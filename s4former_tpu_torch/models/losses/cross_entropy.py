"""Cross-entropy loss and pixel accuracy (counterpart of
``s4former_tpu/models/losses/cross_entropy.py``; reference:
mmseg/models/losses/cross_entropy_loss.py).

- ``avg_non_ignore=False`` by default: the mean is over ALL pixels; ignored
  pixels add 0 to the sum and count in the denominator (reference l.44-61).
  ``avg_non_ignore=True`` divides by the number of non-ignored pixels.
- Logits arrive in the compute dtype (bf16 in the flagship) and are upcast
  to f32 inside the loss.
- The sigmoid (``use_sigmoid=True``) variant is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from s4former_tpu_torch.registry import LOSSES


def softmax_cross_entropy_with_ignore(
        logits: torch.Tensor,
        label: torch.Tensor,
        ignore_index: int = 255,
        class_weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE. logits [..., C], label [...] int. Returns (per-pixel
    loss with ignored pixels zeroed, valid mask f32)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    if class_weight is not None:
        nll = nll * torch.as_tensor(class_weight, dtype=torch.float32,
                                    device=nll.device)[safe]
    validf = valid.float()
    return nll * validf, validf


def cross_entropy_loss(logits: torch.Tensor,
                       label: torch.Tensor,
                       ignore_index: int = 255,
                       class_weight: Optional[Sequence[float]] = None,
                       avg_non_ignore: bool = False,
                       loss_weight: float = 1.0) -> torch.Tensor:
    """Mean CE with the reference's reduction semantics."""
    nll, valid = softmax_cross_entropy_with_ignore(logits, label,
                                                   ignore_index, class_weight)
    if avg_non_ignore:
        denom = valid.sum().clamp(min=1.0)
    else:
        denom = float(nll.numel())
    return loss_weight * nll.sum() / denom


def accuracy(logits: torch.Tensor, label: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """Top-1 pixel accuracy in percent over non-ignored pixels
    (losses/accuracy.py)."""
    pred = logits.argmax(dim=-1)
    valid = label != ignore_index
    correct = (pred == label) & valid
    return 100.0 * correct.sum().float() / valid.sum().clamp(min=1).float()


@LOSSES.register_module()
class CrossEntropyLoss:
    """Config-driven CE loss (reference ``CrossEntropyLoss``):
    ``loss(seg_logits_nhwc, label_nhw) -> scalar``."""

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 loss_weight: float = 1.0,
                 class_weight: Optional[Sequence[float]] = None,
                 avg_non_ignore: bool = False,
                 reduction: str = 'mean',
                 loss_name: str = 'loss_ce'):
        if use_sigmoid or use_mask:
            raise NotImplementedError('the port has the softmax CE only '
                                      '(use_sigmoid / use_mask are not '
                                      'ported)')
        if reduction != 'mean':
            raise NotImplementedError(f'reduction={reduction!r}: the port '
                                      f'reduces by the mean only')
        self.loss_weight = loss_weight
        self.class_weight = class_weight
        self.avg_non_ignore = avg_non_ignore
        # loss_name is a config key only: the train step names the losses

    def __call__(self, logits: torch.Tensor, label: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
        return cross_entropy_loss(logits, label, ignore_index,
                                  self.class_weight, self.avg_non_ignore,
                                  self.loss_weight)
