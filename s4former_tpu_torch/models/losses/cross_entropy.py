"""Cross-entropy loss and pixel accuracy (counterpart of
``s4former_tpu/models/losses/cross_entropy.py``; reference:
mmseg/models/losses/cross_entropy_loss.py).

- ``avg_non_ignore=False`` by default: the mean is over ALL pixels; ignored
  pixels add 0 to the sum and count in the denominator (reference l.44-61).
  ``avg_non_ignore=True`` divides by the number of non-ignored pixels.
- Logits arrive in the compute dtype (bf16 in the flagship) and are upcast
  to f32 inside the loss.
- ``use_sigmoid=True``: the per-class sigmoid BCE summed over classes
  (``binary_cross_entropy_loss``), against a one-hot of class indices or a
  target of the logits' shape, with the same two denominators; the JAX
  package's sigmoid path takes no class weight.
- ``reduction`` is accepted and changes nothing: the loss is always the
  mean, as in the JAX package (which stores the value and ignores it).
- Under data parallelism each rank's loss is its share of the global mean:
  the local sum over the global count (``parallel.mesh.global_sum`` of the
  valid pixels; the rank's pixels times the world size, since every rank
  holds an equal block). The shares add up to the single-process loss,
  ignore labels spread unevenly over the ranks included.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from s4former_tpu_torch.parallel.distributed import data_size
from s4former_tpu_torch.parallel.mesh import global_sum
from s4former_tpu_torch.registry import LOSSES


def softmax_cross_entropy_with_ignore(
        logits: torch.Tensor,
        label: torch.Tensor,
        ignore_index: int = 255,
        class_weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE. logits [..., C], label [...] int. Returns (per-pixel
    loss with ignored pixels zeroed, valid mask f32).

    A label outside 0..C-1 that is not ``ignore_index`` (a 19-class label
    on STDC's 2-class boundary head) gets an nll of 0 and a class weight of
    0 but stays valid, so it counts in the mean's denominator: the JAX
    package contracts with ``jax.nn.one_hot``, whose row for such a label
    is all zero. Its gather reads a clamped index and is masked out."""
    num_classes = logits.shape[-1]
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    in_range = (safe >= 0) & (safe < num_classes)
    safe = safe.clamp(0, num_classes - 1)
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(in_range, nll, torch.zeros_like(nll))
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32,
                             device=nll.device)[safe]
        nll = nll * torch.where(in_range, cw, torch.zeros_like(cw))
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
        denom = global_sum(valid.sum()).clamp(min=1.0)
    else:
        denom = float(nll.numel() * data_size())
    return loss_weight * nll.sum() / denom


def binary_cross_entropy_loss(logits: torch.Tensor,
                              label: torch.Tensor,
                              ignore_index: int = 255,
                              loss_weight: float = 1.0,
                              avg_non_ignore: bool = False) -> torch.Tensor:
    """Sigmoid BCE of ``use_sigmoid=True`` heads (reference
    cross_entropy_loss.py:92-152). logits [..., C]; label either class
    indices [...] (one-hot here; an index outside 0..C-1 is an all-zero
    row, as ``jax.nn.one_hot`` gives) or a target of the logits' shape."""
    logits = logits.float()
    if label.shape == logits.shape:
        target = label.float()
        valid = torch.ones(label.shape[:-1], device=logits.device)
    else:
        keep = label != ignore_index
        safe = torch.where(keep, label, torch.zeros_like(label))
        classes = torch.arange(logits.shape[-1], device=logits.device)
        target = (safe[..., None] == classes).float()
        valid = keep.float()
    per = logits.clamp(min=0) - logits * target + \
        torch.log1p(torch.exp(-logits.abs()))
    per = per.sum(dim=-1) * valid
    if avg_non_ignore:
        denom = global_sum(valid.sum()).clamp(min=1.0)
    else:
        denom = float(per.numel() * data_size())
    return loss_weight * per.sum() / denom


def accuracy(logits: torch.Tensor, label: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """Top-1 pixel accuracy in percent over non-ignored pixels
    (losses/accuracy.py), over the global batch."""
    pred = logits.argmax(dim=-1)
    valid = label != ignore_index
    correct = (pred == label) & valid
    n = global_sum(torch.stack([correct.sum(), valid.sum()]).float())
    return 100.0 * n[0] / n[1].clamp(min=1)


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
        if use_mask:
            raise NotImplementedError('mask CE is detection-only upstream')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction       # accepted; the mean is taken
        self.loss_weight = loss_weight
        self.class_weight = class_weight
        self.avg_non_ignore = avg_non_ignore
        # loss_name is a config key only: the train step names the losses

    def __call__(self, logits: torch.Tensor, label: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
        if self.use_sigmoid:
            return binary_cross_entropy_loss(logits, label, ignore_index,
                                             self.loss_weight,
                                             self.avg_non_ignore)
        return cross_entropy_loss(logits, label, ignore_index,
                                  self.class_weight, self.avg_non_ignore,
                                  self.loss_weight)
