"""NCR: the negative-class-ranking consistency loss (counterpart of
``s4former_tpu/semi/ncr.py``; reference:
mmseg/models/segmentors/encoder_decoder.py:936-1040 and :443-474).

For each pixel labelled class i (255 matches no class), the student's and
the teacher's softmax over the classes other than i are compared (pairwise
L2 or KL), summed over pixels and divided by B*H*W. "Drop class i, then
softmax" is a softmax with class i's logit at -1e30: the dropped entry is 0
in both distributions, so reductions over all C entries are the same.
Under data parallelism B is the global batch: each rank's loss is its
share.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from s4former_tpu_torch.parallel.distributed import data_size

_NEG_INF = -1e30
MODES = ('unsup_only', 'both', 'all', 'kl', 'unsup_only_kl',
         'reweight_unsup_only_kl', 'sup')


def _excluded_softmax(logits: torch.Tensor, label: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """Softmax over the classes other than ``label`` (whose prob is 0)."""
    safe = label.clamp(0, num_classes - 1).long()
    onehot = F.one_hot(safe, num_classes).bool()
    return torch.softmax(logits.masked_fill(onehot, _NEG_INF), dim=-1)


def ncr_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
             label: torch.Tensor, num_classes: int,
             mode: str = 'unsup_only') -> torch.Tensor:
    """logits [B, H, W, C], label [B, H, W] int. Modes as the JAX function:
    'unsup_only'/'both' L2 of excluded softmaxes; 'all' L2 of full ones;
    'kl' KL(teacher || student) of full ones; 'unsup_only_kl' and
    'reweight_unsup_only_kl' (x0.5) KL of excluded ones; 'sup' KL + L2 of
    excluded ones (the reference's double-pdist quirk)."""
    if mode not in MODES:
        raise ValueError(f'unknown NCR mode {mode}')
    sl = student_logits.float()
    tl = teacher_logits.float()
    valid = ((label != 255) & (label < num_classes)).float()
    if mode in ('all', 'kl'):
        sp = torch.softmax(sl, dim=-1)
        tp = torch.softmax(tl, dim=-1)
    else:
        sp = _excluded_softmax(sl, label, num_classes)
        tp = _excluded_softmax(tl, label, num_classes)
    eps = 1e-12
    l2 = kl = None
    if mode in ('unsup_only', 'both', 'all', 'sup'):
        l2 = torch.sqrt(((sp - tp) ** 2).sum(dim=-1) + 1e-12)
    if mode in ('kl', 'unsup_only_kl', 'reweight_unsup_only_kl', 'sup'):
        kl = (tp * (torch.log(tp + eps) - torch.log(sp + eps))).sum(dim=-1)
    per_pixel = l2 if kl is None else (kl if l2 is None else kl + l2)
    loss = (per_pixel * valid).sum() / float(label.numel() * data_size())
    if mode == 'reweight_unsup_only_kl':
        loss = 0.5 * loss
    return loss
