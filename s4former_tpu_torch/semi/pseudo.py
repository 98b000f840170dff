"""Teacher pseudo-labels and the pseudo CE losses (counterpart of
``s4former_tpu/semi/pseudo.py``; reference: ``extract_teacher_info[_ema]``
and ``compute_pseudo_loss``, mmseg/models/segmentors/encoder_decoder.py:
852-935).

``pseudo_ce_loss`` takes the mean over ALL pixels, ignored ones included
(the reference's ``reduction='none'`` CE then ``torch.mean``); it is not the
config-driven ``CrossEntropyLoss`` and shares no reduction with it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from s4former_tpu_torch.models.losses.cross_entropy import \
    softmax_cross_entropy_with_ignore
from s4former_tpu_torch.ops.resize import resize_bilinear


class TeacherInfo(NamedTuple):
    seg_logits: torch.Tensor        # [B, H, W, C] f32 teacher logits
    hard_label: torch.Tensor        # [B, H, W] int32 argmax (255 unconfident)
    conf_mask: torch.Tensor         # [B, H, W] int32 {0, 1}
    max_prob: torch.Tensor          # [B, H, W] f32 max softmax prob
    soft_label: Optional[torch.Tensor] = None   # [B, H, W, C] if unsup_soft


def extract_teacher_info(seg_logits: torch.Tensor,
                         unsup_confidence: float,
                         unsup_temperature: float = 1.0,
                         unsup_soft: bool = False) -> TeacherInfo:
    """(encoder_decoder.py:875-904). The hard label comes from the
    un-tempered softmax; the temperature acts on the soft label only, as
    the reference's literal ``logits ** (1/T)``."""
    logits = seg_logits.float()
    probs = torch.softmax(logits, dim=-1)
    max_prob = probs.amax(dim=-1)
    hard = probs.argmax(dim=-1)      # the first maximum, as jnp.argmax
    conf = (max_prob > unsup_confidence).to(torch.int32)
    hard = torch.where(conf == 0, torch.full_like(hard, 255),
                       hard).to(torch.int32)
    soft = None
    if unsup_soft:
        t_logits = logits.pow(1.0 / unsup_temperature) \
            if unsup_temperature != 1.0 else logits
        soft = torch.softmax(t_logits, dim=-1)
    return TeacherInfo(seg_logits=logits, hard_label=hard, conf_mask=conf,
                       max_prob=max_prob, soft_label=soft)


def pseudo_ce_loss(student_logits: torch.Tensor,
                   hard_label: torch.Tensor) -> torch.Tensor:
    """CE against the hard pseudo-label, ignore 255, mean over all pixels."""
    if tuple(student_logits.shape[1:3]) != tuple(hard_label.shape[1:3]):
        student_logits = resize_bilinear(student_logits,
                                         tuple(hard_label.shape[1:3]), False)
    nll, _ = softmax_cross_entropy_with_ignore(student_logits, hard_label,
                                               ignore_index=255)
    return nll.mean()


def soft_pseudo_ce_loss(student_logits: torch.Tensor,
                        soft_label: torch.Tensor,
                        conf_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Soft-label CE (the unsup_soft path, :914-922); with ``conf_mask`` the
    per-pixel loss is masked by the teacher's confidence before the mean."""
    logp = F.log_softmax(student_logits.float(), dim=-1)
    per = -(soft_label * logp).sum(dim=-1)
    if conf_mask is not None:
        per = per * conf_mask.to(per.dtype)
    return per.mean()


def mask_ratio(conf_mask: torch.Tensor) -> torch.Tensor:
    """Fraction of confident pixels (encoder_decoder.py:923-925)."""
    return conf_mask.float().mean()
