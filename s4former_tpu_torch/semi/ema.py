"""EMA (mean-teacher) update (counterpart of ``s4former_tpu/semi/ema.py``;
reference: ``update_ema_variables``, encoder_decoder.py:1044-1066).

teacher <- m * teacher + (1 - m) * student, in place, over the parameters
and the BN running statistics. States are dicts of tensors under the
reference names (``model.state_dict()`` of the student and of the teacher
copy). The scope follows the reference's four update calls (:416-423):
``backbone.`` lerps with the backbone momentum, ``decode_head.`` with the
head momentum, ``neck.``, ``auxiliary_head.`` and anything else with the
plain momentum; these prefixes are where the JAX names ``backbone_m``,
``decode_head_m``, ``neck_m`` and ``aux_heads`` land. ``m`` may be a
0-d device tensor (the mask-ratio-annealed momentum).

``momentum_head_dropout`` (reference :1050-1053, JAX ``ema_update_with_
dropout``): each PARAMETER tensor of the decode head keeps its teacher
value with probability p instead of the lerp; the head's buffers, the
neck and the auxiliary heads are always lerped. ``head_skip_draw`` draws
the skips from a ``torch.Generator``; ``ema_update_scoped`` takes them by
name as 0-d bool tensors, so the choice stays on the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

Momentum = Union[float, torch.Tensor]


def ema_update(teacher: List[torch.Tensor], student: List[torch.Tensor],
               momentum: Momentum) -> None:
    """teacher[i] <- m * teacher[i] + (1 - m) * student[i], in place."""
    if not teacher:
        return
    with torch.no_grad():
        torch._foreach_mul_(teacher, momentum)
        torch._foreach_add_(teacher, torch._foreach_mul(
            [s.to(t.dtype) for s, t in zip(student, teacher)],
            1.0 - momentum))


def ema_update_with_dropout(teacher: List[torch.Tensor],
                            student: List[torch.Tensor], momentum: Momentum,
                            skips: Sequence[torch.Tensor]) -> None:
    """The lerp of ``ema_update`` where ``skips[i]`` (0-d bool) is False;
    where it is True, ``teacher[i]`` stays as it is."""
    with torch.no_grad():
        for t, s, skip in zip(teacher, student, skips):
            upd = t * momentum + s.to(t.dtype) * (1.0 - momentum)
            t.copy_(torch.where(skip, t, upd))


def head_skip_draw(generator: Optional[torch.Generator], n: int, p: float,
                   device) -> torch.Tensor:
    """[n] bool: True skips that head parameter's update (probability p)."""
    return torch.rand((n,), generator=generator, device=device) < p


def ema_update_scoped(teacher: Dict[str, torch.Tensor],
                      student: Dict[str, torch.Tensor],
                      momentum_backbone: Momentum, momentum_head: Momentum,
                      momentum_plain: Momentum,
                      head_skips: Optional[Dict[str, torch.Tensor]] = None
                      ) -> None:
    """Per-module momenta over every floating-point entry of ``teacher``
    (a state dict whose keys ``student`` shares). ``head_skips``: decode
    head parameter name -> 0-d bool skip (momentum_head_dropout)."""
    groups = {'backbone.': ([], [], momentum_backbone),
              'decode_head.': ([], [], momentum_head),
              '': ([], [], momentum_plain)}
    head_skips = head_skips or {}
    dropped = ([], [], [])          # teacher, student, skip
    for name, t in teacher.items():
        if not t.is_floating_point():
            continue
        if name in head_skips:
            dropped[0].append(t)
            dropped[1].append(student[name])
            dropped[2].append(head_skips[name])
            continue
        prefix = next(p for p in groups if name.startswith(p))
        groups[prefix][0].append(t)
        groups[prefix][1].append(student[name])
    for ts, ss, m in groups.values():
        ema_update(ts, ss, m)
    ema_update_with_dropout(dropped[0], dropped[1], momentum_head,
                            dropped[2])
