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
0-d device tensor (the mask-ratio-annealed momentum). The reference's
``momentum_head_dropout`` is not ported: the train step raises on it.
"""
from __future__ import annotations

from typing import Dict, List, Union

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


def ema_update_scoped(teacher: Dict[str, torch.Tensor],
                      student: Dict[str, torch.Tensor],
                      momentum_backbone: Momentum, momentum_head: Momentum,
                      momentum_plain: Momentum) -> None:
    """Per-module momenta over every floating-point entry of ``teacher``
    (a state dict whose keys ``student`` shares)."""
    groups = {'backbone.': ([], [], momentum_backbone),
              'decode_head.': ([], [], momentum_head),
              '': ([], [], momentum_plain)}
    for name, t in teacher.items():
        if not t.is_floating_point():
            continue
        prefix = next(p for p in groups if name.startswith(p))
        groups[prefix][0].append(t)
        groups[prefix][1].append(student[name])
    for ts, ss, m in groups.values():
        ema_update(ts, ss, m)
