"""SGD with momentum, poly LR and per-parameter lr multipliers (counterpart
of ``s4former_tpu/core/optim.py``; reference: mmcv SGD + PolyLrUpdaterHook +
DefaultOptimizerConstructor ``custom_keys``).

- torch SGD semantics: buf = m * buf + (g + wd * p); p -= lr * mult * buf.
- poly LR (mmcv 1.x, by iteration): lr = (base - min) * (1 - t/T)^power +
  min, computed on the device from the step counter tensor.
- lr multipliers match ``custom_keys`` as substrings of the parameter's
  reference name (longest key wins). The JAX package matches its flax
  paths; ``'head'`` hits ``decode_head_m`` and ``aux_heads`` there and
  ``decode_head.`` and ``auxiliary_head.`` here, nothing of the backbone.
- Parameters and momentum buffers are dicts of tensors by name; the update
  runs in place with ``torch._foreach`` ops, one group per multiplier.
The layer-wise LR decay constructor is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

Tensors = Dict[str, torch.Tensor]


def poly_lr(step: torch.Tensor, base_lr: float, max_iters: int,
            power: float = 0.9, min_lr: float = 1e-4) -> torch.Tensor:
    """lr as a 0-d f32 tensor on ``step``'s device."""
    progress = torch.clamp(step.float() / max_iters, max=1.0)
    return (base_lr - min_lr) * (1.0 - progress) ** power + min_lr


def build_lr_mult_tree(names: Iterable[str],
                       custom_keys: Optional[Dict[str, float]]
                       ) -> Dict[str, float]:
    """name -> lr multiplier: the longest custom key found in the name."""
    keys = sorted(custom_keys or {}, key=len, reverse=True)
    return {n: next((float(custom_keys[k]) for k in keys if k in n), 1.0)
            for n in names}


def sgd_init(params: Tensors) -> Tensors:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def sgd_update(params: Tensors, grads: Tensors, momentum_buf: Tensors,
               lr: torch.Tensor, lr_mults: Dict[str, float],
               momentum: float = 0.9, weight_decay: float = 0.0) -> None:
    """One torch-style SGD step, in place on ``params`` and
    ``momentum_buf``."""
    groups: Dict[float, list] = {}
    for n, p in params.items():
        groups.setdefault(lr_mults[n], []).append(n)
    with torch.no_grad():
        for mult, names in groups.items():
            ps = [params[n] for n in names]
            bufs = [momentum_buf[n] for n in names]
            gs = [grads[n].float() for n in names]
            if weight_decay:
                gs = torch._foreach_add(gs, [p.float() for p in ps],
                                        alpha=weight_decay)
            torch._foreach_mul_(bufs, momentum)
            torch._foreach_add_(bufs, gs)
            torch._foreach_sub_(ps, torch._foreach_mul(bufs, lr * mult))


def global_grad_norm(grads: Tensors) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))


def clip_grads_by_norm(grads: Tensors, max_norm: float) -> Tensors:
    """mmcv OptimizerHook grad_clip: scale by min(1, max / (norm + 1e-6))."""
    scale = torch.clamp(max_norm / (global_grad_norm(grads) + 1e-6), max=1.0)
    return {n: g * scale for n, g in grads.items()}
