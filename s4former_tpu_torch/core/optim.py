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
  runs in place with ``torch._foreach`` ops, one group per (lr, weight
  decay) multiplier pair.
- Layer-wise LR decay (``build_layer_decay_trees``, the reference's
  LearningRateDecayOptimizerConstructor as JAX core/optim.py:66-120 maps
  it): lr multipliers by layer and the no-decay group's weight-decay
  multiplier 0, from the reference parameter names.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Tuple

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


def build_layer_decay_trees(names: Iterable[str], ndims: Dict[str, int],
                            num_layers: int, decay_rate: float,
                            decay_type: str = 'layer_wise', mit: bool = False
                            ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(lr multipliers, weight-decay multipliers) by parameter name
    (reference layer_decay_optimizer_constructor.py:79-189):

    - the embeddings get ``decay_rate ** (num_layers + 1)``: the ViT's
      ``backbone.patch_embed``, ``pos_embed`` and ``cls_token``, a MiT's
      patch embeddings ``backbone.layers.{s}.0.`` (JAX ``patch_embed_{s}``);
    - ViT block i (``backbone.layers.{i}.``) gets
      ``decay_rate ** (num_layers - i)`` when the backbone has exactly
      ``num_layers`` blocks (JAX matches its stacked leaves' leading axis
      to ``num_layers`` and gives 1 otherwise);
    - everything else gets 1 (a MiT's blocks too: JAX finds no stack);
    - the weight-decay multiplier is 0 for 1-D tensors, biases, pos_embed
      and cls_token, else 1.

    ``ndims``: each name's tensor rank."""
    if decay_type != 'layer_wise':
        raise NotImplementedError(
            f'decay_type={decay_type!r}: stage_wise is ConvNeXt-only in '
            f'the reference and no ConvNeXt backbone is ported')
    names = list(names)
    block = re.compile(r'backbone\.layers\.(\d+)\.')
    blocks = {int(m.group(1)) for m in map(block.match, names) if m}
    stacked = not mit and len(blocks) == num_layers
    embed = decay_rate ** (num_layers + 1)
    lr_mults, wd_mults = {}, {}
    for name in names:
        m = block.match(name)
        if mit:
            is_embed = m is not None and name.startswith(
                f'backbone.layers.{m.group(1)}.0.')
        else:
            is_embed = name.startswith(('backbone.patch_embed.',
                                        'backbone.pos_embed',
                                        'backbone.cls_token'))
        if is_embed:
            lr_mults[name] = embed
        elif m is not None and stacked:
            lr_mults[name] = decay_rate ** (num_layers - int(m.group(1)))
        else:
            lr_mults[name] = 1.0
        no_decay = (ndims[name] == 1 or name.endswith('bias') or
                    'pos_embed' in name or 'cls_token' in name)
        wd_mults[name] = 0.0 if no_decay else 1.0
    return lr_mults, wd_mults


def sgd_init(params: Tensors) -> Tensors:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def sgd_update(params: Tensors, grads: Tensors, momentum_buf: Tensors,
               lr: torch.Tensor, lr_mults: Dict[str, float],
               momentum: float = 0.9, weight_decay: float = 0.0,
               wd_mults: Optional[Dict[str, float]] = None) -> None:
    """One torch-style SGD step, in place on ``params`` and
    ``momentum_buf``; ``wd_mults`` scales the weight decay by name."""
    groups: Dict[Tuple[float, float], list] = {}
    for n, p in params.items():
        wdm = 1.0 if wd_mults is None else wd_mults[n]
        groups.setdefault((lr_mults[n], wdm), []).append(n)
    with torch.no_grad():
        for (mult, wdm), names in groups.items():
            ps = [params[n] for n in names]
            bufs = [momentum_buf[n] for n in names]
            gs = [grads[n].float() for n in names]
            if weight_decay * wdm:
                gs = torch._foreach_add(gs, [p.float() for p in ps],
                                        alpha=weight_decay * wdm)
            torch._foreach_mul_(bufs, momentum)
            torch._foreach_add_(bufs, gs)
            torch._foreach_sub_(ps, torch._foreach_mul(bufs, lr * mult))


def global_grad_norm(grads: Tensors,
                     sq_sum: Optional[Callable[[Tensors], torch.Tensor]]
                     = None) -> torch.Tensor:
    """The gradients' global L2 norm; ``sq_sum`` sums the squares of split
    gradients over their groups (``parallel.tp.ShardPlan.grad_sq_sum``)."""
    if sq_sum is not None:
        return torch.sqrt(sq_sum(grads))
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))


def clip_grads_by_norm(grads: Tensors, max_norm: float,
                       sq_sum: Optional[Callable[[Tensors], torch.Tensor]]
                       = None) -> Tensors:
    """mmcv OptimizerHook grad_clip: scale by min(1, max / (norm + 1e-6))."""
    scale = torch.clamp(max_norm / (global_grad_norm(grads, sq_sum) + 1e-6),
                        max=1.0)
    return {n: g * scale for n, g in grads.items()}
