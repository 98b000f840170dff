"""Tensor parallelism and ZeRO-3 over the (data, model) rank grid
(counterpart of ``s4former_tpu/parallel/tp.py``).

The plan is the JAX package's: ``_RULES`` and ``_spec_for`` below are its
own (JAX tp.py:56-91), applied to the port's mmseg parameter names through
the weight bridge's name mapping (``core/checkpoint.py:_vit``, ``_mit``):

- column-split (the output dim over 'model'): ``attn.qkv`` and ``ffn.fc1``
  with their biases;
- row-split (the input dim over 'model'): ``attn.proj`` and ``ffn.fc2``;
  their biases stay whole and are added once, after the reduce;
- everything else (LayerNorms, patch embed, pos embed, cls token, the
  MiT's ``attn.q``/``attn.kv`` and depthwise conv, the heads, BN
  statistics) stays whole on every rank;
- with ``zero3`` every rule-matched kernel, its EMA twin and its SGD
  buffer are also split over 'data' on their other matmul dim.

JAX's GSPMD splits the packed qkv [C, 3C] into contiguous thirds of its
output and reshards at the head reshape (JAX tp.py:36-39). The port has
no compiler to do that, so the split of ``in_proj_weight`` [3C, C] (and
its bias) follows head boundaries: model index m keeps the rows of heads
m·H/mp .. (m+1)·H/mp − 1 of each of q, k and v, three strided row blocks
(``Spec.blocks``). Each rank then attends over H/mp heads with the flash
kernels. The checkpoint layout stays the whole, unsharded one:
``unshard_state_dict`` gathers the pieces back.

``shard_state`` cuts a ``TrainState`` (student, EMA teacher, SGD buffers)
into this rank's pieces, in place, and marks the modules that run on
pieces: ``tp`` (the model split) on the ViT's attention and FFN and the
MiT's, ``zero3_dims`` on the modules that own a ZeRO-3 shard
(``parallel.mesh.param`` gathers it at each use).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from s4former_tpu_torch.parallel.distributed import (data_group, data_rank,
                                                     data_size, model_group,
                                                     model_rank, model_size)
from s4former_tpu_torch.parallel.mesh import all_gather

Tensor = torch.Tensor

# (path-substring, spec-kind), first match wins: JAX tp.py's own table.
# 'col' puts 'model' on the last axis of a flax kernel [in, out] (its
# output dim) and of its bias; 'row' on the second-to-last axis of a
# kernel; a row-split bias stays whole.
_RULES: Tuple[Tuple[str, str], ...] = (
    ('attn/qkv/', 'col'),
    ('attn/in_proj/', 'col'),       # MiT naming
    ('attn/proj/', 'row'),
    ('attn/out_proj/', 'row'),
    ('ffn/fc1/', 'col'),
    ('ffn/fc2/', 'row'),
)


def _spec_for(path: str, ndim: int, shape, axis_size: int,
              zero3_axis: int = 1) -> Tuple[Optional[str], ...]:
    """JAX ``_spec_for``: the mesh axis of each dim of a flax leaf ('model',
    'data' or None); () is whole on every rank."""
    is_kernel = path.rstrip('/').endswith('kernel')
    for frag, kind in _RULES:
        if frag in path:
            if kind == 'col':
                if shape[-1] % axis_size:
                    return ()
                spec = [None] * (ndim - 1) + ['model']
                if zero3_axis > 1 and is_kernel and ndim >= 2 \
                        and shape[-2] % zero3_axis == 0:
                    spec[-2] = 'data'
                return tuple(spec)
            if is_kernel and ndim >= 2 and shape[-2] % axis_size == 0:
                spec = [None] * (ndim - 2) + ['model', None]
                if zero3_axis > 1 and shape[-1] % zero3_axis == 0:
                    spec[-1] = 'data'
                return tuple(spec)
            return ()
    return ()


# the port's names -> the JAX module paths the rules read (the bridge's
# mapping, core/checkpoint.py:_vit and _mit)
_VIT_NAMES = ((r'attn\.attn\.in_proj_', 'attn/qkv/'),
              (r'attn\.attn\.out_proj\.', 'attn/proj/'),
              (r'ffn\.layers\.0\.0\.', 'ffn/fc1/'),
              (r'ffn\.layers\.1\.', 'ffn/fc2/'))
_MIT_NAMES = ((r'attn\.attn\.in_proj_', 'attn/q+kv/'),    # no rule: whole
              (r'attn\.attn\.out_proj\.', 'attn/proj/'),
              (r'ffn\.layers\.0\.', 'ffn/fc1/'),
              (r'ffn\.layers\.1\.', 'ffn/dwconv/'),       # no rule: whole
              (r'ffn\.layers\.4\.', 'ffn/fc2/'))
_MIT_BLOCK = re.compile(r'(^|\.)layers\.\d+\.1\.\d+\.')


def jax_path(name: str) -> str:
    """The JAX path (its rules' fragment and leaf) of a port parameter;
    a name the bridge does not rename keeps its own, '/'-joined."""
    table = _MIT_NAMES if _MIT_BLOCK.search(name) else _VIT_NAMES
    leaf = 'kernel' if name.endswith('weight') else 'bias'
    for pattern, frag in table:
        m = re.search(r'\.' + pattern + r'(weight|bias)$', name)
        if m:
            return name[:m.start()].replace('.', '/') + '/' + frag + leaf
    return name.replace('.', '/')


@dataclasses.dataclass(frozen=True)
class Spec:
    """A parameter's split in torch dims: ``model`` over the model group,
    ``data`` over the data group (ZeRO-3); ``blocks`` > 1 splits the model
    dim in each of that many equal blocks (the packed q | k | v)."""
    model: Optional[int] = None
    data: Optional[int] = None
    blocks: int = 1


def spec_for(name: str, shape, mp: int, zero3_axis: int = 1) -> Spec:
    """The port's split of parameter ``name`` of torch ``shape``: JAX's
    rule on the flax leaf (a kernel [in, out] is the torch weight [out, in
    (, 1, 1)] transposed), its axes mapped back to torch dims."""
    path = jax_path(name)
    kernel = path.endswith('kernel')
    if kernel:
        shape = (shape[1], shape[0])
    spec = _spec_for(path, len(shape), shape, mp, zero3_axis)
    if not spec:
        return Spec()
    dims = {axis: (len(spec) - 1 - i if kernel else i)
            for i, axis in enumerate(spec) if axis is not None}
    return Spec(model=dims.get('model'), data=dims.get('data'),
                blocks=3 if '/attn/qkv/' in path else 1)


def param_specs(named_shapes: Dict[str, Tuple[int, ...]], mp: int,
                zero3_axis: int = 1) -> Dict[str, Spec]:
    """JAX ``tp_param_specs`` on the port's parameters: every split one
    (the rest stay whole). With mp 1 and no ZeRO-3 axis, nothing is."""
    if mp <= 1 and zero3_axis <= 1:
        return {}
    out = {}
    for name, shape in named_shapes.items():
        spec = spec_for(name, tuple(shape), mp, zero3_axis)
        if spec != Spec():
            out[name] = spec
    return out


class ShardPlan:
    """The splits of one run (``specs``, by parameter name) on this rank's
    grid: mp model ranks, and a ZeRO-3 data axis of ``zero3_size`` (1
    without ZeRO-3)."""

    def __init__(self, specs: Dict[str, Spec], mp: int, zero3_size: int):
        self.specs = specs
        self.mp = mp
        self.zero3_size = zero3_size

    def _model_split(self, spec: Spec) -> bool:
        return spec.model is not None and self.mp > 1

    def _data_split(self, spec: Spec) -> bool:
        return spec.data is not None and self.zero3_size > 1

    def split_names(self):
        """The parameters this run actually cuts (a model dim on a model
        axis of 1 cuts nothing)."""
        return [n for n, s in self.specs.items()
                if self._model_split(s) or self._data_split(s)]

    def zero3_names(self):
        """The parameters whose gradient the backward reduce-scatters."""
        return [n for n, s in self.specs.items() if self._data_split(s)]

    def local(self, name: str, full: Tensor) -> Tensor:
        """This rank's piece of the whole tensor ``full``."""
        spec = self.specs.get(name)
        if spec is None:
            return full
        t = full
        if self._model_split(spec):
            m, dim = model_rank(), spec.model
            t = torch.cat([b.chunk(self.mp, dim)[m]
                           for b in t.chunk(spec.blocks, dim)], dim)
        if self._data_split(spec):
            t = t.chunk(self.zero3_size, spec.data)[data_rank()]
        return t.clone(memory_format=torch.contiguous_format)

    def gather(self, name: str, piece: Tensor) -> Tensor:
        """The whole tensor from every rank's ``piece`` (a collective: each
        rank of the groups that split ``name`` must call it)."""
        spec = self.specs.get(name)
        if spec is None:
            return piece
        t = piece.contiguous()
        if self._data_split(spec):
            t = all_gather(t, spec.data, data_group(), data_rank(),
                           self.zero3_size)
        if self._model_split(spec):
            t = all_gather(t, spec.model, model_group(), model_rank(),
                           self.mp)
            if spec.blocks > 1:
                # [m0: b0 b1 b2 | m1: b0 b1 b2 ..] -> [b0: m0 m1 .. | b1 ..]
                dim = spec.model
                parts = [p.chunk(spec.blocks, dim)
                         for p in t.chunk(self.mp, dim)]
                t = torch.cat([parts[m][b] for b in range(spec.blocks)
                               for m in range(self.mp)], dim)
        return t

    def grad_sq_sum(self, grads: Dict[str, Tensor]) -> Tensor:
        """The squared global norm of the gradients: each piece's squares
        summed over the groups that split it, the whole ones once."""
        parts = {}
        for name, g in grads.items():
            spec = self.specs.get(name, Spec())
            key = (self._model_split(spec), self._data_split(spec))
            sq = (g.float() ** 2).sum()
            parts[key] = parts[key] + sq if key in parts else sq
        total = None
        for (by_model, by_data) in sorted(parts):
            s = parts[(by_model, by_data)].clone()
            if by_model:
                torch.distributed.all_reduce(s, group=model_group())
            if by_data:
                torch.distributed.all_reduce(s, group=data_group())
            total = s if total is None else total + s
        return total


def _check_heads(model: nn.Module, mp: int) -> None:
    for name, m in model.named_modules():
        heads = getattr(m, 'num_heads', None)
        if getattr(type(m), 'head_split', False) and heads % mp:
            raise ValueError(
                f'{name or "the model"} has {heads} attention heads, which '
                f'do not divide over a model axis of {mp}: the port splits '
                f'the packed qkv at head boundaries')


def _mark(model: nn.Module, plan: ShardPlan) -> None:
    """Tell the modules how they are split: ``tp`` on the attention and
    FFN modules whose parameters are model-split, ``zero3_dims`` on the
    owners of ZeRO-3 shards."""
    for mname, module in model.named_modules():
        prefix = mname + '.' if mname else ''
        own = [prefix + n for n, _ in module.named_parameters()]
        if hasattr(type(module), 'tp') and plan.mp > 1 and any(
                plan._model_split(plan.specs[n]) for n in own
                if n in plan.specs):
            module.tp = plan.mp
        dims = {n: plan.specs[prefix + n].data
                for n, _ in module.named_parameters(recurse=False)
                if prefix + n in plan.specs and
                plan._data_split(plan.specs[prefix + n])}
        if dims:
            module.zero3_dims = dims


def _cut_module(model: nn.Module, plan: ShardPlan) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in plan.specs:
                p.data = plan.local(name, p.data)
    _mark(model, plan)


def shard_state(state, zero3: bool = False):
    """Cut ``state`` (student, EMA teacher and SGD buffers) into this
    rank's pieces under the grid ``parallel.mesh.make_mesh`` laid out, in
    place, and return it with its ``plan``. The identity on a model axis
    of 1 without ZeRO-3, or with a data axis of 1. Raises ValueError where
    a ViT's heads do not divide over the model axis."""
    mp = model_size()
    zero3_size = data_size() if zero3 else 1
    if mp == 1 and zero3_size == 1:
        return state
    model = state.model
    _check_heads(model, mp)
    specs = param_specs({n: tuple(p.shape)
                         for n, p in model.named_parameters()},
                        mp, zero3_size)
    plan = ShardPlan(specs, mp, zero3_size)
    _cut_module(model, plan)
    if state.ema_model is not None:
        _cut_module(state.ema_model, plan)
    for name in state.momentum:
        state.momentum[name] = plan.local(name, state.momentum[name])
    return dataclasses.replace(state, plan=plan)


def unshard_state_dict(plan: Optional[ShardPlan],
                       sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A state dict of pieces -> the whole one (a collective when
    ``plan`` splits anything)."""
    if plan is None:
        return sd
    return {k: plan.gather(k, v) for k, v in sd.items()}


def shard_state_dict(plan: Optional[ShardPlan],
                     sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A whole state dict -> this rank's pieces."""
    if plan is None:
        return sd
    return {k: plan.local(k, v) for k, v in sd.items()}
