"""Pipeline parallelism over the (data, pipe) grid: a GPipe microbatch
schedule (counterpart of ``s4former_tpu/parallel/pp.py``).

As in the JAX package this is a library: no config or CLI flag reaches it.
Each rank holds one stage, L/S consecutive layers of the stack
(``stage_layers`` cuts them out of the whole one; holding only those is
what a pipeline buys), and the collectives are written out over the grid
of ``parallel.mesh.make_pp_mesh`` / ``make_pp_tp_mesh``:

- ``pipeline_apply(layer_fn, stage, x, M)``: the batch splits into M
  microbatches and the data axis splits each microbatch (JAX shards
  ``x.reshape(M, B/M, ...)`` as ``P(None, 'data')``: data rank d holds rows
  j B/M + d B/(M dp) .. of microbatch j). For tick t in [0, M + S - 1)
  stage 0 takes microbatch t (while t < M), every stage runs its layers,
  the activations hop one stage on (``ppermute``), and the last stage
  banks microbatch t - (S - 1). The banked outputs, zero on every other
  stage, are summed over 'pipe' with an identity backward (JAX's final
  ``psum``: the loss is taken on the replicated output, so a summing
  backward would scale the gradients by S), then gathered over 'data'.
- Inputs and outputs are whole on every rank, as JAX's global arrays:
  ``x`` [B, ...] in, [B, ...] out. The gradients are those of the
  sequential stack on the whole batch: a stage's parameters get theirs
  summed over 'data' (one bucket, ``mesh.sum_grads``), as JAX's transpose
  gives replicated inputs, and ``x`` gets its whole gradient on every
  rank.
- Every rank holds the same collectives in its graph, in the same order:
  a stage selects its input with ``torch.where`` on its index, as JAX's
  ``jnp.where``, never with a Python branch on the stage, so stage 0 keeps
  the received carry in its graph and its backward joins the
  ``ppermute`` that the other stages' backwards wait in.
- ``pipeline_apply_tp(leaves, x, M, num_heads, sequence_parallel)``: the
  same schedule with each stage's layers tensor-parallel over 'model'
  (``_tp_block``: JAX's pre-LN block with Megatron's collectives written
  out), and with Megatron-SP the activations sequence-sharded between
  blocks: gathered before each column-split product, reduce-scattered
  after each row-split one, L % mp == 0 (pad 1025 -> 1026 for DeiT-B).
  ``tp_stage_leaves`` cuts the rank's pieces out of the whole stack with
  ``parallel/tp.py``'s plan, whose head-aligned qkv blocks are JAX
  ``_repack_qkv``'s per-rank packs.

On the card each layer's attention is the flash forward (kernel #1) and
its gradient the fused backward (kernel #2); on CPU tensors their plain
versions. Where JAX asserts, the port raises ValueError before any
collective.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from s4former_tpu_torch.models.backbones.vit import partial_product
from s4former_tpu_torch.ops.flash_attention import flash_attention
from s4former_tpu_torch.parallel import tp
from s4former_tpu_torch.parallel.distributed import (data_size, model_size,
                                                     pipe_rank, pipe_size)
from s4former_tpu_torch.parallel.mesh import (axis_gather,
                                              axis_reduce_scatter, axis_slice,
                                              axis_sum, copy_to_model,
                                              ppermute, reduce_from_model,
                                              sum_grads)

Tensor = torch.Tensor

# a TransformerEncoderLayer's parameters and their names as
# ``pipeline_apply_tp`` leaves (JAX's, in torch's [out, in] layout)
LEAF_NAMES = (('ln1.weight', 'ln1_w'), ('ln1.bias', 'ln1_b'),
              ('attn.attn.in_proj_weight', 'qkv_w'),
              ('attn.attn.in_proj_bias', 'qkv_b'),
              ('attn.attn.out_proj.weight', 'proj_w'),
              ('attn.attn.out_proj.bias', 'proj_b'),
              ('ln2.weight', 'ln2_w'), ('ln2.bias', 'ln2_b'),
              ('ffn.layers.0.0.weight', 'fc1_w'),
              ('ffn.layers.0.0.bias', 'fc1_b'),
              ('ffn.layers.1.weight', 'fc2_w'),
              ('ffn.layers.1.bias', 'fc2_b'))
# the leaves every model rank holds whole; under sequence parallelism each
# rank's gradient of them covers its chunk of the tokens only
_WHOLE = ('ln1_w', 'ln1_b', 'proj_b', 'ln2_w', 'ln2_b', 'fc2_b')


def stage_layers(layers: Sequence[nn.Module]) -> nn.ModuleList:
    """This rank's stage of a whole layer stack: layers s L/S .. (s + 1)
    L/S - 1 of stage s = ``pipe_rank()`` (JAX reshapes the stacked [L]
    axis to [S, L/S] and shards the first). The caller drops the rest."""
    n, s = len(layers), pipe_size()
    if n % s:
        raise ValueError(f'{n} layers do not divide into {s} stages')
    per = n // s
    return nn.ModuleList(list(layers)[pipe_rank() * per:
                                      (pipe_rank() + 1) * per])


def _microbatches(x: Tensor, num_microbatches: int) -> Tensor:
    """[B, ...] -> this data index's rows of each microbatch, [M, B/(M dp),
    ...]; the gradient of ``x`` comes back whole, summed over the stages
    (only stage 0 reads it)."""
    b, m, dp = x.shape[0], num_microbatches, data_size()
    if m < 1 or b % m:
        raise ValueError(f'a batch of {b} does not split into {m} '
                         f'microbatches')
    if (b // m) % dp:
        raise ValueError(f'a microbatch of {b // m} rows does not divide '
                         f'over {dp} data ranks')
    xs = sum_grads([x], 'pipe')[0].reshape((m, b // m) + tuple(x.shape[1:]))
    return axis_slice(xs, 1, 'data')


def _schedule(run_stage: Callable[[Tensor], Tensor], xs: Tensor) -> Tensor:
    """GPipe over 'pipe' on this rank's microbatches ``xs`` [M, b, ...]:
    M + S - 1 ticks; the last stage's outputs [M, b, ...], summed over
    'pipe' (identity backward)."""
    s, m = pipe_size(), xs.shape[0]
    first = torch.tensor(pipe_rank() == 0, device=xs.device)
    last = torch.tensor(pipe_rank() == s - 1, device=xs.device)
    carry = torch.zeros_like(xs[0])
    outs = []
    for t in range(m + s - 1):
        inject = xs[t] if t < m else torch.zeros_like(carry)
        y = run_stage(torch.where(first, inject, carry))
        if t >= s - 1:
            outs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < m + s - 2:           # the last tick's hop would go unread
            carry = ppermute(y, 'pipe')
    return axis_sum(torch.stack(outs), 'pipe')


class _Chunk(nn.Module):
    """A stage's layers run in order through ``layer_fn``."""

    def __init__(self, layers: nn.ModuleList, layer_fn):
        super().__init__()
        self.layers = layers
        self.layer_fn = layer_fn

    def forward(self, act: Tensor) -> Tensor:
        for layer in self.layers:
            act = self.layer_fn(layer, act)
        return act


def _call_layer(layer: nn.Module, act: Tensor) -> Tensor:
    return layer(act)


def pipeline_apply(layer_fn: Optional[Callable[[nn.Module, Tensor], Tensor]],
                   stage: nn.ModuleList, x: Tensor,
                   num_microbatches: int) -> Tensor:
    """Run a layer stack as a GPipe pipeline over 'pipe' (JAX
    ``pipeline_apply``).

    Args:
      layer_fn: (layer, activation [b, ...]) -> activation, batch-local;
        None calls the layer.
      stage: this rank's layers (``stage_layers``).
      x: [B, ...], the same on every rank; B % M == 0 and each microbatch
        of B / M rows divides over the data axis.
      num_microbatches: GPipe's M; the bubble is (S - 1) / (M + S - 1).

    Returns [B, ...], the same on every rank.
    """
    if len(stage) == 0:
        raise ValueError('a pipeline stage needs at least one layer')
    chunk = _Chunk(stage, layer_fn or _call_layer)
    names = [n for n, _ in chunk.named_parameters()]
    params = dict(zip(names, sum_grads([p for _, p in
                                        chunk.named_parameters()], 'data')))
    outs = _schedule(lambda act: functional_call(chunk, params, (act,)),
                     _microbatches(x, num_microbatches))
    return axis_gather(outs, 1, 'data').reshape(x.shape)


# --------------------------------------------------------------------------
# 3-D: data x pipe x model. JAX re-expresses the block with its Megatron
# collectives because GSPMD's TP cannot run inside shard_map; the port keeps
# that block as its own function on the rank's leaves (the ViT's tp modules
# serve every other path).
# --------------------------------------------------------------------------

def tp_stage_leaves(layers: Sequence[nn.Module]) -> nn.ModuleList:
    """This rank's leaves for ``pipeline_apply_tp``: the layers of its
    stage (``stage_layers``), each as a ``ParameterDict`` of the model
    rank's pieces in ``LEAF_NAMES``' names, cut by ``parallel/tp.py``'s
    plan: qkv the rank's heads of each of q, k and v (three row blocks,
    JAX ``_repack_qkv``'s pack r), fc1 its rows, proj and fc2 its input
    columns; LayerNorms and the proj and fc2 biases whole. New parameters:
    the caller drops the whole stack."""
    stage = stage_layers(layers)
    mp = model_size()
    heads = stage[0].attn.num_heads
    if heads % mp:
        raise ValueError(f'{heads} attention heads do not divide over a '
                         f'model axis of {mp}')
    plan = tp.ShardPlan(tp.param_specs(
        {n: tuple(p.shape) for n, p in stage.named_parameters()}, mp), mp, 1)
    out = nn.ModuleList()
    for i, layer in enumerate(stage):
        own = dict(layer.named_parameters())
        out.append(nn.ParameterDict({
            short: nn.Parameter(plan.local(f'{i}.{name}',
                                           own[name].detach()).clone())
            for name, short in LEAF_NAMES if name in own}))
    return out


def _tp_block(p: Dict[str, Tensor], x: Tensor, num_heads_local: int,
              eps: float = 1e-6, sequence_parallel: bool = False) -> Tensor:
    """One pre-LN block on the model rank's leaves ``p``, in x's dtype
    (JAX ``_tp_block``; the port ViT's mixed precision: LayerNorm
    statistics in f32, products in x's dtype with f32 parameters cast).
    The attention is plain softmax with no bias, through
    ``flash_attention`` at the rank's heads. The row-split products'
    partial sums stay f32 through the reduce and round once with the whole
    bias (the ViT's ``row_split_linear``).

    ``sequence_parallel``: x is the rank's [b, L/mp, C] chunk of the
    tokens; the LayerNorms and the residual stream run on it, an
    all-gather over 'model' precedes each column-split product and the
    row-split sums reduce-scatter back along L. Else x is [b, L, C] on
    every model rank, and Megatron's pair (``copy_to_model``,
    ``reduce_from_model``) stands around the split products."""
    dtype, c = x.dtype, x.shape[-1]

    def ln(v, w, b):
        return F.layer_norm(v.float(), (c,), w, b, eps).to(dtype)

    def gather(v):
        return axis_gather(v, 1, 'model', summed=True) \
            if sequence_parallel else copy_to_model(v)

    def reduce(partial, bias):
        v = axis_reduce_scatter(partial, 1, 'model') \
            if sequence_parallel else reduce_from_model(partial)
        return (v + bias.to(dtype).float()).to(dtype)

    def cast(name):
        return p[name].to(dtype) if name in p else None

    y = gather(ln(x, p['ln1_w'], p['ln1_b']))
    b, l, _ = y.shape
    qkv = F.linear(y, cast('qkv_w'), cast('qkv_b'))   # [b, L, 3C/mp]
    q, k, v = (t.view(b, l, num_heads_local, -1)
               for t in qkv.split(qkv.shape[-1] // 3, -1))
    out = flash_attention(q, k, v).reshape(b, l, -1)
    x = x + reduce(partial_product(out, p['proj_w'], dtype), p['proj_b'])
    z = gather(ln(x, p['ln2_w'], p['ln2_b']))
    h1 = F.gelu(F.linear(z, cast('fc1_w'), cast('fc1_b')))
    return x + reduce(partial_product(h1, p['fc2_w'], dtype), p['fc2_b'])


def pipeline_apply_tp(leaves: Sequence[Dict[str, Tensor]], x: Tensor,
                      num_microbatches: int, num_heads: int,
                      sequence_parallel: bool = False) -> Tensor:
    """GPipe over 'pipe' with each stage's layers tensor-parallel over
    'model' and each microbatch split over 'data' (JAX
    ``pipeline_apply_tp``).

    Args:
      leaves: this rank's stage, one dict of leaves a layer
        (``tp_stage_leaves``).
      x: [B, L, C] tokens, the same on every rank; B % M == 0 and each
        microbatch divides over the data axis.
      num_heads: the stack's heads; % model axis == 0.
      sequence_parallel: Megatron-SP; L % model axis == 0. The injected
        microbatches, the hops between stages and the banked outputs are
        then the rank's 1/mp of the tokens.

    Returns [B, L, C], the same on every rank.
    """
    mp = model_size()
    if num_heads % mp:
        raise ValueError(f'{num_heads} heads do not divide over a model '
                         f'axis of {mp}')
    if sequence_parallel and x.shape[1] % mp:
        raise ValueError(f'sequence parallelism splits the {x.shape[1]} '
                         f'tokens over {mp} model ranks: pad them to a '
                         f'multiple')
    if len(leaves) == 0:
        raise ValueError('a pipeline stage needs at least one layer')
    names = [(i, k) for i, p in enumerate(leaves) for k in p]
    summed = dict(zip(names, sum_grads([leaves[i][k] for i, k in names],
                                       'data')))
    if sequence_parallel:
        whole = [n for n in names if n[1] in _WHOLE]
        summed.update(zip(whole, sum_grads([summed[n] for n in whole],
                                           'model')))
    layers = [{k: summed[i, k] for k in p} for i, p in enumerate(leaves)]
    hl = num_heads // mp

    def run(act):
        for p in layers:
            act = _tp_block(p, act, hl, sequence_parallel=sequence_parallel)
        return act

    xs = _microbatches(x, num_microbatches)
    if sequence_parallel:
        xs = axis_slice(xs, 2, 'model')
    outs = _schedule(run, xs)
    if sequence_parallel:
        outs = axis_gather(outs, 2, 'model')
    return axis_gather(outs, 1, 'data').reshape(x.shape)
