"""The rank grid over ``torch.distributed`` (counterpart of
``s4former_tpu/parallel/mesh.py``, and of the meshes of JAX
``parallel/pp.py`` and ``parallel/ring_attention.py``).

The rule, the JAX package's: the N-rank step computes the single-process
step on the global batch. Under ``jax.jit`` XLA derives each collective
from the sharding; here they are written out, and each function below is
the identity without a process group.

``make_mesh(model_parallel)`` lays the ranks out as JAX ``make_mesh``
does: rank r is data index r // mp and model index r % mp, with one
``dist.new_group`` per data axis and per model axis. ``make_pp_mesh``,
``make_pp_tp_mesh`` and ``make_cp_mesh`` add a pipe axis (the stages of
``parallel/pp.py``) and a ctx axis (the rings of
``parallel/ring_attention.py``) in their JAX layouts; ``reset_mesh`` undoes
any of them. The data axis's collectives (each over the rank's data group;
the world without a grid):

- ``shard_batch``: the data index's contiguous block of each batch array;
- ``replicate_state``: parameters, buffers, the EMA teacher and the SGD
  buffers broadcast from rank 0 (over the world, before any sharding);
- ``all_reduce_grads``: the gradients summed over the data axis in one
  flat bucket (each data index's loss is its share of the global loss, so
  the sum is the global gradient); ``broadcast_from_model`` then gives the
  gradients of the tensors every model rank holds whole the values of the
  model group's first rank;
- ``global_sum``: an all-reduce that autograd goes through (its backward
  all-reduces the gradient): SyncBN's moments, the loss normalisers;
- ``gather_rows`` / ``local_rows``: the global batch assembled from every
  data index's block, and the block of a global tensor (the mixes that
  pair sample i with another sample read across the blocks);
- ``draw_rows``: a random draw made at the global batch of which the rank
  keeps its rows, so every rank consumes the step's generator alike.

The model axis's (Megatron's conjugate pair, Shoeybi et al. 2019, and the
ZeRO-3 gather; ``parallel/tp.py`` places them):

- ``copy_to_model``: identity forward, all-reduce backward over the model
  group (before a column-split product);
- ``reduce_from_model``: all-reduce forward over the model group, identity
  backward (after a row-split product);
- ``model_slice``: the model index's chunk of a replicated tensor, whose
  backward gathers the chunks' gradients over the model group;
- ``gather_from_data``: a ZeRO-3 shard all-gathered over the data group,
  its gradient reduce-scattered back.

Those four are cases of collectives over any axis that autograd goes
through, which the pipeline and the ring use as they are:

- ``ppermute(x, axis, shift)``: JAX ``lax.ppermute`` by a shift (a
  pipeline's hop to the next stage, a ring's k/v rotation); its backward
  shifts back;
- ``axis_sum``: all-reduce forward, identity backward (a pipeline's final
  sum over 'pipe');
- ``sum_grads``: identity forward, the gradients all-reduced in one
  bucket (a stage's parameters over 'data');
- ``axis_slice`` / ``axis_gather``: a rank's chunk of a tensor every rank
  holds, and the chunks gathered, each the other's backward (a batch's
  rows, a sequence's chunk); ``axis_gather(summed=True)`` and
  ``axis_reduce_scatter`` are Megatron-SP's conjugate pair.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs both on CUDA
tensors too, so several ranks may share one card with gloo.
``all_gather`` and ``reduce_scatter`` are written on ``all_reduce``: a
gather sums zero buffers that each hold one rank's chunk (x + 0 = x, so
it is exact); a reduce-scatter all-reduces and keeps the rank's chunk.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from s4former_tpu_torch.parallel import distributed as _dist
from s4former_tpu_torch.parallel.distributed import (ctx_group, ctx_rank,
                                                     ctx_size, data_group,
                                                     data_rank, data_size,
                                                     local_batch_slice,
                                                     model_group, model_rank,
                                                     model_size, pipe_group,
                                                     pipe_rank, pipe_size,
                                                     world_size)

Tensor = torch.Tensor

# how many global batches a tensor's batch axis holds, stacked (the train
# step's fused pass runs [unmixed; mixed] as one batch)
_SEGMENTS = contextvars.ContextVar('s4_batch_segments', default=1)


def _make_grid(what: str, pp: int = 1, cp: int = 1, mp: int = 1) -> None:
    """Lay the world out as the (data, pipe, ctx, model) grid of these axis
    sizes, the model axis fastest (``parallel.distributed``'s rank rule),
    with one ``dist.new_group`` per row of each axis longer than 1 and of
    the data axis. Every rank creates every group, in the same order."""
    n = world_size()
    inner = pp * cp * mp
    if min(pp, cp, mp) < 1 or n % inner:
        raise ValueError(f'{n} ranks do not divide into {what}')
    grid = {'pp': pp, 'cp': cp, 'mp': mp, 'data': None, 'pipe': None,
            'ctx': None, 'model': None}
    if inner > 1:
        r = _dist.rank()
        for axis, size, stride in (('data', n // inner, inner),
                                   ('pipe', pp, cp * mp), ('ctx', cp, mp),
                                   ('model', mp, 1)):
            if axis != 'data' and size == 1:
                continue
            for first in range(n):
                if first // stride % size:
                    continue
                ranks = [first + i * stride for i in range(size)]
                g = dist.new_group(ranks)
                if r in ranks:
                    grid[axis] = g
    _dist._GRID.update(grid)


def make_mesh(model_parallel: int = 1) -> None:
    """Lay the world out as a (data, model) grid of ``model_parallel``
    model ranks (JAX ``make_mesh``): rank r is data index r // mp, model
    index r % mp. Every rank must call it. mp = 1 keeps the world as the
    data axis and makes no group."""
    _make_grid(f'model axes of {model_parallel}', mp=model_parallel)


def make_pp_mesh(num_stages: int) -> None:
    """A (data, pipe) grid of ``num_stages`` stages, pipe fastest (JAX
    ``parallel/pp.py:make_pp_mesh``): rank r is data index r // S, stage
    r % S, so neighbouring stages are neighbouring ranks."""
    _make_grid(f'pipelines of {num_stages} stages', pp=num_stages)


def make_pp_tp_mesh(num_stages: int, model_parallel: int) -> None:
    """A (data, pipe, model) grid (JAX ``make_pp_tp_mesh``): rank r is
    data index r // (S mp), stage r // mp % S, model index r % mp."""
    _make_grid(f'{num_stages} stages of {model_parallel} model ranks',
               pp=num_stages, mp=model_parallel)


def make_cp_mesh(context_parallel: Optional[int] = None) -> None:
    """A (data, ctx) grid of rings of ``context_parallel`` ranks (default:
    the world, JAX ``parallel/ring_attention.py:make_cp_mesh``'s 1-D
    ('ctx',) mesh); rank r is data index r // cp, ring position r % cp."""
    cp = world_size() if context_parallel is None else context_parallel
    _make_grid(f'rings of {cp}', cp=cp)


def reset_mesh() -> None:
    """Back to no grid (before the process group is destroyed)."""
    _dist._GRID.update(pp=1, cp=1, mp=1, data=None, pipe=None, ctx=None,
                       model=None)


def _all_reduce(t: Tensor, group) -> Tensor:
    dist.all_reduce(t, group=group)
    return t


def all_gather(x: Tensor, dim: int, group, index: int, n: int) -> Tensor:
    """The ``n`` ranks' equal chunks of ``x`` concatenated along ``dim``;
    this rank's is chunk ``index`` (zero buffers summed: exact)."""
    if n == 1:
        return x
    size = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = size * n
    out = x.new_zeros(shape)
    out.narrow(dim, index * size, size).copy_(x)
    return _all_reduce(out, group)


def reduce_scatter(x: Tensor, dim: int, group, index: int,
                   n: int) -> Tensor:
    """Chunk ``index`` along ``dim`` of the sum of ``x`` over the ranks."""
    if n == 1:
        return x
    total = _all_reduce(x.clone(), group)
    return total.chunk(n, dim)[index].contiguous()


@contextlib.contextmanager
def stacked_batches(segments: int):
    """Within: the batch axis of a draw holds ``segments`` local blocks,
    each of another global batch, one after the other."""
    token = _SEGMENTS.set(segments)
    try:
        yield
    finally:
        _SEGMENTS.reset(token)


def shard_batch(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The rank's contiguous block of every array of a global batch."""
    return {k: v[local_batch_slice(v.shape[0])] for k, v in batch.items()}


def _state_tensors(state) -> list:
    tensors = list(state.model.state_dict().values())
    if state.ema_model is not None:
        tensors += list(state.ema_model.state_dict().values())
    return tensors + list(state.momentum.values())


def replicate_state(state):
    """Broadcast the state's tensors from rank 0, in place (over the
    world: the state is whole here, before ``parallel.tp`` cuts it)."""
    if world_size() > 1:
        with torch.no_grad():
            for t in _state_tensors(state):
                dist.broadcast(t, 0)
    return state


def _through_bucket(grads: Dict[str, Tensor], names: Sequence[str],
                    collective: Callable[[Tensor], None]
                    ) -> Dict[str, Tensor]:
    """``grads`` with those named in ``names`` replaced by the result of
    one ``collective`` on a flat bucket of them."""
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    collective(flat)
    out, i = dict(grads), 0
    for n in names:
        g = grads[n]
        out[n] = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return out


def all_reduce_grads(grads: Dict[str, Tensor],
                     summed: Sequence[str] = ()) -> Dict[str, Tensor]:
    """Every gradient summed over the data axis, through one flat bucket;
    those named in ``summed`` (ZeRO-3 shards, whose backward has already
    reduce-scattered them) pass as they are."""
    names = [n for n in grads if n not in summed]
    if data_size() == 1 or not names:
        return grads
    return _through_bucket(grads, names, lambda flat: dist.all_reduce(
        flat, group=data_group()))


def broadcast_from_model(grads: Dict[str, Tensor],
                         names: Sequence[str]) -> Dict[str, Tensor]:
    """The gradients named in ``names`` (those every model rank computes
    whole) as the model group's first rank has them, through one flat
    bucket. Each model rank computes them from the same inputs, but on the
    card atomic adds (``index_add_``, the fused backward's dq) sum in a
    run-dependent order: without this the ranks' copies drift apart."""
    if model_size() == 1 or not names:
        return grads
    first = _dist.rank() - model_rank()
    return _through_bucket(grads, names, lambda flat: dist.broadcast(
        flat, first, group=model_group()))


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(), data_group())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), data_group())


def global_sum(x: Tensor) -> Tensor:
    """The sum of ``x`` over the data axis. Differentiable: the loss on
    every rank depends on every data index's ``x``, so the gradient is
    all-reduced."""
    if data_size() == 1:
        return x
    return _GlobalSum.apply(x)


def gather_rows(x: Tensor) -> Tensor:
    """The global batch from every data index's block of ``x`` (no
    gradient)."""
    if data_size() == 1:
        return x
    wire = x.detach()
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    return all_gather(wire, 0, data_group(), data_rank(),
                      data_size()).to(x.dtype)


def local_rows(x: Tensor, segments: int = 1) -> Tensor:
    """The data index's rows of a global tensor. With ``segments`` > 1 the
    batch axis holds that many global batches stacked, and the block of
    each is kept, in order."""
    n = data_size()
    if n == 1:
        return x
    per = x.shape[0] // (segments * n)
    view = x.reshape((segments, n, per) + tuple(x.shape[1:]))
    return view[:, data_rank()].reshape((segments * per,) +
                                        tuple(x.shape[1:]))


def draw_rows(draw: Callable[[Sequence[int]], Tensor],
              shape: Sequence[int]) -> Tensor:
    """``draw(shape)`` for a local ``shape`` whose first axis is the batch:
    made at the global batch (under ``stacked_batches``, of each stacked
    batch) and cut to this rank's rows."""
    n = data_size()
    if n == 1:
        return draw(tuple(shape))
    segments = _SEGMENTS.get()
    return local_rows(draw((shape[0] * n,) + tuple(shape[1:])), segments)


# --------------------------------------------- collectives autograd sees
_AXES = {'data': (data_group, data_rank, data_size),
         'pipe': (pipe_group, pipe_rank, pipe_size),
         'ctx': (ctx_group, ctx_rank, ctx_size),
         'model': (model_group, model_rank, model_size)}


def _axis_of(axis: str) -> Tuple[object, int, int]:
    """(process group, this rank's index, size) of grid axis ``axis``:
    'data', 'pipe', 'ctx' or 'model'."""
    group, index, size = _AXES[axis]
    return group(), index(), size()


def _chunk(x: Tensor, dim: int, index: int, n: int) -> Tensor:
    return x.chunk(n, dim)[index].clone(memory_format=torch.contiguous_format)


def _shift(x: Tensor, group, index: int, n: int, shift: int) -> Tensor:
    """Rank ``index`` receives the ``x`` of rank ``index - shift`` (mod
    n): each rank's ``x`` in its own slot of a zero buffer, all-reduced."""
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[index] = x
    return _all_reduce(buf, group)[(index - shift) % n]


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the axis,
    all of them through one flat bucket."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        group = _axis_of(ctx.axis)[0]
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           group)
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
            i += g.numel()
        return (None, *out)


class _Sum(torch.autograd.Function):
    """The sum over the axis; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x.clone(), _axis_of(axis)[0])

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Slice(torch.autograd.Function):
    """The axis index's chunk along ``dim``; the backward gathers the
    chunks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        _, index, n = _axis_of(axis)
        return _chunk(x, dim, index, n)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.dim,
                          *_axis_of(ctx.axis)), None, None


class _Gather(torch.autograd.Function):
    """The axis's chunks concatenated along ``dim``. The backward either
    reduce-scatters (``summed``: each rank's gradient of the whole is a
    part) or keeps the rank's chunk (each rank holds the same gradient)."""

    @staticmethod
    def forward(ctx, x, dim, axis, summed):
        ctx.dim, ctx.axis, ctx.summed = dim, axis, summed
        return all_gather(x.detach().contiguous(), dim, *_axis_of(axis))

    @staticmethod
    def backward(ctx, grad):
        group, index, n = _axis_of(ctx.axis)
        grad = grad.contiguous()
        out = reduce_scatter(grad, ctx.dim, group, index, n) \
            if ctx.summed else _chunk(grad, ctx.dim, index, n)
        return out, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The axis index's chunk along ``dim`` of the sum over the axis; the
    backward gathers."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return reduce_scatter(x.contiguous(), dim, *_axis_of(axis))

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.dim,
                          *_axis_of(ctx.axis)), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _shift(x.contiguous(), *_axis_of(axis), shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad.contiguous(), *_axis_of(ctx.axis),
                      -ctx.shift), None, None


def _one(axis: str) -> bool:
    return _axis_of(axis)[2] == 1


def sum_grads(tensors: Sequence[Tensor], axis: str) -> Tuple[Tensor, ...]:
    """The tensors as they are, each gradient summed over the axis in one
    flat bucket: for tensors every rank of the axis holds alike and uses
    on its own part of the work (a stage's parameters over 'data'; under
    sequence parallelism the LayerNorms and whole biases over 'model')."""
    if _one(axis) or not tensors:
        return tuple(tensors)
    return _SumGrads.apply(axis, *tensors)


def axis_sum(x: Tensor, axis: str) -> Tensor:
    """The sum of ``x`` over the axis, its gradient passed as it is (JAX's
    final ``psum`` of a pipeline, whose loss is taken on the replicated
    output)."""
    return x if _one(axis) else _Sum.apply(x, axis)


def axis_slice(x: Tensor, dim: int, axis: str) -> Tensor:
    """The axis index's chunk along ``dim`` of a tensor every rank of the
    axis holds whole; its gradient is the chunks' gradients gathered, so
    the whole tensor's gradient is the same on every rank."""
    return x if _one(axis) else _Slice.apply(x, dim, axis)


def axis_gather(x: Tensor, dim: int, axis: str,
                summed: bool = False) -> Tensor:
    """The axis's chunks of ``x`` concatenated along ``dim``. Gradient:
    with ``summed``, the sum of the ranks' gradients, reduce-scattered
    (Megatron-SP's gather before a column-split product); else the rank's
    chunk of a gradient every rank holds alike (a loss taken on the
    gathered tensor on each rank)."""
    return x if _one(axis) else _Gather.apply(x, dim, axis, summed)


def axis_reduce_scatter(x: Tensor, dim: int, axis: str) -> Tensor:
    """The axis index's chunk along ``dim`` of the sum of ``x`` over the
    axis (Megatron-SP's reduce after a row-split product); its gradient is
    gathered."""
    return x if _one(axis) else _ReduceScatter.apply(x, dim, axis)


def ppermute(x: Tensor, axis: str, shift: int = 1) -> Tensor:
    """JAX ``lax.ppermute`` with the permutation i -> i + shift (mod n)
    over the axis: each rank gets the ``x`` of the rank ``shift`` before
    it. Written on ``all_reduce`` (the file's rule): a buffer of n slots,
    each rank's ``x`` in its own, summed. Its gradient travels the
    reversed shift."""
    return x if _one(axis) else _PPermute.apply(x, axis, shift)


# ------------------------------------------------------------ model axis
def copy_to_model(x: Tensor) -> Tensor:
    """``x`` as it is; its gradient summed over the model group (the
    input of a column-split product, whose ranks each give a part)."""
    return sum_grads([x], 'model')[0]


def reduce_from_model(x: Tensor) -> Tensor:
    """The sum of the model group's partial products (a row-split
    product's output); the gradient passes as it is."""
    return axis_sum(x, 'model')


def model_slice(x: Tensor, dim: int) -> Tensor:
    """The model index's chunk along ``dim`` of a tensor every model rank
    holds whole; its gradient is the chunks' gradients gathered, so the
    whole tensor's gradient is the same on every model rank."""
    return axis_slice(x, dim, 'model')


def gather_from_data(x: Tensor, dim: int) -> Tensor:
    """A ZeRO-3 shard (chunk ``data_rank()`` along ``dim``) all-gathered
    over the data group; the gradient is reduce-scattered: summed over the
    data axis, the rank keeping its chunk."""
    return axis_gather(x, dim, 'data', summed=True)


def param(module: torch.nn.Module, name: str) -> Tensor:
    """``module``'s parameter ``name`` whole for use: a ZeRO-3 shard
    (``parallel.tp.shard_state`` lists it in ``module.zero3_dims``) is
    gathered over the data group, anything else returned as it is."""
    p = getattr(module, name)
    dim = getattr(module, 'zero3_dims', {}).get(name)
    return p if dim is None else gather_from_data(p, dim)
