"""The (data, model) rank grid over ``torch.distributed`` (counterpart of
``s4former_tpu/parallel/mesh.py``).

The rule, the JAX package's: the N-rank step computes the single-process
step on the global batch. Under ``jax.jit`` XLA derives each collective
from the sharding; here they are written out, and each function below is
the identity without a process group.

``make_mesh(model_parallel)`` lays the ranks out as JAX ``make_mesh``
does: rank r is data index r // mp and model index r % mp, with one
``dist.new_group`` per data axis and per model axis. The data axis's
collectives (each over the rank's data group; the world when mp = 1):

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

Only ``all_reduce`` and ``broadcast`` are used: gloo runs both on CUDA
tensors too, so several ranks may share one card with gloo.
``all_gather`` and ``reduce_scatter`` are written on ``all_reduce``: a
gather sums zero buffers that each hold one rank's chunk (x + 0 = x, so
it is exact); a reduce-scatter all-reduces and keeps the rank's chunk.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from s4former_tpu_torch.parallel import distributed as _dist
from s4former_tpu_torch.parallel.distributed import (data_group, data_rank,
                                                     data_size,
                                                     local_batch_slice,
                                                     model_group, model_rank,
                                                     model_size, world_size)

Tensor = torch.Tensor

# how many global batches a tensor's batch axis holds, stacked (the train
# step's fused pass runs [unmixed; mixed] as one batch)
_SEGMENTS = contextvars.ContextVar('s4_batch_segments', default=1)


def make_mesh(model_parallel: int = 1) -> None:
    """Lay the world out as a (data, model) grid of ``model_parallel``
    model ranks (JAX ``make_mesh``); every rank must call it. mp = 1 keeps
    the world as the data axis and makes no group."""
    n = world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f'{n} ranks do not divide into model axes of '
                         f'{model_parallel}')
    grid = {'mp': model_parallel, 'data': None, 'model': None}
    if model_parallel > 1:
        r, dp = _dist.rank(), n // model_parallel
        # every rank creates every group, in the same order
        for m in range(model_parallel):
            g = dist.new_group([d * model_parallel + m for d in range(dp)])
            if r % model_parallel == m:
                grid['data'] = g
        for d in range(dp):
            g = dist.new_group(list(range(d * model_parallel,
                                          (d + 1) * model_parallel)))
            if r // model_parallel == d:
                grid['model'] = g
    _dist._GRID.update(grid)


def reset_mesh() -> None:
    """Back to no grid (before the process group is destroyed)."""
    _dist._GRID.update(mp=1, data=None, model=None)


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


# ------------------------------------------------------------ model axis
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), model_group())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(), model_group())

    @staticmethod
    def backward(ctx, grad):
        return grad


class _ModelSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.chunk(model_size(), dim)[model_rank()].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.dim, model_group(),
                          model_rank(), model_size()), None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return all_gather(x.detach(), dim, data_group(), data_rank(),
                          data_size())

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.contiguous(), ctx.dim, data_group(),
                              data_rank(), data_size()), None


def copy_to_model(x: Tensor) -> Tensor:
    """``x`` as it is; its gradient summed over the model group (the
    input of a column-split product, whose ranks each give a part)."""
    return _CopyToModel.apply(x) if model_size() > 1 else x


def reduce_from_model(x: Tensor) -> Tensor:
    """The sum of the model group's partial products (a row-split
    product's output); the gradient passes as it is."""
    return _ReduceFromModel.apply(x) if model_size() > 1 else x


def model_slice(x: Tensor, dim: int) -> Tensor:
    """The model index's chunk along ``dim`` of a tensor every model rank
    holds whole; its gradient is the chunks' gradients gathered, so the
    whole tensor's gradient is the same on every model rank."""
    return _ModelSlice.apply(x, dim) if model_size() > 1 else x


def gather_from_data(x: Tensor, dim: int) -> Tensor:
    """A ZeRO-3 shard (chunk ``data_rank()`` along ``dim``) all-gathered
    over the data group; the gradient is reduce-scattered: summed over the
    data axis, the rank keeping its chunk."""
    return _GatherFromData.apply(x, dim) if data_size() > 1 else x


def param(module: torch.nn.Module, name: str) -> Tensor:
    """``module``'s parameter ``name`` whole for use: a ZeRO-3 shard
    (``parallel.tp.shard_state`` lists it in ``module.zero3_dims``) is
    gathered over the data group, anything else returned as it is."""
    p = getattr(module, name)
    dim = getattr(module, 'zero3_dims', {}).get(name)
    return p if dim is None else gather_from_data(p, dim)
