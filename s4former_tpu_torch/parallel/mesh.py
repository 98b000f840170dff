"""The data axis over ``torch.distributed`` (counterpart of
``s4former_tpu/parallel/mesh.py``, its ``data`` axis only).

The rule, the JAX package's: the N-rank step computes the single-process
step on the global batch. Under ``jax.jit`` XLA derives each collective
from the sharding; here they are written out, and each function below is
the identity without a process group:

- ``shard_batch``: the rank's contiguous block of each batch array;
- ``replicate_state``: parameters, buffers, the EMA teacher and the SGD
  buffers broadcast from rank 0;
- ``all_reduce_grads``: the gradients summed over ranks in one flat bucket
  (each rank's loss is its share of the global loss, so the sum is the
  global gradient);
- ``global_sum``: an all-reduce that autograd goes through (its backward
  all-reduces the gradient): SyncBN's moments, the loss normalisers;
- ``gather_rows`` / ``local_rows``: the global batch assembled from every
  rank's block, and the rank's block of a global tensor (the mixes that
  pair sample i with another sample read across the blocks);
- ``draw_rows``: a random draw made at the global batch of which the rank
  keeps its rows, so every rank consumes the step's generator alike.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs both on CUDA
tensors too, so several ranks may share one card with gloo.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from s4former_tpu_torch.parallel.distributed import (local_batch_slice, rank,
                                                     world_size)

Tensor = torch.Tensor

# how many global batches a tensor's batch axis holds, stacked (the train
# step's fused pass runs [unmixed; mixed] as one batch)
_SEGMENTS = contextvars.ContextVar('s4_batch_segments', default=1)


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
    """Broadcast the state's tensors from rank 0, in place."""
    if world_size() > 1:
        with torch.no_grad():
            for t in _state_tensors(state):
                dist.broadcast(t, 0)
    return state


def all_reduce_grads(grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Every gradient summed over the ranks, through one flat bucket."""
    if world_size() == 1:
        return grads
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    dist.all_reduce(flat)
    out, i = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return out


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: Tensor) -> Tensor:
    """The sum of ``x`` over the ranks. Differentiable: the loss on every
    rank depends on every rank's ``x``, so the gradient is all-reduced."""
    if world_size() == 1:
        return x
    return _GlobalSum.apply(x)


def gather_rows(x: Tensor) -> Tensor:
    """The global batch from every rank's block of ``x`` (no gradient):
    an all-reduce sum of a zero buffer holding this rank's rows, exact
    since x + 0 = x."""
    n = world_size()
    if n == 1:
        return x
    b = x.shape[0]
    wire = x.detach()
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    out = wire.new_zeros((n * b,) + tuple(x.shape[1:]))
    out[rank() * b:(rank() + 1) * b] = wire
    dist.all_reduce(out)
    return out.to(x.dtype)


def local_rows(x: Tensor, segments: int = 1) -> Tensor:
    """The rank's rows of a global tensor. With ``segments`` > 1 the batch
    axis holds that many global batches stacked, and the rank's block of
    each is kept, in order."""
    n = world_size()
    if n == 1:
        return x
    per = x.shape[0] // (segments * n)
    view = x.reshape((segments, n, per) + tuple(x.shape[1:]))
    return view[:, rank()].reshape((segments * per,) + tuple(x.shape[1:]))


def draw_rows(draw: Callable[[Sequence[int]], Tensor],
              shape: Sequence[int]) -> Tensor:
    """``draw(shape)`` for a local ``shape`` whose first axis is the batch:
    made at the global batch (under ``stacked_batches``, of each stacked
    batch) and cut to this rank's rows."""
    n = world_size()
    if n == 1:
        return draw(tuple(shape))
    segments = _SEGMENTS.get()
    return local_rows(draw((shape[0] * n,) + tuple(shape[1:])), segments)
