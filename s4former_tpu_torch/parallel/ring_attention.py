"""Ring attention: context parallelism over the token axis (counterpart of
``s4former_tpu/parallel/ring_attention.py``).

As in the JAX package this is a library for long-token variants: no config
or CLI flag reaches it. The ranks of a ring (the 'ctx' axis of
``parallel.mesh.make_cp_mesh``) each hold one chunk of the sequence's
queries, keys and values; the k/v chunks travel round the ring one hop a
step (``mesh.ppermute``), so no rank holds the whole sequence's keys or an
[L, L] score matrix. The result is exact attention.

- Forward: each ring step is one launch of the flash forward (kernel #1)
  on the local queries and the k/v chunk held, ``flash_attention_fwd(q,
  k_blk, v_blk, bias_blk) -> (o_i, lse_i)``, and the blocks are merged by
  log-sum-exp in f32: JAX's online-softmax recurrence (l.55-83) taken a
  block at a time.
- Backward (``RingAttention``, a ``torch.autograd.Function``): it saves
  the local q, k, v, the merged o and lse; each step calls
  ``flash_attention_bwd(q, k_blk, v_blk, bias_blk, o, lse, do)``, which,
  given the global o and lse, returns the block's exact share of dq, dk
  and dv. dq sums on the rank; dk and dv sum in f32 buffers that travel
  with their k/v chunk and take one more hop at the end, to the rank that
  owns it. The kernels: the fused backward (#2) for chunks of up to
  ``FULL_Q_MAX`` tokens, the dk/dv and dq kernels (#3, #4) above.
- The PASA bias stays put: a rank holds its queries' rows [B, 1|H, L/cp,
  L] and each step reads the column block of the chunk it holds, a
  strided view the kernels take as it is.
- On CPU tensors the same code runs the kernels' plain versions.

Deliberate differences from JAX (``ROADMAP.md``): the bias gets no
gradient, by the flash functions' contract, so a bias that requires one
raises ValueError where JAX would differentiate it; in bf16 each block's o
is rounded to bf16 by the kernel before the f32 merge, where JAX rounds
once after an f32 sum; the rotation is written on ``all_reduce``
(``mesh.ppermute``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from s4former_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                    flash_attention_fwd)
from s4former_tpu_torch.parallel.distributed import ctx_rank, ctx_size
from s4former_tpu_torch.parallel.mesh import (axis_gather, axis_slice,
                                              ppermute)

Tensor = torch.Tensor


def _bias_block(bias: Optional[Tensor], src: int,
                lk: int) -> Optional[Tensor]:
    """The columns of k/v chunk ``src`` of the local query rows."""
    return None if bias is None else bias[..., src * lk:(src + 1) * lk]


def _merge(o: Tensor, lse: Tensor, o_i: Tensor,
           lse_i: Tensor) -> Tuple[Tensor, Tensor]:
    """Two blocks' normalised outputs (o [B, L, H, D] f32, lse [B, H, L])
    as the one over both key sets."""
    new = torch.logaddexp(lse, lse_i)

    def weight(t):
        return torch.exp(t - new).transpose(1, 2).unsqueeze(-1)
    return o * weight(lse) + o_i.float() * weight(lse_i), new


def ring_attention_fwd(q: Tensor, k: Tensor, v: Tensor,
                       bias: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """(o [B, Lq, H, D] in q's dtype, lse [B, H, Lq] f32) over the whole
    ring's keys, no autograd. Every rank of the ring must call it."""
    rank, cp = ctx_rank(), ctx_size()
    lk = k.shape[1]
    kv = torch.stack([k, v])
    o = lse = None
    for i in range(cp):
        src = (rank - i) % cp       # after i hops the rank holds chunk src
        o_i, lse_i = flash_attention_fwd(q, kv[0], kv[1],
                                         _bias_block(bias, src, lk))
        o, lse = (o_i.float(), lse_i) if o is None else \
            _merge(o, lse, o_i, lse_i)
        if i != cp - 1:
            kv = ppermute(kv, 'ctx')
    return o.to(q.dtype), lse


class RingAttention(torch.autograd.Function):
    """o = ring attention of the local chunks; the backward launches the
    backward kernels a block at a time (module docstring). The bias gets
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = ring_attention_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        rank, cp = ctx_rank(), ctx_size()
        lk = k.shape[1]
        kv = torch.stack([k, v])
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(cp):
            src = (rank - i) % cp
            dq_i, dk_i, dv_i = flash_attention_bwd(
                q, kv[0], kv[1], _bias_block(bias, src, lk), o, lse, do)
            dq += dq_i.float()
            dkv[0] += dk_i.float()
            dkv[1] += dv_i.float()
            if i != cp - 1:
                kv = ppermute(kv, 'ctx')
            # the sums travel with their chunk; the last hop takes them
            # home (chunk src + 1 after the loop's cp - 1 hops)
            dkv = ppermute(dkv, 'ctx')
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None


def _refuse_bias_grad(bias: Optional[Tensor]) -> None:
    if bias is not None and bias.requires_grad:
        raise ValueError('ring attention gives the bias no gradient (the '
                         'flash kernels do not compute one); pass a bias '
                         'that does not require grad, e.g. bias.detach()')


def ring_attention(q: Tensor, k: Tensor, v: Tensor,
                   bias: Optional[Tensor] = None) -> Tensor:
    """Exact attention with k, v split over the ring (JAX
    ``ring_attention``; call on every rank of the ring).

    Shapes (the rank's): q, k, v [B, L/cp, H, D], the rank's chunk of a
    sequence split in order (rank r holds tokens r L/cp ..); bias
    [B, 1|H, L/cp, L] (the local queries' rows, every key's column) in q's
    dtype, not requiring grad, or None. Returns [B, L/cp, H, D],
    differentiable in q, k and v."""
    _refuse_bias_grad(bias)
    lq, lk, cp = q.shape[1], k.shape[1], ctx_size()
    if lq != lk:
        raise ValueError(f'the ring takes equal chunks of queries and keys; '
                         f'got {lq} and {lk}')
    if bias is not None and tuple(bias.shape[2:]) != (lq, lk * cp):
        raise ValueError(f'bias must be [B, 1|H, {lq}, {lk * cp}] (the '
                         f'local rows, every column); got '
                         f'{tuple(bias.shape)}')
    return RingAttention.apply(q, k, v, bias)


def ring_attention_sharded(q: Tensor, k: Tensor, v: Tensor,
                           bias: Optional[Tensor] = None) -> Tensor:
    """Whole-shape entry (JAX ``ring_attention_sharded``): q, k, v
    [B, L, H, D] and bias [B, 1|H, L, L] (or None), the same on every rank
    of the ring, L % cp == 0. Each rank takes its chunk of the tokens (and
    the bias's rows), runs the ring and gathers the output: [B, L, H, D]
    on every rank, whose gradients come back whole on every rank."""
    _refuse_bias_grad(bias)
    cp = ctx_size()
    if q.shape[1] % cp:
        raise ValueError(f'{q.shape[1]} tokens do not split over a ring of '
                         f'{cp}')
    ql, kl, vl = (axis_slice(t, 1, 'ctx') for t in (q, k, v))
    bl = None if bias is None else bias.chunk(cp, 2)[ctx_rank()]
    return axis_gather(ring_attention(ql, kl, vl, bl), 1, 'ctx')
