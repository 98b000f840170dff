"""Flash attention with an additive logit bias, forward and backward, for
Hopper.

Counterpart of ``s4former_tpu/ops/flash_attention.py``. The TPU package runs
Pallas kernels; here the same functions are the hand-written CUDA kernels
``csrc/flash_attn_fwd.cu`` (forward) and ``csrc/flash_attn_bwd.cu`` (the
three backward kernels), bound with ``ctypes``. In bf16 every kernel runs
on the tensor cores (``csrc/flash_attn_tc.cuh``) and needs 16-byte aligned
q, k, v and do (``check_tc_alignment``); in f32 every kernel runs on the
FMA pipes. The ViT calls
``flash_attention`` once per layer, with the PASA bias ``[B, 1, L, L]`` on
the teacher-PASA and PASA-pass paths and with no bias otherwise; in training
its gradient runs the backward kernels.

- ``flash_attention(q, k, v, bias)`` -> ``o``: the differentiable entry
  point (``FlashAttention``, a ``torch.autograd.Function`` standing for the
  JAX ``custom_vjp``). The bias comes in the q dtype (the ViT casts it
  once per forward, where the JAX wrapper casts it in every call,
  l.606-612) and gets no gradient, as the wrapper's ``stop_gradient``.
- ``flash_attention_fwd(q, k, v, bias)`` -> ``(o, lse)`` and
  ``flash_attention_bwd(q, k, v, bias, o, lse, do)`` -> ``(dq, dk, dv)``:
  CUDA tensors launch the kernels (or raise); CPU tensors take the plain
  versions ``flash_attention_reference`` and
  ``flash_attention_backward_reference``, which are also what the kernels
  are held to on the card. The backward kernels take
  ``row_delta(o, do)``, computed once per backward.
- The backward dispatches as the JAX one does (l.421, 627-635): up to
  ``FULL_Q_MAX`` tokens the fused dq+dk+dv kernel, above it the dk/dv
  kernel and the dq kernel.
- ``launch_count`` (forward), ``fused_launch_count``, ``dkv_launch_count``
  and ``dq_launch_count`` count kernel launches, so a run can show that its
  path went through the kernels.

Layout: q, k, v ``[B, L, H, D]`` (the last axis contiguous; other strides
are passed to the kernels, so the fused qkv projection's slices need no
copy); bias ``[B, 1|H, L, L]``; o, dq, dk, dv ``[B, L, H, D]`` in the q
dtype; lse and delta ``[B, H, L]`` f32. A bias of another dtype than q is
refused.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s4former_tpu_torch.ops import cuda_build

SOURCE = 'flash_attn_fwd.cu'
BWD_SOURCE = 'flash_attn_bwd.cu'
HEAD_DIM = 64
# longest sequence whose backward takes the fused kernel (the JAX wrapper's
# single-q-block limit, flash_attention.py:53)
FULL_Q_MAX = 1536
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
fused_launch_count = 0
dkv_launch_count = 0
dq_launch_count = 0
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL, names, n_ptr: int) -> ctypes.CDLL:
    i64, ptr, c_int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + [i64] * 12 + [c_int] * 5 + [ptr]
        fn.restype = c_int
    lib.s4_cuda_error_string.argtypes = [c_int]
    lib.s4_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the forward kernel's library."""
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load(SOURCE), ['s4_flash_attn_fwd'], 6)
    return _lib


def load_bwd_library() -> ctypes.CDLL:
    """Build (first use only) and load the backward kernels' library."""
    global _bwd_lib
    if _bwd_lib is None:
        _bwd_lib = _bind(cuda_build.load(BWD_SOURCE),
                         ['s4_flash_attn_bwd_fused', 's4_flash_attn_bwd_dkv',
                          's4_flash_attn_bwd_dq'], 10)
    return _bwd_lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (o [B,L,H,D] in q's dtype, lse [B,H,L] f32); the bias
    in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * \
        (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias.float()
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)
    return o, lse


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in f32, [B, H, L] (the JAX ``_bwd`` l.418)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       bias: Optional[torch.Tensor],
                                       o: torch.Tensor, lse: torch.Tensor,
                                       do: torch.Tensor
                                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch backward from the saved lse, with the kernels' rounding
    points: p and ds are rounded to the input dtype before their products,
    which accumulate in f32 (JAX l.228-243, 287-301)."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.to(dt).float()
    s = torch.einsum('bqhd,bkhd->bhqk', qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(dt).float(), dof)
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, vf)
    ds = (p * (dp - row_delta(o, do)[..., None])).to(dt).float()
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qf) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(q, k, v, bias):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'q, k, v must share one [B, L, H, D] shape; got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f'q, k, v must all be float32 or bfloat16; got '
                        f'{q.dtype}, {k.dtype}, {v.dtype}')
    if not (q.device == k.device == v.device):
        raise ValueError('q, k, v lie on different devices')
    b, l, h, _ = q.shape
    if bias is not None:
        if (bias.dim() != 4 or bias.shape[0] != b or bias.shape[1] not in (1, h)
                or tuple(bias.shape[2:]) != (l, l)):
            raise ValueError(f'bias must be [B, 1|H, L, L] = [{b}, 1|{h}, '
                             f'{l}, {l}]; got {tuple(bias.shape)}')
        if bias.device != q.device:
            raise ValueError('bias lies on another device than q')
        if bias.dtype != q.dtype:
            raise TypeError(f'bias must be in the q dtype {q.dtype}; got '
                            f'{bias.dtype}')
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'flash_attention runs on CUDA or CPU tensors, '
                         f'not {q.device}')


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse). CUDA tensors launch the kernel; CPU tensors take the plain
    version. Anything else raises."""
    _check(q, k, v, bias)
    if q.device.type == 'cpu':
        return flash_attention_reference(q, k, v, bias)
    return _launch_fwd(q, k, v, bias)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's o and lse. CUDA tensors launch the
    fused kernel up to ``FULL_Q_MAX`` tokens and the dk/dv + dq kernels
    above it; CPU tensors take the plain version."""
    _check(q, k, v, bias)
    if q.device.type == 'cpu':
        return flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    do = do.to(q.dtype).contiguous()
    delta = row_delta(o, do)
    if q.shape[1] <= FULL_Q_MAX:
        return launch_bwd_fused(q, k, v, bias, do, lse, delta)
    dk, dv = launch_bwd_dkv(q, k, v, bias, do, lse, delta)
    return launch_bwd_dq(q, k, v, bias, do, lse, delta), dk, dv


class FlashAttention(torch.autograd.Function):
    """o = flash(q, k, v, bias); the backward launches the backward kernels
    (the JAX ``_flash_fwd``/``_flash_bwd`` pair, l.561-581). The bias gets
    no gradient, by the same contract as the JAX wrapper."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = flash_attention_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, o, lse, do)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, L, H, D]; bias [B, 1|H, L, L] in q's dtype, or None ->
    o [B, L, H, D], differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, bias)


def _kernel_args(q, k, v, bias):
    """Strides and sizes in the kernels' argument order."""
    b, l, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f'the CUDA kernels take head dim {HEAD_DIM}, got {d}')
    for name, t in (('q', q), ('k', k), ('v', v), ('bias', bias)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f'{name} must be contiguous in its last axis')
    if bias is not None and bias.shape[1] == 1:
        bias_strides = (bias.stride(0), 0, bias.stride(2))
    elif bias is not None:
        bias_strides = (bias.stride(0), bias.stride(1), bias.stride(2))
    else:
        bias_strides = (0, 0, 0)
    return (q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *bias_strides, b, l, h, d, _DTYPE_CODE[q.dtype])


def check_tc_alignment(**tensors):
    """The bf16 kernels copy q, k, v and do in 16-byte chunks (cp.async):
    each data pointer, and each of its B, L, H strides in bytes, must be a
    multiple of 16. Raises ValueError otherwise; nothing is copied to fix
    it."""
    for name, t in tensors.items():
        elt = t.element_size()
        strides = [s * elt for s, n in zip(t.stride()[:3], t.shape[:3])
                   if n > 1]
        if t.data_ptr() % 16 or any(s % 16 for s in strides):
            raise ValueError(
                f'{name} must be 16-byte aligned, with B, L, H strides of a '
                f'multiple of 16 bytes, for the bf16 kernels; got pointer '
                f'offset {t.data_ptr() % 16} and strides {t.stride()[:3]}')


def _call(lib, name, q, pointers, tail):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(*pointers, *tail, stream)
    if err != 0:
        msg = lib.s4_cuda_error_string(err).decode()
        raise RuntimeError(f'{name} launch failed: CUDA error {err} ({msg})')


def _launch_fwd(q, k, v, bias):
    global launch_count
    tail = _kernel_args(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        check_tc_alignment(q=q, k=k, v=v)
    lib = load_library()
    b, l, h, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    _call(lib, 's4_flash_attn_fwd', q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(),
           None if bias is None else bias.data_ptr(), o.data_ptr(),
           lse.data_ptr()), tail)
    launch_count += 1
    return o, lse


def _bwd_pointers(q, k, v, bias, do, lse, delta, dq, dk, dv):
    if not do.is_contiguous() or tuple(do.shape) != tuple(q.shape):
        raise ValueError('do must be a contiguous [B, L, H, D] tensor')
    if not lse.is_contiguous() or lse.dtype != torch.float32:
        raise ValueError('lse must be a contiguous f32 [B, H, L] tensor')
    return tuple(None if t is None else t.data_ptr()
                 for t in (q, k, v, bias, do, lse, delta, dq, dk, dv))


def launch_bwd_fused(q, k, v, bias, do, lse, delta):
    """The fused kernel: (dq, dk, dv); dq is summed in an f32 workspace and
    cast to the q dtype after the launch. Inputs as ``flash_attention_bwd``
    passes them (do contiguous in the q dtype, delta = ``row_delta``)."""
    global fused_launch_count
    tail = _kernel_args(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        check_tc_alignment(q=q, k=k, v=v, do=do)
    lib = load_bwd_library()
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(q, memory_format=torch.contiguous_format)
    dv = torch.empty_like(q, memory_format=torch.contiguous_format)
    _call(lib, 's4_flash_attn_bwd_fused', q,
          _bwd_pointers(q, k, v, bias, do, lse, delta, dq_acc, dk, dv), tail)
    fused_launch_count += 1
    return dq_acc.to(q.dtype), dk, dv


def launch_bwd_dkv(q, k, v, bias, do, lse, delta):
    """The dk/dv kernel of the two-kernel route: (dk, dv)."""
    global dkv_launch_count
    tail = _kernel_args(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        check_tc_alignment(q=q, k=k, v=v, do=do)
    lib = load_bwd_library()
    dk = torch.empty_like(q, memory_format=torch.contiguous_format)
    dv = torch.empty_like(q, memory_format=torch.contiguous_format)
    _call(lib, 's4_flash_attn_bwd_dkv', q,
          _bwd_pointers(q, k, v, bias, do, lse, delta, None, dk, dv), tail)
    dkv_launch_count += 1
    return dk, dv


def launch_bwd_dq(q, k, v, bias, do, lse, delta):
    """The dq kernel of the two-kernel route: dq, written once in the q
    dtype (no workspace, no atomics: the same bits on every run)."""
    global dq_launch_count
    tail = _kernel_args(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        check_tc_alignment(q=q, k=k, v=v, do=do)
    lib = load_bwd_library()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _call(lib, 's4_flash_attn_bwd_dq', q,
          _bwd_pointers(q, k, v, bias, do, lse, delta, dq, None, None), tail)
    dq_launch_count += 1
    return dq
