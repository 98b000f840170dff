"""Flash-attention forward with an additive logit bias, for Hopper.

Counterpart of ``s4former_tpu/ops/flash_attention.py``. The TPU package runs
a Pallas kernel (``_fwd_kernel``); here the same function is the hand-written
CUDA kernel ``csrc/flash_attn_fwd.cu``, bound with ``ctypes``. The ViT calls
it once per layer, with the PASA bias ``[B, 1, L, L]`` on the teacher-PASA
path and with no bias otherwise.

- ``flash_attention_fwd(q, k, v, bias)`` -> ``(o, lse)``: CUDA tensors launch
  the kernel (or raise); CPU tensors take ``flash_attention_reference``.
- ``flash_attention(q, k, v, bias)`` -> ``o``.
- ``flash_attention_reference`` is the plain PyTorch version of the same
  function: the CPU path, and what the kernel is held to on the card.
- ``launch_count`` counts kernel launches, so a run can show that its path
  went through the kernel.

Layout: q, k, v ``[B, L, H, D]`` (the last axis contiguous; other strides
are passed to the kernel, so the fused qkv projection's slices need no
copy); bias ``[B, 1|H, L, L]``, cast to the q dtype as the JAX wrapper casts
it; o ``[B, L, H, D]`` in the q dtype; lse ``[B, H, L]`` f32. The backward
(training) is not ported yet: the output carries no gradient.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s4former_tpu_torch.ops import cuda_build

SOURCE = 'flash_attn_fwd.cu'
HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        i64, ptr, c_int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.s4_flash_attn_fwd.argtypes = (
            [ptr] * 6 + [i64] * 12 + [c_int] * 5 + [ptr])
        lib.s4_flash_attn_fwd.restype = c_int
        lib.s4_cuda_error_string.argtypes = [c_int]
        lib.s4_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (o [B,L,H,D] in q's dtype, lse [B,H,L] f32)."""
    d = q.shape[-1]
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * \
        (1.0 / math.sqrt(d))
    if bias is not None:
        s = s + bias.to(q.dtype).float()
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)
    return o, lse


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse). CUDA tensors launch the kernel; CPU tensors take the plain
    version. Anything else raises."""
    _check(q, k, v, bias)
    if bias is not None:
        bias = bias.to(q.dtype)
    if q.device.type == 'cpu':
        return flash_attention_reference(q, k, v, bias)
    if q.device.type != 'cuda':
        raise ValueError(f'flash_attention runs on CUDA or CPU tensors, '
                         f'not {q.device}')
    return _launch(q, k, v, bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, L, H, D]; bias [B, 1|H, L, L] or None -> o [B, L, H, D]."""
    return flash_attention_fwd(q, k, v, bias)[0]


def _launch(q, k, v, bias):
    global launch_count
    b, l, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f'the CUDA kernel takes head dim {HEAD_DIM}, got {d}')
    for name, t in (('q', q), ('k', k), ('v', v), ('bias', bias)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f'{name} must be contiguous in its last axis')
    if bias is not None and bias.shape[1] == 1:
        bias_strides = (bias.stride(0), 0, bias.stride(2))
    elif bias is not None:
        bias_strides = (bias.stride(0), bias.stride(1), bias.stride(2))
    else:
        bias_strides = (0, 0, 0)
    lib = load_library()
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.s4_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *bias_strides, b, l, h, d, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        msg = lib.s4_cuda_error_string(err).decode()
        raise RuntimeError(f'flash_attn_fwd launch failed: CUDA error {err} '
                           f'({msg})')
    launch_count += 1
    return o, lse
