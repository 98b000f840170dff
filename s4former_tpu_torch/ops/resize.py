"""Image resize ops with exact torch ``F.interpolate`` coordinate semantics,
in NHWC (counterpart of ``s4former_tpu/ops/resize.py``).

- bilinear, align_corners=False: half-pixel centres, clamped;
- bilinear, align_corners=True: src = dst * (in-1)/(out-1);
- nearest: torch's legacy ``floor(dst * in/out)`` rule.

The 2-tap bilinear weights come from float64 host coordinates, as in the JAX
package. The JAX package applies them as two matmuls (the TPU's matrix unit
is its fast path); here each pass is a 2-tap gather and lerp in f32, which
reads each input row twice instead of the whole input per output row.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _output_size(in_hw: Tuple[int, int],
                 size: Optional[Sequence[int]],
                 scale_factor: Optional[Union[float, Sequence[float]]]
                 ) -> Tuple[int, int]:
    if size is not None:
        return int(size[0]), int(size[1])
    if scale_factor is None:
        raise ValueError('either size or scale_factor must be given')
    if isinstance(scale_factor, (int, float)):
        scale_factor = (scale_factor, scale_factor)
    # torch floors the scaled size
    return (int(in_hw[0] * scale_factor[0]), int(in_hw[1] * scale_factor[1]))


def _linear_weights(in_size: int, out_size: int, align_corners: bool):
    """NUMPY (lo_idx, hi_idx, hi_weight) arrays of length out_size, from
    float64 coordinates (torch's internal precision)."""
    if out_size == in_size:
        idx = np.arange(out_size, dtype=np.int64)
        return idx, idx, np.zeros((out_size,), np.float32)
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * \
            (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


def interp_matrix_np(in_size: int, out_size: int,
                     align_corners: bool) -> np.ndarray:
    """[out_size, in_size] float32 2-tap bilinear interpolation matrix (the
    eval path's resize of logits to the label shape,
    ``core/runner.eval_resize_matrices``)."""
    lo, hi, w = _linear_weights(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


def resize_bilinear_np(x: np.ndarray, out_hw: Tuple[int, int],
                       align_corners: bool = False) -> np.ndarray:
    """Host numpy twin of ``resize_bilinear`` on [H, W, C] or [N, H, W, C]
    (float32 out), the same 2-tap weights: the JAX package's
    ``resize_bilinear_np`` (ops/resize.py:152), which the per-image tools
    use to bring logits to the label's shape."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    xf = np.asarray(x, np.float32)
    if oh != h:
        lo, hi, wt = _linear_weights(h, oh, align_corners)
        xf = xf[:, lo] * (1.0 - wt)[None, :, None, None] + \
            xf[:, hi] * wt[None, :, None, None]
    if ow != w:
        lo, hi, wt = _linear_weights(w, ow, align_corners)
        xf = xf[:, :, lo] * (1.0 - wt)[None, None, :, None] + \
            xf[:, :, hi] * wt[None, None, :, None]
    return xf[0] if squeeze else xf


def _lerp_axis(x: torch.Tensor, axis: int, out_size: int,
               align_corners: bool) -> torch.Tensor:
    lo, hi, w = _linear_weights(x.shape[axis], out_size, align_corners)
    lo = torch.from_numpy(lo).to(x.device)
    hi = torch.from_numpy(hi).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = torch.from_numpy(w).to(x.device).view(shape)
    return torch.lerp(x.index_select(axis, lo), x.index_select(axis, hi), w)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NHWC (or HWC) tensor, torch-parity. Float inputs
    keep their dtype (the taps are summed in f32); integer inputs give f32."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x[0] if squeeze else x
    xf = x.float()
    if oh != h:
        xf = _lerp_axis(xf, 1, oh, align_corners)
    if ow != w:
        xf = _lerp_axis(xf, 2, ow, align_corners)
    out = xf.to(x.dtype) if x.is_floating_point() else xf
    return out[0] if squeeze else out


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # torch legacy nearest: src = floor(dst * in/out), float64 on the host
    idx = np.floor(np.arange(out_size, dtype=np.float64) *
                   (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an NHWC, NHW (labels) or HW tensor, any dtype."""
    squeeze_batch = squeeze_channel = False
    if x.dim() == 3:
        x = x[..., None]
        squeeze_channel = True
    elif x.dim() == 2:
        x = x[None, ..., None]
        squeeze_batch = squeeze_channel = True
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) != (h, w):
        yi = torch.from_numpy(_nearest_indices(h, oh)).to(x.device)
        xi = torch.from_numpy(_nearest_indices(w, ow)).to(x.device)
        x = x.index_select(1, yi).index_select(2, xi)
    if squeeze_channel:
        x = x[..., 0]
    if squeeze_batch:
        x = x[0]
    return x


def resize(x: torch.Tensor,
           size: Optional[Sequence[int]] = None,
           scale_factor: Optional[Union[float, Sequence[float]]] = None,
           mode: str = 'bilinear',
           align_corners: Optional[bool] = None) -> torch.Tensor:
    """Analogue of the reference ``mmseg.ops.resize`` for NHWC tensors
    ([N,H,W,C] for bilinear; [N,H,W] or [N,H,W,C] for nearest)."""
    in_hw = (x.shape[1], x.shape[2]) if x.dim() >= 3 else tuple(x.shape)
    out_hw = _output_size(in_hw, size, scale_factor)
    if mode == 'bilinear':
        return resize_bilinear(x, out_hw, bool(align_corners))
    if mode == 'nearest':
        return resize_nearest(x, out_hw)
    raise ValueError(f'unsupported resize mode: {mode}')
