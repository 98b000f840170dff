"""Inference paths: whole-image, sliding-window, flip TTA (counterpart of
``s4former_tpu/models/segmentors/inference.py``; reference:
mmseg/models/segmentors/encoder_decoder.py:1068-1271).

The JAX package compiles the sliding window into one ``fori_loop``; here it
is a Python loop over the same window origins, one forward per window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from s4former_tpu_torch.ops.resize import resize_bilinear


def whole_inference(apply_fn, img: torch.Tensor,
                    out_hw: Optional[Tuple[int, int]] = None,
                    align_corners: bool = False) -> torch.Tensor:
    """apply_fn(img) -> logits at img resolution; resized to out_hw."""
    logits = apply_fn(img)
    if out_hw is not None and tuple(logits.shape[1:3]) != tuple(out_hw):
        logits = resize_bilinear(logits, tuple(out_hw), align_corners)
    return logits


def window_origins(h: int, w: int, crop_size: Tuple[int, int],
                   stride: Tuple[int, int]):
    """Window origins of the reference (:1068-1116): i*stride, clipped so
    the last window ends at the image edge."""
    ch, cw = crop_size
    sh, sw = stride
    grid_h = max(h - ch + sh - 1, 0) // sh + 1
    grid_w = max(w - cw + sw - 1, 0) // sw + 1
    return [(min(i * sh, h - ch), min(j * sw, w - cw))
            for i in range(grid_h) for j in range(grid_w)]


def slide_inference(apply_fn, img: torch.Tensor, num_classes: int,
                    crop_size: Tuple[int, int],
                    stride: Tuple[int, int],
                    out_hw: Optional[Tuple[int, int]] = None,
                    align_corners: bool = False) -> torch.Tensor:
    """Overlapping-window logits, count-normalised."""
    b, h, w, _ = img.shape
    ch, cw = crop_size
    preds = torch.zeros((b, h, w, num_classes), dtype=torch.float32,
                        device=img.device)
    count = torch.zeros((1, h, w, 1), dtype=torch.float32, device=img.device)
    for y, x in window_origins(h, w, crop_size, stride):
        logits = apply_fn(img[:, y:y + ch, x:x + cw]).float()
        preds[:, y:y + ch, x:x + cw] += logits
        count[:, y:y + ch, x:x + cw] += 1.0
    logits = preds / count
    if out_hw is not None and tuple(out_hw) != (h, w):
        logits = resize_bilinear(logits, tuple(out_hw), align_corners)
    return logits


def inference(apply_fn, img: torch.Tensor, num_classes: int,
              mode: str = 'whole',
              out_hw: Optional[Tuple[int, int]] = None,
              crop_size: Tuple[int, int] = (512, 512),
              stride: Tuple[int, int] = (341, 341),
              flip: bool = False,
              align_corners: bool = False) -> torch.Tensor:
    """Softmax probabilities (f32) with optional flip averaging
    (:1174-1212)."""
    def probs_of(x):
        if mode == 'slide':
            logits = slide_inference(apply_fn, x, num_classes, crop_size,
                                     stride, out_hw, align_corners)
        else:
            logits = whole_inference(apply_fn, x, out_hw, align_corners)
        return torch.softmax(logits.float(), dim=-1)

    probs = probs_of(img)
    if flip:
        probs_f = probs_of(torch.flip(img, dims=(2,)))
        probs = 0.5 * (probs + torch.flip(probs_f, dims=(2,)))
    return probs


def predict(apply_fn, img: torch.Tensor, num_classes: int,
            **kwargs) -> torch.Tensor:
    """argmax segmentation map [B, H, W] int32 (simple_test, :1214-1232)."""
    probs = inference(apply_fn, img, num_classes, **kwargs)
    return probs.argmax(dim=-1).to(torch.int32)
