"""Decode-head shared machinery (counterpart of
``s4former_tpu/models/decode_heads/base.py``; reference:
mmseg/models/decode_heads/decode_head.py:159-184).

The PatchShuffle undo helpers (``unshuffle_tokens``, ...) are training-only
and come with the training slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from s4former_tpu_torch.ops.resize import resize_bilinear


def transform_inputs(inputs: Sequence[torch.Tensor],
                     in_index: Union[int, Sequence[int]],
                     input_transform: Optional[str] = None,
                     align_corners: bool = False):
    """Select/assemble backbone features (NHWC)."""
    if input_transform == 'resize_concat':
        sel = [inputs[i] for i in in_index]
        target_hw = tuple(sel[0].shape[1:3])
        up = [resize_bilinear(x, target_hw, align_corners) for x in sel]
        return torch.cat(up, dim=-1)
    if input_transform == 'multiple_select':
        return [inputs[i] for i in in_index]
    return inputs[in_index]
