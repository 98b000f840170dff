"""The shared base of the zoo's decode heads (counterpart of
``s4former_tpu/models/decode_heads/zoo_heads.py:_HeadBase``, l.38-65;
reference: mmseg/models/decode_heads/decode_head.py:35-105).

``HeadBase`` holds the ``BaseDecodeHead`` config surface every zoo head
accepts (``dropout_ratio``, ``align_corners``, ``loss_decode``,
``norm_cfg``, ``act_cfg``, ``init_cfg``, ``sampler``, ``ignore_index``)
and two steps:

- ``_pick``: the head's input from the backbone (or neck) features
  (``transform_inputs``), then the PatchShuffle undo on it, so the step's
  strong mixes reach every head;
- ``_cls``: element-wise dropout in train mode (drawn from the caller's
  ``torch.Generator``), then the 1x1 ``conv_seg`` classifier, f32 logits.

The JAX heads carry no ``dtype``: flax promotes their bf16 inputs with the
f32 parameters, so they compute in f32, and so do these.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from s4former_tpu_torch.models.decode_heads.base import (
    transform_inputs, unshuffle_feature_map)
from s4former_tpu_torch.models.decode_heads.setr_up import conv_nhwc
from s4former_tpu_torch.models.dropout import dropout


class HeadBase(nn.Module):
    """Input selection + PatchShuffle undo + classifier tail.
    ``cls_channels``: the width ``conv_seg`` takes, or None for a head
    without one."""

    def __init__(self, num_classes: int,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 cls_channels: Optional[int] = None,
                 dropout_ratio: float = 0.1,
                 align_corners: bool = False,
                 loss_decode: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[Union[dict, list]] = None,
                 sampler: Optional[dict] = None,
                 ignore_index: int = 255):
        super().__init__()
        self.num_classes = num_classes
        self.in_index = in_index
        self.input_transform = input_transform
        self.dropout_ratio = dropout_ratio
        self.align_corners = align_corners
        self.loss_decode = loss_decode   # read by the train step
        if cls_channels is not None:
            self.conv_seg = nn.Conv2d(cls_channels, num_classes, 1)

    def _pick(self, inputs, patchmix_perm: Optional[torch.Tensor],
              patchmix_n: int) -> torch.Tensor:
        x = transform_inputs(inputs, self.in_index, self.input_transform,
                             self.align_corners) \
            if isinstance(inputs, (list, tuple)) else inputs
        if patchmix_perm is not None and patchmix_n:
            x = unshuffle_feature_map(x, patchmix_perm, patchmix_n)
        return x

    def _cls(self, x: torch.Tensor, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if train and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return conv_nhwc(x, self.conv_seg, torch.float32)
