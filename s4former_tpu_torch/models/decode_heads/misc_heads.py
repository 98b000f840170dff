"""FCN, SETR-MLA and PSP decode heads (counterpart of
``s4former_tpu/models/decode_heads/misc_heads.py``, l.41-177; reference:
mmseg/models/decode_heads/fcn_head.py, setr_mla_head.py, psp_head.py).

NHWC, in f32 as the JAX heads (``zoo_heads.HeadBase``); the conv blocks
are the SETR-PUP head's ``ConvBNReLU`` (bias-free conv, SyncBN over the
data group, ReLU). Parameter names follow the reference layout:

- ``FCNHead``: ``convs.{i}.conv|bn``, ``conv_cat.conv|bn``, ``conv_seg``.
  With ``num_convs=0`` it is ``conv_seg`` on its (PatchShuffle-undone)
  input, as SETR-MLA's four aux heads are.
- ``SETRMLAHead``: per input level ``up_convs.{i}.0`` and ``.1`` (two 3x3
  ``ConvBNReLU``s to ``mla_channels``), then a bilinear x``up_scale``; the
  levels concatenated; ``conv_seg``. Each level's PatchShuffle is undone
  before its convs.
- ``PSPHead``: the pyramid pooling branches ``psp_modules.{i}.1`` (an
  adaptive average pool to s x s, a 1x1 ``ConvBNReLU``, bilinear back),
  the input first in the concatenation, ``bottleneck``, ``conv_seg``; the
  PatchShuffle undone on its input.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from s4former_tpu_torch.models.decode_heads.base import unshuffle_feature_map
from s4former_tpu_torch.models.decode_heads.setr_up import ConvBNReLU
from s4former_tpu_torch.models.decode_heads.zoo_heads import (HeadBase,
                                                              PooledConv)
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import HEADS


@HEADS.register_module()
class FCNHead(HeadBase):
    """``num_convs`` x ConvBNReLU (+ the input concatenated, ``conv_cat``)
    + the classifier."""

    def __init__(self, in_channels: int = 768, channels: int = 256,
                 num_classes: int = 21, num_convs: int = 2,
                 kernel_size: int = 3, concat_input: bool = True,
                 dilation: int = 1,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels if num_convs else in_channels,
                         **kwargs)
        self.convs = nn.ModuleList([
            ConvBNReLU(in_channels if i == 0 else channels, channels,
                       kernel_size, dilation=dilation)
            for i in range(num_convs)])
        self.concat_input = concat_input and num_convs > 0
        if self.concat_input:
            self.conv_cat = ConvBNReLU(in_channels + channels, channels,
                                       kernel_size)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = inp = self._pick(inputs, patchmix_perm, patchmix_n).float()
        for conv in self.convs:
            x = conv(x, train)
        if self.concat_input:
            x = self.conv_cat(torch.cat([inp, x], dim=-1), train)
        return self._cls(x, train, generator)


@HEADS.register_module()
class SETRMLAHead(HeadBase):
    """Per level [two 3x3 ConvBNReLU + bilinear x``up_scale``], the levels
    concatenated, the classifier. ``conv_seg`` takes the concatenation's
    width, len(in_index) * mla_channels (``channels`` in the configs)."""

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 channels: int = 512, num_classes: int = 19,
                 mla_channels: int = 128, up_scale: int = 4,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select',
                 dropout_ratio: float = 0.0, **kwargs):
        super().__init__(num_classes, tuple(in_index), input_transform,
                         cls_channels=len(in_index) * mla_channels,
                         dropout_ratio=dropout_ratio, **kwargs)
        self.up_scale = up_scale
        self.up_convs = nn.ModuleList([
            nn.ModuleList([ConvBNReLU(in_channels[i], mla_channels, 3),
                           ConvBNReLU(mla_channels, mla_channels, 3)])
            for i in range(len(in_index))])

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        outs = []
        for i, (conv_a, conv_b) in zip(self.in_index, self.up_convs):
            f = inputs[i].float()
            if patchmix_perm is not None and patchmix_n:
                f = unshuffle_feature_map(f, patchmix_perm, patchmix_n)
            y = conv_b(conv_a(f, train), train)
            outs.append(resize_bilinear(
                y, (y.shape[1] * self.up_scale, y.shape[2] * self.up_scale),
                self.align_corners))
        return self._cls(torch.cat(outs, dim=-1), train, generator)


@HEADS.register_module()
class PSPHead(HeadBase):
    """Pyramid pooling module + a 3x3 bottleneck + the classifier."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.psp_modules = nn.ModuleList([
            PooledConv(s, ConvBNReLU(in_channels, channels, 1))
            for s in pool_scales])
        self.bottleneck = ConvBNReLU(
            in_channels + len(pool_scales) * channels, channels, 3)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        hw = tuple(x.shape[1:3])
        branches = [x] + [resize_bilinear(m(x, train), hw,
                                          self.align_corners)
                          for m in self.psp_modules]
        y = self.bottleneck(torch.cat(branches, dim=-1), train)
        return self._cls(y, train, generator)
