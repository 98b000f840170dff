"""The shared base of the zoo's decode heads, DeepLabV3+'s, Fast-SCNN's
and LR-ASPP's heads (counterpart of
``s4former_tpu/models/decode_heads/zoo_heads.py``: ``_HeadBase``
l.38-65, ``SepConvBNReLU`` l.87, ``DepthwiseSeparableASPPHead`` l.154,
``DepthwiseSeparableFCNHead`` l.200, ``LRASPPHead`` l.729; reference:
mmseg/models/decode_heads/decode_head.py:35-105, sep_aspp_head.py,
sep_fcn_head.py, lraspp_head.py).

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

``PooledConv`` is the reference's ``Sequential(AdaptiveAvgPool2d(s),
ConvModule)`` (the conv under ``1``): PSPNet's and ICNet's pyramid
branches and the ASPP image pool. ``SepConvBNReLU`` is mmcv's
``DepthwiseSeparableConvModule`` (``depthwise_conv``, ``pointwise_conv``).
``DepthwiseSeparableASPPHead``: the image pool (``image_pool.1``), a 1x1
and separable dilated 3x3 branches (``aspp_modules.{i}``), ``bottleneck``;
then the low-level skip (``c1_bottleneck``) and two separable 3x3s
(``sep_bottleneck.{0,1}``). Its main input has the PatchShuffle undone;
the ``c1`` skip is read from the raw ``inputs[c1_index]`` (JAX
l.188-190), so it stays shuffled.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from s4former_tpu_torch.models.decode_heads.base import (
    transform_inputs, unshuffle_feature_map)
from s4former_tpu_torch.models.decode_heads.setr_up import (ConvBNReLU,
                                                            conv_nhwc)
from s4former_tpu_torch.models.dropout import dropout
from s4former_tpu_torch.ops.resize import (adaptive_avg_pool, avg_pool_nhwc,
                                           resize_bilinear)
from s4former_tpu_torch.registry import HEADS


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


class PooledConv(nn.Module):
    """Adaptive average pool to ``scale`` x ``scale``, then a
    ``ConvBNReLU`` under the key ``1``."""

    def __init__(self, scale: int, conv: ConvBNReLU):
        super().__init__()
        self.scale = scale
        self.add_module('1', conv)

    @property
    def conv(self) -> ConvBNReLU:
        return getattr(self, '1')

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv(adaptive_avg_pool(x, (self.scale, self.scale)),
                         train)


class SepConvBNReLU(nn.Module):
    """Depthwise k x k conv + BN (+ ReLU unless ``dw_act=False``), then
    a pointwise 1x1 conv + BN + ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dilation: int = 1,
                 dw_act: bool = True):
        super().__init__()
        self.dw_act = dw_act
        self.depthwise_conv = ConvBNReLU(in_channels, in_channels,
                                         kernel_size, dilation=dilation,
                                         groups=in_channels)
        self.pointwise_conv = ConvBNReLU(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.depthwise_conv(x, train, relu=self.dw_act)
        return self.pointwise_conv(x, train)


@HEADS.register_module()
class DepthwiseSeparableASPPHead(HeadBase):
    """DeepLabV3+: separable ASPP + the low-level (c1) skip fusion."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 c1_in_channels: int = 256, c1_channels: int = 48,
                 c1_index: int = 0,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.c1_index = c1_index
        self.image_pool = PooledConv(1, ConvBNReLU(in_channels, channels, 1))
        self.aspp_modules = nn.ModuleList([
            ConvBNReLU(in_channels, channels, 1) if d == 1 else
            SepConvBNReLU(in_channels, channels, 3, d) for d in dilations])
        self.bottleneck = ConvBNReLU((len(dilations) + 1) * channels,
                                     channels, 3)
        self.c1_bottleneck = ConvBNReLU(c1_in_channels, c1_channels, 1) \
            if c1_in_channels > 0 else None
        fuse_in = channels + (c1_channels if c1_in_channels > 0 else 0)
        self.sep_bottleneck = nn.ModuleList([
            SepConvBNReLU(fuse_in, channels, 3),
            SepConvBNReLU(channels, channels, 3)])

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        b, h, w, _ = x.shape
        # the image pool's 1 x 1 map bilinearly resized to h x w is that
        # map repeated (both bilinear taps read its one pixel)
        pooled = self.image_pool.conv(x.mean(dim=(1, 2), keepdim=True),
                                      train)
        branches = [pooled.expand(b, h, w, pooled.shape[-1])]
        branches += [m(x, train) for m in self.aspp_modules]
        y = self.bottleneck(torch.cat(branches, dim=-1), train)
        if isinstance(inputs, (list, tuple)) and \
                self.c1_bottleneck is not None:
            c1 = self.c1_bottleneck(inputs[self.c1_index].float(), train)
            y = resize_bilinear(y, tuple(c1.shape[1:3]), self.align_corners)
            y = torch.cat([y, c1], dim=-1)
        for sep in self.sep_bottleneck:
            y = sep(y, train)
        return self._cls(y, train, generator)


@HEADS.register_module()
class DepthwiseSeparableFCNHead(HeadBase):
    """Fast-SCNN's FCN head: ``num_convs`` separable 3x3s
    (``convs.{i}``; the depthwise BN-only, as the reference's
    ``dw_act_cfg=None``), with ``concat_input`` one more on [input,
    convs] (``conv_cat``), then the classifier; the PatchShuffle undone
    on its input."""

    def __init__(self, in_channels: int = 128, channels: int = 128,
                 num_classes: int = 19, num_convs: int = 2,
                 concat_input: bool = False,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.convs = nn.ModuleList([
            SepConvBNReLU(in_channels if i == 0 else channels, channels, 3,
                          dw_act=False) for i in range(num_convs)])
        self.conv_cat = SepConvBNReLU(in_channels + channels, channels, 3,
                                      dw_act=False) if concat_input else None

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = inp = self._pick(inputs, patchmix_perm, patchmix_n).float()
        for conv in self.convs:
            x = conv(x, train)
        if self.conv_cat is not None:
            x = self.conv_cat(torch.cat([inp, x], dim=-1), train)
        return self._cls(x, train, generator)


@HEADS.register_module()
class LRASPPHead(HeadBase):
    """Lite R-ASPP (MobileNetV3): on the deepest input a 1x1
    ``ConvBNReLU`` (``aspp_conv``) gated by the sigmoid of a bias-free
    1x1 (``image_pool.1.conv``, no norm) on a VALID average pool of
    window min(49, size) and strides (16, 20), resized bilinearly to the
    map; a biased 1x1 (``conv_up_input``); then, from the deepest skip
    level to the shallowest, resized to the level, concatenated with the
    level through a bias-free 1x1 (``convs.conv{i}``) and fused by a 1x1
    ``ConvBNReLU`` (``conv_ups.conv_up{i}``); the classifier. It reads
    ``inputs[i]`` as they come and never undoes a PatchShuffle (JAX
    l.729-761 has no ``_pick``)."""

    def __init__(self, in_channels: Sequence[int] = (16, 24, 960),
                 channels: int = 128, num_classes: int = 19,
                 branch_channels: Sequence[int] = (32, 64),
                 in_index: Sequence[int] = (0, 1, 2),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(num_classes, tuple(in_index), input_transform,
                         cls_channels=channels, **kwargs)
        self.branch_channels = tuple(branch_channels)
        pool = nn.Module()
        pool.conv = nn.Conv2d(in_channels[-1], channels, 1, bias=False)
        self.image_pool = nn.ModuleDict({'1': pool})
        self.aspp_conv = ConvBNReLU(in_channels[-1], channels, 1)
        self.conv_up_input = nn.Conv2d(channels, channels, 1)
        self.convs = nn.ModuleDict({
            f'conv{i}': nn.Conv2d(in_channels[i], b, 1, bias=False)
            for i, b in enumerate(branch_channels)})
        self.conv_ups = nn.ModuleDict({
            f'conv_up{i}': ConvBNReLU(channels + b, channels, 1)
            for i, b in enumerate(branch_channels)})

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        feats = [inputs[i].float() for i in self.in_index] \
            if isinstance(inputs, (list, tuple)) else [inputs.float()]
        x = feats[-1]
        hw = tuple(x.shape[1:3])
        k = (min(49, hw[0]), min(49, hw[1]))
        gate = avg_pool_nhwc(x, k, (16, 20))
        gate = torch.sigmoid(conv_nhwc(gate, self.image_pool['1'].conv,
                                       torch.float32))
        gate = resize_bilinear(gate, hw, self.align_corners)
        y = conv_nhwc(self.aspp_conv(x, train) * gate, self.conv_up_input,
                      torch.float32)
        for i in range(len(self.branch_channels) - 1, -1, -1):
            y = resize_bilinear(y, tuple(feats[i].shape[1:3]),
                                self.align_corners)
            skip = conv_nhwc(feats[i], self.convs[f'conv{i}'], torch.float32)
            y = self.conv_ups[f'conv_up{i}'](torch.cat([y, skip], dim=-1),
                                             train)
        return self._cls(y, train, generator)
