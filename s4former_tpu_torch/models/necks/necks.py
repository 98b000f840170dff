"""Necks (counterpart of ``s4former_tpu/models/necks/necks.py``; reference:
mmseg/models/necks/mla_neck.py, fpn.py, ic_neck.py).

``MLANeck`` (SETR-MLA; JAX l.41-72), NHWC, in f32 as the JAX neck (flax
promotes its bf16 inputs with the f32 parameters):

- per level i: LayerNorm over the channels (the ViT's final norms moved
  into the neck; eps from ``norm_layer``, else 1e-6, as the JAX module
  reads it), then a biased 1x1 ``mla.channel_proj.{i}``;
- a cumulative sum, deepest level first;
- a biased 3x3 ``mla.feat_extract.{k}`` on each sum.

The output tuple is deepest-first (the sums in the order they are made),
as the JAX docstring notes of the reference code. Reference keys:
``norm.{i}``, ``mla.channel_proj.{i}.conv``, ``mla.feat_extract.{i}.conv``.

``FPN`` (JAX l.148): a biased 1x1 lateral per level
(``lateral_convs.{i}.conv``), the top-down sum with nearest upsampling
(the reference's default ``upsample_cfg``), a biased 3x3 on each sum
(``fpn_convs.{i}.conv``); no BN, no activation, as the reference's
``ConvModule``s with ``norm_cfg=None``.

``ICNeck`` (JAX l.199): two ``CascadeFeatureFusion``s (l.179),
``cff_24`` fusing ICNet's 1/4-image branch into its 1/2 one, ``cff_12``
that result into the full-image one. Each upsamples its low input
bilinearly to the high one, runs a 3x3 ``ConvBNReLU`` dilated 2 on it
(``conv_low``) and a 1x1 one on the high input (``conv_high``), and
returns relu(sum) and the low projection. The output is (x_24, x_12,
x_cff_12): the two low projections (the aux heads' inputs), then the
fused map.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.vit import layer_norm
from s4former_tpu_torch.models.decode_heads.setr_up import (ConvBNReLU,
                                                            conv_nhwc)
from s4former_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from s4former_tpu_torch.registry import NECKS


class _BiasedConv(nn.Module):
    """mmcv ``ConvModule`` with ``norm_cfg=None, act_cfg=None``: a plain
    biased conv under the key ``conv``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.conv, torch.float32)


class _MLAModule(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        self.channel_proj = nn.ModuleList(
            [_BiasedConv(c, out_channels, 1) for c in in_channels])
        self.feat_extract = nn.ModuleList(
            [_BiasedConv(out_channels, out_channels, 3) for _ in in_channels])


@NECKS.register_module()
class MLANeck(nn.Module):
    """Multi-level aggregation of the ViT's taps (SETR-MLA)."""

    def __init__(self, in_channels: Sequence[int] = (1024, 1024, 1024, 1024),
                 out_channels: int = 256,
                 norm_layer: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        eps = (norm_layer or {}).get('eps', 1e-6)
        self.norm = nn.ModuleList([nn.LayerNorm(c, eps=eps)
                                   for c in in_channels])
        self.mla = _MLAModule(in_channels, out_channels)

    def forward(self, inputs, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        if len(inputs) != len(self.norm):
            raise ValueError(f'MLANeck built for {len(self.norm)} levels '
                             f'got {len(inputs)}')
        feats = [proj(layer_norm(x, norm, torch.float32))
                 for x, norm, proj in zip(inputs, self.norm,
                                          self.mla.channel_proj)]
        mids = [feats[-1]]
        for f in feats[-2::-1]:
            mids.append(mids[-1] + f)
        return tuple(extract(m) for m, extract in
                     zip(mids, self.mla.feat_extract))


@NECKS.register_module()
class FPN(nn.Module):
    """The classic feature pyramid over the backbone's levels."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 4,
                 upsample_mode: str = 'nearest'):
        super().__init__()
        self.num_outs = num_outs
        self.upsample_mode = upsample_mode
        self.lateral_convs = nn.ModuleList(
            [_BiasedConv(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [_BiasedConv(out_channels, out_channels, 3) for _ in in_channels])

    def forward(self, inputs, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            hw = tuple(laterals[i - 1].shape[1:3])
            # any other mode is bilinear, as in JAX
            up = resize_nearest(laterals[i], hw) \
                if self.upsample_mode == 'nearest' else \
                resize_bilinear(laterals[i], hw, False)
            laterals[i - 1] = laterals[i - 1] + up
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        return tuple(outs[:self.num_outs])


class CascadeFeatureFusion(nn.Module):
    """ICNet's CFF unit: (relu(conv_low(up(low)) + conv_high(high)),
    conv_low(up(low)))."""

    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        self.conv_low = ConvBNReLU(low_channels, out_channels, 3, dilation=2)
        self.conv_high = ConvBNReLU(high_channels, out_channels, 1)

    def forward(self, x_low: torch.Tensor, x_high: torch.Tensor,
                train: bool = False):
        x_low = resize_bilinear(x_low, tuple(x_high.shape[1:3]),
                                self.align_corners)
        x_low = self.conv_low(x_low, train)
        x_high = self.conv_high(x_high, train)
        return F.relu(x_low + x_high), x_low


@NECKS.register_module()
class ICNeck(nn.Module):
    """ICNet's cascade of two feature fusions."""

    def __init__(self, in_channels: Sequence[int] = (64, 256, 256),
                 out_channels: int = 128, align_corners: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        if len(in_channels) != 3:
            raise ValueError(f'ICNeck takes 3 levels, not {in_channels}')
        self.cff_24 = CascadeFeatureFusion(in_channels[2], in_channels[1],
                                           out_channels, align_corners)
        self.cff_12 = CascadeFeatureFusion(out_channels, in_channels[0],
                                           out_channels, align_corners)

    def forward(self, inputs, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        x_sub1, x_sub2, x_sub4 = inputs
        x_cff_24, x_24 = self.cff_24(x_sub4, x_sub2, train)
        x_cff_12, x_12 = self.cff_12(x_cff_24, x_sub1, train)
        return (x_24, x_12, x_cff_12)
