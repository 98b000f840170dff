"""ResNet, ResNetV1c and ResNetV1d backbones (counterpart of
``s4former_tpu/models/backbones/resnet.py``; reference:
mmseg/models/backbones/resnet.py).

NHWC in, a tuple of NHWC maps out (the stages of ``out_indices``). Depths
18/34 (``BasicBlock``) and 50/101/152 (``Bottleneck``, pytorch style: the
stride on the 3x3), dilated stages (output stride 8 in the -D8 configs)
with ``contract_dilation``, the V1c deep stem (three 3x3 conv-BN-ReLUs)
and V1d's ``avg_down`` shortcuts (a ceil-mode average pool before a
stride-1 1x1). A shortcut gets its 1x1 conv + BN only where the residual's
shape changes (JAX l.169-173): ResNet-18's layer1 has none.

The JAX ResNet carries no ``dtype``: flax promotes a bf16 input with the
f32 parameters, so it computes in f32, and so does this one. Every BN is
the port's ``setr_up.BatchNorm`` (flax statistics in f32; SyncBN over the
data group in train mode); convs run through ``setr_up.conv_nhwc`` (on the
card on the channels-last view, with no copy).

The forward takes the segmentor's semi keywords (``attn_bias``,
``pos_mode``, ``return_attn``) and the port's ``generator`` and ignores
them but for ``use_fdrop``, which drops channels of each ``out_indices``
tap (one keep mask [B, 1, 1, C], kept channels x2) drawn from
``generator``, as the reference's CNN students do (resnet.py:663-665).
``half_after_stage`` (ICNet) halves the features bilinearly after that
stage, after its tap. The config keys ``norm_cfg``, ``norm_eval``,
``style``, ``init_cfg``, ``pretrained``, ``frozen_stages`` and ``with_cp``
are accepted and change nothing, as in JAX.

Parameter names follow the reference: the deep stem ``stem.{0,1,3,4,6,7}``
(conv, BN, conv, BN, conv, BN) or ``conv1``/``bn1``;
``layer{s}.{j}.conv{c}`` / ``bn{c}``; the shortcut ``downsample.0`` /
``.1`` (conv, BN), or ``downsample.1`` / ``.2`` with V1d's parameter-free
pool at ``.0``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.decode_heads.setr_up import (BatchNorm,
                                                            conv_bn)
from s4former_tpu_torch.models.dropout import channel_dropout
from s4former_tpu_torch.ops.resize import avg_pool_nhwc, resize_bilinear
from s4former_tpu_torch.registry import BACKBONES

ARCH = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


def _conv(in_channels: int, out_channels: int, kernel: int,
          stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """A bias-free conv with 'same' padding at ``dilation``."""
    return nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False)


def _avg_pool_ceil(x: torch.Tensor, s: int) -> torch.Tensor:
    """torch ``AvgPool2d(s, s, ceil_mode=True, count_include_pad=False)``
    on an NHWC map, V1d's ``avg_down`` pool: a partial border window
    averages only its real pixels."""
    return avg_pool_nhwc(x, s, s, ceil_mode=True, count_include_pad=False)


class _Downsample(nn.Module):
    """The 1x1 shortcut: conv + BN at ``0`` / ``1``, or with ``avg_down``
    a ceil-mode pool (no parameters, the reference's ``0``) then the
    stride-1 conv + BN at ``1`` / ``2``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 avg_down: bool):
        super().__init__()
        self.stride = stride
        self.avg_down = avg_down
        first = 1 if avg_down else 0
        self.add_module(str(first), _conv(in_channels, out_channels, 1,
                                          1 if avg_down else stride))
        self.add_module(str(first + 1), BatchNorm(out_channels))
        self._keys = (str(first), str(first + 1))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.avg_down and self.stride > 1:
            x = _avg_pool_ceil(x, self.stride)
        conv, bn = (getattr(self, k) for k in self._keys)
        return conv_bn(x, conv, bn, train, relu=False)


class BasicBlock(nn.Module):
    """Two 3x3s; only ``conv1`` dilates (the reference's ``conv2`` has
    padding 1 and no dilation)."""
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 avg_down: bool = False):
        super().__init__()
        self.conv1 = _conv(in_channels, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = _Downsample(in_channels, planes, stride,
                                      avg_down) if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv_bn(x, self.conv1, self.bn1, train)
        y = conv_bn(y, self.conv2, self.bn2, train, relu=False)
        identity = x if self.downsample is None else \
            self.downsample(x, train)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3 (stride, dilation), 1x1 to ``4 * planes``."""
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 avg_down: bool = False):
        super().__init__()
        self.conv1 = _conv(in_channels, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = _Downsample(in_channels, planes * 4, stride,
                                      avg_down) if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv_bn(x, self.conv1, self.bn1, train)
        y = conv_bn(y, self.conv2, self.bn2, train)
        y = conv_bn(y, self.conv3, self.bn3, train, relu=False)
        identity = x if self.downsample is None else \
            self.downsample(x, train)
        return F.relu(y + identity)


class _DeepStem(nn.Module):
    """V1c's stem: three 3x3 conv-BN-ReLUs (stride 2, 1, 1) under the
    reference's ``Sequential`` indices (conv 0, 3, 6; BN 1, 4, 7)."""

    def __init__(self, in_channels: int, stem_channels: int):
        super().__init__()
        half = stem_channels // 2
        for i, (cin, cout) in enumerate(((in_channels, half), (half, half),
                                         (half, stem_channels))):
            self.add_module(str(3 * i), _conv(cin, cout, 3, 2 if i == 0
                                              else 1))
            self.add_module(str(3 * i + 1), BatchNorm(cout))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(3):
            x = conv_bn(x, getattr(self, str(3 * i)),
                        getattr(self, str(3 * i + 1)), train)
        return x


@BACKBONES.register_module()
class ResNet(nn.Module):
    """ResNet (reference layout), NHWC, f32."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 deep_stem: bool = False, avg_down: bool = False,
                 contract_dilation: bool = False,
                 # config keys accepted for parity; no effect (as JAX)
                 norm_cfg: Optional[dict] = None, norm_eval: bool = False,
                 style: str = 'pytorch', init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None, frozen_stages: int = -1,
                 with_cp: bool = False,
                 half_after_stage: Optional[int] = None,
                 align_corners: bool = False):
        super().__init__()
        if depth not in ARCH:
            raise KeyError(f'invalid depth {depth} for resnet')
        kind, stage_blocks = ARCH[depth]
        block_cls = BasicBlock if kind == 'basic' else Bottleneck
        self.deep_stem = deep_stem
        self.out_indices = tuple(out_indices)
        self.half_after_stage = half_after_stage
        self.align_corners = align_corners
        if deep_stem:
            self.stem = _DeepStem(in_channels, stem_channels)
        else:
            self.conv1 = _conv(in_channels, stem_channels, 7, 2)
            self.bn1 = BatchNorm(stem_channels)
        channels = stem_channels
        planes = base_channels
        self.layer_names = []
        for i in range(num_stages):
            stride, dilation = strides[i], dilations[i]
            blocks = []
            for j in range(stage_blocks[i]):
                d = dilation // 2 if (j == 0 and dilation > 1 and
                                      contract_dilation) else dilation
                need_down = j == 0 and (
                    stride != 1 or channels != planes * block_cls.expansion)
                blocks.append(block_cls(channels, planes,
                                        stride if j == 0 else 1, d,
                                        downsample=need_down,
                                        avg_down=avg_down))
                channels = planes * block_cls.expansion
            name = f'layer{i + 1}'
            self.add_module(name, nn.ModuleList(blocks))
            self.layer_names.append(name)
            planes *= 2

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """Tuple of the ``out_indices`` stages' maps [, ([], None)]."""
        x = x.float()
        if self.deep_stem:
            x = self.stem(x, train)
        else:
            x = conv_bn(x, self.conv1, self.bn1, train)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for i, name in enumerate(self.layer_names):
            for block in getattr(self, name):
                x = block(x, train)
            if i in self.out_indices:
                outs.append(channel_dropout(x, generator) if use_fdrop
                            else x)
            if i == self.half_after_stage:
                # the tap above sees the features before the resize
                # (reference icnet.py:149-159)
                x = resize_bilinear(x, (max(x.shape[1] // 2, 1),
                                        max(x.shape[2] // 2, 1)),
                                    self.align_corners)
        if return_attn:
            return tuple(outs), ([], None)
        return tuple(outs)


@BACKBONES.register_module()
class ResNetV1c(ResNet):
    """ResNet with the deep stem (mmseg's CNN segmentors)."""

    def __init__(self, **kwargs):
        kwargs['deep_stem'] = True
        super().__init__(**kwargs)


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """The deep stem and ``avg_down`` shortcuts (reference
    resnet.py:711-725)."""

    def __init__(self, **kwargs):
        kwargs['deep_stem'] = True
        kwargs['avg_down'] = True
        super().__init__(**kwargs)
