"""MobileNetV3 (counterpart of ``s4former_tpu/models/backbones/mobilenet.py``
l.22-235; reference: mmseg/models/backbones/mobilenet_v3.py with mmseg's
InvertedResidualV3 and SELayer).

NHWC, f32 (the JAX modules carry no ``dtype``). Every conv is bias-free
and followed by BN with flax's eps 1e-5 and momentum 0.9, whatever the
config's ``norm_cfg`` asks (``lraspp_m-v3-d8.py`` asks eps 1e-3; the JAX
``ConvBNAct`` takes flax's default), then ReLU, hard swish or nothing.

- The stem (``layer0``: 3x3 s2 to 16, hard swish) and every depthwise
  conv whose table stride is 2 pad as TensorFlow's 'SAME' (mmcv
  ``Conv2dAdaptivePadding``): at stride 2 on an even size that is one row
  and column more at the end than at the start.
- ``layer{i}``: ``expand_conv`` (1x1, where the width changes),
  ``depthwise_conv`` (k x k), squeeze-excite (``se.conv1.conv``,
  ``se.conv2.conv``: biased 1x1s, ReLU then the hard sigmoid
  ``clip((x + 3) / 6, 0, 1)``, hidden width ``make_divisible(mid // 4,
  8)``), ``linear_conv`` (1x1, BN only); the input added where the
  TABLE stride is 1 and the width is kept.
- Output stride 8 (the -d8 surgery): the last two stride-2 depthwise
  convs run at stride 1, the layers from the first at dilation 2, from
  the second at 4; those two keep no shortcut (the reference decides the
  shortcut before it changes the stride).
- ``layer{N+1}``: a 1x1 to 960 (``large``) or 576 (``small``), hard
  swish.

The forward takes the segmentor's semi keywords and ignores them, fdrop
included, as JAX's does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.decode_heads.setr_up import (BatchNorm,
                                                            conv_nhwc)
from s4former_tpu_torch.registry import BACKBONES


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """mmcv ``HSigmoid(bias=3, divisor=6)``."""
    return torch.clamp((x + 3.0) / 6.0, 0.0, 1.0)


def make_divisible(v: float, divisor: int = 8) -> int:
    """mmcv ``make_divisible``: ``v`` rounded to a multiple of
    ``divisor``, never below 90% of ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _same_pads(n: int, kernel: int, stride: int, dilation: int):
    """TensorFlow 'SAME' padding of one axis (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + dilation * (kernel - 1) + 1 - n, 0)
    return total // 2, total - total // 2


class ConvBNAct(nn.Module):
    """Bias-free conv (``conv``), BN (``bn``), then ``act``: 'relu6',
    'hswish', 'relu' or 'none'. ``same_pad``: TensorFlow 'SAME' padding
    (else symmetric ``dilation * (kernel - 1) // 2``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: int = 3, stride: int = 1, groups: int = 1,
                 dilation: int = 1, act: str = 'relu6',
                 same_pad: bool = False):
        super().__init__()
        self.act, self.same_pad = act, same_pad
        self.conv = nn.Conv2d(in_channels, out_channels, kernel,
                              stride=stride,
                              padding=0 if same_pad else
                              dilation * (kernel - 1) // 2,
                              dilation=dilation, groups=groups, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.same_pad:
            k, s, d = (self.conv.kernel_size[0], self.conv.stride[0],
                       self.conv.dilation[0])
            top, bottom = _same_pads(x.shape[1], k, s, d)
            left, right = _same_pads(x.shape[2], k, s, d)
            x = F.pad(x, (0, 0, left, right, top, bottom))
        x = self.bn(conv_nhwc(x, self.conv, torch.float32), train)
        if self.act == 'relu6':
            return torch.clamp(x, 0.0, 6.0)
        if self.act == 'hswish':
            return hard_swish(x)
        if self.act == 'relu':
            return F.relu(x)
        return x


class _SE(nn.Module):
    """Squeeze-excite: biased 1x1s ``conv1.conv`` (ReLU) and
    ``conv2.conv`` (hard sigmoid) on the global pool."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.conv1 = nn.Module()
        self.conv1.conv = nn.Conv2d(channels, hidden, 1)
        self.conv2 = nn.Module()
        self.conv2.conv = nn.Conv2d(hidden, channels, 1)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        s = y.mean(dim=(1, 2), keepdim=True)
        s = F.relu(conv_nhwc(s, self.conv1.conv, torch.float32))
        return y * hard_sigmoid(conv_nhwc(s, self.conv2.conv, torch.float32))


class InvertedResidualV3(nn.Module):
    """One table row: ``expand_conv``, ``depthwise_conv``, ``se``,
    ``linear_conv``; ``residual`` decided by the caller."""

    def __init__(self, in_channels: int, mid: int, out_channels: int,
                 kernel: int, stride: int, dilation: int, with_se: bool,
                 act: str, same_pad: bool, residual: bool):
        super().__init__()
        self.residual = residual
        self.expand_conv = ConvBNAct(in_channels, mid, 1, act=act) \
            if mid != in_channels else None
        self.depthwise_conv = ConvBNAct(mid, mid, kernel, stride,
                                        groups=mid, dilation=dilation,
                                        act=act, same_pad=same_pad)
        self.se = _SE(mid, make_divisible(mid // 4, 8)) if with_se else None
        self.linear_conv = ConvBNAct(mid, out_channels, 1, act='none')

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x if self.expand_conv is None else self.expand_conv(x, train)
        y = self.depthwise_conv(y, train)
        if self.se is not None:
            y = self.se(y)
        y = self.linear_conv(y, train)
        return x + y if self.residual else y


# [kernel, mid_channels, out_channels, with_se, act, stride] (the
# reference's tables, mobilenet_v3.py:44-71)
ARCH = {
    'small': [(3, 16, 16, True, 'relu', 2), (3, 72, 24, False, 'relu', 2),
              (3, 88, 24, False, 'relu', 1), (5, 96, 40, True, 'hswish', 2),
              (5, 240, 40, True, 'hswish', 1), (5, 240, 40, True, 'hswish', 1),
              (5, 120, 48, True, 'hswish', 1), (5, 144, 48, True, 'hswish', 1),
              (5, 288, 96, True, 'hswish', 2), (5, 576, 96, True, 'hswish', 1),
              (5, 576, 96, True, 'hswish', 1)],
    'large': [(3, 16, 16, False, 'relu', 1), (3, 64, 24, False, 'relu', 2),
              (3, 72, 24, False, 'relu', 1), (5, 72, 40, True, 'relu', 2),
              (5, 120, 40, True, 'relu', 1), (5, 120, 40, True, 'relu', 1),
              (3, 240, 80, False, 'hswish', 2),
              (3, 200, 80, False, 'hswish', 1),
              (3, 184, 80, False, 'hswish', 1),
              (3, 184, 80, False, 'hswish', 1),
              (3, 480, 112, True, 'hswish', 1),
              (3, 672, 112, True, 'hswish', 1),
              (5, 672, 160, True, 'hswish', 2),
              (5, 960, 160, True, 'hswish', 1),
              (5, 960, 160, True, 'hswish', 1)],
}


@BACKBONES.register_module()
class MobileNetV3(nn.Module):
    """MobileNetV3 at output stride 8; a tuple of the ``out_indices``
    layers' maps (layer 0 the stem, N + 1 the last 1x1)."""

    def __init__(self, arch: str = 'small',
                 out_indices: Sequence[int] = (0, 1, 12),
                 reduction_factor: int = 1,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        table = ARCH[arch]
        self.out_indices = tuple(out_indices)
        surgery = (7, 13) if arch == 'large' else (4, 9)
        self.layer0 = ConvBNAct(3, 16, 3, 2, act='hswish', same_pad=True)
        cin = 16
        for i, (k, mid, c, se, act, stride) in enumerate(table):
            li = i + 1
            if (arch == 'large' and i >= 12) or (arch == 'small' and i >= 8):
                mid //= reduction_factor
                c //= reduction_factor
            dilation = 1
            if li >= surgery[0]:
                dilation = 2 if li < surgery[1] else 4
            self.add_module(f'layer{li}', InvertedResidualV3(
                cin, mid, c, k, 1 if li in surgery else stride, dilation, se,
                act, stride == 2, stride == 1 and cin == c))
            cin = c
        self.num_layers = len(table) + 2
        self.add_module(f'layer{len(table) + 1}', ConvBNAct(
            cin, 576 if arch == 'small' else 960, 1, dilation=4,
            act='hswish'))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.float()
        outs = []
        for li in range(self.num_layers):
            x = getattr(self, f'layer{li}')(x, train)
            if li in self.out_indices:
                outs.append(x)
        if return_attn:
            return tuple(outs), ([], None)
        return tuple(outs)
