"""CNN backbones of the zoo beyond the ResNets (counterpart of
``s4former_tpu/models/backbones/cnn_zoo.py``; reference:
mmseg/models/backbones/resnext.py, resnest.py, icnet.py). For now:
ResNeXt and ResNeSt (JAX l.32-245) and ICNet (JAX l.928).

``ResNeXt`` and ``ResNeSt`` walk the ResNet stages of ``resnet.ARCH``
(``_ResNetLike``: the 7x7 stem ``conv1``/``bn1`` or with ``deep_stem``
the V1c stem ``stem.{0,1,3,4,6,7}``, the max-pool, each stage's first
block strided and shortcut, ``contract_dilation``), NHWC, f32; they take
the semi keywords and ignore them, fdrop included, as JAX's do.

- ``GroupBottleneck``: ResNet's bottleneck with the 3x3 grouped, width
  ``int(planes * base_width / 64) * groups``; the keys are ResNet's
  (``conv{c}``/``bn{c}``, ``downsample.0``/``.1``).
- ``SplitAttentionBlock``: ``conv1``/``bn1``; ``conv2``, the split
  attention: a grouped 3x3 to ``radix`` splits (``conv2.conv``,
  ``conv2.bn0``), their radix-major sum pooled, ``conv2.fc1`` (biased 1x1,
  ``conv2.bn1``, ReLU) and ``conv2.fc2`` to one attention logit a split
  and channel, a softmax over the radix (a sigmoid for one split), the
  weighted sum; with ``avg_down_stride`` the stride moves to an
  ``AvgPool(3, stride, 1)`` after it; ``conv3``/``bn3``; V1d's
  ``avg_down`` shortcut (the ceil-mode pool at ``downsample.0``, the 1x1
  at ``.1``/``.2``). ResNeSt is always a V1d: the deep stem.

``ICNet`` runs three input scales and returns their features for
``necks.ICNeck``:

- the full image through a light branch of three stride-2 3x3
  ``ConvBNReLU``s (``conv_sub1.{0,1,2}``), to 1/8;
- the half image through the inner ResNet (``backbone.*``, built from
  ``backbone_cfg`` with ``out_indices=(1, 3)`` and
  ``half_after_stage=1``: the layer2 tap, then the features halved before
  layer3); the tap through a 1x1 (``conv_sub2``);
- the deepest map through the pyramid pooling module (``psp_modules.{i}.1``
  after an adaptive pool to each scale, bilinear back; the map itself
  last in the concatenation; the 3x3 ``psp_bottleneck``) and a 1x1
  (``conv_sub4``).

NHWC, f32 (the JAX ICNet carries no ``dtype``). It draws no fdrop: the
JAX ICNet calls its inner ResNet without it, and the semi keywords are
accepted and ignored. The reference flips the inner stem's max-pool to
ceil mode; the JAX package keeps floor mode, which agrees on even sizes
(JAX resnet.py l.189-193, ``PARITY.md``), and so does the port.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.resnet import (ARCH, _conv,
                                                        _DeepStem,
                                                        _Downsample)
from s4former_tpu_torch.models.decode_heads.setr_up import (BatchNorm,
                                                            ConvBNReLU,
                                                            conv_bn,
                                                            conv_nhwc)
from s4former_tpu_torch.models.decode_heads.zoo_heads import PooledConv
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import BACKBONES


def _grouped_conv(in_channels: int, out_channels: int, stride: int,
                  dilation: int, groups: int) -> nn.Conv2d:
    """A bias-free grouped 3x3 with 'same' padding at ``dilation``."""
    return nn.Conv2d(in_channels, out_channels, 3, stride=stride,
                     padding=dilation, dilation=dilation, groups=groups,
                     bias=False)


class GroupBottleneck(nn.Module):
    """ResNeXt's bottleneck: 1x1, grouped 3x3 (stride, dilation), 1x1 to
    ``4 * planes``."""

    def __init__(self, in_channels: int, planes: int, stride: int,
                 dilation: int, downsample: bool, groups: int,
                 base_width: int):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(in_channels, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = _grouped_conv(width, width, stride, dilation, groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = _Downsample(in_channels, planes * 4, stride,
                                      False) if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv_bn(x, self.conv1, self.bn1, train)
        y = conv_bn(y, self.conv2, self.bn2, train)
        y = conv_bn(y, self.conv3, self.bn3, train, relu=False)
        identity = x if self.downsample is None else \
            self.downsample(x, train)
        return F.relu(y + identity)


class SplitAttentionConv(nn.Module):
    """The split-attention 3x3 (reference ``SplitAttentionConv2d``): its
    grouped conv, ``bn0``, ``fc1``, ``bn1`` and ``fc2``."""

    def __init__(self, width: int, stride: int, dilation: int, radix: int,
                 reduction_factor: int, groups: int):
        super().__init__()
        self.radix, self.groups, self.width = radix, groups, width
        inter = max(width * radix // reduction_factor, 32)
        self.conv = _grouped_conv(width, width * radix, stride, dilation,
                                  groups * radix)
        self.bn0 = BatchNorm(width * radix)
        self.fc1 = nn.Conv2d(width, inter, 1, groups=groups)
        self.bn1 = BatchNorm(inter)
        self.fc2 = nn.Conv2d(inter, width * radix, 1, groups=groups)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        r, g, width = self.radix, self.groups, self.width
        y = conv_bn(x, self.conv, self.bn0, train)
        b, h, w, _ = y.shape
        splits = y.reshape(b, h, w, r, width)    # radix-major channels
        gap = splits.sum(dim=3).mean(dim=(1, 2), keepdim=True)
        a = F.relu(self.bn1(conv_nhwc(gap, self.fc1, torch.float32), train))
        a = conv_nhwc(a, self.fc2, torch.float32)           # [B, 1, 1, r*w]
        if r > 1:
            # RSoftmax: (groups, radix, channels of a group) -> a softmax
            # over the radix, flattened radix-major
            a = a.reshape(b, g, r, width // g).transpose(1, 2)
            a = torch.softmax(a, dim=1).reshape(b, 1, 1, r, width)
            return (splits * a).sum(dim=3)
        return y * torch.sigmoid(a)


class SplitAttentionBlock(nn.Module):
    """ResNeSt's bottleneck: 1x1, split attention (stride on the average
    pool after it with ``avg_down_stride``), 1x1 to ``4 * planes``, V1d's
    ``avg_down`` shortcut."""

    def __init__(self, in_channels: int, planes: int, stride: int,
                 dilation: int, downsample: bool, radix: int,
                 reduction_factor: int, groups: int, base_width: int,
                 base_channels: int, avg_down_stride: bool):
        super().__init__()
        width = planes if groups == 1 else \
            int(planes * (base_width / base_channels)) * groups
        self.avd_stride = stride if avg_down_stride and stride > 1 else 1
        self.conv1 = _conv(in_channels, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = SplitAttentionConv(
            width, 1 if self.avd_stride > 1 else stride, dilation, radix,
            reduction_factor, groups)
        self.conv3 = _conv(width, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = _Downsample(in_channels, planes * 4, stride,
                                      True) if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv2(conv_bn(x, self.conv1, self.bn1, train), train)
        if self.avd_stride > 1:
            y = F.avg_pool2d(y.permute(0, 3, 1, 2), 3, self.avd_stride,
                             1).permute(0, 2, 3, 1)
        y = conv_bn(y, self.conv3, self.bn3, train, relu=False)
        identity = x if self.downsample is None else \
            self.downsample(x, train)
        return F.relu(y + identity)


class _ResNetLike(nn.Module):
    """The stage walker of ResNeXt and ResNeSt (JAX l.133-183): every
    stage's first block takes the stride and a shortcut conv, whether or
    not its shape changes."""

    def __init__(self, depth: int = 50, stem_channels: int = 64,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 deep_stem: bool = False,
                 contract_dilation: bool = False,
                 # config keys accepted for parity; no effect (as JAX)
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None, style: str = 'pytorch'):
        super().__init__()
        if depth not in ARCH:
            raise KeyError(f'invalid depth {depth} for {type(self).__name__}')
        self.deep_stem = deep_stem
        self.base_channels = base_channels
        self.out_indices = tuple(out_indices)
        if deep_stem:
            self.stem = _DeepStem(3, stem_channels)
        else:
            self.conv1 = _conv(3, stem_channels, 7, 2)
            self.bn1 = BatchNorm(stem_channels)
        channels, planes = stem_channels, base_channels
        self.layer_names = []
        for i in range(num_stages):
            blocks = []
            for j in range(ARCH[depth][1][i]):
                d = dilations[i]
                if j == 0 and d > 1 and contract_dilation:
                    d //= 2
                blocks.append(self._block(channels, planes,
                                          strides[i] if j == 0 else 1, d,
                                          j == 0))
                channels = planes * 4
            name = f'layer{i + 1}'
            self.add_module(name, nn.ModuleList(blocks))
            self.layer_names.append(name)
            planes *= 2

    def _block(self, in_channels: int, planes: int, stride: int,
               dilation: int, downsample: bool) -> nn.Module:
        raise NotImplementedError

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
                outs.append(x)
        if return_attn:
            return tuple(outs), ([], None)
        return tuple(outs)


@BACKBONES.register_module()
class ResNeXt(_ResNetLike):
    """Grouped-bottleneck ResNet."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        self.groups, self.base_width = groups, base_width
        super().__init__(**kwargs)

    def _block(self, in_channels, planes, stride, dilation, downsample):
        return GroupBottleneck(in_channels, planes, stride, dilation,
                               downsample, self.groups, self.base_width)


@BACKBONES.register_module()
class ResNeSt(_ResNetLike):
    """Split-attention ResNet, a V1d (deep stem, ``avg_down``)."""

    def __init__(self, radix: int = 2, reduction_factor: int = 4,
                 groups: int = 1, base_width: int = 4,
                 avg_down_stride: bool = True, deep_stem: bool = True,
                 **kwargs):
        self.radix, self.reduction_factor = radix, reduction_factor
        self.groups, self.base_width = groups, base_width
        self.avg_down_stride = avg_down_stride
        super().__init__(deep_stem=deep_stem, **kwargs)

    def _block(self, in_channels, planes, stride, dilation, downsample):
        return SplitAttentionBlock(in_channels, planes, stride, dilation,
                                   downsample, self.radix, self.reduction_factor,
                                   self.groups, self.base_width,
                                   self.base_channels, self.avg_down_stride)


@BACKBONES.register_module()
class ICNet(nn.Module):
    """Image cascade network: (1/8 light, 1/8 mid, 1/16 deep) features."""

    def __init__(self, backbone_cfg: Optional[dict] = None,
                 in_channels: int = 3,
                 layer_channels: Sequence[int] = (512, 2048),
                 light_branch_middle_channels: int = 32,
                 psp_out_channels: int = 512,
                 out_channels: Sequence[int] = (64, 256, 256),
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 norm_cfg: Optional[dict] = None,
                 align_corners: bool = False,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.align_corners = align_corners
        cfg = dict(backbone_cfg or dict(type='ResNetV1c', depth=50))
        cfg.update(out_indices=(1, 3), half_after_stage=1,
                   align_corners=align_corners)
        self.backbone = BACKBONES.build(cfg)
        mid = light_branch_middle_channels
        self.conv_sub1 = nn.ModuleList([
            ConvBNReLU(in_channels, mid, 3, stride=2),
            ConvBNReLU(mid, mid, 3, stride=2),
            ConvBNReLU(mid, out_channels[0], 3, stride=2)])
        self.conv_sub2 = ConvBNReLU(layer_channels[0], out_channels[1], 1)
        self.psp_modules = nn.ModuleList([
            PooledConv(s, ConvBNReLU(layer_channels[1], psp_out_channels, 1))
            for s in pool_scales])
        self.psp_bottleneck = ConvBNReLU(
            layer_channels[1] + len(pool_scales) * psp_out_channels,
            psp_out_channels, 3)
        self.conv_sub4 = ConvBNReLU(psp_out_channels, out_channels[2], 1)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.float()
        s1 = x
        for conv in self.conv_sub1:
            s1 = conv(s1, train)
        x2 = resize_bilinear(x, (x.shape[1] // 2, x.shape[2] // 2),
                             self.align_corners)
        mid, deep = self.backbone(x2, train=train)
        s2 = self.conv_sub2(mid, train)
        hw = tuple(deep.shape[1:3])
        branches = [resize_bilinear(m(deep, train), hw, self.align_corners)
                    for m in self.psp_modules] + [deep]
        d = self.psp_bottleneck(torch.cat(branches, dim=-1), train)
        outs = (s1, s2, self.conv_sub4(d, train))
        if return_attn:
            return outs, ([], None)
        return outs
