"""CNN backbones of the zoo beyond the ResNets (counterpart of
``s4former_tpu/models/backbones/cnn_zoo.py``; reference:
mmseg/models/backbones/resnext.py, resnest.py, icnet.py, bisenetv1.py,
bisenetv2.py, stdc.py, fast_scnn.py, cgnet.py, erfnet.py): ResNeXt and
ResNeSt (JAX l.32-245), ICNet (l.928) and the real-time CNNs (l.216-923,
below the ICNet notes).

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

The real-time CNNs (BiSeNetV1/V2, STDCNet and its context path,
FastSCNN, CGNet, ERFNet) follow the JAX modules op for op, NHWC, f32,
with the mmseg parameter names each class documents (the bridge's
inverses of JAX's ``convert_*``). Their BNs take JAX's hard-coded eps and
momentum, not the configs' ``norm_cfg``: 1e-5 and 0.9 (flax's) but
ERFNet's 1e-3. Resizes are nearest in BiSeNetV1 and STDC's context path
(bilinear there with ``upsample_mode``), bilinear with ``align_corners``
elsewhere; pools are flax's (floor mode, padding counted in the average,
``ops/resize.py:avg_pool_nhwc``). They accept the semi keywords and
ignore them, fdrop included, as JAX's do; ERFNet draws its dropout from
``generator``.
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
from s4former_tpu_torch.models.dropout import dropout
from s4former_tpu_torch.ops.resize import (avg_pool_nhwc, resize_bilinear,
                                           resize_nearest)
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
            y = avg_pool_nhwc(y, 3, self.avd_stride, 1)
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


# ------------------------------------------------- the real-time CNNs
def _gap(x: torch.Tensor) -> torch.Tensor:
    """Global average pool of an NHWC map to [B, 1, 1, C]."""
    return x.mean(dim=(1, 2), keepdim=True)


def _pool(x: torch.Tensor, kind: str, kernel, stride,
          padding=0) -> torch.Tensor:
    """flax ``nn.max_pool`` / ``nn.avg_pool`` on an NHWC map: floor mode,
    explicit padding (-inf for the max, zeros counted in the average)."""
    if kind == 'avg':
        return avg_pool_nhwc(x, kernel, stride, padding)
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride,
                        padding).permute(0, 2, 3, 1)


class PlainConv(nn.Module):
    """An mmcv ``ConvModule`` without norm or activation: one conv under
    ``conv`` (biased unless ``bias=False``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.conv, torch.float32)


class DWSepConv(nn.Module):
    """mmcv ``DepthwiseSeparableConvModule``: a depthwise k x k
    ``ConvBNReLU`` (``depthwise_conv``; ReLU unless ``dw_act=False``) at
    ``stride``, then a pointwise 1x1 (``pointwise_conv``): a
    ``ConvBNReLU`` (ReLU unless ``pw_act=False``), or with
    ``pw_norm=False`` a biased conv alone."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 dw_act: bool = True, pw_act: bool = True,
                 pw_norm: bool = True):
        super().__init__()
        self.dw_act, self.pw_act, self.pw_norm = dw_act, pw_act, pw_norm
        self.depthwise_conv = ConvBNReLU(in_channels, in_channels,
                                         kernel_size, stride=stride,
                                         groups=in_channels)
        self.pointwise_conv = ConvBNReLU(in_channels, out_channels, 1) \
            if pw_norm else PlainConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.depthwise_conv(x, train, relu=self.dw_act)
        if not self.pw_norm:
            return self.pointwise_conv(x)
        return self.pointwise_conv(x, train, relu=self.pw_act)


class AttentionRefinement(nn.Module):
    """ARM (BiSeNetV1, STDC): a 3x3 ``conv_layer``, then a channel gate,
    the sigmoid of a bias-free 1x1 + BN on the global pool
    (``atten_conv_layer.1``)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv_layer = ConvBNReLU(in_channels, channels, 3)
        self.atten_conv_layer = nn.ModuleDict(
            {'1': ConvBNReLU(channels, channels, 1)})

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv_layer(x, train)
        gate = self.atten_conv_layer['1'](_gap(x), train, relu=False)
        return x * torch.sigmoid(gate)


class FeatureFusion(nn.Module):
    """BiSeNetV1's FFM: the concatenation through a 1x1 (``conv1``), then
    ``x * g + x`` with g the sigmoid of a 1x1 ``ConvBNReLU`` on the global
    pool (``conv_atten.0``)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv1 = ConvBNReLU(in_channels, channels, 1)
        self.conv_atten = nn.ModuleDict({'0': ConvBNReLU(channels,
                                                         channels, 1)})

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = self.conv1(torch.cat([a, b], dim=-1), train)
        gate = torch.sigmoid(self.conv_atten['0'](_gap(x), train))
        return x * gate + x


class _Holder(nn.Module):
    """A parameter container under the reference's attribute names."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, m in modules.items():
            self.add_module(name, m)


@BACKBONES.register_module()
class BiSeNetV1(nn.Module):
    """BiSeNetV1: a spatial path (7x7, 3x3, 3x3 at stride 2, then a 1x1;
    ``spatial_path.layer{1..4}``) beside a context path on an inner
    backbone (``context_path.backbone``, ResNet-18 by default, its last
    two stages): ARMs on both (``arm16``, ``arm32``), the global pool's
    1x1 (``gap_conv.1``) added to the deepest, each resized NEAREST to the
    next and refined by a 3x3 (``conv_head32``, ``conv_head16``); the FFM
    (``ffm``) fuses the spatial and the context maps. Outputs (fused,
    context at 1/8, context at 1/16), picked by ``out_indices``. The inner
    backbone's two widths are ``context_channels[1:]``."""

    def __init__(self, backbone_cfg: Optional[dict] = None,
                 in_channels: int = 3,
                 spatial_channels: Sequence[int] = (64, 64, 64, 128),
                 context_channels: Sequence[int] = (128, 256, 512),
                 out_channels: int = 256,
                 out_indices: Sequence[int] = (0, 1, 2),
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        cfg = dict(backbone_cfg or dict(type='ResNet', depth=18))
        cfg.setdefault('out_indices', (2, 3))
        c = context_channels[0]
        chans = [in_channels] + list(spatial_channels)
        self.spatial_path = _Holder(**{
            f'layer{i + 1}': ConvBNReLU(chans[i], chans[i + 1],
                                        (7, 3, 3, 1)[i],
                                        stride=(2, 2, 2, 1)[i])
            for i in range(4)})
        self.context_path = _Holder(
            backbone=BACKBONES.build(cfg),
            arm16=AttentionRefinement(context_channels[1], c),
            arm32=AttentionRefinement(context_channels[2], c),
            conv_head32=ConvBNReLU(c, c, 3),
            conv_head16=ConvBNReLU(c, c, 3),
            gap_conv=nn.ModuleDict({'1': ConvBNReLU(context_channels[2], c,
                                                    1)}))
        self.ffm = FeatureFusion(spatial_channels[-1] + c, out_channels)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.float()
        s = x
        for i in range(4):
            s = getattr(self.spatial_path, f'layer{i + 1}')(s, train)
        cp = self.context_path
        c16, c32 = cp.backbone(x, train=train)[-2:]
        gap = cp.gap_conv['1'](_gap(c32), train)
        a32 = resize_nearest(cp.arm32(c32, train) + gap,
                             tuple(c16.shape[1:3]))
        a32 = cp.conv_head32(a32, train)
        a16 = resize_nearest(cp.arm16(c16, train) + a32,
                             tuple(s.shape[1:3]))
        a16 = cp.conv_head16(a16, train)
        outs = (self.ffm(s, a16, train), a16, a32)
        outs = tuple(outs[i] for i in self.out_indices)
        if return_attn:
            return outs, ([], None)
        return outs


class GatherExpansion(nn.Module):
    """BiSeNetV2's GE layer: a 3x3 (``conv1``), a grouped 3x3 expanding
    by ``expand`` (``dwconv.0``: with ReLU at stride 1; at stride 2 BN
    only, then a depthwise 3x3 with ReLU, ``dwconv.1``), a 1x1 (``conv2.0``,
    BN only); the shortcut is the input, or at stride 2 a separable 3x3
    (``shortcut.0``, no activations); ReLU after the sum."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        mid = in_channels * expand
        self.stride = stride
        self.conv1 = ConvBNReLU(in_channels, in_channels, 3)
        dw = [ConvBNReLU(in_channels, mid, 3, stride=stride,
                         groups=in_channels)]
        if stride == 2:
            dw.append(ConvBNReLU(mid, mid, 3, groups=mid))
        self.dwconv = nn.ModuleList(dw)
        self.conv2 = nn.ModuleList([ConvBNReLU(mid, channels, 1)])
        if stride == 2:
            self.shortcut = nn.ModuleList([DWSepConv(
                in_channels, channels, 3, 2, dw_act=False, pw_act=False)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv1(x, train)
        y = self.dwconv[0](y, train, relu=self.stride == 1)
        if self.stride == 2:
            y = self.dwconv[1](y, train)
        y = self.conv2[0](y, train, relu=False)
        sc = self.shortcut[0](x, train) if self.stride == 2 else x
        return F.relu(y + sc)


@BACKBONES.register_module()
class BiSeNetV2(nn.Module):
    """BiSeNetV2: a detail branch (``detail.detail_branch.{i}.{j}``: two
    3x3s in stage 0, three in the others, the first of each at stride 2:
    1/8), a semantic branch (the stem block ``semantic.stage1``: a 3x3 s2,
    then a 1x1 + 3x3 s2 beside a 3x3 s2 max-pool, fused by a 3x3; GE
    stages ``semantic.stage{2..}``, two layers each and four in the last;
    the context embedding ``semantic.stage{N}_CEBlock``: global pool, BN
    (``gap.1``), 1x1 ``conv_gap`` added back, 3x3 ``conv_last``) and the
    bilateral guided aggregation (``bga``): each branch gates the other
    through a sigmoid, the coarse maps resized bilinearly with
    ``align_corners``, the sum through a 3x3 (``bga.conv``). Outputs
    (aggregation, stem, semantic stages) by ``out_indices``."""

    def __init__(self, in_channels: int = 3,
                 detail_channels: Sequence[int] = (64, 64, 128),
                 semantic_channels: Sequence[int] = (16, 32, 64, 128),
                 semantic_expansion_ratio: int = 6,
                 bga_channels: int = 128,
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4),
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 align_corners: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.align_corners = align_corners
        stages, cin = [], in_channels
        for i, c in enumerate(detail_channels):
            convs = []
            for j in range(2 if i == 0 else 3):
                convs.append(ConvBNReLU(cin, c, 3, stride=2 if j == 0 else 1))
                cin = c
            stages.append(nn.ModuleList(convs))
        self.detail = _Holder(detail_branch=nn.ModuleList(stages))
        sc = semantic_channels
        semantic = {'stage1': _Holder(
            conv_first=ConvBNReLU(in_channels, sc[0], 3, stride=2),
            convs=nn.ModuleList([ConvBNReLU(sc[0], sc[0] // 2, 1),
                                 ConvBNReLU(sc[0] // 2, sc[0], 3, stride=2)]),
            fuse_last=ConvBNReLU(2 * sc[0], sc[0], 3))}
        for i, c in enumerate(sc[1:]):
            n = 4 if i == len(sc) - 2 else 2
            semantic[f'stage{i + 2}'] = nn.ModuleList(
                [GatherExpansion(sc[i], c, 2, semantic_expansion_ratio)] +
                [GatherExpansion(c, c, 1, semantic_expansion_ratio)
                 for _ in range(n - 1)])
        semantic[f'stage{len(sc)}_CEBlock'] = _Holder(
            gap=nn.ModuleDict({'1': BatchNorm(sc[-1])}),
            conv_gap=ConvBNReLU(sc[-1], sc[-1], 1),
            conv_last=ConvBNReLU(sc[-1], sc[-1], 3))
        self.semantic = _Holder(**semantic)
        self.num_semantic = len(sc)
        ch, cd = bga_channels, detail_channels[-1]
        self.bga = _Holder(
            detail_dwconv=nn.ModuleList([DWSepConv(
                cd, ch, 3, dw_act=False, pw_norm=False)]),
            detail_down=nn.ModuleList([ConvBNReLU(cd, ch, 3, stride=2)]),
            semantic_conv=nn.ModuleList([ConvBNReLU(sc[-1], ch, 3)]),
            semantic_dwconv=nn.ModuleList([DWSepConv(
                sc[-1], ch, 3, dw_act=False, pw_norm=False)]),
            conv=ConvBNReLU(ch, ch, 3))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.float()
        d = x
        for stage in self.detail.detail_branch:
            for conv in stage:
                d = conv(d, train)
        stem = self.semantic.stage1
        s = stem.conv_first(x, train)
        left = stem.convs[1](stem.convs[0](s, train), train)
        right = _pool(s, 'max', 3, 2, 1)
        s = stem.fuse_last(torch.cat([left, right], dim=-1), train)
        sem_outs = [s]
        for k in range(2, self.num_semantic + 1):
            for layer in getattr(self.semantic, f'stage{k}'):
                s = layer(s, train)
            sem_outs.append(s)
        ce = getattr(self.semantic, f'stage{self.num_semantic}_CEBlock')
        gap = ce.conv_gap(ce.gap['1'](_gap(s), train), train)
        s = ce.conv_last(s + gap, train)
        bga = self.bga
        dd = bga.detail_dwconv[0](d, train)
        da = _pool(bga.detail_down[0](d, train, relu=False), 'avg', 3, 2, 1)
        sb = bga.semantic_conv[0](s, train, relu=False)
        sd = bga.semantic_dwconv[0](s, train)
        sb = resize_bilinear(sb, tuple(dd.shape[1:3]), self.align_corners)
        fuse_1 = dd * torch.sigmoid(sb)
        fuse_2 = resize_bilinear(da * torch.sigmoid(sd),
                                 tuple(fuse_1.shape[1:3]),
                                 self.align_corners)
        outs = tuple([bga.conv(fuse_1 + fuse_2, train)] + sem_outs)
        outs = tuple(outs[i] for i in self.out_indices)
        if return_attn:
            return outs, ([], None)
        return outs


class STDCModule(nn.Module):
    """STDC's module: a 1x1 to C/2 (``layers.0``), at stride 2 a
    depthwise 3x3 s2 (``downsample``, BN only), then 3x3s halving the
    width (``layers.{1..}``, the last keeping its input's); their outputs
    concatenated to C. ``cat``: the first slot is the 1x1's output
    (average-pooled 3x3 s2 at stride 2). ``add``: the first slot is the
    downsampled 1x1's output (``layers.0`` holds the 1x1 and the
    downsample at ``.0``/``.1``, the downsample also under ``downsample``,
    as the reference shares it) and the concatenation adds to the input
    (at stride 2 its separable projection, ``skip.{0,1}``, BN only)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 num_convs: int = 4, fusion_type: str = 'cat'):
        super().__init__()
        self.stride, self.fusion_type = stride, fusion_type
        c = channels
        conv0 = ConvBNReLU(in_channels, c // 2, 1)
        down = ConvBNReLU(c // 2, c // 2, 3, stride=2, groups=c // 2) \
            if stride == 2 else None
        first = nn.ModuleList([conv0, down]) \
            if fusion_type == 'add' and down is not None else conv0
        layers, prev = [first], c // 2
        for i in range(1, num_convs):
            ch = c // (2 ** i if i == num_convs - 1 else 2 ** (i + 1))
            layers.append(ConvBNReLU(prev, ch, 3))
            prev = ch
        self.layers = nn.ModuleList(layers)
        if down is not None:
            self.downsample = down
        if fusion_type == 'add' and stride == 2:
            self.skip = nn.ModuleList([
                ConvBNReLU(in_channels, in_channels, 3, stride=2,
                           groups=in_channels),
                ConvBNReLU(in_channels, c, 1)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv0 = self.layers[0][0] if isinstance(self.layers[0],
                                                nn.ModuleList) \
            else self.layers[0]
        x0 = conv0(x, train)
        d = self.downsample(x0, train, relu=False) if self.stride == 2 \
            else x0
        y, rest = d, []
        for layer in list(self.layers)[1:]:
            y = layer(y, train)
            rest.append(y)
        if self.fusion_type == 'cat':
            first = _pool(x0, 'avg', 3, 2, 1) if self.stride == 2 else x0
            return torch.cat([first] + rest, dim=-1)
        skip = x
        if self.stride == 2:
            skip = self.skip[1](self.skip[0](x, train, relu=False), train,
                                relu=False)
        return torch.cat([d] + rest, dim=-1) + skip


@BACKBONES.register_module()
class STDCNet(nn.Module):
    """STDCNet: two 3x3 s2 convs (``stages.0``, ``.1``), then three
    stages of STDC modules (``stages.{2,3,4}.{j}``, each stage's first at
    stride 2); outputs the three stages' maps (1/8, 1/16, 1/32) by
    ``out_indices``; ``with_final_conv`` adds a 1x1 (``final_conv``) on
    the last."""

    ARCH = {'STDCNet1': ((2, 1), (2, 1), (2, 1)),
            'STDCNet2': ((2, 1, 1, 1), (2, 1, 1, 1, 1), (2, 1, 1))}

    def __init__(self, stdc_type: str = 'STDCNet1', in_channels: int = 3,
                 channels: Sequence[int] = (32, 64, 256, 512, 1024),
                 bottleneck_type: str = 'cat', num_convs: int = 4,
                 with_final_conv: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2),
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        stages = [ConvBNReLU(in_channels, channels[0], 3, stride=2),
                  ConvBNReLU(channels[0], channels[1], 3, stride=2)]
        for i, strides in enumerate(self.ARCH[stdc_type]):
            stages.append(nn.ModuleList([
                STDCModule(channels[i + 1] if j == 0 else channels[i + 2],
                           channels[i + 2], st, num_convs, bottleneck_type)
                for j, st in enumerate(strides)]))
        self.stages = nn.ModuleList(stages)
        self.final_conv = ConvBNReLU(channels[-1], max(1024, channels[-1]),
                                     1) if with_final_conv else None

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.stages[1](self.stages[0](x.float(), train), train)
        outs = []
        for stage in list(self.stages)[2:]:
            for module in stage:
                x = module(x, train)
            outs.append(x)
        if self.final_conv is not None:
            outs[-1] = self.final_conv(outs[-1], train)
        outs = tuple(outs[i] for i in self.out_indices)
        if return_attn:
            return outs, ([], None)
        return outs


class STDCFeatureFusion(nn.Module):
    """STDC's FFM: a 1x1 (``conv0``) on the concatenation, then ``x * g +
    x`` with g a two-conv bottleneck on the global pool (bias-free, no
    norm: ``attention.1`` with ReLU, ``attention.2``) and a sigmoid."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 4):
        super().__init__()
        inter = out_channels // scale_factor
        self.conv0 = ConvBNReLU(in_channels, out_channels, 1)
        self.attention = nn.ModuleDict({
            '1': PlainConv(out_channels, inter, bias=False),
            '2': PlainConv(inter, out_channels, bias=False)})

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = self.conv0(torch.cat([a, b], dim=-1), train)
        g = F.relu(self.attention['1'](_gap(x)))
        return x * torch.sigmoid(self.attention['2'](g)) + x


@BACKBONES.register_module()
class STDCContextPathNet(nn.Module):
    """STDC's context path on an STDCNet (``backbone``): the deepest map's
    global pool through a 1x1 (``conv_avg``), then twice an ARM
    (``arms.{i}``) on the next shallower map plus the running context,
    resized (nearest, or bilinear with ``align_corners`` when
    ``upsample_mode`` says so) and refined by a 3x3 (``convs.{i}``); the
    FFM (``ffm``) fuses the 1/8 map with the last context. Outputs (1/8
    map, context at 1/16, context at 1/8, fused), the order the stdc
    configs' ``in_index`` values read."""

    def __init__(self, backbone_cfg: Optional[dict] = None,
                 last_in_channels: Sequence[int] = (1024, 512),
                 out_channels: int = 128,
                 ffm_cfg: Optional[dict] = None,
                 ffn_channels: int = 256,
                 upsample_mode: str = 'nearest',
                 align_corners: Optional[bool] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        bcfg = dict(backbone_cfg or dict(type='STDCNet'))
        self.backbone = BACKBONES.build(bcfg)
        self.upsample_mode = upsample_mode
        self.align_corners = bool(align_corners)
        c = out_channels
        self.arms = nn.ModuleList([AttentionRefinement(cin, c)
                                   for cin in last_in_channels])
        self.convs = nn.ModuleList([ConvBNReLU(c, c, 3) for _ in range(2)])
        self.conv_avg = ConvBNReLU(last_in_channels[0], c, 1)
        ffm = dict(ffm_cfg) if ffm_cfg else dict(out_channels=ffn_channels,
                                                 scale_factor=4)
        chans = bcfg.get('channels', (32, 64, 256, 512, 1024))
        self.ffm = STDCFeatureFusion(chans[2] + c, ffm['out_channels'],
                                     ffm.get('scale_factor', 4))

    def _up(self, t: torch.Tensor, hw) -> torch.Tensor:
        if self.upsample_mode == 'nearest':
            return resize_nearest(t, tuple(hw))
        return resize_bilinear(t, tuple(hw), self.align_corners)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        outs = list(self.backbone(x.float(), train=train))
        up = self._up(self.conv_avg(_gap(outs[-1]), train),
                      outs[-1].shape[1:3])
        arms_out = []
        for i in range(2):
            a = self.arms[i](outs[len(outs) - 1 - i], train) + up
            up = self.convs[i](self._up(a, outs[len(outs) - 2 - i].shape[1:3]),
                               train)
            arms_out.append(up)
        result = (outs[0], arms_out[0], arms_out[1],
                  self.ffm(outs[0], arms_out[1], train))
        if return_attn:
            return result, ([], None)
        return result


class InvertedResidual(nn.Module):
    """Fast-SCNN's inverted residual: 1x1 expand, depthwise 3x3 at
    ``stride``, 1x1 projection (BN only) under ``conv.{0,1,2}``; the
    input added where the shape is kept."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        e = in_channels * expand
        self.residual = stride == 1 and in_channels == channels
        self.conv = nn.ModuleList([
            ConvBNReLU(in_channels, e, 1),
            ConvBNReLU(e, e, 3, stride=stride, groups=e),
            ConvBNReLU(e, channels, 1)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv[1](self.conv[0](x, train), train)
        y = self.conv[2](y, train, relu=False)
        return y + x if self.residual else y


@BACKBONES.register_module()
class FastSCNN(nn.Module):
    """Fast-SCNN: learning to downsample (``learning_to_downsample``: a
    3x3 s2 ``conv``, two separable 3x3 s2 ``dsconv1``/``dsconv2`` with no
    activation on the depthwise: 1/8), the global feature extractor
    (``global_feature_extractor``: three inverted residuals a stage,
    ``bottleneck{1,2,3}``; the pyramid pooling ``ppm.{i}.1`` to
    ``global_block_channels[-1] // 4`` each; ``out``, a 3x3) and the
    feature fusion (``feature_fusion``: the coarse map resized up, a
    depthwise 3x3 ``dwconv``, 1x1 ``conv_lower_res`` and
    ``conv_higher_res``, BN only, summed and ReLU). Outputs (higher,
    lower, fused) by ``out_indices``."""

    def __init__(self, in_channels: int = 3,
                 downsample_dw_channels: Sequence[int] = (32, 48),
                 global_in_channels: int = 64,
                 global_block_channels: Sequence[int] = (64, 96, 128),
                 global_block_strides: Sequence[int] = (2, 2, 1),
                 global_out_channels: int = 128,
                 higher_in_channels: int = 64,
                 lower_in_channels: int = 128,
                 fusion_out_channels: int = 128,
                 out_indices: Sequence[int] = (0, 1, 2),
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 norm_cfg: Optional[dict] = None,
                 align_corners: bool = False,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.align_corners = align_corners
        c0, c1 = downsample_dw_channels
        self.learning_to_downsample = _Holder(
            conv=ConvBNReLU(in_channels, c0, 3, stride=2),
            dsconv1=DWSepConv(c0, c1, 3, 2, dw_act=False),
            dsconv2=DWSepConv(c1, global_in_channels, 3, 2, dw_act=False))
        gfe, cin = {}, global_in_channels
        for i, (c, st) in enumerate(zip(global_block_channels,
                                        global_block_strides)):
            gfe[f'bottleneck{i + 1}'] = nn.ModuleList([
                InvertedResidual(cin if j == 0 else c, c,
                                 st if j == 0 else 1) for j in range(3)])
            cin = c
        inter = global_block_channels[-1] // 4
        gfe['ppm'] = nn.ModuleList([PooledConv(s, ConvBNReLU(cin, inter, 1))
                                    for s in pool_scales])
        gfe['out'] = ConvBNReLU(cin + len(pool_scales) * inter,
                                global_out_channels, 3)
        self.global_feature_extractor = _Holder(**gfe)
        co = global_out_channels
        self.feature_fusion = _Holder(
            dwconv=ConvBNReLU(co, co, 3, groups=co),
            conv_lower_res=ConvBNReLU(co, fusion_out_channels, 1),
            conv_higher_res=ConvBNReLU(global_in_channels,
                                       fusion_out_channels, 1))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        lds = self.learning_to_downsample
        higher = lds.dsconv2(lds.dsconv1(lds.conv(x.float(), train), train),
                             train)
        gfe = self.global_feature_extractor
        g = higher
        for i in range(1, 4):
            for block in getattr(gfe, f'bottleneck{i}'):
                g = block(g, train)
        hw = tuple(g.shape[1:3])
        branches = [g] + [resize_bilinear(m(g, train), hw, self.align_corners)
                          for m in gfe.ppm]
        lower = gfe.out(torch.cat(branches, dim=-1), train)
        ff = self.feature_fusion
        up = resize_bilinear(lower, tuple(higher.shape[1:3]),
                             self.align_corners)
        up = ff.conv_lower_res(ff.dwconv(up, train), train, relu=False)
        hi = ff.conv_higher_res(higher, train, relu=False)
        outs = (higher, lower, F.relu(up + hi))
        outs = tuple(outs[i] for i in self.out_indices)
        if return_attn:
            return outs, ([], None)
        return outs


class PReLU(nn.Module):
    """torch ``nn.PReLU(C)`` on an NHWC map: a learned slope a channel
    (``weight``, 0.25 at init) for the negative inputs."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class ConvBNPReLU(ConvBNReLU):
    """mmcv ``ConvModule`` with a PReLU activation (``activate``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride)
        self.activate = PReLU(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                relu: bool = True) -> torch.Tensor:
        return self.activate(super().forward(x, train, relu=False))


class CGBlock(nn.Module):
    """CGNet's context-guided block: ``conv1x1`` (a 3x3 s2 to C when
    downsampling, else a 1x1 to C/2; BN + PReLU), a depthwise 3x3
    (``f_loc``) beside a dilated one (``f_sur``), concatenated, BN
    (``bn``) + PReLU (``activate``), a 1x1 to C when downsampling
    (``bottleneck``), then the global context gate: biased linear layers
    on the global pool (``f_glo.fc.0`` with ReLU, ``.2`` with sigmoid);
    the input added when not downsampling."""

    def __init__(self, in_channels: int, channels: int, dilation: int = 2,
                 reduction: int = 16, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        n = channels if downsample else channels // 2
        self.conv1x1 = ConvBNPReLU(in_channels, n, 3 if downsample else 1,
                                   stride=2 if downsample else 1)
        self.f_loc = nn.Conv2d(n, n, 3, padding=1, groups=n, bias=False)
        self.f_sur = nn.Conv2d(n, n, 3, padding=dilation, dilation=dilation,
                               groups=n, bias=False)
        self.bn = BatchNorm(2 * n)
        self.activate = PReLU(2 * n)
        c = channels if downsample else 2 * n
        if downsample:
            self.bottleneck = nn.Conv2d(2 * n, c, 1, bias=False)
        self.f_glo = _Holder(fc=nn.ModuleDict({
            '0': nn.Linear(c, c // reduction),
            '2': nn.Linear(c // reduction, c)}))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv1x1(x, train)
        joi = torch.cat([conv_nhwc(y, self.f_loc, torch.float32),
                         conv_nhwc(y, self.f_sur, torch.float32)], dim=-1)
        joi = self.activate(self.bn(joi, train))
        if self.downsample:
            joi = conv_nhwc(joi, self.bottleneck, torch.float32)
        fc = self.f_glo.fc
        g = torch.sigmoid(fc['2'](F.relu(fc['0'](joi.mean(dim=(1, 2))))))
        joi = joi * g[:, None, None, :]
        return joi if self.downsample else joi + x


@BACKBONES.register_module()
class CGNet(nn.Module):
    """CGNet: a stem of three 3x3 ConvBN + PReLU (``stem.{0,1,2}``, the
    first at stride 2); the image, average-pooled 3x3 s2 once and twice,
    injected into the first two concatenations; BN + PReLU
    (``norm_prelu_{k}.0``/``.1``) after each concatenation
    ([stem, image/2], [stage 1, its first block, image/4], [stage 2's
    first block, stage 2]); CG-block stages ``level1``, ``level2``, each
    first block downsampling. Outputs the three concatenations' maps by
    ``out_indices``."""

    def __init__(self, in_channels: int = 3,
                 num_channels: Sequence[int] = (32, 64, 128),
                 num_blocks: Sequence[int] = (3, 21),
                 dilations: Sequence[int] = (2, 4),
                 reductions: Sequence[int] = (8, 16),
                 out_indices: Sequence[int] = (0, 1, 2),
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        c0, c1, c2 = num_channels
        self.stem = nn.ModuleList([
            ConvBNPReLU(in_channels if i == 0 else c0, c0, 3,
                        stride=2 if i == 0 else 1) for i in range(3)])
        widths = (c0 + in_channels, 2 * c1 + in_channels, 2 * c2)
        for k, w in enumerate(widths):
            self.add_module(f'norm_prelu_{k}',
                            nn.ModuleList([BatchNorm(w), PReLU(w)]))
        self.level1 = nn.ModuleList([
            CGBlock(widths[0] if j == 0 else c1, c1, dilations[0],
                    reductions[0], downsample=j == 0)
            for j in range(num_blocks[0])])
        self.level2 = nn.ModuleList([
            CGBlock(widths[1] if j == 0 else c2, c2, dilations[1],
                    reductions[1], downsample=j == 0)
            for j in range(num_blocks[1])])

    def _norm_prelu(self, y: torch.Tensor, k: int,
                    train: bool) -> torch.Tensor:
        bn, act = getattr(self, f'norm_prelu_{k}')
        return act(bn(y, train))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.float()
        y = x
        for conv in self.stem:
            y = conv(y, train)
        inp_2x = _pool(x, 'avg', 3, 2, 1)
        inp_4x = _pool(inp_2x, 'avg', 3, 2, 1)
        y = self._norm_prelu(torch.cat([y, inp_2x], dim=-1), 0, train)
        outs = [y]
        for j, block in enumerate(self.level1):
            y = block(y, train)
            if j == 0:
                down1 = y
        y = self._norm_prelu(torch.cat([y, down1, inp_4x], dim=-1), 1, train)
        outs.append(y)
        for j, block in enumerate(self.level2):
            y = block(y, train)
            if j == 0:
                down2 = y
        outs.append(self._norm_prelu(torch.cat([down2, y], dim=-1), 2,
                                     train))
        outs = tuple(outs[i] for i in self.out_indices)
        if return_attn:
            return outs, ([], None)
        return outs


class NonBottleneck1d(nn.Module):
    """ERFNet's factorised residual block, every conv biased, BN eps 1e-3
    (``convs_layers.{0,2,3,5,7,8}``): 3x1, ReLU, 1x3, BN, ReLU, then the
    same at ``dilation`` (3x1 dilated in H, 1x3 in W) with BN and, in
    train mode, element-wise dropout; ReLU of the sum with the input."""

    def __init__(self, channels: int, dilation: int = 1,
                 drop_rate: float = 0.0):
        super().__init__()
        c, d = channels, dilation
        self.drop_rate = drop_rate
        self.convs_layers = nn.ModuleDict({
            '0': nn.Conv2d(c, c, (3, 1), padding=(1, 0)),
            '2': nn.Conv2d(c, c, (1, 3), padding=(0, 1)),
            '3': BatchNorm(c, eps=1e-3),
            '5': nn.Conv2d(c, c, (3, 1), padding=(d, 0), dilation=(d, 1)),
            '7': nn.Conv2d(c, c, (1, 3), padding=(0, d), dilation=(1, d)),
            '8': BatchNorm(c, eps=1e-3)})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        m = self.convs_layers
        y = F.relu(conv_nhwc(x, m['0'], torch.float32))
        y = F.relu(m['3'](conv_nhwc(y, m['2'], torch.float32), train))
        y = F.relu(conv_nhwc(y, m['5'], torch.float32))
        y = m['8'](conv_nhwc(y, m['7'], torch.float32), train)
        if train and self.drop_rate > 0:
            y = dropout(y, self.drop_rate, generator)
        return F.relu(y + x)


class DownsamplerBlock(nn.Module):
    """ERFNet's downsampler: a biased 3x3 s2 conv to C - Cin beside a 2x2
    max-pool (resized bilinearly to the conv's size when they differ),
    concatenated; BN eps 1e-3 (``bn``), ReLU."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels - in_channels, 3,
                              stride=2, padding=1)
        self.bn = BatchNorm(channels, eps=1e-3)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        conv = conv_nhwc(x, self.conv, torch.float32)
        pool = _pool(x, 'max', 2, 2)
        if pool.shape[1:3] != conv.shape[1:3]:
            pool = resize_bilinear(pool, tuple(conv.shape[1:3]), False)
        return F.relu(self.bn(torch.cat([conv, pool], dim=-1), train))


class UpsamplerBlock(nn.Module):
    """ERFNet's upsampler: a biased 3x3 transposed conv at stride 2
    (padding 1, output padding 1: twice the size), BN eps 1e-3, ReLU."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_channels, channels, 3, stride=2,
                                       padding=1, output_padding=1)
        self.bn = BatchNorm(channels, eps=1e-3)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        xin = x.permute(0, 3, 1, 2)
        if xin.device.type == 'cpu':
            xin = xin.contiguous()
        y = F.conv_transpose2d(xin, self.conv.weight, self.conv.bias,
                               stride=2, padding=1, output_padding=1)
        return F.relu(self.bn(y.permute(0, 2, 3, 1), train))


@BACKBONES.register_module()
class ERFNet(nn.Module):
    """ERFNet: an encoder (``encoder.{i}``: downsamplers, the middle
    stage's non-bottlenecks at dilation 1, the last stage cycling through
    ``enc_non_bottleneck_dilations``, all with ``dropout_ratio``) and a
    decoder (``decoder.{i}``: an upsampler then non-bottlenecks without
    dropout, a stage). Outputs the decoder's map (1/2) as a 1-tuple. The
    blocks keep their own BN eps 1e-3 whatever ``norm_cfg`` says, as the
    reference's and JAX's."""

    def __init__(self, in_channels: int = 3,
                 enc_downsample_channels: Sequence[int] = (16, 64, 128),
                 enc_stage_non_bottlenecks: Sequence[int] = (5, 8),
                 enc_non_bottleneck_dilations: Sequence[int] = (2, 4, 8, 16),
                 enc_non_bottleneck_channels: Sequence[int] = (64, 128),
                 dec_upsample_channels: Sequence[int] = (64, 16),
                 dec_stages_non_bottleneck: Sequence[int] = (2, 2),
                 dec_non_bottleneck_channels: Sequence[int] = (64, 16),
                 dropout_ratio: float = 0.1,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        ch = enc_downsample_channels
        enc = [DownsamplerBlock(in_channels, ch[0])]
        for i in range(len(ch) - 1):
            enc.append(DownsamplerBlock(ch[i], ch[i + 1]))
            if i == len(ch) - 2:
                times = enc_stage_non_bottlenecks[-1] // \
                    len(enc_non_bottleneck_dilations)
                enc += [NonBottleneck1d(ch[-1], d, dropout_ratio)
                        for _ in range(times)
                        for d in enc_non_bottleneck_dilations]
            else:
                enc += [NonBottleneck1d(ch[i + 1], 1, dropout_ratio)
                        for _ in range(enc_stage_non_bottlenecks[i])]
        self.encoder = nn.ModuleList(enc)
        dec, cin = [], ch[-1]
        for s, c in enumerate(dec_non_bottleneck_channels):
            dec.append(UpsamplerBlock(cin, c))
            dec += [NonBottleneck1d(c)
                    for _ in range(dec_stages_non_bottleneck[s])]
            cin = c
        self.decoder = nn.ModuleList(dec)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        y = x.float()
        for block in list(self.encoder) + list(self.decoder):
            y = block(y, train, generator)
        if return_attn:
            return (y,), ([], None)
        return (y,)
