"""The shared base of the zoo's decode heads and the heads of the JAX
``zoo_heads.py`` (its counterpart, whole: ``_HeadBase`` l.38-65,
``SepConvBNReLU`` l.87, ``ASPPHead`` l.119, ``DepthwiseSeparableASPPHead``
l.154, ``DepthwiseSeparableFCNHead`` l.200, ``NonLocal2d`` l.228 and the
NL, GC and DNL heads l.254-355, ``ANNHead`` l.360, ``APCHead`` l.437,
``DMHead`` l.486, ``EMAHead`` l.536, ``EncHead`` l.610, ``ISAHead`` l.662,
``LRASPPHead`` l.729, ``_psamask`` l.766, ``PSAHead`` l.793, ``DAHead``
l.877; reference: mmseg/models/decode_heads/decode_head.py:35-105 and the
heads' files, mmcv's NonLocal2d, ContextBlock and PSAMask).

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
l.188-190), so it stays shuffled. ``ASPPHead`` is DeepLabV3's: the same
image pool and branches with dilated 3x3 ``ConvBNReLU``s.

The context heads keep mmseg's keys (each class says which) and JAX's
computation, f32, attention as plain einsums and softmaxes; BNs take
flax's eps 1e-5 and momentum 0.9 whatever the config's ``norm_cfg``. All
but ``ANNHead`` (its high level only) and ``EncHead`` (never) undo the
PatchShuffle on their input, as JAX's ``_pick`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.decode_heads.base import (
    transform_inputs, unshuffle_feature_map)
from s4former_tpu_torch.models.decode_heads.setr_up import (BatchNorm,
                                                            ConvBNReLU,
                                                            conv_nhwc)
from s4former_tpu_torch.models.dropout import dropout
from s4former_tpu_torch.ops.encoding import Encoding
from s4former_tpu_torch.ops.resize import (adaptive_avg_pool, avg_pool_nhwc,
                                           resize_bilinear)
from s4former_tpu_torch.parallel.distributed import data_size
from s4former_tpu_torch.parallel.mesh import global_sum
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
class ASPPHead(HeadBase):
    """DeepLabV3's ASPP: the image pool, a 1x1 branch where the dilation
    is 1, else a dilated 3x3, the 3x3 ``bottleneck`` on their
    concatenation, the classifier."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.image_pool = PooledConv(1, ConvBNReLU(in_channels, channels, 1))
        self.aspp_modules = nn.ModuleList([
            self._branch(in_channels, channels, d) for d in dilations])
        self.bottleneck = ConvBNReLU((len(dilations) + 1) * channels,
                                     channels, 3)

    @staticmethod
    def _branch(in_channels: int, channels: int, dilation: int) -> nn.Module:
        return ConvBNReLU(in_channels, channels, 1 if dilation == 1 else 3,
                          dilation=dilation)

    def aspp_forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, h, w, _ = x.shape
        # the image pool's 1 x 1 map bilinearly resized to h x w is that
        # map repeated (both bilinear taps read its one pixel)
        pooled = self.image_pool.conv(x.mean(dim=(1, 2), keepdim=True),
                                      train)
        branches = [pooled.expand(b, h, w, pooled.shape[-1])]
        branches += [m(x, train) for m in self.aspp_modules]
        return self.bottleneck(torch.cat(branches, dim=-1), train)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        return self._cls(self.aspp_forward(x, train), train, generator)


@HEADS.register_module()
class DepthwiseSeparableASPPHead(ASPPHead):
    """DeepLabV3+: separable ASPP + the low-level (c1) skip fusion."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 c1_in_channels: int = 256, c1_channels: int = 48,
                 c1_index: int = 0,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(in_channels, channels, num_classes, dilations,
                         in_index, input_transform, **kwargs)
        self.c1_index = c1_index
        self.c1_bottleneck = ConvBNReLU(c1_in_channels, c1_channels, 1) \
            if c1_in_channels > 0 else None
        fuse_in = channels + (c1_channels if c1_in_channels > 0 else 0)
        self.sep_bottleneck = nn.ModuleList([
            SepConvBNReLU(fuse_in, channels, 3),
            SepConvBNReLU(channels, channels, 3)])

    @staticmethod
    def _branch(in_channels: int, channels: int, dilation: int) -> nn.Module:
        return ConvBNReLU(in_channels, channels, 1) if dilation == 1 else \
            SepConvBNReLU(in_channels, channels, 3, dilation)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        y = self.aspp_forward(x, train)
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


# ------------------------------------------------------- the context heads
class ConvOnly(nn.Module):
    """A biased 1x1 conv under the key ``conv`` (an mmcv ConvModule
    without norm or activation)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.conv, torch.float32)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ [* scale]) v over [B, L, C] rows."""
    sim = torch.einsum('bqc,bkc->bqk', q, k)
    if scale is not None:
        sim = sim * scale
    return torch.einsum('bqk,bkc->bqc', torch.softmax(sim, dim=-1), v)


class NonLocal2d(nn.Module):
    """mmcv NonLocal2d, embedded Gaussian: biased 1x1 ``theta``, ``phi``,
    ``g`` to max(C // reduction, 1), softmax(theta phiᵀ [/ sqrt(inter)]) g,
    ``conv_out`` (bias-free 1x1 + BN, no activation), plus the input."""

    def __init__(self, channels: int, reduction: int = 2,
                 use_scale: bool = True):
        super().__init__()
        self.use_scale = use_scale
        self.inter = max(channels // reduction, 1)
        for name in ('g', 'theta', 'phi'):
            setattr(self, name, ConvOnly(channels, self.inter))
        self.conv_out = ConvBNReLU(self.inter, channels, 1)

    def project(self, x: torch.Tensor):
        b, h, w, _ = x.shape
        return [m(x).reshape(b, h * w, self.inter)
                for m in (self.theta, self.phi, self.g)]

    def out(self, x: torch.Tensor, y: torch.Tensor,
            train: bool) -> torch.Tensor:
        y = y.reshape(*x.shape[:3], self.inter)
        return x + self.conv_out(y, train, relu=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = _attend(*self.project(x),
                    self.inter ** -0.5 if self.use_scale else None)
        return self.out(x, y, train)


class DisentangledNonLocal2d(NonLocal2d):
    """DNL's block: theta and phi less their means over the pixels, the
    pairwise softmax scaled by 1/sqrt(inter) and 1/``temperature``, plus
    the unary softmax of the biased 1x1 ``conv_mask``, both applied to g."""

    def __init__(self, channels: int, reduction: int = 2,
                 use_scale: bool = True, temperature: float = 0.05):
        super().__init__(channels, reduction, use_scale)
        self.temperature = temperature
        self.conv_mask = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, h, w, _ = x.shape
        q, k, v = self.project(x)
        q = q - q.mean(dim=1, keepdim=True)
        k = k - k.mean(dim=1, keepdim=True)
        sim = torch.einsum('bqc,bkc->bqk', q, k)
        if self.use_scale:
            sim = sim / math.sqrt(self.inter)
        pairwise = torch.softmax(sim / self.temperature, dim=-1)
        unary = torch.softmax(
            conv_nhwc(x, self.conv_mask, torch.float32).reshape(b, 1, h * w),
            dim=-1)
        y = torch.einsum('bqk,bkc->bqc', pairwise + unary, v)
        return self.out(x, y, train)


class ContextBlock(nn.Module):
    """mmcv ContextBlock (GCNet), channel-add fusion: the context pooled
    by the softmax of the biased 1x1 ``conv_mask`` over the pixels
    ('att'; else the mean), through ``channel_add_conv`` (1x1, LayerNorm
    over [planes, 1, 1] with flax's eps 1e-6, ReLU, 1x1), added to every
    pixel."""

    def __init__(self, channels: int, ratio: float = 0.25,
                 pooling_type: str = 'att'):
        super().__init__()
        self.pooling_type = pooling_type
        planes = max(int(channels * ratio), 1)
        if pooling_type == 'att':
            self.conv_mask = nn.Conv2d(channels, 1, 1)
        self.channel_add_conv = nn.Sequential(
            nn.Conv2d(channels, planes, 1),
            nn.LayerNorm([planes, 1, 1], eps=1e-6), nn.ReLU(),
            nn.Conv2d(planes, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if self.pooling_type == 'att':
            mask = torch.softmax(
                conv_nhwc(x, self.conv_mask, torch.float32).reshape(
                    b, h * w), dim=-1)
            context = torch.einsum('bp,bpc->bc', mask, x.reshape(b, h * w, c))
        else:
            context = x.mean(dim=(1, 2))
        t = self.channel_add_conv(context[:, :, None, None])
        return x + t[:, None, None, :, 0, 0]


class _FCNScaffold(HeadBase):
    """FCNHead(num_convs=2) around a block: ``convs.0`` -> the block ->
    ``convs.1`` (+ ``conv_cat`` on [input, out]) -> the classifier, all
    3x3 (the NL, GC and DNL heads)."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21, concat_input: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.convs = nn.ModuleList([ConvBNReLU(in_channels, channels, 3),
                                    ConvBNReLU(channels, channels, 3)])
        self.concat_input = concat_input
        if concat_input:
            self.conv_cat = ConvBNReLU(in_channels + channels, channels, 3)

    def block(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        y = self.convs[1](self.block(self.convs[0](x, train), train), train)
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1), train)
        return self._cls(y, train, generator)


@HEADS.register_module()
class NLHead(_FCNScaffold):
    """NLNet: ``nl_block`` (NonLocal2d) between the FCN convs. ``mode`` is
    taken and, as JAX's, not read: the block is the embedded Gaussian."""

    def __init__(self, reduction: int = 2, use_scale: bool = True,
                 mode: str = 'embedded_gaussian', **kwargs):
        super().__init__(**kwargs)
        self.nl_block = NonLocal2d(self.convs[0].conv.out_channels,
                                   reduction, use_scale)

    def block(self, y, train):
        return self.nl_block(y, train)


@HEADS.register_module()
class GCHead(_FCNScaffold):
    """GCNet: ``gc_block`` (ContextBlock) between the FCN convs. Whatever
    ``fusion_types`` says, the fusion is channel-add, as JAX's."""

    def __init__(self, ratio: float = 0.25, pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add',), **kwargs):
        super().__init__(**kwargs)
        self.gc_block = ContextBlock(self.convs[0].conv.out_channels, ratio,
                                     pooling_type)

    def block(self, y, train):
        return self.gc_block(y)


@HEADS.register_module()
class DNLHead(_FCNScaffold):
    """DNLNet: ``dnl_block`` (the disentangled non-local block) between
    the FCN convs; ``mode`` taken and not read, as JAX's."""

    def __init__(self, reduction: int = 2, use_scale: bool = True,
                 mode: str = 'embedded_gaussian', temperature: float = 0.05,
                 **kwargs):
        super().__init__(**kwargs)
        self.dnl_block = DisentangledNonLocal2d(
            self.convs[0].conv.out_channels, reduction, use_scale,
            temperature)

    def block(self, y, train):
        return self.dnl_block(y, train)


def _ppm_concat(x: torch.Tensor, scales: Sequence[int]) -> torch.Tensor:
    """[B, sum s², C]: the map adaptively pooled to each s x s, rows
    concatenated."""
    b, c = x.shape[0], x.shape[-1]
    return torch.cat([adaptive_avg_pool(x, (s, s)).reshape(b, s * s, c)
                      for s in scales], dim=1)


class _ANNBlock(nn.Module):
    """ANN's self-attention block: ``query_project`` and ``key_project``
    (1x1 ConvBNReLU to ``channels``; one module under both names when
    shared, as the reference registers it), a biased 1x1
    ``value_project`` and ``out_project`` at ``out_channels``; keys and
    values PPM-pooled after their projections; scaled by channels^-0.5."""

    def __init__(self, key_in: int, query_in: int, channels: int,
                 out_channels: int, share_key_query: bool,
                 key_pool_scales: Sequence[int]):
        super().__init__()
        self.scales = tuple(key_pool_scales)
        self.channels = channels
        self.key_project = ConvBNReLU(key_in, channels, 1)
        self.query_project = self.key_project if share_key_query else \
            ConvBNReLU(query_in, channels, 1)
        self.value_project = nn.Conv2d(key_in, out_channels, 1)
        self.out_project = nn.Conv2d(out_channels, out_channels, 1)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                train: bool) -> torch.Tensor:
        b, h, w, _ = query.shape
        q = self.query_project(query, train).reshape(b, h * w, self.channels)
        k = _ppm_concat(self.key_project(key, train), self.scales)
        v = _ppm_concat(conv_nhwc(key, self.value_project, torch.float32),
                        self.scales)
        y = _attend(q, k, v, float(self.channels) ** -0.5)
        return conv_nhwc(y.reshape(b, h, w, -1), self.out_project,
                         torch.float32)


@HEADS.register_module()
class ANNHead(HeadBase):
    """ANNNet. AFNB (``fusion``): per query scale a block with the high
    level as query and the low level as key and value, summed, then the
    act-free ``fusion.bottleneck`` on [context, high]; the head's dropout
    (train mode) here; the 3x3 ``bottleneck``; APNB (``context``): blocks
    with a shared query/key projection on that map, ``context.bottleneck``
    on [context, map]; the classifier (no dropout before it). Each of
    ``query_scales`` adds a block whose query is, as JAX's, not pooled.
    The PatchShuffle is undone on the high level only: the low level's
    keys and values stay shuffled (JAX l.402-406)."""

    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 channels: int = 512, num_classes: int = 21,
                 project_channels: int = 256,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 in_index: Sequence[int] = (-2, -1),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(num_classes, tuple(in_index), input_transform,
                         cls_channels=channels, **kwargs)
        low, high = in_channels[0], in_channels[-1]
        self.fusion = nn.Module()
        self.fusion.stages = nn.ModuleList([
            _ANNBlock(low, high, project_channels, high, False,
                      key_pool_scales) for _ in query_scales])
        self.fusion.bottleneck = ConvBNReLU(2 * high, high, 1)
        self.bottleneck = ConvBNReLU(high, channels, 3)
        self.context = nn.Module()
        self.context.stages = nn.ModuleList([
            _ANNBlock(channels, channels, project_channels, channels, True,
                      key_pool_scales) for _ in query_scales])
        self.context.bottleneck = ConvBNReLU(2 * channels, channels, 1)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        feats = [inputs[i].float() for i in self.in_index] \
            if isinstance(inputs, (list, tuple)) else [inputs.float()] * 2
        low, high = feats[0], feats[-1]
        if patchmix_perm is not None and patchmix_n:
            high = unshuffle_feature_map(high, patchmix_perm, patchmix_n)
        ctx = sum(s(high, low, train) for s in self.fusion.stages)
        y = self.fusion.bottleneck(torch.cat([ctx, high], dim=-1), train,
                                   relu=False)
        if train and self.dropout_ratio > 0:
            y = dropout(y, self.dropout_ratio, generator)
        y = self.bottleneck(y, train)
        ctx = sum(s(y, y, train) for s in self.context.stages)
        y = self.context.bottleneck(torch.cat([ctx, y], dim=-1), train)
        return conv_nhwc(y, self.conv_seg, torch.float32)


class _ACM(nn.Module):
    """APCNet's adaptive context module at pool scale ``s``: the pooled
    map (``pooled_redu_conv``), the reduced map (``input_redu_conv``),
    the sigmoid affinities of the biased 1x1 ``gla`` on the reduced map
    plus its pooled global context (``global_info``), the affinity-
    weighted pooled features through ``residual_conv``, ReLU of their sum
    with the reduced map, ``fusion_conv`` if ``fusion``."""

    def __init__(self, scale: int, in_channels: int, channels: int,
                 fusion: bool):
        super().__init__()
        self.scale = scale
        self.pooled_redu_conv = ConvBNReLU(in_channels, channels, 1)
        self.input_redu_conv = ConvBNReLU(in_channels, channels, 1)
        self.global_info = ConvBNReLU(channels, channels, 1)
        self.gla = nn.Conv2d(channels, scale * scale, 1)
        self.residual_conv = ConvBNReLU(channels, channels, 1)
        self.fusion_conv = ConvBNReLU(channels, channels, 1) \
            if fusion else None

    def forward(self, raw: torch.Tensor, train: bool) -> torch.Tensor:
        b, s = raw.shape[0], self.scale
        pooled = self.pooled_redu_conv(adaptive_avg_pool(raw, (s, s)), train)
        x = self.input_redu_conv(raw, train)
        gi = self.global_info(x.mean(dim=(1, 2), keepdim=True), train)
        aff = torch.sigmoid(conv_nhwc(x + gi, self.gla, torch.float32))
        z = torch.einsum('bhwk,bkc->bhwc', aff,
                         pooled.reshape(b, s * s, pooled.shape[-1]))
        z = F.relu(self.residual_conv(z, train) + x)
        return z if self.fusion_conv is None else self.fusion_conv(z, train)


@HEADS.register_module()
class APCHead(HeadBase):
    """APCNet: ``acm_modules.{i}`` per pool scale, the 3x3 ``bottleneck``
    on [input, every module's map], the classifier."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 fusion: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.acm_modules = nn.ModuleList([
            _ACM(s, in_channels, channels, fusion) for s in pool_scales])
        self.bottleneck = ConvBNReLU(
            in_channels + len(pool_scales) * channels, channels, 3)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        raw = self._pick(inputs, patchmix_perm, patchmix_n).float()
        branches = [raw] + [m(raw, train) for m in self.acm_modules]
        return self._cls(self.bottleneck(torch.cat(branches, dim=-1), train),
                         train, generator)


class _DCM(nn.Module):
    """DMNet's dynamic convolution module of filter size ``fs``: per
    channel an fs x fs filter from the biased 1x1 ``filter_gen_conv`` on
    the map adaptively pooled to fs x fs, applied as a correlation to the
    reduced map (``input_redu_conv``) padded as the reference pads (one
    more row and column before than after on even sizes), ``norm`` (BN),
    ReLU, ``fusion_conv`` if ``fusion``."""

    def __init__(self, fs: int, in_channels: int, channels: int,
                 fusion: bool):
        super().__init__()
        self.fs = fs
        self.filter_gen_conv = nn.Conv2d(in_channels, channels, 1)
        self.input_redu_conv = ConvBNReLU(in_channels, channels, 1)
        self.norm = BatchNorm(channels)
        self.fusion_conv = ConvBNReLU(channels, channels, 1) \
            if fusion else None

    def forward(self, raw: torch.Tensor, train: bool) -> torch.Tensor:
        fs = self.fs
        b = raw.shape[0]
        filt = conv_nhwc(adaptive_avg_pool(raw, (fs, fs)),
                         self.filter_gen_conv, torch.float32)  # [B, fs, fs, C]
        y = self.input_redu_conv(raw, train)
        _, h, w, c = y.shape
        pad = (fs - 1) // 2
        lo, hi = (pad, pad) if (fs - 1) % 2 == 0 else (pad + 1, pad)
        yp = F.pad(y, (0, 0, lo, hi, lo, hi))
        patches = torch.stack([yp[:, a:a + h, e:e + w] for a in range(fs)
                               for e in range(fs)], dim=-2)
        ctx = torch.einsum('bhwkc,bkc->bhwc', patches,
                           filt.reshape(b, fs * fs, c))
        ctx = F.relu(self.norm(ctx, train))
        return ctx if self.fusion_conv is None else self.fusion_conv(ctx,
                                                                     train)


@HEADS.register_module()
class DMHead(HeadBase):
    """DMNet: ``dcm_modules.{i}`` per filter size, the 3x3 ``bottleneck``
    on [input, every module's map], the classifier."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 filter_sizes: Sequence[int] = (1, 3, 5, 7),
                 fusion: bool = False,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.dcm_modules = nn.ModuleList([
            _DCM(fs, in_channels, channels, fusion) for fs in filter_sizes])
        self.bottleneck = ConvBNReLU(
            in_channels + len(filter_sizes) * channels, channels, 3)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        raw = self._pick(inputs, patchmix_perm, patchmix_n).float()
        branches = [raw] + [m(raw, train) for m in self.dcm_modules]
        return self._cls(self.bottleneck(torch.cat(branches, dim=-1), train),
                         train, generator)


class _EMAModule(nn.Module):
    """The EM bases: ``bases`` [1, C, K], the reference's buffer layout,
    L2-normal over the channels."""

    def __init__(self, channels: int, num_bases: int, num_stages: int,
                 momentum: float):
        super().__init__()
        self.num_stages = num_stages
        self.momentum = momentum
        self.register_buffer('bases', torch.empty(1, channels, num_bases))
        self.init_seeded(None)

    @torch.no_grad()
    def init_seeded(self, generator: Optional[torch.Generator]):
        """Normal with std sqrt(2 / num_bases), L2-normalised."""
        k = self.bases.shape[-1]
        bases = torch.randn(self.bases.shape, generator=generator) * \
            math.sqrt(2.0 / k)
        self.bases.copy_(bases / torch.linalg.vector_norm(bases, dim=1,
                                                          keepdim=True))

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, train: bool) -> torch.Tensor:
        """EM iterations on [B, N, C] features (no gradient flows through
        them, as the reference runs them under no_grad); the
        reconstruction [B, N, C]. In train mode ``bases`` moves by
        ``momentum`` towards the batch's mean bases (the global batch's
        under data parallelism), L2-normalised."""
        b = feats.shape[0]
        mu = self.bases.transpose(1, 2).expand(b, -1, -1)    # [B, K, C]
        attn = None
        for _ in range(self.num_stages):
            attn = torch.softmax(torch.einsum('bpc,bkc->bpk', feats, mu),
                                 dim=-1)
            attn_normed = attn / (attn.sum(dim=1, keepdim=True) + 1e-12)
            mu = torch.einsum('bpk,bpc->bkc', attn_normed, feats)
            mu = mu / (torch.linalg.vector_norm(mu, dim=-1, keepdim=True)
                       + 1e-12)
        recon = torch.einsum('bkc,bpk->bpc', mu, attn)
        if train:
            new = global_sum(mu.sum(dim=0, keepdim=True)) / (b * data_size())
            new = new / (torch.linalg.vector_norm(new, dim=-1, keepdim=True)
                         + 1e-12)
            old = self.bases.transpose(1, 2)
            self.bases.copy_(((1 - self.momentum) * old +
                              self.momentum * new).transpose(1, 2))
        return recon


@HEADS.register_module()
class EMAHead(HeadBase):
    """EMANet: ``ema_in_conv`` (3x3), the frozen biased 1x1
    ``ema_mid_conv`` (its output detached: its weights get no gradient),
    the EM bases (``ema_module``), ReLU, ``ema_out_conv`` (1x1 + BN),
    ReLU of the sum with ``ema_in_conv``'s map, the 3x3 ``bottleneck``,
    ``conv_cat`` on [input, map] if ``concat_input``, the classifier. The
    gradient reaches the loss through that sum's first term only."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21, ema_channels: int = 256,
                 num_bases: int = 64, num_stages: int = 3,
                 momentum: float = 0.1, concat_input: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.ema_in_conv = ConvBNReLU(in_channels, ema_channels, 3)
        self.ema_mid_conv = ConvOnly(ema_channels, ema_channels)
        self.ema_module = _EMAModule(ema_channels, num_bases, num_stages,
                                     momentum)
        self.ema_out_conv = ConvBNReLU(ema_channels, ema_channels, 1)
        self.bottleneck = ConvBNReLU(ema_channels, channels, 3)
        self.concat_input = concat_input
        if concat_input:
            self.conv_cat = ConvBNReLU(in_channels + channels, channels, 3)
        # no loss reads the frozen 1x1 (the train step checks the set)
        self.unused_parameters = ('ema_mid_conv.conv.weight',
                                  'ema_mid_conv.conv.bias')

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        raw = self._pick(inputs, patchmix_perm, patchmix_n).float()
        x = self.ema_in_conv(raw, train)
        b, h, w, c = x.shape
        with torch.no_grad():
            feats = self.ema_mid_conv(x).reshape(b, h * w, c)
        recon = F.relu(self.ema_module(feats, train).reshape(b, h, w, c))
        recon = self.ema_out_conv(recon, train, relu=False)
        y = self.bottleneck(F.relu(x + recon), train)
        if self.concat_input:
            y = self.conv_cat(torch.cat([raw, y], dim=-1), train)
        return self._cls(y, train, generator)


class _EncModule(nn.Module):
    """EncNet's module: ``encoding_project`` (1x1), ``encoding.0``
    (``Encoding``), ``encoding.1`` (BN over the codes axis), ReLU, the
    mean over the codes, ``fc.0`` (Linear) and a sigmoid."""

    def __init__(self, channels: int, num_codes: int):
        super().__init__()
        self.encoding_project = ConvBNReLU(channels, channels, 1)
        self.encoding = nn.ModuleList([Encoding(channels, num_codes),
                                       BatchNorm(num_codes)])
        self.fc = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor, train: bool):
        """(gamma [B, C], the encoded vector [B, C])."""
        encoded = self.encoding[0](self.encoding_project(x, train))
        encoded = self.encoding[1](encoded.transpose(1, 2),
                                   train).transpose(1, 2)   # BN over K
        vec = F.relu(encoded).mean(dim=1)
        return torch.sigmoid(self.fc[0](vec)), vec


@HEADS.register_module()
class EncHead(HeadBase):
    """EncNet: the 3x3 ``bottleneck`` on the deepest input (with
    ``add_lateral``: 1x1 ``lateral_convs`` of the others resized to it
    and the 3x3 ``fusion``), ``enc_module``, ReLU(x + x * gamma), the
    classifier. It reads its inputs as they come and never undoes a
    PatchShuffle (JAX l.631). With ``use_se_loss`` the ``se_layer``
    (Linear to the classes) is built and its logits are returned by
    ``forward(..., return_se_logits=True)``, as JAX sows them; no step
    trains them (JAX's step reads no ``se_logits``)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 channels: int = 512, num_classes: int = 21,
                 num_codes: int = 32, use_se_loss: bool = False,
                 add_lateral: bool = False,
                 loss_se_decode: Optional[dict] = None,
                 in_index: Sequence[int] = (0, 1, 2),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(num_classes, tuple(in_index), input_transform,
                         cls_channels=channels, **kwargs)
        self.add_lateral = add_lateral and len(in_channels) > 1
        self.bottleneck = ConvBNReLU(in_channels[-1], channels, 3)
        if self.add_lateral:
            self.lateral_convs = nn.ModuleList([
                ConvBNReLU(c, channels, 1) for c in in_channels[:-1]])
            self.fusion = ConvBNReLU(len(in_channels) * channels, channels, 3)
        self.enc_module = _EncModule(channels, num_codes)
        self.se_layer = nn.Linear(channels, num_classes) \
            if use_se_loss else None
        self.unused_parameters = ('se_layer.weight', 'se_layer.bias') \
            if use_se_loss else ()

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None,
                return_se_logits: bool = False):
        feats = [inputs[i].float() for i in self.in_index] \
            if isinstance(inputs, (list, tuple)) else [inputs.float()]
        x = self.bottleneck(feats[-1], train)
        if self.add_lateral:
            hw = tuple(x.shape[1:3])
            laterals = [resize_bilinear(conv(f, train), hw,
                                        self.align_corners)
                        for conv, f in zip(self.lateral_convs, feats[:-1])]
            x = self.fusion(torch.cat([x] + laterals, dim=-1), train)
        gamma, vec = self.enc_module(x, train)
        logits = self._cls(F.relu(x + x * gamma[:, None, None, :]), train,
                           generator)
        if not return_se_logits:
            return logits
        return logits, None if self.se_layer is None else self.se_layer(vec)


class _ISABlock(nn.Module):
    """ISANet's self-attention block: two 1x1 ConvBNReLUs each for
    ``query_project`` and ``key_project`` (to ``isa_channels``), a biased
    1x1 ``value_project``, attention scaled by isa_channels^-0.5, the 1x1
    ``output_project``."""

    def __init__(self, channels: int, isa_channels: int):
        super().__init__()
        self.isa_channels = isa_channels
        self.query_project = nn.ModuleList([
            ConvBNReLU(channels, isa_channels, 1),
            ConvBNReLU(isa_channels, isa_channels, 1)])
        self.key_project = nn.ModuleList([
            ConvBNReLU(channels, isa_channels, 1),
            ConvBNReLU(isa_channels, isa_channels, 1)])
        self.value_project = nn.Conv2d(channels, channels, 1)
        self.output_project = ConvBNReLU(channels, channels, 1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, h, w, c = x.shape
        q, k = x, x
        for qm, km in zip(self.query_project, self.key_project):
            q, k = qm(q, train), km(k, train)
        ci = self.isa_channels
        y = _attend(q.reshape(b, h * w, ci), k.reshape(b, h * w, ci),
                    conv_nhwc(x, self.value_project,
                              torch.float32).reshape(b, h * w, c),
                    float(ci) ** -0.5)
        return self.output_project(y.reshape(b, h, w, c), train)


@HEADS.register_module()
class ISAHead(HeadBase):
    """ISANet: ``in_conv`` (3x3); the map padded (centred) to whole
    ``down_factor`` blocks and split glb-major; ``global_relation`` over
    the block grid at each offset within a block, then
    ``local_relation`` within each block; the padding cut off;
    ``out_conv`` (1x1) on [attention, ``in_conv``'s map]; the
    classifier."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21, isa_channels: int = 256,
                 down_factor: Sequence[int] = (8, 8),
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.down_factor = tuple(down_factor)
        self.in_conv = ConvBNReLU(in_channels, channels, 3)
        self.global_relation = _ISABlock(channels, isa_channels)
        self.local_relation = _ISABlock(channels, isa_channels)
        self.out_conv = ConvBNReLU(2 * channels, channels, 1)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.in_conv(self._pick(inputs, patchmix_perm,
                                    patchmix_n).float(), train)
        b, h, w, c = x.shape
        loc_h, loc_w = min(self.down_factor[0], h), \
            min(self.down_factor[1], w)
        glb_h, glb_w = -(-h // loc_h), -(-w // loc_w)
        pad_h, pad_w = glb_h * loc_h - h, glb_w * loc_w - w
        y = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                      pad_h // 2, pad_h - pad_h // 2))
        y = y.reshape(b, glb_h, loc_h, glb_w, loc_w, c)
        y = y.permute(0, 2, 4, 1, 3, 5).reshape(b * loc_h * loc_w, glb_h,
                                                glb_w, c)
        y = self.global_relation(y, train)
        y = y.reshape(b, loc_h, loc_w, glb_h, glb_w, c)
        y = y.permute(0, 3, 4, 1, 2, 5).reshape(b * glb_h * glb_w, loc_h,
                                                loc_w, c)
        y = self.local_relation(y, train)
        y = y.reshape(b, glb_h, glb_w, loc_h, loc_w, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, glb_h * loc_h,
                                                glb_w * loc_w, c)
        y = y[:, pad_h // 2:pad_h // 2 + h, pad_w // 2:pad_w // 2 + w]
        x = self.out_conv(torch.cat([y, x], dim=-1), train)
        return self._cls(x, train, generator)


def psamask(a: torch.Tensor, mask_size: Sequence[int], collect: bool
            ) -> torch.Tensor:
    """PSAMask as a gather, JAX's buffer exactly (JAX ``_psamask``, l.766,
    contracts one-hot matrices). ``a``: [B, h, w, mask_h * mask_w], the
    relative attention each position predicts. Returns [B, h*w, h*w]:
    with ``collect`` buffer[b, (s, z), (t, u)] = a[b, t, u, m, v] where
    (m, v) = (t, u) - (s, z) + ((mask_h - 1) // 2, (mask_w - 1) // 2),
    zero where that lies outside the mask; distribute is its transpose.
    (JAX's contraction reads the mask mirrored against its docstring's
    s = t + m - hh, mmcv's offsets; the port follows the code.)"""
    b, h, w, _ = a.shape
    mh, mw = mask_size
    t = torch.arange(h, device=a.device)
    u = torch.arange(w, device=a.device)
    m = t[None, :] - t[:, None] + (mh - 1) // 2     # [s, t]
    v = u[None, :] - u[:, None] + (mw - 1) // 2     # [z, u]
    ok = ((m >= 0) & (m < mh))[:, None, :, None] & \
        ((v >= 0) & (v < mw))[None, :, None, :]     # [s, z, t, u]
    src = ((t[:, None] * w + u[None, :]) * (mh * mw))[None, None] + \
        m[:, None, :, None] * mw + v[None, :, None, :]
    zero = h * w * mh * mw                          # a zero appended
    idx = torch.where(ok, src, torch.full_like(src, zero)).reshape(1, -1)
    flat = torch.cat([a.reshape(b, -1), a.new_zeros(b, 1)], dim=1)
    out = torch.gather(flat, 1, idx.expand(b, -1)).reshape(b, h * w, h * w)
    return out if collect else out.transpose(1, 2)


@HEADS.register_module()
class PSAHead(HeadBase):
    """PSANet: ``reduce`` (1x1) [and ``reduce_p`` for bi-direction]; per
    branch the map shrunk by ``shrink_factor`` (align_corners switched on
    when both sides are indivisible), ``attention.0`` (1x1 ConvBNReLU) and
    the bias-free ``attention.1`` to mask_h * mask_w, ``psamask`` (or the
    compact transpose: single-direction collect and bi-direction
    distribute transpose, as the reference), a softmax over the source
    positions, x @ buffer / ``normalization_factor``; the branches
    concatenated; ``proj`` (the reference's 1x1 with padding 1: the map
    grows by one pixel a side); resized back; the 3x3 ``bottleneck`` on
    [input, out]; the classifier."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21,
                 mask_size: Sequence[int] = (97, 97),
                 psa_type: str = 'bi-direction', compact: bool = False,
                 shrink_factor: int = 2, normalization_factor: float = 1.0,
                 psa_softmax: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.mask_size = tuple(mask_size)
        self.psa_type = psa_type
        self.compact = compact
        self.shrink_factor = shrink_factor
        self.normalization_factor = normalization_factor
        self.psa_softmax = psa_softmax
        n = self.mask_size[0] * self.mask_size[1]
        bi = psa_type not in ('collect', 'distribute')
        for suffix in ('', '_p') if bi else ('',):
            setattr(self, 'reduce' + suffix,
                    ConvBNReLU(in_channels, channels, 1))
            setattr(self, 'attention' + suffix, nn.ModuleList([
                ConvBNReLU(channels, channels, 1),
                nn.Conv2d(channels, n, 1, bias=False)]))
        self.proj = ConvBNReLU((2 if bi else 1) * channels, in_channels, 1)
        self.bottleneck = ConvBNReLU(2 * in_channels, channels, 3)

    def _branch(self, x, train, attention, collect, compact_transpose):
        b, h, w, c = x.shape
        align = self.align_corners
        sf = self.shrink_factor
        if sf != 1:
            if h % sf and w % sf:
                h, w, align = (h - 1) // sf + 1, (w - 1) // sf + 1, True
            else:
                h, w, align = h // sf, w // sf, False
            x = resize_bilinear(x, (h, w), align)
        y = conv_nhwc(attention[0](x, train), attention[1], torch.float32)
        if self.compact:
            y = y.reshape(b, h * w, h * w)
            if compact_transpose:
                y = y.transpose(1, 2)
        else:
            y = psamask(y, self.mask_size, collect)
        if self.psa_softmax:
            y = torch.softmax(y, dim=1)
        out = torch.einsum('bpc,bpq->bqc', x.reshape(b, h * w, c), y) * \
            (1.0 / self.normalization_factor)
        return out.reshape(b, h, w, c), align

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        identity = self._pick(inputs, patchmix_perm, patchmix_n).float()
        if self.psa_type in ('collect', 'distribute'):
            collect = self.psa_type == 'collect'
            out, align = self._branch(self.reduce(identity, train), train,
                                      self.attention, collect, collect)
        else:
            col, align = self._branch(self.reduce(identity, train), train,
                                      self.attention, True, False)
            dis, _ = self._branch(self.reduce_p(identity, train), train,
                                  self.attention_p, False, True)
            out = torch.cat([col, dis], dim=-1)
        out = self.proj(F.pad(out, (0, 0, 1, 1, 1, 1)), train)
        out = resize_bilinear(out, tuple(identity.shape[1:3]), align)
        y = self.bottleneck(torch.cat([identity, out], dim=-1), train)
        return self._cls(y, train, generator)


class Scale(nn.Module):
    """mmcv ``Scale``: one learnable factor (``scale``, shape [1])."""

    def __init__(self, value: float = 0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), value))


@HEADS.register_module()
class DAHead(HeadBase):
    """DANet. Position attention: ``pam_in_conv`` (3x3), biased 1x1
    ``pam.query_project`` / ``key_project`` (to ``pam_channels``) and
    ``value_project``, unscaled softmax attention, times ``pam.gamma``
    plus the map, ``pam_out_conv``. Channel attention: ``cam_in_conv``,
    the channel energies subtracted from their row maximum, softmax,
    times ``cam.gamma`` plus the map, ``cam_out_conv``. The classifier on
    their sum. ``pam_conv_seg`` and ``cam_conv_seg`` are held (mmseg files
    load) and, as JAX's, feed no output: they get no gradient from any
    loss."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21, pam_channels: int = 64,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.pam_in_conv = ConvBNReLU(in_channels, channels, 3)
        self.pam = nn.Module()
        self.pam.query_project = nn.Conv2d(channels, pam_channels, 1)
        self.pam.key_project = nn.Conv2d(channels, pam_channels, 1)
        self.pam.value_project = nn.Conv2d(channels, channels, 1)
        self.pam.gamma = Scale()
        self.pam_out_conv = ConvBNReLU(channels, channels, 3)
        self.cam_in_conv = ConvBNReLU(in_channels, channels, 3)
        self.cam = nn.Module()
        self.cam.gamma = Scale()
        self.cam_out_conv = ConvBNReLU(channels, channels, 3)
        self.pam_conv_seg = nn.Conv2d(channels, num_classes, 1)
        self.cam_conv_seg = nn.Conv2d(channels, num_classes, 1)
        self.unused_parameters = tuple(
            f'{m}.{p}' for m in ('pam_conv_seg', 'cam_conv_seg')
            for p in ('weight', 'bias'))

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        pam = self.pam_in_conv(x, train)
        b, h, w, c = pam.shape
        q, k, v = (conv_nhwc(pam, m, torch.float32).reshape(b, h * w, -1)
                   for m in (self.pam.query_project, self.pam.key_project,
                             self.pam.value_project))
        pam = pam + self.pam.gamma.scale * _attend(q, k, v).reshape(
            b, h, w, c)
        pam = self.pam_out_conv(pam, train)
        cam = self.cam_in_conv(x, train)
        f = cam.reshape(b, h * w, c)
        energy = torch.einsum('bpc,bpd->bcd', f, f)
        energy = energy.amax(dim=-1, keepdim=True) - energy
        ctx = torch.einsum('bcd,bpd->bpc', torch.softmax(energy, dim=-1), f)
        cam = self.cam_out_conv(cam + self.cam.gamma.scale *
                                ctx.reshape(b, h, w, c), train)
        return self._cls(pam + cam, train, generator)
