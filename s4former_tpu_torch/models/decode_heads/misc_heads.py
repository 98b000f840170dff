"""FCN, SETR-MLA, PSP, UPer and OCR decode heads (counterpart of
``s4former_tpu/models/decode_heads/misc_heads.py``; reference:
mmseg/models/decode_heads/fcn_head.py, setr_mla_head.py, psp_head.py,
uper_head.py, ocr_head.py).

NHWC, in f32 as the JAX heads (``zoo_heads.HeadBase``); the conv blocks
are the SETR-PUP head's ``ConvBNReLU`` (bias-free conv, SyncBN over the
data group, ReLU). Parameter names follow the reference layout:

- ``FCNHead``: ``convs.{i}.conv|bn``, ``conv_cat.conv|bn``, ``conv_seg``.
  With ``num_convs=0`` it is ``conv_seg`` on its (PatchShuffle-undone)
  input, as SETR-MLA's four aux heads are. Under ``resize_concat`` its
  ``in_channels`` is the list of the levels' widths (OCRNet's first
  stage: the four HRNet maps resized to the first's and concatenated,
  the PatchShuffle undone on that map).
- ``SETRMLAHead``: per input level ``up_convs.{i}.0`` and ``.1`` (two 3x3
  ``ConvBNReLU``s to ``mla_channels``), then a bilinear x``up_scale``; the
  levels concatenated; ``conv_seg``. Each level's PatchShuffle is undone
  before its convs.
- ``PSPHead``: the pyramid pooling branches ``psp_modules.{i}.1`` (an
  adaptive average pool to s x s, a 1x1 ``ConvBNReLU``, bilinear back),
  the input first in the concatenation, ``bottleneck``, ``conv_seg``; the
  PatchShuffle undone on its input.
- ``UPerHead``: PSP on the deepest level (``psp_modules.{i}.1``,
  ``bottleneck``), 1x1 laterals on the others (``lateral_convs.{i}``),
  the top-down sums (each level plus the next deeper one resized to it),
  3x3 ``fpn_convs.{i}`` on all but the deepest, every level resized to
  the first and concatenated, ``fpn_bottleneck``, ``conv_seg``. Like
  JAX's (l.199-200), it never undoes a PatchShuffle.
- ``OCRHead``: a cascade stage; its last input is the previous stage's
  logits. ``bottleneck`` (3x3) on the resize-concat features; the
  previous logits resized to that map if need be, a softmax over the
  pixels of each class map, and the class contexts (``bpk,bpc->bkc``);
  the object-attention block (``object_context_block``): the pixels'
  query through two 1x1 conv-BN-ReLUs (``query_project.{0,1}``), the
  contexts as a [B, K, 1, C] map (its BNs pool over batch and classes)
  through two for the key (``key_project.{0,1}``) and one for the value
  (``value_project``), attention over the classes scaled by
  ``ocr_channels`` ** -0.5, ``out_project``, and the fusion
  ``bottleneck`` on [context, pixels]; ``conv_seg``. It never undoes a
  PatchShuffle (JAX l.264-268).
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
        if input_transform == 'resize_concat':
            in_channels = sum(in_channels)
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


@HEADS.register_module()
class UPerHead(HeadBase):
    """PSP on the deepest level, FPN top-down fusion, the classifier."""

    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 channels: int = 512, num_classes: int = 150,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(num_classes, tuple(in_index), input_transform,
                         cls_channels=channels, **kwargs)
        self.psp_modules = nn.ModuleList([
            PooledConv(s, ConvBNReLU(in_channels[-1], channels, 1))
            for s in pool_scales])
        self.bottleneck = ConvBNReLU(
            in_channels[-1] + len(pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList([
            ConvBNReLU(c, channels, 1) for c in in_channels[:-1]])
        self.fpn_convs = nn.ModuleList([
            ConvBNReLU(channels, channels, 3) for _ in in_channels[:-1]])
        self.fpn_bottleneck = ConvBNReLU(len(in_channels) * channels,
                                         channels, 3)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        feats = [inputs[i].float() for i in self.in_index]
        x = feats[-1]
        hw = tuple(x.shape[1:3])
        branches = [x] + [resize_bilinear(m(x, train), hw,
                                          self.align_corners)
                          for m in self.psp_modules]
        laterals = [conv(f, train) for conv, f in
                    zip(self.lateral_convs, feats[:-1])]
        laterals.append(self.bottleneck(torch.cat(branches, dim=-1), train))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], tuple(laterals[i - 1].shape[1:3]),
                self.align_corners)
        outs = [conv(lat, train) for conv, lat in
                zip(self.fpn_convs, laterals)] + [laterals[-1]]
        hw = tuple(outs[0].shape[1:3])
        outs = [o if tuple(o.shape[1:3]) == hw else
                resize_bilinear(o, hw, self.align_corners) for o in outs]
        y = self.fpn_bottleneck(torch.cat(outs, dim=-1), train)
        return self._cls(y, train, generator)


class _ObjectContextBlock(nn.Module):
    """The reference's ``ObjectAttentionBlock`` parameters (1x1
    conv-BN-ReLUs)."""

    def __init__(self, channels: int, ocr_channels: int):
        super().__init__()
        self.query_project = nn.ModuleList([
            ConvBNReLU(channels, ocr_channels, 1),
            ConvBNReLU(ocr_channels, ocr_channels, 1)])
        self.key_project = nn.ModuleList([
            ConvBNReLU(channels, ocr_channels, 1),
            ConvBNReLU(ocr_channels, ocr_channels, 1)])
        self.value_project = ConvBNReLU(channels, ocr_channels, 1)
        self.out_project = ConvBNReLU(ocr_channels, channels, 1)
        self.bottleneck = ConvBNReLU(2 * channels, channels, 1)


@HEADS.register_module()
class OCRHead(HeadBase):
    """Object-contextual representations: a cascade stage on the backbone
    features and the previous stage's logits."""

    def __init__(self, in_channels=2048, channels: int = 512,
                 num_classes: int = 19, ocr_channels: int = 256,
                 scale: int = 1, in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        self.scale = scale
        self.ocr_channels = ocr_channels
        if input_transform == 'resize_concat':
            in_channels = sum(in_channels)
        self.bottleneck = ConvBNReLU(in_channels, channels, 3)
        self.object_context_block = _ObjectContextBlock(channels,
                                                        ocr_channels)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        prev = inputs[-1].float()
        x = self.bottleneck(self._pick(list(inputs[:-1]), None, 0).float(),
                            train)
        b, h, w, c = x.shape
        if tuple(prev.shape[1:3]) != (h, w):
            prev = resize_bilinear(prev, (h, w), self.align_corners)
        # the class contexts: a softmax over the pixels of each class map
        probs = torch.softmax(self.scale * prev.reshape(b, h * w, -1), dim=1)
        context = torch.einsum('bpk,bpc->bkc', probs, x.reshape(b, h * w, c))
        ctx = context[:, :, None, :]                  # [B, K, 1, C]
        ocb = self.object_context_block
        q = x
        for conv in ocb.query_project:
            q = conv(q, train)
        k = ctx
        for conv in ocb.key_project:
            k = conv(k, train)
        v = ocb.value_project(ctx, train)
        sim = torch.einsum('bhwc,bkc->bhwk', q, k[:, :, 0]) * \
            float(self.ocr_channels) ** -0.5
        ocr = torch.einsum('bhwk,bkc->bhwc', sim.softmax(dim=-1), v[:, :, 0])
        ocr = ocb.out_project(ocr, train)
        y = ocb.bottleneck(torch.cat([ocr, x], dim=-1), train)
        return self._cls(y, train, generator)
