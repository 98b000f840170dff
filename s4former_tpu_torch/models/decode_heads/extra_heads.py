"""FPN, CCNet, Segmenter and STDC decode heads (counterparts of
``FPNHead`` l.37, ``CrissCrossAttention`` l.79, ``CCHead`` l.112,
``SegmenterMaskTransformerHead`` l.142-207, ``_laplacian`` l.212,
``stdc_boundary_targets`` l.219 and ``STDCHead`` l.238 in
``s4former_tpu/models/decode_heads/extra_heads.py``; reference:
mmseg/models/decode_heads/fpn_head.py, cc_head.py with mmcv's
CrissCrossAttention, segmenter_mask_head.py, stdc_head.py).

``FPNHead`` (Panoptic FPN): per level, one 3x3 ``ConvBNReLU`` a halving
between its stride and the finest, each followed by a bilinear x2 where
the level is coarser than the finest; the levels summed at the finest,
then the classifier. Reference keys ``scale_heads.{i}.{k}`` (the convs at
0, 2, 4, ... between the parameter-free upsamples; at 0 on the finest
level). It reads ``inputs[i]`` as they come: no PatchShuffle undo (JAX
l.55-56).

``CCHead`` (CCNet): ``FCNHead`` with two convs (``convs.{0,1}``,
``conv_cat``) and ``recurrence`` passes of one criss-cross attention
(``cca``) between them; the PatchShuffle undone on its input. The
attention is two einsums over a pixel's row and column (plain PyTorch, as
the JAX einsums; no kernel): the column energies carry -inf on the pixel
itself, so it is counted once, in the row softmax. Biased 1x1
``query_conv``/``key_conv`` (channels/8) and ``value_conv``; the output
``gamma * out + x`` with the scalar ``gamma.scale``, 0 at init.

``SegmenterMaskTransformerHead``: the picked feature map's patch tokens go through ``dec_proj``; the
learnable class embeddings ``cls_emb`` [1, num_classes, C] are appended;
``num_layers`` of the ViT's ``TransformerEncoderLayer`` run over the
whole sequence with plain attention (``use_flash=False``, as JAX l.184:
no kernel launches here) and drop path ramping linearly from 0 to
``drop_path_rate``; ``decoder_norm``; the patch and class tokens are
projected (``patch_proj``, ``classes_proj``, no bias), L2-normalised, and
their products are the masks, normalised over the classes by
``mask_norm``. Both norms take eps 1e-5 (mmcv's LN default; the head does
not pass the backbone's 1e-6). In f32, as the JAX head, whose layers
carry no ``dtype``. Reference keys: ``dec_proj``, ``cls_emb``,
``layers.{i}.*`` (the backbone layer's names), ``decoder_norm``,
``patch_proj``, ``classes_proj``, ``mask_norm``; no ``conv_seg``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.vit import TransformerEncoderLayer
from s4former_tpu_torch.models.decode_heads.misc_heads import FCNHead
from s4former_tpu_torch.models.decode_heads.setr_up import (ConvBNReLU,
                                                            conv_nhwc)
from s4former_tpu_torch.models.decode_heads.zoo_heads import HeadBase
from s4former_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from s4former_tpu_torch.registry import HEADS


class _ScaleHead(nn.Module):
    """One level's ``ConvBNReLU`` chain under the reference's
    ``Sequential`` indices (``step`` 2 where upsamples sit between)."""

    def __init__(self, in_channels: int, channels: int, n: int,
                 upsample: bool):
        super().__init__()
        self.upsample = upsample
        self.keys = [str(k * (2 if upsample else 1)) for k in range(n)]
        for k, key in enumerate(self.keys):
            self.add_module(key, ConvBNReLU(in_channels if k == 0
                                            else channels, channels, 3))

    def forward(self, x: torch.Tensor, train: bool,
                align_corners: bool) -> torch.Tensor:
        for key in self.keys:
            x = getattr(self, key)(x, train)
            if self.upsample:
                x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2),
                                    align_corners)
        return x


@HEADS.register_module()
class FPNHead(HeadBase):
    """Per-level scale heads summed at the finest stride."""

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 channels: int = 128, num_classes: int = 21,
                 feature_strides: Sequence[int] = (4, 8, 16, 32),
                 in_index: Union[int, Sequence[int]] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select', **kwargs):
        super().__init__(num_classes, in_index, input_transform,
                         cls_channels=channels, **kwargs)
        if min(feature_strides) != feature_strides[0]:
            raise ValueError(f'feature_strides {feature_strides}: the '
                             f'first must be the finest')
        self.scale_heads = nn.ModuleList([
            _ScaleHead(in_channels[i], channels, max(1, int(
                math.log2(s) - math.log2(feature_strides[0]))),
                       s != feature_strides[0])
            for i, s in enumerate(feature_strides)])

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        idx = self.in_index if isinstance(self.in_index, (list, tuple)) \
            else (self.in_index,)
        feats = [inputs[i] for i in idx] \
            if isinstance(inputs, (list, tuple)) else [inputs]
        out = None
        for f, head in zip(feats, self.scale_heads):
            x = head(f.float(), train, self.align_corners)
            if out is None:
                out = x
                continue
            if x.shape[1:3] != out.shape[1:3]:
                x = resize_bilinear(x, tuple(out.shape[1:3]),
                                    self.align_corners)
            out = out + x
        return self._cls(out, train, generator)


class _Scale(nn.Module):
    """mmcv ``Scale``: one learnable scalar, ``scale``."""

    def __init__(self, value: float = 0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(value)))


class CrissCrossAttention(nn.Module):
    """Each pixel attends over its own row and column."""

    def __init__(self, channels: int):
        super().__init__()
        cq = max(channels // 8, 1)
        self.query_conv = nn.Conv2d(channels, cq, 1)
        self.key_conv = nn.Conv2d(channels, cq, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = _Scale(0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = conv_nhwc(x, self.query_conv, torch.float32)
        k = conv_nhwc(x, self.key_conv, torch.float32)
        v = conv_nhwc(x, self.value_conv, torch.float32)
        h = x.shape[1]
        energy_h = torch.einsum('bhwc,bHwc->bhwH', q, k).masked_fill(
            torch.eye(h, dtype=torch.bool, device=x.device)[:, None, :],
            float('-inf'))
        energy_w = torch.einsum('bhwc,bhWc->bhwW', q, k)
        att = torch.softmax(torch.cat([energy_h, energy_w], dim=-1), dim=-1)
        out = torch.einsum('bhwH,bHwc->bhwc', att[..., :h], v) + \
            torch.einsum('bhwW,bhWc->bhwc', att[..., h:], v)
        return self.gamma.scale * out + x


@HEADS.register_module()
class CCHead(FCNHead):
    """``FCNHead`` (two convs) with criss-cross attention between them."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 21, recurrence: int = 2,
                 concat_input: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(in_channels, channels, num_classes, num_convs=2,
                         kernel_size=3, concat_input=concat_input,
                         in_index=in_index, input_transform=input_transform,
                         **kwargs)
        self.recurrence = recurrence
        self.cca = CrissCrossAttention(channels)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        y = self.convs[0](x, train)
        for _ in range(self.recurrence):
            y = self.cca(y)
        y = self.convs[1](y, train)
        if self.concat_input:
            y = self.conv_cat(torch.cat([x, y], dim=-1), train)
        return self._cls(y, train, generator)


@HEADS.register_module()
class SegmenterMaskTransformerHead(HeadBase):
    """Masks = LN(normalize(patches) @ normalize(classes)^T)."""

    def __init__(self, in_channels: int = 768, num_layers: int = 2,
                 num_heads: int = 6, embed_dims: int = 384,
                 channels: int = 384,       # config-parity alias, unused
                 num_classes: int = 21, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.1, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, qkv_bias: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform, **kwargs)
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate   # changes no output (vit.py)
        self.drop_paths = [drop_path_rate * i / max(num_layers - 1, 1)
                           for i in range(num_layers)]
        self.dec_proj = nn.Linear(in_channels, embed_dims)
        self.cls_emb = nn.Parameter(torch.zeros(1, num_classes, embed_dims))
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dims, num_heads,
                                    mlp_ratio * embed_dims,
                                    qkv_bias=qkv_bias, use_flash=False)
            for _ in range(num_layers)])
        self.decoder_norm = nn.LayerNorm(embed_dims, eps=1e-5)
        self.patch_proj = nn.Linear(embed_dims, embed_dims, bias=False)
        self.classes_proj = nn.Linear(embed_dims, embed_dims, bias=False)
        self.mask_norm = nn.LayerNorm(num_classes, eps=1e-5)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the train forward's dropout and drop path."""
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        b, h, w, c = x.shape
        k = self.num_classes
        tokens = self.dec_proj(x.reshape(b, h * w, c))
        tokens = torch.cat([tokens, self.cls_emb.expand(b, -1, -1)], dim=1)
        for layer, drop_path in zip(self.layers, self.drop_paths):
            tokens = layer(tokens, None, self.drop_rate if train else 0.0,
                           drop_path if train else 0.0, generator)
        tokens = self.decoder_norm(tokens)
        patches = F.normalize(self.patch_proj(tokens[:, :-k]), dim=-1,
                              eps=1e-12)
        classes = F.normalize(self.classes_proj(tokens[:, -k:]), dim=-1,
                              eps=1e-12)
        masks = self.mask_norm(torch.einsum('bpd,bkd->bpk', patches,
                                            classes))
        return masks.reshape(b, h, w, k)


def _laplacian(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The 3x3 laplacian (8 in the centre, -1 around) at ``stride``,
    padding 1, on a [B, H, W, 1] float map (JAX l.212)."""
    kernel = torch.full((1, 1, 3, 3), -1.0, dtype=x.dtype, device=x.device)
    kernel[0, 0, 1, 1] = 8.0
    y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), kernel, stride=stride,
                 padding=1)
    return y.permute(0, 2, 3, 1)


def stdc_boundary_targets(seg_label: torch.Tensor,
                          boundary_threshold: float = 0.1) -> torch.Tensor:
    """STDC's detail-aggregation boundary target (JAX l.219; reference
    stdc_head.py:34-85): the laplacian's positive responses at strides 1,
    2 and 4, the coarse ones resized nearest to the label's size, each
    binarised at ``boundary_threshold``, fused by the fixed weights 0.6,
    0.3, 0.1 and binarised again. seg_label [B, H, W] int -> [B, H, W]
    f32 of 0 and 1. No step builds it: the JAX step trains ``STDCHead``
    with the 2-class cross-entropy on the segmentation labels."""
    lab = seg_label.float()[..., None]
    t1 = (_laplacian(lab, 1).clamp(min=0.0) > boundary_threshold).float()
    hw = tuple(t1.shape[1:3])
    t2, t4 = ((resize_nearest(_laplacian(lab, s).clamp(min=0.0), hw) >
               boundary_threshold).float() for s in (2, 4))
    fused = 0.6 * t1 + 0.3 * t2 + 0.1 * t4
    return (fused[..., 0] > boundary_threshold).float()


@HEADS.register_module()
class STDCHead(FCNHead):
    """STDC's detail head: an ``FCNHead`` (its keys, its forward) that
    holds ``boundary_threshold`` for ``stdc_boundary_targets``."""

    def __init__(self, boundary_threshold: float = 0.1, **kwargs):
        super().__init__(**kwargs)
        self.boundary_threshold = boundary_threshold
