"""SegFormer decode head (counterpart of
``s4former_tpu/models/decode_heads/segformer.py``; reference:
mmseg/models/decode_heads/segformer_head.py).

Per level: [PatchShuffle undo on the level's own grid] -> 1x1 conv (no
bias) + BN + ReLU -> bilinear resize to the finest grid; then concat in
``in_index`` order -> 1x1 ``fusion_conv`` + BN + ReLU -> dropout ->
``conv_seg``, on NHWC maps. Parameter names follow the reference layout
(``convs.{i}.conv/bn``, ``fusion_conv.conv/bn``, ``conv_seg``).

- The BN is the SETR head's: statistics in f32, running statistics updated
  in train mode as flax does (momentum 0.9, biased variance).
- Dropout is element-wise, as the JAX head's flax ``nn.Dropout`` (not
  mmseg's ``Dropout2d``), in train mode only, drawn from the caller's
  ``torch.Generator``.
- PatchShuffle: the permutation [B, G*G] has G*G super-patches; a level
  whose grid side g is a multiple of G is un-shuffled with g // G tokens a
  super-patch side (JAX segformer.py:55-72).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.decode_heads.base import unshuffle_feature_map
from s4former_tpu_torch.models.decode_heads.setr_up import ConvBNReLU
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import HEADS


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout: each value kept with probability 1 - rate
    (scaled by 1/keep) or zeroed."""
    if generator is None:
        raise ValueError('dropout in train mode draws from a '
                         'torch.Generator; pass generator=')
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def conv1x1(x: torch.Tensor, conv: nn.Conv2d,
            dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv on an NHWC map as the matmul it is (flax ``Dense``)."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.linear(x.to(dtype), conv.weight.flatten(1).to(dtype), b)


@HEADS.register_module()
class SegformerHead(nn.Module):
    """All-MLP SegFormer head over the multi-level MiT features."""

    def __init__(self,
                 in_channels: Sequence[int] = (64, 128, 320, 512),
                 channels: int = 256,
                 num_classes: int = 19,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 input_transform: str = 'multiple_select',
                 dropout_ratio: float = 0.1,
                 align_corners: bool = False,
                 interpolate_mode: str = 'bilinear',
                 dtype: torch.dtype = torch.float32,
                 # config keys accepted for parity and consumed elsewhere
                 loss_decode: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[Union[dict, list]] = None,
                 sampler: Optional[dict] = None,
                 ignore_index: int = 255,
                 vit_patch: int = 16):
        super().__init__()
        if interpolate_mode != 'bilinear':
            raise NotImplementedError(
                f'SegformerHead interpolate_mode {interpolate_mode!r}')
        self.loss_decode = loss_decode   # read by the train step
        self.num_classes = num_classes
        self.in_index = tuple(in_index)
        self.dropout_ratio = dropout_ratio
        self.align_corners = align_corners
        self.dtype = dtype
        self.convs = nn.ModuleList([ConvBNReLU(c, channels, 1, dtype)
                                    for c in in_channels])
        self.fusion_conv = ConvBNReLU(channels * len(in_channels), channels,
                                      1, dtype)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits [B, h0, w0, classes] at the finest level's grid."""
        feats = [inputs[i] for i in self.in_index]
        target_hw = tuple(feats[0].shape[1:3])
        outs = []
        for f, block in zip(feats, self.convs):
            if patchmix_perm is not None and patchmix_n:
                g = f.shape[1]
                num_super = int(round(float(patchmix_perm.shape[-1]) ** 0.5))
                if g >= num_super and g % num_super == 0:
                    f = unshuffle_feature_map(f, patchmix_perm,
                                              g // num_super)
            y = F.relu(block.bn(conv1x1(f, block.conv, self.dtype), train))
            if tuple(y.shape[1:3]) != target_hw:
                y = resize_bilinear(y, target_hw, self.align_corners)
            outs.append(y)
        fusion = self.fusion_conv
        x = F.relu(fusion.bn(conv1x1(torch.cat(outs, dim=-1), fusion.conv,
                                     self.dtype), train))
        if train and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        return conv1x1(x, self.conv_seg, self.dtype)
