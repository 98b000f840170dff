"""Necks (counterpart of ``s4former_tpu/models/necks/necks.py``; reference:
mmseg/models/necks/mla_neck.py).

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
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from s4former_tpu_torch.models.backbones.vit import layer_norm
from s4former_tpu_torch.models.decode_heads.setr_up import conv_nhwc
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
