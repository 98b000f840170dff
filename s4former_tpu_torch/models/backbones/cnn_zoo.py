"""CNN backbones of the zoo beyond the ResNets (counterpart of
``s4former_tpu/models/backbones/cnn_zoo.py``; reference:
mmseg/models/backbones/icnet.py). For now: ICNet (JAX l.928).

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
from torch import nn

from s4former_tpu_torch.models.decode_heads.setr_up import ConvBNReLU
from s4former_tpu_torch.models.decode_heads.zoo_heads import PooledConv
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import BACKBONES


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
