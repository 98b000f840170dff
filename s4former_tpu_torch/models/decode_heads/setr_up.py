"""SETR-PUP decode head (counterpart of
``s4former_tpu/models/decode_heads/setr_up.py``; reference:
mmseg/models/decode_heads/setr_up_head.py).

[PatchShuffle undo on tokens] -> LayerNorm -> num_convs x [3x3 conv + BN +
ReLU + bilinear up] -> 1x1 classifier, on NHWC maps. Parameter names follow
the reference layout (``norm``, ``up_convs.{i}.0.conv``,
``up_convs.{i}.0.bn``, ``conv_seg``).

BN (eps 1e-5, statistics in f32) runs with its running statistics in eval
mode and with the batch's in train mode, where it updates the running
statistics as flax does: ``running = 0.9 running + 0.1 batch`` with the
BIASED batch variance (``F.batch_norm`` would use the unbiased one). The
JAX head's ``dropout_ratio`` > 0 is not ported and raises in train mode.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.vit import layer_norm
from s4former_tpu_torch.models.decode_heads.base import (
    transform_inputs, unshuffle_feature_map)
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import HEADS


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d,
              dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=...)`` on an NHWC map: the NCHW view keeps the
    channels-last strides, so no copy is made around the conv."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), b,
                 stride=conv.stride, padding=conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis, statistics in f32, output in
    the input dtype. Holds exactly the reference's four tensors (``weight``,
    ``bias``, ``running_mean``, ``running_var``)."""

    MOMENTUM = 0.9     # flax convention (torch's 0.1): weight of the old

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return (x.float() * scale + shift).to(x.dtype)
        # flax BatchNorm: mean and E[x^2] in f32 over every axis but the
        # last, var = E[x^2] - mean^2 (biased), clipped at 0
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(
                mean.detach() * (1.0 - self.MOMENTUM))
            self.running_var.mul_(self.MOMENTUM).add_(
                var.detach() * (1.0 - self.MOMENTUM))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.bn(conv_nhwc(x, self.conv, self.dtype), train))


@HEADS.register_module()
class SETRUPHead(nn.Module):
    """Progressive/naive upsampling SETR head."""

    def __init__(self,
                 in_channels: int = 768,
                 channels: int = 256,
                 num_classes: int = 21,
                 num_convs: int = 1,
                 up_scale: int = 4,
                 kernel_size: int = 3,
                 in_index: Union[int, Sequence[int]] = 3,
                 input_transform: Optional[str] = None,
                 dropout_ratio: float = 0.0,
                 align_corners: bool = False,
                 norm_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 # config keys accepted for parity and consumed elsewhere
                 loss_decode: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[Union[dict, list]] = None):
        super().__init__()
        self.loss_decode = loss_decode   # read by the train step
        self.dropout_ratio = dropout_ratio
        self.num_classes = num_classes
        self.num_convs = num_convs
        self.up_scale = up_scale
        self.in_index = in_index
        self.input_transform = input_transform
        self.align_corners = align_corners
        self.dtype = dtype
        self.norm = nn.LayerNorm(in_channels, eps=norm_eps)
        self.up_convs = nn.ModuleList([
            nn.ModuleList([ConvBNReLU(in_channels if i == 0 else channels,
                                      channels, kernel_size, dtype)])
            for i in range(num_convs)])
        self.conv_seg = nn.Conv2d(channels if num_convs else in_channels,
                                  num_classes, 1)

    def _upsample(self, x: torch.Tensor, factor: int) -> torch.Tensor:
        return resize_bilinear(x, (x.shape[1] * factor, x.shape[2] * factor),
                               self.align_corners)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``patchmix_perm`` [B, G*G] with ``patchmix_n`` > 0 undoes a
        PatchShuffle on the token grid before the LayerNorm
        (setr_up.py:84-90). ``generator`` is unused (no dropout)."""
        if train and self.dropout_ratio > 0:
            raise NotImplementedError('SETRUPHead dropout_ratio > 0 in train '
                                      'mode is not ported')
        x = transform_inputs(inputs, self.in_index, self.input_transform,
                             self.align_corners) \
            if isinstance(inputs, (list, tuple)) else inputs
        if patchmix_perm is not None and patchmix_n:
            x = unshuffle_feature_map(x, patchmix_perm, patchmix_n)
        x = layer_norm(x, self.norm, self.dtype)
        # the 1x1 classifier commutes with the last bilinear upsample (its
        # 2-tap rows sum to 1), so it runs first and the upsample moves
        # num_classes channels instead of `channels` (setr_up.py:92-132)
        for i, (block,) in enumerate(self.up_convs):
            x = block(x, train)
            if i < self.num_convs - 1:
                x = self._upsample(x, self.up_scale)
        logits = conv_nhwc(x, self.conv_seg, self.dtype)
        if self.num_convs:
            logits = self._upsample(logits, self.up_scale)
        return logits
