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
batch is the global one: under data parallelism the sums of x and x² are
all-reduced (SyncBN, the configs' ``norm_cfg=dict(type='SyncBN')``), so
the moments, the running statistics and the gradients are those of the
single-process step on the global batch.

``dropout_ratio`` > 0: element-wise dropout (flax ``nn.Dropout``, from the
caller's ``torch.Generator``) on the last feature map in train mode. The
1x1 classifier commutes with the last bilinear upsample, so with no
dropout it runs first and the upsample moves ``num_classes`` channels;
with dropout, whatever the mode, the head takes JAX's order
(setr_up.py:100-118): upsample the ``channels``-wide map, drop, classify.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.vit import layer_norm
from s4former_tpu_torch.models.decode_heads.base import (
    transform_inputs, unshuffle_feature_map)
from s4former_tpu_torch.models.dropout import dropout
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.parallel.distributed import data_size
from s4former_tpu_torch.parallel.mesh import global_sum
from s4former_tpu_torch.registry import HEADS


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d,
              dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=...)`` on an NHWC map: on the card the NCHW view
    keeps the channels-last strides, so no copy is made around the conv.
    On the CPU the view is copied to NCHW first: PyTorch's CPU kernels for
    channels-last convolutions have crashed (SIGSEGV in the backward of a
    stride-2 1x1 conv from 8 to 16 channels on a batch of 3 or more) and
    returned a weight gradient far from the NCHW convolution's in builds
    this port is tested on."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    xin = x.permute(0, 3, 1, 2).to(dtype)
    if xin.device.type == 'cpu':
        xin = xin.contiguous()
    y = F.conv2d(xin, conv.weight.to(dtype), b,
                 stride=conv.stride, padding=conv.padding,
                 dilation=conv.dilation, groups=conv.groups)
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
        # last (and every rank), var = E[x^2] - mean^2 (biased), clipped
        # at 0
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        sums = global_sum(torch.stack([xf.sum(dim=dims),
                                       (xf * xf).sum(dim=dims)]))
        n = xf.numel() // xf.shape[-1] * data_size()
        mean = sums[0] / n
        var = (sums[1] / n - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(
                mean.detach() * (1.0 - self.MOMENTUM))
            self.running_var.mul_(self.MOMENTUM).add_(
                var.detach() * (1.0 - self.MOMENTUM))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: BatchNorm, train: bool,
            relu: bool = True,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Conv (``conv_nhwc`` in ``dtype``), BN, ReLU unless ``relu=False``:
    ``ConvBNReLU``'s forward, and JAX's ResNet ``ConvBN`` (f32), whose
    pair the reference keeps as two attributes of its block (``conv1``,
    ``bn1``)."""
    y = bn(conv_nhwc(x, conv, dtype), train)
    return F.relu(y) if relu else y


class ConvBNReLU(nn.Module):
    """Bias-free conv, BN, ReLU (mmcv ``ConvModule``; reference keys
    ``conv``, ``bn``), 'same' padding at any ``dilation``, any ``stride``
    and ``groups``; ``relu=False`` stops after the BN."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32,
                 dilation: int = 1, stride: int = 1, groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride,
                              padding=dilation * (kernel_size - 1) // 2,
                              dilation=dilation, groups=groups, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                relu: bool = True) -> torch.Tensor:
        return conv_bn(x, self.conv, self.bn, train, relu, self.dtype)


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
                 init_cfg: Optional[Union[dict, list]] = None,
                 use_addition_up_scale: bool = False):
        super().__init__()
        self.loss_decode = loss_decode   # read by the train step
        self.use_addition_up_scale = use_addition_up_scale
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
        (setr_up.py:84-90). ``generator`` draws the train forward's
        dropout."""
        x = transform_inputs(inputs, self.in_index, self.input_transform,
                             self.align_corners) \
            if isinstance(inputs, (list, tuple)) else inputs
        if patchmix_perm is not None and patchmix_n:
            x = unshuffle_feature_map(x, patchmix_perm, patchmix_n)
        x = layer_norm(x, self.norm, self.dtype)
        defer_last_up = self.num_convs > 0 and self.dropout_ratio == 0
        # use_addition_up_scale: one more x2 resize after each up conv's,
        # the deferred last one at twice the scale (JAX setr_up.py:102-114)
        extra = 2 if self.use_addition_up_scale else 1
        for i, (block,) in enumerate(self.up_convs):
            x = block(x, train)
            if not (defer_last_up and i == self.num_convs - 1):
                x = self._upsample(x, self.up_scale)
                if self.use_addition_up_scale:
                    x = self._upsample(x, 2)
        if train and self.dropout_ratio > 0:
            x = dropout(x, self.dropout_ratio, generator)
        logits = conv_nhwc(x, self.conv_seg, self.dtype)
        if defer_last_up:
            logits = self._upsample(logits, self.up_scale * extra)
        return logits
