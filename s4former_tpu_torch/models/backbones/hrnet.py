"""HRNet backbone (counterpart of ``s4former_tpu/models/backbones/hrnet.py``;
reference: mmseg/models/backbones/hrnet.py).

NHWC in, the branches' maps out (1/4, 1/8, 1/16, 1/32 for four branches),
f32 (JAX's HRNet has no ``dtype``). In JAX's order:

- the stem: two 3x3 stride-2 conv-BN-ReLUs (``conv1``/``bn1``,
  ``conv2``/``bn2``);
- ``layer1``: ``stage1``'s blocks (ResNet's ``Bottleneck`` for HRNet-W18),
  the first with a shortcut where the width changes;
- before stages 2-4 the transition (``transition{t}``): a branch that
  stays keeps its map (``None`` in the reference's list) or, where its
  width changes, takes a 3x3 conv-BN-ReLU (``.{i}.0``/``.1``); a new
  branch chains stride-2 3x3 conv-BN-ReLUs from the last branch
  (``.{i}.{j}.0``/``.1``), the last to the new width;
- each stage's ``num_modules`` HR modules (``stage{s}.{m}``): every
  branch through its blocks (``branches.{b}.{k}``), then the fusion
  (``fuse_layers.{i}.{j}``): branch i's own map plus, for each j > i, a
  1x1 conv-BN of branch j resized bilinearly (``align_corners=False``) to
  branch i's size, and for j < i a chain of i - j stride-2 3x3 conv-BNs
  (``.{k}.0``/``.1``), ReLU on all but the last, summed in j's order;
  ReLU on the sum. With ``multiscale_output=False`` the last module fuses
  only branch 0.

The semi keywords are accepted and ignored, fdrop included, as JAX's
(the configs' PASA bias is built and ignored). ``norm_cfg``,
``conv_cfg``, ``norm_eval``, ``frozen_stages``, ``zero_init_residual``,
``with_cp``, ``init_cfg`` and ``pretrained`` change nothing, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.resnet import (BasicBlock,
                                                        Bottleneck, _conv)
from s4former_tpu_torch.models.decode_heads.setr_up import BatchNorm, conv_bn
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import BACKBONES

_BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}

# HRNet-W18 (configs/_base_/models/ocrnet_hr18.py; JAX hrnet.py:47-56)
DEFAULT_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(4, 4), num_channels=(18, 36)),
    stage3=dict(num_modules=4, num_branches=3, block='BASIC',
                num_blocks=(4, 4, 4), num_channels=(18, 36, 72)),
    stage4=dict(num_modules=3, num_branches=4, block='BASIC',
                num_blocks=(4, 4, 4, 4), num_channels=(18, 36, 72, 144)),
)


class ConvBN(nn.Module):
    """A bias-free conv (``0``) and its BN (``1``): an element of the
    reference's ``Sequential``s."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.add_module('0', _conv(in_channels, out_channels, kernel,
                                   stride))
        self.add_module('1', BatchNorm(out_channels))

    def forward(self, x: torch.Tensor, train: bool,
                relu: bool = True) -> torch.Tensor:
        return conv_bn(x, getattr(self, '0'), getattr(self, '1'), train,
                       relu)


def _blocks(block_cls, in_channels: int, planes: int, n: int) -> nn.ModuleList:
    """``n`` stride-1 blocks; the first with a shortcut where the width
    changes (JAX ``_branch``)."""
    out = []
    for k in range(n):
        out.append(block_cls(in_channels, planes, 1, 1,
                             downsample=in_channels !=
                             planes * block_cls.expansion))
        in_channels = planes * block_cls.expansion
    return nn.ModuleList(out)


def _run(blocks: nn.ModuleList, x: torch.Tensor, train: bool):
    for block in blocks:
        x = block(x, train)
    return x


class HRModule(nn.Module):
    """Branches, then the cross-resolution fusion of the first ``n_out``
    branches."""

    def __init__(self, block_cls, channels: List[int], num_blocks,
                 out_channels: List[int], n_out: int):
        super().__init__()
        self.branches = nn.ModuleList([
            _blocks(block_cls, channels[b], out_channels[b] //
                    block_cls.expansion, num_blocks[b])
            for b in range(len(channels))])
        n = len(channels)
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList()
            for i in range(n_out):
                row = nn.ModuleList()
                for j in range(n):
                    if j > i:
                        row.append(ConvBN(out_channels[j], out_channels[i], 1))
                    elif j == i:
                        row.append(None)
                    else:
                        row.append(nn.ModuleList([
                            ConvBN(out_channels[j], out_channels[i]
                                   if k == i - j - 1 else out_channels[j],
                                   3, 2) for k in range(i - j)]))
                self.fuse_layers.append(row)

    def forward(self, xs: List[torch.Tensor], train: bool
                ) -> List[torch.Tensor]:
        xs = [_run(branch, x, train) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = xs[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                if j > i:
                    y = resize_bilinear(layer(xs[j], train, relu=False),
                                        tuple(xs[i].shape[1:3]), False)
                else:
                    y = xs[j]
                    for k, conv in enumerate(layer):
                        y = conv(y, train, relu=k < len(layer) - 1)
                acc = acc + y
            fused.append(F.relu(acc))
        return fused


@BACKBONES.register_module()
class HRNet(nn.Module):
    """High-resolution network (reference layout), NHWC, f32."""

    def __init__(self, extra: Optional[Dict[str, Any]] = None,
                 in_channels: int = 3, multiscale_output: bool = True,
                 # config keys accepted for parity; no effect (as JAX)
                 norm_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None, norm_eval: bool = False,
                 frozen_stages: int = -1, zero_init_residual: bool = False,
                 with_cp: bool = False, init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        extra = {k: dict(v) for k, v in (extra or DEFAULT_EXTRA).items()}
        self.conv1 = _conv(in_channels, 64, 3, 2)
        self.bn1 = BatchNorm(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = BatchNorm(64)
        s1 = extra['stage1']
        block_cls = _BLOCKS[s1.get('block', 'BOTTLENECK')]
        self.layer1 = _blocks(block_cls, 64, s1['num_channels'][0],
                              s1['num_blocks'][0])
        prev = [s1['num_channels'][0] * block_cls.expansion]
        for stage_i in (2, 3, 4):
            cfg = extra[f'stage{stage_i}']
            block_cls = _BLOCKS[cfg.get('block', 'BASIC')]
            out_ch = [c * block_cls.expansion for c in cfg['num_channels']]
            transition = nn.ModuleList()
            for i, c in enumerate(out_ch):
                if i < len(prev):
                    transition.append(ConvBN(prev[i], c, 3)
                                      if prev[i] != c else None)
                else:
                    n_new = i + 1 - len(prev)
                    transition.append(nn.ModuleList([
                        ConvBN(prev[-1], c if j == n_new - 1 else prev[-1],
                               3, 2) for j in range(n_new)]))
            self.add_module(f'transition{stage_i - 1}', transition)
            modules = []
            for m in range(cfg['num_modules']):
                last = (stage_i == 4 and not multiscale_output and
                        m == cfg['num_modules'] - 1)
                modules.append(HRModule(
                    block_cls, out_ch, cfg['num_blocks'], out_ch,
                    1 if last else len(out_ch)))
            self.add_module(f'stage{stage_i}', nn.ModuleList(modules))
            prev = out_ch

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """Tuple of the branches' maps [, ([], None)]."""
        x = conv_bn(x.float(), self.conv1, self.bn1, train)
        x = conv_bn(x, self.conv2, self.bn2, train)
        xs = [_run(self.layer1, x, train)]
        for stage_i in (2, 3, 4):
            new_xs = []
            for i, t in enumerate(getattr(self, f'transition{stage_i - 1}')):
                if i < len(xs):
                    new_xs.append(xs[i] if t is None else t(xs[i], train))
                else:
                    y = xs[-1]
                    for conv in t:
                        y = conv(y, train)
                    new_xs.append(y)
            xs = new_xs
            for module in getattr(self, f'stage{stage_i}'):
                xs = module(xs, train)
        if return_attn:
            return tuple(xs), ([], None)
        return tuple(xs)
