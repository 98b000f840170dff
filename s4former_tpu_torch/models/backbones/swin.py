"""Swin Transformer backbone (counterpart of
``s4former_tpu/models/backbones/swin.py``; reference:
mmseg/models/backbones/swin.py).

NHWC in, a tuple of NHWC maps out (the stages of ``out_indices``, each
through its own LayerNorm ``norm{s}``). A 4x4 patch embed (``patch_embed.
projection``, with ``patch_norm`` its LayerNorm ``patch_embed.norm``),
then per stage ``depths[s]`` blocks (``stages.{s}.blocks.{i}``) and, but
after the last, a patch merging (``stages.{s}.downsample``) to half the
grid and twice the width.

A block (JAX ``SwinBlock``): ``norm1``; the tokens as a map, padded at the
bottom and right to window multiples; every second block of a stage
rolled back by half a window, with the -100 mask between the regions the
roll brought together; windowed attention (``attn.w_msa``: ``qkv``,
``proj`` and the relative-position table ``[(2 ws - 1)², heads]``,
indexed as JAX's ``_relative_position_index``); the windows put back,
rolled forward, unpadded; per-sample drop path; ``norm2`` and the exact
GELU MLP (``ffn.layers.0.0``, ``ffn.layers.1``), drop path again. The
window is ``min(window_size, h, w)``, and a block shifts only where that
is smaller than the grid (JAX l.97-98). Its heads are 32 wide, so the
attention runs plain, as JAX's does (kernel #1 takes 64).

The patch merging keeps the reference's 4C axis: mmseg's ``nn.Unfold``
orders it channel-major (c * 4 + 2 dy + dx), where JAX concatenates the
2x2 neighbours position-major; ``downsample.norm`` (LayerNorm) and the
bias-free ``downsample.reduction`` take that order, which JAX's
``convert_swin_backbone`` permutes into its own.

f32, as JAX's Swin (no ``dtype``); LayerNorms eps 1e-5. The semi keywords
are accepted and ignored, fdrop included (JAX swin.py:155-157);
``generator`` draws the drop path of a train forward.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.decode_heads.setr_up import conv_nhwc
from s4former_tpu_torch.models.dropout import drop_path
from s4former_tpu_torch.registry import BACKBONES


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * windows, ws * ws, C], windows raster-ordered."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int,
                            table_ws: Optional[int] = None) -> torch.Tensor:
    """[ws², ws²] rows of the relative-position table of a ``table_ws``
    window (default ``ws``): (dy + t - 1) * (2 t - 1) + dx + t - 1 for the
    query - key offsets (dy, dx) of a ``ws`` window. With ``table_ws`` = ws
    it is JAX's ``_relative_position_index``; a smaller ``ws`` reads the
    table's central (2 ws - 1)² offsets."""
    t = ws if table_ws is None else table_ws
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + \
        (t - 1)
    return rel[..., 0] * (2 * t - 1) + rel[..., 1]


def shift_mask(hp: int, wp: int, ws: int, shift: int,
               device) -> torch.Tensor:
    """[windows, ws², ws²]: -100 between tokens of a window that the roll
    brought from different regions, else 0 (JAX l.107-118)."""
    img = torch.zeros(1, hp, wp, 1, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss, :] = cnt
            cnt += 1
    mw = window_partition(img, ws)[..., 0]
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the relative-position
    bias (reference ``WindowMSA``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window_size),
                             persistent=False)

    def forward(self, x: torch.Tensor, ws: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` [B * windows, ws², C] at window ``ws``. A grid smaller
        than the window takes the grid as its window: JAX then makes a
        table of (2 ws - 1)² offsets for it; this one keeps the window's
        table (the reference layout) and reads its central offsets, the
        same relative positions (the bridge puts JAX's table there)."""
        bw, n, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-2, -1)) / d ** 0.5
        if ws == self.window_size:
            idx = self.relative_position_index
        else:
            idx = relative_position_index(ws, self.window_size).to(
                x.device)
        rpb = self.relative_position_bias_table[idx.reshape(-1)]
        attn = attn + rpb.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n) +
                    mask[None, :, None]).reshape(bw, h, n, n)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """(Shifted-)window attention and the MLP, each a pre-norm residual
    with drop path."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.0, qkv_bias: bool = True):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = nn.ModuleDict({'w_msa': WindowAttention(
            dim, num_heads, window_size, qkv_bias)})
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = nn.Module()
        self.ffn.layers = nn.ModuleList([
            nn.ModuleList([nn.Linear(dim, mlp_ratio * dim)]),
            nn.Linear(mlp_ratio * dim, dim)])

    def _drop(self, y: torch.Tensor, train: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if train and self.drop_path_rate > 0:
            return drop_path(y, self.drop_path_rate, generator)
        return y

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h, w = hw
        ws = min(self.window_size, h, w)
        shift = self.shift if ws < min(h, w) else 0
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(hp, wp, ws, shift, y.device)
        y = self.attn['w_msa'](window_partition(y, ws), ws, mask)
        y = window_reverse(y, ws, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        y = y[:, :h, :w].reshape(b, l, c)
        x = x + self._drop(y, train, generator)
        (fc1,), fc2 = self.ffn.layers
        z = fc2(F.gelu(fc1(self.norm2(x))))
        return x + self._drop(z, train, generator)


class PatchMerging(nn.Module):
    """2x2 neighbours to 4C channels in the reference's channel-major
    order, LayerNorm, a bias-free linear to 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, tokens: torch.Tensor,
                hw: Tuple[int, int]) -> torch.Tensor:
        b, _, c = tokens.shape
        h, w = hw
        t = tokens.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2,
                                                              4)
        t = t.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(t))


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin (reference layout), NHWC, f32."""

    def __init__(self, pretrain_img_size: int = 224, in_channels: int = 3,
                 embed_dims: int = 96, patch_size: int = 4,
                 window_size: int = 7, mlp_ratio: int = 4,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 # config keys accepted for parity; no effect (as JAX)
                 strides: Optional[Sequence[int]] = None,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 patch_norm: bool = True, norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None, with_cp: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Module()
        self.patch_embed.projection = nn.Conv2d(in_channels, embed_dims,
                                                patch_size, patch_size)
        if patch_norm:
            self.patch_embed.norm = nn.LayerNorm(embed_dims, eps=1e-5)
        # stochastic depth rising linearly over the whole stack
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1)
                 for i in range(total)]
        self.stages = nn.ModuleList()
        dim, cur = embed_dims, 0
        for s, depth in enumerate(depths):
            stage = nn.Module()
            stage.blocks = nn.ModuleList([
                SwinBlock(dim, num_heads[s], window_size,
                          0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                          rates[cur + i], qkv_bias) for i in range(depth)])
            stage.downsample = PatchMerging(dim) \
                if s < len(depths) - 1 else None
            self.stages.append(stage)
            if s in self.out_indices:
                self.add_module(f'norm{s}', nn.LayerNorm(dim, eps=1e-5))
            cur += depth
            dim *= 2

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default', use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """Tuple of the ``out_indices`` stages' maps [, ([], None)]."""
        x = conv_nhwc(x.float(), self.patch_embed.projection, torch.float32)
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        norm = getattr(self.patch_embed, 'norm', None)
        if norm is not None:
            tokens = norm(tokens)
        outs = []
        hw = (h, w)
        for s, stage in enumerate(self.stages):
            for block in stage.blocks:
                tokens = block(tokens, hw, train, generator)
            if s in self.out_indices:
                normed = getattr(self, f'norm{s}')(tokens)
                outs.append(normed.reshape(b, hw[0], hw[1], -1))
            if stage.downsample is not None:
                tokens = stage.downsample(tokens, hw)
                hw = (hw[0] // 2, hw[1] // 2)
        if return_attn:
            return tuple(outs), ([], None)
        return tuple(outs)
