"""MixVisionTransformer (SegFormer MiT) backbone (counterpart of
``s4former_tpu/models/backbones/mit.py``; reference:
mmseg/models/backbones/mit.py).

- 4 stages of [overlapping patch embed -> N x (efficient attention +
  MixFFN) -> LayerNorm]. Efficient attention reduces K/V spatially by
  ``sr_ratio`` (a conv with kernel = stride = sr, then a LayerNorm).
- Layout as in the JAX package: images and feature maps NHWC, tokens
  [B, L, C]. Parameter names are the mmseg layout that JAX
  ``convert_mit_backbone`` reads (``layers.{s}.0.projection/norm``,
  ``layers.{s}.1.{i}.norm1/norm2``, ``attn.attn.in_proj_*`` with the q rows
  first and the kv rows after, ``attn.attn.out_proj``, ``attn.sr``,
  ``attn.norm``, ``ffn.layers.{0,1,4}`` as conv weights, ``layers.{s}.2``),
  so ``state_dict()`` is an mmseg checkpoint's.
- Mixed precision as in flax: parameters f32, matmuls and convs in
  ``dtype``; the LayerNorms (eps 1e-6) compute and return f32, so the
  residual stream and the stage outputs are f32 as in the JAX module.
- Attention is the plain ``ops.attention.dot_product_attention`` (f32
  logits and softmax), as the JAX MiT calls its XLA attention; no flash
  kernel runs here.
- PASA: ``attn_bias`` is the raw per-pixel unconfidence map [B, H, W] at
  input resolution. Each stage with ``sr_ratio == 1`` mean-pools it to its
  own token grid and builds its bias with ``semi.pasa.mit_stage_bias``
  (``attn_mask_weight``, ``adaptive_attn_mask``); the other stages take no
  bias.
- Drop path (``drop_path_rate``, linear over the blocks) runs in train mode
  only: a per-sample keep mask [B, 1, 1] drawn from the caller's
  ``torch.Generator``, kept values scaled by 1/keep. ``drop_rate`` and
  ``attn_drop_rate`` are accepted and unused, as in the JAX module;
  ``with_cp`` (activation checkpointing) is accepted and unused too.
  ``use_fdrop`` is not ported and raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.vit import (_MHAProjections,
                                                     layer_norm, linear)
from s4former_tpu_torch.models.decode_heads.setr_up import conv_nhwc
from s4former_tpu_torch.ops.attention import dot_product_attention
from s4former_tpu_torch.registry import BACKBONES
from s4former_tpu_torch.semi.pasa import mit_stage_bias

Grid = Tuple[int, int]


def drop_path(y: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth: each sample's ``y`` is kept with
    probability 1 - rate (scaled by 1/keep) or zeroed."""
    if generator is None:
        raise ValueError('drop path in train mode draws from a '
                         'torch.Generator; pass generator=')
    keep = 1.0 - rate
    mask = torch.rand((y.shape[0],) + (1,) * (y.dim() - 1),
                      generator=generator, device=y.device) < keep
    return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))


class EfficientAttention(nn.Module):
    """Multi-head attention with the K/V grid reduced by ``sr_ratio``
    (reference key layout ``attn.attn.*``, ``attn.sr``, ``attn.norm``)."""

    def __init__(self, embed_dims: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.dtype = dtype
        self.attn = _MHAProjections(embed_dims)
        if not qkv_bias:
            self.attn.in_proj_bias = None
        if sr_ratio > 1:
            self.sr = nn.Conv2d(embed_dims, embed_dims, sr_ratio,
                                stride=sr_ratio)
            self.norm = nn.LayerNorm(embed_dims, eps=1e-6)

    def forward(self, x: torch.Tensor, hw: Grid,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, c = x.shape
        h = self.num_heads
        w, bias = self.attn.in_proj_weight, self.attn.in_proj_bias
        q = linear(x, w[:c], None if bias is None else bias[:c], self.dtype)
        kv_in = x
        if self.sr_ratio > 1:
            xs = conv_nhwc(x.reshape(b, hw[0], hw[1], c), self.sr,
                           self.dtype)
            kv_in = layer_norm(xs.reshape(b, -1, c), self.norm,
                               torch.float32)
        kv = linear(kv_in, w[c:], None if bias is None else bias[c:],
                    self.dtype)
        lk = kv.shape[1]
        k, v = (t.reshape(b, lk, h, c // h) for t in kv.split(c, dim=-1))
        out, _ = dot_product_attention(
            q.reshape(b, l, h, c // h), k, v,
            attn_bias if self.sr_ratio == 1 else None)
        proj = self.attn.out_proj
        return linear(out.reshape(b, l, c), proj.weight, proj.bias,
                      self.dtype)


class MixFFN(nn.Module):
    """fc1 (1x1 conv) -> depthwise 3x3 conv -> exact GELU -> fc2 (1x1 conv),
    under the reference's Sequential indices ``layers.{0,1,4}`` (2 and 3
    are its activation and dropout, which hold no parameters)."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        hidden = feedforward_channels
        self.layers = nn.ModuleList([
            nn.Conv2d(embed_dims, hidden, 1),
            nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
            nn.Identity(), nn.Identity(),
            nn.Conv2d(hidden, embed_dims, 1)])

    def forward(self, x: torch.Tensor, hw: Grid) -> torch.Tensor:
        b, l, _ = x.shape
        fc1, dw, fc2 = self.layers[0], self.layers[1], self.layers[4]
        y = linear(x, fc1.weight.flatten(1), fc1.bias, self.dtype)
        hidden = y.shape[-1]
        y = conv_nhwc(y.reshape(b, hw[0], hw[1], hidden), dw, self.dtype)
        y = F.gelu(y.reshape(b, l, hidden), approximate='none')
        return linear(y, fc2.weight.flatten(1), fc2.bias, self.dtype)


class MiTBlock(nn.Module):
    """x += drop_path(attn(LN(x), bias)); x += drop_path(ffn(LN(x)))."""

    def __init__(self, embed_dims: int, num_heads: int, mlp_ratio: int,
                 sr_ratio: int, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-6)
        self.attn = EfficientAttention(embed_dims, num_heads, sr_ratio,
                                       qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-6)
        self.ffn = MixFFN(embed_dims, mlp_ratio * embed_dims, dtype)

    def forward(self, x: torch.Tensor, hw: Grid,
                attn_bias: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        def residual(y):
            if train and self.drop_path_rate > 0:
                return drop_path(y, self.drop_path_rate, generator)
            return y
        x = x + residual(self.attn(layer_norm(x, self.norm1, torch.float32),
                                   hw, attn_bias))
        return x + residual(self.ffn(layer_norm(x, self.norm2,
                                                torch.float32), hw))


class OverlapPatchEmbed(nn.Module):
    """k x k conv, stride s, padding k // 2 on every side, then LayerNorm
    (reference key ``layers.{s}.0.projection`` and ``.norm``)."""

    def __init__(self, in_channels: int, embed_dims: int, kernel: int,
                 stride: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.projection = nn.Conv2d(in_channels, embed_dims, kernel,
                                    stride=stride, padding=kernel // 2)
        self.norm = nn.LayerNorm(embed_dims, eps=1e-6)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Grid]:
        """x [B, H, W, Cin] -> (f32 tokens [B, h*w, C], (h, w))."""
        y = conv_nhwc(x, self.projection, self.dtype)
        b, hh, ww, c = y.shape
        return layer_norm(y.reshape(b, hh * ww, c), self.norm,
                          torch.float32), (hh, ww)


@BACKBONES.register_module()
class MixVisionTransformer(nn.Module):
    """4-stage MiT; returns the NHWC feature maps at ``out_indices``."""

    def __init__(self,
                 in_channels: int = 3,
                 embed_dims: int = 64,
                 num_stages: int = 4,
                 num_layers: Sequence[int] = (3, 4, 6, 3),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 mlp_ratio: int = 4,
                 qkv_bias: bool = True,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 attn_mask_weight: float = 1.0,
                 adaptive_attn_mask: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 with_cp: bool = False):
        super().__init__()
        self.num_stages = num_stages
        self.sr_ratios = tuple(sr_ratios)
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.attn_mask_weight = attn_mask_weight
        self.adaptive_attn_mask = adaptive_attn_mask
        # stage widths embed_dims x (1, 2, 5, 8), as the JAX module has them
        dims = [embed_dims * m for m in (1, 2, 5, 8)][:num_stages]
        total = sum(num_layers[:num_stages])
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        cur, cin = 0, in_channels
        for s in range(num_stages):
            blocks = nn.ModuleList([
                MiTBlock(dims[s], num_heads[s], mlp_ratio, sr_ratios[s],
                         qkv_bias, dpr[cur + i], dtype)
                for i in range(num_layers[s])])
            self.layers.append(nn.ModuleList([
                OverlapPatchEmbed(cin, dims[s], patch_sizes[s], strides[s],
                                  dtype),
                blocks, nn.LayerNorm(dims[s], eps=1e-6)]))
            cur += num_layers[s]
            cin = dims[s]

    def stage_bias(self, unconf_map: torch.Tensor,
                   hw: Grid) -> torch.Tensor:
        """The raw [B, H, W] unconfidence map mean-pooled to the stage grid
        ``hw``, as a [B, 1, L, L] bias."""
        b, h, w = unconf_map.shape
        ph, pw = h // hw[0], w // hw[1]
        vec = unconf_map.float().reshape(b, hw[0], ph, hw[1], pw).mean(
            dim=(2, 4)).reshape(b, hw[0] * hw[1])
        return mit_stage_bias(vec, self.attn_mask_weight,
                              self.adaptive_attn_mask)

    def forward(self, x: torch.Tensor, *,
                train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default',
                use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x`` [B, H, W, 3]; ``attn_bias`` the raw PASA unconfidence map
        [B, H, W] or None. ``pos_mode`` means nothing here (the MiT has no
        position embedding). With ``return_attn`` the JAX module's
        ``(outs, ([], None))``: the MiT exposes no attention maps."""
        del pos_mode
        if use_fdrop:
            raise NotImplementedError('use_fdrop is not ported')
        outs = []
        for s, (embed, blocks, norm) in enumerate(self.layers):
            tokens, hw = embed(x)
            bias = None
            if attn_bias is not None and self.sr_ratios[s] == 1:
                bias = self.stage_bias(attn_bias.detach(), hw)
            for block in blocks:
                tokens = block(tokens, hw, bias, train, generator)
            tokens = layer_norm(tokens, norm, torch.float32)
            x = tokens.reshape(tokens.shape[0], hw[0], hw[1], -1)
            if s in self.out_indices:
                outs.append(x)
        if return_attn:
            return tuple(outs), ([], None)
        return tuple(outs)
