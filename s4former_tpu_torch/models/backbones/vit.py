"""DeiT/ViT backbone (counterpart of
``s4former_tpu/models/backbones/vit.py``; reference:
mmseg/models/backbones/vit.py:187-569).

- Public layout follows the JAX package: images NHWC, tokens [B, L, C],
  feature maps NHWC. Parameter names follow the reference (mmseg) layout, so
  ``state_dict()`` keys are those of an mmseg/S4Former checkpoint
  (``layers.{i}.attn.attn.in_proj_weight``, ``ffn.layers.0.0.weight``, ...).
- Mixed precision as in flax: parameters are stored f32; matmuls and convs
  run in ``dtype``; LayerNorm statistics are taken in f32.
- Attention runs through ``ops.attention.multi_head_attention``: the CUDA
  flash kernels on the card (forward, and in training the backward), their
  plain versions on the CPU. The kernels take head dim 64, that of every ViT
  config in ``configs/``.
- The 12 layers are a Python loop over ``nn.Module``s (the JAX package
  scans stacked parameters); the ``out_indices`` taps read the loop.
- ``train=True`` is the training forward. With the flagship's zero rates
  it computes what eval mode computes; dropout, drop-path and fdrop are not
  ported, so a nonzero ``drop_rate``, ``attn_drop_rate`` or
  ``drop_path_rate`` raises in train mode (in eval mode they are
  identities, as in the JAX package), and ``use_fdrop`` raises in either
  mode. ``scan_unroll`` is a JAX
  compile option the flagship config sets; it is accepted and means
  nothing here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.ops.attention import (dot_product_attention,
                                              multi_head_attention)
from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import BACKBONES


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics and affine in f32, output in
    the compute dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and f32 parameters cast to dtype."""
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


class _MHAProjections(nn.Module):
    """Parameter holder in torch ``nn.MultiheadAttention``'s names
    (``in_proj_weight`` [3C, C], ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv self-attention (reference key layout ``attn.attn.*``)."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn = _MHAProjections(embed_dims)

    def qkv(self, x: torch.Tensor, dtype: torch.dtype):
        """q, k, v [B, L, H, D] as strided views of the fused projection."""
        b, l, c = x.shape
        h = self.num_heads
        qkv = linear(x, self.attn.in_proj_weight, self.attn.in_proj_bias,
                     dtype)
        return [t.view(b, l, h, c // h) for t in qkv.split(c, dim=-1)]

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, c = x.shape
        q, k, v = self.qkv(x, self.dtype)
        out, _ = multi_head_attention(q, k, v, bias=attn_bias)
        proj = self.attn.out_proj
        return linear(out.reshape(b, l, c), proj.weight, proj.bias,
                      self.dtype)


class FFN(nn.Module):
    """Linear-GELU-Linear (reference mmcv FFN key layout ``layers.0.0`` and
    ``layers.1``)."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList([
            nn.ModuleList([nn.Linear(embed_dims, feedforward_channels)]),
            nn.Linear(feedforward_channels, embed_dims)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1, fc2 = self.layers[0][0], self.layers[1]
        y = F.gelu(linear(x, fc1.weight, fc1.bias, self.dtype))
        return linear(y, fc2.weight, fc2.bias, self.dtype)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN block: x += MHA(LN(x), bias); x += FFN(LN(x))."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, norm_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(embed_dims, eps=norm_eps)
        self.attn = MultiheadSelfAttention(embed_dims, num_heads, dtype)
        self.ln2 = nn.LayerNorm(embed_dims, eps=norm_eps)
        self.ffn = FFN(embed_dims, feedforward_channels, dtype)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln1, self.dtype), attn_bias)
        return x + self.ffn(layer_norm(x, self.ln2, self.dtype))


class PatchEmbed(nn.Module):
    """p x p stride-p conv (reference key ``patch_embed.projection``)."""

    def __init__(self, in_channels: int, embed_dims: int, patch_size: int):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, embed_dims, patch_size,
                                    stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x [B, H, W, Cin] -> tokens [B, H/p * W/p, C] in dtype."""
        w, b = self.projection.weight, self.projection.bias
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), w.to(dtype),
                     b.to(dtype), stride=self.projection.stride)
        return y.flatten(2).transpose(1, 2)


def _resize_pos_embed(pos_embed: torch.Tensor, hw: Tuple[int, int],
                      with_cls_token: bool) -> torch.Tensor:
    """Runtime bilinear pos-embed resize (reference vit.py:416-477)."""
    n = pos_embed.shape[1] - (1 if with_cls_token else 0)
    src = int(round(float(n) ** 0.5))
    if (src, src) == tuple(hw):
        return pos_embed
    grid = pos_embed[:, 1:] if with_cls_token else pos_embed
    c = grid.shape[-1]
    grid = resize_bilinear(grid.reshape(1, src, src, c), hw,
                           align_corners=False)
    grid = grid.reshape(1, hw[0] * hw[1], c)
    if with_cls_token:
        return torch.cat([pos_embed[:, :1], grid], dim=1)
    return grid


def _pos_embed_ablation(pos_embed: torch.Tensor, mode: str,
                        with_cls_token: bool) -> torch.Tensor:
    """Pos-embed ablations (reference vit.py:488-513); ``mode`` in
    {'default', 'none', 'avg', 'duplicate'}."""
    if mode == 'default':
        return pos_embed
    if mode == 'none':
        return torch.zeros_like(pos_embed)
    grid = pos_embed[:, 1:] if with_cls_token else pos_embed
    n, c = grid.shape[1], grid.shape[2]
    s = int(round(float(n) ** 0.5))
    g = grid.reshape(1, s, s, c)
    factor = 4
    if mode == 'avg':
        # avg-pool 4x4 then nearest-up 4x (vit.py:494-500)
        pooled = g.reshape(1, s // factor, factor, s // factor, factor,
                           c).mean(dim=(2, 4))
        up = pooled.repeat_interleave(factor, 1).repeat_interleave(factor, 2)
    elif mode == 'duplicate':
        up = g[:, :s // factor, :s // factor, :].repeat(1, factor, factor, 1)
    else:
        raise ValueError(f'unknown pos_mode {mode}')
    up = up.reshape(1, n, c)
    if with_cls_token:
        return torch.cat([pos_embed[:, :1], up], dim=1)
    return up


@BACKBONES.register_module()
class VisionTransformer(nn.Module):
    """DeiT-style ViT backbone for SETR/S4Former.

    ``forward`` returns a tuple of NHWC feature maps at ``out_indices`` and,
    with ``return_attn``, per-tap attention probabilities and the grid.
    """

    def __init__(self,
                 img_size: Tuple[int, int] = (512, 512),
                 patch_size: int = 16,
                 in_channels: int = 3,
                 embed_dims: int = 768,
                 num_layers: int = 12,
                 num_heads: int = 12,
                 mlp_ratio: int = 4,
                 out_indices: Sequence[int] = (4, 7, 9, 11),
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 with_cls_token: bool = True,
                 norm_eps: float = 1e-6,
                 scan_unroll: int = 1,
                 dtype: torch.dtype = torch.float32,
                 interpolate_mode: str = 'bilinear',
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        if isinstance(img_size, int):
            img_size = (img_size, img_size)
        self.patch_size = patch_size
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.out_indices = tuple(out_indices)
        self.with_cls_token = with_cls_token
        self.dtype = dtype
        self.drop_rates = dict(drop_rate=drop_rate,
                               attn_drop_rate=attn_drop_rate,
                               drop_path_rate=drop_path_rate)
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size)
        if with_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        n_pos = (img_size[0] // patch_size) * (img_size[1] // patch_size) + \
            (1 if with_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dims))
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dims, num_heads,
                                    mlp_ratio * embed_dims, norm_eps, dtype)
            for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, *,
                train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default',
                use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x``: [B, H, W, 3] float. ``attn_bias``: [B, 1|heads, L+1, L+1]
        additive logit bias (PASA), or None; it gets no gradient.
        ``generator`` is the train forward's randomness, unused here (no
        dropout is ported for the ViT)."""
        live = [k for k, r in self.drop_rates.items() if r > 0 and train]
        if live or use_fdrop:
            raise NotImplementedError(
                f'dropout is not ported: '
                f'{live + (["use_fdrop"] if use_fdrop else [])}')
        # flash attention takes the bias in the compute dtype: cast once
        # here for every layer (the JAX wrapper casts it in each call)
        layer_bias = None if attn_bias is None else \
            attn_bias.detach().to(self.dtype)
        b, ih, iw, _ = x.shape
        p = self.patch_size
        # AdaptivePadding 'corner': zero-pad bottom/right so the stride-p
        # patch conv covers inputs not divisible by p (reference
        # mmseg/models/utils/embed.py:12-81)
        ph, pw = -(-ih // p) * p, -(-iw // p) * p
        if (ph, pw) != (ih, iw):
            x = F.pad(x, (0, 0, 0, pw - iw, 0, ph - ih))
        hw = (ph // p, pw // p)
        num_patches = hw[0] * hw[1]
        tokens = self.patch_embed(x, self.dtype)

        if self.with_cls_token:
            cls = self.cls_token.to(tokens.dtype).expand(b, -1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        n_pos = num_patches + (1 if self.with_cls_token else 0)
        pos = _pos_embed_ablation(self.pos_embed, pos_mode,
                                  self.with_cls_token)
        if n_pos != pos.shape[1]:
            pos = _resize_pos_embed(pos, hw, self.with_cls_token)
        tokens = tokens + pos.to(tokens.dtype)

        states = []
        h = tokens
        for layer in self.layers:
            h = layer(h, layer_bias)
            states.append(h)

        outs, attns = [], []
        for i in self.out_indices:
            feat_tokens = states[i][:, 1:] if self.with_cls_token \
                else states[i]
            outs.append(feat_tokens.reshape(b, hw[0], hw[1], self.embed_dims))
            if return_attn:
                x_in = tokens if i == 0 else states[i - 1]
                attns.append(self._attn_probs(i, x_in, attn_bias))
        if return_attn:
            return tuple(outs), (attns, hw)
        return tuple(outs)

    def _attn_probs(self, i: int, x_in: torch.Tensor,
                    attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """Layer i's attention probabilities, recomputed in f32 from its
        input (the explicit debug path of JAX ``_attn_probs_for_layer``,
        replacing the reference's patched-mmcv ``.self_attn`` capture)."""
        layer = self.layers[i]
        y = layer_norm(x_in, layer.ln1, torch.float32)
        q, k, _ = layer.attn.qkv(y, torch.float32)
        _, probs = dot_product_attention(q, k, torch.zeros_like(q),
                                         bias=attn_bias, return_probs=True)
        return probs[:, :, 1:, 1:] if self.with_cls_token else probs
