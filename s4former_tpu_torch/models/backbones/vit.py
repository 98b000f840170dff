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
- ``train=True`` is the training forward, with the JAX module's dropout
  (``models/dropout.py``, drawn from the caller's ``torch.Generator``):
  ``drop_rate`` element-wise on the tokens after the position embedding,
  on the attention projection's output and after each FFN linear;
  ``drop_path_rate`` one per-sample mask per residual branch, the same
  rate in every layer, as the JAX scan passes it (mmseg's ViT ramps it
  linearly). ``attn_drop_rate`` is accepted and changes no output: the
  JAX module drops the attention probabilities it returns, after the
  output is computed (JAX vit.py:66-70). In eval mode every rate is an
  identity. ``use_fdrop`` multiplies each ``out_indices`` map by a
  channelwise keep-0.5 mask [B, 1, 1, C] (x2), in train and eval alike, as
  JAX does. The flash kernels run unchanged: no dropout is inside them.
  ``scan_unroll`` is a JAX compile option the flagship config sets; it is
  accepted and means nothing here.
- ``remat_layers`` recomputes each layer in the backward
  (``torch.utils.checkpoint``, non-reentrant), only while gradients are on.
  ``remat_policy='dots'`` keeps the matrix products' outputs and recomputes
  the rest, as JAX's ``checkpoint_dots``; any other value recomputes
  everything. The flash forward is a ctypes call no policy sees, so it is
  recomputed under both: one more launch of the forward kernel a layer of
  each pass that takes a gradient, as the Pallas call is under JAX's
  policy. A layer's dropout and drop-path masks are drawn before the
  checkpointed call and passed in, so the recomputation sees the same masks
  and the generator advances as it does without remat. The default is off,
  unlike JAX's (True, set for a 16 GB TPU): remat changes no output, only
  memory and time, and the configs fit the 80 GB card without it.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from s4former_tpu_torch.models import dropout as dropout_mod
from s4former_tpu_torch.models.dropout import (apply_keep, channel_dropout,
                                              dropout)
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
                attn_bias: Optional[torch.Tensor] = None,
                drop: Optional[Tuple[float, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``drop``: (rate, keep mask) of the projection's dropout."""
        b, l, c = x.shape
        q, k, v = self.qkv(x, self.dtype)
        out, _ = multi_head_attention(q, k, v, bias=attn_bias)
        proj = self.attn.out_proj
        out = linear(out.reshape(b, l, c), proj.weight, proj.bias,
                     self.dtype)
        return out if drop is None else apply_keep(out, drop[1], drop[0])


class FFN(nn.Module):
    """Linear-GELU-Linear (reference mmcv FFN key layout ``layers.0.0`` and
    ``layers.1``)."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.feedforward_channels = feedforward_channels
        self.layers = nn.ModuleList([
            nn.ModuleList([nn.Linear(embed_dims, feedforward_channels)]),
            nn.Linear(feedforward_channels, embed_dims)])

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                masks: Tuple[Optional[torch.Tensor], ...] = (None, None)
                ) -> torch.Tensor:
        """``masks``: the keep masks of the dropouts after each linear, or
        None."""
        fc1, fc2 = self.layers[0][0], self.layers[1]
        y = F.gelu(linear(x, fc1.weight, fc1.bias, self.dtype))
        if masks[0] is not None:
            y = apply_keep(y, masks[0], rate)
        y = linear(y, fc2.weight, fc2.bias, self.dtype)
        return y if masks[1] is None else apply_keep(y, masks[1], rate)


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

    def draw_masks(self, x: torch.Tensor, drop_rate: float,
                   drop_path_rate: float,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[Optional[torch.Tensor], ...]:
        """The layer's keep masks for input ``x``, in the JAX layer's order:
        projection dropout, the attention branch's drop path, the two FFN
        dropouts, the FFN branch's drop path (None where a rate is 0)."""
        b, l, c = x.shape
        shapes = [(drop_rate, (b, l, c)), (drop_path_rate, (b, 1, 1)),
                  (drop_rate, (b, l, self.ffn.feedforward_channels)),
                  (drop_rate, (b, l, c)), (drop_path_rate, (b, 1, 1))]
        return tuple(
            dropout_mod.keep_mask(generator, 1.0 - rate, shape, x.device)
            if rate > 0 else None for rate, shape in shapes)

    def block(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
              masks: Tuple[Optional[torch.Tensor], ...], drop_rate: float,
              drop_path_rate: float) -> torch.Tensor:
        """The layer given its drawn ``masks``: no randomness, so a
        recomputation in the backward gives the same values."""
        proj, attn_path, fc1, fc2, ffn_path = masks

        def branch(y, mask):
            return y if mask is None else apply_keep(y, mask, drop_path_rate)
        x = x + branch(self.attn(layer_norm(x, self.ln1, self.dtype),
                                 attn_bias,
                                 None if proj is None else (drop_rate, proj)),
                       attn_path)
        return x + branch(self.ffn(layer_norm(x, self.ln2, self.dtype),
                                   drop_rate, (fc1, fc2)), ffn_path)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The rates are the train forward's (0 in eval); the masks are
        drawn from ``generator`` first (``draw_masks``)."""
        masks = self.draw_masks(x, drop_rate, drop_path_rate, generator)
        return self.block(x, attn_bias, masks, drop_rate, drop_path_rate)


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


# the products of the ViT layer (its four linears; the plain attention's
# einsums on the CPU) at the aten level, below autograd
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: keep the outputs of the
    matrix products, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def remat_kwargs(policy: str) -> dict:
    """``checkpoint``'s keywords for ``remat_policy``: 'dots' saves the
    products (``save_dots``); any other policy recomputes the whole layer,
    as the JAX ViT's (vit.py:339-347)."""
    if policy != 'dots':
        return {}
    return {'context_fn': functools.partial(
        create_selective_checkpoint_contexts, save_dots)}


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
                 remat_layers: bool = False,
                 remat_policy: str = 'dots',
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
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate    # changes no output (above)
        self.drop_path_rate = drop_path_rate
        self.remat_layers = remat_layers
        self.remat_policy = remat_policy
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
        ``generator`` draws the train forward's dropout and drop path and
        the fdrop masks."""
        drop_rate = self.drop_rate if train else 0.0
        drop_path_rate = self.drop_path_rate if train else 0.0
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
        if drop_rate > 0:
            tokens = dropout(tokens, drop_rate, generator)

        states = []
        h = tokens
        remat = self.remat_layers and torch.is_grad_enabled()
        for layer in self.layers:
            masks = layer.draw_masks(h, drop_rate, drop_path_rate, generator)
            if remat:
                h = checkpoint(layer.block, h, layer_bias, masks, drop_rate,
                               drop_path_rate, use_reentrant=False,
                               preserve_rng_state=False,
                               **remat_kwargs(self.remat_policy))
            else:
                h = layer.block(h, layer_bias, masks, drop_rate,
                                drop_path_rate)
            states.append(h)

        outs, attns = [], []
        for i in self.out_indices:
            feat_tokens = states[i][:, 1:] if self.with_cls_token \
                else states[i]
            out = feat_tokens.reshape(b, hw[0], hw[1], self.embed_dims)
            outs.append(channel_dropout(out, generator) if use_fdrop
                        else out)
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
