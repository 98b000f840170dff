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
- The JAX module's options: ``qkv_bias=False`` (no ``in_proj_bias``, absent
  from ``state_dict()`` as in mmseg's layout); ``use_flash=False`` (the
  plain attention of ``ops/attention.py``, no kernel launched: the
  config's choice; the default runs the kernels); ``final_norm`` (a
  LayerNorm, mmseg's ``ln1``, on the last layer's tap); ``output_cls_token``
  (each tap is [map, cls token]). ``attn_bias`` may be per layer,
  [num_layers, B, 1, T, T] (PASA's ``layer_scales``): layer i takes its
  slice.
- Tensor parallelism (``parallel/tp.py``): with ``tp`` > 1 the attention
  and the FFN hold their pieces only. The attention's input goes through
  ``copy_to_model``; the rank's q, k, v are [B, L, H/tp, 64] views of its
  [B, L, 3C/tp] product (an H stride of 64 elements, 16-byte aligned, no
  copy) and run the flash kernels at H/tp heads; the output projection's
  partial products, kept in f32, are summed by ``reduce_from_model``,
  then its whole bias is added and the sum rounded to the compute dtype
  once (``row_split_linear``), as the unsplit product rounds its f32
  accumulator once. The FFN likewise around fc1 | fc2; its hidden
  dropout mask is drawn whole and the rank keeps its columns, so the
  draws match the unsharded step. A [B, H, T, T] bias is cut to the rank's
  heads; a [B, 1, T, T] one passes. ZeRO-3 shards are gathered at each use
  (``parallel.mesh.param``), recomputation under remat included.
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
from s4former_tpu_torch.parallel.distributed import model_rank
from s4former_tpu_torch.parallel.mesh import (copy_to_model, param,
                                              reduce_from_model)
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


class _F32Product(torch.autograd.Function):
    """x @ w.T of bf16 / f16 CUDA tensors with the GEMM's f32 accumulator
    as the output, not rounded to the inputs' dtype; the backward takes
    the gradient in the inputs' dtype, as ``linear``'s does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.view(tuple(x.shape[:-1]) + (w.shape[0],))

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


def partial_product(x: torch.Tensor, w: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """A rank's share of a row-split product, in f32: summed over the
    model group before one rounding to ``dtype``, as the unsplit product
    rounds its f32 sum once."""
    if dtype in (torch.bfloat16, torch.float16) and x.is_cuda:
        return _F32Product.apply(x.to(dtype), w.to(dtype))
    return linear(x, w, None, dtype).float()


def row_split_linear(x: torch.Tensor, module: nn.Module, tp: int,
                     dtype: torch.dtype, weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``module``'s linear (weight [out, in]) on ``x``; with ``tp`` > 1 the
    weight is the rank's input columns, the partial products are summed
    in f32 over the model group, the whole bias is added once, after, and
    the sum is rounded to ``dtype`` once."""
    w = param(module, 'weight') if weight is None else weight
    if tp == 1:
        return linear(x, w, module.bias, dtype)
    y = reduce_from_model(partial_product(x, w, dtype))
    if module.bias is not None:
        y = y + module.bias.to(dtype).float()
    return y.to(dtype)


class _MHAProjections(nn.Module):
    """Parameter holder in torch ``nn.MultiheadAttention``'s names
    (``in_proj_weight`` [3C, C], ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, embed_dims: int, qkv_bias: bool = True):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims)) \
            if qkv_bias else None
        self.out_proj = nn.Linear(embed_dims, embed_dims)


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv self-attention (reference key layout ``attn.attn.*``).
    ``tp`` > 1: the rank's H/tp heads (module docstring)."""
    tp = 1
    head_split = True       # the model split cuts at head boundaries

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, qkv_bias: bool = True,
                 use_flash: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_flash = use_flash
        self.attn = _MHAProjections(embed_dims, qkv_bias)

    def qkv(self, x: torch.Tensor, dtype: torch.dtype):
        """q, k, v [B, L, H/tp, D] as strided views of the fused
        projection."""
        b, l, _ = x.shape
        h = self.num_heads // self.tp
        qkv = linear(x, param(self.attn, 'in_proj_weight'),
                     self.attn.in_proj_bias, dtype)
        c = qkv.shape[-1] // 3
        return [t.view(b, l, h, c // h) for t in qkv.split(c, dim=-1)]

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                drop: Optional[Tuple[float, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``drop``: (rate, keep mask) of the projection's dropout.
        ``attn_bias`` [B, 1|H/tp, T, T]."""
        b, l, _ = x.shape
        if self.tp > 1:
            x = copy_to_model(x)
        q, k, v = self.qkv(x, self.dtype)
        out, _ = multi_head_attention(q, k, v, bias=attn_bias,
                                      use_flash=self.use_flash)
        out = row_split_linear(out.reshape(b, l, -1), self.attn.out_proj,
                               self.tp, self.dtype)
        return out if drop is None else apply_keep(out, drop[1], drop[0])


class FFN(nn.Module):
    """Linear-GELU-Linear (reference mmcv FFN key layout ``layers.0.0`` and
    ``layers.1``). ``tp`` > 1: the rank's hidden columns."""
    tp = 1

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
        if self.tp > 1:
            x = copy_to_model(x)
        y = F.gelu(linear(x, param(fc1, 'weight'), fc1.bias, self.dtype))
        if masks[0] is not None:
            # drawn at the whole hidden width: the rank keeps its columns
            mask = masks[0] if self.tp == 1 else \
                masks[0].chunk(self.tp, -1)[model_rank()]
            y = apply_keep(y, mask, rate)
        y = row_split_linear(y, fc2, self.tp, self.dtype)
        return y if masks[1] is None else apply_keep(y, masks[1], rate)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN block: x += MHA(LN(x), bias); x += FFN(LN(x))."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, norm_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, qkv_bias: bool = True,
                 use_flash: bool = True):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(embed_dims, eps=norm_eps)
        self.attn = MultiheadSelfAttention(embed_dims, num_heads, dtype,
                                           qkv_bias, use_flash)
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
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
           torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.baddbmm.default)


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
                 qkv_bias: bool = True,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 with_cls_token: bool = True,
                 output_cls_token: bool = False,
                 final_norm: bool = False,
                 norm_eps: float = 1e-6,
                 use_flash: bool = True,
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
        if any(not -num_layers <= i < num_layers for i in out_indices):
            # JAX indexes its stacked layer outputs, and jnp clamps an
            # index past the end to the last layer
            raise ValueError(f'out_indices {tuple(out_indices)} outside '
                             f'the {num_layers} layers')
        if output_cls_token and not with_cls_token:
            # mmseg asserts it; the JAX module's pos embed cannot add
            raise ValueError('output_cls_token needs with_cls_token')
        self.patch_size = patch_size
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.out_indices = tuple(out_indices)
        self.with_cls_token = with_cls_token
        self.output_cls_token = output_cls_token
        self.final_norm = final_norm
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
                                    mlp_ratio * embed_dims, norm_eps, dtype,
                                    qkv_bias, use_flash)
            for _ in range(num_layers)])
        if final_norm:      # mmseg's name for the final norm
            self.ln1 = nn.LayerNorm(embed_dims, eps=norm_eps)

    def _layer_bias(self, attn_bias: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
        """The bias in the compute dtype, cut to this rank's heads under
        tensor parallelism (a head axis of 1 passes)."""
        if attn_bias is None:
            return None
        bias = attn_bias.detach().to(self.dtype)
        tp = self.layers[0].attn.tp if len(self.layers) else 1
        heads = bias.shape[-3]
        if tp > 1 and heads > 1:
            per = heads // tp
            bias = bias.narrow(-3, model_rank() * per, per)
        return bias

    def forward(self, x: torch.Tensor, *,
                train: bool = False,
                attn_bias: Optional[torch.Tensor] = None,
                pos_mode: str = 'default',
                use_fdrop: bool = False,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x``: [B, H, W, 3] float. ``attn_bias``: [B, 1|heads, L+1, L+1]
        additive logit bias (PASA), or per layer [num_layers, B, 1|heads,
        L+1, L+1] (``layer_scales``), or None; it gets no gradient.
        ``generator`` draws the train forward's dropout and drop path and
        the fdrop masks."""
        drop_rate = self.drop_rate if train else 0.0
        drop_path_rate = self.drop_path_rate if train else 0.0
        # flash attention takes the bias in the compute dtype: cast once
        # here for every layer (the JAX wrapper casts it in each call)
        layer_bias = self._layer_bias(attn_bias)
        per_layer = layer_bias is not None and layer_bias.dim() == 5
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
        for i, layer in enumerate(self.layers):
            masks = layer.draw_masks(h, drop_rate, drop_path_rate, generator)
            bias_i = layer_bias[i] if per_layer else layer_bias
            if remat:
                h = checkpoint(layer.block, h, bias_i, masks, drop_rate,
                               drop_path_rate, use_reentrant=False,
                               preserve_rng_state=False,
                               **remat_kwargs(self.remat_policy))
            else:
                h = layer.block(h, bias_i, masks, drop_rate, drop_path_rate)
            states.append(h)

        outs, attns = [], []
        for i in self.out_indices:
            layer_out = states[i]
            if self.final_norm and i == len(self.layers) - 1:
                layer_out = layer_norm(layer_out, self.ln1, self.dtype)
            feat_tokens = layer_out[:, 1:] if self.with_cls_token \
                else layer_out
            out = feat_tokens.reshape(b, hw[0], hw[1], self.embed_dims)
            if use_fdrop:
                out = channel_dropout(out, generator)
            outs.append([out, layer_out[:, 0]] if self.output_cls_token
                        else out)
            if return_attn:
                x_in = tokens if i == 0 else states[i - 1]
                attns.append(self._attn_probs(
                    i, x_in, attn_bias[i] if per_layer else attn_bias))
        if return_attn:
            return tuple(outs), (attns, hw)
        return tuple(outs)

    def _attn_probs(self, i: int, x_in: torch.Tensor,
                    attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """Layer i's attention probabilities, recomputed in f32 from its
        input (the explicit debug path of JAX ``_attn_probs_for_layer``,
        replacing the reference's patched-mmcv ``.self_attn`` capture); under
        tensor parallelism, those of the rank's heads."""
        layer = self.layers[i]
        y = layer_norm(x_in, layer.ln1, torch.float32)
        q, k, _ = layer.attn.qkv(y, torch.float32)
        _, probs = dot_product_attention(q, k, torch.zeros_like(q),
                                         bias=attn_bias, return_probs=True)
        return probs[:, :, 1:, 1:] if self.with_cls_token else probs
