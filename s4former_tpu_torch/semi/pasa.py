"""PASA: the confidence-driven additive self-attention bias (counterpart of
``s4former_tpu/semi/pasa.py``; reference: mmseg/models/backbones/vit.py:519-541
and encoder_decoder.py:547-567).

- ``layer_scales``: one bias a ViT layer, scaled per layer;
- per-patch unconfidence = mean over the patch's pixels of (1 - conf_mask);
- bias[b, q, k] = w * unconf[b, k]: attention toward unconfident patches is
  raised; the cls token has unconfidence 0;
- adaptive: the query rows of the 50% most confident patches are zeroed.
  The ranks come from a STABLE argsort, as ``jnp.argsort`` is stable, so
  ties (frequent in per-patch means) pick the same rows as the JAX package.
- ``pasa_bias_from_conf_mask``: the train step's whole pipeline, from the
  teacher's image-resolution confidence mask to the bias.
- ``mit_stage_bias``: the MiT's per-stage bias from the unconfidence pooled
  to that stage's token grid (reference mit.py:464-475).
- ``require_cls_token``: the ViT bias has a cls row and column, so a ViT
  built with ``with_cls_token=False`` (SETR-MLA's) cannot take it. The
  JAX step and teacher-PASA inference build it with the cls row all the
  same and fail on the shapes; the port refuses such a model with a
  ValueError, before any forward, rather than build another bias.
"""
from __future__ import annotations

from typing import Optional

import torch


def patch_unconfidence(conf_mask: torch.Tensor,
                       patch_size: int) -> torch.Tensor:
    """[B, H, W] {0,1} confidence mask -> [B, h*w] mean unconfidence per
    patch_size x patch_size patch (raster order)."""
    b, h, w = conf_mask.shape
    ph, pw = h // patch_size, w // patch_size
    unconf = 1.0 - conf_mask.float()
    unconf = unconf.reshape(b, ph, patch_size, pw, patch_size)
    return unconf.mean(dim=(2, 4)).reshape(b, ph * pw)


def build_pasa_bias(unconf: torch.Tensor,
                    attn_mask_weight: float,
                    adaptive: bool,
                    with_cls_token: bool = True,
                    layer_scales: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """unconf [B, L] in [0,1] -> additive bias [B, 1, L(+1), L(+1)].

    ``layer_scales`` [num_layers] (the reference's learnable per-layer sigma
    ablation, ``w_PatchRelativeAttention``, vit.py:130-134, 540-541) gives
    [num_layers, B, 1, T, T], the bias scaled for each layer; the ViT hands
    layer i its slice."""
    b, n = unconf.shape
    vec = torch.cat([unconf.new_zeros((b, 1)), unconf], dim=1) \
        if with_cls_token else unconf
    t = vec.shape[1]
    bias = vec[:, None, :].expand(b, t, t)
    if adaptive:
        k = int(0.5 * n)
        order = torch.argsort(unconf, dim=1, stable=True)  # most confident 1st
        ranks = torch.argsort(order, dim=1, stable=True)
        row_zero = ranks < k
        if with_cls_token:   # the cls row is never zeroed (vit.py:526-528)
            row_zero = torch.cat([row_zero.new_zeros((b, 1)), row_zero],
                                 dim=1)
        bias = torch.where(row_zero[:, :, None], 0.0, bias)
    bias = (bias * attn_mask_weight)[:, None, :, :]
    if layer_scales is not None:
        return bias[None] * layer_scales[:, None, None, None, None]
    return bias


def pasa_bias_from_conf_mask(conf_mask: torch.Tensor, patch_size: int,
                             attn_mask_weight: float, adaptive: bool,
                             with_cls_token: bool = True) -> torch.Tensor:
    """[B, H, W] {0,1} confidence mask -> additive bias [B, 1, L+1, L+1]."""
    return build_pasa_bias(patch_unconfidence(conf_mask, patch_size),
                           attn_mask_weight, adaptive, with_cls_token)


def require_cls_token(backbone, what: str) -> None:
    """Raise ValueError if ``backbone`` is a ViT without a cls token."""
    if getattr(backbone, 'with_cls_token', True):
        return
    raise ValueError(
        f'{what} needs a ViT with with_cls_token=True: the PASA bias has a '
        f'cls row and column, and this backbone has with_cls_token=False '
        f'(the JAX package cannot run it either)')


def mit_stage_bias(unconf: torch.Tensor, attn_mask_weight: float,
                   adaptive: bool) -> torch.Tensor:
    """MiT per-stage PASA bias: pooled per-token unconfidence [B, L] in
    [0, 1] -> additive bias [B, 1, L, L] (JAX ``mit_stage_bias``).

    Not adaptive: every query row is the key-unconfidence vector. Adaptive:
    the key vector is inverted (``1 - unconf``, reference mit.py:470) and
    the query rows of the most confident half are zeroed. As in the
    reference (and the JAX package), the ranks are taken over
    ``unconf[:, 1:]`` (a leftover of the ViT's cls token) and used as row
    indices without the shift, so row ``l - 1`` is never zeroed. Both
    argsorts are stable, as ``jnp.argsort`` is: pooled binary maps are full
    of ties."""
    b, l = unconf.shape
    if not adaptive:
        return (unconf[:, None, :].expand(b, l, l) *
                attn_mask_weight)[:, None]
    bias = (1.0 - unconf)[:, None, :].expand(b, l, l)
    k = int(0.5 * (l - 1))
    order = torch.argsort(unconf[:, 1:], dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    row_zero = torch.cat(
        [ranks < k, torch.zeros((b, 1), dtype=torch.bool,
                                device=unconf.device)], dim=1)
    bias = torch.where(row_zero[:, :, None], 0.0, bias)
    return (bias * attn_mask_weight)[:, None]
