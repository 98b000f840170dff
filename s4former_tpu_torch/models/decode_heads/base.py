"""Decode-head shared machinery (counterpart of
``s4former_tpu/models/decode_heads/base.py``; reference:
mmseg/models/decode_heads/decode_head.py:159-212).

- ``transform_inputs``: resize_concat / multiple_select / index selection.
- ``unshuffle_tokens`` / ``unshuffle_feature_map``: the PatchShuffle undo
  (``_repatchmix_inputs``, decode_head.py:186-212) driven by a
  ``[B, G*G]`` permutation tensor, as one batched gather.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from s4former_tpu_torch.ops.resize import resize_bilinear


def transform_inputs(inputs: Sequence[torch.Tensor],
                     in_index: Union[int, Sequence[int]],
                     input_transform: Optional[str] = None,
                     align_corners: bool = False):
    """Select/assemble backbone features (NHWC)."""
    if input_transform == 'resize_concat':
        sel = [inputs[i] for i in in_index]
        target_hw = tuple(sel[0].shape[1:3])
        up = [resize_bilinear(x, target_hw, align_corners) for x in sel]
        return torch.cat(up, dim=-1)
    if input_transform == 'multiple_select':
        return [inputs[i] for i in in_index]
    return inputs[in_index]


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """Batched inverse permutation: inv[b, perm[b, j]] = j."""
    return torch.argsort(perm, dim=-1)


def unshuffle_tokens(tokens: torch.Tensor, perm: torch.Tensor,
                     patchmix_n: int) -> torch.Tensor:
    """Undo a PatchShuffle on raster-ordered patch tokens [B, P*P, C].

    ``perm`` [B, G*G] (G = P // patchmix_n) is the shuffle applied to the
    image: shuffled super-patch j = original super-patch perm[j]; an
    identity row leaves its sample as is. Output super-patch k = shuffled
    super-patch inv[k]."""
    b, l, c = tokens.shape
    p = int(round(float(l) ** 0.5))
    n = patchmix_n
    g = p // n
    if g * n != p or perm.shape[-1] != g * g:
        # JAX fails on the shapes here: the image's super-patches
        # (patchsize * PatchMix_N pixels) must tile this grid in blocks of
        # patchmix_n (a stride-8 CNN's map takes patchsize 8)
        raise ValueError(
            f'a PatchShuffle permutation of {perm.shape[-1]} super-patches '
            f'does not tile a {p} x {p} feature map in blocks of '
            f'{n} x {n}: set the mixes\' patchsize to the image pixels a '
            f'feature of this map covers')
    x = tokens.reshape(b, g, n, g, n, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * g, n * n, c)
    inv = invert_permutation(perm).long()
    x = torch.gather(x, 1, inv[:, :, None, None].expand(-1, -1, n * n, c))
    x = x.reshape(b, g, g, n, n, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, l, c)


def unshuffle_feature_map(feat: torch.Tensor, perm: torch.Tensor,
                          patchmix_n: int) -> torch.Tensor:
    """The same undo on an NHWC map whose grid is the patch grid
    (reference get_repatchmix_feat, setr_up_head.py:79-91)."""
    b, h, w, c = feat.shape
    tokens = unshuffle_tokens(feat.reshape(b, h * w, c), perm, patchmix_n)
    return tokens.reshape(b, h, w, c)
