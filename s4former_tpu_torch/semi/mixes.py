"""The strong mixes of the flagship S4Former step (counterpart of
``s4former_tpu/semi/mixes.py``; reference: mmseg/utils/generate_unsup_data.py).

Only what the flagship's ``use_PatchShuffle_w_Cutmix`` branch runs is
ported: box CutMix (``random_box_mask``, ``cutmix_with_masks``,
``cutmix``) and PatchShuffle (``patch_shuffle``, ``apply_patch_perm``). The
rest of the JAX family (CutOut, ClassMix, patchwise masks,
``mix_with_labeled``, ``cutmix_label_adaptive``) is not ported yet.

Images are NHWC, labels [B, H, W] int (255 = ignore), at the images'
resolution or at the head's (the SegFormer head's logits are at a quarter of
it): CutMix then mixes the labels at image resolution and brings them back,
nearest, as the JAX package does.
Randomness comes from an explicit ``torch.Generator`` on the images' device,
so the draws stay on the card; they are not ``jax.random``'s numbers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from s4former_tpu_torch.ops.resize import resize_nearest


def random_box_mask(generator: Optional[torch.Generator], b: int,
                    hw: Tuple[int, int], ratio: float = 2.0,
                    device=None) -> torch.Tensor:
    """[B, H, W] {0,1} float masks, 0 inside one random box each of area
    H*W/ratio (reference generate_cutout_mask, l.7-26): box width ~
    randint(W/ratio + 1, W), height round(area / width), top-left corner
    uniform and clamped into the image."""
    h, w = hw
    area = h * w / ratio
    box_w = torch.randint(int(w / ratio) + 1, w, (b,), generator=generator,
                          device=device)
    box_h = torch.round(area / box_w).long().clamp(max=h)
    x0 = torch.minimum(torch.randint(0, w, (b,), generator=generator,
                                     device=device), w - box_w)
    y0 = torch.minimum(torch.randint(0, h, (b,), generator=generator,
                                     device=device), h - box_h)
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < (y0 + box_h)[:, None, None]) &
              (xs >= x0[:, None, None]) & (xs < (x0 + box_w)[:, None, None]))
    return (~inside).float()


def cutmix_with_masks(masks: torch.Tensor, imgs: torch.Tensor,
                      labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CutMix with given [B, H, W] {0,1} masks: where a mask is 0, sample
    i takes sample (i+1) % B's pixels and labels. Labels at another
    resolution are mixed at the images' (nearest up, then back down)."""
    img_hw = tuple(imgs.shape[1:3])
    label_hw = tuple(labels.shape[1:])
    full = labels if label_hw == img_hw else resize_nearest(labels, img_hw)
    nxt = torch.roll(torch.arange(imgs.shape[0], device=imgs.device), -1)
    m4 = masks[..., None].to(imgs.dtype)
    new_imgs = imgs * m4 + imgs[nxt] * (1.0 - m4)
    new_labels = torch.where(masks > 0.5, full, full[nxt])
    if label_hw != img_hw:
        new_labels = resize_nearest(new_labels, label_hw)
    return new_imgs, new_labels.to(labels.dtype)


def cutmix(generator: Optional[torch.Generator], imgs: torch.Tensor,
           labels: torch.Tensor, ratio: float = 2.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample i mixed with sample (i+1) % B under a random box each
    (generate_unsup_cutmix_data, l.400-453)."""
    b, h, w, _ = imgs.shape
    masks = random_box_mask(generator, b, (h, w), ratio, device=imgs.device)
    return cutmix_with_masks(masks, imgs, labels)


def apply_patch_perm(imgs: torch.Tensor, perms: torch.Tensor,
                     patchmix_n: int, patch_size: int = 16) -> torch.Tensor:
    """Permute each image as (patch_size * patchmix_n)^2-pixel super-patches:
    shuffled super-patch j = original super-patch perms[b, j]."""
    b, h, w, c = imgs.shape
    s = patch_size * patchmix_n
    g, gw = h // s, w // s
    x = imgs.reshape(b, g, s, gw, s, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * gw, s, s, c)
    x = torch.gather(x, 1, perms.long()[:, :, None, None, None].expand(
        -1, -1, s, s, c))
    x = x.reshape(b, g, gw, s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def patch_shuffle(generator: Optional[torch.Generator], imgs: torch.Tensor,
                  patchmix_n: int, patch_size: int = 16,
                  patchmix_ratio: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PatchShuffle (generate_unsup_patchmix_data, l.737-819): with
    probability ``patchmix_ratio`` per sample, a uniform random permutation
    of the super-patches, else the identity. Returns (images, perm [B, G*G]
    int32); the decode head undoes perm on its features."""
    b, h, w, _ = imgs.shape
    s = patch_size * patchmix_n
    gg = (h // s) * (w // s)
    dev = imgs.device
    gates = torch.rand((b,), generator=generator, device=dev) < patchmix_ratio
    perms = torch.argsort(torch.rand((b, gg), generator=generator,
                                     device=dev), dim=1)
    identity = torch.arange(gg, device=dev).expand(b, gg)
    perms = torch.where(gates[:, None], perms, identity).to(torch.int32)
    return apply_patch_perm(imgs, perms, patchmix_n, patch_size), perms
