"""The strong mixes of the S4Former step (counterpart of
``s4former_tpu/semi/mixes.py``; reference: mmseg/utils/generate_unsup_data.py).

Each mix is split into a draw (``torch.Generator`` -> masks, scores,
permutations, gates) and a deterministic apply (draws -> images and
labels), so a test or ``chip_smoke.py`` can hand both devices, or both
packages, the same draws:

- CutMix (and the supervised one, a box at ratio 2): ``random_box_mask``
  / ``random_patchwise_mask`` (``mix_masks``) -> ``cutmix_with_masks``;
- CutOut: the same masks -> ``cutout_with_masks``;
- ClassMix: ``class_scores`` (uniform per class, per sample or per
  super-patch) -> ``classmix_with_scores``, which selects n // 2 + 1 of the
  n classes present (per super-patch with ``patchwise``);
- PatchShuffle: ``shuffle_perms`` (in ``patch_shuffle``) ->
  ``apply_patch_perm``;
- ``mix_with_labeled``: no draw;
- adaptive CutMix: ``adaptive_draws`` -> ``cutmix_label_adaptive``.

Images are NHWC, labels [B, H, W] int (255 = ignore), at the images'
resolution or at the head's (the SegFormer head's logits are at a quarter of
it): CutMix, CutOut and ClassMix then mix the labels at image resolution
and bring them back, nearest, as the JAX package does. The draws stay on the
card; they are not ``jax.random``'s numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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


def random_patchwise_mask(generator: Optional[torch.Generator], b: int,
                          hw: Tuple[int, int], patchsize: int,
                          ratio: float = 2.0, device=None) -> torch.Tensor:
    """[B, H, W] {0,1} float masks, 0 on ``num_patches // ratio`` random
    patchsize² patches each (generate_patchwise_cutout_mask, l.351-365):
    uniform scores per patch, the k lowest cut."""
    return patchwise_mask_from_scores(
        torch.rand((b, (hw[0] // patchsize) * (hw[1] // patchsize)),
                   generator=generator, device=device), hw, patchsize, ratio)


def patchwise_mask_from_scores(scores: torch.Tensor, hw: Tuple[int, int],
                               patchsize: int, ratio: float = 2.0
                               ) -> torch.Tensor:
    """The masks of ``random_patchwise_mask`` from its scores [B, n]."""
    gh, gw = hw[0] // patchsize, hw[1] // patchsize
    k = int(scores.shape[1] // ratio)
    ranks = torch.argsort(torch.argsort(scores, dim=1), dim=1)
    cut = (ranks < k).float().reshape(-1, gh, gw)
    cut = cut.repeat_interleave(patchsize, 1).repeat_interleave(patchsize, 2)
    return 1.0 - cut


def mix_masks(generator: Optional[torch.Generator], b: int,
              hw: Tuple[int, int], ratio: float = 2.0,
              patchwise: bool = False, patchsize: int = 128,
              device=None) -> torch.Tensor:
    """CutMix's and CutOut's masks: a box each, or random patches."""
    if patchwise:
        return random_patchwise_mask(generator, b, hw, patchsize, ratio,
                                     device)
    return random_box_mask(generator, b, hw, ratio, device)


def _labels_at(labels: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    return labels if tuple(labels.shape[1:]) == hw else \
        resize_nearest(labels, hw)


def cutmix_with_masks(masks: torch.Tensor, imgs: torch.Tensor,
                      labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CutMix with given [B, H, W] {0,1} masks: where a mask is 0, sample
    i takes sample (i+1) % B's pixels and labels. Labels at another
    resolution are mixed at the images' (nearest up, then back down)."""
    img_hw = tuple(imgs.shape[1:3])
    label_hw = tuple(labels.shape[1:])
    full = _labels_at(labels, img_hw)
    nxt = torch.roll(torch.arange(imgs.shape[0], device=imgs.device), -1)
    m4 = masks[..., None].to(imgs.dtype)
    new_imgs = imgs * m4 + imgs[nxt] * (1.0 - m4)
    new_labels = torch.where(masks > 0.5, full, full[nxt])
    return new_imgs, _labels_at(new_labels, label_hw).to(labels.dtype)


def cutout_with_masks(masks: torch.Tensor, imgs: torch.Tensor,
                      labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CutOut with given masks: where a mask is 0 the image is zeroed and
    the label is 255 (generate_unsup_cutout_data, l.368-397)."""
    img_hw = tuple(imgs.shape[1:3])
    label_hw = tuple(labels.shape[1:])
    new_imgs = imgs * masks[..., None].to(imgs.dtype)
    full = _labels_at(labels, img_hw)
    new_labels = torch.where(masks > 0.5, full, torch.full_like(full, 255))
    return new_imgs, _labels_at(new_labels, label_hw).to(labels.dtype)


def class_scores(generator: Optional[torch.Generator], b: int,
                 num_classes: int, hw: Tuple[int, int],
                 patchwise: bool = False, patchsize: int = 128,
                 device=None) -> torch.Tensor:
    """ClassMix's draw: uniform scores per class, [B, C], or per
    super-patch [B, n_patches, C] with ``patchwise``."""
    shape = (b, num_classes) if not patchwise else \
        (b, (hw[0] // patchsize) * (hw[1] // patchsize), num_classes)
    return torch.rand(shape, generator=generator, device=device)


def _selected_classes(labels: torch.Tensor, scores: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """labels [N, P] int, scores [N, C] -> [N, C] bool: n // 2 + 1 of the
    n classes present (255 not a class), the lowest scores first;
    and the count n [N]."""
    classes = torch.arange(num_classes, device=labels.device)
    present = (labels[:, :, None] == classes).any(dim=1)
    n = present.sum(dim=1)
    ranked = torch.where(present, scores, torch.full_like(scores, math.inf))
    ranks = torch.argsort(torch.argsort(ranked, dim=1), dim=1)
    return (ranks < (n // 2 + 1)[:, None]) & present, n


def _lookup(selected: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """selected [N, C] bool at labels [N, ...] (False for 255 and any
    label >= C)."""
    table = torch.zeros((selected.shape[0], 256), dtype=torch.bool,
                        device=selected.device)
    table[:, :selected.shape[1]] = selected
    flat = labels.reshape(labels.shape[0], -1).clamp(0, 255).long()
    return torch.gather(table, 1, flat).reshape(labels.shape)


def class_masks(scores: torch.Tensor, labels: torch.Tensor,
                num_classes: int, patchwise: bool = False,
                patchsize: int = 128) -> torch.Tensor:
    """ClassMix's [B, H, W] float masks (1 = keep sample i) from its draw
    and labels at image resolution (generate_class_mask, l.518-542; with
    ``patchwise`` generate_patchwise_class_mask, l.491-515: each
    super-patch selects half of ITS classes, none where it has <= 1, and
    keeps its 255 pixels)."""
    if not patchwise:
        selected, _ = _selected_classes(labels.flatten(1), scores,
                                        num_classes)
        return _lookup(selected, labels).float()
    b, h, w = labels.shape
    gh, gw = h // patchsize, w // patchsize
    patches = labels.reshape(b, gh, patchsize, gw, patchsize).permute(
        0, 1, 3, 2, 4).reshape(b * gh * gw, patchsize * patchsize)
    selected, n = _selected_classes(patches, scores.reshape(b * gh * gw, -1),
                                    num_classes)
    selected = selected & (n > 1)[:, None]
    masks = _lookup(selected, patches) | (patches == 255)
    return masks.float().reshape(b, gh, gw, patchsize, patchsize).permute(
        0, 1, 3, 2, 4).reshape(b, h, w)


def classmix_with_scores(scores: torch.Tensor, imgs: torch.Tensor,
                         labels: torch.Tensor, num_classes: int,
                         patchwise: bool = False, patchsize: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ClassMix (generate_unsup_classmix_data, l.665-704) from its draw:
    sample i keeps the pixels of its selected classes and takes the rest
    from sample (i+1) % B."""
    img_hw = tuple(imgs.shape[1:3])
    label_hw = tuple(labels.shape[1:])
    full = _labels_at(labels, img_hw)
    masks = class_masks(scores, full, num_classes, patchwise, patchsize)
    nxt = torch.roll(torch.arange(imgs.shape[0], device=imgs.device), -1)
    m4 = masks[..., None].to(imgs.dtype)
    new_imgs = imgs * m4 + imgs[nxt] * (1.0 - m4)
    new_labels = torch.where(masks > 0.5, full, full[nxt])
    return new_imgs, _labels_at(new_labels, label_hw).to(labels.dtype)


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
    perms = shuffle_perms(generator, b, (h // s) * (w // s), patchmix_ratio,
                          imgs.device)
    return apply_patch_perm(imgs, perms, patchmix_n, patch_size), perms


def shuffle_perms(generator: Optional[torch.Generator], b: int, gg: int,
                  patchmix_ratio: float = 0.5, device=None) -> torch.Tensor:
    """PatchShuffle's draw: [B, gg] int32, each row a uniform random
    permutation with probability ``patchmix_ratio``, else the identity."""
    gates = torch.rand((b,), generator=generator,
                       device=device) < patchmix_ratio
    perms = torch.argsort(torch.rand((b, gg), generator=generator,
                                     device=device), dim=1)
    identity = torch.arange(gg, device=device).expand(b, gg)
    return torch.where(gates[:, None], perms, identity).to(torch.int32)


def mix_with_labeled(imgs: torch.Tensor, labels: torch.Tensor,
                     sup_imgs: torch.Tensor, sup_labels: torch.Tensor,
                     conf_mask: torch.Tensor, patch_size: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace each patch_size² patch with no confident pixel by the
    labeled sample's content (encoder_decoder.py:584-594,
    generate_mix_with_labeled_data l.545-578)."""
    b, h, w, _ = imgs.shape
    ph, pw = h // patch_size, w // patch_size
    conf = conf_mask.float().reshape(b, ph, patch_size, pw, patch_size)
    take = (conf.sum(dim=(2, 4)) == 0).float()
    mask = take.repeat_interleave(patch_size, 1).repeat_interleave(
        patch_size, 2)
    m4 = mask[..., None].to(imgs.dtype)
    new_imgs = sup_imgs * m4 + imgs * (1.0 - m4)
    new_labels = torch.where(mask > 0.5, sup_labels, labels)
    return new_imgs, new_labels.to(labels.dtype)


def beta_draw(generator: Optional[torch.Generator], a: int, b: int,
              device=None) -> torch.Tensor:
    """One Beta(a, b) sample for integer a, b as the a-th smallest of
    a + b - 1 uniforms (its order-statistic law): torch's Beta sampler takes
    no generator."""
    u = torch.rand((a + b - 1,), generator=generator, device=device)
    return torch.sort(u).values[a - 1]


def adaptive_draws(generator: Optional[torch.Generator], b: int,
                   hw: Tuple[int, int],
                   device=None) -> Dict[str, torch.Tensor]:
    """Adaptive CutMix's draws (cut_mix_label_adaptive, l.608-663): a
    permutation of the batch, lam_l ~ Beta(8, 2) and lam_u ~ Beta(4, 4),
    box centres per sample for the labeled paste (cx_l, cy_l) and the
    unlabeled one (cx_u, cy_u), uniform in [size // 8, size), and the paste
    gate's uniforms u."""
    h, w = hw

    def centre(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator,
                             device=device)
    return {'perm': torch.randperm(b, generator=generator, device=device),
            'lam_l': beta_draw(generator, 8, 2, device),
            'lam_u': beta_draw(generator, 4, 4, device),
            'cx_l': centre(w // 8, w), 'cy_l': centre(h // 8, h),
            'cx_u': centre(w // 8, w), 'cy_u': centre(h // 8, h),
            'u': torch.rand((b,), generator=generator, device=device)}


def _adaptive_box(lam: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  b: int, hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W] bool box of side (size * sqrt(1 - lam)) // 1 around
    (cx, cy), clipped. As the reference (and JAX), the x-box indexes rows
    and the y-box columns."""
    h, w = hw
    cut_rat = torch.sqrt(1.0 - lam.float())
    cut_w = (w * cut_rat).to(torch.int64)
    cut_h = (h * cut_rat).to(torch.int64)
    x1 = (cx - cut_w // 2).clamp(0, w)
    y1 = (cy - cut_h // 2).clamp(0, h)
    x2 = (cx + cut_w // 2).clamp(0, w)
    y2 = (cy + cut_h // 2).clamp(0, h)
    ys = torch.arange(h, device=cx.device)[None, :, None]
    xs = torch.arange(w, device=cx.device)[None, None, :]
    return ((ys >= x1[:, None, None]) & (ys < x2[:, None, None]) &
            (xs >= y1[:, None, None]) & (xs < y2[:, None, None]))


def cutmix_label_adaptive(draws: Dict[str, torch.Tensor],
                          unlabeled_imgs: torch.Tensor,
                          hard_labels: torch.Tensor, max_probs: torch.Tensor,
                          sup_imgs: torch.Tensor, sup_labels: torch.Tensor,
                          confidences: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """AugSeg-style confidence-adaptive CutMix from its draws
    (cut_mix_label_adaptive, l.608-663): a sample whose uniform exceeds its
    confidence [B] gets a labeled box pasted (labels 1.0 confident), then
    every sample takes a box from the permuted mix. Returns (images,
    labels, probabilities)."""
    b, h, w, _ = unlabeled_imgs.shape
    perm = draws['perm'].long()
    inside_l = _adaptive_box(draws['lam_l'], draws['cx_l'], draws['cy_l'],
                             b, (h, w))
    inside_u = _adaptive_box(draws['lam_u'], draws['cx_u'], draws['cy_u'],
                             b, (h, w))
    paste = inside_l & (draws['u'] > confidences)[:, None, None]
    mix_imgs = torch.where(paste[..., None], sup_imgs[perm], unlabeled_imgs)
    mix_labels = torch.where(paste, sup_labels[perm].to(hard_labels.dtype),
                             hard_labels)
    mix_probs = torch.where(paste, torch.ones_like(max_probs), max_probs)
    out_imgs = torch.where(inside_u[..., None], mix_imgs[perm],
                           unlabeled_imgs)
    out_labels = torch.where(inside_u, mix_labels[perm], hard_labels)
    out_probs = torch.where(inside_u, mix_probs[perm], max_probs)
    return out_imgs, out_labels.to(hard_labels.dtype), out_probs
