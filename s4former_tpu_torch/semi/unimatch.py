"""UniMatch's dual-stream unsupervised branch (counterpart of
``s4former_tpu/semi/unimatch.py``; reference: ``foward_unsup_train_unimatch``,
mmseg/models/segmentors/encoder_decoder.py:689-830).

The teacher labels the weak view and a second, "mix-source" weak view.
Head 1 is the PASA pass on the first strong view (with its bias, under
``attn_mask_seperate_head``) or else an fdrop pass, weighted 0.5. Then two
strong streams: each is CutMixed against its own mix-source stream, image
from the mix stream and labels from the mix teacher at the same batch
index, with one gate of probability ``strong_aug_prob`` for the whole
batch and a box of area ratio ``cutout_area``; then PatchShuffled under
``use_PatchShuffle``. Each stream adds 0.25 x pseudo-CE and, with NCR,
0.25 x NCR against the teacher's logits on the UNMIXED weak view.

As in ``semi/mixes.py`` the randomness is a draw (``unimatch_draws``: the
gates, boxes and permutations from the step's ``torch.Generator``) and the
rest is deterministic given it (``cutmix_unimatch``,
``unimatch_unsup_losses``), so a test can hand the port the JAX step's
draws: overrides ``um_cutmix_mask_{1,2}`` (a box mask, which also opens
the gate, as in JAX) and ``um_patchmix_perm_{1,2}``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from s4former_tpu_torch.ops.resize import resize_nearest
from s4former_tpu_torch.semi import mixes
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.ncr import ncr_loss
from s4former_tpu_torch.semi.pseudo import TeacherInfo, pseudo_ce_loss

Tensor = torch.Tensor
# each stream's (strong view, its mix-source view) batch keys
STREAMS = {1: ('unsup_student_img', 'unsup_student_mix_img'),
           2: ('unsup_student_2_img', 'unsup_student_2_mix_img')}


def unimatch_draws(cfg: SemiConfig, generator: Optional[torch.Generator],
                   b: int, hw: Tuple[int, int], device,
                   overrides: Optional[Dict[str, Tensor]] = None
                   ) -> Dict[int, Dict[str, Optional[Tensor]]]:
    """Per stream: ``gate`` (0-d bool), ``mask`` ([B, H, W] {0,1}, 0 inside
    the box) and ``perm`` ([B, G*G] int32, or None without PatchShuffle),
    drawn in that order, stream 1 first. An override replaces its draw; an
    overridden mask opens the gate."""
    overrides = overrides or {}
    s = cfg.patchsize * cfg.PatchMix_N
    gg = (hw[0] // s) * (hw[1] // s)
    out = {}
    for idx in STREAMS:
        mask = overrides.get(f'um_cutmix_mask_{idx}')
        if mask is None:
            gate = torch.rand((), generator=generator,
                              device=device) < cfg.strong_aug_prob
            mask = mixes.random_box_mask(generator, b, hw, cfg.cutout_area,
                                         device)
        else:
            gate = torch.ones((), dtype=torch.bool, device=device)
        perm = None
        if cfg.use_PatchShuffle:
            perm = overrides.get(f'um_patchmix_perm_{idx}')
            if perm is None:
                perm = mixes.shuffle_perms(generator, b, gg,
                                           cfg.patchmix_ratio, device)
        out[idx] = {'gate': gate, 'mask': mask, 'perm': perm}
    return out


def cutmix_unimatch(masks: Tensor, imgs: Tensor, mix_imgs: Tensor,
                    labels: Tensor, mix_labels: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Where a mask is 0 take the mix stream's pixels and labels at the
    same batch index, else keep the originals. Labels at the head's
    resolution are mixed at the images' (nearest up, then back down), as
    the reference's generate_unsup_data.py:410-452."""
    img_hw = tuple(imgs.shape[1:3])
    label_hw = tuple(labels.shape[1:])
    lab, mix_lab = labels, mix_labels
    if label_hw != img_hw:
        lab = resize_nearest(labels, img_hw)
        mix_lab = resize_nearest(mix_labels, img_hw)
    m4 = masks[..., None].to(imgs.dtype)
    new_imgs = imgs * m4 + mix_imgs * (1.0 - m4)
    new_labels = torch.where(masks > 0.5, lab, mix_lab)
    if label_hw != img_hw:
        new_labels = resize_nearest(new_labels, label_hw)
    return new_imgs, new_labels.to(labels.dtype)


def unimatch_unsup_losses(cfg: SemiConfig,
                          draws: Dict[int, Dict[str, Optional[Tensor]]],
                          batch: Dict[str, Tensor], teacher: TeacherInfo,
                          teacher_mix: TeacherInfo,
                          pasa_bias: Optional[Tensor],
                          apply_decode: Callable,
                          num_classes: int) -> Dict[str, Tensor]:
    """The branch's losses, unweighted by ``unsup_weight``. ``apply_decode
    (img, attn_bias=None, use_fdrop=False, patchmix_perm=None,
    patchmix_n=0)`` is the student's training forward to decode logits;
    it is called for head 1, then stream 1, then stream 2 (the order the
    BN statistics move in)."""
    losses: Dict[str, Tensor] = {}
    student = batch['unsup_student_img']
    if cfg.attn_mask_seperate_head and pasa_bias is not None:
        logits = apply_decode(student, attn_bias=pasa_bias,
                              use_fdrop=cfg.attn_mask_w_fdrop)
        losses['loss_seg_unsup_attn_mask'] = 0.5 * pseudo_ce_loss(
            logits, teacher.hard_label)
    else:
        # the fdrop pass, whatever cfg.use_fdrop says (JAX unimatch.py:84)
        logits = apply_decode(student, use_fdrop=True)
        losses['loss_seg_unsup_fdrop'] = 0.5 * pseudo_ce_loss(
            logits, teacher.hard_label)

    ncr = cfg.negative_class_ranking and \
        cfg.negative_class_ranking_mode != 'sup_only'
    for idx, (img_key, mix_key) in STREAMS.items():
        d = draws[idx]
        imgs, labels = batch[img_key], teacher.hard_label
        mixed_imgs, mixed_labels = cutmix_unimatch(
            d['mask'], imgs, batch[mix_key], labels, teacher_mix.hard_label)
        imgs = torch.where(d['gate'], mixed_imgs, imgs)
        labels = torch.where(d['gate'], mixed_labels, labels)
        perm = d['perm']
        if perm is not None:
            imgs = mixes.apply_patch_perm(imgs, perm, cfg.PatchMix_N,
                                          cfg.patchsize)
        logits = apply_decode(imgs, patchmix_perm=perm,
                              patchmix_n=cfg.PatchMix_N if perm is not None
                              else 0)
        losses[f'loss_seg_unsup_{idx}'] = 0.25 * pseudo_ce_loss(logits,
                                                                labels)
        if ncr:
            losses[f'loss_ncr_unsup_{idx}'] = 0.25 * ncr_loss(
                logits, teacher.seg_logits, labels, num_classes,
                cfg.negative_class_ranking_mode)
    return losses
