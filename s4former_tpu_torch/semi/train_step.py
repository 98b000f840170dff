"""The S4Former semi-supervised training step (counterpart of
``s4former_tpu/semi/train_step.py``; reference:
mmseg/models/segmentors/encoder_decoder.py:386-935 plus mmcv's
OptimizerHook and PolyLR).

``make_semi_train_step(model, semi_cfg, num_classes, ...)`` returns
``train_step(state, batch, generator) -> (state, logs)``. In the JAX step's
order: EMA update before any forward; teacher forward in eval mode,
pseudo-labels and ``mask_ratio``; the PASA bias; the strong mixes (gated
CutMix then PatchShuffle); the supervised pass (main and aux CE,
``decode.acc_seg``); the unsup losses, either as one fused 2B forward (the
PASA half carries the bias, the mixed half zeros; the default
``fuse_unsup_passes=True``) or as the sequential passes; the sum of the
entries whose key contains 'loss'; autograd; poly LR with the head x10
multiplier and torch SGD with momentum; the annealed EMA momentum for the
next step. ``batch`` holds NHWC device tensors under the JAX keys
(``sup_img``, ``sup_gt``, ``unsup_teacher_img``, ``unsup_student_img``) and
optionally ``dbg_cutmix_mask`` / ``dbg_patchmix_perm``, fixed randomness
that replaces the sampled CutMix box and PatchShuffle (parity tests only).

With a MiT backbone (JAX train_step.py:286-288, 376-390, 527-529) the PASA
input is the raw unconfidence map ``1 - conf_mask`` lifted to image
resolution (nearest), which the MiT pools per stage; its "no bias" is not
a zero tensor, so a MiT never takes the fused 2B pass: it runs the
sequential passes (sup, PASA on the unmixed strong images, the final pass
on the mixed images with PatchShuffle undone). The step's generator goes
to every student forward, where the MiT's drop path and the SegFormer
head's dropout draw from it (the JAX step's ``rngs={'dropout': ...}``).

The step makes no host round-trip: logs stay device tensors, and the mix
gates are ``torch.where``s on the device. The student module, its SGD
buffers and the EMA teacher (a second copy of the module) are updated in
place; the returned state holds them with the next step counter.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: UniMatch, fdrop (``use_fdrop``, ``attn_mask_w_fdrop``), the other
strong mixes (``use_CutMix``, ``use_CutOut``, ``use_ClassMix``,
``use_PatchShuffle``, ``use_PatchShuffle_w_Classmix``,
``mix_with_labeled``, ``use_cutmix_adaptive``), the supervised mixes
(``sup_cutmix``, ``sup_ClassMix``), supervised NCR (modes 'sup_only' and
'both'), ``sup_ema``, ``momentum_head_dropout`` and the layer-wise LR decay
(``paramwise_cfg``); the ViT's and the SETR head's train-mode dropout and
drop-path raise in the models.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from s4former_tpu_torch.core.checkpoint import train_state_dicts_from_jax
from s4former_tpu_torch.core.optim import (build_lr_mult_tree,
                                           clip_grads_by_norm, poly_lr,
                                           sgd_init, sgd_update)
from s4former_tpu_torch.models.losses.cross_entropy import accuracy
from s4former_tpu_torch.models.backbones.mit import MixVisionTransformer
from s4former_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from s4former_tpu_torch.registry import LOSSES
from s4former_tpu_torch.semi import mixes
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.ema import ema_update_scoped
from s4former_tpu_torch.semi.ncr import ncr_loss
from s4former_tpu_torch.semi.pasa import pasa_bias_from_conf_mask
from s4former_tpu_torch.semi.pseudo import (extract_teacher_info, mask_ratio,
                                            pseudo_ce_loss,
                                            soft_pseudo_ce_loss)

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """Everything that evolves across steps."""
    step: Tensor                              # 0-d int64 on the device
    model: nn.Module                          # the student (params + BN)
    momentum: Dict[str, Tensor]               # SGD buffers by param name
    ema_model: Optional[nn.Module] = None     # the mean teacher
    # mask-ratio-annealed EMA momentum (encoder_decoder.py:926-932); None
    # unless momentum_head_exp / momentum_exp is set
    annealed_momentum: Optional[Tensor] = None


def create_train_state(model: nn.Module, ema: bool = False) -> TrainState:
    """The state of a fresh run: step 0, zero SGD buffers and, with ``ema``,
    a teacher that starts as a copy of the student."""
    device = next(model.parameters()).device
    ema_model = copy.deepcopy(model).requires_grad_(False) if ema else None
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device), model=model,
        momentum=sgd_init(dict(model.named_parameters())),
        ema_model=ema_model)


def train_state_from_jax(model: nn.Module, jax_state) -> TrainState:
    """The port's state from a JAX ``TrainState`` through the weight bridge:
    ``model`` (the student, on its device) is loaded in place."""
    sds = train_state_dicts_from_jax(jax_state)
    model.load_state_dict(sds['model'])
    state = create_train_state(model, ema=sds['ema'] is not None)
    if state.ema_model is not None:
        state.ema_model.load_state_dict(sds['ema'])
    device = state.step.device
    for name, buf in state.momentum.items():
        buf.copy_(sds['momentum'][name])
    state.step.fill_(int(np.asarray(jax_state.step)))
    if jax_state.annealed_momentum is not None:
        state.annealed_momentum = torch.tensor(
            float(np.asarray(jax_state.annealed_momentum)),
            dtype=torch.float32, device=device)
    return state


def _head_loss_fns(model: nn.Module) -> Tuple[Callable, List[Callable]]:
    """Loss callables from the heads' ``loss_decode`` configs."""
    def build(head):
        return LOSSES.build(dict(head.loss_decode or
                                 {'type': 'CrossEntropyLoss'}))
    return build(model.decode_head), [build(a) for a in model.auxiliary_head]


def _sup_losses(model, main_loss, aux_losses, img, gt, generator):
    """Supervised branch: every head against the ground truth
    (encoder_decoder.py:426-441)."""
    main, aux = model.forward_train_heads_from_img(img, train=True,
                                                   generator=generator)
    gt_hw = tuple(gt.shape[1:3])

    def to_gt(logits):
        if tuple(logits.shape[1:3]) != gt_hw:
            return resize_bilinear(logits, gt_hw, model.align_corners)
        return logits

    main = to_gt(main)
    losses = {'decode.loss_ce': main_loss(main, gt),
              'decode.acc_seg': accuracy(main.detach(), gt)}
    for i, (a, lfn) in enumerate(zip(aux, aux_losses)):
        losses[f'aux_{i}.loss_ce'] = lfn(to_gt(a), gt)
    return losses


def apply_strong_mixes(cfg: SemiConfig, generator: Optional[torch.Generator],
                       imgs: Tensor, labels: Tensor,
                       overrides: Optional[Dict[str, Tensor]] = None):
    """The strong-augmentation cascade on (student images, teacher labels),
    flagship branch ``use_PatchShuffle_w_Cutmix`` (encoder_decoder.py:
    635-643): CutMix gated by ``strong_aug_prob``, then PatchShuffle.
    ``overrides`` ``cutmix_mask`` [B,H,W] / ``patchmix_perm`` [B,G*G]
    replace the sampled box (ungated) and the sampled shuffle. Returns
    (images, labels, perm or None)."""
    overrides = overrides or {}
    perm = None
    if cfg.use_PatchShuffle_w_Cutmix:
        if 'cutmix_mask' in overrides:
            imgs, labels = mixes.cutmix_with_masks(overrides['cutmix_mask'],
                                                   imgs, labels)
        else:
            gate = torch.rand((), generator=generator,
                              device=imgs.device) < cfg.strong_aug_prob
            new_imgs, new_labels = mixes.cutmix(generator, imgs, labels,
                                                cfg.cutout_area)
            imgs = torch.where(gate, new_imgs, imgs)
            labels = torch.where(gate, new_labels, labels)
        if 'patchmix_perm' in overrides:
            perm = overrides['patchmix_perm']
            imgs = mixes.apply_patch_perm(imgs, perm, cfg.PatchMix_N,
                                          cfg.patchsize)
        else:
            imgs, perm = mixes.patch_shuffle(generator, imgs, cfg.PatchMix_N,
                                             cfg.patchsize,
                                             cfg.patchmix_ratio)
    return imgs, labels, perm


def unported_flags(cfg: SemiConfig,
                   paramwise_cfg: Optional[Dict] = None) -> List[str]:
    """The flags of ``cfg`` this port does not run."""
    flags = {name: bool(getattr(cfg, name)) for name in (
        'unimatch', 'use_fdrop', 'attn_mask_w_fdrop', 'use_CutMix',
        'use_CutOut', 'use_ClassMix', 'use_PatchShuffle',
        'use_PatchShuffle_w_Classmix', 'mix_with_labeled',
        'use_cutmix_adaptive', 'sup_cutmix', 'sup_ClassMix', 'sup_ema',
        'momentum_head_dropout')}
    flags['negative_class_ranking_mode (supervised NCR)'] = (
        cfg.negative_class_ranking and
        cfg.negative_class_ranking_mode in ('sup_only', 'both'))
    flags['paramwise_cfg (layer-wise LR decay)'] = paramwise_cfg is not None
    return [name for name, on in flags.items() if on]


def make_semi_train_step(model: nn.Module,
                         semi_cfg: SemiConfig,
                         num_classes: int,
                         base_lr: float = 0.001,
                         max_iters: int = 80001,
                         power: float = 0.9,
                         min_lr: float = 1e-4,
                         sgd_momentum: float = 0.9,
                         weight_decay: float = 0.0,
                         custom_keys: Optional[Dict[str, float]] = None,
                         grad_clip_norm: Optional[float] = None,
                         patch_size: int = 16,
                         paramwise_cfg: Optional[Dict] = None):
    """Returns ``train_step(state, batch, generator) -> (state, logs)``.
    ``generator`` draws the mixes' randomness on the batch's device, and
    the student forwards' drop path and dropout where the model has them."""
    cfg = semi_cfg
    missing = unported_flags(cfg, paramwise_cfg)
    if missing:
        raise NotImplementedError(f'not ported yet: {", ".join(missing)}')
    main_loss, aux_losses = _head_loss_fns(model)
    if custom_keys is None:
        custom_keys = {'head': 10.0}
    ncr_unsup = (cfg.negative_class_ranking and
                 cfg.negative_class_ranking_mode != 'sup_only')
    mit = isinstance(model.backbone, MixVisionTransformer)
    anneal = cfg.momentum_head_exp != 0 or cfg.momentum_exp != 0

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        model = state.model
        logs: Dict[str, Tensor] = {}

        # ---- 1. EMA update BEFORE the forwards (encoder_decoder.py:416-423)
        if cfg.ema:
            m_backbone = cfg.effective_momentum_backbone
            m_head = cfg.effective_momentum_head
            if anneal and state.annealed_momentum is not None:
                # the previous step's mask_ratio**exp (:926-932)
                m_head = state.annealed_momentum
                if cfg.momentum_exp != 0:
                    m_backbone = state.annealed_momentum
            ema_update_scoped(state.ema_model.state_dict(),
                              model.state_dict(), m_backbone, m_head,
                              cfg.ema_momentum)

        has_unsup = 'unsup_teacher_img' in batch and cfg.unsup_weight != 0
        sup_img, sup_gt = batch['sup_img'], batch['sup_gt']
        sup_student_img = batch.get('sup_student_img', sup_img)

        # ---- 2. teacher pseudo-labels (no grad, eval mode; :516-542)
        teacher = pasa_bias = mixed_imgs = mixed_labels = perm = None
        new_annealed = None
        if has_unsup:
            t_model = state.ema_model if cfg.ema else model
            with torch.no_grad():
                t_logits = t_model.forward_decode_from_img(
                    batch['unsup_teacher_img'], train=False)
            teacher = extract_teacher_info(t_logits, cfg.unsup_confidence,
                                           cfg.unsup_temperature,
                                           cfg.unsup_soft)
            logs['mask_ratio'] = mask_ratio(teacher.conf_mask)
            if anneal:
                exp = cfg.momentum_head_exp or cfg.momentum_exp
                new_annealed = logs['mask_ratio'] ** exp
                logs['momentum_head'] = new_annealed
            if (cfg.attn_mask_seperate_head or cfg.use_attn_mask_inline) \
                    and mit:
                # the MiT pools the raw unconfidence map per stage; lift it
                # from head-output to image resolution
                pasa_bias = resize_nearest(
                    1.0 - teacher.conf_mask.float(),
                    tuple(batch['unsup_teacher_img'].shape[1:3]))
            elif cfg.attn_mask_seperate_head or cfg.use_attn_mask_inline:
                # the conf mask lives at head-output resolution; pool it to
                # the backbone's token grid
                grid_h = batch['unsup_teacher_img'].shape[1] // patch_size
                attn_ps = teacher.conf_mask.shape[1] // grid_h
                pasa_bias = pasa_bias_from_conf_mask(
                    teacher.conf_mask, attn_ps, cfg.attn_mask_weight,
                    cfg.adaptive_attn_mask)
            bu = batch['unsup_student_img'].shape[0]
            if bu > sup_student_img.shape[0]:
                raise ValueError(
                    f'unsup batch ({bu}) > sup batch '
                    f'({sup_student_img.shape[0]}): the strong mixes pair '
                    f'each unsup sample with a labeled one')
            overrides = {key[4:]: v for key, v in batch.items()
                         if key.startswith('dbg_')}
            mixed_imgs, mixed_labels, perm = apply_strong_mixes(
                cfg, generator, batch['unsup_student_img'],
                teacher.hard_label, overrides)

        # ---- 3. differentiable student losses
        losses = _sup_losses(model, main_loss, aux_losses, sup_img, sup_gt,
                             generator)
        if has_unsup:
            unsup: Dict[str, Tensor] = {}
            student_img = batch['unsup_student_img']
            if cfg.fuse_unsup_passes and cfg.attn_mask_seperate_head and \
                    not mit:
                # PASA pass (unmixed images + bias) and the final pass
                # (mixed images, PatchShuffle undo) as ONE 2B forward; per
                # sample the same maths, BN moments span the 2B batch
                bias2 = torch.cat([pasa_bias, torch.zeros_like(pasa_bias)])
                imgs2 = torch.cat([student_img, mixed_imgs])
                perm2, n2 = None, 0
                if perm is not None:
                    identity = torch.arange(
                        perm.shape[-1], device=perm.device,
                        dtype=perm.dtype).expand(bu, -1)
                    perm2, n2 = torch.cat([identity, perm]), cfg.PatchMix_N
                logits2 = model.forward_decode_from_img(
                    imgs2, train=True, attn_bias=bias2, pos_mode=cfg.pos_mode,
                    patchmix_perm=perm2, patchmix_n=n2, generator=generator)
                pasa_logits, stu_logits = logits2[:bu], logits2[bu:]
            else:
                if cfg.attn_mask_seperate_head:
                    pasa_logits = model.forward_decode_from_img(
                        student_img, train=True, attn_bias=pasa_bias,
                        pos_mode=cfg.pos_mode, generator=generator)
                inline_bias = pasa_bias if cfg.use_attn_mask_inline else None
                stu_logits = model.forward_decode_from_img(
                    mixed_imgs, train=True, attn_bias=inline_bias,
                    pos_mode=cfg.pos_mode, patchmix_perm=perm,
                    patchmix_n=cfg.PatchMix_N if perm is not None else 0,
                    generator=generator)
            if cfg.attn_mask_seperate_head:
                unsup['loss_seg_unsup_attn_mask'] = 0.5 * pseudo_ce_loss(
                    pasa_logits, teacher.hard_label)
            if cfg.unsup_soft:
                main_pseudo = soft_pseudo_ce_loss(
                    stu_logits, teacher.soft_label,
                    teacher.conf_mask if cfg.unsup_confidence != 0 else None)
            else:
                main_pseudo = pseudo_ce_loss(stu_logits, mixed_labels)
            separate = cfg.attn_mask_seperate_head
            unsup['loss_seg_unsup'] = main_pseudo * (
                cfg.fdrop_loss_weight if separate else 1.0)
            if ncr_unsup:
                unsup['loss_ncr_unsup'] = (0.5 if separate else 1.0) * \
                    ncr_loss(stu_logits, teacher.seg_logits, mixed_labels,
                             num_classes, cfg.negative_class_ranking_mode)
            # weighted by unsup_weight, gated by iter_unsup_start (:488-512)
            w = torch.tensor(cfg.unsup_weight, dtype=torch.float32,
                             device=state.step.device)
            if cfg.iter_unsup_start != 0:
                w = torch.where(state.step > cfg.iter_unsup_start, w,
                                torch.zeros_like(w))
            for key, v in unsup.items():
                losses[f'unsup.{key}'] = v * w

        total = sum(v for key, v in losses.items() if 'loss' in key)
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(total,
                                                     list(params.values()))))
        if grad_clip_norm is not None:
            grads = clip_grads_by_norm(grads, grad_clip_norm)

        # ---- 4. SGD + poly LR
        lr = poly_lr(state.step, base_lr, max_iters, power, min_lr)
        sgd_update(params, grads, state.momentum, lr,
                   build_lr_mult_tree(params, custom_keys), sgd_momentum,
                   weight_decay)

        logs.update({key: v.detach() for key, v in losses.items()})
        logs['loss'] = total.detach()
        logs['lr'] = lr
        annealed = new_annealed if (cfg.ema and anneal and has_unsup) \
            else state.annealed_momentum
        return dataclasses.replace(state, step=state.step + 1,
                                   annealed_momentum=annealed), logs

    return train_step
