"""The S4Former semi-supervised training step (counterpart of
``s4former_tpu/semi/train_step.py``; reference:
mmseg/models/segmentors/encoder_decoder.py:386-935 plus mmcv's
OptimizerHook and PolyLR).

``make_semi_train_step(model, semi_cfg, num_classes, ...)`` returns
``train_step(state, batch, generator) -> (state, logs)``. In the JAX step's
order: EMA update before any forward (with ``momentum_head_dropout``, each
decode-head parameter skipped with that probability); the supervised mixes
(``sup_cutmix``, ``sup_ClassMix``); teacher forward in eval mode,
pseudo-labels and ``mask_ratio``; the PASA bias; the strong-mix cascade
(``apply_strong_mixes``: ``mix_with_labeled``, CutMix, CutOut, ClassMix,
adaptive CutMix, PatchShuffle, PatchShuffle with CutMix or ClassMix); the
EMA teacher on the weak labeled images for supervised NCR ('sup_only',
'both') and ``sup_ema``; the supervised pass (main and aux CE,
``decode.acc_seg``), the supervised NCR pass and the ``sup_ema`` loss; the
unsup losses, either as one fused 2B forward (the PASA half carries the
bias, the mixed half zeros; the default ``fuse_unsup_passes=True``) or as
the sequential passes (PASA, with fdrop under ``attn_mask_w_fdrop``; the
fdrop pass under ``use_fdrop``; the final pass), which fdrop and a MiT
always take; or, under ``unimatch`` with a mix stream in the batch, the
UniMatch branch (``semi/unimatch.py``) ahead of both; the sum of the
entries whose key contains 'loss'; autograd; poly LR with the head x10
multiplier, the layer-wise decay when
``paramwise_cfg`` is given, and torch SGD with momentum; the annealed EMA
momentum for the next step. A ``CascadeEncoderDecoder``'s earlier stages
train as aux heads ahead of the real ones, every stage takes the head x10
('head' is in ``decode_head.{i}.``, as in JAX's ``cascade_heads_{i}``),
and the EMA lerps the stages with the plain momentum, as JAX's, whose
head group ``decode_head_m`` a cascade does not have. ``batch`` holds NHWC device tensors under the
JAX keys (``sup_img``, ``sup_gt``, ``unsup_teacher_img``,
``unsup_student_img``) and optionally ``dbg_``-prefixed fixed draws that
replace a mix's sampled draw and gate (keys in ``apply_strong_mixes`` and
``sup_mixes``) or the EMA head skips (``dbg_ema_head_skip``, [n] bool in
``decode_head.named_parameters()`` order): parity tests and
``chip_smoke.py`` only; the JAX step reads only ``dbg_cutmix_mask`` and
``dbg_patchmix_perm``. UniMatch (JAX train_step.py:331, 404-411,
492-528) runs when ``unimatch`` is set and the batch holds
``unsup_teacher_mix_img`` (with ``unsup_student_2_img``,
``unsup_student_mix_img`` and ``unsup_student_2_mix_img``); without the
mix stream ``unimatch`` takes the normal branch, as in JAX. The teacher
then also labels the mix-source view, the strong-mix cascade is skipped,
and the unsup passes are always sequential: head 1 (PASA with its bias, or
fdrop), then the two mixed streams; its draws take the overrides
``dbg_um_cutmix_mask_{1,2}`` and ``dbg_um_patchmix_perm_{1,2}``, the keys
the JAX step reads.

With a MiT backbone (JAX train_step.py:286-288, 376-390, 527-529) the PASA
input is the raw unconfidence map ``1 - conf_mask`` lifted to image
resolution (nearest), which the MiT pools per stage; its "no bias" is not
a zero tensor, so a MiT never takes the fused 2B pass. The step's
generator goes to every student forward, where the models draw their
dropout, drop path and fdrop (the JAX step's ``rngs={'dropout': ...,
'fdrop': ...}``). The JAX step hands its PASA and fdrop passes one fdrop
key, so their masks coincide there; here each pass draws its own, as the
reference's ``Dropout2d`` does.

The step makes no host round-trip: logs stay device tensors, and the mix
gates and EMA skips are ``torch.where``s on the device. The student
module, its SGD buffers and the EMA teacher (a second copy of the module)
are updated in place; the returned state holds them with the next step
counter.

Data parallelism (``parallel/``; JAX: the same jitted step on a batch
sharded over the ``data`` axis): in a process group each data index passes
its contiguous block of the global batch, and the step computes the
single-process step on the global batch. Under tensor parallelism
(``state.plan``, ``parallel/tp.py``) the ranks of a model group pass the
same block, each holding its pieces of the split weights; every data-axis
collective below runs over the data group, so a share is counted once. Every rank seeds its generator
alike; draws with a batch axis are made at the global batch and the rank
keeps its rows; the strong-mix cascade and the supervised mixes, which
pair sample i with i+1 (CutMix, ClassMix) or with any sample (adaptive
CutMix), run on the global batch gathered from the blocks; losses are
each rank's share of the global loss, BN is synced, ``mask_ratio`` and
the annealed momentum are global; the gradients are summed over the
ranks before the clip and the update, and every log is a global value.
``dbg_`` overrides are given at the global batch.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from s4former_tpu_torch.core.checkpoint import train_state_dicts_from_jax
from s4former_tpu_torch.core.optim import (build_layer_decay_trees,
                                           build_lr_mult_tree,
                                           clip_grads_by_norm, poly_lr,
                                           sgd_init, sgd_update)
from s4former_tpu_torch.models.losses.cross_entropy import accuracy
from s4former_tpu_torch.models.backbones.mit import MixVisionTransformer
from s4former_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from s4former_tpu_torch.parallel.distributed import data_size
from s4former_tpu_torch.parallel.mesh import (all_reduce_grads,
                                              broadcast_from_model,
                                              gather_rows, global_sum,
                                              local_rows, stacked_batches)
from s4former_tpu_torch.parallel.tp import ShardPlan
from s4former_tpu_torch.registry import LOSSES
from s4former_tpu_torch.semi import mixes
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.ema import ema_update_scoped, head_skip_draw
from s4former_tpu_torch.semi.ncr import ncr_loss
from s4former_tpu_torch.semi.pasa import (pasa_bias_from_conf_mask,
                                          require_cls_token)
from s4former_tpu_torch.semi.pseudo import (extract_teacher_info, mask_ratio,
                                            pseudo_ce_loss,
                                            soft_pseudo_ce_loss)
from s4former_tpu_torch.semi.unimatch import (unimatch_draws,
                                              unimatch_unsup_losses)

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
    # the tensor-parallel / ZeRO-3 split of the tensors above
    # (parallel.tp.shard_state); None: each rank holds them whole
    plan: Optional[ShardPlan] = None


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
    """Loss callables from the heads' ``loss_decode`` configs: the main
    head's, then the aux heads' in ``forward_train_heads``' order, a
    cascade's earlier stages first (JAX l.75-99)."""
    def build(head):
        return LOSSES.build(dict(head.loss_decode or
                                 {'type': 'CrossEntropyLoss'}))
    heads = list(model.decode_head) if _is_cascade(model) else \
        [model.decode_head]
    return build(heads[-1]), [build(h) for h in heads[:-1]] + \
        [build(a) for a in model.auxiliary_head]


def _is_cascade(model: nn.Module) -> bool:
    """A ``CascadeEncoderDecoder``: its stages are a ``ModuleList``."""
    return isinstance(model.decode_head, nn.ModuleList)


def _sup_losses(model, main_loss, aux_losses, img, gt, generator):
    """Supervised branch: every head against the ground truth
    (encoder_decoder.py:426-441). Returns (losses, main logits at the
    ground truth's resolution)."""
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
    return losses, main


def _gate(generator: Optional[torch.Generator], prob: float,
          device) -> Tensor:
    """0-d bool, True with probability ``prob`` (``bernoulli(key, p)``)."""
    return torch.rand((), generator=generator, device=device) < prob


def _gated(overrides: Dict[str, Tensor], key: str, generator, prob: float,
           draw: Callable[[], Tensor], apply: Callable, imgs: Tensor,
           labels: Tensor) -> Tuple[Tensor, Tensor]:
    """One gated mix of the cascade: the apply of ``draw()`` where a gate
    of probability ``prob`` opens, else the inputs. ``overrides[key]``, if
    given, replaces the draw and the gate (the mix applies)."""
    if key in overrides:
        return apply(overrides[key], imgs, labels)
    gate = _gate(generator, prob, imgs.device)
    new_imgs, new_labels = apply(draw(), imgs, labels)
    return (torch.where(gate, new_imgs, imgs),
            torch.where(gate, new_labels, labels))


def _shuffle(cfg: SemiConfig, overrides: Dict[str, Tensor], key: str,
             generator, imgs: Tensor) -> Tuple[Tensor, Tensor]:
    if key in overrides:
        perm = overrides[key]
        return mixes.apply_patch_perm(imgs, perm, cfg.PatchMix_N,
                                      cfg.patchsize), perm
    return mixes.patch_shuffle(generator, imgs, cfg.PatchMix_N,
                               cfg.patchsize, cfg.patchmix_ratio)


def apply_strong_mixes(cfg: SemiConfig, generator: Optional[torch.Generator],
                       imgs: Tensor, labels: Tensor, teacher, sup_imgs: Tensor,
                       sup_gts: Tensor, num_classes: int,
                       overrides: Optional[Dict[str, Tensor]] = None):
    """The strong-augmentation cascade on (student images, teacher labels),
    each unsup sample i paired with labeled sample i (``sup_imgs[:B]``).
    Under data parallelism the cascade runs on the global batch gathered
    from the ranks' blocks, draws included, and the rank keeps its block.
    See ``_strong_mix_cascade``. Returns (images, labels, perm or None)."""
    if cfg.use_cutmix_adaptive:
        # per-sample confidence mean((1 - normalised entropy) * max prob)
        # (:608-620) and a fresh argmax (:621-630), from the logits
        probs = torch.softmax(teacher.seg_logits, dim=-1)
        ent = -(probs * torch.log(probs + 1e-10)).sum(dim=-1)
        ent = ent / math.log(num_classes)
        adaptive = (((1.0 - ent) * teacher.max_prob).mean(dim=(1, 2)),
                    probs.argmax(dim=-1).to(teacher.hard_label.dtype),
                    teacher.max_prob)
    else:
        adaptive = None
    conf_mask = teacher.conf_mask
    if data_size() == 1:
        return _strong_mix_cascade(cfg, generator, imgs, labels, conf_mask,
                                   adaptive, sup_imgs[:imgs.shape[0]],
                                   sup_gts[:imgs.shape[0]], num_classes,
                                   overrides)
    imgs, labels = gather_rows(imgs), gather_rows(labels)
    if cfg.mix_with_labeled:
        conf_mask = gather_rows(conf_mask)
    if adaptive is not None:
        adaptive = tuple(gather_rows(x) for x in adaptive)
    if cfg.mix_with_labeled or adaptive is not None:
        sup_imgs, sup_gts = gather_rows(sup_imgs), gather_rows(sup_gts)
    b = imgs.shape[0]
    out = _strong_mix_cascade(cfg, generator, imgs, labels, conf_mask,
                              adaptive, sup_imgs[:b], sup_gts[:b],
                              num_classes, overrides)
    return tuple(None if x is None else local_rows(x) for x in out)


def _strong_mix_cascade(cfg: SemiConfig,
                        generator: Optional[torch.Generator], imgs: Tensor,
                        labels: Tensor, conf_mask: Tensor,
                        adaptive: Optional[Tuple[Tensor, Tensor, Tensor]],
                        sup_imgs: Tensor, sup_gts: Tensor, num_classes: int,
                        overrides: Optional[Dict[str, Tensor]]):
    """The strong-augmentation cascade in the JAX step's order
    (encoder_decoder.py:584-648):
    ``mix_with_labeled``; CutMix gated by ``strong_aug_prob``; CutOut and
    ClassMix gated by 0.5 (patchwise with ``patchwise``); adaptive CutMix
    on the PRE-mix images with a fresh teacher argmax, which overwrites
    what came before, as the reference does; PatchShuffle; the flagship's
    PatchShuffle + CutMix; PatchShuffle + ClassMix with super-patches of
    ``patchsize * PatchMix_N``. ``overrides`` replace a mix's draw and its
    gate, by key: [B, H, W] masks ``strong_cutmix_mask`` (use_CutMix),
    ``cutout_mask``, ``cutmix_mask`` (PatchShuffle + CutMix); [B, C]
    scores ([B, n_patches, C] patchwise) ``classmix_scores``,
    ``ps_classmix_scores``; [B, G*G] perms ``shuffle_perm``
    (use_PatchShuffle), ``patchmix_perm`` (PatchShuffle + CutMix or
    ClassMix); adaptive CutMix's draws as ``'adaptive_' + name`` of
    ``mixes.adaptive_draws``. ``conf_mask`` is the teacher's confidence
    (``mix_with_labeled``); ``adaptive`` the adaptive CutMix's per-sample
    confidence, fresh argmax and max probability. Returns (images, labels,
    perm or None)."""
    overrides = overrides or {}
    b, h, w, _ = imgs.shape
    dev = imgs.device
    perm = None
    raw_imgs = imgs
    ps = cfg.patchsize * cfg.PatchMix_N

    def masks(patchwise=cfg.patchwise):
        return lambda: mixes.mix_masks(generator, b, (h, w), cfg.cutout_area,
                                       patchwise, ps, dev)

    def scores(patchsize):
        return lambda: mixes.class_scores(generator, b, num_classes, (h, w),
                                          cfg.patchwise, patchsize, dev)

    def classmix(patchsize):
        return lambda sc, i, lab: mixes.classmix_with_scores(
            sc, i, lab, num_classes, cfg.patchwise, patchsize)

    if cfg.mix_with_labeled:
        imgs, labels = mixes.mix_with_labeled(
            imgs, labels, sup_imgs, sup_gts, conf_mask, cfg.patchsize)
    if cfg.use_CutMix:
        imgs, labels = _gated(overrides, 'strong_cutmix_mask', generator,
                              cfg.strong_aug_prob, masks(),
                              mixes.cutmix_with_masks, imgs, labels)
    if cfg.use_CutOut:
        imgs, labels = _gated(overrides, 'cutout_mask', generator, 0.5,
                              masks(), mixes.cutout_with_masks, imgs, labels)
    if cfg.use_ClassMix:
        # the JAX step passes no patchsize here: classmix's default, 128
        imgs, labels = _gated(overrides, 'classmix_scores', generator, 0.5,
                              scores(128), classmix(128), imgs, labels)
    if adaptive is not None:
        # the PRE-mix images with the fresh argmax (:621-630)
        confidence, fresh, max_prob = adaptive
        draws = {k: overrides['adaptive_' + k] for k in
                 ('perm', 'lam_l', 'lam_u', 'cx_l', 'cy_l', 'cx_u', 'cy_u',
                  'u')} if 'adaptive_perm' in overrides else \
            mixes.adaptive_draws(generator, b, (h, w), dev)
        imgs, new_labels, new_probs = mixes.cutmix_label_adaptive(
            draws, raw_imgs, fresh, max_prob, sup_imgs, sup_gts,
            confidence)
        labels = torch.where(new_probs < cfg.unsup_confidence,
                             torch.full_like(new_labels, 255), new_labels)
    if cfg.use_PatchShuffle:
        imgs, perm = _shuffle(cfg, overrides, 'shuffle_perm', generator,
                              imgs)
    if cfg.use_PatchShuffle_w_Cutmix:
        imgs, labels = _gated(overrides, 'cutmix_mask', generator,
                              cfg.strong_aug_prob, masks(patchwise=False),
                              mixes.cutmix_with_masks, imgs, labels)
        imgs, perm = _shuffle(cfg, overrides, 'patchmix_perm', generator,
                              imgs)
    if cfg.use_PatchShuffle_w_Classmix:
        # the reference passes patchsize=16*PatchMix_N here (:644-648)
        imgs, labels = _gated(overrides, 'ps_classmix_scores', generator,
                              0.5, scores(ps), classmix(ps), imgs, labels)
        imgs, perm = _shuffle(cfg, overrides, 'patchmix_perm', generator,
                              imgs)
    return imgs, labels, perm


def sup_mixes(cfg: SemiConfig, generator: Optional[torch.Generator],
              img: Tensor, gt: Tensor, num_classes: int,
              overrides: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
    """The supervised mixes (encoder_decoder.py:429-434): ``sup_cutmix``
    (box, ratio 2, gated by ``strong_aug_prob``; override
    ``sup_cutmix_mask``), else ``sup_ClassMix`` (gated by 0.5; override
    ``sup_classmix_scores``). Under data parallelism they run on the
    global batch and the rank keeps its block."""
    if not (cfg.sup_cutmix or cfg.sup_ClassMix):
        return img, gt
    if data_size() > 1:
        img, gt = _sup_mixes(cfg, generator, gather_rows(img),
                             gather_rows(gt), num_classes, overrides)
        return local_rows(img), local_rows(gt)
    return _sup_mixes(cfg, generator, img, gt, num_classes, overrides)


def _sup_mixes(cfg, generator, img, gt, num_classes, overrides):
    b, h, w, _ = img.shape
    if cfg.sup_cutmix:
        return _gated(overrides, 'sup_cutmix_mask', generator,
                      cfg.strong_aug_prob,
                      lambda: mixes.random_box_mask(generator, b, (h, w),
                                                    2.0, img.device),
                      mixes.cutmix_with_masks, img, gt)
    if cfg.sup_ClassMix:
        return _gated(overrides, 'sup_classmix_scores', generator, 0.5,
                      lambda: mixes.class_scores(generator, b, num_classes,
                                                 (h, w), device=img.device),
                      lambda sc, i, lab: mixes.classmix_with_scores(
                          sc, i, lab, num_classes), img, gt)
    return img, gt


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
    ``generator`` draws the mixes' randomness on the batch's device, the
    EMA head skips, and the student forwards' dropout, drop path and fdrop.
    ``paramwise_cfg`` ``{num_layers, decay_rate[, decay_type]}`` turns on
    the layer-wise LR decay, composed with ``custom_keys``."""
    cfg = semi_cfg
    main_loss, aux_losses = _head_loss_fns(model)
    if custom_keys is None:
        custom_keys = {'head': 10.0}
    ncr_unsup = (cfg.negative_class_ranking and
                 cfg.negative_class_ranking_mode != 'sup_only')
    ncr_sup = (cfg.negative_class_ranking and
               cfg.negative_class_ranking_mode in ('sup_only', 'both'))
    mit = isinstance(model.backbone, MixVisionTransformer)
    anneal = cfg.momentum_head_exp != 0 or cfg.momentum_exp != 0
    fdrop = cfg.use_fdrop or cfg.attn_mask_w_fdrop
    # the fused 2B pass needs a zero "no bias" and no fdrop pass
    # (JAX train_step.py:527-529)
    fused = (cfg.fuse_unsup_passes and cfg.attn_mask_seperate_head and
             not fdrop and not mit)
    if (cfg.attn_mask_seperate_head or cfg.use_attn_mask_inline) and not mit:
        require_cls_token(model.backbone, 'PASA (attn_mask_seperate_head or '
                          'use_attn_mask_inline)')
    params0 = dict(model.named_parameters())
    lr_mults = build_lr_mult_tree(params0, custom_keys)
    wd_mults = None
    if paramwise_cfg is not None:
        ld_mults, wd_mults = build_layer_decay_trees(
            params0, {n: p.dim() for n, p in params0.items()},
            paramwise_cfg['num_layers'], paramwise_cfg['decay_rate'],
            paramwise_cfg.get('decay_type', 'layer_wise'), mit=mit)
        lr_mults = {n: m * ld_mults[n] for n, m in lr_mults.items()}
    # JAX names a cascade's stages cascade_heads_{i}, outside the EMA's
    # decode_head_m group (JAX semi/ema.py:76-88): they lerp with the
    # plain momentum and skip no parameter
    cascade = _is_cascade(model)
    head_params = [] if cascade else [
        'decode_head.' + n for n, _ in model.decode_head.named_parameters()]

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        model = state.model
        logs: Dict[str, Tensor] = {}
        overrides = {key[4:]: v for key, v in batch.items()
                     if key.startswith('dbg_')}

        # ---- 1. EMA update BEFORE the forwards (encoder_decoder.py:416-423)
        if cfg.ema:
            m_backbone = cfg.effective_momentum_backbone
            m_head = cfg.effective_momentum_head
            if anneal and state.annealed_momentum is not None:
                # the previous step's mask_ratio**exp (:926-932)
                m_head = state.annealed_momentum
                if cfg.momentum_exp != 0:
                    m_backbone = state.annealed_momentum
            if cascade:
                m_head = cfg.ema_momentum
            head_skips = None
            if cfg.momentum_head_dropout > 0:
                skips = overrides.get('ema_head_skip')
                if skips is None:
                    skips = head_skip_draw(generator, len(head_params),
                                           cfg.momentum_head_dropout,
                                           state.step.device)
                head_skips = dict(zip(head_params, skips.bool()))
            ema_update_scoped(state.ema_model.state_dict(),
                              model.state_dict(), m_backbone, m_head,
                              cfg.ema_momentum, head_skips)

        has_unsup = 'unsup_teacher_img' in batch and cfg.unsup_weight != 0
        has_unimatch = cfg.unimatch and 'unsup_teacher_mix_img' in batch
        # supervised mixes, before the unsup branch, whose labeled mixes
        # take the mixed images and labels (:429-434, :488)
        sup_img, sup_gt = sup_mixes(cfg, generator, batch['sup_img'],
                                    batch['sup_gt'], num_classes, overrides)
        # a strong labeled view, if the batch has one, feeds the
        # supervised NCR pass and the unsup mixes (:451, :490-492)
        sup_student_img = batch.get('sup_student_img', sup_img)

        # ---- 2. teacher pseudo-labels (no grad, eval mode; :516-542)
        teacher = pasa_bias = mixed_imgs = mixed_labels = perm = None
        teacher_mix = new_annealed = None
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
            if has_unimatch:
                # the mix-source view's labels (UniMatch: no strong-mix
                # cascade)
                with torch.no_grad():
                    t_mix_logits = t_model.forward_decode_from_img(
                        batch['unsup_teacher_mix_img'], train=False)
                teacher_mix = extract_teacher_info(
                    t_mix_logits, cfg.unsup_confidence,
                    cfg.unsup_temperature, cfg.unsup_soft)
            else:
                # global sizes: every rank holds an equal block
                bu_all = bu * data_size()
                bs_all = sup_student_img.shape[0] * data_size()
                if bu_all > bs_all:
                    raise ValueError(
                        f'unsup batch ({bu_all}) > sup batch ({bs_all}): '
                        f'the strong mixes pair each unsup sample with a '
                        f'labeled one')
                mixed_imgs, mixed_labels, perm = apply_strong_mixes(
                    cfg, generator, batch['unsup_student_img'],
                    teacher.hard_label, teacher, sup_student_img, sup_gt,
                    num_classes, overrides)

        # ---- 2b. the EMA teacher on the WEAK (unmixed) labeled images,
        # shared by supervised NCR (:447-449) and sup_ema (:477-480)
        sup_ema_logits = None
        if ncr_sup or cfg.sup_ema:
            e_model = state.ema_model if cfg.ema else model
            with torch.no_grad():
                sup_ema_logits = e_model.forward_decode_from_img(
                    batch['sup_img'], train=False)

        # ---- 3. differentiable student losses
        losses, sup_main = _sup_losses(model, main_loss, aux_losses, sup_img,
                                       sup_gt, generator)
        if ncr_sup:
            # the student on the strong labeled view vs the EMA on the weak
            # one, ranked against the unmixed labels ('sup' mode, :443-474)
            s_logits = model.forward_decode_from_img(
                sup_student_img, train=True, generator=generator)
            t_logits = sup_ema_logits
            img_hw = tuple(sup_student_img.shape[1:3])
            if tuple(s_logits.shape[1:3]) != img_hw:
                s_logits = resize_bilinear(s_logits, img_hw, False)
                t_logits = resize_bilinear(t_logits, img_hw, False)
            losses['loss_ncr_sup'] = ncr_loss(s_logits, t_logits,
                                              batch['sup_gt'], num_classes,
                                              'sup')
        if cfg.sup_ema:
            # the EMA's argmax (softmax nearest-resized to the labels) as
            # labels of the supervised pass's main logits (:476-487)
            ema_probs = torch.softmax(sup_ema_logits.float(), dim=-1)
            gt_hw = tuple(sup_gt.shape[1:3])
            if tuple(ema_probs.shape[1:3]) != gt_hw:
                ema_probs = resize_nearest(ema_probs, gt_hw)
            losses['loss_decode_sup_ema'] = main_loss(
                sup_main, ema_probs.argmax(dim=-1).to(torch.int32))
        if has_unsup and has_unimatch:
            def apply_decode(img, attn_bias=None, use_fdrop=False,
                             patchmix_perm=None, patchmix_n=0):
                return model.forward_decode_from_img(
                    img, train=True, attn_bias=attn_bias,
                    pos_mode=cfg.pos_mode, use_fdrop=use_fdrop,
                    patchmix_perm=patchmix_perm, patchmix_n=patchmix_n,
                    generator=generator)
            student_img = batch['unsup_student_img']
            # drawn at the global batch; the rank keeps its rows
            draws = unimatch_draws(cfg, generator, bu * data_size(),
                                   tuple(student_img.shape[1:3]),
                                   student_img.device, overrides)
            for d in draws.values():
                d['mask'] = local_rows(d['mask'])
                if d['perm'] is not None:
                    d['perm'] = local_rows(d['perm'])
            unsup = unimatch_unsup_losses(cfg, draws, batch, teacher,
                                          teacher_mix, pasa_bias,
                                          apply_decode, num_classes)
        elif has_unsup:
            unsup: Dict[str, Tensor] = {}
            student_img = batch['unsup_student_img']
            if fused:
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
                with stacked_batches(2):
                    logits2 = model.forward_decode_from_img(
                        imgs2, train=True, attn_bias=bias2,
                        pos_mode=cfg.pos_mode, patchmix_perm=perm2,
                        patchmix_n=n2, generator=generator)
                pasa_logits, stu_logits = logits2[:bu], logits2[bu:]
            else:
                if cfg.attn_mask_seperate_head:
                    pasa_logits = model.forward_decode_from_img(
                        student_img, train=True, attn_bias=pasa_bias,
                        pos_mode=cfg.pos_mode,
                        use_fdrop=cfg.attn_mask_w_fdrop, generator=generator)
                if cfg.use_fdrop:
                    fdrop_logits = model.forward_decode_from_img(
                        student_img, train=True, pos_mode=cfg.pos_mode,
                        use_fdrop=True, generator=generator)
                    unsup['loss_seg_unsup_fdrop'] = 0.5 * pseudo_ce_loss(
                        fdrop_logits, teacher.hard_label)
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
            halved = cfg.use_fdrop or cfg.attn_mask_seperate_head
            unsup['loss_seg_unsup'] = main_pseudo * (
                cfg.fdrop_loss_weight if halved else 1.0)
            if ncr_unsup:
                unsup['loss_ncr_unsup'] = (0.5 if halved else 1.0) * \
                    ncr_loss(stu_logits, teacher.seg_logits, mixed_labels,
                             num_classes, cfg.negative_class_ranking_mode)
        if has_unsup:
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
        # each data index's total is its share of the global loss; the
        # ZeRO-3 shards' backward has summed theirs already
        plan = state.plan
        grads = all_reduce_grads(grads, plan.zero3_names() if plan else ())
        if plan is not None:
            # the whole tensors' gradients, bit for bit alike on the model
            # ranks (their atomic adds sum in a run-dependent order)
            split = set(plan.split_names())
            grads = broadcast_from_model(
                grads, [n for n in grads if n not in split])
        if grad_clip_norm is not None:
            grads = clip_grads_by_norm(
                grads, grad_clip_norm, plan.grad_sq_sum if plan else None)

        # ---- 4. SGD + poly LR
        lr = poly_lr(state.step, base_lr, max_iters, power, min_lr)
        sgd_update(params, grads, state.momentum, lr, lr_mults, sgd_momentum,
                   weight_decay, wd_mults)

        logs.update({key: v.detach() for key, v in losses.items()})
        logs['loss'] = total.detach()
        # the losses are shares of the global losses: their global sums in
        # one all-reduce (the reference's _parse_losses, base.py:259-276)
        shares = [key for key in logs if 'loss' in key]
        logs.update(zip(shares, global_sum(torch.stack(
            [logs[key] for key in shares])).unbind()))
        logs['lr'] = lr
        annealed = new_annealed if (cfg.ema and anneal and has_unsup) \
            else state.annealed_momentum
        return dataclasses.replace(state, step=state.step + 1,
                                   annealed_momentum=annealed), logs

    return train_step
