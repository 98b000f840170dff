"""The port's S4Former training step held to the JAX step on the CPU, in
f32: a 3-step trajectory from one TrainState (through the weight bridge),
with the CutMix box and the PatchShuffle permutation injected into both
packages through the ``dbg_`` batch keys.

Constants and flags are those of tests/test_core/test_train_parity_fullflag.py
(EMA 0.99 with the annealed head momentum, PASA separate head x5 adaptive,
PatchShuffle-with-CutMix N=2, NCR unsup_only, lr 0.01 poly over 100 iters,
head x10), with one change: the confidence threshold is 0.5, not 0.1. With
5 classes every max-probability is >= 0.2, so 0.1 marks every pixel
confident and the PASA bias is all zeros; at 0.5 part of the pixels are
unconfident and the bias is live.

Tolerances: losses 1e-4 relative (f32 sums in another order, XLA vs ATen,
through 3 steps); parameters, EMA parameters, BN running statistics and SGD
buffers 1e-4 max abs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch.core.checkpoint import train_state_dicts_from_jax
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from tests._torch_port import jax_train_model, torch_train_model

B, IMG, NCLS, STEPS = 2, 64, 5, 3
STEP_KW = dict(num_classes=NCLS, base_lr=0.01, max_iters=100, power=0.9,
               min_lr=1e-4)
S4_FLAGS = dict(
    ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.5,
    attn_mask_seperate_head=True, attn_mask_weight=5.0,
    adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
    negative_class_ranking=True, negative_class_ranking_mode='unsup_only',
    momentum_head_exp=1.0)
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4


def _batches():
    rng = np.random.RandomState(11)
    return [{'sup_img': rng.randn(B, IMG, IMG, 3).astype(np.float32),
             'sup_gt': rng.randint(0, NCLS, (B, IMG, IMG)).astype(np.int32),
             'unsup_teacher_img': rng.randn(B, IMG, IMG, 3).astype(np.float32),
             'unsup_student_img': rng.randn(B, IMG, IMG, 3).astype(np.float32)}
            for _ in range(STEPS)]


def _injected(step):
    """Fixed CutMix boxes and PatchShuffle perms, different per step; one
    identity row exercises the unshuffled sample (fullflag l.266-276)."""
    masks = np.ones((B, IMG, IMG), np.float32)
    masks[0, 8 + step:40 + step, 16:48] = 0
    masks[1, 0:32, 24 + step:56 + step] = 0
    perms = np.stack([np.roll(np.arange(4), step + 1),
                      np.arange(4) if step == 1 else np.array([1, 0, 3, 2])]
                     ).astype(np.int32)
    return masks, perms


def _assert_state_close(jstate, state):
    sds = train_state_dicts_from_jax(jstate)
    pairs = [('model', state.model.state_dict()),
             ('momentum', state.momentum)]
    if state.ema_model is not None:
        pairs.append(('ema', state.ema_model.state_dict()))
    for which, ours in pairs:
        ref = sds[which]
        assert sorted(ref) == sorted(ours), which
        for name, want in ref.items():
            np.testing.assert_allclose(
                ours[name].detach().numpy(), want.numpy(), rtol=0,
                atol=STATE_ATOL, err_msg=f'{which} {name}')


@pytest.mark.parametrize('mode', ['fused', 'sequential', 'sup_only'])
def test_trajectory_matches_jax_step(mode):
    semi = mode != 'sup_only'
    flags = dict(S4_FLAGS, fuse_unsup_passes=mode == 'fused') if semi else {}
    jmodel, jstate = jax_train_model(seed=0, ema=semi)
    jstep = jax.jit(j_make_semi_train_step(jmodel, JSemiConfig(**flags),
                                           **STEP_KW))
    model = torch_train_model()
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    launches = (fa.launch_count, fa.fused_launch_count)
    for i, batch in enumerate(_batches()):
        if not semi:
            batch = {k: v for k, v in batch.items() if k.startswith('sup')}
        else:
            masks, perms = _injected(i)
            batch = dict(batch, dbg_cutmix_mask=masks,
                         dbg_patchmix_perm=perms)
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
        state, logs = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, gen)
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'step {i} {k}')
        if semi:
            # the flags did something: PASA bias live, unsup losses > 0
            assert 0.05 < float(logs['mask_ratio']) < 0.95, i
            assert float(logs['unsup.loss_ncr_unsup']) > 0, i
    assert int(state.step) == int(jstate.step) == STEPS
    assert launches == (fa.launch_count, fa.fused_launch_count)   # CPU only
    _assert_state_close(jstate, state)
    if semi:
        np.testing.assert_allclose(float(state.annealed_momentum),
                                   float(jstate.annealed_momentum),
                                   rtol=LOSS_RTOL)


def test_step_draws_mixes_from_the_generator():
    """Without the dbg_ keys the mixes are drawn from the generator: one
    seed gives one step, another seed another mix."""
    flags = dict(S4_FLAGS, strong_aug_prob=1.0, patchmix_ratio=1.0)
    _, jstate = jax_train_model(seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    losses = []
    for seed in (0, 0, 1):
        model = torch_train_model()
        state = train_state_from_jax(model, jstate)
        step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
        _, logs = step(state, batch, torch.Generator().manual_seed(seed))
        losses.append(float(logs['unsup.loss_seg_unsup']))
    assert losses[0] == losses[1] != losses[2]


def test_semi_config_copy_matches_jax():
    """The port's own SemiConfig has the JAX fields and defaults."""
    ours = {f.name: f.default for f in dataclasses.fields(SemiConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JSemiConfig)}
    assert ours == ref
    cfg = dict(ema=True, avg_pos_emd=True, momentum_head=0.5, nonsense=1)
    assert SemiConfig.from_model_cfg(cfg).pos_mode == \
        JSemiConfig.from_model_cfg(cfg).pos_mode == 'avg'
