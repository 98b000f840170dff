"""The port's S4Former step with the ablation flags held to the jitted JAX
step on the CPU, in f32: a 3-step trajectory from one TrainState (through
the weight bridge) per flag group, as tests/test_torch_train_step.py does
for the flagship's flags, at 1e-4.

Randomness is made the same in both packages without editing either:

- The JAX step draws its mixes from its own keys. The test derives the
  same keys (``fold_in(key, step)``, then the step's and the cascade's
  splits), makes each mix's draws from them with the JAX calls, and hands
  them to the port as ``dbg_`` overrides, which replace the port's draw
  and gate.
- The JAX gates with a fixed probability of 0.5 (CutOut, ClassMix, the
  supervised ClassMix, PatchShuffle + ClassMix) are opened by
  monkeypatching ``jax.random.bernoulli`` for scalar draws in the test;
  ``strong_aug_prob`` is 1.0.
- The flagship's CutMix box and PatchShuffle permutation go to both
  packages through ``dbg_cutmix_mask`` / ``dbg_patchmix_perm``.
- fdrop masks ([B, 1, 1, C]) are fixed in both packages by monkeypatching
  ``jax.random.bernoulli`` and the port's ``models.dropout.keep_mask``; the
  EMA head skips of ``momentum_head_dropout`` by monkeypatching the JAX
  scalar draws in leaf order and handing the port ``dbg_ema_head_skip``.

Dropout rates are 0 here (test_torch_ablation.py holds them given masks).
Tolerances: losses 1e-4 relative, parameters, EMA, BN statistics and SGD
buffers 1e-4 max abs.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.semi import mixes as jmixes
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch.models import dropout as tdrop
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from tests._torch_port import TRAIN_MODEL, jax_train_model, torch_train_model
from tests.test_torch_ablation import (_FixedMasks, _jax_mults_by_port_name,
                                       j_adaptive_draws, j_class_scores)
from tests.test_torch_train_step import (LOSS_RTOL, S4_FLAGS, STEP_KW,
                                         _assert_state_close, _injected)

B, STEPS, NCLS = 2, 3, 5
# the flagship's flags without the annealed head momentum (its state field
# changes from None to a value after the first step, so the JAX step would
# compile twice; test_torch_train_step.py holds it)
BASE = dict(S4_FLAGS, strong_aug_prob=1.0, momentum_head_exp=0.0)
NO_FLAGSHIP_MIX = dict(use_PatchShuffle_w_Cutmix=False)

GROUPS = {
    'sup_ncr_both_sup_ema': dict(negative_class_ranking_mode='both',
                                 sup_ema=True),
    'sup_ncr_sup_only': dict(negative_class_ranking_mode='sup_only'),
    'strong_mixes': dict(NO_FLAGSHIP_MIX, use_CutMix=True, patchwise=True,
                         use_CutOut=True, use_ClassMix=True,
                         mix_with_labeled=True, use_PatchShuffle=True,
                         patchmix_ratio=0.5),
    'ps_classmix_sup_cutmix': dict(NO_FLAGSHIP_MIX,
                                   use_PatchShuffle_w_Classmix=True,
                                   patchwise=True, sup_cutmix=True),
    'sup_classmix': dict(sup_ClassMix=True),
    'cutmix_adaptive': dict(use_cutmix_adaptive=True),
    'layer_decay_sigmoid': dict(),
    'fdrop': dict(use_fdrop=True, attn_mask_w_fdrop=True),
    'momentum_head_dropout': dict(momentum_head_dropout=0.5),
}
# ClassMix of use_ClassMix takes 128² super-patches with ``patchwise``
# (the JAX step passes no patchsize), so that group runs at 128²
IMG = {'strong_mixes': 128}
LAYER_DECAY = dict(num_layers=2, decay_rate=0.65)


def _batches(size):
    rng = np.random.RandomState(11)
    return [{'sup_img': rng.randn(B, size, size, 3).astype(np.float32),
             'sup_gt': rng.randint(0, NCLS, (B, size, size)).astype(np.int32),
             'unsup_teacher_img': rng.randn(B, size, size,
                                            3).astype(np.float32),
             'unsup_student_img': rng.randn(B, size, size,
                                            3).astype(np.float32)}
            for _ in range(STEPS)]


def _step_keys(key, step):
    """The JAX step's sup-mix key and its cascade's 8 keys at ``step``."""
    rng = jax.random.fold_in(key, step)
    _, r_sup, r_mix, _, _ = jax.random.split(rng, 5)
    return r_sup, jax.random.split(r_mix, 8)


def _draw_key(k):
    """The key of a gated mix's draw (``gated``: kg, kf = split(key))."""
    return jax.random.split(k)[1]


def _shuffle_perm(key, size, cfg):
    dummy = jnp.zeros((B, size, size, 3), jnp.float32)
    return np.asarray(jmixes.patch_shuffle(key, dummy, cfg.PatchMix_N,
                                           cfg.patchsize,
                                           cfg.patchmix_ratio)[1])


def _port_draws(cfg, key, step, size):
    """The ``dbg_`` overrides that give the port the JAX step's draws."""
    r_sup, k = _step_keys(key, step)
    hw = (size, size)
    ps = cfg.patchsize * cfg.PatchMix_N
    out = {}
    if cfg.sup_cutmix:
        out['sup_cutmix_mask'] = jmixes._batch_box_masks(_draw_key(r_sup),
                                                         B, hw, 2.0)
    elif cfg.sup_ClassMix:
        out['sup_classmix_scores'] = j_class_scores(_draw_key(r_sup), B,
                                                    False, 0)
    if cfg.use_CutMix:
        out['strong_cutmix_mask'] = jmixes._batch_patchwise_masks(
            _draw_key(k[0]), B, hw, ps, cfg.cutout_area)
    if cfg.use_CutOut:
        out['cutout_mask'] = jmixes._batch_patchwise_masks(
            _draw_key(k[1]), B, hw, ps, cfg.cutout_area)
    if cfg.use_ClassMix:
        out['classmix_scores'] = j_class_scores(_draw_key(k[2]), B, True,
                                                (size // 128) ** 2)
    if cfg.use_cutmix_adaptive:
        out.update({'adaptive_' + n: v for n, v in
                    j_adaptive_draws(k[3], B, hw).items()})
    if cfg.use_PatchShuffle:
        out['shuffle_perm'] = _shuffle_perm(k[4], size, cfg)
    if cfg.use_PatchShuffle_w_Classmix:
        out['ps_classmix_scores'] = j_class_scores(_draw_key(k[5]), B, True,
                                                   (size // ps) ** 2)
        out['patchmix_perm'] = _shuffle_perm(k[6], size, cfg)
    return {key_: np.asarray(v) for key_, v in out.items()}


def _model_cfg(group):
    cfg = copy.deepcopy(TRAIN_MODEL)
    if group == 'layer_decay_sigmoid':
        # both aux heads alike, so the JAX model still fuses them and its
        # parameters are the base state's
        for head in cfg['auxiliary_head']:
            head['loss_decode'] = dict(type='CrossEntropyLoss',
                                       use_sigmoid=True, loss_weight=0.4)
    return cfg


@pytest.fixture(scope='module')
def jax_base():
    """The JAX model and TrainState every group starts from (a loss
    config changes no parameter, so the sigmoid group shares the state)."""
    return jax_train_model(seed=0)


def _head_skips(jstate, model):
    """Skips by rule for the JAX head leaves (flax order) and the same
    skips in the port's ``decode_head.named_parameters()`` order."""
    head = jstate.params['decode_head_m']
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(head)[0]]
    skips = ['conv_seg' in p or 'norm' in p or 'up_convs_1' in p
             for p in paths]
    index = jax.tree_util.tree_map(lambda _: -1.0, jstate.params)
    index['decode_head_m'] = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(head), [float(i)
                                             for i in range(len(paths))])
    order = _jax_mults_by_port_name(jstate.params, index)
    port = np.array([skips[int(order['decode_head.' + n])]
                     for n, _ in model.decode_head.named_parameters()])
    return skips, port


@pytest.mark.parametrize('group', list(GROUPS))
def test_ablation_trajectory_matches_jax_step(group, monkeypatch, jax_base):
    flags = dict(BASE, **GROUPS[group])
    size = IMG.get(group, 64)
    cfg = JSemiConfig(**flags)
    step_kw = dict(STEP_KW)
    if group == 'layer_decay_sigmoid':
        step_kw.update(weight_decay=1e-2)
    jmodel, jstate = jax_base
    if group == 'layer_decay_sigmoid':
        jcfg = _model_cfg(group)
        jcfg['backbone']['use_flash'] = False
        jmodel = j_build_segmentor(jcfg)
    model = torch_train_model(_model_cfg(group))
    state = train_state_from_jax(model, jstate)

    # the JAX draws the port cannot be handed through a batch
    fixed = _FixedMasks()
    skips, port_skips = _head_skips(jstate, model)
    scalar_calls = []
    original = jax.random.bernoulli

    def bernoulli(key, p=0.5, shape=None):
        if shape is None or tuple(shape) == ():
            if group == 'momentum_head_dropout':
                scalar_calls.append(p)
                return jnp.asarray(skips[(len(scalar_calls) - 1) %
                                         len(skips)])
            return jnp.asarray(True)        # the 0.5 gates, opened
        if len(shape) == 4:                 # fdrop [B, 1, 1, C]
            return fixed.bernoulli(key, p, shape)
        return original(key, p, shape)
    monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', fixed.keep_mask)

    paramwise = LAYER_DECAY if group == 'layer_decay_sigmoid' else None
    jstep = jax.jit(j_make_semi_train_step(jmodel, cfg, **step_kw,
                                           paramwise_cfg=paramwise))
    step = make_semi_train_step(model, SemiConfig(**flags), **step_kw,
                                paramwise_cfg=paramwise)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for i, batch in enumerate(_batches(size)):
        jbatch = dict(batch)
        if flags['use_PatchShuffle_w_Cutmix']:
            masks, perms = _injected(i)
            jbatch.update(dbg_cutmix_mask=masks, dbg_patchmix_perm=perms)
        port_batch = dict(jbatch, **{'dbg_' + k: v for k, v in
                                     _port_draws(cfg, key, i, size).items()})
        if group == 'momentum_head_dropout':
            port_batch['dbg_ema_head_skip'] = port_skips
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in jbatch.items()}, key)
        state, logs = step(state, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in port_batch.items()}, gen)
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'{group} step {i} {k}')
        assert 0.05 < float(logs['mask_ratio']) < 0.95, i
    _assert_state_close(jstate, state)
    if group == 'fdrop':
        assert fixed.jax_shapes and fixed.port_shapes
        assert set(fixed.jax_shapes) == set(fixed.port_shapes) == {
            (B, 1, 1, 64)}
        assert 'unsup.loss_seg_unsup_fdrop' in logs
    if group == 'momentum_head_dropout':
        assert scalar_calls and set(scalar_calls) == {0.5}
        assert 0 < port_skips.sum() < len(port_skips)
    if group.startswith('sup_ncr'):
        assert float(logs['loss_ncr_sup']) > 0


def test_ablation_flags_run_through_tools_train(tmp_path):
    """``tools.train`` with the regularisers and supervised losses set by
    ``--cfg-options`` (ViT dropout, drop path and attention dropout, SETR
    dropout, fdrop with the PASA pass, EMA head dropout, NCR 'both',
    sup_ema, layer decay over the ViT's 2 layers, the main head's CE as
    sigmoid: the config has no list keys, so an aux head's loss cannot be
    set from the command line): 2 steps on the CPU with eval and a
    checkpoint."""
    import json
    import os.path as osp
    from s4former_tpu_torch.tools import train as train_cli
    from tests._torch_port import write_cli_config
    from tests.test_torch_runner import _split
    cfg = write_cli_config(tmp_path, _split(tmp_path, 1))
    opts = ['model.backbone.drop_rate=0.1',
            'model.backbone.drop_path_rate=0.1',
            'model.backbone.attn_drop_rate=0.1',
            'model.decode_head.dropout_ratio=0.1',
            'model.use_fdrop=True', 'model.attn_mask_w_fdrop=True',
            'model.momentum_head_dropout=0.1',
            'model.negative_class_ranking_mode=both', 'model.sup_ema=True',
            'optimizer.paramwise_cfg.num_layers=2',
            'optimizer.paramwise_cfg.decay_rate=0.65',
            'model.decode_head.loss_decode.use_sigmoid=True']
    wd = str(tmp_path / 'work')
    state = train_cli.main([cfg, '--work-dir', wd, '--device', 'cpu',
                            '--cfg-options'] + opts)
    assert int(state.step) == 2
    assert state.model.backbone.drop_path_rate == 0.1
    assert state.model.decode_head.dropout_ratio == 0.1
    with open(osp.join(wd, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r['prefix'] == 'train']
    assert {'loss_ncr_sup', 'loss_decode_sup_ema',
            'unsup.loss_seg_unsup_fdrop'} <= set(train[-1])
    assert all(np.isfinite(r['loss']) for r in train)
    assert [r['step'] for r in records if r['prefix'] == 'val'] == [2]
