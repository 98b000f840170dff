"""UniMatch in the port held to the JAX package on the CPU, in f32.

- ``cutmix_unimatch`` bit for bit, labels at the images' resolution and
  at the head's.
- ``unimatch_unsup_losses`` of both packages on the same teacher logits,
  through one deterministic stand-in for the student forward: head 1 as the
  PASA pass and as the fdrop pass, each with the streams' boxes and
  permutations injected, and with the gate off (``strong_aug_prob=0``).
- The step: ``unimatch=True`` without a mix stream takes the normal
  branch; 3-step trajectories against the jitted JAX step (a tiny ViT with
  PASA, PatchShuffle and NCR; the fdrop head 1 with ``iter_unsup_start``;
  a tiny MiT with its raw unconfidence map and labels at a quarter of the
  image), the boxes and permutations handed to both packages as
  ``dbg_um_*`` keys, fdrop masks fixed by (shape, keep) in both.
- Data and CLI: ``UniSemiDataset`` + ``SemiLoader`` give the six unsup
  views, and ``tools.train`` runs 2 steps of a UniMatch config.

Tolerances: cutmix bit-exact; branch losses 1e-6 relative; trajectories
as tests/test_torch_train_step.py (losses 1e-4 relative, state 1e-4 abs).
"""
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.data.datasets.custom import \
    UniSemiDataset as JUniSemiDataset
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu.semi import unimatch as junimatch
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.pseudo import \
    extract_teacher_info as j_extract_teacher_info
from s4former_tpu.semi.train_step import create_train_state as j_create_state
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch.data import SemiLoader, build_dataset
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.models import dropout as tdrop
from s4former_tpu_torch.semi import unimatch
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.pseudo import extract_teacher_info
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from tests._torch_port import (FIXTURE, jax_train_model, mit_model_cfg,
                               perturbed, torch_train_model,
                               write_unimatch_config)
from tests.test_torch_ablation import _FixedMasks
from tests.test_torch_train_step import (LOSS_RTOL, STEP_KW,
                                         _assert_state_close)

B, IMG, NCLS, STEPS = 2, 64, 5, 3
BRANCH_RTOL = 1e-6
UNIMATCH = dict(
    ema=True, ema_momentum=0.99, unimatch=True, unsup_weight=1.0,
    unsup_confidence=0.5, attn_mask_seperate_head=True,
    attn_mask_weight=5.0, adaptive_attn_mask=True, use_PatchShuffle=True,
    PatchMix_N=2, negative_class_ranking=True,
    negative_class_ranking_mode='unsup_only')
# head 1 as the fdrop pass: no separate PASA head; the unsup losses start
# after step 1
FDROP_HEAD = dict(UNIMATCH, attn_mask_seperate_head=False,
                  iter_unsup_start=1)
UNSUP_VIEWS = ('unsup_teacher_img', 'unsup_student_img',
               'unsup_student_2_img', 'unsup_teacher_mix_img',
               'unsup_student_mix_img', 'unsup_student_2_mix_img')


def _boxes(step, idx):
    """[B, IMG, IMG] {0,1} boxes, one per sample, different per step and
    stream."""
    masks = np.ones((B, IMG, IMG), np.float32)
    o = step + 5 * idx
    masks[0, 8 + o:40 + o, 16:48] = 0
    masks[1, 0:32, 20 + o:52 + o] = 0
    return masks


def _perms(step, idx):
    """[B, 4] super-patch permutations; one identity row."""
    rows = [np.roll(np.arange(4), step + idx),
            np.arange(4) if (step + idx) % 2 else np.array([1, 0, 3, 2])]
    return np.stack(rows).astype(np.int32)


def _injected(step):
    out = {}
    for idx in (1, 2):
        out[f'dbg_um_cutmix_mask_{idx}'] = _boxes(step, idx)
        out[f'dbg_um_patchmix_perm_{idx}'] = _perms(step, idx)
    return out


def _batches(seed=11):
    rng = np.random.RandomState(seed)
    out = []
    for step in range(STEPS):
        batch = {'sup_img': rng.randn(B, IMG, IMG, 3).astype(np.float32),
                 'sup_gt': rng.randint(0, NCLS, (B, IMG, IMG)
                                       ).astype(np.int32)}
        for key in UNSUP_VIEWS:
            batch[key] = rng.randn(B, IMG, IMG, 3).astype(np.float32)
        out.append(dict(batch, **_injected(step)))
    return out


# ------------------------------------------------------------- the apply
@pytest.mark.parametrize('label_hw', [64, 16])
def test_cutmix_unimatch_bit_exact(label_hw):
    rs = np.random.RandomState(3)
    imgs, mix = (rs.randn(B, IMG, IMG, 3).astype(np.float32)
                 for _ in range(2))
    labels, mix_labels = (rs.randint(0, NCLS, (B, label_hw, label_hw)
                                     ).astype(np.int32) for _ in range(2))
    labels[0, :3] = 255
    masks = _boxes(1, 1)
    want_i, want_l = junimatch.cutmix_unimatch(
        None, jnp.asarray(imgs), jnp.asarray(mix), jnp.asarray(labels),
        jnp.asarray(mix_labels), masks=jnp.asarray(masks))
    got_i, got_l = unimatch.cutmix_unimatch(
        *(torch.from_numpy(a) for a in (masks, imgs, mix, labels,
                                        mix_labels)))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.dtype == torch.int32
    # both sources are present in the mixed labels
    assert (got_l.numpy() != labels).any() and (got_l.numpy() == labels).any()


# ------------------------------------------------- the branch's losses
def _decoders(w, calls):
    """The same deterministic student forward in both packages: 4x4
    average pooling to a 16² head resolution, a fixed [3, C] projection,
    and terms that show the bias, fdrop and the permutation arrived."""
    def jdecode(img, attn_bias=None, use_fdrop=False, patchmix_perm=None,
                patchmix_n=0):
        calls['jax'].append((attn_bias is not None, use_fdrop,
                             patchmix_perm is not None, patchmix_n))
        x = img.reshape(B, 16, 4, 16, 4, 3).mean(axis=(2, 4))
        out = x @ jnp.asarray(w)
        if attn_bias is not None:
            out = out + attn_bias.mean()
        if use_fdrop:
            out = out * 0.5
        if patchmix_perm is not None:
            out = out + 0.1 * patchmix_perm[:, :1, None, None].astype(
                jnp.float32)
        return out

    def tdecode(img, attn_bias=None, use_fdrop=False, patchmix_perm=None,
                patchmix_n=0):
        calls['port'].append((attn_bias is not None, use_fdrop,
                              patchmix_perm is not None, patchmix_n))
        x = img.reshape(B, 16, 4, 16, 4, 3).mean(dim=(2, 4))
        out = x @ torch.from_numpy(w)
        if attn_bias is not None:
            out = out + attn_bias.mean()
        if use_fdrop:
            out = out * 0.5
        if patchmix_perm is not None:
            out = out + 0.1 * patchmix_perm[:, :1, None, None].float()
        return out
    return jdecode, tdecode


@pytest.mark.parametrize('draws', ['injected', 'gate_off'])
@pytest.mark.parametrize('head', ['pasa', 'fdrop'])
def test_unimatch_losses_match_jax(head, draws):
    flags = dict(UNIMATCH, attn_mask_seperate_head=head == 'pasa',
                 unsup_confidence=0.3)
    if draws == 'gate_off':
        flags['strong_aug_prob'] = 0.0
    jcfg, cfg = JSemiConfig(**flags), SemiConfig(**flags)
    rs = np.random.RandomState(5)
    batch = {k: rs.randn(B, IMG, IMG, 3).astype(np.float32)
             for k in UNSUP_VIEWS}
    t_logits, t_mix_logits = (rs.randn(B, 16, 16, NCLS).astype(np.float32)
                              for _ in range(2))
    bias = rs.randn(B, 1, 17, 17).astype(np.float32)
    overrides = {k[4:]: v for k, v in _injected(1).items()
                 if draws == 'injected' or 'perm' in k}
    w = rs.randn(3, NCLS).astype(np.float32)
    calls = {'jax': [], 'port': []}
    jdecode, tdecode = _decoders(w, calls)

    def jinfo(x):
        return j_extract_teacher_info(jnp.asarray(x), jcfg.unsup_confidence)

    def tinfo(x):
        return extract_teacher_info(torch.from_numpy(x),
                                    cfg.unsup_confidence)
    want = junimatch.unimatch_unsup_losses(
        jcfg, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.items()}, jinfo(t_logits),
        jinfo(t_mix_logits), jnp.asarray(bias), jdecode, NCLS,
        overrides={k: jnp.asarray(v) for k, v in overrides.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port_draws = unimatch.unimatch_draws(
        cfg, torch.Generator().manual_seed(0), B, (IMG, IMG), 'cpu',
        {k: torch.from_numpy(v) for k, v in overrides.items()})
    got = unimatch.unimatch_unsup_losses(
        cfg, port_draws, tb, tinfo(t_logits), tinfo(t_mix_logits),
        torch.from_numpy(bias), tdecode, NCLS)
    assert sorted(got) == sorted(want)
    head_key = 'loss_seg_unsup_attn_mask' if head == 'pasa' else \
        'loss_seg_unsup_fdrop'
    assert head_key in got
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v),
                                   rtol=BRANCH_RTOL, err_msg=k)
        assert float(got[k]) > 0, k
    # head 1 (with the bias, or fdrop), then two streams, each shuffled
    assert calls['port'] == calls['jax'] == [
        (head == 'pasa', head == 'fdrop', False, 0),
        (False, False, True, 2), (False, False, True, 2)]
    gates = [bool(port_draws[i]['gate']) for i in (1, 2)]
    assert gates == ([True, True] if draws == 'injected' else
                     [False, False])


# ---------------------------------------------------------------- the step
def test_unimatch_without_mix_stream_takes_the_normal_branch():
    """``unimatch=True`` on a batch without ``unsup_teacher_mix_img`` is
    the step without UniMatch: the same logs from the same draws."""
    flags = dict(UNIMATCH, use_PatchShuffle=False,
                 use_PatchShuffle_w_Cutmix=True)
    _, jstate = jax_train_model(seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()
             if k in ('sup_img', 'sup_gt', 'unsup_teacher_img',
                      'unsup_student_img')}
    out = []
    for on in (True, False):
        state = train_state_from_jax(torch_train_model(), jstate)
        step = make_semi_train_step(state.model,
                                    SemiConfig(**dict(flags, unimatch=on)),
                                    **STEP_KW)
        _, logs = step(state, batch, torch.Generator().manual_seed(0))
        out.append({k: float(v) for k, v in logs.items()})
    assert out[0] == out[1]
    assert 'unsup.loss_seg_unsup' in out[0]


def _jax_mit_state(cfg):
    model = j_build_segmentor(cfg)
    v = jax.jit(lambda key: init_segmentor_variables(
        model, key, (1, IMG, IMG, 3)))(jax.random.PRNGKey(0))
    student = perturbed({'params': v['params'],
                         'batch_stats': v['batch_stats']}, 0)
    teacher = perturbed(student, 1, std=0.05)
    state = j_create_state(jax.tree_util.tree_map(jnp.asarray, student),
                           ema=True)
    return model, state.replace(
        ema_params=jax.tree_util.tree_map(jnp.asarray, teacher['params']),
        ema_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               teacher['batch_stats']))


@pytest.mark.parametrize('case', ['vit_pasa', 'vit_fdrop', 'mit_pasa'])
def test_unimatch_trajectory_matches_jax_step(case, monkeypatch):
    flags = FDROP_HEAD if case == 'vit_fdrop' else UNIMATCH
    if case == 'mit_pasa':
        flags = dict(flags, unsup_confidence=0.4)
        jmodel, jstate = _jax_mit_state(mit_model_cfg())
        model = build_segmentor(mit_model_cfg())
    else:
        jmodel, jstate = jax_train_model(seed=0)
        model = torch_train_model()
    state = train_state_from_jax(model, jstate)
    fixed = _FixedMasks()                # fdrop masks by (shape, keep)
    original = jax.random.bernoulli

    def bernoulli(key, p=0.5, shape=None):
        if shape is not None and len(shape) == 4:
            return fixed.bernoulli(key, p, shape)
        return original(key, p, shape)
    monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', fixed.keep_mask)
    jstep = jax.jit(j_make_semi_train_step(jmodel, JSemiConfig(**flags),
                                           **STEP_KW))
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for i, batch in enumerate(_batches()):
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
        state, logs = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, gen)
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'{case} step {i} {k}')
        assert 0.05 < float(logs['mask_ratio']) < 0.95, i
        live = case != 'vit_fdrop' or i == STEPS - 1
        for idx in (1, 2):
            assert (float(logs[f'unsup.loss_seg_unsup_{idx}']) > 0) == live
            assert (float(logs[f'unsup.loss_ncr_unsup_{idx}']) > 0) == live
    head = 'unsup.loss_seg_unsup_fdrop' if case == 'vit_fdrop' else \
        'unsup.loss_seg_unsup_attn_mask'
    assert float(logs[head]) > 0
    if case == 'vit_fdrop':
        assert set(fixed.port_shapes) == set(fixed.jax_shapes) == {
            (B, 1, 1, 64)}
    assert int(state.step) == int(jstate.step) == STEPS
    _assert_state_close(jstate, state)


# ------------------------------------------------------------ data and CLI
def _voc(split, pipeline):
    return dict(type='PascalVOCDataset', data_root=FIXTURE,
                img_dir='JPEGImages', ann_dir='SegmentationClass',
                split=osp.join(FIXTURE, 'datasplits', 'fixture', split),
                pipeline=pipeline)


GEOMETRIC = [
    dict(type='LoadImageFromFile'), dict(type='LoadAnnotations'),
    dict(type='Resize', img_scale=(128, 64), ratio_range=(0.5, 2.0)),
    dict(type='RandomCrop', crop_size=(64, 64))]


def _branch(tag):
    return [dict(type='RandomGrayscale', prob=0.5),
            dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                 std=[58.395, 57.12, 57.375], to_rgb=True),
            dict(type='Pad', size=(64, 64), pad_val=0, seg_pad_val=255),
            dict(type='ExtraAttrs', tag=tag),
            dict(type='Collect', keys=['img', 'gt_semantic_seg'])]


def _three_branch(suffix):
    return GEOMETRIC + [dict(type='MultiBranch', **{
        name + suffix: _branch(name + suffix) for name in
        ('unsup_teacher', 'unsup_student', 'unsup_student_2')})]


def test_unisemi_dataset_and_loader_give_the_six_unsup_views():
    sup = _voc('train_supervised.txt', GEOMETRIC + _branch('sup'))
    cfg = dict(type='UniSemiDataset', sup=sup,
               unsup=_voc('train_unsupervised.txt', _three_branch('')),
               unsup2=_voc('train_unsupervised.txt', _three_branch('_mix')))
    ds = build_dataset(cfg)
    assert len(ds) == len(JUniSemiDataset(**{k: v for k, v in cfg.items()
                                             if k != 'type'})) == 48
    loader = SemiLoader(ds.sup, ds.unsup, ds.unsup2, sup_per_batch=2,
                        unsup_per_batch=3, num_workers=2, max_iter_size=1)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    for key in UNSUP_VIEWS:
        assert batch[key].shape == (3, 64, 64, 3), key
    assert batch['sup_img'].shape == (2, 64, 64, 3)


def test_unimatch_runs_through_tools_train(tmp_path):
    """``tools.train`` on a UniMatch config (UniSemiDataset, three-branch
    pipelines with RandomGrayscale and GaussianBlur, ``model.unimatch``),
    with the ViT's remat on from the command line: 2 steps on the CPU with
    eval and a checkpoint."""
    from s4former_tpu_torch.tools import train as train_cli
    from tests.test_torch_runner import _split
    cfg = write_unimatch_config(tmp_path, _split(tmp_path, 1))
    wd = str(tmp_path / 'work')
    state = train_cli.main([cfg, '--work-dir', wd, '--device', 'cpu',
                            '--cfg-options', 'model.unsup_confidence=0.06',
                            'model.backbone.remat_layers=True'])
    assert int(state.step) == 2
    assert state.model.backbone.remat_layers
    with open(osp.join(wd, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r['prefix'] == 'train']
    assert {'unsup.loss_seg_unsup_attn_mask', 'unsup.loss_seg_unsup_1',
            'unsup.loss_seg_unsup_2', 'unsup.loss_ncr_unsup_1',
            'unsup.loss_ncr_unsup_2'} <= set(train[-1])
    assert all(np.isfinite(r['loss']) for r in train)
    assert [r['step'] for r in records if r['prefix'] == 'val'] == [2]
    assert osp.isdir(osp.join(wd, 'iter_2'))
    assert 'mask_ratio' in train[-1]
