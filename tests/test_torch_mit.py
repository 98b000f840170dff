"""The SegFormer/MiT family of the port held to the JAX package on the CPU,
in f32, at a tiny size: ``tests/_torch_port.MIT_MODEL`` is the one of
tests/test_semi/test_mit_semi.py (MiT embed 8, 4 stages of one block,
heads 1/2/4/8, sr 8/4/2/1, mlp ratio 2; SegFormer head of 16 channels, 5
classes), with the head's dropout at 0 where two packages must agree. The
JAX package's initial variables are perturbed with seeded numpy noise
(``tests/_torch_port.perturbed``) and go to both packages as numpy arrays.

- ``mit_stage_bias``: bit-equal, adaptive and not, on random, all-tie and
  binary maps (the stable argsort picks the same rows as ``jnp.argsort``).
- The MiT forward, with and without a PASA map, adaptive and not, and the
  SegFormer head in eval, in train (BN on batch statistics) and with a
  PatchShuffle permutation: within 1e-5 abs (f32 sums in another order).
- An mmseg-layout SegFormer ``.pth`` (every LayerNorm weight moved from 1
  and every bias from 0, so a skipped tensor shows), loaded by JAX
  ``convert_mmseg_checkpoint`` and by the port's ``init_segmentor``: the
  same logits within 1e-5, the student's and the EMA twin's, and every
  backbone tensor overlaid.
- A 3-step trajectory of the ``_MT_w_ours`` flags (EMA, adaptive PASA x5,
  PatchShuffle + CutMix injected through the ``dbg_`` keys, NCR, drop
  rates 0) against the jitted JAX step: losses 1e-4 relative, states 1e-4
  abs, as tests/test_torch_train_step.py.
- Drop path and dropout: identities in eval; in train, per-sample and
  element-wise masks, kept values scaled by 1/keep, the kept share within
  5 sigma of its binomial mean, the same generator seed the same output.
- The real segformer configs build with the JAX model's 61,374,419
  parameters; a Cityscapes tree's items (sup, MultiBranch unsup, val) are
  bit-exact to the JAX dataset's; the train -> test CLI round trip on that
  tree in slide mode gives the in-loop mIoU offline.
"""
import copy
import json
import logging
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import s4former_tpu.data  # noqa: F401  (registers the JAX pipelines)
import s4former_tpu.models  # noqa: F401
import s4former_tpu_torch.data  # noqa: F401
import s4former_tpu_torch.models  # noqa: F401
from s4former_tpu.core.checkpoint import convert_mmseg_checkpoint
from s4former_tpu.data.datasets.custom import build_dataset as j_build
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.pasa import mit_stage_bias as j_mit_stage_bias
from s4former_tpu.semi.train_step import create_train_state as j_create_state
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch import apis
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import (ema_state_dict,
                                                state_dict_from_jax_variables,
                                                train_state_dicts_from_jax)
from s4former_tpu_torch.data import build_dataset
from s4former_tpu_torch.models import build_segmentor, init_segmentor_weights
from s4former_tpu_torch.models.backbones.mit import drop_path
from s4former_tpu_torch.models.decode_heads.segformer import dropout
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.pasa import mit_stage_bias
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from s4former_tpu_torch.utils.logger import get_root_logger
from tests._torch_port import mit_model_cfg, perturbed
from tests.test_torch_data import _assert_same

REPO = osp.join(osp.dirname(osp.abspath(__file__)), '..')
SEGFORMER = osp.join(REPO, 'configs', 'segformer',
                     'segformer_mit-b4_bs_8_768x768_40k_cityscapes_'
                     '1over16_split_CPS_{}.py')
# the JAX model of the _MT_w_ours config: jax.eval_shape of its
# build_segmentor's init, 849 parameter leaves
MIT_B4_PARAMS = 61_374_419
ATOL = 1e-5
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
@pytest.fixture(scope='module')
def jax_mit():
    """(JAX model, perturbed numpy variables) of ``MIT_MODEL``."""
    model = j_build_segmentor(mit_model_cfg())
    v = jax.jit(lambda key: init_segmentor_variables(
        model, key, (1, 64, 64, 3)))(jax.random.PRNGKey(0))
    return model, perturbed({'params': v['params'],
                             'batch_stats': v['batch_stats']}, 0)


def _port(variables, cfg=None):
    model = build_segmentor(cfg or mit_model_cfg())
    model.load_state_dict(state_dict_from_jax_variables(variables))
    return model


def _close(got, want, atol=ATOL, what=''):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------ stage bias
def _unconf(kind, b, l, rs):
    if kind == 'random':
        return rs.rand(b, l).astype(np.float32)
    if kind == 'all_tie':
        return np.full((b, l), 0.25, np.float32)
    if kind == 'binary':
        return (rs.rand(b, l) > 0.5).astype(np.float32)
    # pooled binary maps: means of 4 pixels, ties everywhere
    return (rs.randint(0, 5, (b, l)) / 4.0).astype(np.float32)


@pytest.mark.parametrize('adaptive', [False, True])
@pytest.mark.parametrize('kind', ['random', 'all_tie', 'binary', 'pooled'])
@pytest.mark.parametrize('length', [4, 16, 36])
def test_mit_stage_bias_bit_equal(adaptive, kind, length):
    unconf = _unconf(kind, 3, length, np.random.RandomState(length))
    want = np.asarray(j_mit_stage_bias(jnp.asarray(unconf), 5.0, adaptive))
    got = mit_stage_bias(torch.from_numpy(unconf), 5.0, adaptive).numpy()
    assert got.shape == want.shape == (3, 1, length, length)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- the forwards
@pytest.mark.parametrize('hw', [64, 128])
@pytest.mark.parametrize('pasa', [None, 'adaptive', 'plain'])
def test_mit_backbone_matches_jax(jax_mit, hw, pasa):
    _, variables = jax_mit
    cfg = mit_model_cfg(adaptive=pasa != 'plain')
    jmodel = j_build_segmentor(copy.deepcopy(cfg))
    model = _port(variables, cfg)
    rs = np.random.RandomState(hw)
    x = rs.randn(2, hw, hw, 3).astype(np.float32)
    unconf = None if pasa is None else \
        (rs.rand(2, hw, hw) > 0.4).astype(np.float32)
    want = jax.jit(lambda v, img, b: jmodel.apply(
        v, method='extract_feat', img=img, train=False, attn_bias=b))(
            variables, jnp.asarray(x),
            None if unconf is None else jnp.asarray(unconf))
    with torch.no_grad():
        got = model.extract_feat(
            torch.from_numpy(x),
            attn_bias=None if unconf is None else torch.from_numpy(unconf))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (2, hw // 4 >> i, hw // 4 >> i,
                                      8 * (1, 2, 5, 8)[i])
        _close(g.numpy(), w, what=f'level {i}')
    if pasa is not None:     # the map moved the last stage only
        with torch.no_grad():
            plain = model.extract_feat(torch.from_numpy(x))
        for i in range(3):
            torch.testing.assert_close(got[i], plain[i], rtol=0, atol=0)
        assert (got[3] - plain[3]).abs().max() > 1e-3
    feats, (attns, grid) = model.extract_feat(torch.from_numpy(x),
                                              return_attn=True)
    assert attns == [] and grid is None and len(feats) == 4


@pytest.mark.parametrize('mode', ['eval', 'train', 'train_perm'])
def test_segformer_head_matches_jax(jax_mit, mode):
    jmodel, variables = jax_mit
    model = _port(variables)
    rs = np.random.RandomState(7)
    feats = [rs.randn(2, 16 >> i, 16 >> i, c).astype(np.float32)
             for i, c in enumerate((8, 16, 40, 64))]
    train = mode != 'eval'
    perm = np.array([[2, 0, 3, 1], [0, 1, 2, 3]], np.int32) \
        if mode == 'train_perm' else None
    n = 2 if perm is not None else 0

    def jfn(v, fs, p):
        return jmodel.apply(v, method='decode_logits', feats=fs, train=train,
                            patchmix_perm=p, patchmix_n=n,
                            mutable=['batch_stats'] if train else False)
    out = jax.jit(jfn)(variables, [jnp.asarray(f) for f in feats],
                       None if perm is None else jnp.asarray(perm))
    want, upd = (out if train else (out, None))
    with torch.no_grad():
        got = model.decode_logits(
            [torch.from_numpy(f) for f in feats], train=train,
            patchmix_perm=None if perm is None else torch.from_numpy(perm),
            patchmix_n=n)
    assert got.shape == want.shape == (2, 16, 16, 5)
    _close(got.numpy(), want)
    if train:   # the running statistics moved as flax moves them
        ref = state_dict_from_jax_variables(
            {'params': variables['params'], 'batch_stats': upd['batch_stats']})
        own = model.state_dict()
        stats = [k for k in ref if 'running' in k]
        assert len(stats) == 10
        for k in stats:
            _close(own[k].numpy(), ref[k].numpy(), what=k)


# ------------------------------------------------ mmseg SegFormer files
def _mmseg_file(path, seed=3):
    """An mmseg-layout SegFormer .pth of the port's MIT_MODEL with an EMA
    twin: seeded weights, every 1-d tensor (LayerNorm and BN weights,
    biases) moved by N(0, 0.2), BN variances scaled by exp(N(0, 0.2))."""
    model = build_segmentor(mit_model_cfg())
    init_segmentor_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    sd = {}
    for twin in ('', '_ema'):
        for k, v in model.state_dict().items():
            v = v.clone()
            if k.endswith('running_var'):
                v *= torch.from_numpy(np.exp(rs.normal(
                    0, 0.2, v.shape)).astype(np.float32))
            elif v.dim() == 1 or k.endswith('running_mean'):
                v += torch.from_numpy(rs.normal(0, 0.2, v.shape).astype(
                    np.float32))
            elif twin:
                v *= 1.1
            head, rest = k.split('.', 1)
            sd[f'{head}{twin if head in ("backbone", "decode_head") else ""}'
               f'.{rest}'] = v
    torch.save({'state_dict': sd, 'meta': {}}, path)
    return sd


def test_mmseg_segformer_file_loads_every_backbone_tensor(tmp_path):
    """The regression case of the ViT-only key renames: a MiT's
    ``layers.{s}.1.{i}.norm1/norm2`` keys must reach the model unrenamed."""
    pth = str(tmp_path / 'segformer.pth')
    sd = _mmseg_file(pth)
    cfg_path = tmp_path / 'mit.py'
    cfg_path.write_text(f'model = {mit_model_cfg()!r}\n')
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = get_root_logger()
    logger.addHandler(handler)
    try:
        seg = apis.init_segmentor(str(cfg_path), checkpoint=pth, seed=9,
                                  device='cpu')
    finally:
        logger.removeHandler(handler)
    n_backbone = sum(k.startswith('backbone.') for k in
                     seg.model.state_dict())
    assert n_backbone == 92
    assert any(f'({n_backbone} of {n_backbone} backbone tensors)' in r
               for r in records), records
    for k, v in seg.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)

    jvars = convert_mmseg_checkpoint({k: v.numpy() for k, v in sd.items()},
                                     num_aux=0)
    jmodel = j_build_segmentor(mit_model_cfg())
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    fwd = jax.jit(lambda v, img: jmodel.apply(
        v, method='forward_decode_from_img', img=img, train=False))
    teacher = build_segmentor(mit_model_cfg())
    teacher.load_state_dict(ema_state_dict(sd))
    for which, model in (('', seg.model), ('ema_', teacher)):
        want = fwd({'params': jvars[which + 'params'],
                    'batch_stats': jvars[which + 'batch_stats']},
                   jnp.asarray(x))
        with torch.no_grad():
            got = model.forward_decode_from_img(torch.from_numpy(x))
        _close(got.numpy(), want, what=which or 'student')


# -------------------------------------------------------- the train step
B, IMG, STEPS = 2, 64, 3
STEP_KW = dict(num_classes=5, base_lr=0.01, max_iters=100, power=0.9,
               min_lr=1e-4)
# the _MT_w_ours flags at this size (PatchShuffle N = 2 of 16-pixel
# patches: 2 x 2 super-patches of 64²); threshold 0.4 of 5 classes keeps
# part of the teacher's pixels confident, so the stage-4 PASA bias, the
# pseudo-CE and NCR are live
MT_W_OURS = dict(
    ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.4,
    attn_mask_seperate_head=True, attn_mask_weight=5.0,
    adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
    negative_class_ranking=True, negative_class_ranking_mode='unsup_only')


def _step_batches():
    rs = np.random.RandomState(11)
    out = []
    for step in range(STEPS):
        masks = np.ones((B, IMG, IMG), np.float32)
        masks[0, 8 + step:40 + step, 16:48] = 0
        masks[1, 0:32, 24 + step:56 + step] = 0
        perms = np.stack([np.roll(np.arange(4), step + 1),
                          np.arange(4) if step == 1 else
                          np.array([1, 0, 3, 2])]).astype(np.int32)
        out.append({
            'sup_img': rs.randn(B, IMG, IMG, 3).astype(np.float32),
            'sup_gt': rs.randint(0, 5, (B, IMG, IMG)).astype(np.int32),
            'unsup_teacher_img': rs.randn(B, IMG, IMG, 3).astype(np.float32),
            'unsup_student_img': rs.randn(B, IMG, IMG, 3).astype(np.float32),
            'dbg_cutmix_mask': masks, 'dbg_patchmix_perm': perms})
    return out


def test_mt_w_ours_trajectory_matches_jax(jax_mit):
    jmodel, variables = jax_mit
    jstate = j_create_state(jax.tree_util.tree_map(jnp.asarray, variables),
                            ema=True)
    teacher = perturbed(variables, 1, std=0.05)
    jstate = jstate.replace(
        ema_params=jax.tree_util.tree_map(jnp.asarray, teacher['params']),
        ema_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               teacher['batch_stats']))
    jstep = jax.jit(j_make_semi_train_step(jmodel, JSemiConfig(**MT_W_OURS),
                                           **STEP_KW))
    model = build_segmentor(mit_model_cfg())
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**MT_W_OURS), **STEP_KW)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for i, batch in enumerate(_step_batches()):
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
        state, logs = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, gen)
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'step {i} {k}')
        assert 0.05 < float(logs['mask_ratio']) < 0.95, i
        assert float(logs['unsup.loss_ncr_unsup']) > 0, i
        assert float(logs['unsup.loss_seg_unsup_attn_mask']) > 0, i
    assert int(state.step) == int(jstate.step) == STEPS
    sds = train_state_dicts_from_jax(jstate)
    for which, ours in (('model', state.model.state_dict()),
                        ('momentum', state.momentum),
                        ('ema', state.ema_model.state_dict())):
        assert sorted(sds[which]) == sorted(ours), which
        for name, want in sds[which].items():
            _close(ours[name].detach().numpy(), want.numpy(), STATE_ATOL,
                   f'{which} {name}')


# ------------------------------------------------- drop path and dropout
def _binomial_ok(kept: int, n: int, keep: float):
    sigma = (n * keep * (1 - keep)) ** 0.5
    assert abs(kept - n * keep) <= 5 * sigma, (kept, n, keep)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_drop_path_is_per_sample(rate):
    y = torch.rand(4000, 3, 5) + 0.5
    out = drop_path(y, rate, torch.Generator().manual_seed(1))
    kept = (out != 0).all(dim=(1, 2))
    assert torch.equal(kept, (out != 0).any(dim=(1, 2)))   # whole samples
    torch.testing.assert_close(out[kept], y[kept] / (1 - rate))
    _binomial_ok(int(kept.sum()), 4000, 1 - rate)
    again = drop_path(y, rate, torch.Generator().manual_seed(1))
    other = drop_path(y, rate, torch.Generator().manual_seed(2))
    assert torch.equal(out, again) and not torch.equal(out, other)
    with pytest.raises(ValueError, match='Generator'):
        drop_path(y, rate, None)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_dropout_is_element_wise(rate):
    x = torch.rand(8, 16, 16, 32) + 0.5
    out = dropout(x, rate, torch.Generator().manual_seed(1))
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / (1 - rate))
    _binomial_ok(int(kept.sum()), x.numel(), 1 - rate)
    per_sample = kept.flatten(1)
    assert per_sample.any(1).all() and not per_sample.all(1).any()
    assert torch.equal(out, dropout(x, rate,
                                    torch.Generator().manual_seed(1)))
    assert not torch.equal(out, dropout(x, rate,
                                        torch.Generator().manual_seed(2)))


def test_model_drop_rates_in_eval_and_train(jax_mit):
    """Drop path 0.5 (linear over the 4 blocks: 0, 1/6, 1/3, 1/2) and head
    dropout 0.5: eval is the rate-0 model's forward; a train forward is
    the same for the same seed and another for another seed."""
    _, variables = jax_mit
    cfg = mit_model_cfg(drop_path_rate=0.5, dropout_ratio=0.5)
    live, still = _port(variables, cfg), _port(variables)
    assert [b.drop_path_rate for s in live.backbone.layers for b in s[1]] \
        == pytest.approx([0, 1 / 6, 1 / 3, 0.5])
    x = torch.from_numpy(np.random.RandomState(2).randn(
        4, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(live.forward_decode_from_img(x),
                                   still.forward_decode_from_img(x),
                                   rtol=0, atol=0)
        outs = [live.forward_decode_from_img(
            x, train=True, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
        assert torch.equal(outs[0], outs[1])
        assert not torch.equal(outs[0], outs[2])
        rate0 = still.forward_decode_from_img(x, train=True)
        assert not torch.equal(outs[0], rate0)
        with pytest.raises(ValueError, match='Generator'):
            live.forward_decode_from_img(x, train=True)


# ----------------------------------------------------- configs and data
@pytest.mark.parametrize('variant', ['semi_MT_w_ours', 'sup'])
def test_segformer_configs_build_with_the_jax_parameter_count(variant):
    cfg = Config.fromfile(SEGFORMER.format(variant))
    with torch.device('meta'):
        model = build_segmentor(cfg.model)
    assert sum(p.numel() for p in model.parameters()) == MIT_B4_PARAMS
    bb = model.backbone
    assert [len(stage[1]) for stage in bb.layers] == [3, 8, 27, 3]
    assert bb.attn_mask_weight == 5
    assert bb.adaptive_attn_mask is (variant == 'semi_MT_w_ours')
    assert model.decode_head.dropout_ratio == 0.1
    assert bb.layers[3][1][2].drop_path_rate == pytest.approx(0.1)


CITIES = ('aachen', 'bochum')


def _cityscapes_tree(root, n=4, hw=(48, 96)):
    """Seeded RGB PNGs and blocky trainId label PNGs (0-18, 255) in the
    Cityscapes layout, and a split file of their stems."""
    rs = np.random.RandomState(0)
    stems = []
    for i in range(n):
        city = CITIES[i % 2]
        stem = f'{city}/{city}_{i:06d}_000019'
        for sub, suffix, arr in (
                ('leftImg8bit/train', '_leftImg8bit.png',
                 rs.randint(0, 256, hw + (3,)).astype(np.uint8)),
                ('gtFine/train', '_gtFine_labelTrainIds.png',
                 np.kron(rs.choice(list(range(19)) + [255],
                                   (hw[0] // 8, hw[1] // 8)),
                         np.ones((8, 8), int)).astype(np.uint8))):
            path = root / sub / (stem + suffix)
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(arr).save(path)
        stems.append(stem)
    (root / 'split.txt').write_text('\n'.join(stems) + '\n')
    return root


def _small(pipeline, scale=(128, 64), crop=(48, 48)):
    """The config's pipeline with its scale and crop cut to the tiny tree."""
    out = []
    for t in copy.deepcopy(pipeline):
        if t.get('img_scale'):
            t['img_scale'] = scale
        for key in ('crop_size', 'size'):
            if key in t:
                t[key] = crop
        for key in ('transforms', 'unsup_student', 'unsup_teacher'):
            if key in t:
                t[key] = _small(t[key], scale, crop)
        out.append(t)
    return out


def _city_cfg(ds, root, pipeline=None):
    ds = copy.deepcopy(dict(ds))
    ds.update(data_root=str(root), split='split.txt',
              pipeline=_small(pipeline or ds['pipeline']))
    return ds


@pytest.mark.parametrize('which', ['sup', 'unsup', 'val'])
def test_cityscapes_items_match_jax(tmp_path, which):
    cfg = Config.fromfile(SEGFORMER.format('semi_MT_w_ours'))
    root = _cityscapes_tree(tmp_path)
    ds_cfg = {'sup': cfg.data.train.sup, 'unsup': cfg.data.train.unsup,
              'val': dict(cfg.data.val, img_dir='leftImg8bit/train',
                          ann_dir='gtFine/train')}[which]
    ds_cfg = _city_cfg(ds_cfg, root)
    jds, ds = j_build(copy.deepcopy(ds_cfg)), build_dataset(ds_cfg)
    assert type(ds).__name__ == 'CityscapesDataset' and len(ds) == 4
    for idx in range(4):
        item = ds.get_item_deterministic(idx, seed=idx + 3)
        _assert_same(jds.get_item_deterministic(idx, seed=idx + 3), item,
                     f'{which} {idx}')
        np.testing.assert_array_equal(jds.get_gt_seg_map(idx),
                                      ds.get_gt_seg_map(idx))
    if which == 'unsup':
        assert [v['tag'] for v in item] == ['unsup_student', 'unsup_teacher']


CLI_CFG = """
_base_ = ['{base}']
data_root = '{root}'
model = dict(
    backbone=dict(embed_dims=8, num_layers=[1, 1, 1, 1], mlp_ratio=2,
                  drop_path_rate=0.1),
    decode_head=dict(in_channels=[8, 16, 40, 64], channels=16),
    unsup_confidence=0.06, PatchMix_N=2,
    test_cfg=dict(mode='slide', crop_size=(64, 64), stride=(40, 40)))
data = dict(
    workers_per_gpu=1,
    train=dict(sup=dict(data_root=data_root, split='split.txt',
                        pipeline={sup}),
               unsup=dict(data_root=data_root, split='split.txt',
                          pipeline={unsup})),
    val=dict(data_root=data_root, img_dir='leftImg8bit/train',
             ann_dir='gtFine/train', split='split.txt', pipeline={val}),
    test=dict(data_root=data_root, img_dir='leftImg8bit/train',
              ann_dir='gtFine/train', split='split.txt', pipeline={val}))
samples_per_gpu_sup = 2
samples_per_gpu_unsup = 2
runner = dict(type='IterBasedRunner', max_iters=2)
evaluation = dict(interval=2, metric='mIoU')
checkpoint_config = dict(by_epoch=False, interval=2)
log_config = dict(interval=1)
"""


def test_train_test_cli_round_trip_in_slide_mode(tmp_path):
    """tools.train on the _MT_w_ours config cut to a tiny MiT, on a
    Cityscapes tree (64² crops, slide 64 / 40 on 128x64 val images), 2
    steps with drop path and head dropout live; tools.test on iter_2 gives
    the in-loop mIoU."""
    cfg = Config.fromfile(SEGFORMER.format('semi_MT_w_ours'))
    root = _cityscapes_tree(tmp_path / 'city')
    small = dict(scale=(128, 64), crop=(64, 64))
    path = tmp_path / 'mit_cli.py'
    path.write_text(CLI_CFG.format(
        base=SEGFORMER.format('semi_MT_w_ours'), root=root,
        sup=_small(cfg.data.train.sup.pipeline, **small),
        unsup=_small(cfg.data.train.unsup.pipeline, **small),
        val=_small(cfg.data.val.pipeline, **small)))
    wd = str(tmp_path / 'work')
    state = train_cli.main([str(path), '--work-dir', wd, '--device', 'cpu'])
    assert int(state.step) == 2
    with open(osp.join(wd, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    val = [r for r in records if r['prefix'] == 'val']
    train = [r for r in records if r['prefix'] == 'train']
    assert [r['step'] for r in val] == [2] and len(train) == 2
    assert all('unsup.loss_seg_unsup' in r for r in train)
    results = test_cli.main([str(path), osp.join(wd, 'iter_2'),
                             '--device', 'cpu'])
    assert results['mIoU'] == pytest.approx(val[0]['mIoU'], abs=1e-6)


def test_serving_api_on_a_mit(tmp_path):
    """init_segmentor / inference_segmentor in slide mode on the tiny MiT
    (a 96x160 image: 2 x 4 windows of 64 at stride 32) give the label map
    of the slide inference of the same weights; teacher-PASA serving is
    the ViT's only and refuses the MiT."""
    from s4former_tpu_torch.models.segmentors.inference import \
        slide_inference
    cfg = mit_model_cfg()
    cfg['test_cfg'] = dict(mode='slide', crop_size=(64, 64), stride=(32, 32))
    path = tmp_path / 'mit.py'
    path.write_text(f'model = {cfg!r}\n')
    seg = apis.init_segmentor(str(path), seed=1, device='cpu')
    img = np.random.RandomState(3).randint(0, 256, (96, 160, 3), np.uint8)
    labels = apis.inference_segmentor(seg, img)
    x, _ = apis._prepare_image(seg, img)
    with torch.no_grad():
        logits = slide_inference(seg.model, torch.from_numpy(x), 5,
                                 (64, 64), (32, 32))
    assert labels.shape == (96, 160)
    np.testing.assert_array_equal(labels, logits.argmax(-1)[0].numpy())
    with pytest.raises(NotImplementedError, match='MiT'):
        apis.inference_with_teacher_pasa(seg, img, seg.model.state_dict())


def test_seeded_init_draws_every_mit_parameter():
    """``init_segmentor_weights`` on the MiT: every kernel (dense, conv,
    depthwise [C, 1, 3, 3]) drawn with std 1/sqrt(fan in), every norm
    weight 1 and every bias 0; nothing keeps torch's own init."""
    model = build_segmentor(mit_model_cfg())
    init_segmentor_weights(model, torch.Generator().manual_seed(0))
    kernels = 0
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            kernels += 1
            fan_in = p[0].numel()
            assert abs(p.std().item() * fan_in ** 0.5 - 1) < 0.5, name
        elif name.endswith('weight'):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert torch.equal(p, torch.zeros_like(p)), name
    dw = model.backbone.layers[0][1][0].ffn.layers[1].weight
    assert dw.shape == (16, 1, 3, 3) and kernels == 33
