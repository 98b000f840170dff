"""The ViT model-zoo slice held to the JAX package on the CPU, in f32:
SETR-MLA (``MLANeck``, ``SETRMLAHead``, ``FCNHead`` aux heads) and
Segmenter (``SegmenterMaskTransformerHead``), module by module and whole.

- Each module from perturbed JAX weights through the weight bridge, on
  seeded numpy inputs, with and without a PatchShuffle permutation, in
  train mode (BN on batch statistics, which both packages then update);
  dropout and drop path given the same masks through stand-ins for
  ``jax.random.bernoulli`` and the port's ``models.dropout.keep_mask``.
- The tiny segmentors (``tests/_torch_port.py:MLA_MODEL``, ``SEG_MODEL``):
  the forward, the keys and values JAX ``export_reference_state_dict``
  writes, and the port's state dict back through JAX
  ``convert_mmseg_checkpoint`` to the same variables.
- A 3-step trajectory of each against the jitted JAX step (MLA with PASA
  off, Segmenter with PASA on, the fused pass), the CutMix boxes and
  PatchShuffle permutations injected through the ``dbg_`` keys.
- PASA on a ViT without a cls token: ValueError in the step and in
  teacher-PASA inference (JAX fails on the shapes); teacher-PASA with a
  neck against JAX on an MLA model that has a cls token.
- EMA momenta, learning-rate and weight-decay groups of ``neck.*`` and
  ``auxiliary_head.*`` against JAX; ``tools.train`` -> ``tools.test`` on
  an MLA config, whose checkpoint carries the neck.

Tolerances: module outputs and BN statistics 1e-5 (f32, sums in another
order); whole forwards 1e-4 (through two layers, the neck and the head);
the trajectories those of tests/test_torch_train_step.py (losses 1e-4
relative, states 1e-4 absolute).
"""
import copy
import json
import os.path as osp
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu import apis as japis
from s4former_tpu.config import Config as JConfig
from s4former_tpu.core.checkpoint import (convert_mmseg_checkpoint,
                                          export_reference_state_dict)
from s4former_tpu.core.optim import (
    build_layer_decay_trees as j_build_layer_decay_trees,
    build_lr_mult_tree as j_build_lr_mult_tree)
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu.models.decode_heads.extra_heads import \
    SegmenterMaskTransformerHead as JSegmenterHead
from s4former_tpu.models.decode_heads.misc_heads import FCNHead as JFCNHead
from s4former_tpu.models.decode_heads.misc_heads import \
    SETRMLAHead as JSETRMLAHead
from s4former_tpu.models.necks.necks import MLANeck as JMLANeck
from s4former_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.ema import ema_update_scoped as j_ema_update_scoped
from s4former_tpu.semi.pasa import build_pasa_bias as j_build_pasa_bias
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch import apis
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import (state_dict_from_jax_variables,
                                                train_state_dicts_from_jax)
from s4former_tpu_torch.core.optim import (build_layer_decay_trees,
                                           build_lr_mult_tree)
from s4former_tpu_torch.models import dropout as tdrop
from s4former_tpu_torch.models.decode_heads.extra_heads import \
    SegmenterMaskTransformerHead
from s4former_tpu_torch.models.decode_heads.misc_heads import (FCNHead,
                                                               SETRMLAHead)
from s4former_tpu_torch.models.necks.necks import MLANeck
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.ema import ema_update_scoped
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (FIXTURE, MLA_MODEL, SEG_MODEL,
                               assert_argmax_agrees,
                               jax_train_model, perturbed, torch_train_model,
                               write_cli_config)

MOD_ATOL = 1e-5
FWD_ATOL = 1e-4
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
B, G, NCLS = 2, 4, 5          # batch, token grid, classes
PERM = np.array([[1, 0, 3, 2], [2, 3, 1, 0]], np.int32)   # N = 2 on 4 x 4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _feats(seed, n, c=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, G, G, c).astype(np.float32) for _ in range(n)]


def _mask_for(shape, keep):
    seed = zlib.crc32(repr((tuple(shape), round(float(keep), 6))).encode())
    return np.random.RandomState(seed).rand(*tuple(shape)) < keep


@pytest.fixture
def fixed_masks(monkeypatch):
    """Both packages draw the mask of ``_mask_for`` for a (shape, keep);
    returns the shapes each drew."""
    drawn = {'jax': [], 'port': []}

    def bernoulli(key, p=0.5, shape=None):
        drawn['jax'].append(tuple(shape or ()))
        return jnp.asarray(_mask_for(shape or (), p))

    def keep_mask(generator, keep, shape, device):
        drawn['port'].append(tuple(shape))
        return torch.from_numpy(_mask_for(shape, keep))
    monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', keep_mask)
    return drawn


def _bridged(jmod, args, scope, seed, **init_kw):
    """Perturbed numpy variables of a JAX module and the reference state
    dict the bridge makes of them under ``scope`` (prefix stripped)."""
    v = jmod.init({'params': jax.random.PRNGKey(seed),
                   'dropout': jax.random.PRNGKey(seed + 1)}, *args,
                  **init_kw)
    v = perturbed(dict(v), seed)
    tree = {'params': {scope: v['params']},
            'batch_stats': {scope: v.get('batch_stats', {})}}
    prefix = {'neck_m': 'neck.', 'decode_head_m': 'decode_head.'}[scope]
    sd = {k[len(prefix):]: t for k, t in
          state_dict_from_jax_variables(tree).items()}
    return v, sd


def _head_case(jmod, port, inputs, perm, seed=0):
    """A head in train mode on ``inputs`` in both packages: logits and the
    BN statistics each package updates."""
    jin = [jnp.asarray(x) for x in inputs]
    v, sd = _bridged(jmod, (jin,), 'decode_head_m', seed, train=False)
    port.load_state_dict(sd)
    kw = {} if perm is None else dict(patchmix_n=2)
    want, mutated = jmod.apply(
        jax.tree_util.tree_map(jnp.asarray, v), jin, train=True,
        patchmix_perm=None if perm is None else jnp.asarray(perm),
        mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(3)},
        **kw)
    with torch.no_grad():
        got = port([_t(x) for x in inputs], train=True,
                   patchmix_perm=None if perm is None
                   else torch.from_numpy(perm), generator=torch.Generator(),
                   **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MOD_ATOL)
    stats = state_dict_from_jax_variables(
        {'params': {'decode_head_m': v['params']},
         'batch_stats': {'decode_head_m': jax.tree_util.tree_map(
             np.asarray, dict(mutated.get('batch_stats', {})))}})
    own = port.state_dict()
    for k, want in stats.items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(
                own[k[len('decode_head.'):]].numpy(), want.numpy(), rtol=0,
                atol=MOD_ATOL, err_msg=k)


# --------------------------------------------------------------- modules
@pytest.mark.parametrize('levels', [4, 2])
def test_mla_neck_matches_jax(levels):
    """LayerNorm + biased 1x1 per level, the deepest-first cumulative sum,
    the biased 3x3s; the tuple deepest first."""
    feats = _feats(1, levels, c=24)
    jin = [jnp.asarray(f) for f in feats]
    jneck = JMLANeck(in_channels=[24] * levels, out_channels=8)
    v, sd = _bridged(jneck, (jin,), 'neck_m', seed=2)
    want = jneck.apply(jax.tree_util.tree_map(jnp.asarray, v), jin)
    neck = MLANeck(in_channels=[24] * levels, out_channels=8)
    neck.load_state_dict(sd)
    with torch.no_grad():
        got = neck([_t(f) for f in feats])
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=MOD_ATOL)
    assert sorted(sd) == sorted(neck.state_dict())
    with pytest.raises(ValueError, match='levels'):
        neck([_t(f) for f in feats[1:]])


@pytest.mark.parametrize('perm', [None, PERM], ids=['plain', 'shuffled'])
@pytest.mark.parametrize('num_convs', [0, 2])
def test_fcn_head_matches_jax(fixed_masks, num_convs, perm):
    """num_convs 0 (SETR-MLA's aux heads: conv_seg on the input) and 2
    (dilated 3x3s + conv_cat), in_index 1, dropout 0.1 given the same
    mask."""
    kw = dict(in_channels=16, channels=12, num_classes=NCLS,
              num_convs=num_convs, kernel_size=3 if num_convs else 1,
              dilation=2 if num_convs else 1, concat_input=bool(num_convs),
              in_index=1, dropout_ratio=0.1)
    _head_case(JFCNHead(**kw), FCNHead(**kw), _feats(3, 2), perm)
    assert fixed_masks['port'] == fixed_masks['jax'] == \
        [(B, G, G, 12 if num_convs else 16)]


@pytest.mark.parametrize('perm', [None, PERM], ids=['plain', 'shuffled'])
def test_setr_mla_head_matches_jax(perm):
    kw = dict(in_channels=(16, 16, 16, 16), channels=32, num_classes=NCLS,
              mla_channels=8, up_scale=4, in_index=(0, 1, 2, 3))
    port = SETRMLAHead(**kw)
    _head_case(JSETRMLAHead(**kw), port, _feats(4, 4), perm)
    assert port.conv_seg.in_channels == 32


@pytest.mark.parametrize('perm', [None, PERM], ids=['plain', 'shuffled'])
def test_segmenter_head_matches_jax(fixed_masks, perm):
    """Two plain-attention layers with the drop-path ramp 0 -> 0.2 and
    dropout 0.1, given the same masks; norms at eps 1e-5; no kernel
    launch."""
    kw = dict(in_channels=16, num_layers=2, num_heads=2, embed_dims=32,
              channels=32, num_classes=NCLS, drop_path_rate=0.2,
              drop_rate=0.1, in_index=0)
    port = SegmenterMaskTransformerHead(**kw)
    launches = fa.launch_count
    _head_case(JSegmenterHead(**kw), port, _feats(5, 1), perm)
    assert fa.launch_count == launches
    assert port.drop_paths == [0.0, 0.2]
    assert sorted(set(fixed_masks['port'])) == \
        sorted(set(fixed_masks['jax'])) == \
        [(B, 1, 1), (B, G * G + NCLS, 32), (B, G * G + NCLS, 128)]
    assert not hasattr(port, 'conv_seg')


# --------------------------------------------------- whole segmentors
def _jax_pair(cfg, seed=0):
    """(JAX model, perturbed numpy variables, the port's model loaded
    through the bridge)."""
    jcfg = copy.deepcopy(cfg)
    jcfg['backbone']['use_flash'] = False
    jmodel = j_build_segmentor(jcfg)
    # jitted: eagerly, JAX dispatches (and compiles) op by op
    v = jax.jit(lambda key: init_segmentor_variables(
        jmodel, key, (1, 64, 64, 3)))(jax.random.PRNGKey(seed))
    v = perturbed({'params': v['params'],
                   'batch_stats': v.get('batch_stats', {})}, seed)
    model = torch_train_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax_variables(v))
    return jmodel, v, model


@pytest.mark.parametrize('cfg', [MLA_MODEL, SEG_MODEL],
                         ids=['setr_mla', 'segmenter'])
def test_segmentor_bridge_export_and_back(cfg):
    jmodel, v, model = _jax_pair(cfg)
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    want = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, v),
                        jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    sd = model.state_dict()
    # JAX's export writes the ViT and, of these heads, only conv_seg:
    # each key it writes is the port's, with the same value
    exported = export_reference_state_dict(v)
    assert exported and set(exported) < set(sd)
    for k, want in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), want, err_msg=k)
    # the port's whole state dict is the reference layout JAX reads back
    back = convert_mmseg_checkpoint({k: t.numpy() for k, t in sd.items()},
                                    num_layers=2, num_aux=4)
    paths = jax.tree_util.tree_flatten_with_path(v)[0]
    # every number of each side is on the other (JAX stacks the layers)
    assert sum(np.size(leaf) for _, leaf in paths) == \
        sum(t.numel() for t in sd.values())
    for path, leaf in paths:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), leaf,
                                      err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------- the steps
STEP_KW = dict(num_classes=NCLS, base_lr=0.01, max_iters=100, power=0.9,
               min_lr=1e-4)
S4_FLAGS = dict(
    ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.5,
    attn_mask_seperate_head=True, attn_mask_weight=5.0,
    adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
    negative_class_ranking=True, negative_class_ranking_mode='unsup_only',
    momentum_head_exp=1.0)


def _batches(steps=3):
    rng = np.random.RandomState(11)
    return [{'sup_img': rng.randn(B, 64, 64, 3).astype(np.float32),
             'sup_gt': rng.randint(0, NCLS, (B, 64, 64)).astype(np.int32),
             'unsup_teacher_img': rng.randn(B, 64, 64, 3).astype(np.float32),
             'unsup_student_img': rng.randn(B, 64, 64, 3).astype(np.float32)}
            for _ in range(steps)]


def _injected(step):
    masks = np.ones((B, 64, 64), np.float32)
    masks[0, 8 + step:40 + step, 16:48] = 0
    masks[1, 0:32, 24 + step:56 + step] = 0
    perms = np.stack([np.roll(np.arange(4), step + 1),
                      np.arange(4) if step == 1 else np.array([1, 0, 3, 2])]
                     ).astype(np.int32)
    return masks, perms


@pytest.mark.parametrize('which', ['setr_mla', 'segmenter'])
def test_trajectory_matches_jax_step(which):
    """MLA: PASA off (no cls token), the sequential unsup pass, NCR,
    PatchShuffle undone on the four neck levels; Segmenter: every flag,
    PASA on, the fused 2B pass."""
    cfg = MLA_MODEL if which == 'setr_mla' else SEG_MODEL
    flags = dict(S4_FLAGS, attn_mask_seperate_head=which == 'segmenter')
    jmodel, jstate = jax_train_model(seed=0, cfg=cfg)
    jstep = jax.jit(j_make_semi_train_step(jmodel, JSemiConfig(**flags),
                                           **STEP_KW))
    model = torch_train_model(cfg)
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
    for i, batch in enumerate(_batches()):
        masks, perms = _injected(i)
        batch = dict(batch, dbg_cutmix_mask=masks, dbg_patchmix_perm=perms)
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
        state, logs = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, gen)
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'step {i} {k}')
        assert 0 < float(logs['mask_ratio']) < 1, i
        assert float(logs['unsup.loss_ncr_unsup']) > 0, i
    assert ('unsup.loss_seg_unsup_attn_mask' in logs) == \
        (which == 'segmenter')
    sds = train_state_dicts_from_jax(jstate)
    for which_sd, ours in (('model', state.model.state_dict()),
                           ('momentum', state.momentum),
                           ('ema', state.ema_model.state_dict())):
        ref = sds[which_sd]
        assert sorted(ref) == sorted(ours), which_sd
        for name, want in ref.items():
            np.testing.assert_allclose(
                ours[name].detach().numpy(), want.numpy(), rtol=0,
                atol=STATE_ATOL, err_msg=f'{which_sd} {name}')


def test_pasa_without_cls_token_raises():
    """The step (PASA either way) and teacher-PASA inference refuse a ViT
    built without a cls token, naming the flag."""
    for flags in (S4_FLAGS, dict(S4_FLAGS, attn_mask_seperate_head=False,
                                 use_attn_mask_inline=True)):
        with pytest.raises(ValueError, match='with_cls_token'):
            make_semi_train_step(torch_train_model(MLA_MODEL),
                                 SemiConfig(**flags), **STEP_KW)
    model = torch_train_model(MLA_MODEL).eval()
    seg = apis.Segmentor(model, Config(dict(crop_size=(64, 64))), 'cpu')
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match='with_cls_token'):
        apis.inference_with_teacher_pasa(seg, img, model.state_dict())


def test_teacher_pasa_with_a_neck_matches_jax():
    """On an MLA model with a cls token, the teacher (backbone, neck,
    decode head of the EMA weights) builds the bias as JAX does."""
    cfg = copy.deepcopy(MLA_MODEL)
    cfg['backbone']['with_cls_token'] = True
    jmodel, v, model = _jax_pair(cfg, seed=1)
    ema = perturbed(v, seed=2)
    teacher = state_dict_from_jax_variables(ema)
    assert any(k.startswith('neck.') for k in teacher)
    jcfg = JConfig(dict(crop_size=(64, 64)))
    js = japis.Segmentor(jmodel, jax.tree_util.tree_map(jnp.asarray, v),
                         jcfg)
    j_ema = jax.tree_util.tree_map(jnp.asarray, ema)
    seg = apis.Segmentor(model, Config(dict(crop_size=(64, 64))), 'cpu')
    img = np.random.RandomState(8).randint(0, 256, (50, 60, 3), np.uint8)
    want = japis.inference_with_teacher_pasa(js, img, j_ema)
    got = apis.inference_with_teacher_pasa(seg, img, teacher)
    # the JAX path's student probabilities say where labels must agree
    x, _ = japis._prepare_image(js, img)

    @jax.jit
    def student_probs(student, teacher, x):
        t = jmodel.apply(teacher, method='forward_decode_from_img', img=x,
                         train=False)
        conf = jnp.max(jax.nn.softmax(t, -1), -1)
        pool = t.shape[1] // (x.shape[1] // 16)
        unconf = jnp.mean((1.0 - conf).reshape(1, 4, pool, 4, pool),
                          axis=(2, 4)).reshape(1, -1)
        logits = jmodel.apply(student, method='forward_decode_from_img',
                              img=x, train=False,
                              attn_bias=j_build_pasa_bias(unconf, 5.0, True))
        return jax.nn.softmax(j_resize_bilinear(logits, x.shape[1:3], False),
                              -1)
    probs = np.asarray(student_probs(js.variables, j_ema,
                                     jnp.asarray(x)))[0, :50, :60]
    np.testing.assert_array_equal(want, probs.argmax(-1))
    assert_argmax_agrees(probs, np.eye(NCLS, dtype=np.float32)[got],
                         FWD_ATOL)
    # a teacher state without the neck is refused, not run with the
    # student's neck
    with pytest.raises(RuntimeError, match='neck|Missing'):
        apis.inference_with_teacher_pasa(
            seg, img, {k: t for k, t in teacher.items()
                       if not k.startswith('neck.')})


def test_ema_momenta_of_neck_and_aux_heads_match_jax():
    """The neck and the aux heads lerp with the plain momentum, the
    backbone and the decode head with theirs (JAX semi/ema.py:54-83)."""
    _, v, _ = _jax_pair(MLA_MODEL, seed=3)
    student = perturbed(v, seed=4)
    want = j_ema_update_scoped(
        jax.tree_util.tree_map(jnp.asarray, v['params']),
        jax.tree_util.tree_map(jnp.asarray, student['params']),
        0.9, 0.5, 0.99)
    teacher = state_dict_from_jax_variables({'params': v['params']})
    ema_update_scoped(teacher,
                      state_dict_from_jax_variables(
                          {'params': student['params']}), 0.9, 0.5, 0.99)
    ref = state_dict_from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, want)})
    assert sorted(ref) == sorted(teacher)
    assert any(k.startswith('neck.') for k in ref) and \
        any(k.startswith('auxiliary_head.3.') for k in ref)
    for k, w in ref.items():
        np.testing.assert_allclose(teacher[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def _jax_mults(params, tree):
    """A JAX multiplier tree broadcast to its leaves, through the bridge:
    the multiplier of each port name."""
    full = jax.tree_util.tree_map(
        lambda p, m: np.broadcast_to(np.asarray(m, np.float32),
                                     np.shape(p)).copy(), params, tree)
    return {k: np.unique(t.numpy()) for k, t in
            state_dict_from_jax_variables({'params': full}).items()}


def test_lr_and_weight_decay_groups_match_jax():
    """custom_keys {'head': 10} (the decode and aux heads x10, the neck
    and backbone x1) and the layer-wise decay with its no-decay group."""
    _, v, model = _jax_pair(MLA_MODEL, seed=5)
    params = dict(model.named_parameters())
    lr = build_lr_mult_tree(params, {'head': 10.0})
    want = _jax_mults(v['params'], j_build_lr_mult_tree(
        v['params'], {'head': 10.0}))
    assert {lr[k] for k in lr if k.startswith('neck.')} == {1.0}
    assert {lr[k] for k in lr if k.startswith('auxiliary_head.')} == {10.0}
    ld, wd = build_layer_decay_trees(params, {n: p.dim() for n, p in
                                              params.items()}, 2, 0.65)
    j_ld, j_wd = j_build_layer_decay_trees(v['params'], 2, 0.65)
    j_ld, j_wd = _jax_mults(v['params'], j_ld), _jax_mults(v['params'], j_wd)
    assert sorted(want) == sorted(lr)
    for name in lr:
        assert list(want[name]) == [lr[name]], name
        np.testing.assert_allclose(j_ld[name], [ld[name]], rtol=1e-6,
                                   err_msg=name)
        assert list(j_wd[name]) == [wd[name]], name


# ------------------------------------------------------------ the CLIs
MLA_CLI = """
_base_ = ['./tiny_cli.py']
model = dict(
    backbone=dict(_delete_=True, **{backbone}),
    neck={neck},
    decode_head=dict(_delete_=True, **{head}),
    auxiliary_head={aux},
    attn_mask_seperate_head=False)
"""


def test_mla_train_then_test_cli(tmp_path):
    """tools.train on an MLA config that _base_-inherits the tiny CLI
    config (21 classes, PASA off), then tools.test on its checkpoint,
    which carries the neck."""
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:2]
    split = tmp_path / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    write_cli_config(tmp_path, str(split))
    m = copy.deepcopy(MLA_MODEL)
    m['decode_head']['num_classes'] = 21
    for a in m['auxiliary_head']:
        a['num_classes'] = 21
    path = tmp_path / 'mla_cli.py'
    path.write_text(MLA_CLI.format(backbone=m['backbone'], neck=m['neck'],
                                   head=m['decode_head'],
                                   aux=m['auxiliary_head']))
    wd = str(tmp_path / 'work')
    state = train_cli.main([str(path), '--work-dir', wd, '--device', 'cpu'])
    assert int(state.step) == 2 and state.model.neck is not None
    saved = torch.load(osp.join(wd, 'iter_2', 'state.pt'),
                       weights_only=True)
    assert any(k.startswith('neck.mla.') for k in saved['model'])
    assert any(k.startswith('neck.') for k in saved['ema_model'])
    val = [json.loads(line) for line in open(osp.join(wd, 'metrics.jsonl'))
           if '"val"' in line]
    results = test_cli.main([str(path), osp.join(wd, 'iter_2'),
                             '--device', 'cpu'])
    assert results['mIoU'] == val[-1]['mIoU']
    seg = apis.init_segmentor(str(path), osp.join(wd, 'iter_2'),
                              device='cpu')
    img = osp.join(FIXTURE, 'JPEGImages', stems[0] + '.jpg')
    labels = apis.inference_segmentor(seg, img)
    assert labels.shape == (375, 500) and labels.max() < 21


@pytest.mark.parametrize('name,want', [
    ('setr_mla.py', dict(layers=24, heads=16, dims=1024, cls=False,
                         pos=(1, 1024, 1024), taps=(5, 11, 17, 23))),
    ('segmenter_vit-b_mask.py', dict(layers=12, heads=12, dims=768,
                                     cls=True, pos=(1, 1025, 768),
                                     taps=(11,)))])
def test_full_width_configs_match_jax_parameters(name, want):
    """The base configs at full width (the meta device; JAX by
    ``jax.eval_shape``, so neither allocates): ViT-L without a cls token,
    no final norm, drop rate 0.1 (SETR-MLA) and ViT-B (Segmenter), and
    the parameters counted equal to JAX's."""
    path = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                    'models', name)
    with torch.device('meta'):
        model = torch_train_model(dict(Config.fromfile(path).model))
    bb = model.backbone
    assert (len(bb.layers), bb.num_heads, bb.embed_dims, bb.with_cls_token,
            tuple(bb.pos_embed.shape), bb.out_indices) == \
        (want['layers'], want['heads'], want['dims'], want['cls'],
         want['pos'], want['taps'])
    assert not bb.final_norm and bb.drop_rate == (0.1 if name ==
                                                  'setr_mla.py' else 0.0)
    jcfg = copy.deepcopy(dict(JConfig.fromfile(path).model))
    jcfg['backbone']['use_flash'] = False
    jmodel = j_build_segmentor(jcfg)
    shapes = jax.eval_shape(lambda: init_segmentor_variables(
        jmodel, jax.random.PRNGKey(0), (1, 512, 512, 3)))
    j_count = sum(int(np.prod(x.shape)) for x in
                  jax.tree_util.tree_leaves(shapes['params']))
    count = sum(p.numel() for p in model.parameters())
    assert count == j_count == {'setr_mla.py': 309364319,
                                'segmenter_vit-b_mask.py': 102395174}[name]
