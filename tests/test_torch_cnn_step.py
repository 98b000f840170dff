"""The CNN slice's training path held to the JAX package on the CPU, in
f32: the tiny DeepLabV3+ (``tests/_torch_port.py:cnn_model``, ResNet-18
V1c) through the S4Former step against the jitted JAX step, through
``tools.train`` -> ``tools.test``, and the PatchShuffle's tiling rule on a
stride-8 map.

- Three steps with every flag of the fixture config: PASA on
  (``attn_mask_seperate_head``; the bias is built from the teacher and
  ignored by the ResNet, and the PASA pass still runs in the fused 2B
  batch, so the BN statistics span 2B), PatchShuffle + CutMix (boxes and
  permutations injected through the ``dbg_`` keys), NCR and the EMA with
  the annealed head momentum. Each step starts from the JAX step's state
  (loaded through the bridge), so the steps are compared one at a time.
  Held at 1e-4: every log (losses, accuracy, mask ratio), the EMA teacher
  and every BN running statistic. The parameter update is held leaf by
  leaf against a witness, the same JAX step run in x64 from the same
  state: at this size a ReLU input can sit within 1e-5 of 0 (in step 0
  one in ``sep_bottleneck.1`` does), and an f32 sum order decides its
  side, which moves every leaf below it by up to ~7e-3 of its largest
  entry. JAX's f32 step and the port each flip such ties, in different
  places (JAX's f32 step parts from its x64 run by 3e-2 in step 0 and
  2.4e-2 in step 1; the port by 5.2e-2 and 6.4e-5; in step 0 the port's
  tie sits above JAX's, so its leaves below part by up to 3.3x JAX's
  distance). So every leaf of the port is within WITNESS_MULT x
  JAX-f32's own distance to the witness, or within KINK_RTOL of the
  witness's largest entry of that leaf; and in step 2,
  where the witness shows no flip (JAX f32 within WITNESS_RTOL of it on
  every leaf), every leaf is within 1e-4 of JAX's largest entry of that
  leaf. At depth 18: the jitted JAX step compiles for about twice as long
  at depth 50.
- The mixes' ``patchsize`` is 8: the head's undo cuts its input map,
  1/8 of the image for a -D8 ResNet, into blocks of ``PatchMix_N``
  features, so the image's super-patches must be 8 * ``PatchMix_N``
  pixels. At the default 16 the JAX step fails on the shapes; the port
  raises ValueError naming the cause.
- ``tools.train`` on a CNN variant of the tiny CLI config (2 steps, eval
  and checkpoint at 2), then ``tools.test`` on the checkpoint: the same
  mIoU as the in-loop one; the checkpoint carries the ResNet's BN
  statistics, the student's and the teacher's.

The images differ in brightness and contrast from sample to sample (as
photographs do): noise images of one distribution pool to near-equal
features, which leaves the image pool's batch statistics degenerate.
"""
import copy
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch import apis
from s4former_tpu_torch.core.checkpoint import train_state_dicts_from_jax
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (FIXTURE, cnn_model, jax_cnn_train_model,
                               torch_train_model, write_cli_config)

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
UPDATE_RTOL = 1e-4     # a leaf's update where no ReLU tie flips
WITNESS_MULT = 4       # otherwise: a multiple of JAX-f32's distance to x64
KINK_RTOL = 1e-2       # or a share of the leaf's largest x64 entry
WITNESS_RTOL = 2e-4    # JAX f32 against x64 in a step with no flip
CLEAN_STEP = 2
B, NCLS = 2, 5
S = 64                # crop: the -D8 stage 4 is S/8 x S/8
STEP_KW = dict(num_classes=NCLS, base_lr=0.01, max_iters=100, power=0.9,
               min_lr=1e-4)
S4_FLAGS = dict(
    ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.45,
    attn_mask_seperate_head=True, attn_mask_weight=5.0,
    adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
    patchsize=8, negative_class_ranking=True,
    negative_class_ranking_mode='unsup_only', momentum_head_exp=1.0)


def _images(rng, sign):
    """[B, S, S, 3] noise images of very different brightness and
    contrast, sample to sample and between the labeled (``sign`` 1) and
    the unlabeled (-1) batch."""
    gain = np.linspace(0.4, 2.5, B)[:, None, None, None]
    offset = sign * np.linspace(-1.5, 1.5, B)[:, None, None, None]
    return (rng.randn(B, S, S, 3) * gain + offset).astype(np.float32)


def _batches(steps=3):
    rng = np.random.RandomState(11)
    return [{'sup_img': _images(rng, 1),
             'sup_gt': rng.randint(0, NCLS, (B, S, S)).astype(np.int32),
             'unsup_teacher_img': _images(rng, -1),
             'unsup_student_img': _images(rng, -1)}
            for _ in range(steps)]


def _injected(step, grid=S // 16):
    """A CutMix box a sample and PatchShuffle permutations of the
    ``grid`` x ``grid`` super-patches (sample 1 unshuffled at step 1)."""
    masks = np.ones((B, S, S), np.float32)
    for b in range(B):
        masks[b, 4 * b + step:S - 12 + step, 2 * b:S - 8] = 0
    rs = np.random.RandomState(step)
    perms = np.stack([np.arange(grid * grid) if (step, b) == (1, 1) else
                      rs.permutation(grid * grid) for b in range(B)]
                     ).astype(np.int32)
    return masks, perms


def _x64(tree):
    """A JAX tree with its f32 leaves in f64 (inside ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)
                              if np.asarray(a).dtype == np.float32 else a),
        tree)


def _updates(new, old):
    """{name: new - old} over the parameters of two state dicts (f64)."""
    return {n: new[n].double() - old[n].double() for n in old
            if not n.endswith(('running_mean', 'running_var'))}


def test_deeplabv3plus_steps_match_jax_step():
    """Three steps, each from the JAX step's state (the port is loaded with
    it through the bridge before each step): every log within LOSS_RTOL,
    the EMA teacher and every BN running statistic within STATE_ATOL, and
    every parameter leaf's update against the x64 witness (the module
    docstring): within WITNESS_MULT x JAX-f32's distance to it or
    KINK_RTOL of its largest entry, and in CLEAN_STEP within UPDATE_RTOL
    of JAX's."""
    cfg = cnn_model(depth=18)
    jmodel, jstate = jax_cnn_train_model(cfg, seed=0)
    jfn = j_make_semi_train_step(jmodel, JSemiConfig(**S4_FLAGS), **STEP_KW)
    jstep = jax.jit(jfn)
    with jax.enable_x64(True):
        jstep64 = jax.jit(jfn)
    model = torch_train_model(cfg)
    step = make_semi_train_step(model, SemiConfig(**S4_FLAGS), **STEP_KW)
    launches = fa.launch_count
    for i, batch in enumerate(_batches()):
        masks, perms = _injected(i)
        batch = dict(batch, dbg_cutmix_mask=masks, dbg_patchmix_perm=perms)
        state = train_state_from_jax(model, jstate)
        before = train_state_dicts_from_jax(jstate)
        with jax.enable_x64(True):
            witness, _ = jstep64(_x64(jstate), _x64(batch),
                                 jax.random.PRNGKey(0))
            witness = train_state_dicts_from_jax(
                jax.tree_util.tree_map(np.asarray, witness))
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              jax.random.PRNGKey(0))
        state, logs = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                           torch.Generator().manual_seed(0))
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'step {i} {k}')
        assert 0 < float(logs['mask_ratio']) < 1, i
        assert float(logs['unsup.loss_ncr_unsup']) > 0, i
        assert 'unsup.loss_seg_unsup_attn_mask' in logs
        after = train_state_dicts_from_jax(jstate)
        ours = state.model.state_dict()
        assert sorted(after['model']) == sorted(ours)
        for name, w in after['model'].items():
            if name.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(ours[name].numpy(), w.numpy(),
                                           rtol=0, atol=STATE_ATOL,
                                           err_msg=f'step {i} {name}')
        want = _updates(witness['model'], before['model'])
        jax32 = _updates(after['model'], before['model'])
        got = _updates(ours, before['model'])
        assert len(got) == len(want) > 0
        for name, u in want.items():
            top = float(u.abs().max())
            err = float((got[name] - u).abs().max())
            jax_err = float((jax32[name] - u).abs().max())
            assert err <= max(WITNESS_MULT * jax_err, KINK_RTOL * top), \
                (i, name, err, jax_err, top)
            if i == CLEAN_STEP:
                assert jax_err <= WITNESS_RTOL * top, (i, name, jax_err, top)
                err = float((got[name] - jax32[name]).abs().max())
                assert err <= UPDATE_RTOL * float(jax32[name].abs().max()), \
                    (i, name, err)
        ema = state.ema_model.state_dict()
        for name, w in after['ema'].items():
            np.testing.assert_allclose(ema[name].numpy(), w.numpy(), rtol=0,
                                       atol=STATE_ATOL,
                                       err_msg=f'step {i} ema {name}')
    assert fa.launch_count == launches         # a CNN launches no kernel


def test_patch_shuffle_must_tile_the_stride_8_map():
    """At the default patchsize 16 the 64² image has 2 x 2 super-patches
    of 32 pixels, and the head's 8 x 8 input would need 4 x 4 blocks of 2:
    JAX fails on the shapes, the port raises ValueError."""
    flags = dict(S4_FLAGS, patchsize=16)
    masks, _ = _injected(0)
    perms = _injected(0, grid=2)[1]
    batch = dict(_batches(1)[0], dbg_cutmix_mask=masks,
                 dbg_patchmix_perm=perms)
    cfg = cnn_model(depth=18)
    jmodel, jstate = jax_cnn_train_model(cfg, seed=0)
    jstep = j_make_semi_train_step(jmodel, JSemiConfig(**flags), **STEP_KW)
    with pytest.raises(TypeError, match='reshape'):
        jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    model = torch_train_model(cfg)
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    with pytest.raises(ValueError, match='does not tile a 8 x 8'):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
             torch.Generator().manual_seed(0))


CNN_CLI = """
_base_ = ['./tiny_cli.py']
model = dict(
    backbone=dict(_delete_=True, **{backbone}),
    decode_head=dict(_delete_=True, **{head}),
    auxiliary_head={aux},
    patchsize=8)
"""


def test_cnn_train_then_test_cli(tmp_path):
    """tools.train on a DeepLabV3+ variant of the tiny CLI config (ResNet-18
    V1c, 21 classes, every S4Former flag, patchsize 8), then tools.test on
    its checkpoint, then a request through init_segmentor on it."""
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:2]
    split = tmp_path / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    write_cli_config(tmp_path, str(split))
    m = copy.deepcopy(cnn_model(depth=18, num_classes=21))
    path = tmp_path / 'cnn_cli.py'
    path.write_text(CNN_CLI.format(backbone=m['backbone'],
                                   head=m['decode_head'],
                                   aux=m['auxiliary_head']))
    wd = str(tmp_path / 'work')
    state = train_cli.main([str(path), '--work-dir', wd, '--device', 'cpu'])
    assert int(state.step) == 2
    saved = torch.load(osp.join(wd, 'iter_2', 'state.pt'),
                       weights_only=True)
    for part in ('model', 'ema_model'):
        bn = [k for k in saved[part]
              if k.startswith('backbone.') and k.endswith('running_var')]
        # the stem 3, 8 blocks x 2, a shortcut in layers 2-4
        assert len(bn) == 22, (part, len(bn))
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
