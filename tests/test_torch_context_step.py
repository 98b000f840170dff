"""The context-head slice's training path held to the JAX package on the
CPU, in f32: a tiny EMANet (``tests/_torch_port.py:emanet_model``, the
narrowed ResNetV1c-18-D8 with ``EMAHead``) through the S4Former step
against the jitted JAX step, the PatchShuffle's tiling rule on its 1/8
map, and the tiny DeepLabV3 on MobileNetV2-D8 through ``tools.train`` ->
``tools.test``.

Three steps with the flags of ``tests/test_torch_cnn_step.py``
(``S4_FLAGS``: PASA built and ignored by the backbone, PatchShuffle +
CutMix injected through the ``dbg_`` keys, NCR, the EMA with the annealed
head momentum), each from the JAX step's state, held as
``tests/test_torch_realtime_step.py`` holds STDC: every log within
LOSS_RTOL, the EMA teacher, the BN statistics and EMAHead's ``bases``
(which the student's train-mode passes move by the head's momentum, and
the teacher's lerp with the head's EMA momentum) within STATE_ATOL, and
each parameter leaf's update within UPDATE_RTOL of JAX's f32 step; where
a leaf is not, against the same JAX step in x64 (the witness, compiled
only then): within WITNESS_MULT x JAX-f32's own distance to it or
KINK_RTOL of its largest entry; or, where the port's own f32 step sits at
a ReLU tie, within WITNESS_MULT x the distance the port's update moves
when its inputs move by one ulp (its step on ``_ulp_moved`` inputs). In
step 0 the port's update of ``layer4.0.conv2`` parts from x64 by 2.2e-2
of its largest entry (JAX-f32 by 5.2e-3), and moving the inputs one ulp
moves it by the same 2.2e-2: the tie, not a fault, which would not move
with an ulp. ``ema_mid_conv`` gets no gradient (its
output is detached), so its update is weight decay's and momentum's
alone, in both packages. The steps start from states with the annealed
head momentum set, so the jitted step compiles once.
"""
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
from s4former_tpu_torch.core.checkpoint import (load_checkpoint,
                                                save_checkpoint,
                                                train_state_dicts_from_jax)
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                make_semi_train_step,
                                                train_state_from_jax)
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (FIXTURE, emanet_model, jax_cnn_train_model,
                               mobilenet_v2_model, torch_train_model,
                               write_cli_config)
from tests.test_torch_cnn_step import (CNN_CLI, S, S4_FLAGS, STEP_KW,
                                       _batches, _injected, _updates, _x64)

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
UPDATE_RTOL = 1e-4     # a leaf's update where no ReLU tie flips
WITNESS_MULT = 4       # otherwise: a multiple of JAX-f32's distance to x64
KINK_RTOL = 1e-2       # or a share of the leaf's largest x64 entry
PATCHSIZE = 8
ANNEALED = 0.995       # the start state's annealed head momentum
BASES = 'decode_head.ema_module.bases'


@pytest.fixture(scope='module')
def emanet_jax():
    """(config, JAX model, JAX TrainState) of the tiny EMANet."""
    cfg = emanet_model()
    return (cfg,) + jax_cnn_train_model(cfg, seed=0)


def _ulp_moved(batch):
    """``batch`` with every image value moved one f32 ulp up or down
    (seeded)."""
    rs = np.random.RandomState(0)
    out = dict(batch)
    for k in ('sup_img', 'unsup_teacher_img', 'unsup_student_img'):
        to = np.where(rs.rand(*batch[k].shape) < 0.5, -np.inf, np.inf)
        out[k] = np.nextafter(batch[k], to.astype(np.float32))
    return out


def _ulp_step(cfg, flags, jstate, batch, before):
    """The port's parameter updates of one step from ``jstate`` on
    ``_ulp_moved(batch)``."""
    model = torch_train_model(cfg)
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    state, _ = step(state, {k: torch.from_numpy(v)
                            for k, v in _ulp_moved(batch).items()},
                    torch.Generator().manual_seed(0))
    return _updates(state.model.state_dict(), before['model'])


def _near(got, want, what):
    np.testing.assert_allclose(
        got.numpy(), want.numpy(), rtol=0,
        atol=STATE_ATOL * max(1.0, float(want.abs().max())), err_msg=what)


def test_emanet_steps_match_jax_step(emanet_jax, tmp_path):
    """Three steps, each from the JAX step's state: logs, the EMA teacher,
    BN statistics and ``bases`` (moved in each step); each leaf's update
    within UPDATE_RTOL of JAX's f32 step, or where not, against the x64
    witness (the module docstring); no kernel launch. The last state
    through a training checkpoint and back: the student's and the
    teacher's ``bases`` bit for bit."""
    flags = dict(S4_FLAGS, patchsize=PATCHSIZE)
    cfg, jmodel, jstate = emanet_jax
    jstate = jstate.replace(annealed_momentum=jnp.float32(ANNEALED))
    jfn = j_make_semi_train_step(jmodel, JSemiConfig(**flags), **STEP_KW)
    jstep = jax.jit(jfn)
    jstep64 = None
    model = torch_train_model(cfg)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    launches = fa.launch_count
    ratios = []
    for i, batch in enumerate(_batches()):
        masks, perms = _injected(i, S // (2 * PATCHSIZE))
        batch = dict(batch, dbg_cutmix_mask=masks, dbg_patchmix_perm=perms)
        state = train_state_from_jax(model, jstate)
        before = train_state_dicts_from_jax(jstate)
        start = jstate
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
        ratios.append(float(logs['mask_ratio']))
        assert float(logs['unsup.loss_ncr_unsup']) > 0, i
        after = train_state_dicts_from_jax(jstate)
        ours = state.model.state_dict()
        assert sorted(after['model']) == sorted(ours)
        assert not torch.equal(after['model'][BASES], before['model'][BASES])
        for name, w in after['model'].items():
            if name.endswith(('running_mean', 'running_var', 'bases')):
                _near(ours[name], w, f'step {i} {name}')
        jax32 = _updates(after['model'], before['model'])
        got = _updates(ours, before['model'])
        assert len(got) == len(jax32) > 0
        far = [name for name, u in jax32.items()
               if float((got[name] - u).abs().max()) >
               UPDATE_RTOL * float(u.abs().max())]
        if far:
            if jstep64 is None:
                with jax.enable_x64(True):
                    jstep64 = jax.jit(jfn)
            with jax.enable_x64(True):
                witness, _ = jstep64(_x64(start), _x64(batch),
                                     jax.random.PRNGKey(0))
                witness = train_state_dicts_from_jax(
                    jax.tree_util.tree_map(np.asarray, witness))
            want = _updates(witness['model'], before['model'])
            own = None
            for name in far:
                u = want[name]
                top = float(u.abs().max())
                err = float((got[name] - u).abs().max())
                jax_err = float((jax32[name] - u).abs().max())
                if err <= max(WITNESS_MULT * jax_err, KINK_RTOL * top):
                    continue
                # the port's own tie: its step on inputs one ulp away
                if own is None:
                    own = _ulp_step(cfg, flags, start, batch, before)
                own_err = float((own[name] - got[name]).abs().max())
                assert err <= WITNESS_MULT * own_err, \
                    (i, name, err, jax_err, own_err, top)
        ema = state.ema_model.state_dict()
        assert sorted(after['ema']) == sorted(ema)
        for name, w in after['ema'].items():
            _near(ema[name], w, f'step {i} ema {name}')
    # the confidence mask: partial in a step, at most whole in each
    assert all(0 < r <= 1 for r in ratios) and min(ratios) < 1, ratios
    assert fa.launch_count == launches
    path = save_checkpoint(str(tmp_path), 3, state)
    back = load_checkpoint(path, train_state_from_jax(
        torch_train_model(cfg), start))
    for part in ('model', 'ema_model'):
        assert torch.equal(getattr(back, part).state_dict()[BASES],
                           getattr(state, part).state_dict()[BASES]), part


def test_emanet_patch_shuffle_must_tile_the_eighth_map(emanet_jax):
    """At the default patchsize 16 the 64² image has 2 x 2 super-patches
    of 32 pixels, and EMAHead's 8 x 8 input would need 2 x 2 blocks of 4:
    JAX fails on the shapes, the port raises ValueError."""
    flags = dict(S4_FLAGS, patchsize=16)
    masks, perms = _injected(0, 2)
    batch = dict(_batches(1)[0], dbg_cutmix_mask=masks,
                 dbg_patchmix_perm=perms)
    cfg, jmodel, jstate = emanet_jax
    jstep = j_make_semi_train_step(jmodel, JSemiConfig(**flags), **STEP_KW)
    with pytest.raises(TypeError, match='reshape'):
        jax.eval_shape(jstep, jstate,
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    model = torch_train_model(cfg)
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    with pytest.raises(ValueError, match='does not tile a 8 x 8'):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
             torch.Generator().manual_seed(0))


@pytest.mark.parametrize('declared', [True, False])
def test_only_declared_parameters_may_go_unread(declared):
    """The step gives a parameter that no loss reads a zero gradient, as
    JAX does, only where its module declares it (EMAHead's frozen
    ``ema_mid_conv``); an undeclared one raises, naming it."""
    torch.manual_seed(0)
    model = torch_train_model(emanet_model())
    if not declared:
        model.decode_head.unused_parameters = ()
    step = make_semi_train_step(model, SemiConfig(**S4_FLAGS), **STEP_KW)
    masks, perms = _injected(0)
    batch = {k: torch.from_numpy(v) for k, v in dict(
        _batches(1)[0], dbg_cutmix_mask=masks,
        dbg_patchmix_perm=perms).items()}
    state = create_train_state(model, ema=True)
    if not declared:
        with pytest.raises(RuntimeError,
                           match='decode_head.ema_mid_conv.conv.weight'):
            step(state, batch, torch.Generator().manual_seed(0))
        return
    state, logs = step(state, batch, torch.Generator().manual_seed(0))
    assert int(state.step) == 1
    assert all(np.isfinite(float(v)) for v in logs.values())


def test_mobilenet_v2_deeplabv3_train_then_test_cli(tmp_path):
    """tools.train on a DeepLabV3-MobileNetV2-D8 variant of the tiny CLI
    config (``mobilenet_v2_model`` at 21 classes, every S4Former flag,
    patchsize 8): 2 steps, eval and checkpoint; the checkpoint carries the
    backbone's BN statistics, the student's and the teacher's; tools.test
    on it gives the in-loop mIoU; a request through init_segmentor on it;
    a small request's labels the same through teacher-PASA inference with
    its teacher."""
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:2]
    split = tmp_path / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    write_cli_config(tmp_path, str(split))
    m = mobilenet_v2_model(num_classes=21)
    path = tmp_path / 'mnv2_cli.py'
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
        assert len(bn) == 51, (part, len(bn))
    val = [json.loads(line) for line in open(osp.join(wd, 'metrics.jsonl'))
           if '"val"' in line]
    results = test_cli.main([str(path), osp.join(wd, 'iter_2'),
                             '--device', 'cpu'])
    assert results['mIoU'] == val[-1]['mIoU']
    seg = apis.init_segmentor(str(path), osp.join(wd, 'iter_2'),
                              device='cpu')
    labels = apis.inference_segmentor(
        seg, osp.join(FIXTURE, 'JPEGImages', stems[0] + '.jpg'))
    assert labels.shape == (375, 500) and labels.max() < 21
    # teacher-PASA on a crop-sized request (the confidence map is pooled
    # to the 16-pixel token grid, as JAX's): the bias is built from the
    # teacher and ignored by the CNN, as in JAX, so the plain labels
    small = np.random.RandomState(8).randint(0, 256, (50, 60, 3), np.uint8)
    np.testing.assert_array_equal(
        apis.inference_with_teacher_pasa(seg, small, saved['ema_model']),
        apis.inference_segmentor(seg, small))
