"""The real-time slice's training path held to the JAX package on the
CPU, in f32: the tiny STDC (``tests/_torch_port.py:stdc_model``, its
``STDCHead`` an aux head of 2 classes against 5-class labels) through the
S4Former step against the jitted JAX step, and the PatchShuffle's tiling
rule on STDC's 1/8 map.

Three steps with every flag of ``tests/test_torch_cnn_step.py``
(``S4_FLAGS``: PASA built and ignored by the backbone, PatchShuffle +
CutMix injected through the ``dbg_`` keys, NCR, the EMA with the annealed
head momentum), each from the JAX step's state, held as that file holds
DeepLabV3+: every log within LOSS_RTOL (``aux_2.loss_ce``, the 2-class
head's, counts the labels 2-4 with an nll of 0 in its mean, as JAX's
one-hot does), the EMA teacher and the BN statistics within STATE_ATOL,
and each parameter leaf's update within UPDATE_RTOL of JAX's f32 step;
where a leaf is not (an f32 sum order decides the side of a ReLU input
within ~1e-5 of 0, which moves the leaves below it; at this size it does
in every step), against the same JAX step in x64 (the witness): within
WITNESS_MULT x JAX-f32's own distance to it or KINK_RTOL of its largest
entry. The steps start from states with the annealed head momentum set
(ANNEALED), so each jitted step compiles once. Then STDC through
``tools.train`` -> ``tools.test``.

The mixes' ``patchsize`` is 8: the decode head undoes the shuffle on the
fused 1/8 map in blocks of ``PatchMix_N``; at the default 16 the JAX step
fails on the shapes and the port raises ValueError.
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
from s4former_tpu_torch.core.checkpoint import train_state_dicts_from_jax
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (FIXTURE, jax_cnn_train_model, stdc_model,
                               torch_train_model, write_cli_config)
from tests.test_torch_cnn_step import (CNN_CLI, S, S4_FLAGS, STEP_KW,
                                       _batches, _injected, _updates, _x64)

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
UPDATE_RTOL = 1e-4     # a leaf's update where no ReLU tie flips
WITNESS_MULT = 4       # otherwise: a multiple of JAX-f32's distance to x64
KINK_RTOL = 1e-2       # or a share of the leaf's largest x64 entry
PATCHSIZE = 8
ANNEALED = 0.995       # the start state's annealed head momentum


@pytest.fixture(scope='module')
def stdc_jax():
    """(config, JAX model, JAX TrainState) of the tiny STDC."""
    cfg = stdc_model()
    return (cfg,) + jax_cnn_train_model(cfg, seed=0)


def test_stdc_steps_match_jax_step(stdc_jax):
    """Three steps, each from the JAX step's state: logs (the 2-class
    head's loss among them), EMA and BN statistics; each leaf's update
    within UPDATE_RTOL of JAX's f32 step, or where not, against the x64
    witness (the module docstring); no kernel launch."""
    flags = dict(S4_FLAGS, patchsize=PATCHSIZE)
    cfg, jmodel, jstate = stdc_jax
    # a state past its first step, as every later one: the annealed head
    # momentum is set, so the jitted steps compile once (the first step's
    # plain momentum is held in tests/test_torch_cnn_step.py)
    jstate = jstate.replace(annealed_momentum=jnp.float32(ANNEALED))
    jfn = j_make_semi_train_step(jmodel, JSemiConfig(**flags), **STEP_KW)
    jstep = jax.jit(jfn)
    with jax.enable_x64(True):
        jstep64 = jax.jit(jfn)
    model = torch_train_model(cfg)
    assert model.auxiliary_head[2].num_classes == 2
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    launches = fa.launch_count
    for i, batch in enumerate(_batches()):
        assert (batch['sup_gt'] >= 2).mean() > 0.5
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
        assert 'aux_2.loss_ce' in logs
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(logs[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'step {i} {k}')
        assert 0 < float(logs['mask_ratio']) < 1, i
        after = train_state_dicts_from_jax(jstate)
        ours = state.model.state_dict()
        assert sorted(after['model']) == sorted(ours)
        for name, w in after['model'].items():
            if name.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(
                    ours[name].numpy(), w.numpy(), rtol=0,
                    atol=STATE_ATOL * max(1.0, float(w.abs().max())),
                    err_msg=f'step {i} {name}')
        jax32 = _updates(after['model'], before['model'])
        got = _updates(ours, before['model'])
        assert len(got) == len(jax32) > 0
        far = [name for name, u in jax32.items()
               if float((got[name] - u).abs().max()) >
               UPDATE_RTOL * float(u.abs().max())]
        if far:
            with jax.enable_x64(True):
                witness, _ = jstep64(_x64(start), _x64(batch),
                                     jax.random.PRNGKey(0))
                witness = train_state_dicts_from_jax(
                    jax.tree_util.tree_map(np.asarray, witness))
            want = _updates(witness['model'], before['model'])
            for name in far:
                u = want[name]
                top = float(u.abs().max())
                err = float((got[name] - u).abs().max())
                jax_err = float((jax32[name] - u).abs().max())
                assert err <= max(WITNESS_MULT * jax_err, KINK_RTOL * top), \
                    (i, name, err, jax_err, top)
        ema = state.ema_model.state_dict()
        for name, w in after['ema'].items():
            np.testing.assert_allclose(
                ema[name].numpy(), w.numpy(), rtol=0,
                atol=STATE_ATOL * max(1.0, float(w.abs().max())),
                err_msg=f'step {i} ema {name}')
    assert fa.launch_count == launches


def test_stdc_patch_shuffle_must_tile_the_eighth_map(stdc_jax):
    """At the default patchsize 16 the 64² image has 2 x 2 super-patches
    of 32 pixels, and the decode head's 8 x 8 input would need 2 x 2
    blocks of 4: JAX fails on the shapes, the port raises ValueError."""
    flags = dict(S4_FLAGS, patchsize=16)
    masks, perms = _injected(0, 2)
    batch = dict(_batches(1)[0], dbg_cutmix_mask=masks,
                 dbg_patchmix_perm=perms)
    cfg, jmodel, jstate = stdc_jax
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


def test_stdc_train_then_test_cli(tmp_path):
    """tools.train on an STDC variant of the tiny CLI config (the tiny STDC
    at 21 classes but the 2-class ``STDCHead``, every S4Former flag,
    patchsize 8): 2 steps with the STDCHead's loss finite, eval and
    checkpoint; tools.test on it gives the in-loop mIoU; a request through
    init_segmentor on it."""
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:2]
    split = tmp_path / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    write_cli_config(tmp_path, str(split))
    m = stdc_model(num_classes=21)
    assert m['auxiliary_head'][2]['num_classes'] == 2
    path = tmp_path / 'stdc_cli.py'
    path.write_text(CNN_CLI.format(backbone=m['backbone'],
                                   head=m['decode_head'],
                                   aux=m['auxiliary_head']))
    wd = str(tmp_path / 'work')
    state = train_cli.main([str(path), '--work-dir', wd, '--device', 'cpu'])
    assert int(state.step) == 2
    lines = open(osp.join(wd, 'metrics.jsonl')).read().splitlines()
    losses = [json.loads(line)['aux_2.loss_ce'] for line in lines
              if 'aux_2.loss_ce' in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    val = [json.loads(line) for line in lines if '"val"' in line]
    results = test_cli.main([str(path), osp.join(wd, 'iter_2'),
                             '--device', 'cpu'])
    assert results['mIoU'] == val[-1]['mIoU']
    seg = apis.init_segmentor(str(path), osp.join(wd, 'iter_2'),
                              device='cpu')
    labels = apis.inference_segmentor(
        seg, osp.join(FIXTURE, 'JPEGImages', stems[0] + '.jpg'))
    assert labels.shape == (375, 500) and labels.max() < 21
