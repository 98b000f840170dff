"""The Swin and HRNet slice's training path held to the JAX package on the
CPU, in f32: tiny UPerNet-Swin and OCRNet-HRNet
(``tests/_torch_port.py:upernet_swin_model``, ``ocrnet_model``) through
the S4Former step against the jitted JAX step, the cascade through
``tools.train`` -> ``tools.test``, and the PatchShuffle's tiling rule on
OCRNet's 1/4 map.

Three steps with every flag of ``tests/test_torch_cnn_step.py``
(``S4_FLAGS``: PASA built and ignored by both backbones, PatchShuffle +
CutMix injected through the ``dbg_`` keys, NCR, the EMA with the annealed
head momentum), each from the JAX step's state, held as that file holds
DeepLabV3+: every log within LOSS_RTOL, the EMA teacher and the BN
statistics within STATE_ATOL, and each parameter leaf's update against
the same JAX step in x64 (the witness): within WITNESS_MULT x JAX-f32's
own distance to it or KINK_RTOL of its largest entry; and, in the steps
where no f32 step flips a ReLU tie (JAX f32 within WITNESS_RTOL of x64 on
every leaf, checked), within UPDATE_RTOL of JAX's f32 step: UPerNet-Swin's
steps 1 and 2 (in step 0 JAX's f32 step parts from x64 by 4.2e-4 of the
largest update in the UPer head's pyramid), OCRNet's step 2 (in step 1 by
2.5e-4; in step 0 the port's own f32 step sits at a tie: moving its inputs
by one ulp moves its update of the OCR query's first BN bias by 6.8e-3 of
that leaf's largest entry, as far as it parts from JAX and from x64).

The mixes' ``patchsize``: UPerNet-Swin keeps 16 (no head undoes the
shuffle: the UPer head never does, the aux head is handed no
permutation); OCRNet's first stage undoes it on its 1/4 map in blocks of
``PatchMix_N``, so its super-patches are 4 * ``PatchMix_N`` pixels:
``patchsize`` 4. At 16 the JAX step fails on the shapes and the port
raises ValueError.

The cascade's EMA: JAX's stages (``cascade_heads_{i}``) lie outside its
head group, so they lerp with the plain momentum, not the annealed head
momentum, and the port's do too (checked through the EMA teacher).
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
from tests._torch_port import (FIXTURE, jax_cnn_train_model, ocrnet_model,
                               torch_train_model, upernet_swin_model,
                               write_cli_config)
from tests.test_torch_cnn_step import (S, S4_FLAGS, STEP_KW, _batches,
                                       _injected, _updates, _x64)

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
UPDATE_RTOL = 1e-4     # a leaf's update where no ReLU tie flips
WITNESS_MULT = 4       # otherwise: a multiple of JAX-f32's distance to x64
KINK_RTOL = 1e-2       # or a share of the leaf's largest x64 entry
WITNESS_RTOL = 2e-4    # JAX f32 against x64 in a step with no flip
# the model (two Swin stages, one HRNet module a stage: the jitted JAX
# step compiles twice, f32 and x64), its mixes' patchsize, the image's
# super-patch grid, the steps where neither f32 step flips a tie
CASES = {'upernet_swin': (lambda: upernet_swin_model(stages=2), 16, S // 32,
                          (1, 2)),
         'ocrnet_hrnet': (lambda: ocrnet_model(stage3_modules=1), 4, S // 8,
                          (2,))}


@pytest.mark.parametrize('which', sorted(CASES))
def test_steps_match_jax_step(which):
    """Three steps, each from the JAX step's state: logs, EMA and BN
    statistics; each leaf's update against the x64 witness (the module
    docstring); no kernel launch."""
    make_cfg, patchsize, grid, clean = CASES[which]
    flags = dict(S4_FLAGS, patchsize=patchsize)
    cfg = make_cfg()
    jmodel, jstate = jax_cnn_train_model(cfg, seed=0)
    jfn = j_make_semi_train_step(jmodel, JSemiConfig(**flags), **STEP_KW)
    jstep = jax.jit(jfn)
    with jax.enable_x64(True):
        jstep64 = jax.jit(jfn)
    model = torch_train_model(cfg)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    launches = fa.launch_count
    for i, batch in enumerate(_batches()):
        masks, perms = _injected(i, grid)
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
        after = train_state_dicts_from_jax(jstate)
        ours = state.model.state_dict()
        assert sorted(after['model']) == sorted(ours)
        for name, w in after['model'].items():
            if name.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(
                    ours[name].numpy(), w.numpy(), rtol=0,
                    atol=STATE_ATOL * max(1.0, float(w.abs().max())),
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
            if i in clean:
                assert jax_err <= WITNESS_RTOL * top, (i, name, jax_err, top)
                err = float((got[name] - jax32[name]).abs().max())
                assert err <= UPDATE_RTOL * float(jax32[name].abs().max()), \
                    (i, name, err)
        ema = state.ema_model.state_dict()
        for name, w in after['ema'].items():
            np.testing.assert_allclose(
                ema[name].numpy(), w.numpy(), rtol=0,
                atol=STATE_ATOL * max(1.0, float(w.abs().max())),
                err_msg=f'step {i} ema {name}')
    assert fa.launch_count == launches


def test_ocrnet_patch_shuffle_must_tile_the_quarter_map():
    """At the default patchsize 16 the 64² image has 2 x 2 super-patches
    of 32 pixels, and the first stage's 16 x 16 input would need 8 x 8
    blocks of 2: JAX fails on the shapes, the port raises ValueError."""
    flags = dict(S4_FLAGS, patchsize=16)
    masks, perms = _injected(0, 2)
    batch = dict(_batches(1)[0], dbg_cutmix_mask=masks,
                 dbg_patchmix_perm=perms)
    cfg = ocrnet_model()
    jmodel, jstate = jax_cnn_train_model(cfg, seed=0)
    jstep = j_make_semi_train_step(jmodel, JSemiConfig(**flags), **STEP_KW)
    with pytest.raises(TypeError, match='reshape'):
        jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    model = torch_train_model(cfg)
    state = train_state_from_jax(model, jstate)
    step = make_semi_train_step(model, SemiConfig(**flags), **STEP_KW)
    with pytest.raises(ValueError, match='does not tile a 16 x 16'):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
             torch.Generator().manual_seed(0))


CASCADE_CLI = """
_base_ = ['./tiny_cli.py']
model = dict(
    type='CascadeEncoderDecoder', num_stages=2,
    backbone=dict(_delete_=True, **{backbone}),
    decode_head={head},
    auxiliary_head=[],
    patchsize=4)
"""


def test_ocrnet_train_then_test_cli(tmp_path):
    """tools.train on an OCRNet-HRNet variant of the tiny CLI config (21
    classes, every S4Former flag, patchsize 4): 2 steps, eval and a
    checkpoint holding both stages (``decode_head.{0,1}.``) and the
    HRNet's BN statistics; tools.test on it gives the in-loop mIoU; a
    request through init_segmentor on it."""
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:2]
    split = tmp_path / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    write_cli_config(tmp_path, str(split))
    m = copy.deepcopy(ocrnet_model(num_classes=21))
    path = tmp_path / 'ocr_cli.py'
    path.write_text(CASCADE_CLI.format(backbone=m['backbone'],
                                       head=m['decode_head']))
    wd = str(tmp_path / 'work')
    state = train_cli.main([str(path), '--work-dir', wd, '--device', 'cpu'])
    assert int(state.step) == 2
    saved = torch.load(osp.join(wd, 'iter_2', 'state.pt'),
                       weights_only=True)
    for part in ('model', 'ema_model'):
        keys = saved[part]
        assert any(k.startswith('decode_head.0.convs.0.') for k in keys)
        assert any(k.startswith('decode_head.1.object_context_block.')
                   for k in keys)
        assert any(k.startswith('backbone.stage4.0.fuse_layers.3.')
                   and k.endswith('running_var') for k in keys)
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
