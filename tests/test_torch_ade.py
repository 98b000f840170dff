"""The datasets slice end to end on the CPU, in f32, against the JAX package:
the CLI config of tests/_torch_port.py on an ADE20K-layout tree
(``write_ade_tree``: 4 + 4 training and 3 validation images, labels 0-150
through ``reduce_zero_label``) with 150 classes on the decode head and both
aux heads, from one set of perturbed JAX weights.

- The weight bridge carries the 150-class head and aux heads.
- ``tools.train`` of the port (2 steps of 2 + 2 with the S4Former flags,
  eval and checkpoint at 2), loading those weights from a ``.pth``, against
  the JAX package's own pieces on the same items: ``SemiLoader``, the
  jitted ``make_semi_train_step`` and ``make_eval_fn``. The CutMix boxes
  and PatchShuffle permutations are handed to both steps as the ``dbg_``
  batch keys; the items come from ``get_item_deterministic`` in both
  packages (a dataset's ``__getitem__`` reseeds from numpy's global state,
  which the loaders' threads read in any order). Every logged loss within
  LOSS_RTOL of JAX's, the in-loop metrics within METRIC_TOL; the eval
  panels of ``eval_vis/iter_2`` at the label maps' sizes.
- ``tools.test`` of the port on ``iter_2`` (``--out``) against the JAX
  eval of the JAX state after the same 2 steps: labels by the margin rule
  (equal wherever JAX's top-2 probabilities lie more than ATOL apart, at
  most MAX_FLIPPED of the pixels differing), metrics within METRIC_TOL and
  equal to the port's in-loop ones.
"""
import json
import os
import os.path as osp
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from s4former_tpu import apis as japis
from s4former_tpu.core.runner import make_eval_fn as j_make_eval_fn
from s4former_tpu.data.datasets import custom as j_custom
from s4former_tpu.data.loader import SemiLoader as JSemiLoader
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.train_step import \
    create_train_state as j_create_train_state
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.data.datasets import custom
from s4former_tpu_torch.semi import train_step as port_train_step
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (jax_eval_probs, jax_variables, sure_pixels,
                               write_ade_config, write_ade_tree)
from tests.test_torch_test_cli import ATOL, MAX_FLIPPED, METRIC_TOL
from tests.test_torch_train_step import LOSS_RTOL

STEPS, B, CROP = 2, 2, 64


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draws(step):
    """The CutMix boxes and PatchShuffle permutations (PatchMix_N = 2) of
    step ``step`` (0-based), the same arrays for both packages."""
    masks = np.ones((B, CROP, CROP), np.float32)
    masks[0, 8 + 4 * step:40 + 4 * step, 16:48] = 0
    masks[1, 0:32, 24:56 - 8 * step] = 0
    perms = np.array([[1, 0, 3, 2], [2, 3, 0, 1]] if step == 0 else
                     [[3, 2, 1, 0], [0, 1, 2, 3]], np.int32)
    return {'dbg_cutmix_mask': masks, 'dbg_patchmix_perm': perms}


def _deterministic(self, idx):
    return self.get_item_deterministic(idx, 0)


@pytest.fixture(scope='module')
def ade_run(tmp_path_factory):
    """The port's tools.train and tools.test on the ADE tree, and the JAX
    package's 2 steps and eval on the same items and weights."""
    d = tmp_path_factory.mktemp('ade_slice')
    write_ade_tree(d / 'ade', seed=1)
    cfg = write_ade_config(d, d / 'ade')
    js = japis.init_segmentor(cfg)
    variables = jax_variables(js, seed=4)
    sd = state_dict_from_jax_variables(variables)
    pth = str(d / 'init.pth')
    torch.save({'state_dict': sd}, pth)
    mp = pytest.MonkeyPatch()
    try:
        for module in (custom, j_custom):
            mp.setattr(module.CustomDataset, '__getitem__', _deterministic)
        real = port_train_step.make_semi_train_step

        def make(*args, **kwargs):
            step = real(*args, **kwargs)

            def injected(state, batch, gen):
                draws = {k: torch.from_numpy(v) for k, v in
                         _draws(int(state.step)).items()}
                return step(state, {**batch, **draws}, gen)
            return injected

        mp.setattr(port_train_step, 'make_semi_train_step', make)
        wd = str(d / 'work')
        train_cli.main([cfg, '--work-dir', wd, '--device', 'cpu',
                        '--load-from', pth])
        mp.setattr(port_train_step, 'make_semi_train_step', real)
        preds = str(d / 'preds.pkl')
        offline = test_cli.main([cfg, osp.join(wd, f'iter_{STEPS}'),
                                 '--device', 'cpu', '--out', preds])
        jax_logs, jax_state, jax_eval = _jax_run(js, variables)
    finally:
        mp.undo()
    with open(osp.join(wd, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    with open(preds, 'rb') as f:
        labels = pickle.load(f)
    return SimpleNamespace(js=js, sd=sd, wd=wd, records=records,
                           offline=offline,
                           labels=labels, jax_logs=jax_logs,
                           jax_state=jax_state, jax_eval=jax_eval)


def _jax_run(js, variables):
    """The JAX package's loader, jitted step and in-loop eval on the config
    of ``js``: 2 steps from ``variables`` with the injected draws."""
    cfg = js.cfg
    semi = JSemiConfig.from_model_cfg(cfg.model)
    step = jax.jit(j_make_semi_train_step(
        js.model, semi, num_classes=150, base_lr=0.01, max_iters=STEPS,
        power=0.9, min_lr=1e-4, sgd_momentum=0.9, weight_decay=0.0,
        custom_keys={'head': 10.0}))
    state = j_create_train_state(variables, ema=True)
    train = cfg.data['train']
    loader = JSemiLoader(j_custom.build_dataset(train['sup']),
                         j_custom.build_dataset(train['unsup']),
                         sup_per_batch=B, unsup_per_batch=B,
                         num_workers=2, seed=0)
    batches = iter(loader)
    logs = []
    for i in range(STEPS):
        batch = {**next(batches), **_draws(i)}
        state, out = step(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()},
                          jax.random.PRNGKey(0))
        logs.append({k: float(v) for k, v in out.items()})
    eval_fn = j_make_eval_fn(js.model, j_custom.build_dataset(
        cfg.data['val']), crop_size=(CROP, CROP))
    metrics = eval_fn(SimpleNamespace(params=state.params,
                                      batch_stats=state.batch_stats))
    return logs, state, (metrics, eval_fn.last_samples)


def test_bridge_carries_the_150_class_heads(ade_run):
    heads = [k for k in ade_run.sd if k.endswith('conv_seg.weight')]
    assert sorted(heads) == ['auxiliary_head.0.conv_seg.weight',
                             'auxiliary_head.1.conv_seg.weight',
                             'decode_head.conv_seg.weight']
    for k in heads:
        assert ade_run.sd[k].shape[0] == 150, k
        assert ade_run.sd[k.replace('weight', 'bias')].shape == (150,), k


def test_train_cli_matches_jax(ade_run):
    train = [r for r in ade_run.records if r['prefix'] == 'train']
    val = [r for r in ade_run.records if r['prefix'] == 'val']
    assert [r['step'] for r in train] == [1, 2]
    assert [r['step'] for r in val] == [2]
    for i, (got, want) in enumerate(zip(train, ade_run.jax_logs)):
        assert set(want) <= set(got), sorted(set(want) - set(got))
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'step {i + 1} {k}')
    for r in train:             # the semi branch is live
        assert 0.05 < r['mask_ratio'] < 0.95 and \
            r['unsup.loss_ncr_unsup'] > 0, r
    metrics, samples = ade_run.jax_eval
    for k in ('aAcc', 'mIoU', 'mAcc'):
        assert abs(val[0][k] - metrics[k]) <= METRIC_TOL, \
            (k, val[0][k], metrics[k])
    # the eval panels: image | GT | prediction under the 150-colour palette
    panels = osp.join(ade_run.wd, 'eval_vis', f'iter_{STEPS}')
    assert sorted(os.listdir(panels)) == ['000.png', '001.png', '002.png']
    for name, (_, _, gt) in zip(sorted(os.listdir(panels)), samples):
        panel = np.asarray(Image.open(osp.join(panels, name)))
        assert panel.shape == (gt.shape[0], 3 * gt.shape[1], 3)


def test_test_cli_matches_jax(ade_run):
    metrics, samples = ade_run.jax_eval
    val = [r for r in ade_run.records if r['prefix'] == 'val'][0]
    for k in ('aAcc', 'mIoU', 'mAcc'):
        assert ade_run.offline[k] == val[k], k          # the in-loop eval
        assert abs(ade_run.offline[k] - metrics[k]) <= METRIC_TOL, k
    assert len(ade_run.labels) == len(samples) == 3
    variables = {'params': ade_run.jax_state.params,
                 'batch_stats': ade_run.jax_state.batch_stats}
    flipped = pixels = 0
    for got, (img, want, gt) in zip(ade_run.labels, samples):
        want = np.asarray(want)
        assert got.shape == want.shape == gt.shape
        assert (gt == 255).any() and gt[gt != 255].max() < 150
        sure = sure_pixels(jax_eval_probs(ade_run.js.model, variables, img,
                                          gt.shape), ATOL)
        assert sure.mean() > 0.5
        np.testing.assert_array_equal(got[sure], want[sure])
        flipped += int((got != want).sum())
        pixels += got.size
    assert flipped <= MAX_FLIPPED * pixels, (flipped, pixels)
