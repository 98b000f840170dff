"""The eval panels and the overlay of the port on the CPU, in f32, against
the JAX package on the same numpy inputs and bridged weights (the CLI
fixture config of tests/_torch_port.py: a 2-layer ViT of 64, 21 classes,
test images at keep-ratio (96, 64); the JAX ViT runs its Pallas kernel in
interpret mode).

- ``core.hooks.JsonlLoggerHook.log_eval_images``: the same PNG bytes as the
  JAX hook for a float image, an image of another shape than its labels
  and no palette; a stub ``wandb`` in ``sys.modules`` receives the same
  table from both.
- ``core.runner.make_eval_fn``'s ``last_samples`` and ``palette``: the
  images and label maps equal the JAX ``make_eval_fn``'s bit for bit, the
  predictions by the margin rule of test_torch_test_cli (labels equal
  wherever JAX's top-2 probabilities lie more than ATOL apart, at most
  MAX_FLIPPED of the pixels differing), the metrics within METRIC_TOL.
- a training run's ``eval_vis/iter_2`` panels: the same PNG bytes as the
  JAX hook writes from the JAX eval of the same weights (the port's
  checkpoint published to a ``.pth`` that the JAX package loads).
- 2 gloo ranks write the same ``eval_vis`` files and metrics as one
  process.
- ``apis.show_result_pyplot`` against the JAX one.
"""
import json
import os
import os.path as osp
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from s4former_tpu import apis as japis
from s4former_tpu.core.hooks import JsonlLoggerHook as JJsonlLoggerHook
from s4former_tpu.core.runner import make_eval_fn as j_make_eval_fn
from s4former_tpu.data.datasets.custom import build_dataset as j_build
from s4former_tpu_torch import apis
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.core.class_names import get_palette
from s4former_tpu_torch.core.hooks import JsonlLoggerHook
from s4former_tpu_torch.core.runner import make_eval_fn
from s4former_tpu_torch.data import build_dataset
from s4former_tpu_torch.data.datasets.custom import CustomDataset
from s4former_tpu_torch.tools import publish_model
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (FIXTURE, eval_vis_worker, jax_eval_probs,
                               jax_variables, run_ranks, sure_pixels,
                               write_cli_config)
from tests.test_torch_test_cli import ATOL, MAX_FLIPPED, METRIC_TOL

REPO = Path(__file__).resolve().parents[1]
N_VAL = 5          # in groups of 2: images 2 and 3 are rank 1's at 2 ranks


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def vis_setup(tmp_path_factory):
    """The CLI config on 5 val images, the JAX segmentor and dataset, and
    one set of perturbed weights in both packages."""
    d = tmp_path_factory.mktemp('vis')
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:N_VAL]
    split = d / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    cfg = write_cli_config(d, str(split))
    js = japis.init_segmentor(cfg)
    variables = jax_variables(js, seed=11)
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    seg = apis.init_segmentor(cfg, device='cpu')
    seg.model.load_state_dict(state_dict_from_jax_variables(variables))
    return SimpleNamespace(dir=d, cfg=cfg, js=js, seg=seg,
                           j_ds=j_build(js.cfg.data['val']),
                           ds=build_dataset(seg.cfg.data['val']))


class _JState:
    def __init__(self, variables):
        self.params = variables['params']
        self.batch_stats = variables['batch_stats']


class _State:
    def __init__(self, model):
        self.model = model


class _StubWandb(types.ModuleType):
    """A ``wandb`` with a live run that keeps what is logged to it."""

    def __init__(self):
        super().__init__('wandb')
        self.run = object()
        self.logged = []

        class Table:
            def __init__(self, columns):
                self.columns, self.rows = columns, []

            def add_data(self, *row):
                self.rows.append(row)

        class Image:
            def __init__(self, path, masks=None):
                self.path, self.masks = path, masks

        self.Table, self.Image = Table, Image

    def log(self, data, step=None):
        self.logged.append((data, step))


def _files(directory):
    return {n: (Path(directory) / n).read_bytes()
            for n in sorted(os.listdir(directory))}


def _same_tables(got, want, got_root, want_root):
    """The logged wandb tables agree: columns, each image's path below its
    work dir, and its masks."""
    assert len(got) == len(want) == 1
    (g, g_step), (w, w_step) = got[0], want[0]
    assert g_step == w_step and sorted(g) == sorted(w) == ['val/examples']
    g, w = g['val/examples'], w['val/examples']
    assert g.columns == w.columns == ['image', 'ground_truth', 'prediction']
    assert len(g.rows) == len(w.rows)
    for g_row, w_row in zip(g.rows, w.rows):
        for gi, wi in zip(g_row, w_row):
            assert osp.relpath(gi.path, got_root) == \
                osp.relpath(wi.path, want_root)
            assert (gi.masks is None) == (wi.masks is None)
            if gi.masks is not None:
                assert sorted(gi.masks) == sorted(wi.masks)
                for key in gi.masks:
                    np.testing.assert_array_equal(
                        gi.masks[key]['mask_data'],
                        wi.masks[key]['mask_data'])


def _samples(kind):
    rs = np.random.RandomState(5)
    labels = [rs.randint(0, 21, (45, 60)) for _ in range(3)]
    for lab in labels:
        lab[:5] = 255                      # ignore pixels paint as 0
    if kind == 'float_image':              # a normalised pipeline image
        images = [rs.normal(0, 1, (45, 60, 3)).astype(np.float32)
                  for _ in range(3)]
    else:                                  # resized to the labels first
        images = [rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)
                  for _ in range(3)]
    preds = [rs.randint(0, 21, (45, 60)).astype(np.int32)
             for _ in range(3)]
    palette = None if kind == 'palette_none' else get_palette('voc')
    return images, preds, labels, palette


@pytest.mark.parametrize('kind', ['float_image', 'shape_mismatch',
                                  'palette_none'])
def test_log_eval_images_matches_jax(tmp_path, monkeypatch, kind):
    images, preds, gts, palette = _samples(kind)
    out = {}
    for pkg, hook_cls in (('jax', JJsonlLoggerHook),
                          ('port', JsonlLoggerHook)):
        stub = _StubWandb()
        monkeypatch.setitem(sys.modules, 'wandb', stub)
        hook = hook_cls(str(tmp_path / pkg))
        path = hook.log_eval_images(7, images, preds, gts, palette=palette)
        out[pkg] = (path, stub.logged)
    assert out['port'][0] == str(tmp_path / 'port' / 'eval_vis' / 'iter_7')
    want, got = _files(out['jax'][0]), _files(out['port'][0])
    assert sorted(got) == ['000.png', '001.png', '002.png']
    assert got == want
    panel = np.asarray(Image.open(osp.join(out['port'][0], '000.png')))
    assert panel.shape == (45, 180, 3)
    _same_tables(out['port'][1], out['jax'][1], tmp_path / 'port',
                 tmp_path / 'jax')


def test_no_wandb_run_logs_files_only(tmp_path, monkeypatch):
    """A ``wandb`` without a live run is not used (JAX hooks.py:30-36)."""
    stub = _StubWandb()
    stub.run = None
    monkeypatch.setitem(sys.modules, 'wandb', stub)
    hook = JsonlLoggerHook(str(tmp_path))
    images, preds, gts, palette = _samples('float_image')
    hook.log(3, {'loss': 1.0})
    hook.log_eval_images(3, images, preds, gts, palette=palette)
    assert stub.logged == [] and hook._wandb is None
    assert len(os.listdir(tmp_path / 'eval_vis' / 'iter_3')) == 3


@pytest.mark.parametrize('batch_size', [2, 4])
def test_eval_fn_samples_match_jax(vis_setup, batch_size):
    """The pipeline images and label maps bit for bit; the predictions by
    the margin rule of test_torch_test_cli (two f32 forwards: a pixel whose
    top-2 probabilities lie within ATOL may take the other label, at most
    MAX_FLIPPED of the pixels); the metrics within METRIC_TOL."""
    s = vis_setup
    want_fn = j_make_eval_fn(s.js.model, s.j_ds, batch_size=batch_size)
    want = want_fn(_JState(s.js.variables))
    got_fn = make_eval_fn(s.ds, batch_size=batch_size)
    got = got_fn(_State(s.seg.model))
    for k in ('aAcc', 'mIoU', 'mAcc'):
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    assert got_fn.palette == want_fn.palette == get_palette('voc')
    assert len(got_fn.last_samples) == len(want_fn.last_samples) == 4
    flipped = pixels = 0
    for (gi, gp, gg), (wi, wp, wg) in zip(got_fn.last_samples,
                                          want_fn.last_samples):
        assert gi.dtype == np.float32 and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)       # the pipeline image
        np.testing.assert_array_equal(gg, wg)       # the label map
        assert gp.dtype == np.int32 and gp.shape == gg.shape
        wp = np.asarray(wp)
        sure = sure_pixels(jax_eval_probs(s.js.model, s.js.variables, wi,
                                          wg.shape), ATOL)
        assert sure.mean() > 0.5
        np.testing.assert_array_equal(gp[sure], wp[sure])
        flipped += int((gp != wp).sum())
        pixels += gp.size
    assert flipped <= MAX_FLIPPED * pixels, (flipped, pixels)


def test_training_run_writes_the_jax_panels(vis_setup, monkeypatch):
    """``tools.train`` (2 steps, eval at 2) writes ``eval_vis/iter_2``; the
    JAX eval of the same weights through the JAX hook writes the same
    bytes. The training items are drawn by ``get_item_deterministic``: a
    dataset's ``__getitem__`` reseeds each access from numpy's global
    state (as the JAX package's does), so each run would train other
    weights, with other pixels where the two packages' f32 logits nearly
    tie."""
    monkeypatch.setattr(CustomDataset, '__getitem__',
                        lambda self, idx: self.get_item_deterministic(idx,
                                                                      0))
    s = vis_setup
    wd = s.dir / 'train'
    train_cli.main([s.cfg, '--work-dir', str(wd), '--device', 'cpu'])
    got = _files(wd / 'eval_vis' / 'iter_2')
    assert sorted(got) == [f'{i:03d}.png' for i in range(4)]
    _, pth = publish_model.main([str(wd / 'iter_2'), str(s.dir / 'pub'),
                                 '--to-pth'])
    js = japis.init_segmentor(s.cfg, pth)
    eval_fn = j_make_eval_fn(js.model, s.j_ds)
    eval_fn(_JState(js.variables))
    hook = JJsonlLoggerHook(str(s.dir / 'jax_train'))
    want = _files(hook.log_eval_images(2, *zip(*eval_fn.last_samples),
                                       palette=eval_fn.palette))
    assert got == want
    with open(wd / 'metrics.jsonl') as f:
        val = [r for r in map(json.loads, f) if r['prefix'] == 'val']
    assert [r['step'] for r in val] == [2]


def test_two_ranks_write_the_eval_panels_of_one_process(vis_setup):
    s = vis_setup
    weights = str(s.dir / 'weights.pt')
    torch.save(s.seg.model.state_dict(), weights)
    one, two = s.dir / 'one', s.dir / 'two'
    eval_vis_worker(0, 1, s.cfg, weights, str(one))
    run_ranks(eval_vis_worker, 2, s.cfg, weights, str(two))
    got = _files(two / 'eval_vis' / 'iter_2')
    assert sorted(got) == [f'{i:03d}.png' for i in range(4)]
    assert got == _files(one / 'eval_vis' / 'iter_2')

    def val_record(wd):
        with open(wd / 'metrics.jsonl') as f:
            rec = json.loads(f.read())
        return {k: v for k, v in rec.items() if k not in ('time', 'eval_s')}
    assert val_record(two) == val_record(one)
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))


@pytest.mark.parametrize('palette', ['default', 'cityscapes'])
def test_show_result_pyplot_matches_jax(tmp_path, palette):
    rs = np.random.RandomState(9)
    img = rs.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    seg = rs.randint(0, 19, (40, 56))
    pal = None if palette == 'default' else get_palette(palette)
    want = japis.show_result_pyplot(None, img, seg, palette=pal,
                                    opacity=0.3,
                                    out_file=str(tmp_path / 'jax.png'))
    got = apis.show_result_pyplot(None, img, seg, palette=pal, opacity=0.3,
                                  out_file=str(tmp_path / 'port.png'))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / 'port.png').read_bytes() == \
        (tmp_path / 'jax.png').read_bytes()
    # returned without a file; a path is read as the image
    path = str(tmp_path / 'img.png')
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(
        apis.show_result_pyplot(None, path, seg, palette=pal, opacity=0.3),
        want)
