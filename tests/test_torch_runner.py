"""The port's runner, checkpoints, exact eval and CLIs on the CPU, in f32.

- ``make_eval_fn`` against the JAX ``make_eval_fn`` on the same perturbed
  weights (through ``state_dict_from_jax_variables``), on fixture images
  through a small keep-ratio test pipeline: mIoU, aAcc and mAcc agree
  within 1e-6, with batched (4) and per-image flushes, and in slide mode;
  so does ``apis.single_device_test``.
- Resume: 5 steps straight against 2 steps, a checkpoint, and 3 more in a
  fresh state: parameters, BN statistics, EMA teacher and SGD buffers are
  bit-identical, because each step's generator is seeded from the step.
- Checkpoints: a partial write is never offered to auto-resume; the
  asynchronous save round-trips after ``finalize_pending_saves``.
- ``tools.train`` -> ``tools.test`` with ``--device cpu`` on a tiny
  config: the offline mIoU is the in-loop one, exactly; ``--auto-resume``
  continues from the last checkpoint; what is not ported raises.
"""
import copy
import json
import os
import os.path as osp
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s4former_tpu.data  # noqa: F401
import s4former_tpu_torch.data  # noqa: F401
from s4former_tpu import apis as japis
from s4former_tpu.core.runner import make_eval_fn as j_make_eval_fn
from s4former_tpu.data.datasets.custom import build_dataset as j_build
from s4former_tpu_torch import apis
from s4former_tpu_torch.core import checkpoint as ckpt_lib
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.core.runner import (IterBasedRunner,
                                            _DevicePrefetcher, make_eval_fn)
from s4former_tpu_torch.data import build_dataset
from s4former_tpu_torch.models import init_segmentor_weights
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                make_semi_train_step)
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from tests._torch_port import (FIXTURE, TEST_PIPELINE, jax_variables,
                               torch_train_model, write_cli_config,
                               write_tiny_config)

METRIC_TOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Tiny steps on a shared, loaded CPU: eight OpenMP threads a process
    make each step seconds long; two keep it near 0.1 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _split(tmp_path, n, name='val'):
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:n]
    path = tmp_path / f'{name}_{n}.txt'
    path.write_text('\n'.join(stems) + '\n')
    return str(path)


def _val_cfg(split):
    # the tiny model's 5 classes (the JAX slide eval sizes its logit
    # buffer by the dataset's classes); labels 5-20 count in no class
    return dict(type='PascalVOCDataset', data_root=FIXTURE,
                img_dir='JPEGImages', ann_dir='SegmentationClass',
                split=split, pipeline=copy.deepcopy(TEST_PIPELINE),
                classes=tuple(f'c{i}' for i in range(5)))


# ---------------------------------------------------------- prefetch
# the JAX package's tests/test_core/test_prefetch.py cases, on the CPU;
# tests/test_torch_cuda.py holds the copies on the card to their sources
def _numbered(n):
    for i in range(n):
        yield {'x': np.full((2, 3), i, np.float32),
               'y': np.full((2,), i, np.int32)}


def _index(batch):
    return int(batch['x'][0, 0])


def test_prefetch_preserves_order():
    pf = _DevicePrefetcher(_numbered(10), 'cpu')
    got = [pf.get() for _ in range(10)]
    assert [_index(b) for b in got] == list(range(10))
    assert all(b['x'].dtype == torch.float32 and b['y'].dtype == torch.int32
               and torch.equal(b['y'], torch.full((2,), i, dtype=torch.int32))
               for i, b in enumerate(got))
    with pytest.raises(StopIteration):
        pf.get()


def test_prefetch_forwards_loader_exception():
    def bad():
        yield from _numbered(3)
        raise ValueError('boom at 3')

    pf = _DevicePrefetcher(bad(), 'cpu')
    assert [_index(pf.get()) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match='boom at 3'):
        pf.get()


def test_prefetch_close_stops_worker():
    """The worker, stalled on a full queue with most of 1000 batches to
    go, ends when the prefetcher is closed."""
    pf = _DevicePrefetcher(_numbered(1000), 'cpu')
    assert _index(pf.get()) == 0
    pf.close()
    assert not pf._thread.is_alive()


# ------------------------------------------------------------ resume
B, IMG, NCLS = 2, 64, 5
# the seeded teacher's max probability over 5 classes lies in 0.20-0.40
# (median 0.245) on these batches: at 0.25 about half the pixels are
# confident, so the CutMix box and the shuffle drawn each step reach the
# unsup losses and the parameters
S4_FLAGS = dict(
    ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.25,
    attn_mask_seperate_head=True, attn_mask_weight=5.0,
    adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
    negative_class_ranking=True, negative_class_ranking_mode='unsup_only',
    momentum_head_exp=1.0)


def _fresh():
    model = torch_train_model()
    init_segmentor_weights(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, ema=True)
    step = make_semi_train_step(model, SemiConfig(**S4_FLAGS),
                                num_classes=NCLS, base_lr=0.01,
                                max_iters=100)
    return state, step


def _batches(start):
    i = start
    while True:
        rng = np.random.RandomState(100 + i)
        yield {'sup_img': rng.randn(B, IMG, IMG, 3).astype(np.float32),
               'sup_gt': rng.randint(0, NCLS, (B, IMG, IMG)).astype(np.int32),
               'unsup_teacher_img': rng.randn(B, IMG, IMG, 3).astype(
                   np.float32),
               'unsup_student_img': rng.randn(B, IMG, IMG, 3).astype(
                   np.float32)}
        i += 1


def _tensors(state):
    out = {f'model.{k}': v for k, v in state.model.state_dict().items()}
    out.update({f'ema.{k}': v
                for k, v in state.ema_model.state_dict().items()})
    out.update({f'momentum.{k}': v for k, v in state.momentum.items()})
    out['annealed_momentum'] = state.annealed_momentum
    out['step'] = state.step
    return out


def test_resume_is_bit_identical(tmp_path):
    state, step = _fresh()
    final_a = IterBasedRunner(step, state, _batches(0), max_iters=5,
                              work_dir=str(tmp_path / 'a'),
                              checkpoint_interval=2, log_interval=5).run()

    wd = str(tmp_path / 'b')
    state, step = _fresh()
    IterBasedRunner(step, state, _batches(0), max_iters=2, work_dir=wd,
                    checkpoint_interval=2, log_interval=100).run()
    os.makedirs(osp.join(wd, 'iter_77'))          # a write killed early
    open(osp.join(wd, 'iter_77', 'state.pt.tmp'), 'wb').close()
    state, step = _fresh()
    runner = IterBasedRunner(step, state, _batches(2), max_iters=5,
                             work_dir=wd, checkpoint_interval=100,
                             log_interval=100)
    runner.resume(auto=True)
    assert int(runner.state.step) == 2
    final_b = runner.run()

    a, b = _tensors(final_a), _tensors(final_b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(final_b.step) == 5
    assert final_a.annealed_momentum is not None   # the annealing is live
    records = [json.loads(line) for line in
               open(osp.join(tmp_path, 'a', 'metrics.jsonl'))]
    assert [r['step'] for r in records] == [5]
    assert records[0]['mask_ratio'] > 0            # the unsup branch is live
    assert {'loss', 'data_wait_ms', 'step_ms'} <= set(records[0])
    with open(osp.join(wd, 'work_is_done')) as f:
        assert f.read() == 'iter 5\n'


def _assert_states_equal(x, y):
    a, b = _tensors(x), _tensors(y)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            assert torch.equal(a[k], b[k]), k


def test_find_latest_skips_partial_writes(tmp_path):
    wd = str(tmp_path)
    state, _ = _fresh()
    ckpt_lib.save_checkpoint(wd, 2, state)
    os.makedirs(osp.join(wd, 'iter_50'))          # killed mid-write
    open(osp.join(wd, 'iter_50', 'state.pt.tmp'), 'wb').close()
    os.makedirs(osp.join(wd, 'iter_99'))          # killed before the write
    os.makedirs(osp.join(wd, 'iter_3.tmp'))
    assert ckpt_lib.find_latest_checkpoint(wd) == osp.join(wd, 'iter_2')
    assert [s for _, s in ckpt_lib.find_all_checkpoints(wd)] == [2]


def test_async_save_round_trip(tmp_path):
    wd = str(tmp_path)
    state, step = _fresh()
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                            next(_batches(0)).items()},
                    torch.Generator().manual_seed(0))
    p1 = ckpt_lib.save_checkpoint(wd, 1, state, meta={'iter': 1},
                                  block=False)
    p2 = ckpt_lib.save_checkpoint(wd, 3, state, meta={'iter': 3},
                                  block=False)
    # the second save finalized the first: at most one write in flight
    assert osp.isfile(osp.join(p1, 'state.pt'))
    assert json.load(open(osp.join(p1, 's4former_meta.json'))) == {'iter': 1}
    assert ckpt_lib.finalize_pending_saves() == p2
    assert ckpt_lib.finalize_pending_saves() is None
    assert ckpt_lib.find_latest_checkpoint(wd) == p2
    fresh, _ = _fresh()
    restored = ckpt_lib.load_checkpoint(p2, fresh)
    _assert_states_equal(state, restored)
    assert int(restored.step) == 1
    assert not any(n.endswith('.tmp') for n in os.listdir(p2))


# --------------------------------------------------------------- CLIs
def test_train_then_test_cli_round_trip(tmp_path):
    cfg_path = write_cli_config(tmp_path, _split(tmp_path, 4))
    wd = str(tmp_path / 'work')
    state = train_cli.main([str(cfg_path), '--work-dir', wd,
                            '--device', 'cpu'])
    assert int(state.step) == 2
    records = [json.loads(line) for line in open(osp.join(wd,
                                                          'metrics.jsonl'))]
    train = [r for r in records if r['prefix'] == 'train']
    val = [r for r in records if r['prefix'] == 'val']
    assert [r['step'] for r in train] == [1, 2]
    assert all(np.isfinite(r['loss']) for r in train)
    assert [r['step'] for r in val] == [2]
    assert sorted(n for n in os.listdir(wd) if n.startswith('iter_')) == \
        ['iter_2']
    assert os.listdir(osp.join(wd, 'best')) == ['iter_2']

    results = test_cli.main([str(cfg_path), osp.join(wd, 'iter_2'),
                             '--device', 'cpu'])
    assert results['mIoU'] == val[0]['mIoU']
    assert results['aAcc'] == val[0]['aAcc']

    state = train_cli.main([str(cfg_path), '--work-dir', wd, '--device',
                            'cpu', '--auto-resume', '--max-iters', '3'])
    assert int(state.step) == 3
    logs = [n for n in os.listdir(wd) if n.endswith('.log')]
    text = ''.join(open(osp.join(wd, n)).read() for n in logs)
    assert f'resumed from {osp.join(wd, "iter_2")}' in text
    assert osp.isfile(osp.join(wd, 'iter_3', 'state.pt'))


# tensor parallelism and ZeRO-3 are ported (tests/test_torch_tp.py); what
# the model axis refuses, before any rank joins a group: a world that does
# not divide by it (one rank; 2 ranks' environment), and a ViT whose heads
# do not (4 heads over 3 ranks)
@pytest.mark.parametrize('argv', [
    (['--model-parallel', '2'], '1', '1 rank'),
    (['--launcher', 'env', '--model-parallel', '3'], '2', '2 rank'),
    (['--launcher', 'env', '--model-parallel', '3'], '3', '4 heads')])
def test_unported_train_flags_raise(argv, tmp_path):
    args, world, match = argv
    cfg = write_cli_config(tmp_path, _split(tmp_path, 1))
    env = {'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': '1',
           'WORLD_SIZE': world, 'RANK': '0', 'LOCAL_RANK': '0'}
    with mock.patch.dict(os.environ, env), \
            pytest.raises(ValueError, match=match):
        train_cli.main([cfg, '--device', 'cpu'] + args)


# what tools.test still refuses: a submission format VOC does not have,
# the JAX eval fast mode, and the official Cityscapes evaluator without
# cityscapesscripts (JAX's ImportError; test_torch_datasets stubs it)
@pytest.mark.parametrize('argv', [
    (['--format-only'], {}, NotImplementedError),
    ([], {'S4_EVAL_BUCKET': '256'}, NotImplementedError),
    (['--eval', 'cityscapes', '--cfg-options',
      'data.test.type=CityscapesDataset', 'data.test.img_suffix=.jpg',
      'data.test.seg_map_suffix=.png'], {}, ImportError)])
def test_unported_test_flags_raise(argv, tmp_path, monkeypatch):
    flags, env, error = argv
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setitem(sys.modules, 'cityscapesscripts', None)
    cfg_path = write_cli_config(tmp_path, _split(tmp_path, 1))
    with pytest.raises(error):
        test_cli.main([cfg_path, '--device', 'cpu', '--imgfile-prefix',
                       str(tmp_path / 'fmt')] + flags)


# ------------------------------------------------- eval vs JAX (last:
# XLA's CPU threads slow the torch steps that run after them)
class _JState:
    def __init__(self, variables):
        self.params = variables['params']
        self.batch_stats = variables['batch_stats']


class _State:
    def __init__(self, model):
        self.model = model


@pytest.fixture(scope='module')
def eval_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp('eval')
    js = japis.init_segmentor(write_tiny_config(d))
    variables = jax_variables(js, seed=3)
    seg = apis.init_segmentor(write_tiny_config(d), device='cpu')
    seg.model.load_state_dict(state_dict_from_jax_variables(variables))
    split = _split(d, 6)
    return dict(js=js, variables=variables, model=seg.model,
                j_ds=j_build(_val_cfg(split)),
                ds=build_dataset(_val_cfg(split)))


@pytest.mark.parametrize('mode,batch_size', [('whole', 4), ('whole', 1),
                                             ('slide', 4)])
def test_eval_fn_matches_jax(eval_setup, mode, batch_size):
    s = eval_setup
    geometry = dict(mode=mode, crop_size=(64, 64), stride=(40, 40))
    want = j_make_eval_fn(s['js'].model, s['j_ds'], batch_size=batch_size,
                          **geometry)(
        _JState(jax.tree_util.tree_map(jnp.asarray, s['variables'])))
    got = make_eval_fn(s['ds'], batch_size=batch_size, **geometry)(
        _State(s['model']))
    assert sorted(got) == ['aAcc', 'mAcc', 'mIoU']
    for k in ('aAcc', 'mIoU', 'mAcc'):
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    assert got['aAcc'] > 0.02      # the perturbed model predicts something


def test_single_device_test_matches_jax(eval_setup, tmp_path):
    """apis.single_device_test: the pipeline images through predict, label
    maps resized nearest to the labels, as per-image histograms."""
    s = eval_setup
    cfg = write_tiny_config(tmp_path)
    jseg = japis.init_segmentor(cfg)
    jseg.variables = jax.tree_util.tree_map(jnp.asarray, s['variables'])
    seg = apis.init_segmentor(cfg, device='cpu')
    seg.model.load_state_dict(s['model'].state_dict())
    want = japis.single_device_test(jseg, s['j_ds'])
    got = apis.single_device_test(seg, s['ds'])
    assert len(got) == len(want) == len(s['ds'])
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=0, atol=METRIC_TOL)
