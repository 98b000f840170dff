"""The port's data and metric modules held to the JAX package on the CPU:
the same fixture files (data/fixtures/voc_mini) and seeded numpy
generators go through both.

Exact (array_equal): every transform of the flagship train pipeline, the
unsup pipeline (its MultiBranch weak/strong views) and the test pipeline,
one transform at a time from one seed; ``get_item_deterministic`` on the
sup, unsup and val datasets; ``get_gt_seg_map``; the SemiBalanceSampler
index stream over two epochs; ``_stack_tagged``; ``interp_matrix_np`` and
``eval_resize_matrices``. The JAX package decodes and resizes through its
host C++ library when that builds (it is pinned bit-exact to PIL by
tests/test_native/), the port through PIL: the arrays must still be equal.

Within 1e-6: ``intersect_and_union`` (float32 counts), ``eval_metrics`` and
``pre_eval_to_metrics`` on random label maps with ignored pixels (the
ratios of the same integer counts).
"""
import copy
import os.path as osp

import numpy as np
import pytest

import s4former_tpu.data  # noqa: F401  (registers the JAX pipelines)
import s4former_tpu_torch.data  # noqa: F401
from s4former_tpu.core import metrics as jmetrics
from s4former_tpu.core.runner import eval_resize_matrices as j_resize_mats
from s4former_tpu.data.datasets.custom import build_dataset as j_build
from s4former_tpu.data.loader import SemiBalanceSampler as JSampler
from s4former_tpu.data.loader import _stack_tagged as j_stack_tagged
from s4former_tpu.data.pipelines.transforms import Compose as JCompose
from s4former_tpu.ops.resize import interp_matrix_np as j_interp
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core import metrics
from s4former_tpu_torch.core.runner import eval_resize_matrices
from s4former_tpu_torch.data.datasets.custom import build_dataset
from s4former_tpu_torch.data.loader import SemiBalanceSampler, _stack_tagged
from s4former_tpu_torch.data.pipelines.transforms import Compose
from s4former_tpu_torch.ops.resize import interp_matrix_np

REPO = osp.join(osp.dirname(__file__), '..')
CONFIG = osp.join(REPO, 'configs', 'setr',
                  'setr_fixture_voc_mini_fullflag.py')
METRIC_TOL = 1e-6


@pytest.fixture(scope='module')
def cfg():
    return Config.fromfile(CONFIG)


def _abs(ds_cfg):
    """The dataset config with data_root made absolute (tests run from any
    directory)."""
    ds_cfg = copy.deepcopy(dict(ds_cfg))
    ds_cfg['data_root'] = osp.join(REPO, ds_cfg['data_root'])
    return ds_cfg


def _datasets(cfg, which):
    ds_cfg = {'sup': cfg.data.train.sup, 'unsup': cfg.data.train.unsup,
              'val': cfg.data.val}[which]
    return j_build(_abs(ds_cfg)), build_dataset(_abs(ds_cfg))


def _assert_same(a, b, where):
    """Same structure, same arrays (dtype and values) and same metas."""
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{where}[{i}]')
        return
    assert sorted(k for k in a if k != 'rng') == \
        sorted(k for k in b if k != 'rng'), where
    for k, v in a.items():
        if k == 'rng':
            continue
        if isinstance(v, dict):
            _assert_same(v, b[k], f'{where}.{k}')
        elif isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype, f'{where}.{k}'
            np.testing.assert_array_equal(v, b[k], err_msg=f'{where}.{k}')
        else:
            assert v == b[k], f'{where}.{k}'


def _run_stepwise(pipeline_cfg, results, seed):
    """Each transform of ``pipeline_cfg`` in both packages from one seed,
    compared after every transform."""
    jr = copy.deepcopy(results)
    pr = copy.deepcopy(results)
    jr['rng'] = np.random.default_rng(seed)
    pr['rng'] = np.random.default_rng(seed)
    for t in pipeline_cfg:
        jr = JCompose([dict(t)])(jr)
        pr = Compose([dict(t)])(pr)
        _assert_same(jr, pr, t['type'])
    return jr


@pytest.mark.parametrize('which,seed', [('sup', 0), ('sup', 3),
                                        ('unsup', 1), ('unsup', 4),
                                        ('val', 2)])
def test_pipelines_transform_by_transform(cfg, which, seed):
    jds, _ = _datasets(cfg, which)
    pipeline = {'sup': cfg.data.train.sup.pipeline,
                'unsup': cfg.data.train.unsup.pipeline,
                'val': cfg.data.val.pipeline}[which]
    out = _run_stepwise(pipeline, jds._base_results(seed % len(jds)), seed)
    if which == 'unsup':   # the weak and strong views differ
        student, teacher = out
        assert (student['tag'], teacher['tag']) == ('unsup_student',
                                                    'unsup_teacher')
        assert student['img'].shape == teacher['img'].shape == (512, 512, 3)
    if which == 'val':     # keep-ratio (2048, 512): 500x375 -> 683x512
        assert out[0]['img'].shape == (512, 683, 3)


@pytest.mark.parametrize('which', ['sup', 'unsup', 'val'])
def test_get_item_deterministic(cfg, which):
    jds, ds = _datasets(cfg, which)
    assert len(jds) == len(ds) == 16
    for idx in (0, 5, 15):
        _assert_same(jds.get_item_deterministic(idx, seed=7),
                     ds.get_item_deterministic(idx, seed=7), f'{idx}')


def test_get_gt_seg_map(cfg):
    jds, ds = _datasets(cfg, 'val')
    for idx in range(len(ds)):
        a, b = jds.get_gt_seg_map(idx), ds.get_gt_seg_map(idx)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_repeat_dataset(cfg):
    """RepeatDataset: items, labels and pre_eval repeat modulo the length."""
    wrap = dict(type='RepeatDataset', times=3, dataset=_abs(cfg.data.val))
    jds, ds = j_build(copy.deepcopy(wrap)), build_dataset(wrap)
    assert len(jds) == len(ds) == 48
    assert ds.CLASSES == jds.CLASSES and ds.PALETTE == jds.PALETTE
    for idx in (3, 19, 35):
        np.testing.assert_array_equal(ds.get_gt_seg_map(idx),
                                      jds.get_gt_seg_map(idx))
        _assert_same(ds[idx][0]['img_metas'], jds[idx][0]['img_metas'],
                     str(idx))
    pred = ds.get_gt_seg_map(19)
    for a, b in zip(jds.pre_eval([pred], [35]), ds.pre_eval([pred], [35])):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=0, atol=METRIC_TOL)


def test_sampler_index_stream_two_epochs():
    kw = dict(num_sup=16, num_unsup=16, sup_per_batch=4, unsup_per_batch=4,
              seed=3, max_iter_size=6)
    js, ps = JSampler(**kw), SemiBalanceSampler(**kw)
    for _ in range(2):
        assert list(js) == list(ps)
    assert js.epoch == ps.epoch == 2


def test_stack_tagged(cfg):
    for which, tag in (('sup', 'sup'), ('unsup', 'unsup_student')):
        jds, ds = _datasets(cfg, which)
        items = [ds.get_item_deterministic(i, seed=1) for i in (2, 9)]
        want = j_stack_tagged(copy.deepcopy(items), tag)
        got = _stack_tagged(items, tag)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k])
    assert sorted(got) == ['unsup_student_gt', 'unsup_student_img',
                           'unsup_teacher_gt', 'unsup_teacher_img']
    assert got['unsup_student_img'].dtype == np.float32
    assert got['unsup_student_gt'].dtype == np.int32


@pytest.mark.parametrize('align', [False, True])
def test_interp_and_eval_resize_matrices(align):
    for n_in, n_out in ((32, 512), (43, 500), (7, 7), (688, 375)):
        np.testing.assert_array_equal(j_interp(n_in, n_out, align),
                                      interp_matrix_np(n_in, n_out, align))
    # the fixture eval: 683x512 image padded to 688x512, head logits at
    # 688x512 (or a quarter), labels 375x500, bucket 16
    for args in ((512, 683, 512, 688, 512, 688, (375, 500), align, 16),
                 (512, 683, 128, 172, 128, 172, (375, 500), align, 16),
                 (60, 85, 16, 24, 16, 24, (375, 500), align, 16),
                 (60, 85, 60, 85, 64, 96, (375, 500), align, 256)):
        for a, b in zip(j_resize_mats(*args), eval_resize_matrices(*args)):
            np.testing.assert_array_equal(a, b)


def _label_pairs(seed, n=3, n_cls=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.integers(0, n_cls, (37, 53)).astype(np.int32)
        gt[rng.random(gt.shape) < 0.2] = 255
        pred = np.where(rng.random(gt.shape) < 0.6, gt,
                        rng.integers(0, n_cls, gt.shape)).astype(np.int32)
        pred[pred == 255] = 0
        out.append((pred, gt))
    return out


def test_intersect_and_union_and_metrics():
    n_cls = 6
    pairs = _label_pairs(0)
    pre_j, pre_p = [], []
    for pred, gt in pairs:
        want = [np.asarray(x) for x in jmetrics.intersect_and_union(
            pred, gt, n_cls, 255)]
        got = [x.numpy() for x in metrics.intersect_and_union(
            pred, gt, n_cls, 255)]
        for w, g in zip(want, got):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=METRIC_TOL)
        pre_j.append(tuple(want))
        pre_p.append(tuple(got))
    preds, gts = zip(*pairs)
    want = jmetrics.total_intersect_and_union(np.stack(preds), np.stack(gts),
                                              n_cls, 255)
    got = metrics.total_intersect_and_union(np.stack(preds), np.stack(gts),
                                            n_cls, 255)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=METRIC_TOL)
    for k, v in jmetrics.mean_iou(preds, gts, n_cls, 255).items():
        np.testing.assert_allclose(metrics.mean_iou(preds, gts, n_cls,
                                                    255)[k], v, rtol=0,
                                   atol=METRIC_TOL, err_msg=k)
    for names in (('mIoU',), ('mDice',), ('mFscore',)):
        for want, got in ((jmetrics.pre_eval_to_metrics(pre_j, names),
                           metrics.pre_eval_to_metrics(pre_p, names)),
                          (jmetrics.eval_metrics(preds, gts, n_cls, 255,
                                                 names),
                           metrics.eval_metrics(preds, gts, n_cls, 255,
                                                names))):
            assert sorted(want) == sorted(got)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=METRIC_TOL, err_msg=k)


def test_dataset_pre_eval_and_evaluate(cfg):
    """dataset.pre_eval / evaluate on predictions made from the labels."""
    jds, ds = _datasets(cfg, 'val')
    rng = np.random.default_rng(5)
    pre_j, pre_p = [], []
    for idx in range(4):
        gt = ds.get_gt_seg_map(idx)
        pred = np.where(rng.random(gt.shape) < 0.7, gt,
                        rng.integers(0, 21, gt.shape))
        pred = np.where(pred == 255, 0, pred).astype(np.int32)
        pre_j += jds.pre_eval([pred], [idx])
        pre_p += ds.pre_eval([pred], [idx])
    want, got = jds.evaluate(pre_j), ds.evaluate(pre_p)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL,
                                   equal_nan=True, err_msg=k)
