"""The port's datasets, wrappers and class tables held to the JAX package on
the CPU, on small trees written with seeded numpy into ``tmp_path``.

- Every dataset class of JAX ``data/datasets/custom.py`` beyond VOC and
  Cityscapes (ADE20K, COCO-Stuff, LoveDA, COCO, Potsdam, ISPRS, iSAID,
  Pascal Context and Context59, the four retinal sets, Dark Zurich, Night
  Driving): CLASSES and PALETTE; the suffix and ``reduce_zero_label``
  defaults and which of them a config may override (Dark Zurich and Night
  Driving overwrite theirs); ``img_infos`` and ``get_gt_seg_map`` (after
  ``reduce_zero_label``); one training-pipeline item bit for bit; and
  ``pre_eval`` + ``evaluate`` of seeded predictions (exact: the same
  integer counts through the same float64 ratios).
- ``core.class_names.get_classes``/``get_palette`` over every registry
  name and alias; an unknown name raises in both.
- ``ConcatDataset``: indexing across the sources, ``pre_eval``, and
  ``evaluate`` with ``separate_eval`` (keys ``i_``) and merged (one
  histogram over every source, equal to one dataset over the union;
  mismatched CLASSES raise); ``ConcatDataset_SETR``.
- ``MultiImageMixDataset`` + ``RandomMosaic``: the same items bit for bit
  from the same numpy and Python ``random`` states.
- The ``cityscapes`` metric: the JAX ``ImportError`` text without
  ``cityscapesscripts``; with a stub package in ``sys.modules`` the same
  submission files (under the stub's label palette), evaluator arguments
  and results as the JAX route; ``tools.test --eval cityscapes`` writes
  the files an image at a time and hands them to the evaluator.
"""
import os
import os.path as osp
import random
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

import s4former_tpu.data  # noqa: F401  (registers the JAX pipelines)
import s4former_tpu_torch.data  # noqa: F401
from s4former_tpu.core import class_names as j_class_names
from s4former_tpu.data.datasets.custom import build_dataset as j_build
from s4former_tpu_torch.core import class_names
from s4former_tpu_torch.data.datasets.custom import build_dataset
from s4former_tpu_torch.tools import test as test_cli
from tests._torch_port import (FIXTURE, NORM, write_ade_tree,
                               write_cli_config)
from tests.test_torch_data import _assert_same

# the dataset classes of JAX custom.py beyond VOC and Cityscapes
DATASETS = ['ADE20KDataset', 'COCOStuffDataset', 'LoveDADataset',
            'COCODataset', 'PotsdamDataset', 'ISPRSDataset', 'iSAIDDataset',
            'PascalContextDataset', 'PascalContextDataset59',
            'ChaseDB1Dataset', 'DRIVEDataset', 'HRFDataset', 'STAREDataset',
            'DarkZurichDataset', 'NightDrivingDataset']


def _train_pipeline(reduce_zero_label):
    return [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations',
                 reduce_zero_label=reduce_zero_label),
            dict(type='Resize', img_scale=(80, 40), ratio_range=(0.5, 2.0)),
            dict(type='RandomCrop', crop_size=(32, 32), cat_max_ratio=0.75),
            dict(type='RandomFlip', prob=0.5),
            dict(type='PhotoMetricDistortion'),
            dict(type='Normalize', **NORM),
            dict(type='Pad', size=(32, 32), pad_val=0, seg_pad_val=255),
            dict(type='DefaultFormatBundle'),
            dict(type='Collect', keys=['img', 'gt_semantic_seg'])]


def _tree(root, name, n=3):
    """A flat tree of ``n`` seeded images and label maps for dataset
    ``name`` under the suffixes the JAX class defaults to (read from an
    empty instance), and a split file of their stems; labels of blocks over every class id, with 255s, and
    with 0 where ``reduce_zero_label`` turns it into 255. Returns the
    config both packages build."""
    cfg = dict(type=name, data_root=str(root), img_dir='img',
               ann_dir='ann', pipeline=[])
    probe = j_build(cfg)
    n_cls = len(probe.CLASSES)
    rs = np.random.RandomState(DATASETS.index(name))
    os.makedirs(root / 'img')
    os.makedirs(root / 'ann')
    for i in range(n):
        h, w = 30 + 4 * i, 40 - 2 * i
        blocks = rs.randint(0, n_cls + probe.reduce_zero_label,
                            (-(-h // 4), -(-w // 4)))
        blocks[rs.rand(*blocks.shape) < 0.1] = 255
        if probe.reduce_zero_label:
            blocks[rs.rand(*blocks.shape) < 0.1] = 0
        label = np.kron(blocks, np.ones((4, 4), np.int64))[:h, :w]
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        stem = f'im{i}'
        Image.fromarray(img).save(root / 'img' / (stem + probe.img_suffix),
                                  format='JPEG' if probe.img_suffix.endswith(
                                      '.jpg') else 'PNG')
        seg = label.astype(np.uint8)
        if name == 'iSAIDDataset':          # RGB label files
            seg = np.repeat(seg[..., None], 3, axis=-1)
        Image.fromarray(seg).save(root / 'ann' /
                                  (stem + probe.seg_map_suffix))
    (root / 'split.txt').write_text(
        '\n'.join(f'im{i}' for i in range(n)) + '\n')
    return dict(cfg, split='split.txt',
                pipeline=_train_pipeline(probe.reduce_zero_label))


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """Each dataset's tree and config, made once."""
    out = {}
    for name in DATASETS:
        out[name] = _tree(tmp_path_factory.mktemp(name), name)
    return out


@pytest.mark.parametrize('name', DATASETS)
def test_tables_and_defaults_match_jax(name, tmp_path):
    cfg = dict(type=name, data_root=str(tmp_path), img_dir='img',
               ann_dir='ann', pipeline=[])
    jds, ds = j_build(cfg), build_dataset(cfg)
    assert type(ds).__name__ == name
    assert ds.CLASSES == jds.CLASSES and isinstance(ds.CLASSES, tuple)
    assert ds.PALETTE == jds.PALETTE
    for key in ('img_suffix', 'seg_map_suffix', 'reduce_zero_label',
                'ignore_index'):
        assert getattr(ds, key) == getattr(jds, key), key
    # a config's suffixes: kept by setdefault, overwritten by the night sets
    given = dict(cfg, img_suffix='.x.png', seg_map_suffix='.y.png',
                 reduce_zero_label=not jds.reduce_zero_label)
    jds, ds = j_build(given), build_dataset(given)
    for key in ('img_suffix', 'seg_map_suffix', 'reduce_zero_label'):
        assert getattr(ds, key) == getattr(jds, key), key
    forced = name in ('DarkZurichDataset', 'NightDrivingDataset')
    assert (ds.img_suffix != '.x.png') == forced


@pytest.mark.parametrize('name', DATASETS)
def test_img_infos_and_gt_match_jax(name, trees):
    jds, ds = j_build(trees[name]), build_dataset(trees[name])
    assert len(ds) == len(jds) == 3
    assert ds.img_infos == jds.img_infos
    for idx in range(len(ds)):
        want, got = jds.get_gt_seg_map(idx), ds.get_gt_seg_map(idx)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    if ds.reduce_zero_label:        # label 0 ("other") is ignored
        raw = np.asarray(Image.open(ds.img_infos[0]['seg_map']))
        assert (raw == 0).any()
        assert np.all(ds.get_gt_seg_map(0)[raw == 0] == 255)


@pytest.mark.parametrize('name', DATASETS)
def test_items_match_jax(name, trees):
    jds, ds = j_build(trees[name]), build_dataset(trees[name])
    for idx, seed in ((0, 3), (2, 5)):
        _assert_same(jds.get_item_deterministic(idx, seed),
                     ds.get_item_deterministic(idx, seed), f'{name} {idx}')


def _preds(ds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for idx in range(len(ds)):
        gt = ds.get_gt_seg_map(idx)
        pred = np.where(rng.random(gt.shape) < 0.6, gt,
                        rng.integers(0, len(ds.CLASSES), gt.shape))
        out.append(np.where(pred == 255, 0, pred).astype(np.int32))
    return out


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('name', DATASETS)
def test_pre_eval_and_evaluate_match_jax(name, trees):
    jds, ds = j_build(trees[name]), build_dataset(trees[name])
    preds = _preds(ds, 7)
    pre_j = jds.pre_eval(preds, list(range(len(ds))))
    pre_p = ds.pre_eval(preds, list(range(len(ds))))
    for a, b in zip(pre_j, pre_p):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    _same_metrics(ds.evaluate(pre_p, metric=['mIoU', 'mDice']),
                  jds.evaluate(pre_j, metric=['mIoU', 'mDice']))
    _same_metrics(ds.evaluate(preds), jds.evaluate(preds))   # label maps


@pytest.mark.parametrize('name', sorted(j_class_names._REGISTRY))
def test_class_tables_match_jax(name):
    assert class_names.get_classes(name) == j_class_names.get_classes(name)
    assert class_names.get_palette(name) == j_class_names.get_palette(name)
    assert class_names.get_palette(name.upper()) == \
        j_class_names.get_palette(name)
    assert len(class_names.get_palette(name)) >= \
        len(class_names.get_classes(name))


def test_unknown_class_table_raises_in_both():
    for pkg in (class_names, j_class_names):
        with pytest.raises(KeyError, match='unknown dataset'):
            pkg.get_classes('nope')
        with pytest.raises(KeyError):
            pkg.get_palette('nope')


# ------------------------------------------------------------- wrappers
@pytest.fixture(scope='module')
def ade(tmp_path_factory):
    """An ADE20K tree of 4 + 4 training and 5 val images, and the configs
    of two val halves (split files) and of the whole val folder."""
    root = tmp_path_factory.mktemp('ade')
    stems = write_ade_tree(root, seed=3, n_val=5)
    halves = []
    for i, part in enumerate((stems['val'][:2], stems['val'][2:])):
        split = root / f'val{i}.txt'
        split.write_text('\n'.join(part) + '\n')
        halves.append(dict(type='ADE20KDataset', data_root=str(root),
                           img_dir='images/validation',
                           ann_dir='annotations/validation',
                           split=str(split),
                           pipeline=_train_pipeline(True)))
    whole = dict(halves[0], split=None)
    return SimpleNamespace(root=root, stems=stems, halves=halves,
                           whole=whole)


def _concat(halves, **kw):
    return dict(type='ConcatDataset', datasets=halves, **kw)


def test_concat_indexes_across_sources(ade):
    cfg = _concat(ade.halves)
    jds, ds = j_build(cfg), build_dataset(cfg)
    assert len(ds) == len(jds) == 5
    assert [ds._locate(i) for i in range(5)] == \
        [jds._locate(i) for i in range(5)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2)]
    whole = build_dataset(ade.whole)
    assert [i['filename'] for i in ds.img_infos] == \
        [i['filename'] for i in whole.img_infos]
    for idx in range(5):
        np.testing.assert_array_equal(ds.get_gt_seg_map(idx),
                                      jds.get_gt_seg_map(idx))
        d, off = ds._locate(idx)
        _assert_same(ds.get_item_deterministic(idx, 1),
                     ds.datasets[d].get_item_deterministic(off, 1), idx)
        np.random.seed(idx)
        want = jds[idx]
        np.random.seed(idx)
        _assert_same(want, ds[idx], idx)
    preds = _preds(ds, 2)
    for a, b in zip(jds.pre_eval(preds, list(range(5))),
                    ds.pre_eval(preds, list(range(5)))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize('separate', [True, False])
def test_concat_evaluate_matches_jax(ade, separate):
    cfg = _concat(ade.halves, separate_eval=separate)
    jds, ds = j_build(cfg), build_dataset(cfg)
    preds = _preds(ds, 4)
    pre = ds.pre_eval(preds, list(range(len(ds))))
    got = ds.evaluate(pre, metric='mIoU')
    _same_metrics(got, jds.evaluate(jds.pre_eval(preds, list(range(5))),
                                    metric='mIoU'))
    _same_metrics(ds.evaluate(preds, metric='mIoU'),
                  jds.evaluate(preds, metric='mIoU'))
    if separate:
        assert {k.split('_', 1)[0] for k in got} == {'0', '1'}
        first = build_dataset(ade.halves[0])
        _same_metrics({k[2:]: v for k, v in got.items()
                       if k.startswith('0_')},
                      first.evaluate(pre[:2], metric='mIoU'))
    else:
        # one histogram over both halves: the whole folder's metrics
        whole = build_dataset(ade.whole)
        _same_metrics(got, whole.evaluate(pre, metric='mIoU'))


def test_concat_merged_eval_needs_one_class_table(ade):
    voc = dict(ade.halves[1], type='PascalVOCDataset')
    cfg = _concat([ade.halves[0], voc], separate_eval=False)
    for build in (j_build, build_dataset):
        ds = build(cfg)
        preds = _preds(ds.datasets[0], 1) + [np.zeros((2, 2), np.int32)] * 3
        with pytest.raises(AssertionError, match='CLASSES'):
            ds.evaluate(preds)


def test_concat_setr_evaluates_each_source(ade):
    cfg = dict(type='ConcatDataset_SETR', datasets=ade.halves)
    jds, ds = j_build(cfg), build_dataset(cfg)
    assert type(ds).__name__ == 'ConcatDatasetSETR' and ds.separate_eval
    preds = _preds(ds, 9)
    _same_metrics(ds.evaluate(preds), jds.evaluate(preds))


def _mosaic_cfg(root, skip=None):
    inner = dict(type='ADE20KDataset', data_root=str(root),
                 img_dir='images/training', ann_dir='annotations/training',
                 pipeline=[dict(type='LoadImageFromFile'),
                           dict(type='LoadAnnotations',
                                reduce_zero_label=True)])
    return dict(type='MultiImageMixDataset', dataset=inner,
                skip_type_keys=skip,
                pipeline=[dict(type='RandomMosaic', prob=1.0,
                               img_scale=(24, 32)),
                          dict(type='RandomFlip', prob=0.5),
                          dict(type='Normalize', **NORM),
                          dict(type='DefaultFormatBundle'),
                          dict(type='Collect',
                               keys=['img', 'gt_semantic_seg'])])


@pytest.mark.parametrize('skip', [None, ('RandomMosaic',)])
def test_multi_image_mix_mosaic_matches_jax(ade, skip):
    cfg = _mosaic_cfg(ade.root, skip)
    jds, ds = j_build(cfg), build_dataset(cfg)
    assert len(ds) == len(jds) == 8 and ds.CLASSES == jds.CLASSES
    for idx in (0, 5, 7):
        items = []
        for d in (jds, ds):
            np.random.seed(idx)
            random.seed(idx)
            items.append(d[idx])
        _assert_same(*items, idx)
        shape = items[1]['img'].shape
        assert 'mix_results' not in items[1]
        if skip is None:                   # 2 x 2 quadrants of (24, 32)
            assert shape == (48, 64, 3), shape
        else:
            with Image.open(ds.dataset.img_infos[idx]['filename']) as im:
                assert shape == (im.size[1], im.size[0], 3), shape


def test_mosaic_indexes_match_jax(ade):
    """The 3 companions come from Python's ``random`` stream, as JAX's."""
    cfg = _mosaic_cfg(ade.root)
    jds, ds = j_build(cfg), build_dataset(cfg)
    out = []
    for d in (jds, ds):
        random.seed(5)
        out.append([d.pipeline[0].get_indexes(d.dataset) for _ in range(4)])
    assert out[0] == out[1]
    assert all(len(a) == 3 and all(0 <= i < 8 for i in a) for a in out[1])


# ------------------------------------------------------- cityscapes route
def _city_tree(root, n=2):
    """Two frames in the Cityscapes layout (one city folder's files, flat,
    and a split file of their stems): trainId maps for the histogram
    metrics and labelId maps for the official evaluator."""
    rs = np.random.RandomState(1)
    for sub in ('leftImg8bit', 'gtFine'):
        os.makedirs(root / sub / 'val')
    for i in range(n):
        stem = f'lindau_{i:06d}_000019'
        train_ids = rs.randint(0, 19, (16, 32)).astype(np.uint8)
        Image.fromarray(rs.randint(0, 256, (16, 32, 3)).astype(np.uint8)) \
            .save(root / 'leftImg8bit' / 'val' / f'{stem}_leftImg8bit.png')
        gt = root / 'gtFine' / 'val'
        Image.fromarray(train_ids).save(gt / f'{stem}_gtFine_labelTrainIds'
                                             '.png')
        Image.fromarray(train_ids + 7).save(gt / f'{stem}_gtFine_labelIds.png')
    (root / 'val.txt').write_text('\n'.join(
        f'lindau_{i:06d}_000019' for i in range(n)) + '\n')
    return dict(type='CityscapesDataset', data_root=str(root),
                img_dir='leftImg8bit/val', ann_dir='gtFine/val',
                split='val.txt', pipeline=[])


def _stub_cityscapesscripts(monkeypatch, calls):
    """A ``cityscapesscripts`` with the two modules the route reads: the
    evaluator (its ``args``, ``getPrediction`` and ``evaluateImgLists``,
    recording what it is given) and ``helpers.labels.id2label``."""
    modules = {n: types.ModuleType(n) for n in (
        'cityscapesscripts', 'cityscapesscripts.evaluation',
        'cityscapesscripts.evaluation.evalPixelLevelSemanticLabeling',
        'cityscapesscripts.helpers', 'cityscapesscripts.helpers.labels')}
    ev = modules['cityscapesscripts.evaluation.evalPixelLevelSemanticLabeling']
    ev.args = SimpleNamespace()

    def get_prediction(args, gt):
        stem = osp.basename(gt).replace('_gtFine_labelIds.png', '')
        return osp.join(args.predictionPath, stem + '_leftImg8bit.png')

    def evaluate_img_lists(preds, gts, args):
        calls.append(dict(preds=list(preds), gts=list(gts),
                          args=dict(vars(args))))
        return {'averageScoreCategories': 0.5, 'averageScoreClasses': 0.25}

    ev.getPrediction, ev.evaluateImgLists = get_prediction, evaluate_img_lists
    modules['cityscapesscripts.helpers.labels'].id2label = {
        i: SimpleNamespace(color=(i * 7 % 256, i * 13 % 256, 255 - i))
        for i in range(34)}
    for name, module in modules.items():
        monkeypatch.setitem(sys.modules, name, module)
        parent, _, child = name.rpartition('.')
        if parent:
            setattr(modules[parent], child, module)


def test_cityscapes_metric_without_the_package(tmp_path, monkeypatch):
    cfg = _city_tree(tmp_path)
    monkeypatch.setitem(sys.modules, 'cityscapesscripts', None)
    errors = []
    for build in (j_build, build_dataset):
        ds = build(cfg)
        preds = [ds.get_gt_seg_map(i) for i in range(len(ds))]
        with pytest.raises(ImportError) as e:
            ds.evaluate(preds, metric='cityscapes')
        errors.append(str(e.value))
    assert errors[0] == errors[1] and 'cityscapesscripts' in errors[0]


def test_cityscapes_metric_with_a_stub_matches_jax(tmp_path, monkeypatch):
    cfg = _city_tree(tmp_path / 'city')
    out = {}
    for pkg, build in (('jax', j_build), ('port', build_dataset)):
        calls = []
        _stub_cityscapesscripts(monkeypatch, calls)
        ds = build(cfg)
        preds = _preds(ds, 3)
        prefix = tmp_path / pkg
        res = ds.evaluate(preds, metric=['cityscapes', 'mIoU'],
                          imgfile_prefix=str(prefix))
        files = {n: (prefix / n).read_bytes()
                 for n in sorted(os.listdir(prefix))}
        (call,) = calls
        call['preds'] = [osp.relpath(p, prefix) for p in call['preds']]
        assert call['args'].pop('predictionPath') == str(prefix)
        out[pkg] = (res, files, call)
    (res, files, call), (j_res, j_files, j_call) = out['port'], out['jax']
    _same_metrics(res, j_res)
    assert res['averageScoreClasses'] == 0.25 and 'mIoU' in res
    assert sorted(files) == ['lindau_000000_000019_leftImg8bit.png',
                             'lindau_000001_000019_leftImg8bit.png']
    assert files == j_files
    assert call == j_call
    assert call['args'] == dict(evalInstLevelScore=True,
                                evalPixelAccuracy=True, JSONOutput=False)
    # the stub's palette colours label id 7 (trainId 0)
    png = Image.open(tmp_path / 'port' / sorted(files)[0])
    assert png.getpalette()[21:24] == [49, 91, 248]


def test_test_cli_scores_cityscapes_files(tmp_path, monkeypatch):
    """``tools.test --eval cityscapes mIoU``: the label-id files of
    ``--format-only``, written an image at a time, go to the evaluator;
    mIoU comes from the histograms."""
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = f.read().split()[:2]
    split = tmp_path / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    cfg = write_cli_config(tmp_path, str(split))
    city = ['--cfg-options', 'data.test.type=CityscapesDataset',
            'data.test.img_suffix=.jpg', 'data.test.seg_map_suffix=.png']
    calls = []
    _stub_cityscapesscripts(monkeypatch, calls)
    fmt, ev = tmp_path / 'fmt', tmp_path / 'ev'
    assert test_cli.main([cfg, '--device', 'cpu', '--format-only',
                          '--imgfile-prefix', str(fmt)] + city) is None
    res = test_cli.main([cfg, '--device', 'cpu', '--eval', 'cityscapes',
                         'mIoU', '--imgfile-prefix', str(ev)] + city)
    assert sorted(os.listdir(ev)) == [f'{s}.png' for s in stems]
    for name in os.listdir(ev):
        assert (ev / name).read_bytes() == (fmt / name).read_bytes()
    (call,) = calls
    assert call['args']['predictionPath'] == str(ev)
    assert res['averageScoreCategories'] == 0.5 and 0 <= res['mIoU'] <= 1
