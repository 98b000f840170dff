"""Split-file-driven segmentation datasets (the port's copy of
``s4former_tpu/data/datasets/custom.py``; reference:
mmseg/datasets/custom.py:32-512, the dataset files beside it and
dataset_wrappers.py).

``CustomDataset`` and its datasets (VOC, Cityscapes with its submission
format and the official ``cityscapes`` metric, ADE20K, COCO-Stuff, LoveDA,
COCO, Potsdam, ISPRS, iSAID, Pascal Context and Context59, the four
retinal vessel sets, Dark Zurich and Night Driving), the wrappers
(``SemiDataset``, ``UniSemiDataset``, ``RepeatDataset``, ``ConcatDataset``,
``ConcatDataset_SETR``, ``MultiImageMixDataset``) and ``build_dataset``.
Items are numpy dicts made by the pipeline; the loader batches them.
"""
from __future__ import annotations

import bisect
import copy
import glob
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from s4former_tpu_torch.core import class_names
from s4former_tpu_torch.core.metrics import (eval_metrics, intersect_and_union,
                                             pre_eval_to_metrics)
from s4former_tpu_torch.data.pipelines.transforms import Compose
from s4former_tpu_torch.registry import DATASETS, PIPELINES


@DATASETS.register_module()
class CustomDataset:
    """(custom.py:32): img_dir + ann_dir (+ a split file of stems).
    ``__getitem__`` runs the pipeline; ``pre_eval`` gives per-image
    confusion histograms (custom.py:302)."""

    CLASSES: Optional[Sequence[str]] = None
    PALETTE = None

    def __init__(self,
                 pipeline,
                 img_dir: str,
                 img_suffix: str = '.jpg',
                 ann_dir: Optional[str] = None,
                 seg_map_suffix: str = '.png',
                 split: Optional[str] = None,
                 data_root: Optional[str] = None,
                 test_mode: bool = False,
                 ignore_index: int = 255,
                 reduce_zero_label: bool = False,
                 classes=None,
                 palette=None,
                 seed: int = 0,
                 **kwargs):
        self.pipeline = Compose(pipeline)
        self.img_dir = img_dir
        self.img_suffix = img_suffix
        self.ann_dir = ann_dir
        self.seg_map_suffix = seg_map_suffix
        self.split = split
        self.data_root = data_root
        self.test_mode = test_mode
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.label_map = None
        self.base_seed = seed
        if classes is not None:
            self.CLASSES = tuple(classes)
        if palette is not None:
            self.PALETTE = palette

        if data_root is not None:
            if not osp.isabs(self.img_dir):
                self.img_dir = osp.join(data_root, self.img_dir)
            if self.ann_dir is not None and not osp.isabs(self.ann_dir):
                self.ann_dir = osp.join(data_root, self.ann_dir)
            if self.split is not None and not osp.isabs(self.split):
                self.split = osp.join(data_root, self.split)

        self.img_infos = self.load_annotations()

    def load_annotations(self) -> List[Dict]:
        """(custom.py:150): the split file's stems, or a scan of img_dir."""
        if self.split is not None:
            with open(self.split) as f:
                stems = [line.strip() for line in f if line.strip()]
            pairs = [(osp.join(self.img_dir, stem + self.img_suffix),
                      stem + self.img_suffix, stem) for stem in stems]
        else:
            pairs = [(path, osp.basename(path),
                      osp.splitext(osp.basename(path))[0])
                     for path in sorted(glob.glob(
                         osp.join(self.img_dir, f'*{self.img_suffix}')))]
        infos = []
        for path, name, stem in pairs:
            info = dict(filename=path, ori_filename=name)
            if self.ann_dir is not None:
                info['seg_map'] = osp.join(self.ann_dir,
                                           stem + self.seg_map_suffix)
            infos.append(info)
        return infos

    def __len__(self) -> int:
        return len(self.img_infos)

    def _base_results(self, idx: int) -> Dict:
        info = self.img_infos[idx]
        results: Dict = dict(
            img_info=dict(filename=info['filename'],
                          ori_filename=info['ori_filename']),
            seg_fields=[])
        if 'seg_map' in info:
            results['ann_info'] = dict(seg_map=info['seg_map'])
        if self.label_map is not None:
            results['label_map'] = self.label_map
        return results

    def __getitem__(self, idx: int):
        results = self._base_results(idx)
        # deterministic per-(epoch-less) sample rng; reseeded per access
        results['rng'] = np.random.default_rng(
            np.random.SeedSequence([self.base_seed, idx,
                                    np.random.randint(0, 2 ** 31)]))
        return self.pipeline(results)

    def get_item_deterministic(self, idx: int, seed: int):
        results = self._base_results(idx)
        results['rng'] = np.random.default_rng(
            np.random.SeedSequence([self.base_seed, seed, idx]))
        return self.pipeline(results)

    def get_gt_seg_map(self, idx: int) -> np.ndarray:
        with Image.open(self.img_infos[idx]['seg_map']) as im:
            seg = np.asarray(im)
        if seg.ndim == 3:
            seg = seg[..., 0]
        seg = seg.astype(np.int32)
        if self.reduce_zero_label:
            seg[seg == 0] = 256
            seg = seg - 1
            seg[seg == 255] = 255
        if self.label_map is not None:
            out = seg.copy()
            for old_id, new_id in self.label_map.items():
                out[seg == old_id] = new_id
            seg = out
        return seg

    # --------------------------------------------------------- evaluation
    def pre_eval(self, preds, indices):
        """(custom.py:302): per-image (intersect, union, areas) tuples of
        numpy arrays."""
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        out = []
        for pred, idx in zip(preds, indices):
            gt = self.get_gt_seg_map(idx)
            out.append(tuple(x.cpu().numpy() for x in intersect_and_union(
                pred, gt, len(self.CLASSES), self.ignore_index)))
        return out

    def evaluate(self, results, metric='mIoU', **kwargs):
        """(custom.py:413): pre_eval tuples or full label maps."""
        metrics = [metric] if isinstance(metric, str) else list(metric)
        if len(results) and isinstance(results[0], tuple):
            tables = pre_eval_to_metrics(results, metrics)
        else:
            gts = [self.get_gt_seg_map(i) for i in range(len(self))]
            tables = eval_metrics(results, gts, len(self.CLASSES),
                                  self.ignore_index, metrics)
        out = {'aAcc': float(tables['aAcc'])}
        for key, vals in tables.items():
            if key == 'aAcc':
                continue
            out[f'm{key}'] = float(np.nanmean(vals))
            for name, v in zip(self.CLASSES or [], np.asarray(vals)):
                out[f'{key}.{name}'] = float(v)
        return out

    def format_results(self, results, imgfile_prefix, indices=None,
                       **kwargs):
        """A dataset's submission files (custom.py:179; reference
        custom.py:275-277): the reference defines none for this dataset,
        nor for VOC; ``CityscapesDataset`` writes its label-id PNGs."""
        raise NotImplementedError(
            f'{type(self).__name__} defines no submission format; '
            'use a dataset with format_results (e.g. cityscapes)')


@DATASETS.register_module()
class PascalVOCDataset(CustomDataset):
    """(voc.py:9): 21 classes and their palette."""

    CLASSES = tuple(class_names.voc_classes())
    PALETTE = class_names.voc_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '.png')
        super().__init__(**kwargs)


@DATASETS.register_module()
class CityscapesDataset(CustomDataset):
    """(custom.py:210; reference cityscapes.py:14): trainId label maps
    (``*_gtFine_labelTrainIds``); predictions are submitted as label-id
    PNGs."""

    CLASSES = tuple(class_names.cityscapes_classes())
    PALETTE = class_names.cityscapes_palette()
    # trainId -> labelId (cityscapesscripts.helpers.labels)
    TRAINID2LABELID = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25,
                       26, 27, 28, 31, 32, 33)

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '_leftImg8bit.png')
        kwargs.setdefault('seg_map_suffix', '_gtFine_labelTrainIds.png')
        super().__init__(**kwargs)

    def _convert_to_label_id(self, result: np.ndarray) -> np.ndarray:
        """trainId map -> labelId map (reference cityscapes.py:36-47);
        other values become 0."""
        out = np.full_like(result, 0)
        for train_id, label_id in enumerate(self.TRAINID2LABELID):
            out[result == train_id] = label_id
        return out

    def results2img(self, results, imgfile_prefix, to_label_id=True,
                    indices=None) -> List[str]:
        """Write each prediction as ``imgfile_prefix/<image stem>.png``, a
        'P' PNG of label ids (or trainIds) under cityscapesscripts'
        palette when that package is installed, the trainId palette
        otherwise (custom.py:243-274; reference cityscapes.py:49-93).
        Returns the paths."""
        if indices is None:
            indices = list(range(len(self)))
        os.makedirs(imgfile_prefix, exist_ok=True)
        try:
            import cityscapesscripts.helpers.labels as CSLabels
            palette = np.zeros((len(CSLabels.id2label), 3), np.uint8)
            for label_id, label in CSLabels.id2label.items():
                palette[label_id] = label.color
        except ImportError:
            palette = np.zeros((max(self.TRAINID2LABELID) + 1, 3), np.uint8)
            for tid, lid in enumerate(self.TRAINID2LABELID):
                palette[lid] = self.PALETTE[tid]
        files = []
        for result, idx in zip(results, indices):
            if to_label_id:
                result = self._convert_to_label_id(np.asarray(result))
            base = osp.splitext(osp.basename(
                self.img_infos[idx]['filename']))[0]
            png = osp.join(imgfile_prefix, f'{base}.png')
            out = Image.fromarray(result.astype(np.uint8)).convert('P')
            out.putpalette(palette.reshape(-1).tolist())
            out.save(png)
            files.append(png)
        return files

    def format_results(self, results, imgfile_prefix, to_label_id=True,
                       indices=None):
        """(custom.py:277; reference cityscapes.py:95-128)."""
        return self.results2img(results, imgfile_prefix, to_label_id,
                                indices)

    def evaluate(self, results, metric='mIoU', imgfile_prefix=None,
                 **kwargs):
        """(custom.py:283; reference cityscapes.py:130-169): the
        'cityscapes' metric goes to the official cityscapesscripts
        evaluator, the others to the histogram metrics."""
        metrics = list(metric) if isinstance(metric, (list, tuple)) \
            else [metric]
        out = {}
        if 'cityscapes' in metrics:
            out.update(self._evaluate_cityscapes(results, imgfile_prefix))
            metrics.remove('cityscapes')
        if metrics:
            out.update(super().evaluate(results, metrics, **kwargs))
        return out

    def _evaluate_cityscapes(self, results, imgfile_prefix):
        """(custom.py:299-321): the predictions as label-id PNGs in
        ``imgfile_prefix``, scored by ``evalPixelLevelSemanticLabeling``
        against every ``*gtFine_labelIds.png`` under ``ann_dir``. Label
        maps are written here; with ``pre_eval`` tuples the caller has
        written them (``tools.test`` does, an image at a time)."""
        try:
            import cityscapesscripts.evaluation. \
                evalPixelLevelSemanticLabeling as CSEval
        except ImportError as e:
            raise ImportError(
                'the "cityscapes" metric needs cityscapesscripts '
                '(pip install cityscapesscripts)') from e
        result_dir = imgfile_prefix or 'cityscapes_eval_tmp'
        if not (len(results) and isinstance(results[0], tuple)):
            self.format_results(results, result_dir)
        CSEval.args.evalInstLevelScore = True
        CSEval.args.predictionPath = osp.abspath(result_dir)
        CSEval.args.evalPixelAccuracy = True
        CSEval.args.JSONOutput = False
        seg_maps = sorted(glob.glob(osp.join(
            self.ann_dir, '**', '*gtFine_labelIds.png'), recursive=True))
        preds = [CSEval.getPrediction(CSEval.args, seg_map)
                 for seg_map in seg_maps]
        return dict(CSEval.evaluateImgLists(preds, seg_maps, CSEval.args))


@DATASETS.register_module()
class ADE20KDataset(CustomDataset):
    """(custom.py:325; reference ade.py): 150 classes; label 0 ("other")
    is ignored through ``reduce_zero_label``."""

    CLASSES = tuple(class_names.ade_classes())
    PALETTE = class_names.ade_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)


@DATASETS.register_module()
class SemiDataset:
    """(dataset_wrappers.py:279-305): a (sup, unsup) pair kept explicit;
    the sampler draws a fixed ratio from each."""

    def __init__(self, sup: dict, unsup: dict, **kwargs):
        self.sup = DATASETS.build(dict(sup)) if isinstance(sup, dict) \
            else sup
        self.unsup = DATASETS.build(dict(unsup)) if isinstance(unsup, dict) \
            else unsup
        self.CLASSES = self.sup.CLASSES
        self.PALETTE = self.sup.PALETTE

    def __len__(self):
        return len(self.sup) + len(self.unsup)


@DATASETS.register_module()
class UniSemiDataset(SemiDataset):
    """(dataset_wrappers.py:308; JAX custom.py:541-552): a SemiDataset with
    a third, unlabeled source ``unsup2``, the mix-source stream of
    UniMatch. ``tools.train`` reads it from the train config's
    ``unsup_mix`` (or ``unsup2``) and hands it to ``SemiLoader``, whose
    batches then hold the ``*_mix`` views."""

    def __init__(self, sup: dict, unsup: dict, unsup2: Optional[dict] = None,
                 **kwargs):
        super().__init__(sup, unsup, **kwargs)
        self.unsup2 = DATASETS.build(dict(unsup2)) if unsup2 else None

    def __len__(self):
        n = super().__len__()
        return n + (len(self.unsup2) if self.unsup2 else 0)


@DATASETS.register_module()
class RepeatDataset:
    """(dataset_wrappers.py:165-192): ``times`` x the dataset, items
    repeating modulo its length."""

    def __init__(self, dataset, times: int):
        self.dataset = DATASETS.build(dict(dataset)) \
            if isinstance(dataset, dict) else dataset
        self.times = int(times)
        self.CLASSES = self.dataset.CLASSES
        self.PALETTE = self.dataset.PALETTE
        self._ori_len = len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def get_gt_seg_map(self, idx):
        return self.dataset.get_gt_seg_map(idx % self._ori_len)

    def pre_eval(self, preds, indices):
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        return self.dataset.pre_eval(preds,
                                     [i % self._ori_len for i in indices])

    def evaluate(self, results, **kwargs):
        return self.dataset.evaluate(results, **kwargs)

    def __len__(self):
        return self.times * self._ori_len


@DATASETS.register_module()
class ConcatDataset:
    """(custom.py:391; reference dataset_wrappers.py:16-163): the sources
    one after another. ``evaluate`` scores each source alone with its keys
    prefixed by the source's index (``separate_eval=True``), or all of
    them in one histogram. The port adds ``get_item_deterministic`` and
    ``img_infos``, which the in-loop eval and ``tools.test`` read (JAX's
    wrapper has neither)."""

    def __init__(self, datasets, separate_eval: bool = True):
        self.datasets = [DATASETS.build(dict(d)) if isinstance(d, dict)
                         else d for d in datasets]
        assert self.datasets, 'ConcatDataset needs at least one dataset'
        self.cumulative_sizes = list(np.cumsum([len(d)
                                                for d in self.datasets]))
        self.CLASSES = self.datasets[0].CLASSES
        self.PALETTE = self.datasets[0].PALETTE
        self.separate_eval = bool(separate_eval)
        self.img_infos = [info for d in self.datasets
                          for info in getattr(d, 'img_infos', ())]

    def _locate(self, idx):
        """(source, index within it) of item ``idx``."""
        d = bisect.bisect_right(self.cumulative_sizes, idx)
        return d, idx - (self.cumulative_sizes[d - 1] if d else 0)

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx):
        d, off = self._locate(idx)
        return self.datasets[d][off]

    def get_item_deterministic(self, idx, seed):
        d, off = self._locate(idx)
        return self.datasets[d].get_item_deterministic(off, seed)

    def get_gt_seg_map(self, idx):
        d, off = self._locate(idx)
        return self.datasets[d].get_gt_seg_map(off)

    def pre_eval(self, preds, indices):
        if not isinstance(indices, (list, tuple)):
            indices, preds = [indices], [preds]
        out = []
        for pred, idx in zip(preds, indices):
            d, off = self._locate(idx)
            out.extend(self.datasets[d].pre_eval([pred], [off]))
        return out

    def evaluate(self, results, **kwargs):
        assert len(results) == len(self), (
            f'results size {len(results)} != dataset size {len(self)}')
        if self.separate_eval:
            out, start = {}, 0
            for i, (d, end) in enumerate(zip(self.datasets,
                                             self.cumulative_sizes)):
                res = d.evaluate(results[start:end], **kwargs)
                out.update({f'{i}_{k}': v for k, v in res.items()})
                start = end
            return out
        assert all(d.CLASSES == self.CLASSES for d in self.datasets), \
            'merged eval needs identical CLASSES across sources'
        # one histogram over every source (an average of the sources'
        # metrics would weigh them by count, not by pixel)
        if results and isinstance(results[0], tuple):
            return self.datasets[0].evaluate(results, **kwargs)
        gts = [self.get_gt_seg_map(i) for i in range(len(self))]
        metric = kwargs.get('metric', 'mIoU')
        metrics = [metric] if isinstance(metric, str) else list(metric)
        tables = eval_metrics(results, gts, len(self.CLASSES),
                              self.datasets[0].ignore_index, metrics)
        out = {'aAcc': float(tables['aAcc'])}
        for key, vals in tables.items():
            if key != 'aAcc':
                out[f'm{key}'] = float(np.nanmean(vals))
        return out


@DATASETS.register_module(name='ConcatDataset_SETR')
class ConcatDatasetSETR(ConcatDataset):
    """(custom.py:467; reference dataset_wrappers.py:279-291): the
    concatenation with separate evaluation (the reference's group flags
    serve aspect-ratio batching, which the loader does not do)."""

    def __init__(self, datasets):
        super().__init__(datasets, separate_eval=True)


@DATASETS.register_module()
class MultiImageMixDataset:
    """(custom.py:555; reference dataset_wrappers.py:195-277): runs
    ``pipeline`` over the dataset's items; a transform with
    ``get_indexes`` (``RandomMosaic``) gets those items too, as
    ``results['mix_results']``. ``skip_type_keys`` names transforms to
    leave out."""

    def __init__(self, dataset, pipeline, skip_type_keys=None):
        self.dataset = DATASETS.build(dict(dataset)) \
            if isinstance(dataset, dict) else dataset
        self._skip_type_keys = skip_type_keys
        self.pipeline_types = [t['type'] for t in pipeline]
        self.pipeline = [PIPELINES.build(dict(t)) for t in pipeline]
        self.CLASSES = self.dataset.CLASSES
        self.PALETTE = getattr(self.dataset, 'PALETTE', None)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        results = copy.deepcopy(self.dataset[idx])
        for transform, ttype in zip(self.pipeline, self.pipeline_types):
            if self._skip_type_keys and ttype in self._skip_type_keys:
                continue
            if hasattr(transform, 'get_indexes'):
                results['mix_results'] = [
                    copy.deepcopy(self.dataset[i])
                    for i in transform.get_indexes(self.dataset)]
            results = transform(results)
            results.pop('mix_results', None)
        return results


def build_dataset(cfg: dict):
    return DATASETS.build(dict(cfg))


# ------------------------------------------------------ other datasets
# Pascal Context (custom.py:622-692): 60 classes with the background; the
# 59-class variant drops the first entry of each table
PASCAL_CONTEXT_CLASSES = (
    'background', 'aeroplane', 'bag', 'bed', 'bedclothes', 'bench',
    'bicycle', 'bird', 'boat', 'book', 'bottle', 'building', 'bus',
    'cabinet', 'car', 'cat', 'ceiling', 'chair', 'cloth', 'computer', 'cow',
    'cup', 'curtain', 'dog', 'door', 'fence', 'floor', 'flower', 'food',
    'grass', 'ground', 'horse', 'keyboard', 'light', 'motorbike',
    'mountain', 'mouse', 'person', 'plate', 'platform', 'pottedplant',
    'road', 'rock', 'sheep', 'shelves', 'sidewalk', 'sign', 'sky', 'snow',
    'sofa', 'table', 'track', 'train', 'tree', 'truck', 'tvmonitor', 'wall',
    'water', 'window', 'wood')
PASCAL_CONTEXT_PALETTE = [
    [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50],
    [4, 200, 3], [120, 120, 80], [140, 140, 140], [204, 5, 255],
    [230, 230, 230], [4, 250, 7], [224, 5, 255], [235, 255, 7],
    [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82],
    [143, 255, 140], [204, 255, 4], [255, 51, 7], [204, 70, 3],
    [0, 102, 200], [61, 230, 250], [255, 6, 51], [11, 102, 255],
    [255, 7, 71], [255, 9, 224], [9, 7, 230], [220, 220, 220],
    [255, 9, 92], [112, 9, 255], [8, 255, 214], [7, 255, 224],
    [255, 184, 6], [10, 255, 71], [255, 41, 10], [7, 255, 255],
    [224, 255, 8], [102, 8, 255], [255, 61, 6], [255, 194, 7],
    [255, 122, 8], [0, 255, 20], [255, 8, 41], [255, 5, 153],
    [6, 51, 255], [235, 12, 255], [160, 150, 20], [0, 163, 255],
    [140, 140, 140], [250, 10, 15], [20, 255, 0], [31, 255, 0],
    [255, 31, 0], [255, 224, 0], [153, 255, 0], [0, 0, 255],
    [255, 71, 0], [0, 235, 255], [0, 173, 255], [31, 0, 255]]


@DATASETS.register_module()
class COCOStuffDataset(CustomDataset):
    """(custom.py:481; reference coco_stuff.py): 171 classes."""

    CLASSES = tuple(class_names.cocostuff_classes())
    PALETTE = class_names.cocostuff_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '_labelTrainIds.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)


@DATASETS.register_module()
class LoveDADataset(CustomDataset):
    """(custom.py:497; reference loveda.py): 7 classes."""

    CLASSES = tuple(class_names.loveda_classes())
    PALETTE = class_names.loveda_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)


@DATASETS.register_module()
class COCODataset(CustomDataset):
    """(custom.py:512; reference coco.py:7): 81 COCO thing classes with
    the void class."""

    CLASSES = tuple(class_names.coco_classes())
    PALETTE = class_names.coco_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '.png')
        super().__init__(**kwargs)


@DATASETS.register_module()
class PotsdamDataset(CustomDataset):
    """(custom.py:526; reference potsdam.py): ISPRS Potsdam, 6 classes."""

    CLASSES = tuple(class_names.potsdam_classes())
    PALETTE = class_names.potsdam_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)


@DATASETS.register_module()
class ISPRSDataset(PotsdamDataset):
    """(custom.py:594; reference isprs.py): Vaihingen, Potsdam's 6
    classes and defaults."""


@DATASETS.register_module()
class iSAIDDataset(CustomDataset):
    """(custom.py:607; reference isaid.py): 16 classes (spelt otherwise
    than ``class_names.isaid_classes``, as in JAX), no palette."""

    CLASSES = ('background', 'ship', 'storage_tank', 'baseball_diamond',
               'tennis_court', 'basketball_court', 'ground_track_field',
               'bridge', 'large_vehicle', 'small_vehicle', 'helicopter',
               'swimming_pool', 'roundabout', 'soccer_ball_field', 'plane',
               'harbor')

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', '_instance_color_RGB.png')
        super().__init__(**kwargs)


@DATASETS.register_module()
class PascalContextDataset(CustomDataset):
    """(custom.py:622; reference pascal_context.py): 60 classes with the
    background."""

    CLASSES = PASCAL_CONTEXT_CLASSES
    PALETTE = PASCAL_CONTEXT_PALETTE

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', False)
        super().__init__(**kwargs)


@DATASETS.register_module()
class PascalContextDataset59(CustomDataset):
    """(custom.py:659): the 59 classes without the background, which
    ``reduce_zero_label`` ignores."""

    CLASSES = PASCAL_CONTEXT_CLASSES[1:]
    PALETTE = PASCAL_CONTEXT_PALETTE[1:]

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)


class _RetinalDataset(CustomDataset):
    """(custom.py:695; reference chase_db1.py, drive.py, hrf.py,
    stare.py): background and vessel; each set its label suffix."""

    CLASSES = ('background', 'vessel')
    PALETTE = [[120, 120, 120], [6, 230, 230]]
    SEG_SUFFIX = '.png'

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', self.SEG_SUFFIX)
        kwargs.setdefault('reduce_zero_label', False)
        super().__init__(**kwargs)


@DATASETS.register_module()
class ChaseDB1Dataset(_RetinalDataset):
    SEG_SUFFIX = '_1stHO.png'


@DATASETS.register_module()
class DRIVEDataset(_RetinalDataset):
    SEG_SUFFIX = '_manual1.png'


@DATASETS.register_module()
class HRFDataset(_RetinalDataset):
    SEG_SUFFIX = '.png'


@DATASETS.register_module()
class STAREDataset(_RetinalDataset):
    SEG_SUFFIX = '.ah.png'


@DATASETS.register_module()
class DarkZurichDataset(CityscapesDataset):
    """(custom.py:733; reference dark_zurich.py): Cityscapes' classes
    under Dark Zurich's file names, which overwrite any given."""

    def __init__(self, **kwargs):
        kwargs['img_suffix'] = '_rgb_anon.png'
        kwargs['seg_map_suffix'] = '_gt_labelTrainIds.png'
        super().__init__(**kwargs)


@DATASETS.register_module()
class NightDrivingDataset(CityscapesDataset):
    """(custom.py:743; reference night_driving.py): Cityscapes' classes
    under Nighttime Driving's file names, which overwrite any given."""

    def __init__(self, **kwargs):
        kwargs['img_suffix'] = '_leftImg8bit.png'
        kwargs['seg_map_suffix'] = '_gtCoarse_labelTrainIds.png'
        super().__init__(**kwargs)
