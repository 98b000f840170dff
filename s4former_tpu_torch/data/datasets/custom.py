"""Split-file-driven segmentation datasets (the port's copy of the VOC path
of ``s4former_tpu/data/datasets/custom.py``; reference:
mmseg/datasets/custom.py:32-512, voc.py:9, dataset_wrappers.py:165-305).

``CustomDataset``, ``PascalVOCDataset``, ``CityscapesDataset`` (its
submission format, ``format_results``/``results2img``), ``SemiDataset``,
``RepeatDataset`` and ``build_dataset``. Items are numpy dicts made by the
pipeline; the loader batches them. ADE20K, COCO-Stuff, the other datasets
and the concat wrappers are still to be ported.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from s4former_tpu_torch.core.class_names import (cityscapes_classes,
                                                 cityscapes_palette,
                                                 voc_classes, voc_palette)
from s4former_tpu_torch.core.metrics import (eval_metrics, intersect_and_union,
                                             pre_eval_to_metrics)
from s4former_tpu_torch.data.pipelines.transforms import Compose
from s4former_tpu_torch.registry import DATASETS


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

    CLASSES = tuple(voc_classes())
    PALETTE = voc_palette()

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.jpg')
        kwargs.setdefault('seg_map_suffix', '.png')
        super().__init__(**kwargs)


@DATASETS.register_module()
class CityscapesDataset(CustomDataset):
    """(custom.py:210; reference cityscapes.py:14): trainId label maps
    (``*_gtFine_labelTrainIds``); predictions are submitted as label-id
    PNGs."""

    CLASSES = tuple(cityscapes_classes())
    PALETTE = cityscapes_palette()
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
        'P' PNG of label ids (or trainIds) under the trainId palette
        (custom.py:243; reference cityscapes.py:49-93). Returns the
        paths."""
        if indices is None:
            indices = list(range(len(self)))
        os.makedirs(imgfile_prefix, exist_ok=True)
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

    def evaluate(self, results, metric='mIoU', **kwargs):
        metrics = [metric] if isinstance(metric, str) else list(metric)
        if 'cityscapes' in metrics:
            raise NotImplementedError(
                'not ported: the "cityscapes" metric (the official '
                'cityscapesscripts evaluator); use mIoU')
        return super().evaluate(results, metrics, **kwargs)


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


def build_dataset(cfg: dict):
    return DATASETS.build(dict(cfg))
