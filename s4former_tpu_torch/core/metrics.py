"""Evaluation metrics: IoU / Dice / Fscore from confusion histograms
(counterpart of ``s4former_tpu/core/metrics.py``; reference:
mmseg/core/evaluation/metrics.py:26-342).

``intersect_and_union`` takes tensors (or arrays) and counts with
``torch.bincount`` on their device; ignored pixels go to an overflow bucket,
as in the JAX version. The rest are the numpy entry points that
``dataset.evaluate`` uses.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def intersect_and_union(pred, label, num_classes: int,
                        ignore_index: int = 255
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-image histograms (metrics.py:26-83). ``pred``, ``label``: int
    tensors or arrays of one shape. Returns (intersect, union, pred_area,
    label_area), each a float32 [num_classes] tensor on pred's device."""
    def tensor(x):
        # a copy of arrays (PIL's are read-only, which torch warns about)
        return x if isinstance(x, Tensor) else torch.from_numpy(np.array(x))
    pred = tensor(pred)
    label = tensor(label).to(pred.device)
    mask = label != ignore_index
    overflow = torch.full_like(label, num_classes, dtype=torch.int64)
    pred = torch.where(mask, pred.to(torch.int64), overflow).reshape(-1)
    label = torch.where(mask, label.to(torch.int64), overflow).reshape(-1)

    def hist(x):
        return torch.bincount(x, minlength=num_classes + 1)[
            :num_classes].to(torch.float32)

    inter = hist(torch.where(pred == label, pred, overflow.reshape(-1)))
    area_pred = hist(pred)
    area_label = hist(label)
    return inter, area_pred + area_label - inter, area_pred, area_label


def total_intersect_and_union(preds, labels, num_classes: int,
                              ignore_index: int = 255):
    """Sums over a batch (metrics.py:89-130). preds/labels: [B, H, W]."""
    totals = [intersect_and_union(p, l, num_classes, ignore_index)
              for p, l in zip(preds, labels)]
    return tuple(torch.stack(t).sum(0) for t in zip(*totals))


def _metrics_from_totals(total_inter: np.ndarray, total_union: np.ndarray,
                         total_pred: np.ndarray, total_label: np.ndarray,
                         metrics: Sequence[str] = ('mIoU',),
                         beta: float = 1.0,
                         nan_to_num: Optional[float] = None
                         ) -> Dict[str, np.ndarray]:
    """(metrics.py:256-342): per-class tables + aAcc."""
    allowed = {'mIoU', 'mDice', 'mFscore'}
    if not set(metrics).issubset(allowed):
        raise KeyError(f'metrics {metrics} not in {allowed}')
    out: Dict[str, np.ndarray] = {}
    with np.errstate(divide='ignore', invalid='ignore'):
        out['aAcc'] = np.array(total_inter.sum() /
                               max(total_label.sum(), 1e-12))
        acc = total_inter / total_label
        if 'mIoU' in metrics:
            out['IoU'] = total_inter / total_union
            out['Acc'] = acc
        if 'mDice' in metrics:
            out['Dice'] = 2 * total_inter / (total_pred + total_label)
            out['Acc'] = acc
        if 'mFscore' in metrics:
            precision = total_inter / total_pred
            recall = total_inter / total_label
            out['Fscore'] = ((1 + beta ** 2) * precision * recall /
                             (beta ** 2 * precision + recall))
            out['Precision'] = precision
            out['Recall'] = recall
    if nan_to_num is not None:
        out = {k: np.nan_to_num(v, nan=nan_to_num) for k, v in out.items()}
    return out


def eval_metrics(results, gt_seg_maps, num_classes: int,
                 ignore_index: int = 255,
                 metrics: Sequence[str] = ('mIoU',),
                 nan_to_num: Optional[float] = None,
                 beta: float = 1.0) -> Dict[str, np.ndarray]:
    """Over lists of per-image arrays (metrics.py:256-295)."""
    totals = [np.zeros(num_classes) for _ in range(4)]
    for pred, label in zip(results, gt_seg_maps):
        for total, x in zip(totals, intersect_and_union(
                np.asarray(pred), np.asarray(label), num_classes,
                ignore_index)):
            total += x.cpu().numpy()
    return _metrics_from_totals(*totals, metrics, beta, nan_to_num)


def pre_eval_to_metrics(pre_eval_results,
                        metrics: Sequence[str] = ('mIoU',),
                        nan_to_num: Optional[float] = None,
                        beta: float = 1.0) -> Dict[str, np.ndarray]:
    """Streaming-eval aggregation (metrics.py:296-342): a list of
    (intersect, union, pred_area, label_area) tuples."""
    stacked = tuple(np.sum(np.stack([np.asarray(x[i]) for x in
                                     pre_eval_results]), axis=0)
                    for i in range(4))
    return _metrics_from_totals(*stacked, metrics=metrics, beta=beta,
                                nan_to_num=nan_to_num)


def mean_iou(results, gt_seg_maps, num_classes, ignore_index=255,
             nan_to_num=None):
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        ('mIoU',), nan_to_num)
