"""Class name and palette tables (the port's copy of the VOC part of
``s4former_tpu/core/class_names.py``; reference:
mmseg/core/evaluation/class_names.py). The other datasets' tables come
with their datasets."""
from __future__ import annotations

from typing import List


def voc_classes() -> List[str]:
    return ['background', 'aeroplane', 'bicycle', 'bird', 'boat', 'bottle',
            'bus', 'car', 'cat', 'chair', 'cow', 'diningtable', 'dog',
            'horse', 'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
            'train', 'tvmonitor']


def voc_palette() -> List[List[int]]:
    return [[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0],
            [0, 0, 128], [128, 0, 128], [0, 128, 128], [128, 128, 128],
            [64, 0, 0], [192, 0, 0], [64, 128, 0], [192, 128, 0],
            [64, 0, 128], [192, 0, 128], [64, 128, 128], [192, 128, 128],
            [0, 64, 0], [128, 64, 0], [0, 192, 0], [128, 192, 0],
            [0, 64, 128]]
