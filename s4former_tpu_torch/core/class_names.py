"""Class name and palette tables (the port's copy of the VOC and
Cityscapes parts of ``s4former_tpu/core/class_names.py``; reference:
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


def cityscapes_classes() -> List[str]:
    return ['road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
            'traffic light', 'traffic sign', 'vegetation', 'terrain',
            'sky', 'person', 'rider', 'car', 'truck', 'bus', 'train',
            'motorcycle', 'bicycle']


def cityscapes_palette() -> List[List[int]]:
    return [[128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
            [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
            [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
            [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
            [0, 80, 100], [0, 0, 230], [119, 11, 32]]


_REGISTRY = {
    'voc': (voc_classes, voc_palette),
    'pascal_voc': (voc_classes, voc_palette),
    'cityscapes': (cityscapes_classes, cityscapes_palette),
}


def get_classes(dataset: str) -> List[str]:
    key = dataset.lower()
    if key not in _REGISTRY:
        raise KeyError(f'unknown dataset {dataset}; '
                       f'known: {sorted(_REGISTRY)}')
    return _REGISTRY[key][0]()


def get_palette(dataset: str) -> List[List[int]]:
    """The dataset's palette (JAX class_names.py:300)."""
    key = dataset.lower()
    if key not in _REGISTRY:
        raise KeyError(f'unknown dataset {dataset}; '
                       f'known: {sorted(_REGISTRY)}')
    return _REGISTRY[key][1]()
