"""Pipeline transforms beyond the flagship's (counterpart of
``s4former_tpu/data/pipelines/extra_transforms.py``; reference:
mmseg/datasets/pipelines/transforms.py): RandErase, RandomGrayscale and
GaussianBlur (the strong views of UniMatch configs), RandomRotate,
RandomCropRareRemain, ResizeToMultiple, Rerange, RGB2Gray, AdjustGamma,
SegRescale, RandomCutOut and RandomMosaic (with ``MultiImageMixDataset``).
numpy host code like ``transforms.py``, with the same draws from
``results['rng']`` in the same order as the JAX package's, so a seed gives
the same output bit for bit. Refused with ``NotImplementedError``: CLAHE
(OpenCV).
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from s4former_tpu_torch.data.pipelines.transforms import _pil_resize, _rng
from s4former_tpu_torch.registry import PIPELINES


@PIPELINES.register_module()
class RandErase:
    """(transforms.py:707): erase n random boxes (fill with mean value)."""

    def __init__(self, prob: float = 0.5, n_patches: Tuple[int, int] = (1, 3),
                 ratio: Tuple[float, float] = (0.0, 0.2),
                 squared: bool = True):
        self.prob = prob
        self.n_patches = n_patches
        self.ratio = ratio
        self.squared = squared

    def __call__(self, results):
        rng = _rng(results)
        if float(rng.uniform()) >= self.prob:
            return results
        img = results['img'].copy()
        h, w = img.shape[:2]
        n = int(rng.integers(self.n_patches[0], self.n_patches[1] + 1))
        for _ in range(n):
            rh = float(rng.uniform(*self.ratio))
            rw = rh if self.squared else float(rng.uniform(*self.ratio))
            ph, pw = max(1, int(h * rh)), max(1, int(w * rw))
            y = int(rng.integers(0, max(h - ph, 1)))
            x = int(rng.integers(0, max(w - pw, 1)))
            img[y:y + ph, x:x + pw] = img.mean(axis=(0, 1))
        results['img'] = img
        return results


@PIPELINES.register_module()
class RandomGrayscale:
    """(transforms.py:1662)."""

    def __init__(self, prob: float = 0.2):
        self.prob = prob

    def __call__(self, results):
        rng = _rng(results)
        if float(rng.uniform()) < self.prob:
            img = results['img'].astype(np.float32)
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] +
                    0.114 * img[..., 2])
            results['img'] = np.stack([gray] * 3, -1).astype(
                results['img'].dtype)
        return results


@PIPELINES.register_module()
class GaussianBlur:
    """(transforms.py:1682): separable gaussian blur with random sigma."""

    def __init__(self, prob: float = 0.5,
                 sigma: Tuple[float, float] = (0.1, 2.0),
                 kernel_size: int = 5):
        self.prob = prob
        self.sigma = sigma
        self.kernel_size = kernel_size

    def __call__(self, results):
        rng = _rng(results)
        if float(rng.uniform()) >= self.prob:
            return results
        sigma = float(rng.uniform(*self.sigma))
        k = self.kernel_size
        xs = np.arange(k, dtype=np.float64) - (k - 1) / 2
        kern = np.exp(-xs ** 2 / (2 * sigma ** 2))
        kern /= kern.sum()
        img = results['img'].astype(np.float32)
        pad = k // 2
        padded = np.pad(img, ((pad, pad), (0, 0), (0, 0)), mode='reflect')
        img = sum(padded[i:i + img.shape[0]] * kern[i] for i in range(k))
        padded = np.pad(img, ((0, 0), (pad, pad), (0, 0)), mode='reflect')
        img = sum(padded[:, i:i + img.shape[1]] * kern[i] for i in range(k))
        results['img'] = np.clip(img, 0, 255).astype(results['img'].dtype)
        return results


@PIPELINES.register_module()
class RandomRotate:
    """(transforms.py RandomRotate): rotate image+seg by a random angle."""

    def __init__(self, prob: float = 0.5,
                 degree: Tuple[float, float] = (-10.0, 10.0),
                 pad_val: float = 0, seg_pad_val: int = 255):
        self.prob = prob
        self.degree = degree if isinstance(degree, (tuple, list)) \
            else (-degree, degree)
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def __call__(self, results):
        rng = _rng(results)
        if float(rng.uniform()) >= self.prob:
            return results
        angle = float(rng.uniform(*self.degree))
        img = Image.fromarray(results['img'].astype(np.uint8))
        results['img'] = np.asarray(
            img.rotate(angle, resample=Image.BILINEAR,
                       fillcolor=(int(self.pad_val),) * 3))
        for key in results.get('seg_fields', []):
            seg = Image.fromarray(results[key])
            results[key] = np.asarray(
                seg.rotate(angle, resample=Image.NEAREST,
                           fillcolor=self.seg_pad_val))
        return results


@PIPELINES.register_module()
class RandomMosaic:
    """(JAX extra_transforms.py:129; reference transforms.py:1378-1543):
    the sample and 3 more dataset items (``results['mix_results']``, handed
    in by ``MultiImageMixDataset``) pasted as a 2 x 2 mosaic of keep-ratio
    quadrants around a random centre. Without ``mix_results`` it raises,
    so a pipeline outside the wrapper fails instead of passing through."""

    QUADRANTS = ('top_left', 'top_right', 'bottom_left', 'bottom_right')

    def __init__(self, prob: float, img_scale=(640, 640),
                 center_ratio_range=(0.5, 1.5), pad_val=0, seg_pad_val=255):
        assert 0 <= prob <= 1
        self.prob = prob
        self.img_scale = tuple(img_scale)   # (h, w) of one quadrant
        self.center_ratio_range = center_ratio_range
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def get_indexes(self, dataset):
        """3 companion indices in [0, len(dataset)), from Python's
        ``random`` stream, as the JAX transform draws them (the
        reference's inclusive randint(0, len) can overrun; neither package
        keeps that)."""
        return [random.randint(0, len(dataset) - 1) for _ in range(3)]

    def _paste_crop(self, loc, center_xy, wh):
        """Where quadrant ``loc`` of size ``wh`` lands on the mosaic and
        the part of it that lands (reference transforms.py:1571-1634)."""
        cx, cy = center_xy
        w, h = wh
        W2, H2 = self.img_scale[1] * 2, self.img_scale[0] * 2
        if loc == 'top_left':
            x1, y1, x2, y2 = max(cx - w, 0), max(cy - h, 0), cx, cy
            crop = (w - (x2 - x1), h - (y2 - y1), w, h)
        elif loc == 'top_right':
            x1, y1, x2, y2 = cx, max(cy - h, 0), min(cx + w, W2), cy
            crop = (0, h - (y2 - y1), min(w, x2 - x1), h)
        elif loc == 'bottom_left':
            x1, y1, x2, y2 = max(cx - w, 0), cy, cx, min(H2, cy + h)
            crop = (w - (x2 - x1), 0, w, min(y2 - y1, h))
        else:
            x1, y1, x2, y2 = cx, cy, min(cx + w, W2), min(H2, cy + h)
            crop = (0, 0, min(w, x2 - x1), min(y2 - y1, h))
        return (x1, y1, x2, y2), crop

    def _mosaic(self, arrays, sizes, center, fill, nearest):
        hq, wq = self.img_scale
        out = np.full((hq * 2, wq * 2) + arrays[0].shape[2:], fill,
                      dtype=arrays[0].dtype)
        for arr, size, loc in zip(arrays, sizes, self.QUADRANTS):
            arr = _pil_resize(arr, size, nearest=nearest)
            (x1, y1, x2, y2), (xc1, yc1, xc2, yc2) = self._paste_crop(
                loc, center, size)
            out[y1:y2, x1:x2] = arr[yc1:yc2, xc1:xc2]
        return out

    def __call__(self, results):
        rng = _rng(results)
        if float(rng.uniform()) >= self.prob:
            return results
        if 'mix_results' not in results:
            raise KeyError(
                'RandomMosaic needs results["mix_results"]: wrap the '
                'dataset in MultiImageMixDataset (reference '
                'dataset_wrappers.py:195)')
        hq, wq = self.img_scale
        center = (int(rng.uniform(*self.center_ratio_range) * wq),
                  int(rng.uniform(*self.center_ratio_range) * hq))
        patches = [results] + list(results['mix_results'])
        sizes = []
        for patch in patches:
            h_i, w_i = patch['img'].shape[:2]
            s = min(hq / h_i, wq / w_i)   # keep-ratio fit into a quadrant
            sizes.append((int(w_i * s), int(h_i * s)))
        img = self._mosaic([p['img'] for p in patches], sizes, center,
                           self.pad_val, False)
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        for key in results.get('seg_fields', []):
            results[key] = self._mosaic([p[key] for p in patches], sizes,
                                        center, self.seg_pad_val, True)
        return results


@PIPELINES.register_module()
class RandomCropRareRemain:
    """(transforms.py:876-957): RandomCrop whose accept test tries to KEEP
    rare classes. If the full label map contains any of the (hardcoded
    Cityscapes) rare class ids, retry up to 15 crops until the crop holds
    more than half of the image's rare classes AND passes cat_max_ratio;
    otherwise fall back to the plain 10-retry cat_max_ratio loop."""

    RARE_CLASSES = np.array([16, 15, 14, 17, 3, 12, 4, 6, 9])

    def __init__(self, crop_size, cat_max_ratio: float = 1.0,
                 ignore_index: int = 255):
        assert crop_size[0] > 0 and crop_size[1] > 0
        self.crop_size = tuple(crop_size)
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def _bbox(self, rng, shape):
        mh = max(shape[0] - self.crop_size[0], 0)
        mw = max(shape[1] - self.crop_size[1], 0)
        y = int(rng.integers(0, mh + 1))
        x = int(rng.integers(0, mw + 1))
        return y, y + self.crop_size[0], x, x + self.crop_size[1]

    @staticmethod
    def _crop(arr, bbox):
        y1, y2, x1, x2 = bbox
        return arr[y1:y2, x1:x2, ...]

    def __call__(self, results):
        rng = _rng(results)
        img = results['img']
        seg = results['gt_semantic_seg']
        bbox = self._bbox(rng, img.shape)
        if self.cat_max_ratio < 1.0:
            img_rare = np.intersect1d(np.unique(seg), self.RARE_CLASSES)
            if len(img_rare) > 0:
                for _ in range(15):
                    tmp = self._crop(seg, bbox)
                    labels, cnt = np.unique(tmp, return_counts=True)
                    cnt = cnt[labels != self.ignore_index]
                    crop_rare = np.intersect1d(labels, self.RARE_CLASSES)
                    if len(crop_rare) > 0.5 * len(img_rare) and \
                            len(cnt) > 1 and \
                            np.max(cnt) / np.sum(cnt) < self.cat_max_ratio:
                        break
                    bbox = self._bbox(rng, img.shape)
            else:
                for _ in range(10):
                    tmp = self._crop(seg, bbox)
                    labels, cnt = np.unique(tmp, return_counts=True)
                    cnt = cnt[labels != self.ignore_index]
                    if len(cnt) > 1 and \
                            np.max(cnt) / np.sum(cnt) < self.cat_max_ratio:
                        break
                    bbox = self._bbox(rng, img.shape)
        img = self._crop(img, bbox)
        results['img'] = img
        results['img_shape'] = img.shape
        for key in results.get('seg_fields', []):
            results[key] = self._crop(results[key], bbox)
        return results


@PIPELINES.register_module()
class ResizeToMultiple:
    """(transforms.py:114): resize img (bilinear) and seg maps (nearest)
    up to the next multiple of ``size_divisor`` (mmcv.imresize_to_multiple
    with scale_factor=1: ceil-divide each side)."""

    def __init__(self, size_divisor: int = 32,
                 interpolation: Optional[str] = None):
        self.size_divisor = size_divisor
        self.interpolation = interpolation

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        d = self.size_divisor
        nh, nw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
        if (nh, nw) != (h, w):
            img = _pil_resize(img, (nw, nh),
                              nearest=self.interpolation == 'nearest')
        results['img'] = img
        results['img_shape'] = img.shape
        results['pad_shape'] = img.shape
        for key in results.get('seg_fields', []):
            results[key] = _pil_resize(results[key], (nw, nh), nearest=True)
        return results


@PIPELINES.register_module()
class Rerange:
    """(transforms.py:615): min-max rescale pixel values to
    [min_value, max_value] (float output, like the reference)."""

    def __init__(self, min_value=0, max_value=255):
        assert min_value < max_value
        self.min_value = min_value
        self.max_value = max_value

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        lo, hi = float(img.min()), float(img.max())
        assert lo < hi, 'Rerange needs a non-constant image'
        img = (img - lo) / (hi - lo)
        results['img'] = img * (self.max_value - self.min_value) \
            + self.min_value
        return results


@PIPELINES.register_module()
class CLAHE:
    """(transforms.py:661) is ``cv2.createCLAHE``; the port does not
    depend on OpenCV, so it is refused (ROADMAP Queue 1, "CLAHE without
    OpenCV")."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'not ported: CLAHE needs OpenCV (cv2), which the port does not '
            'depend on (ROADMAP Queue 1, "CLAHE without OpenCV")')


@PIPELINES.register_module()
class RGB2Gray:
    """(transforms.py:1043): weighted-mean grayscale, channels repeated
    to ``out_channels`` (or back to len(weights) when None)."""

    def __init__(self, out_channels: Optional[int] = None,
                 weights: Tuple[float, ...] = (0.299, 0.587, 0.114)):
        assert out_channels is None or out_channels > 0
        self.out_channels = out_channels
        self.weights = tuple(weights)

    def __call__(self, results):
        img = results['img']
        assert img.ndim == 3 and img.shape[2] == len(self.weights)
        w = np.asarray(self.weights).reshape(1, 1, -1)
        gray = (img * w).sum(2, keepdims=True)
        reps = self.out_channels or len(self.weights)
        results['img'] = gray.repeat(reps, axis=2)
        results['img_shape'] = results['img'].shape
        return results


@PIPELINES.register_module()
class AdjustGamma:
    """(transforms.py:1099): uint8 LUT gamma correction; the table uses
    the reference's truncating uint8 cast."""

    def __init__(self, gamma: float = 1.0):
        assert gamma > 0
        self.gamma = gamma
        inv = 1.0 / gamma
        self.table = np.array([(i / 255.0) ** inv * 255
                               for i in np.arange(256)]).astype('uint8')

    def __call__(self, results):
        img = np.asarray(results['img'], dtype=np.uint8)
        results['img'] = self.table[img]
        return results


@PIPELINES.register_module()
class SegRescale:
    """(transforms.py:1135): rescale seg maps by ``scale_factor`` with
    nearest interpolation (mmcv.imrescale size rounding: int(d*f + 0.5))."""

    def __init__(self, scale_factor: float = 1):
        self.scale_factor = scale_factor

    def __call__(self, results):
        if self.scale_factor != 1:
            for key in results.get('seg_fields', []):
                h, w = results[key].shape[:2]
                nw = int(w * self.scale_factor + 0.5)
                nh = int(h * self.scale_factor + 0.5)
                results[key] = _pil_resize(results[key], (nw, nh),
                                           nearest=True)
        return results


@PIPELINES.register_module()
class RandomCutOut:
    """(transforms.py:1286): drop n random boxes; top-left sampled over
    the FULL image so boxes clip at the border (reference semantics),
    fill img with ``fill_in`` and optionally segs with ``seg_fill_in``."""

    def __init__(self, prob: float, n_holes, cutout_shape=None,
                 cutout_ratio=None, fill_in=(0, 0, 0),
                 seg_fill_in: Optional[int] = None):
        assert 0 <= prob <= 1
        assert (cutout_shape is None) ^ (cutout_ratio is None), \
            'Either cutout_shape or cutout_ratio should be specified.'
        if isinstance(n_holes, tuple):
            assert len(n_holes) == 2 and 0 <= n_holes[0] < n_holes[1]
        else:
            n_holes = (n_holes, n_holes)
        self.prob = prob
        self.n_holes = n_holes
        self.fill_in = fill_in
        self.seg_fill_in = seg_fill_in
        self.with_ratio = cutout_ratio is not None
        cand = cutout_ratio if self.with_ratio else cutout_shape
        self.candidates = cand if isinstance(cand, list) else [cand]

    def __call__(self, results):
        rng = _rng(results)
        if float(rng.uniform()) >= self.prob:
            return results
        img = results['img'].copy()
        h, w = img.shape[:2]
        segs = {k: results[k].copy() for k in results.get('seg_fields', [])} \
            if self.seg_fill_in is not None else {}
        n = int(rng.integers(self.n_holes[0], self.n_holes[1] + 1))
        for _ in range(n):
            x1 = int(rng.integers(0, w))
            y1 = int(rng.integers(0, h))
            idx = int(rng.integers(0, len(self.candidates)))
            if not self.with_ratio:
                cw, ch = self.candidates[idx]
            else:
                cw = int(self.candidates[idx][0] * w)
                ch = int(self.candidates[idx][1] * h)
            x2, y2 = min(x1 + cw, w), min(y1 + ch, h)
            img[y1:y2, x1:x2, :] = self.fill_in
            for k in segs:
                segs[k][y1:y2, x1:x2] = self.seg_fill_in
        results['img'] = img
        results.update(segs)
        return results
