"""Host-side (numpy) data pipeline transforms (the port's copy of
``s4former_tpu/data/pipelines/transforms.py``; reference:
mmseg/datasets/pipelines/transforms.py, pipeline layout in
configs/setr/..._MT_w_ours.py).

Compose / LoadImageFromFile / LoadAnnotations / Resize (4 multiscale modes)
/ RandomCrop (cat_max_ratio) / RandomFlip / PhotoMetricDistortion /
Normalize / Pad / ExtraAttrs / DefaultFormatBundle / ImageToTensor /
Collect / MultiBranch / MultiScaleFlipAug. They run on the host in loader
threads; the device-side strong mixes (CutMix, PatchShuffle) are in
``semi/mixes.py``. Images flow as uint8/float32 RGB HWC numpy arrays and
each transform mutates a ``results`` dict.

Randomness: each transform draws from ``results['rng']``, a
``np.random.Generator``, in the JAX package's order, so a seeded sample is
the same array in both packages.

Decode, resize, PhotoMetricDistortion's brightness, contrast, saturation
and hue, and Normalize run in the port's native host library
(``s4former_tpu_torch/native``), as the JAX package's do in its
``s4former_tpu/native``: C++ called through ``ctypes``, which releases the
interpreter lock, so the loader's threads neither wait for each other nor
hold up the thread that dispatches the training step. Their plain versions
(``read_rgb_plain``, ``read_label_plain``, ``resize_plain``,
``convert_plain``, ``saturate_plain``, ``hue_plain``, ``normalize_plain``:
PIL and numpy) are what the native ones are held to, bit for bit; the
pipelines do not call them. Two cases stay on PIL: decoding where the
library was built without ``jpeglib.h``/``png.h`` (``native.HAS_DECODE``
is False) or a file that is neither JPEG nor PNG, and a nearest resize of
a non-uint8 array.
"""
from __future__ import annotations

import copy
import types
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from s4former_tpu_torch import native
from s4former_tpu_torch.registry import PIPELINES


def _rng(results) -> np.random.Generator:
    r = results.get('rng')
    if r is None:
        r = np.random.default_rng()
        results['rng'] = r
    return r


def read_rgb_plain(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 [h, w, 3] with PIL."""
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def read_label_plain(path: str) -> np.ndarray:
    """Decode a label map to uint8 [h, w] with PIL: raw palette indices for
    'P' PNGs, the first channel otherwise (reference loading.py:104)."""
    with Image.open(path) as im:
        seg = np.asarray(im).astype(np.uint8)
    if seg.ndim == 3:
        seg = seg[..., 0]
    return seg


def resize_plain(img: np.ndarray, size_wh: Tuple[int, int],
                 nearest: bool = False) -> np.ndarray:
    """PIL resize to (w, h): nearest keeps the dtype; bilinear runs on the
    uint8 image and casts back to the input dtype."""
    if nearest:
        return np.asarray(Image.fromarray(img).resize(size_wh, Image.NEAREST))
    pil = Image.fromarray(img if img.dtype == np.uint8
                          else img.astype(np.uint8))
    return np.asarray(pil.resize(size_wh, Image.BILINEAR)).astype(img.dtype)


def _read(path: str, label: bool) -> np.ndarray:
    if native.HAS_DECODE:
        with open(path, 'rb') as f:
            data = f.read()
        if native.decodable(data):
            return native.decode_label(data) if label else \
                native.decode_rgb(data)
    return read_label_plain(path) if label else read_rgb_plain(path)


def _read_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 [h, w, 3] (JAX transforms.py:
    40-52)."""
    return _read(path, label=False)


def _read_label(path: str) -> np.ndarray:
    """Decode a label map to uint8 [h, w] (JAX transforms.py:55-68)."""
    return _read(path, label=True)


def _pil_resize(img: np.ndarray, size_wh: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """PIL-semantics resize to (w, h) (JAX transforms.py:71-87): bilinear
    on the uint8 image, cast back to the input dtype."""
    if nearest and img.dtype != np.uint8:
        return resize_plain(img, size_wh, nearest=True)
    return native.resize_u8(img.astype(np.uint8, copy=False), size_wh,
                            nearest).astype(img.dtype, copy=False)


@PIPELINES.register_module()
class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [t if callable(t) else PIPELINES.build(dict(t))
                           for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register_module()
class LoadImageFromFile:
    """(loading.py:24-49): read the image, record its shape metas.
    ``color_type``: 'color' (RGB), 'grayscale' (2-D uint8) or 'unchanged'.
    ``imdecode_backend`` is accepted for config parity; decoding is the
    native library's (``_read_rgb``)."""

    def __init__(self, to_float32: bool = False, color_type: str = 'color',
                 imdecode_backend: str = 'cv2', **kwargs):
        if color_type not in ('color', 'grayscale', 'unchanged'):
            raise ValueError(f'color_type {color_type!r}')
        self.to_float32 = to_float32
        self.color_type = color_type

    def __call__(self, results):
        path = results['img_info']['filename']
        if self.color_type == 'color':
            img = _read_rgb(path)
        else:
            with Image.open(path) as im:
                img = np.asarray(im.convert('L')
                                 if self.color_type == 'grayscale' else im)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = path
        results['ori_filename'] = results['img_info'].get(
            'ori_filename', path)
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = 1.0
        results['img_norm_cfg'] = dict(
            mean=np.zeros(3, np.float32), std=np.ones(3, np.float32),
            to_rgb=True)
        results.setdefault('seg_fields', [])
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """(loading.py:104): read the label PNG (palette index map)."""

    def __init__(self, reduce_zero_label: bool = False, **kwargs):
        self.reduce_zero_label = reduce_zero_label

    def __call__(self, results):
        seg = _read_label(results['ann_info']['seg_map'])
        if self.reduce_zero_label:
            seg = seg.astype(np.int32)
            seg[seg == 0] = 256
            seg = seg - 1
            seg[seg == 255] = 255
            seg = seg.astype(np.uint8)
        if 'label_map' in results:
            seg_out = seg.copy()
            for old_id, new_id in results['label_map'].items():
                seg_out[seg == old_id] = new_id
            seg = seg_out
        results['gt_semantic_seg'] = seg
        results['seg_fields'] = list(
            set(results.get('seg_fields', []) + ['gt_semantic_seg']))
        return results


@PIPELINES.register_module()
class Resize:
    """mmseg Resize (transforms.py:171-345), all 4 multiscale modes:
    1. ``ratio_range``, no ``img_scale``: ratio x original size;
    2. ``ratio_range`` + one ``img_scale``: ratio x img_scale;
    3. ``multiscale_mode='range'`` + 2 scales: long and short edges each
       uniform between the scales' bounds (``random_sample``, :260-284);
    4. ``multiscale_mode='value'`` + scales: one picked uniformly
       (``random_select``, :241-258).
    """

    def __init__(self, img_scale=None, ratio_range=None, keep_ratio=True,
                 multiscale_mode='range', min_size=None):
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list) and img_scale and \
                isinstance(img_scale[0], (list, tuple)):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        # reference constructor contract (:216-235)
        if ratio_range is not None:
            if self.img_scale is not None and len(self.img_scale) != 1:
                raise ValueError('ratio_range takes a single img_scale')
        elif multiscale_mode not in ('value', 'range'):
            raise ValueError(f'multiscale_mode {multiscale_mode!r}')
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.min_size = min_size

    def _pick_scale(self, results) -> Tuple[int, int]:
        rng = _rng(results)
        if self.ratio_range is not None:
            lo, hi = self.ratio_range
            r = float(rng.uniform(lo, hi))
            base = (self.img_scale[0] if self.img_scale
                    else results['img'].shape[:2][::-1])
            results['scale_idx'] = None
            return (int(base[0] * r), int(base[1] * r))
        if self.img_scale is None:
            results['scale_idx'] = 0
            return results['img'].shape[1], results['img'].shape[0]
        if len(self.img_scale) == 1:
            results['scale_idx'] = 0
            return self.img_scale[0]
        if self.multiscale_mode == 'range':
            if len(self.img_scale) != 2:
                raise ValueError(f'range mode takes 2 scales: '
                                 f'{self.img_scale}')
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_edge = int(rng.integers(min(longs), max(longs) + 1))
            short_edge = int(rng.integers(min(shorts), max(shorts) + 1))
            results['scale_idx'] = None
            return (long_edge, short_edge)
        idx = int(rng.integers(0, len(self.img_scale)))
        results['scale_idx'] = idx
        return self.img_scale[idx]

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        scale = results.get('scale') or self._pick_scale(results)
        if self.keep_ratio:
            max_long, max_short = max(scale), min(scale)
            f = min(max_long / max(h, w), max_short / min(h, w))
            new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
        else:
            new_w, new_h = scale
        if self.min_size is not None:
            fmin = max(self.min_size / new_w, self.min_size / new_h, 1.0)
            new_w, new_h = int(new_w * fmin + 0.5), int(new_h * fmin + 0.5)
        results['img'] = _pil_resize(img, (new_w, new_h))
        results['img_shape'] = results['img'].shape
        results['pad_shape'] = results['img'].shape
        results['scale_factor'] = np.array(
            [new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
        results['keep_ratio'] = self.keep_ratio
        for key in results.get('seg_fields', []):
            results[key] = _pil_resize(results[key], (new_w, new_h),
                                       nearest=True)
        return results


@PIPELINES.register_module()
class RandomCrop:
    """(transforms.py:802): random crop with cat_max_ratio retries."""

    def __init__(self, crop_size, cat_max_ratio: float = 1.0,
                 ignore_index: int = 255):
        self.crop_size = tuple(crop_size)
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def _crop_bbox(self, results):
        rng = _rng(results)
        h, w = results['img'].shape[:2]
        mh = max(h - self.crop_size[0], 0)
        mw = max(w - self.crop_size[1], 0)
        y = int(rng.integers(0, mh + 1))
        x = int(rng.integers(0, mw + 1))
        return y, y + self.crop_size[0], x, x + self.crop_size[1]

    def __call__(self, results):
        bbox = self._crop_bbox(results)
        if self.cat_max_ratio < 1.0 and 'gt_semantic_seg' in results:
            for _ in range(10):
                seg = results['gt_semantic_seg'][bbox[0]:bbox[1],
                                                 bbox[2]:bbox[3]]
                labels, cnt = np.unique(seg, return_counts=True)
                cnt = cnt[labels != self.ignore_index]
                if len(cnt) > 1 and cnt.max() / cnt.sum() < \
                        self.cat_max_ratio:
                    break
                bbox = self._crop_bbox(results)
        y1, y2, x1, x2 = bbox
        results['img'] = results['img'][y1:y2, x1:x2]
        results['img_shape'] = results['img'].shape
        for key in results.get('seg_fields', []):
            results[key] = results[key][y1:y2, x1:x2]
        return results


@PIPELINES.register_module()
class RandomFlip:
    """(transforms.py:429): flip with probability ``prob``."""

    def __init__(self, prob: Optional[float] = None,
                 flip_ratio: Optional[float] = None,
                 direction: str = 'horizontal'):
        self.prob = prob if prob is not None else flip_ratio
        self.direction = direction

    def __call__(self, results):
        if 'flip' not in results:
            rng = _rng(results)
            results['flip'] = (self.prob is not None and
                               float(rng.uniform()) < self.prob)
            results['flip_direction'] = self.direction
        if results['flip']:
            axis = 1 if results['flip_direction'] == 'horizontal' else 0
            results['img'] = np.flip(results['img'], axis=axis).copy()
            for key in results.get('seg_fields', []):
                results[key] = np.flip(results[key], axis=axis).copy()
        return results


def _rgb_to_hsv_cv(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> cv2-style HSV (H in [0,180), S/V in [0,255])."""
    arr = img.astype(np.float32) / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    mx = arr.max(-1)
    mn = arr.min(-1)
    diff = mx - mn
    h = np.zeros_like(mx)
    mask = diff > 0
    rm = mask & (mx == r)
    gm = mask & (mx == g) & ~rm
    bm = mask & ~rm & ~gm
    safe = np.where(diff == 0, 1, diff)
    h[rm] = (60 * (g - b) / safe)[rm] % 360
    h[gm] = (60 * (b - r) / safe + 120)[gm]
    h[bm] = (60 * (r - g) / safe + 240)[bm]
    s = np.where(mx > 0, diff / np.where(mx == 0, 1, mx), 0)
    hh = np.round(h / 2.0).astype(np.int32) % 180
    ss = np.clip(np.round(s * 255.0), 0, 255).astype(np.int32)
    vv = np.clip(np.round(mx * 255.0), 0, 255).astype(np.int32)
    return np.stack([hh, ss, vv], axis=-1).astype(np.uint8)


def _hsv_to_rgb_cv(img: np.ndarray) -> np.ndarray:
    h = img[..., 0].astype(np.float32) * 2.0
    s = img[..., 1].astype(np.float32) / 255.0
    v = img[..., 2].astype(np.float32) / 255.0
    c = v * s
    hp = h / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    idx = (np.floor(hp).astype(np.int32) % 6)[..., None]
    rgb = np.select(
        [idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
        [np.stack([c, x, z], -1), np.stack([x, c, z], -1),
         np.stack([z, c, x], -1), np.stack([z, x, c], -1),
         np.stack([x, z, c], -1), np.stack([c, z, x], -1)])
    m = (v - c)[..., None]
    return np.clip(np.round((rgb + m) * 255.0), 0, 255).astype(np.uint8)


def convert_plain(img, alpha=1.0, beta=0.0):
    """clip(img * alpha + beta, 0, 255) truncated to uint8, in numpy."""
    out = img.astype(np.float32) * alpha + beta
    return np.clip(out, 0, 255).astype(np.uint8)


def saturate_plain(img, alpha):
    """HSV saturation scaled by ``alpha``, in numpy (cv2's HSV)."""
    hsv = _rgb_to_hsv_cv(img)
    hsv[..., 1] = convert_plain(hsv[..., 1], alpha=alpha)
    return _hsv_to_rgb_cv(hsv)


def hue_plain(img, dh):
    """HSV hue shifted by ``dh`` (mod 180), in numpy."""
    hsv = _rgb_to_hsv_cv(img)
    hsv[..., 0] = (hsv[..., 0].astype(int) + dh) % 180
    return _hsv_to_rgb_cv(hsv)


def normalize_plain(img, mean, std):
    """(img - mean) / std in float32, in numpy."""
    return (img.astype(np.float32) - mean) / std


# the plain versions in the shape of the ``native`` module: tests and
# chip_smoke.py put it in the place of ``native`` to run the pipelines on
# PIL and numpy, which they hold the native runs to
PLAIN_HOST = types.SimpleNamespace(
    HAS_DECODE=False, decodable=native.decodable, resize_u8=resize_plain,
    convert_u8=convert_plain, saturation_u8=saturate_plain,
    hue_u8=hue_plain, normalize_f32=normalize_plain)


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """(transforms.py:1165): brightness, contrast, saturation and hue
    jitter, each with probability 1/``rand_colorjitter_prob``, contrast
    first or last at random."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18,
                 rand_colorjitter_prob=2):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta
        self.p = rand_colorjitter_prob

    # the native library's (JAX transforms.py:394-415)
    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        return native.convert_u8(img, alpha, beta)

    @staticmethod
    def _saturate(img, alpha):
        return native.saturation_u8(img, alpha)

    @staticmethod
    def _hue(img, dh):
        return native.hue_u8(img, dh)

    def __call__(self, results):
        rng = _rng(results)
        img = results['img'].astype(np.uint8)

        def coin():
            return bool(1 - int(rng.integers(0, self.p)))

        if coin():
            img = self._convert(
                img, beta=float(rng.uniform(-self.brightness_delta,
                                            self.brightness_delta)))
        mode = int(rng.integers(0, 2))

        def contrast(im):
            if coin():
                return self._convert(
                    im, alpha=float(rng.uniform(self.contrast_lower,
                                                self.contrast_upper)))
            return im

        if mode == 1:
            img = contrast(img)
        if coin():
            img = self._saturate(
                img, float(rng.uniform(self.saturation_lower,
                                       self.saturation_upper)))
        if coin():
            img = self._hue(img, int(rng.integers(-self.hue_delta,
                                                  self.hue_delta + 1)))
        if mode == 0:
            img = contrast(img)
        results['img'] = img
        return results


@PIPELINES.register_module()
class Normalize:
    """(transforms.py:572): (img - mean) / std in RGB. Images load as RGB,
    so ``to_rgb=True`` is the identity; ``to_rgb=False`` flips channels."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img']
        if not self.to_rgb:
            img = img[..., ::-1]
        if img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3:
            # the native library's (JAX transforms.py:475)
            results['img'] = native.normalize_f32(img, self.mean, self.std)
        else:
            results['img'] = normalize_plain(img, self.mean, self.std)
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    """(transforms.py:484): pad bottom/right to a size or a divisor; labels
    pad with ``seg_pad_val``."""

    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 seg_pad_val=255):
        self.size = tuple(size) if size else None
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    def _target(self, h, w):
        if self.size is not None:
            return max(self.size[0], h), max(self.size[1], w)
        d = self.size_divisor
        return ((h + d - 1) // d * d, (w + d - 1) // d * d)

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        th, tw = self._target(h, w)
        if (th, tw) != (h, w):
            results['img'] = np.pad(
                img, ((0, th - h), (0, tw - w), (0, 0)),
                constant_values=self.pad_val)
            for key in results.get('seg_fields', []):
                results[key] = np.pad(
                    results[key], ((0, th - h), (0, tw - w)),
                    constant_values=self.seg_pad_val)
        results['pad_shape'] = results['img'].shape
        return results


@PIPELINES.register_module()
class ExtraAttrs:
    """(transforms.py:1645): inject attributes, used for ``tag``."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def __call__(self, results):
        for k, v in self.attrs.items():
            if k in results:
                raise KeyError(f'{k!r} is already in the results')
            results[k] = v
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """(formatting.py:191): batches stay numpy until the loader stacks them,
    so this is a no-op kept for the reference pipelines."""

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """No-op, as DefaultFormatBundle."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect:
    """(formatting.py:232): keep the data keys, pack the metas."""

    DEFAULT_META_KEYS = ('filename', 'ori_filename', 'ori_shape',
                         'img_shape', 'pad_shape', 'scale_factor', 'flip',
                         'flip_direction', 'img_norm_cfg')

    def __init__(self, keys, meta_keys=DEFAULT_META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        out = {'img_metas': {k: results[k] for k in self.meta_keys
                             if k in results}}
        for k in self.keys:
            out[k] = results[k]
        if 'tag' in results:
            out['tag'] = results['tag']
        return out


@PIPELINES.register_module()
class MultiBranch:
    """(compose.py:70-83): run each sub-pipeline on a deep copy of one
    sample; returns the list of results (the loader groups them by tag)."""

    def __init__(self, **branch_pipelines):
        self.branch_pipelines = {
            name: Compose(p) for name, p in branch_pipelines.items()}

    def __call__(self, results):
        out = []
        for pipeline in self.branch_pipelines.values():
            res = pipeline(copy.deepcopy(results))
            if res is None:
                return None
            out.append(res)
        return out


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """(test_time_aug.py:11): one result per (scale, flip) combination."""

    def __init__(self, transforms, img_scale=None, img_ratios=None,
                 flip=False, flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        img_scale = img_scale if isinstance(img_scale, list) else [img_scale]
        self.img_scale = [tuple(s) if s else None for s in img_scale]
        self.img_ratios = img_ratios if isinstance(img_ratios, list) else \
            ([img_ratios] if img_ratios else None)
        self.flip = flip
        self.flip_direction = flip_direction if isinstance(
            flip_direction, list) else [flip_direction]

    def __call__(self, results):
        outs = []
        if self.img_ratios:
            h, w = results['img'].shape[:2]
            scales = [(int(w * r), int(h * r)) for r in self.img_ratios]
        else:
            scales = self.img_scale
        flips = [False] + ([True] if self.flip else [])
        for scale in scales:
            for flip in flips:
                for direction in (self.flip_direction if flip else
                                  ['horizontal']):
                    res = copy.deepcopy(results)
                    res['scale'] = scale
                    res['flip'] = flip
                    res['flip_direction'] = direction
                    outs.append(self.transforms(res))
        return outs
