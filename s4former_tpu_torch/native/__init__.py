"""The host data path's native runtime (the port's counterpart of
``s4former_tpu/native``).

``src/s4_native.cpp`` decodes JPEG/PNG files and computes PIL's bilinear
and nearest resize, PhotoMetricDistortion's brightness/contrast
(``convert_u8``), saturation and hue, and ``Normalize``, each bit-exact to
the PIL/numpy plain versions in ``data/pipelines/transforms.py``. It has a
plain C interface and is loaded with ``ctypes``, which releases the
interpreter lock for the length of every call: the loader's threads run
these functions in parallel with each other and with the thread that
dispatches the training step.

The library is built with g++ at first use (``native/build.py``), not on
import; a failed build raises. ``HAS_DECODE`` (read at first use, which
builds the library) says whether the decoders are in it: they need
``jpeglib.h`` and ``png.h`` where the library is built, and without them
``decode_rgb``/``decode_label`` raise and the transforms decode with PIL.
Every other function needs no image library.

Arrays are HWC uint8 (``normalize_f32`` returns float32); each function
checks type, shape and size before it passes a pointer, and writes into
an array it allocates.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from s4former_tpu_torch.native import build

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
JPEG_MAGIC = b'\xff\xd8\xff'
PNG_MAGIC = b'\x89PNG\r\n\x1a\n'


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, c_int, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int)
    sig = {'s4_has_decode': ([], c_int),
           's4_free': ([ptr], None),
           's4_decode': ([ctypes.c_char_p, size, c_int, pp, pp, ip, ip, ip,
                          ctypes.c_char_p, c_int], c_int),
           's4_resize': ([ptr, c_int, c_int, c_int, c_int, c_int, c_int,
                          ptr], c_int),
           's4_convert_u8': ([ptr, size, ctypes.c_float, ctypes.c_float,
                              ptr], None),
           's4_saturation_u8': ([ptr, size, ctypes.c_float, ptr], None),
           's4_hue_u8': ([ptr, size, c_int, ptr], None),
           's4_normalize_f32': ([ptr, size, ptr, ptr, ptr], None)}
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build.build())))
    return _lib


def __getattr__(name):
    if name == 'HAS_DECODE':
        return bool(library().s4_has_decode())
    raise AttributeError(name)


def decodable(data: bytes) -> bool:
    """Whether ``data`` is a container the decoders read (JPEG or PNG)."""
    return data.startswith(JPEG_MAGIC) or data.startswith(PNG_MAGIC)


def _decode(data: bytes, label: bool) -> np.ndarray:
    lib = library()
    if not lib.s4_has_decode():
        raise RuntimeError('s4_native was built without jpeglib.h/png.h: '
                           'it has no decoder')
    handle, pixels = ctypes.c_void_p(), ctypes.c_void_p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.s4_decode(bytes(data), len(data), int(label),
                     ctypes.byref(handle), ctypes.byref(pixels),
                     ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                     err, len(err)):
        raise ValueError(err.value.decode())
    try:
        shape = (h.value, w.value) + ((c.value,) if c.value > 1 else ())
        out = np.empty(shape, np.uint8)
        ctypes.memmove(out.ctypes.data, pixels, out.nbytes)
    finally:
        lib.s4_free(handle)
    return out


def decode_rgb(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> RGB uint8 [h, w, 3] (PIL's ``convert('RGB')``)."""
    return _decode(data, label=False)


def decode_label(data: bytes) -> np.ndarray:
    """Label PNG bytes -> uint8 [h, w]: raw palette indices or gray
    values, the first channel of an RGB(A) PNG."""
    return _decode(data, label=True)


def _u8(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f'uint8 array expected, got {img.dtype}')
    if rgb and (img.ndim < 1 or img.shape[-1] != 3):
        raise ValueError(f'RGB array [..., 3] expected, got {img.shape}')
    return np.ascontiguousarray(img)


def convert_u8(img: np.ndarray, alpha: float = 1.0,
               beta: float = 0.0) -> np.ndarray:
    """clip(img * alpha + beta, 0, 255) truncated to uint8, any shape
    (PhotoMetricDistortion's brightness and contrast)."""
    a = _u8(img)
    out = np.empty_like(a)
    library().s4_convert_u8(a.ctypes.data, a.size, float(alpha),
                            float(beta), out.ctypes.data)
    return out


def saturation_u8(img: np.ndarray, alpha: float) -> np.ndarray:
    """HSV saturation scaled by ``alpha`` on RGB uint8 [..., 3] (cv2's
    HSV convention)."""
    a = _u8(img, rgb=True)
    out = np.empty_like(a)
    library().s4_saturation_u8(a.ctypes.data, a.size // 3, float(alpha),
                               out.ctypes.data)
    return out


def hue_u8(img: np.ndarray, dh: int) -> np.ndarray:
    """HSV hue shifted by ``dh`` (mod 180) on RGB uint8 [..., 3]."""
    a = _u8(img, rgb=True)
    out = np.empty_like(a)
    library().s4_hue_u8(a.ctypes.data, a.size // 3, int(dh),
                        out.ctypes.data)
    return out


def normalize_f32(img: np.ndarray, mean: Sequence[float],
                  std: Sequence[float]) -> np.ndarray:
    """(img - mean) / std of RGB uint8 [..., 3] -> float32."""
    a = _u8(img, rgb=True)
    m = np.ascontiguousarray(mean, np.float32).reshape(3)
    s = np.ascontiguousarray(std, np.float32).reshape(3)
    out = np.empty(a.shape, np.float32)
    library().s4_normalize_f32(a.ctypes.data, a.size // 3, m.ctypes.data,
                               s.ctypes.data, out.ctypes.data)
    return out


def resize_u8(img: np.ndarray, size_wh: Tuple[int, int],
              nearest: bool = False) -> np.ndarray:
    """PIL ``Image.resize(size_wh, BILINEAR or NEAREST)`` of uint8
    [h, w] or [h, w, c], c <= 16."""
    a = _u8(img)
    if a.ndim not in (2, 3) or (a.ndim == 3 and not 1 <= a.shape[2] <= 16):
        raise ValueError(f'[h, w] or [h, w, c <= 16] expected, got '
                         f'{a.shape}')
    ow, oh = int(size_wh[0]), int(size_wh[1])
    if min(a.shape[:2]) < 1 or ow < 1 or oh < 1:
        raise ValueError(f'cannot resize {a.shape} to {size_wh}')
    c = a.shape[2] if a.ndim == 3 else 1
    out = np.empty((oh, ow) + a.shape[2:], np.uint8)
    if library().s4_resize(a.ctypes.data, a.shape[0], a.shape[1], c, oh, ow,
                           int(nearest), out.ctypes.data):
        raise MemoryError(f'resize of {a.shape} to {size_wh} failed')
    return out
