"""The port's native host library (``s4former_tpu_torch/native``) against
its plain versions in ``data/pipelines/transforms.py`` (PIL and numpy),
bit for bit: every case of ``tests/test_native/test_native.py``, ported.

Also: concurrent first uses of an empty build directory each load a whole
library; a failed build raises with the compiler's messages; the pipelines
call the native functions and give the same arrays on the plain ones.

The decode cases need a library built with ``jpeglib.h`` and ``png.h``
(``native.HAS_DECODE``); they skip, with that reason, where it is not.
"""
import io
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from s4former_tpu_torch import native
from s4former_tpu_torch.data.pipelines import transforms as T

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.RandomState(42)


@pytest.fixture
def decode(tmp_path):
    """(native decode, plain decode) of bytes, as (rgb, label) pairs."""
    if not native.HAS_DECODE:
        pytest.skip('s4_native built without jpeglib.h/png.h: no decoder')

    def plain(data, reader):
        path = tmp_path / 'img'
        path.write_bytes(data)
        return reader(str(path))
    return {'rgb': (native.decode_rgb,
                    lambda d: plain(d, T.read_rgb_plain)),
            'label': (native.decode_label,
                      lambda d: plain(d, T.read_label_plain))}


def _png_bytes(arr, mode=None):
    b = io.BytesIO()
    (Image.fromarray(arr) if mode is None
     else Image.fromarray(arr, mode=mode)).save(b, 'PNG')
    return b.getvalue()


def _palette_png(lab):
    pi = Image.fromarray(lab, mode='P')
    pi.putpalette([v for i in range(256) for v in (i, 0, 255 - i)])
    b = io.BytesIO()
    pi.save(b, 'PNG')
    return b.getvalue()


def _jpeg_bytes(arr, quality=85):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, 'JPEG', quality=quality)
    return b.getvalue()


@pytest.mark.parametrize('kind,make', [
    ('rgb', lambda: _png_bytes(RNG.randint(0, 256, (37, 53, 3), np.uint8))),
    ('rgb', lambda: _png_bytes(RNG.randint(0, 256, (21, 33), np.uint8))),
    ('rgb', lambda: _png_bytes(RNG.randint(0, 256, (19, 23, 4), np.uint8))),
    ('rgb', lambda: _jpeg_bytes(RNG.randint(0, 256, (64, 48, 3), np.uint8))),
    ('label', lambda: _palette_png(RNG.randint(0, 21, (33, 41), np.uint8))),
    ('label', lambda: _png_bytes(RNG.randint(0, 256, (17, 29), np.uint8))),
], ids=['png_rgb', 'png_gray_replicates', 'png_rgba_drops_alpha', 'jpeg',
        'label_palette_indices', 'label_gray'])
def test_decode_bit_exact_vs_plain(decode, kind, make):
    data = make()
    got, want = decode[kind][0](data), decode[kind][1](data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_decode_label_is_writable(decode):
    out = native.decode_label(_palette_png(
        RNG.randint(0, 21, (9, 9), np.uint8)))
    out[0, 0] = 255            # LoadAnnotations remaps label maps in place


def test_decode_rejects_garbage(decode):
    with pytest.raises(ValueError):
        native.decode_rgb(b'not an image at all')


@pytest.mark.parametrize('shape,size', [
    ((64, 80, 3), (37, 51)),    # downscale
    ((37, 51, 3), (128, 100)),  # upscale
    ((64, 80), (31, 31)),       # gray
    ((50, 50, 3), (100, 100)),  # exact 2x
    ((512, 683, 3), (256, 341)),  # eval-path geometry
    ((7, 9, 3), (5, 3)),        # tiny
])
def test_resize_bilinear_bit_exact_vs_plain(shape, size):
    a = RNG.randint(0, 256, shape, np.uint8)
    assert np.array_equal(native.resize_u8(a, size), T.resize_plain(a, size))


@pytest.mark.parametrize('shape,size', [
    ((64, 80), (37, 51)),       # downscale (accumulation-order sensitive)
    ((37, 51), (128, 100)),
    ((33, 47, 3), (67, 31)),
    ((513, 771), (256, 385)),
    ((100, 100), (33, 77)),
])
def test_resize_nearest_bit_exact_vs_plain(shape, size):
    a = RNG.randint(0, 256, shape, np.uint8)
    assert np.array_equal(native.resize_u8(a, size, nearest=True),
                          T.resize_plain(a, size, nearest=True))


@pytest.mark.parametrize('alpha,beta', [(1.0, 17.3), (0.5, 0.0),
                                        (1.49, -20.0), (1.5, 32.0)])
def test_convert_u8_bit_exact_vs_plain(alpha, beta):
    img = RNG.randint(0, 256, (31, 47, 3), np.uint8)
    assert np.array_equal(native.convert_u8(img, alpha, beta),
                          T.convert_plain(img, alpha, beta))


@pytest.mark.parametrize('alpha', [0.5, 0.77, 1.0, 1.31, 1.5])
def test_saturation_u8_bit_exact_vs_plain(alpha):
    img = RNG.randint(0, 256, (29, 41, 3), np.uint8)
    assert np.array_equal(native.saturation_u8(img, alpha),
                          T.saturate_plain(img, alpha))


@pytest.mark.parametrize('dh', [-18, -1, 0, 7, 17])
def test_hue_u8_bit_exact_vs_plain(dh):
    img = RNG.randint(0, 256, (29, 41, 3), np.uint8)
    assert np.array_equal(native.hue_u8(img, dh), T.hue_plain(img, dh))


def test_hsv_edge_cases():
    # grey (diff = 0), primaries, near-black, near-white
    edges = np.array([[[0, 0, 0], [255, 255, 255], [255, 0, 0],
                       [0, 255, 0], [0, 0, 255], [128, 128, 128],
                       [255, 255, 0], [1, 0, 0], [254, 255, 255]]],
                     np.uint8)
    for dh in (-18, 7):
        assert np.array_equal(native.hue_u8(edges, dh),
                              T.hue_plain(edges, dh))
    for a in (0.5, 1.5):
        assert np.array_equal(native.saturation_u8(edges, a),
                              T.saturate_plain(edges, a))


def test_normalize_f32_bit_exact_vs_plain():
    img = RNG.randint(0, 256, (23, 37, 3), np.uint8)
    mean = np.asarray([123.675, 116.28, 103.53], np.float32)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    got = native.normalize_f32(img, mean, std)
    assert got.dtype == np.float32
    assert np.array_equal(got, T.normalize_plain(img, mean, std))


def test_native_refuses_what_it_cannot_take():
    with pytest.raises(TypeError):
        native.convert_u8(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        native.hue_u8(np.zeros((4, 4, 4), np.uint8), 3)
    with pytest.raises(ValueError):
        native.resize_u8(np.zeros((4, 4, 3), np.uint8), (0, 3))


def _fixture_files(tmp_path):
    img = RNG.randint(0, 256, (40, 56, 3), np.uint8)
    lab = RNG.randint(0, 21, (40, 56), np.uint8)
    ip, lp = tmp_path / 'img.png', tmp_path / 'lab.png'
    Image.fromarray(img).save(ip)
    pi = Image.fromarray(lab, mode='P')
    pi.putpalette([v for i in range(256) for v in (i, i, i)])
    pi.save(lp)
    return str(ip), str(lp)


def test_pipeline_native_and_plain_identical(tmp_path):
    """LoadImageFromFile, LoadAnnotations, Resize, PhotoMetricDistortion
    and Normalize give the same arrays on the native functions and on the
    plain ones (the same rng draws, bit-equal pixels)."""
    ip, lp = _fixture_files(tmp_path)
    pipeline = T.Compose([
        dict(type='LoadImageFromFile'), dict(type='LoadAnnotations'),
        dict(type='Resize', img_scale=(96, 64), ratio_range=(0.5, 2.0)),
        dict(type='PhotoMetricDistortion', rand_colorjitter_prob=1),
        dict(type='Normalize', mean=[123.675, 116.28, 103.53],
             std=[58.395, 57.12, 57.375])])

    def run():
        return pipeline({'img_info': {'filename': ip},
                         'ann_info': {'seg_map': lp}, 'seg_fields': [],
                         'rng': np.random.default_rng(5)})

    on = run()
    with mock.patch.object(T, 'native', T.PLAIN_HOST):
        off = run()
    assert on['img'].dtype == np.float32
    for key in ('img', 'gt_semantic_seg'):
        assert np.array_equal(on[key], off[key])


def test_pipeline_calls_the_native_functions(tmp_path):
    """The main path does not reach the plain versions: with each of them
    made to raise, the pipeline still runs."""
    ip, lp = _fixture_files(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError('a plain version ran on the main path')

    plain = ['resize_plain', 'convert_plain', 'saturate_plain', 'hue_plain',
             'normalize_plain']
    if native.HAS_DECODE:
        plain += ['read_rgb_plain', 'read_label_plain']
    with mock.patch.multiple(T, **{name: refuse for name in plain}):
        out = T.Compose([
            dict(type='LoadImageFromFile'), dict(type='LoadAnnotations'),
            dict(type='Resize', img_scale=(96, 64), ratio_range=(0.5, 2.0)),
            dict(type='PhotoMetricDistortion', rand_colorjitter_prob=1),
            dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1])])(
            {'img_info': {'filename': ip}, 'ann_info': {'seg_map': lp},
             'seg_fields': [], 'rng': np.random.default_rng(0)})
    assert out['img'].dtype == np.float32


_LOAD = ('import sys; from s4former_tpu_torch import native; '
         'from s4former_tpu_torch.native import build; import ctypes; '
         'lib = native._bind(ctypes.CDLL(str(build.build(sys.argv[1])))); '
         'print(lib.s4_has_decode())')


def test_concurrent_first_use_loads_a_whole_library(tmp_path):
    """Six processes started together on an empty build directory: each
    builds or finds the library and loads it; no partial file is left."""
    build_dir = tmp_path / 'build'
    procs = [subprocess.Popen([sys.executable, '-c', _LOAD, str(build_dir)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert [f.suffix for f in build_dir.iterdir()] == ['.so']


def test_failed_build_raises_with_the_compiler_messages(tmp_path):
    bad = tmp_path / 'broken.cpp'
    bad.write_text('int f( { return 0; }\n')
    with pytest.raises(RuntimeError, match='broken.cpp'):
        native.build.build(tmp_path / 'build', source=bad)
    assert not any((tmp_path / 'build').iterdir())


def test_build_name_hashes_source_and_flags(tmp_path):
    src = tmp_path / 'a.cpp'
    src.write_text('extern "C" int f() { return 1; }\n')
    p1 = native.build.library_path(['-O3'], src, tmp_path)
    assert p1 == native.build.library_path(['-O3'], src, tmp_path)
    assert p1 != native.build.library_path(['-O2'], src, tmp_path)
    src.write_text('extern "C" int f() { return 2; }\n')
    assert p1 != native.build.library_path(['-O3'], src, tmp_path)


def test_has_decode_matches_the_headers():
    cxx = native.build.find_cxx()
    assert native.HAS_DECODE == native.build.decode_headers_found(cxx)
    assert os.path.basename(native.build.build()).startswith('s4_native-')
