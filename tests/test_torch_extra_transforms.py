"""The port's extra pipeline transforms (``data/pipelines/extra_transforms``)
held bit for bit to the JAX package's: the same arguments, the same input
and the same ``results['rng']`` seed give the same image, label map, keys
and generator state afterwards, for 8 seeds a case, on uint8 and float
images. CLAHE and RandomMosaic are refused."""
import numpy as np
import pytest

from s4former_tpu.data.pipelines import extra_transforms as jextra
from s4former_tpu_torch.data.pipelines import extra_transforms as textra
from s4former_tpu_torch.registry import PIPELINES

HW = (45, 60)
SEEDS = range(8)
# Cityscapes' rare train ids, which RandomCropRareRemain tries to keep
RARE = [16, 15, 14, 17, 3, 12, 4, 6, 9]
COMMON = [0, 1, 2, 5, 7, 8]

CASES = [
    ('RandErase', dict(prob=1.0), 'uint8', 'common'),
    ('RandErase', dict(prob=0.7, n_patches=(2, 4), ratio=(0.1, 0.4),
                       squared=False), 'float32', 'common'),
    ('RandomGrayscale', dict(prob=0.5), 'uint8', 'common'),
    ('RandomGrayscale', dict(prob=0.5), 'float32', 'common'),
    ('GaussianBlur', dict(prob=1.0), 'uint8', 'common'),
    ('GaussianBlur', dict(prob=0.5, sigma=(0.5, 3.0), kernel_size=7),
     'float32', 'common'),
    ('RandomRotate', dict(prob=1.0, degree=20), 'uint8', 'common'),
    ('RandomRotate', dict(prob=0.5, degree=(-30.0, 5.0), pad_val=3,
                          seg_pad_val=0), 'float32', 'common'),
    ('RandomCropRareRemain', dict(crop_size=(24, 32), cat_max_ratio=0.75),
     'uint8', 'rare'),
    ('RandomCropRareRemain', dict(crop_size=(24, 32), cat_max_ratio=0.75),
     'uint8', 'common'),
    ('RandomCropRareRemain', dict(crop_size=(30, 70)), 'float32', 'rare'),
    ('ResizeToMultiple', dict(size_divisor=32), 'float32', 'common'),
    ('ResizeToMultiple', dict(size_divisor=16, interpolation='nearest'),
     'uint8', 'common'),
    ('Rerange', dict(), 'uint8', 'common'),
    ('Rerange', dict(min_value=-1.0, max_value=1.0), 'float32', 'common'),
    ('RGB2Gray', dict(), 'uint8', 'common'),
    ('RGB2Gray', dict(out_channels=1, weights=(0.2, 0.5, 0.3)), 'float32',
     'common'),
    ('AdjustGamma', dict(gamma=0.5), 'uint8', 'common'),
    ('AdjustGamma', dict(gamma=2.0), 'float32', 'common'),
    ('SegRescale', dict(scale_factor=0.5), 'uint8', 'common'),
    ('SegRescale', dict(scale_factor=2), 'float32', 'common'),
    ('RandomCutOut', dict(prob=1.0, n_holes=(1, 4),
                          cutout_shape=[(4, 4), (8, 6)]), 'uint8', 'common'),
    ('RandomCutOut', dict(prob=0.8, n_holes=3, cutout_ratio=[(0.1, 0.2)],
                          fill_in=(1, 2, 3), seg_fill_in=255), 'float32',
     'common'),
]


def _results(seed, dtype, classes):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, HW + (3,)).astype(np.uint8)
    if dtype == 'float32':
        img = img.astype(np.float32) + rs.uniform(0, 1, img.shape).astype(
            np.float32)
    # blocks of 15x20 pixels, one class each, so crops see few classes
    blocks = rs.choice(classes, (3, 3)).astype(np.uint8)
    seg = np.kron(blocks, np.ones((15, 20), np.uint8))
    seg[:2] = 255
    return {'img': img, 'gt_semantic_seg': seg,
            'seg_fields': ['gt_semantic_seg'], 'img_shape': img.shape,
            'ori_shape': img.shape, 'rng': np.random.default_rng(seed)}


@pytest.mark.parametrize('name,kwargs,dtype,classes', CASES,
                         ids=[f'{c[0]}-{i}' for i, c in enumerate(CASES)])
def test_transform_matches_jax_bit_for_bit(name, kwargs, dtype, classes):
    ours = getattr(textra, name)(**kwargs)
    ref = getattr(jextra, name)(**kwargs)
    changed = 0
    for seed in SEEDS:
        pool = COMMON if classes == 'common' else RARE + COMMON
        a = ours(_results(seed, dtype, pool))
        b = ref(_results(seed, dtype, pool))
        assert sorted(a) == sorted(b), seed
        for key, want in b.items():
            if key == 'rng':
                assert a[key].bit_generator.state == \
                    want.bit_generator.state, seed
            elif isinstance(want, np.ndarray):
                assert a[key].dtype == want.dtype, (key, seed)
                np.testing.assert_array_equal(a[key], want,
                                              err_msg=f'{key} seed {seed}')
            else:
                assert a[key] == want, (key, seed)
        before = _results(seed, dtype, pool)
        changed += not (a['img'].shape == before['img'].shape and
                        a['img'].dtype == before['img'].dtype and
                        np.array_equal(a['img'], before['img']) and
                        np.array_equal(a['gt_semantic_seg'],
                                       before['gt_semantic_seg']))
    assert changed > 0            # the transform did something


def test_transforms_are_registered():
    for name in {c[0] for c in CASES}:
        assert PIPELINES.get(name) is getattr(textra, name)


@pytest.mark.parametrize('name,kwargs', [
    ('CLAHE', {}), ('RandomMosaic', dict(prob=1.0))])
def test_unported_transforms_are_refused(name, kwargs):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        PIPELINES.build(dict(type=name, **kwargs))
