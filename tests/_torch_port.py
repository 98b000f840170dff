"""Shared fixtures of the port's CPU parity tests (tests/test_torch_*.py).

One tiny SETR-PUP model (2-layer ViT, embed 64, 4 heads of dim 16, 64²
crops, two aux heads) is built by the JAX package; its variables are
perturbed with seeded numpy noise, so zero biases, the zero cls token and
identity BN statistics all matter, and the same numbers go to both packages
as numpy arrays.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

TINY_CFG = """
crop_size = (64, 64)
img_norm_cfg = dict(
    mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True)
model = dict(
    type='EncoderDecoder',
    backbone=dict(
        type='VisionTransformer', img_size=(64, 64), patch_size=16,
        embed_dims=64, num_layers=2, num_heads=4, out_indices=(0, 1)),
    decode_head=dict(
        type='SETRUPHead', in_channels=64, channels=16, num_classes=5,
        in_index=1, num_convs=2, up_scale=2, kernel_size=3),
    auxiliary_head=[dict(
        type='SETRUPHead', in_channels=64, channels=16, num_classes=5,
        in_index=i, num_convs=1, up_scale=4, kernel_size=3)
        for i in range(2)],
    test_cfg=dict(mode='whole'))
"""


def write_tiny_config(directory, mode: str = 'whole') -> str:
    text = TINY_CFG
    if mode == 'slide':
        text = text.replace(
            "test_cfg=dict(mode='whole')",
            "test_cfg=dict(mode='slide', crop_size=(64, 64), stride=(40, 40))")
    path = directory / f'tiny_{mode}.py'
    path.write_text(text)
    return str(path)


def perturbed(tree, seed: int, std: float = 0.1):
    """numpy copy of a JAX variables tree with every float leaf perturbed;
    BN variances are scaled by exp(noise), so they stay positive."""
    import jax
    rs = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        a = np.asarray(leaf, np.float32)
        noise = rs.normal(0.0, std, a.shape).astype(np.float32)
        if getattr(path[-1], 'key', None) == 'var':
            out.append(a * np.exp(noise))
        else:
            out.append(a + noise)
    return jax.tree_util.tree_unflatten(treedef, out)


def jax_variables(jax_segmentor, seed: int = 0):
    """Perturbed numpy variables {'params', 'batch_stats'} of a JAX
    Segmentor."""
    return perturbed({'params': jax_segmentor.variables['params'],
                      'batch_stats': jax_segmentor.variables['batch_stats']},
                     seed)


def image_batch(seed: int, h: int, w: int) -> np.ndarray:
    """[1, h, w, 3] normalised-image-like float32 input."""
    return np.random.RandomState(seed).normal(
        0.0, 1.0, (1, h, w, 3)).astype(np.float32)


def assert_argmax_agrees(p_ref: np.ndarray, p: np.ndarray, tol: float):
    """Labels must agree wherever the reference's top-2 margin exceeds
    ``tol`` (elsewhere the order is within the stated tolerance)."""
    top2 = np.sort(p_ref, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > tol
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(p_ref.argmax(-1)[sure], p.argmax(-1)[sure])


def jax_eval_probs(model, variables, img: np.ndarray, gt_shape):
    """The JAX in-loop eval's probabilities for one pipeline image at its
    label map's shape (``s4former_tpu/core/runner.py:make_eval_fn``): the
    image corner-padded to the patch size, the raw head logits resized by
    the eval's composed matrices (``eval_resize_matrices``), a softmax.
    The margin rule of the label comparisons reads them."""
    import jax
    import jax.numpy as jnp
    from s4former_tpu.core.runner import (_pad_to_bucket,
                                          eval_resize_matrices)
    x, (vh, vw) = _pad_to_bucket(img[None], 16)
    logits = np.asarray(model.apply(
        variables, jnp.asarray(x), train=False,
        method='forward_decode_from_img'))[0]
    lh, lw = logits.shape[:2]
    m_h, m_w = eval_resize_matrices(vh, vw, lh, lw, lh, lw, gt_shape,
                                    False, 1)
    out = np.einsum('oh,hwc->owc', m_h, logits)
    out = np.einsum('pw,hwc->hpc', m_w, out)
    return np.asarray(jax.nn.softmax(jnp.asarray(out), axis=-1))


def sure_pixels(probs: np.ndarray, tol: float) -> np.ndarray:
    """Where the top-2 probabilities lie more than ``tol`` apart: the
    pixels whose label two f32 forwards must agree on."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol


# The training tests' model: the tiny ViT above with a main head whose
# logits come out at image resolution (4 -> 16 -> 64, as SETR-PUP at 512²)
# and two one-conv aux heads at a quarter of it (resized to the labels).
TRAIN_MODEL = dict(
    type='EncoderDecoder',
    backbone=dict(type='VisionTransformer', img_size=(64, 64), patch_size=16,
                  embed_dims=64, num_layers=2, num_heads=4,
                  out_indices=(0, 1)),
    decode_head=dict(type='SETRUPHead', in_channels=64, channels=16,
                     num_classes=5, in_index=1, num_convs=2, up_scale=4,
                     kernel_size=3,
                     loss_decode=dict(type='CrossEntropyLoss',
                                      loss_weight=1.0)),
    auxiliary_head=[dict(type='SETRUPHead', in_channels=64, channels=16,
                         num_classes=5, in_index=i, num_convs=1, up_scale=4,
                         kernel_size=3,
                         loss_decode=dict(type='CrossEntropyLoss',
                                          loss_weight=0.4))
                    for i in range(2)])


# The zoo slice's tiny models (2-layer ViT of 64, 4 heads of 16, 64²):
# SETR-MLA (no cls token, the MLA neck to 16 channels, the MLA head with
# 8 channels a level, four one-conv FCN aux heads) and Segmenter (the
# mask-transformer head over the last tap). Drop rates are 0, so the steps
# draw nothing but the injected mixes.
MLA_MODEL = dict(
    type='EncoderDecoder',
    backbone=dict(type='VisionTransformer', img_size=(64, 64), patch_size=16,
                  embed_dims=64, num_layers=2, num_heads=4,
                  out_indices=(0, 1, 0, 1), with_cls_token=False,
                  final_norm=False, interpolate_mode='bilinear'),
    neck=dict(type='MLANeck', in_channels=[64, 64, 64, 64], out_channels=16,
              norm_cfg=dict(type='LN', eps=1e-6, requires_grad=True)),
    decode_head=dict(type='SETRMLAHead', in_channels=(16, 16, 16, 16),
                     channels=32, in_index=(0, 1, 2, 3), dropout_ratio=0,
                     mla_channels=8, num_classes=5,
                     loss_decode=dict(type='CrossEntropyLoss',
                                      loss_weight=1.0)),
    auxiliary_head=[dict(type='FCNHead', in_channels=16, channels=16,
                         in_index=i, dropout_ratio=0, num_convs=0,
                         kernel_size=1, concat_input=False, num_classes=5,
                         loss_decode=dict(type='CrossEntropyLoss',
                                          loss_weight=0.4))
                    for i in range(4)])
SEG_MODEL = dict(
    type='EncoderDecoder',
    backbone=dict(type='VisionTransformer', img_size=(64, 64), patch_size=16,
                  embed_dims=64, num_layers=2, num_heads=4,
                  out_indices=(1,)),
    decode_head=dict(type='SegmenterMaskTransformerHead', in_channels=64,
                     channels=64, num_classes=5, num_layers=2, num_heads=4,
                     embed_dims=64, dropout_ratio=0.0, drop_path_rate=0.0,
                     in_index=0,
                     loss_decode=dict(type='CrossEntropyLoss',
                                      loss_weight=1.0)))


def jax_train_model(seed: int = 0, ema: bool = True, cfg=None):
    """(JAX model, JAX TrainState) of TRAIN_MODEL (or ``cfg``, a variant of
    it) with perturbed weights; the EMA teacher gets weights of its own. The
    JAX side runs its XLA attention (its Pallas kernels are held to the
    port in test_torch_ops)."""
    import copy
    import jax
    import jax.numpy as jnp
    from s4former_tpu.models import build_segmentor, init_segmentor_variables
    from s4former_tpu.semi.train_step import create_train_state
    cfg = copy.deepcopy(cfg or TRAIN_MODEL)
    cfg['backbone']['use_flash'] = False
    model = build_segmentor(cfg)
    variables = init_segmentor_variables(model, jax.random.PRNGKey(seed),
                                         (1, 64, 64, 3))
    student = perturbed({'params': variables['params'],
                         'batch_stats': variables.get('batch_stats', {})},
                        seed)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, student),
                               ema=ema)
    if ema:
        teacher = perturbed(student, seed + 1, std=0.05)
        state = state.replace(
            ema_params=jax.tree_util.tree_map(jnp.asarray, teacher['params']),
            ema_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                   teacher['batch_stats']))
    return model, state


def shaped_variables(init_fn, seed: int = 0):
    """Seeded numpy variables {'params', 'batch_stats'} of a JAX module
    made from the shapes of ``init_fn()`` (``jax.eval_shape``: traced, not
    compiled; a jitted init of a tiny ResNet-50 segmentor takes many
    seconds to compile on the CPU): kernels normal with std 1/sqrt(fan_in) (flax's
    lecun normal), every other leaf moved off its init by seeded noise of
    std 0.1 (BN scales 1 + noise, variances 1 * exp(noise), biases, means
    and CCNet's ``gamma`` noise). The kernels keep their scale, so a deep
    CNN's eval-mode activations do not blow up as with ``perturbed``
    (which adds 0.1 to kernels of std 0.03-0.1) and its logits leave the
    softmax unsaturated."""
    import jax
    shapes = jax.eval_shape(init_fn)
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        key = getattr(path[-1], 'key', None)
        noise = rs.normal(0.0, 0.1, x.shape).astype(np.float32)
        if key == 'kernel':
            fan_in = int(np.prod(x.shape[:-1]))
            return (rs.normal(0.0, 1.0, x.shape) /
                    np.sqrt(fan_in)).astype(np.float32)
        if key == 'scale':
            return 1.0 + noise
        if key == 'var':
            return np.exp(noise)
        return noise
    tree = {'params': dict(shapes['params']),
            'batch_stats': dict(shapes.get('batch_stats', {}))}
    return jax.tree_util.tree_map_with_path(leaf, tree)


def cnn_model(depth: int = 50, num_classes: int = 5) -> dict:
    """The CNN slice's tiny DeepLabV3+ (``deeplabv3plus_r50-d8.py`` at
    ``stem_channels`` 16, ``base_channels`` 8, head ``channels`` 16, 64²
    crops: the -D8 strides and dilations, so stage 4 is 8 x 8): the
    separable ASPP (dilations 1, 2, 3: small enough to reach across an
    8 x 8 map) with the c1 skip, one FCN aux head on stage 3.
    Dropout 0, so a step draws nothing but the injected mixes. Below depth
    50 ``base_channels`` is 16: PyTorch's CPU build 2.13 crashes (SIGSEGV)
    in the backward of a stride-2 1x1 conv from 8 to 16 channels on a
    channels-last batch of 3 or more."""
    base = 8 if depth >= 50 else 16
    widths = [base * (4 if depth >= 50 else 1) * 2 ** i for i in range(4)]
    ce = dict(type='CrossEntropyLoss', loss_weight=1.0)
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=depth, stem_channels=16,
                      base_channels=base, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), contract_dilation=True),
        decode_head=dict(type='DepthwiseSeparableASPPHead',
                         in_channels=widths[3], in_index=3, channels=16,
                         dilations=(1, 2, 3), c1_in_channels=widths[0],
                         c1_channels=8, c1_index=0, dropout_ratio=0.0,
                         num_classes=num_classes, loss_decode=ce),
        auxiliary_head=[dict(type='FCNHead', in_channels=widths[2],
                             in_index=2, channels=16, num_convs=1,
                             concat_input=False, dropout_ratio=0.0,
                             num_classes=num_classes,
                             loss_decode=dict(ce, loss_weight=0.4))])


def upernet_swin_model(window_size: int = 7, num_classes: int = 5,
                       stages: int = 4) -> dict:
    """``configs/_base_/models/upernet_swin.py`` narrowed: Swin at embed
    24, two blocks a stage, heads (1, 2, 3, 6); the first ``stages``
    stages, each a level of the UPer head (12 channels); the FCN aux head
    (8 channels) on the last but one; dropout 0."""
    ce = dict(type='CrossEntropyLoss', loss_weight=1.0)
    widths = [24 * 2 ** s for s in range(stages)]
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='SwinTransformer', embed_dims=24,
                      depths=(2,) * stages, num_heads=(1, 2, 3, 6)[:stages],
                      window_size=window_size,
                      out_indices=tuple(range(stages))),
        decode_head=dict(type='UPerHead', in_channels=widths,
                         in_index=list(range(stages)),
                         pool_scales=(1, 2, 3, 6), channels=12,
                         dropout_ratio=0.0, num_classes=num_classes,
                         loss_decode=ce),
        auxiliary_head=[dict(type='FCNHead', in_channels=widths[-2],
                             in_index=stages - 2, channels=8, num_convs=1,
                             concat_input=False, dropout_ratio=0.0,
                             num_classes=num_classes,
                             loss_decode=dict(ce, loss_weight=0.4))])


def hrnet_extra(stage3_modules: int = 2) -> dict:
    """HRNet-W18's stages with one block a branch, stage 3 of
    ``stage3_modules`` modules, branch widths 4, 8, 16, 32 (a bottleneck
    layer1 of 8)."""
    return dict(
        stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                    num_blocks=(1,), num_channels=(8,)),
        stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                    num_blocks=(1, 1), num_channels=(4, 8)),
        stage3=dict(num_modules=stage3_modules, num_branches=3,
                    block='BASIC', num_blocks=(1, 1, 1),
                    num_channels=(4, 8, 16)),
        stage4=dict(num_modules=1, num_branches=4, block='BASIC',
                    num_blocks=(1, 1, 1, 1), num_channels=(4, 8, 16, 32)))


def ocrnet_model(num_classes: int = 5, stage3_modules: int = 2) -> dict:
    """``configs/_base_/models/ocrnet_hr18.py`` narrowed: ``hrnet_extra``,
    the FCN stage at 12 channels, the OCR stage at 12 (8 for its
    attention); dropout off, as the config's."""
    ce = dict(type='CrossEntropyLoss', loss_weight=1.0)
    widths = [4, 8, 16, 32]
    return dict(
        type='CascadeEncoderDecoder', num_stages=2,
        backbone=dict(type='HRNet', extra=hrnet_extra(stage3_modules)),
        decode_head=[
            dict(type='FCNHead', in_channels=widths, in_index=(0, 1, 2, 3),
                 input_transform='resize_concat', channels=12, num_convs=1,
                 kernel_size=1, concat_input=False, dropout_ratio=-1,
                 num_classes=num_classes,
                 loss_decode=dict(ce, loss_weight=0.4)),
            dict(type='OCRHead', in_channels=widths, in_index=(0, 1, 2, 3),
                 input_transform='resize_concat', channels=12,
                 ocr_channels=8, dropout_ratio=-1, num_classes=num_classes,
                 loss_decode=ce)])


def stdc_model(num_classes: int = 5) -> dict:
    """``configs/_base_/models/stdc.py`` narrowed: STDCNet1 at channels
    (8, 16, 32, 64, 128), two convs a module, the context path at 16 (its FFM
    at 32), the FCN decode head (16) on the fused 1/8 map, the two FCN aux
    heads (8) on the contexts and ``STDCHead`` (8) on the 1/8 map with its own
    2 classes; dropout 0."""
    ce = dict(type='CrossEntropyLoss', loss_weight=1.0)
    fcn = dict(type='FCNHead', num_convs=1, concat_input=False,
               dropout_ratio=0.0, align_corners=True, loss_decode=ce)
    return dict(
        type='EncoderDecoder',
        backbone=dict(
            type='STDCContextPathNet',
            backbone_cfg=dict(type='STDCNet', stdc_type='STDCNet1',
                              channels=(8, 16, 32, 64, 128),
                              bottleneck_type='cat', num_convs=2),
            last_in_channels=(128, 64), out_channels=16,
            ffm_cfg=dict(in_channels=48, out_channels=32, scale_factor=4)),
        decode_head=dict(fcn, in_channels=32, channels=16, in_index=3,
                         num_classes=num_classes),
        auxiliary_head=[
            dict(fcn, in_channels=16, channels=8, in_index=2,
                 num_classes=num_classes),
            dict(fcn, in_channels=16, channels=8, in_index=1,
                 num_classes=num_classes),
            dict(fcn, type='STDCHead', in_channels=32, channels=8,
                 in_index=0, num_classes=2, boundary_threshold=0.1)])


LOGIT_GAIN = 8.0


def jax_cnn_train_model(cfg, seed: int = 0):
    """(JAX model, JAX TrainState) of a CNN segmentor config, weights from
    ``shaped_variables``; the EMA teacher gets weights of its own."""
    import copy
    import jax
    import jax.numpy as jnp
    from s4former_tpu.models import build_segmentor, init_segmentor_variables
    from s4former_tpu.semi.train_step import create_train_state
    model = build_segmentor(copy.deepcopy(cfg))
    student = shaped_variables(lambda: init_segmentor_variables(
        model, jax.random.PRNGKey(0), (1, 64, 64, 3)), seed)
    # classifiers x LOGIT_GAIN: logits with a spread, so neither the
    # teacher's max softmax nor the student's argmax (acc_seg) sits in
    # near-ties, and the softmax is not saturated
    for head in student['params'].values():
        if isinstance(head, dict) and 'conv_seg' in head:
            head['conv_seg']['kernel'] = head['conv_seg']['kernel'] * \
                LOGIT_GAIN
    teacher = perturbed(student, seed + 1, std=0.01)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, student),
                               ema=True)
    state = state.replace(
        ema_params=jax.tree_util.tree_map(jnp.asarray, teacher['params']),
        ema_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               teacher['batch_stats']))
    return model, state


def torch_train_model(cfg=None):
    """The port's TRAIN_MODEL, or ``cfg`` (weights to be loaded through the
    bridge)."""
    import copy
    import s4former_tpu_torch.models  # noqa: F401
    from s4former_tpu_torch.models import build_segmentor
    return build_segmentor(copy.deepcopy(cfg or TRAIN_MODEL))


# ------------------------------------------------- the CLIs' tiny config
FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), '..', 'data',
                   'fixtures', 'voc_mini')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
# keep-ratio (96, 64): the 500x375 fixtures become 85x64, padded to 96x64
TEST_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(96, 64), flip=False,
         transforms=[dict(type='Resize', keep_ratio=True),
                     dict(type='RandomFlip'),
                     dict(type='Normalize', **NORM),
                     dict(type='ImageToTensor', keys=['img']),
                     dict(type='Collect', keys=['img'])])]

CLI_CFG = """
crop_size = (64, 64)
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
data_root = '{root}'
geometric = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations'),
    dict(type='Resize', img_scale=(128, 64), ratio_range=(0.5, 2.0)),
    dict(type='RandomCrop', crop_size=crop_size, cat_max_ratio=0.75),
    dict(type='RandomFlip', prob=0.5),
]
sup_pipeline = geometric + [
    dict(type='PhotoMetricDistortion'),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
    dict(type='ExtraAttrs', tag='sup'),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_semantic_seg']),
]
unsup_pipeline = geometric + [dict(
    type='MultiBranch',
    unsup_student=[
        dict(type='PhotoMetricDistortion'),
        dict(type='Normalize', **img_norm_cfg),
        dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
        dict(type='ExtraAttrs', tag='unsup_student'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg'])],
    unsup_teacher=[
        dict(type='Normalize', **img_norm_cfg),
        dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
        dict(type='ExtraAttrs', tag='unsup_teacher'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg'])])]
test_pipeline = {test_pipeline}
splits = '{root}/datasplits/fixture/'
data = dict(
    samples_per_gpu=4, workers_per_gpu=1,
    train=dict(
        type='SemiDataset',
        sup=dict(type='PascalVOCDataset', data_root=data_root,
                 img_dir='JPEGImages', ann_dir='SegmentationClass',
                 split=splits + 'train_supervised.txt',
                 pipeline=sup_pipeline),
        unsup=dict(type='PascalVOCDataset', data_root=data_root,
                   img_dir='JPEGImages', ann_dir='SegmentationClass',
                   split=splits + 'train_unsupervised.txt',
                   pipeline=unsup_pipeline)),
    val=dict(type='PascalVOCDataset', data_root=data_root,
             img_dir='JPEGImages', ann_dir='SegmentationClass',
             split='{val_split}', pipeline=test_pipeline),
    test=dict(type='PascalVOCDataset', data_root=data_root,
              img_dir='JPEGImages', ann_dir='SegmentationClass',
              split='{val_split}', pipeline=test_pipeline))
samples_per_gpu_sup = 2
samples_per_gpu_unsup = 2
model = dict(
    type='EncoderDecoder',
    backbone=dict(type='VisionTransformer', img_size=(64, 64),
                  patch_size=16, embed_dims=64, num_layers=2, num_heads=4,
                  out_indices=(0, 1)),
    decode_head=dict(type='SETRUPHead', in_channels=64, channels=16,
                     num_classes=21, in_index=1, num_convs=2, up_scale=4,
                     kernel_size=3,
                     loss_decode=dict(type='CrossEntropyLoss',
                                      loss_weight=1.0)),
    auxiliary_head=[dict(type='SETRUPHead', in_channels=64, channels=16,
                         num_classes=21, in_index=i, num_convs=1,
                         up_scale=4, kernel_size=3,
                         loss_decode=dict(type='CrossEntropyLoss',
                                          loss_weight=0.4))
                    for i in range(2)],
    test_cfg=dict(mode='whole'),
    ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.06,
    attn_mask_seperate_head=True, attn_mask_weight=5.0,
    adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
    negative_class_ranking=True, negative_class_ranking_mode='unsup_only')
optimizer = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=0.0,
                 paramwise_cfg=dict(custom_keys={{'head': dict(lr_mult=10.)}}))
lr_config = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)
runner = dict(type='IterBasedRunner', max_iters=2)
evaluation = dict(interval=2, metric='mIoU')
checkpoint_config = dict(by_epoch=False, interval=2)
log_config = dict(interval=1)
"""


def write_cli_config(directory, val_split: str) -> str:
    """A config for ``tools.train`` / ``tools.test`` that runs in seconds on
    the CPU: the fixture images through the flagship's pipelines at 64²
    crops (test: keep-ratio (96, 64)), 2 + 2 a step, a 2-layer ViT of 64
    with the SETR-PUP head, 2 aux heads, 21 classes and the S4Former flags,
    2 iterations with eval and checkpoint at 2. ``val_split``: a split file
    of val stems."""
    path = directory / 'tiny_cli.py'
    path.write_text(CLI_CFG.format(root=osp.abspath(FIXTURE),
                                   test_pipeline=repr(TEST_PIPELINE),
                                   val_split=val_split))
    return str(path)


def write_ade_tree(root, seed: int = 0, n_sup: int = 4, n_unsup: int = 4,
                   n_val: int = 3, hw=(48, 64)) -> dict:
    """An ADE20K-layout tree written with numpy under ``root``:
    ``images/{training,validation}/*.jpg`` of about ``hw`` (some turned to
    portrait) and their ``annotations/`` label PNGs of blocks of 0-150 (0 is
    "other", ignored under ``reduce_zero_label``), plus the split files
    ``sup.txt`` and ``unsup.txt`` of the training stems. Returns the stems
    by split."""
    import os
    from PIL import Image
    rs = np.random.RandomState(seed)
    stems = {'sup': [], 'unsup': [], 'val': []}
    names = ['sup'] * n_sup + ['unsup'] * n_unsup + ['val'] * n_val
    for i, which in enumerate(names):
        part = 'validation' if which == 'val' else 'training'
        stem = f'ADE_{"val" if which == "val" else "train"}_{i + 1:08d}'
        h, w = hw if i % 3 else hw[::-1]
        h, w = h + int(rs.randint(0, 8)), w + int(rs.randint(0, 8))
        blocks = rs.randint(1, 151, (-(-h // 8), -(-w // 8)))
        blocks[rs.rand(*blocks.shape) < 0.15] = 0
        label = np.kron(blocks, np.ones((8, 8), np.int64))[:h, :w]
        img = (rs.randint(0, 256, (h, w, 3)) // 2 +
               (label[..., None] * np.array([1, 3, 7])) % 128)
        for sub, ext, arr in (('images', '.jpg', img.astype(np.uint8)),
                              ('annotations', '.png',
                               label.astype(np.uint8))):
            os.makedirs(osp.join(root, sub, part), exist_ok=True)
            Image.fromarray(arr).save(osp.join(root, sub, part, stem + ext))
        stems[which].append(stem)
    for which in ('sup', 'unsup'):
        with open(osp.join(root, f'{which}.txt'), 'w') as f:
            f.write('\n'.join(stems[which]) + '\n')
    return stems


def write_ade_config(directory, root) -> str:
    """The CLI config on the ADE20K tree at ``root`` (``write_ade_tree``):
    ``ADE20KDataset`` in sup, unsup and val (the whole validation folder,
    keep-ratio test pipeline), labels through ``reduce_zero_label``, and
    150 classes on the decode head and both aux heads."""
    text = CLI_CFG.format(root=osp.abspath(root),
                          test_pipeline=repr(TEST_PIPELINE), val_split='')
    for old, new, count in (
            ("dict(type='LoadAnnotations')",
             "dict(type='LoadAnnotations', reduce_zero_label=True)", 1),
            ("'PascalVOCDataset'", "'ADE20KDataset'", 4),
            ("img_dir='JPEGImages', ann_dir='SegmentationClass',\n"
             "                 split=splits + 'train_supervised.txt'",
             "img_dir='images/training', ann_dir='annotations/training',\n"
             "                 split='sup.txt'", 1),
            ("img_dir='JPEGImages', ann_dir='SegmentationClass',\n"
             "                   split=splits + 'train_unsupervised.txt'",
             "img_dir='images/training',\n"
             "                   ann_dir='annotations/training',\n"
             "                   split='unsup.txt'", 1),
            ("img_dir='JPEGImages', ann_dir='SegmentationClass',\n"
             "             split='', pipeline",
             "img_dir='images/validation',\n"
             "             ann_dir='annotations/validation', pipeline", 1),
            ("img_dir='JPEGImages', ann_dir='SegmentationClass',\n"
             "              split='', pipeline",
             "img_dir='images/validation',\n"
             "              ann_dir='annotations/validation', pipeline", 1),
            ('num_classes=21', 'num_classes=150', 2)):
        assert text.count(old) == count, old
        text = text.replace(old, new)
    path = directory / 'tiny_ade.py'
    path.write_text(text)
    return str(path)


# The SegFormer tests' model (tests/test_torch_mit.py and the card tests):
# the MIT_MODEL of tests/test_semi/test_mit_semi.py (MiT embed 8, 4 stages
# of one block, heads 1/2/4/8, sr 8/4/2/1, mlp ratio 2; SegFormer head of
# 16 channels, 5 classes) with the PASA flags on the segmentor, adaptive;
# head dropout 0, so two packages (or devices) compute the same.
MIT_MODEL = dict(
    type='EncoderDecoder',
    backbone=dict(
        type='MixVisionTransformer', embed_dims=8, num_stages=4,
        num_layers=[1, 1, 1, 1], num_heads=[1, 2, 4, 8],
        patch_sizes=[7, 3, 3, 3], sr_ratios=[8, 4, 2, 1],
        out_indices=(0, 1, 2, 3), mlp_ratio=2),
    decode_head=dict(
        type='SegformerHead', in_channels=[8, 16, 40, 64],
        in_index=[0, 1, 2, 3], channels=16, num_classes=5,
        dropout_ratio=0.0,
        loss_decode=dict(type='CrossEntropyLoss', loss_weight=1.0)),
    attn_mask_seperate_head=True, attn_mask_weight=5,
    adaptive_attn_mask=True)


def mit_model_cfg(adaptive: bool = True, drop_path_rate: float = 0.0,
                  **head):
    """A copy of MIT_MODEL with the adaptive flag, the drop-path rate and
    head keys set."""
    import copy
    cfg = copy.deepcopy(MIT_MODEL)
    cfg['adaptive_attn_mask'] = adaptive
    cfg['backbone']['drop_path_rate'] = drop_path_rate
    cfg['decode_head'].update(head)
    return cfg


# A UniMatch variant of the CLI config: UniSemiDataset with three-branch
# unsup pipelines (the weak teacher view and two strong student views, whose
# strong branches also take RandomGrayscale and GaussianBlur) and the
# ``_mix``-tagged mix-source stream; PatchShuffle in the streams.
UNIMATCH_CFG = """
strong = [dict(type='PhotoMetricDistortion'),
          dict(type='RandomGrayscale', prob=0.5),
          dict(type='GaussianBlur', prob=0.5)]


def branch(tag, strong_views):
    return (strong if strong_views else []) + [
        dict(type='Normalize', **img_norm_cfg),
        dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
        dict(type='ExtraAttrs', tag=tag),
        dict(type='Collect', keys=['img', 'gt_semantic_seg'])]


def three_branch(suffix):
    return geometric + [dict(type='MultiBranch', **{
        'unsup_teacher' + suffix: branch('unsup_teacher' + suffix, False),
        'unsup_student' + suffix: branch('unsup_student' + suffix, True),
        'unsup_student_2' + suffix: branch('unsup_student_2' + suffix,
                                           True)})]


data['train'] = dict(
    type='UniSemiDataset', sup=data['train']['sup'],
    unsup=dict(data['train']['unsup'], pipeline=three_branch('')),
    unsup_mix=dict(data['train']['unsup'], pipeline=three_branch('_mix')))
model.update(unimatch=True, use_PatchShuffle=True,
             use_PatchShuffle_w_Cutmix=False)
"""


def write_unimatch_config(directory, val_split: str) -> str:
    """``write_cli_config``'s config (2 + 2 a step, 2 iterations) with the
    UniMatch regime: the unsup and mix-source streams through three-branch
    pipelines, and ``model.unimatch``."""
    base = write_cli_config(directory, val_split)
    path = directory / 'tiny_unimatch.py'
    with open(base) as f:
        path.write_text(f.read() + UNIMATCH_CFG)
    return str(path)


# ------------------------------------------------- data-parallel workers
# tests/test_torch_parallel.py runs these in spawned processes joined by a
# gloo group on the CPU; they import only the port (the JAX reference runs
# in the test's own process) and exchange data through files.
def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, args,
               init: bool = True):
    import os
    import torch
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    if not init:            # fn joins the group itself (a CLI's --launcher)
        fn(rank, world, *args)
        return
    from s4former_tpu_torch.parallel.distributed import init_distributed
    init_distributed('env', device='cpu')
    try:
        fn(rank, world, *args)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 240.0,
              init: bool = True):
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one
    gloo group (torchrun's env launcher); every process must exit 0. With
    ``init=False`` the processes get the launcher's environment and ``fn``
    joins the group itself."""
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, args, init))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, f'{len(alive)} ranks did not finish in {timeout} s'
    assert [p.exitcode for p in procs] == [0] * world, \
        [p.exitcode for p in procs]


def identical_across_ranks(tensors) -> bool:
    """Every tensor bit for bit the same on every rank (rank 0's broadcast
    compared on each rank, the mismatches summed over the ranks)."""
    import torch
    import torch.distributed as dist
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    bad = (flat.view(torch.int32) != ref.view(torch.int32)).sum().reshape(1)
    dist.all_reduce(bad)
    return int(bad) == 0


def dp_trajectory_worker(rank: int, world: int, inp: str, out: str):
    """The port's step at ``world`` ranks: the test's initial state dicts,
    flags and global batches from ``inp``; each data index feeds its block
    (``dbg_`` draws stay global). With ``mp`` > 1 or ``zero3`` in ``inp``
    the ranks form a (data, model) grid and the state is split
    (``parallel/tp.py``). Rank 0 writes each step's logs and the final,
    gathered state to ``out``; the tensors every rank holds whole must stay
    identical across the ranks, and the split ones keep their pieces'
    shapes after every step (``sharded``)."""
    import torch
    from s4former_tpu_torch.models import build_segmentor
    from s4former_tpu_torch.parallel.mesh import (make_mesh, reset_mesh,
                                                  shard_batch)
    from s4former_tpu_torch.parallel.tp import shard_state, unshard_state_dict
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    data = torch.load(inp, weights_only=False)
    model = build_segmentor(data['model_cfg'])
    sds = data['state']
    model.load_state_dict(sds['model'])
    state = create_train_state(model, ema=sds['ema'] is not None)
    if state.ema_model is not None:
        state.ema_model.load_state_dict(sds['ema'])
    for name, buf in state.momentum.items():
        buf.copy_(sds['momentum'][name])
    make_mesh(data.get('mp', 1))
    state = shard_state(state, zero3=data.get('zero3', False))
    plan = state.plan
    split = set(plan.split_names()) if plan else set()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    step = make_semi_train_step(model, SemiConfig(**data['flags']),
                                **data['step_kw'])
    gen = torch.Generator().manual_seed(0)
    logs_by_step, same, sharded = [], [], []
    for batch in data['batches']:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        local = shard_batch({k: v for k, v in batch.items()
                             if not k.startswith('dbg_')})
        local.update({k: v for k, v in batch.items() if k.startswith('dbg_')})
        state, logs = step(state, local, gen)
        logs_by_step.append({k: float(v) for k, v in logs.items()})
        whole = [(n, t) for n, t in state.model.state_dict().items()] + \
            list(state.momentum.items())
        if state.ema_model is not None:
            whole += list(state.ema_model.state_dict().items())
        same.append(identical_across_ranks(
            [t for n, t in whole if n not in split]))
        sharded.append(bool(split) and all(
            tuple(p.shape) == shapes[n] and
            tuple(state.momentum[n].shape) == shapes[n]
            for n, p in state.model.named_parameters()) and all(
            shapes[n] != tuple(sds['model'][n].shape) for n in split))
    sd = {'model': unshard_state_dict(plan, state.model.state_dict()),
          'momentum': unshard_state_dict(plan, dict(state.momentum)),
          'ema': None if state.ema_model is None else
          unshard_state_dict(plan, state.ema_model.state_dict())}
    reset_mesh()
    if rank == 0:
        torch.save({'logs': logs_by_step, 'same': same, 'sharded': sharded,
                    'step': int(state.step),
                    'annealed': None if state.annealed_momentum is None
                    else float(state.annealed_momentum), **sd}, out)


def dp_collectives_worker(rank: int, world: int, out: str):
    """The data axis's collectives at ``world`` ranks, each checked on
    every rank against the same computation on the global batch in plain
    torch; rank 0 writes 'ok' to ``out``."""
    import torch
    import torch.distributed as dist
    from s4former_tpu_torch.models.decode_heads.setr_up import BatchNorm
    from s4former_tpu_torch.parallel import mesh
    rs = np.random.RandomState(3)
    b = 3
    x = torch.from_numpy(rs.randn(b * world, 5, 6, 4).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 256, (b * world, 7)).astype(
        np.int32))
    rows = slice(rank * b, (rank + 1) * b)
    # gather_rows / local_rows / shard_batch: exact for f32 and int
    assert torch.equal(mesh.gather_rows(x[rows]), x)
    assert torch.equal(mesh.gather_rows(labels[rows]), labels)
    assert torch.equal(mesh.gather_rows(labels[rows] > 100), labels > 100)
    assert torch.equal(mesh.local_rows(x), x[rows])
    assert torch.equal(mesh.shard_batch({'x': x})['x'], x[rows])
    # a draw at the global batch, one block or two stacked batches
    two = torch.arange(2 * b * world)
    assert torch.equal(mesh.draw_rows(lambda s: torch.arange(s[0]), (b,)),
                       torch.arange(b * world)[rows])
    with mesh.stacked_batches(2):
        got = mesh.draw_rows(lambda s: torch.arange(s[0]), (2 * b,))
    assert torch.equal(got, torch.cat([two[rows], two[b * world:][rows]]))
    # global_sum: forward sums, backward all-reduces the gradient
    v = torch.full((3,), float(rank + 1), requires_grad=True)
    s = mesh.global_sum(v)
    assert torch.equal(s.detach(), torch.full((3,), world * (world + 1) / 2))
    (s * (rank + 1)).sum().backward()
    assert torch.equal(v.grad, torch.full((3,), world * (world + 1) / 2))
    # SyncBN forward, backward and running statistics against the plain
    # batch norm (biased variance, momentum 0.9) of the global batch
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.0, -0.2, 0.3]))
    w = torch.from_numpy(rs.randn(b * world, 5, 6, 4).astype(np.float32))
    xl = x[rows].clone().requires_grad_(True)
    y = bn(xl, train=True)
    (y * w[rows]).sum().backward()
    xg = x.clone().requires_grad_(True)
    wt = bn.weight.detach().clone().requires_grad_(True)
    bt = bn.bias.detach().clone().requires_grad_(True)
    mean = xg.mean(dim=(0, 1, 2))
    var = (xg * xg).mean(dim=(0, 1, 2)) - mean * mean
    yg = (xg - mean) * torch.rsqrt(var + 1e-5) * wt + bt
    (yg * w).sum().backward()
    torch.testing.assert_close(y, yg[rows].detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(xl.grad, xg.grad[rows], rtol=0, atol=1e-5)
    grads = mesh.all_reduce_grads({'w': bn.weight.grad, 'b': bn.bias.grad})
    torch.testing.assert_close(grads['w'], wt.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads['b'], bt.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean.detach(),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_var,
                               0.9 + 0.1 * var.detach(), rtol=0, atol=1e-6)
    # replicate_state: rank 0's tensors everywhere
    from s4former_tpu_torch.semi.train_step import create_train_state
    torch.manual_seed(rank)
    model = torch_train_model()
    state = mesh.replicate_state(create_train_state(model, ema=True))
    assert identical_across_ranks(list(model.state_dict().values()) +
                                  list(state.ema_model.state_dict().values()))
    dist.barrier()
    if rank == 0:
        with open(out, 'w') as f:
            f.write('ok')


def dp_eval_worker(rank: int, world: int, cfg_path: str, weights: str,
                   out: str):
    """``make_eval_fn`` of the config's val set at ``world`` ranks on the
    weights in ``weights``; rank 0 writes the metrics to ``out``."""
    import json
    import torch
    import s4former_tpu_torch.data  # noqa: F401
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import make_eval_fn
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.models import build_segmentor
    from s4former_tpu_torch.semi.train_step import create_train_state
    cfg = Config.fromfile(cfg_path)
    model = build_segmentor(cfg.model)
    model.load_state_dict(torch.load(weights, weights_only=True))
    metrics = make_eval_fn(build_dataset(cfg.data['val']), batch_size=2)(
        create_train_state(model))
    if rank == 0:
        with open(out, 'w') as f:
            json.dump(metrics, f)


def eval_vis_worker(rank: int, world: int, cfg_path: str, weights: str,
                    work_dir: str):
    """The runner's eval at iteration 2 (``IterBasedRunner._evaluate``:
    metrics, the eval panels, the best checkpoint) on the weights in
    ``weights``, at ``world`` ranks (or in this process with world 1)."""
    import torch
    import s4former_tpu_torch.data  # noqa: F401
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.checkpoint import finalize_pending_saves
    from s4former_tpu_torch.core.runner import IterBasedRunner, make_eval_fn
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.models import build_segmentor
    from s4former_tpu_torch.semi.train_step import create_train_state
    cfg = Config.fromfile(cfg_path)
    model = build_segmentor(cfg.model)
    model.load_state_dict(torch.load(weights, weights_only=True))
    runner = IterBasedRunner(
        None, create_train_state(model), None, max_iters=2,
        work_dir=work_dir,
        eval_fn=make_eval_fn(build_dataset(cfg.data['val']), batch_size=2))
    runner._evaluate(2)
    finalize_pending_saves()


def warm_forward(cfg: str):
    """One throwaway forward of the config's model (seeded weights) on the
    CPU in this process. A fresh process's first f32 forward can round
    otherwise than all its later ones: the first parallel regions' CPU
    thread team forms while the forward runs (seen in 5 of 320 cold first
    forwards of the CLI model under the suite's load, differing in the
    first layer's attention block, and at 3 threads without load; in no
    later forward). A test that holds a spawned process's predictions bit
    for bit to another process's warms both first."""
    from s4former_tpu_torch import apis
    seg = apis.init_segmentor(cfg, device='cpu')
    apis.inference_segmentor(seg, np.zeros((64, 64, 3), np.uint8))


def cli_test_worker(rank: int, world: int, argv, out: str):
    """``tools.test --launcher env --device cpu`` at ``world`` ranks, each
    rank warmed first (``warm_forward``); rank 0 writes the returned
    metrics (or None) to ``out`` as JSON."""
    import json
    from s4former_tpu_torch.tools import test as test_cli
    warm_forward(argv[0])
    results = test_cli.main(list(argv) + ['--launcher', 'env', '--device',
                                          'cpu'])
    if rank == 0:
        with open(out, 'w') as f:
            json.dump(results, f)


# ----------------------------------------------- pipeline and ring workers
# spawned gloo ranks of tests/test_torch_pp.py, test_torch_ring_attention.py
# and the ring case of test_torch_cuda.py: the parent writes the cases to
# ``inp`` (torch.save of numpy arrays); each rank writes its results to
# ``out`` + '.rank{r}'
def _layer_stack(state, num_layers: int, c: int, heads: int):
    """A ModuleList of the port's TransformerEncoderLayer loaded from
    ``state`` ('{i}.ln1.weight', ... : the bridge's 'backbone.layers.'
    keys without the prefix)."""
    import torch
    from s4former_tpu_torch.models.backbones.vit import \
        TransformerEncoderLayer
    layers = torch.nn.ModuleList([TransformerEncoderLayer(c, heads, 4 * c)
                                  for _ in range(num_layers)])
    layers.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return layers


def _raises(fn) -> str:
    """The message of the ValueError ``fn()`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ''


def pp_worker(rank: int, world: int, inp: str, out: str):
    """Each case of ``inp`` on its grid ('grid': (data, pipe, model)):
    ``pipeline_apply`` of the port's layers ('kind' 'pp') or
    ``pipeline_apply_tp`` ('tp', 'sp' for sequence parallelism) on the
    whole batch 'x', the loss mean((out - tgt)^2), its backward. A rank
    writes, by case: out, loss, x's gradient, and the whole gradients of
    its stage's layers under the bridge's names (TP pieces gathered over
    the model group), and the ValueErrors of the case's 'errors'."""
    import torch
    from s4former_tpu_torch.parallel import pp
    from s4former_tpu_torch.parallel import tp as tp_mod
    from s4former_tpu_torch.parallel.distributed import (data_size,
                                                         model_size,
                                                         pipe_rank)
    from s4former_tpu_torch.parallel.mesh import (make_pp_mesh,
                                                  make_pp_tp_mesh,
                                                  reset_mesh)
    data = torch.load(inp, weights_only=False)
    results = []
    for case in data['cases']:
        dp, s, mp = case['grid']
        if mp == 1:
            make_pp_mesh(s)
        else:
            make_pp_tp_mesh(s, mp)
        assert data_size() == dp and model_size() == mp
        n, c, heads = data['num_layers'], data['c'], data['heads']
        layers = _layer_stack(data['state'], n, c, heads)
        x = torch.from_numpy(case['x']).requires_grad_()
        tgt = torch.from_numpy(case['tgt'])
        per = n // s
        res = {'errors': {}}
        if case['kind'] == 'pp':
            stage = pp.stage_layers(layers)
            y = pp.pipeline_apply(None, stage, x, case['M'])
            res['errors'] = {
                'layers': _raises(lambda: pp.stage_layers(layers[:-1])),
                'microbatches': _raises(lambda: pp.pipeline_apply(
                    None, stage, x[:-2], case['M']))}
            if dp > 1:          # one row a microbatch, over dp ranks
                res['errors']['data_rows'] = _raises(
                    lambda: pp.pipeline_apply(None, stage, x[:case['M']],
                                              case['M']))
        else:
            sp = case['kind'] == 'sp'
            leaves = pp.tp_stage_leaves(layers)
            stage = pp.stage_layers(layers)
            y = pp.pipeline_apply_tp(leaves, x, case['M'], heads, sp)
            res['errors'] = {
                'heads': _raises(lambda: pp.pipeline_apply_tp(
                    leaves, x, case['M'], heads + 1, sp)),
                'tokens': _raises(lambda: pp.pipeline_apply_tp(
                    leaves, x[:, :mp + 1], case['M'], heads, True)),
                'layers': _raises(lambda: pp.tp_stage_leaves(layers[:-1]))}
        loss = ((y - tgt) ** 2).mean()
        loss.backward()
        grads = {}
        if case['kind'] == 'pp':
            for name, p in stage.named_parameters():
                i, rest = name.split('.', 1)
                grads[f'{pipe_rank() * per + int(i)}.{rest}'] = p.grad
        else:
            plan = tp_mod.ShardPlan(tp_mod.param_specs(
                {k: tuple(p.shape) for k, p in stage.named_parameters()},
                mp), mp, 1)
            for i, leaf in enumerate(leaves):
                for name, short in pp.LEAF_NAMES:
                    grads[f'{pipe_rank() * per + i}.{name}'] = plan.gather(
                        f'{i}.{name}', leaf[short].grad)
        res.update(out=y.detach().numpy(), loss=float(loss),
                   x_grad=x.grad.numpy(),
                   grads={k: g.detach().numpy() for k, g in grads.items()})
        results.append(res)
        reset_mesh()
    torch.save(results, f'{out}.rank{rank}')


def ring_worker(rank: int, world: int, inp: str, out: str):
    """Each case of ``inp``: a (data, ctx) grid of rings of 'cp' ranks,
    ``ring_attention_sharded`` of the whole q, k, v (and 'bias') on
    'device', and the backward of ``sum(o * do)`` (whose gradients are the
    vjp of ``do``). A rank writes, by case: o, dq, dk, dv, the launches
    of kernels #1-#4 in the call and the ValueError of a length the ring
    does not divide."""
    import torch
    from s4former_tpu_torch.ops import flash_attention as fa
    from s4former_tpu_torch.parallel.mesh import make_cp_mesh, reset_mesh
    from s4former_tpu_torch.parallel.ring_attention import \
        ring_attention_sharded
    data = torch.load(inp, weights_only=False)
    results = []
    for case in data['cases']:
        make_cp_mesh(case['cp'])
        dev = torch.device(case.get('device', 'cpu'))
        dtype = getattr(torch, case.get('dtype', 'float32'))
        q, k, v, do = (torch.from_numpy(case[n]).to(dev, dtype)
                       for n in ('q', 'k', 'v', 'do'))
        bias = None if case['bias'] is None else \
            torch.from_numpy(case['bias']).to(dev, dtype)
        for t in (q, k, v):
            t.requires_grad_()
        before = (fa.launch_count, fa.fused_launch_count,
                  fa.dkv_launch_count, fa.dq_launch_count)
        o = ring_attention_sharded(q, k, v, bias)
        (o.float() * do.float()).sum().backward()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        after = (fa.launch_count, fa.fused_launch_count,
                 fa.dkv_launch_count, fa.dq_launch_count)
        results.append({
            'o': o.detach().float().cpu().numpy(),
            'grads': [t.grad.float().cpu().numpy() for t in (q, k, v)],
            'launches': [a - b for a, b in zip(after, before)],
            'length_error': _raises(lambda: ring_attention_sharded(
                q[:, :-1], k[:, :-1], v[:, :-1]))})
        reset_mesh()
    torch.save(results, f'{out}.rank{rank}')
