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


def jax_train_model(seed: int = 0, ema: bool = True):
    """(JAX model, JAX TrainState) of TRAIN_MODEL with perturbed weights;
    the EMA teacher gets weights of its own. The JAX side runs its XLA
    attention (its Pallas kernels are held to the port in test_torch_ops)."""
    import copy
    import jax
    import jax.numpy as jnp
    from s4former_tpu.models import build_segmentor, init_segmentor_variables
    from s4former_tpu.semi.train_step import create_train_state
    cfg = copy.deepcopy(TRAIN_MODEL)
    cfg['backbone']['use_flash'] = False
    model = build_segmentor(cfg)
    variables = init_segmentor_variables(model, jax.random.PRNGKey(seed),
                                         (1, 64, 64, 3))
    student = perturbed({'params': variables['params'],
                         'batch_stats': variables['batch_stats']}, seed)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, student),
                               ema=ema)
    if ema:
        teacher = perturbed(student, seed + 1, std=0.05)
        state = state.replace(
            ema_params=jax.tree_util.tree_map(jnp.asarray, teacher['params']),
            ema_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                   teacher['batch_stats']))
    return model, state


def torch_train_model():
    """The port's TRAIN_MODEL (weights to be loaded through the bridge)."""
    import copy
    import s4former_tpu_torch.models  # noqa: F401
    from s4former_tpu_torch.models import build_segmentor
    return build_segmentor(copy.deepcopy(TRAIN_MODEL))


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
