"""Guards of the port: it imports nothing of JAX or the JAX package, and
chip_smoke.py fails (without its result line) where there is no card or no
port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'orbax', 's4former_tpu')


def _port_files():
    return sorted((REPO / 's4former_tpu_torch').rglob('*.py')) + \
        [REPO / 'chip_smoke.py']


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    # the host runtime, the profiler's reader, the test CLI's modules, the
    # SegFormer slice's, the ablation slice's, the UniMatch slice's, the
    # data-parallel slice's, the eval-and-tools slice's (the tools and the
    # demo package), the pipeline- and context-parallel slice's, the
    # model zoo's, the CNN slice's and the context heads' (MobileNetV2,
    # the Encoding layer) are among the files read
    assert {'native/__init__.py', 'native/build.py', 'core/hooks.py',
            'tools/profile_trace.py', 'utils/palette.py',
            'utils/collect_env.py', 'tools/test.py',
            'models/backbones/mit.py', 'models/decode_heads/segformer.py',
            'semi/pasa.py', 'models/dropout.py', 'models/backbones/vit.py',
            'models/decode_heads/setr_up.py',
            'models/losses/cross_entropy.py', 'core/optim.py',
            'semi/ema.py', 'semi/mixes.py', 'semi/train_step.py',
            'tools/train.py', 'semi/unimatch.py',
            'data/pipelines/extra_transforms.py',
            'data/datasets/custom.py', 'data/loader.py',
            'parallel/distributed.py', 'parallel/mesh.py',
            'parallel/pp.py', 'parallel/ring_attention.py',
            'core/runner.py', 'apis.py', 'ops/resize.py',
            'tools/print_config.py', 'tools/publish_model.py',
            'tools/ensemble_test.py', 'tools/benchmark.py',
            'tools/get_flops.py', 'tools/per_image_eval.py',
            'tools/measure_eval_divergence.py', 'demo/__init__.py',
            'demo/image_demo.py', 'demo/video_demo.py',
            'models/necks/necks.py', 'models/decode_heads/misc_heads.py',
            'models/decode_heads/zoo_heads.py',
            'models/decode_heads/extra_heads.py',
            'models/backbones/resnet.py', 'models/backbones/cnn_zoo.py',
            'models/decode_heads/base.py', 'models/backbones/mobilenet.py',
            'ops/encoding.py'} <= {
        str(p.relative_to(REPO / 's4former_tpu_torch')) for p in files
        if REPO / 's4former_tpu_torch' in p.parents}
    bad = [(str(p.relative_to(REPO)), m) for p in files
           for m in _imported_modules(p)
           if m.split('.')[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Here torch has no CUDA: the script must exit nonzero and print no
    result, in the repo and copied into a directory of its own."""
    script = REPO / 'chip_smoke.py'
    if where == 'alone':
        script = Path(shutil.copy(script, tmp_path / 'chip_smoke.py'))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# the arguments each entry point that runs a model is given; the device
# check comes before any file is read
_NO_CARD_ARGS = {
    'tools.train': ['CFG', '--work-dir', 'WD'],
    'tools.test': ['CFG'],
    'tools.benchmark': ['CFG'],
    'tools.ensemble_test': ['CFG', 'missing_a', 'missing_b'],
    'tools.get_flops': ['CFG'],
    'tools.per_image_eval': ['CFG', 'missing'],
    'tools.measure_eval_divergence': ['CFG', 'missing'],
    'demo.image_demo': ['missing.jpg', 'CFG', '--out', 'WD/out.png'],
}


@pytest.mark.parametrize('tool', ['train', 'test', 'benchmark',
                                  'ensemble_test', 'get_flops',
                                  'per_image_eval', 'measure_eval_divergence',
                                  'image_demo'])
def test_cli_fails_without_a_card(tmp_path, tool):
    """``python -m s4former_tpu_torch.{tools,demo}.<tool>`` without
    ``--device cpu`` (or ``--cpu``) exits nonzero where torch finds no CUDA
    device."""
    cfg = REPO / 'configs' / 'setr' / 'setr_fixture_voc_mini_tiny.py'
    module = f'demo.{tool}' if tool == 'image_demo' else f'tools.{tool}'
    args = [a.replace('CFG', str(cfg)).replace('WD', str(tmp_path))
            for a in _NO_CARD_ARGS[module]]
    argv = [sys.executable, '-m', f's4former_tpu_torch.{module}'] + args
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=120,
                          env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode != 0
    assert 'no CUDA device' in proc.stderr
    assert not any(tmp_path.iterdir())       # failed before any work


def test_every_training_flag_builds_and_runs():
    """Every semi flag of the JAX step is accepted by the port's train
    step, UniMatch included, which runs a step on its six unsup views; the
    layer-wise LR decay and the models' dropout, drop path, fdrop and head
    dropout are accepted and run."""
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    from tests._torch_port import torch_train_model
    model = torch_train_model()
    kw = dict(num_classes=5, base_lr=0.01, max_iters=100)
    step = make_semi_train_step(model, SemiConfig(
        unimatch=True, ema=True, unsup_weight=1.0), **kw)
    rs = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rs.randn(2, 64, 64, 3).astype(np.float32))
             for k in ('sup_img', 'unsup_teacher_img', 'unsup_student_img',
                       'unsup_student_2_img', 'unsup_teacher_mix_img',
                       'unsup_student_mix_img', 'unsup_student_2_mix_img')}
    batch['sup_gt'] = torch.from_numpy(rs.randint(0, 5, (2, 64, 64)))
    state, logs = step(create_train_state(model, ema=True), batch,
                       torch.Generator().manual_seed(0))
    assert int(state.step) == 1
    assert {'unsup.loss_seg_unsup_fdrop', 'unsup.loss_seg_unsup_1',
            'unsup.loss_seg_unsup_2'} <= set(logs)
    flags = [dict(use_fdrop=True),
             dict(attn_mask_w_fdrop=True), dict(use_ClassMix=True),
             dict(use_CutOut=True), dict(use_CutMix=True),
             dict(use_PatchShuffle=True),
             dict(use_PatchShuffle_w_Classmix=True),
             dict(mix_with_labeled=True), dict(use_cutmix_adaptive=True),
             dict(sup_cutmix=True), dict(sup_ClassMix=True),
             dict(sup_ema=True), dict(momentum_head_dropout=0.5),
             dict(negative_class_ranking=True,
                  negative_class_ranking_mode='sup_only'),
             dict(negative_class_ranking=True,
                  negative_class_ranking_mode='both')]
    for flag in flags:
        make_semi_train_step(model, SemiConfig(**flag), **kw)
    make_semi_train_step(model, SemiConfig(), **kw,
                         paramwise_cfg=dict(num_layers=2, decay_rate=0.9))
    # the flagship's flags are accepted
    make_semi_train_step(model, SemiConfig(
        ema=True, attn_mask_seperate_head=True, adaptive_attn_mask=True,
        use_PatchShuffle_w_Cutmix=True, negative_class_ranking=True,
        negative_class_ranking_mode='unsup_only'), **kw)
    # dropout, drop-path and fdrop in the models: identities in eval (fdrop
    # aside), drawn from the generator in train
    x = torch.zeros(1, 64, 64, 3)
    gen = torch.Generator().manual_seed(0)
    model.forward_decode_from_img(x, use_fdrop=True, generator=gen)
    for rate in ('drop_rate', 'attn_drop_rate', 'drop_path_rate'):
        setattr(model.backbone, rate, 0.1)
        model.forward_decode_from_img(x, train=False)
        model.forward_decode_from_img(x, train=True, generator=gen)
        setattr(model.backbone, rate, 0.0)
    model.decode_head.dropout_ratio = 0.1
    model.forward_decode_from_img(x, train=True, generator=gen)
