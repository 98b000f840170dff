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
    # the host runtime, the profiler's reader, the test CLI's modules and
    # the SegFormer slice's are among the files read
    assert {'native/__init__.py', 'native/build.py', 'core/hooks.py',
            'tools/profile_trace.py', 'utils/palette.py',
            'utils/collect_env.py', 'tools/test.py',
            'models/backbones/mit.py', 'models/decode_heads/segformer.py',
            'semi/pasa.py'} <= {
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


@pytest.mark.parametrize('tool', ['train', 'test'])
def test_cli_fails_without_a_card(tmp_path, tool):
    """``python -m s4former_tpu_torch.tools.{train,test}`` without
    ``--device cpu`` exits nonzero where torch finds no CUDA device."""
    cfg = REPO / 'configs' / 'setr' / 'setr_fixture_voc_mini_tiny.py'
    argv = [sys.executable, '-m', f's4former_tpu_torch.tools.{tool}',
            str(cfg)] + (['--work-dir', str(tmp_path)] if tool == 'train'
                         else [])
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=120,
                          env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode != 0
    assert 'no CUDA device' in proc.stderr
    assert not any(tmp_path.iterdir())       # failed before any work


def test_unported_training_flags_raise():
    """Every semi flag and option the port's train step does not run raises
    NotImplementedError when the step is made; none is ignored."""
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import make_semi_train_step
    from tests._torch_port import torch_train_model
    model = torch_train_model()
    kw = dict(num_classes=5, base_lr=0.01, max_iters=100)
    flags = [dict(unimatch=True), dict(use_fdrop=True),
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
        with pytest.raises(NotImplementedError):
            make_semi_train_step(model, SemiConfig(**flag), **kw)
    with pytest.raises(NotImplementedError, match='paramwise'):
        make_semi_train_step(model, SemiConfig(), **kw,
                             paramwise_cfg=dict(num_layers=2, decay_rate=0.9))
    # the flagship's flags are accepted
    make_semi_train_step(model, SemiConfig(
        ema=True, attn_mask_seperate_head=True, adaptive_attn_mask=True,
        use_PatchShuffle_w_Cutmix=True, negative_class_ranking=True,
        negative_class_ranking_mode='unsup_only'), **kw)
    # dropout, drop-path and fdrop in the models
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(NotImplementedError, match='use_fdrop'):
        model.forward_decode_from_img(x, use_fdrop=True)
    for rate in ('drop_rate', 'attn_drop_rate', 'drop_path_rate'):
        model.backbone.drop_rates[rate] = 0.1
        model.forward_decode_from_img(x, train=False)   # identity in eval
        with pytest.raises(NotImplementedError, match=rate):
            model.forward_decode_from_img(x, train=True)
        model.backbone.drop_rates[rate] = 0.0
    model.decode_head.dropout_ratio = 0.1
    with pytest.raises(NotImplementedError, match='dropout_ratio'):
        model.forward_decode_from_img(x, train=True)
