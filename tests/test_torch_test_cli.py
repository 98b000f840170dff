"""The rest of ``tools.test`` and the profiler, on the CPU, in f32.

- ``apis.inference_segmentor_tta`` against the JAX one (six ratios and
  flip) on a tiny model: averaged probabilities within 1e-4, labels equal
  wherever their top-2 margin is wider.
- ``tools.test --show-dir`` and ``--format-only`` against the JAX
  ``tools/test.py`` on the CLI fixture, from one ``.pth``: the same PNGs
  (painted results; Cityscapes label-id files) and the same mIoU;
  ``--aug-test`` evaluates, dumps and paints the TTA labels.
- ``utils.palette`` and ``core.class_names.get_palette`` against the JAX
  package's; ``utils.collect_env`` names torch and the cards.
- ``core.hooks.profile_steps``, ``tools.train --profile`` and the trace
  reader ``tools/profile_trace.py`` (on a canned trace, and on a trace of
  the CPU run).
"""
import importlib.util
import json
import os
import os.path as osp
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from s4former_tpu import apis as japis
from s4former_tpu.core import class_names as j_class_names
from s4former_tpu.core.checkpoint import export_reference_state_dict
from s4former_tpu.models.segmentors.inference import inference as j_inference
from s4former_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from s4former_tpu.utils.palette import paint_result as j_paint_result
from s4former_tpu_torch import apis
from s4former_tpu_torch.core import class_names
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.core.hooks import profile_steps
from s4former_tpu_torch.tools import profile_trace
from s4former_tpu_torch.tools import test as test_cli
from s4former_tpu_torch.tools import train as train_cli
from s4former_tpu_torch.utils.collect_env import collect_env
from s4former_tpu_torch.utils.palette import paint_result
from tests._torch_port import (FIXTURE, assert_argmax_agrees, jax_variables,
                               write_cli_config, write_tiny_config)

REPO = Path(__file__).resolve().parents[1]
# probabilities in f32 on both sides (sums in another order)
ATOL = 1e-4
# label maps from two f32 forwards: a pixel whose top-2 probabilities lie
# within the f32 error may take the other label
MAX_FLIPPED = 1e-4
METRIC_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _xla_attention(cfg: str) -> str:
    """A copy of config ``cfg`` whose JAX ViT runs XLA attention: the
    eager TTA forwards would run the Pallas kernel in interpret mode
    (held to the port's kernels in test_torch_ops), seconds a forward."""
    path = cfg.replace('.py', '_xla.py')
    text = open(cfg).read()
    anchor = 'out_indices=(0, 1)'
    assert text.count(anchor) == 1
    with open(path, 'w') as f:
        f.write(text.replace(anchor, anchor + ', use_flash=False'))
    return path


def test_tta_matches_jax(tmp_path):
    cfg = write_tiny_config(tmp_path)
    js = japis.init_segmentor(_xla_attention(cfg))
    variables = jax_variables(js, seed=5)
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    seg = apis.init_segmentor(cfg, device='cpu')
    seg.model.load_state_dict(state_dict_from_jax_variables(variables))
    img = _image(2, 50, 70)
    # the JAX function's sum (apis.py:167-192), before its argmax; its
    # forward jitted (one compile a shape, not one an op)
    apply_fn = jax.jit(js.apply_fn)
    total = 0.0
    for r in apis.TTA_RATIOS:
        scaled = np.asarray(Image.fromarray(img).resize(
            (max(1, int(70 * r)), max(1, int(50 * r))), Image.BILINEAR))
        x, (sh, sw) = japis._prepare_image(js, scaled)
        p = np.asarray(j_inference(apply_fn, jnp.asarray(x), 5,
                                   mode='whole', crop_size=js.crop_size,
                                   flip=True))[0][:sh, :sw]
        total = total + np.asarray(j_resize_bilinear(
            jnp.asarray(p)[None], (50, 70), False))[0]
    ref = total / len(apis.TTA_RATIOS)
    got = apis.tta_probs(seg, img).numpy()
    assert got.shape == (50, 70, 5)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    labels = apis.inference_segmentor_tta(seg, img)
    assert labels.dtype == np.int32 and labels.shape == (50, 70)
    assert_argmax_agrees(ref, got, ATOL)
    # the JAX function's labels are the argmax of its sum
    sure = np.diff(np.sort(ref, -1)[..., -2:], axis=-1)[..., 0] > ATOL
    np.testing.assert_array_equal(labels[sure], ref.argmax(-1)[sure])


def _jax_test_cli(argv, capsys):
    """Run the JAX package's ``tools/test.py`` in this process; returns
    what it printed."""
    spec = importlib.util.spec_from_file_location(
        'jax_tools_test', REPO / 'tools' / 'test.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    old = sys.argv
    sys.argv = ['tools/test.py'] + argv
    try:
        capsys.readouterr()
        module.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _pngs(directory):
    return {n: np.asarray(Image.open(osp.join(directory, n)))
            for n in sorted(os.listdir(directory))}


@pytest.fixture(scope='module')
def cli_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp('cli')
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:2]
    split = d / 'val_2.txt'
    split.write_text('\n'.join(stems) + '\n')
    cfg = write_cli_config(d, str(split))
    j_cfg = _xla_attention(cfg)
    js = japis.init_segmentor(j_cfg)
    pth = str(d / 'cli.pth')
    export_reference_state_dict(jax_variables(js, seed=6), path=pth)
    return SimpleNamespace(dir=d, cfg=cfg, j_cfg=j_cfg, pth=pth,
                           stems=stems)


_CITYSCAPES = ['--cfg-options', 'data.test.type=CityscapesDataset',
               'data.test.img_suffix=.jpg', 'data.test.seg_map_suffix=.png']


@pytest.mark.parametrize('flags', ['show_dir', 'format_only'])
def test_cli_writes_the_same_files_as_jax(cli_setup, flags, capsys):
    s = cli_setup
    out = {pkg: str(s.dir / f'{flags}_{pkg}') for pkg in ('jax', 'port')}
    if flags == 'show_dir':
        args = {pkg: ['--show-dir', out[pkg]] for pkg in out}
    else:
        args = {pkg: ['--format-only', '--imgfile-prefix', out[pkg]] +
                _CITYSCAPES for pkg in out}
    printed = _jax_test_cli([s.j_cfg, s.pth] + args['jax'], capsys)
    results = test_cli.main([s.cfg, s.pth, '--device', 'cpu'] +
                            args['port'])
    want, got = _pngs(out['jax']), _pngs(out['port'])
    assert sorted(got) == sorted(want) == sorted(
        f'{stem}.png' for stem in s.stems)
    for name in want:
        assert got[name].shape == want[name].shape
        flipped = (got[name] != want[name]).reshape(
            got[name].shape[0], got[name].shape[1], -1).any(-1).mean()
        assert flipped <= MAX_FLIPPED, (name, flipped)
    if flags == 'format_only':
        assert results is None
        for name in want:
            palette = Image.open(osp.join(out['port'], name)).getpalette()
            assert palette == Image.open(
                osp.join(out['jax'], name)).getpalette()
            assert set(np.unique(got[name])) <= {0, 7, 8, 11, 12, 13, 17,
                                                 19, 20, 21, 22, 23, 24, 25,
                                                 26, 27, 28, 31, 32, 33}
    else:
        j_miou = eval(printed.strip().splitlines()[-1])['mIoU']
        assert abs(round(results['mIoU'], 4) - j_miou) <= METRIC_TOL


def test_aug_test_cli_evaluates_the_tta_labels(cli_setup):
    """``--aug-test``: each test image through inference_segmentor_tta
    (held to the JAX function above), its labels evaluated, dumped and
    painted."""
    import pickle
    from s4former_tpu_torch.data import build_dataset
    s = cli_setup
    vis, out = s.dir / 'aug_vis', s.dir / 'aug.pkl'
    results = test_cli.main([s.cfg, s.pth, '--device', 'cpu', '--aug-test',
                             '--show-dir', str(vis), '--out', str(out)])
    with open(out, 'rb') as f:
        dumped = pickle.load(f)
    seg = apis.init_segmentor(s.cfg, checkpoint=s.pth, device='cpu')
    dataset = build_dataset(seg.cfg.data['test'])
    pre = [r for idx, labels in enumerate(dumped)
           for r in dataset.pre_eval([labels.astype(np.int32)], [idx])]
    assert results['mIoU'] == dataset.evaluate(pre)['mIoU']
    assert np.isfinite(results['mIoU'])
    path = dataset.img_infos[0]['filename']
    labels = apis.inference_segmentor_tta(seg, path)
    np.testing.assert_array_equal(dumped[0], labels.astype(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(Image.open(vis / f'{s.stems[0]}.png')),
        paint_result(path, labels, dataset.PALETTE))


def test_format_only_needs_a_submission_format(cli_setup):
    with pytest.raises(NotImplementedError, match='submission format'):
        test_cli.main([cli_setup.cfg, cli_setup.pth, '--device', 'cpu',
                       '--format-only', '--imgfile-prefix',
                       str(cli_setup.dir / 'voc')])


def test_paint_result_and_palettes_match_jax():
    img = _image(3, 40, 56)
    seg = np.random.RandomState(4).randint(0, 21, (40, 56))
    for name in ('voc', 'cityscapes'):
        assert class_names.get_palette(name) == \
            j_class_names.get_palette(name)
    pal = class_names.get_palette('voc')
    np.testing.assert_array_equal(paint_result(img, seg, pal, 0.5),
                                  j_paint_result(img, seg, pal, 0.5))
    small = _image(5, 20, 28)        # resized to the label map first
    np.testing.assert_array_equal(paint_result(small, seg, pal, 0.3),
                                  j_paint_result(small, seg, pal, 0.3))


def test_collect_env_names_torch_and_the_cards():
    info = collect_env()
    assert info['torch'] == torch.__version__
    assert info['GPUs'] == 'none'          # no card in this process
    assert 's4former_tpu_torch' in info and 'nvcc' in info


CANNED = [
    {'ph': 'M', 'name': 'thread_name', 'pid': 1, 'tid': 10,
     'args': {'name': 'main'}},
    {'ph': 'M', 'name': 'thread_name', 'pid': 1, 'tid': 11,
     'args': {'name': 'loader'}},
    {'ph': 'M', 'name': 'thread_name', 'pid': 1, 'tid': 12,
     'args': {'name': 'autograd'}},
    {'ph': 'X', 'cat': 'Trace', 'name': 'window', 'pid': 1, 'tid': 10,
     'ts': 0.0, 'dur': 10000.0},
    # the forward's thread: ops at 0-1000 and 1500-2000 us (an op nested
    # in the first), two launches, and 8000-9000
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'pid': 1, 'tid': 10,
     'ts': 0.0, 'dur': 1000.0},
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::empty', 'pid': 1, 'tid': 10,
     'ts': 100.0, 'dur': 50.0},
    {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
     'pid': 1, 'tid': 10, 'ts': 900.0, 'dur': 50.0},
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'pid': 1, 'tid': 10,
     'ts': 1500.0, 'dur': 500.0},
    {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
     'pid': 1, 'tid': 10, 'ts': 1900.0, 'dur': 50.0},
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::sum', 'pid': 1, 'tid': 10,
     'ts': 8000.0, 'dur': 1000.0},
    # the backward's thread: one op with a launch at 3000-4000
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'MmBackward0', 'pid': 1,
     'tid': 12, 'ts': 3000.0, 'dur': 1000.0},
    {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cuLaunchKernel', 'pid': 1,
     'tid': 12, 'ts': 3500.0, 'dur': 50.0},
    # a thread that launches nothing
    {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::copy_', 'pid': 1,
     'tid': 11, 'ts': 0.0, 'dur': 3000.0},
    # device: two kernels overlapping (1000-3000 busy) and a copy
    {'ph': 'X', 'cat': 'kernel', 'name': 'gemm', 'pid': 0, 'tid': 7,
     'ts': 1000.0, 'dur': 1500.0},
    {'ph': 'X', 'cat': 'kernel', 'name': 'add', 'pid': 0, 'tid': 8,
     'ts': 2000.0, 'dur': 1000.0},
    {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'pid': 0,
     'tid': 9, 'ts': 5000.0, 'dur': 1000.0},
]


def test_trace_reader_on_a_canned_trace(tmp_path):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': CANNED}))
    s = profile_trace.main([str(tmp_path), '--steps', '2'])
    assert s['wall_ms'] == pytest.approx(5.0)            # 10 ms / 2 steps
    assert s['device_busy_ms'] == pytest.approx(1.5)     # 3 ms / 2
    assert s['device_busy_share'] == pytest.approx(0.3)
    assert s['device_ms'] == pytest.approx(1.75)         # 3.5 ms / 2
    assert [op['name'] for op in s['device_ops']] == ['gemm', 'add',
                                                      'Memcpy HtoD']
    d = s['dispatch']
    # main and autograd launch; their calls: 0-1000, 1500-2000,
    # 3000-4000, 8000-9000; gaps 500, 1000, 4000 us
    assert d['threads'] == ['main', 'autograd'] and d['launches'] == 1.5
    assert d['busy_ms'] == pytest.approx(1.75)           # 3.5 ms / 2
    assert d['idle_ms'] == pytest.approx(3.25)
    assert d['gap_max_ms'] == pytest.approx(4.0)
    assert d['gaps_over_1ms'] == 0.5 and d['gaps'] == 1.5
    assert d['gap_p50_us'] == pytest.approx(1000.0)
    threads = {t['thread']: t for t in s['threads']}
    assert threads['loader']['op_ms'] == pytest.approx(1.5)
    assert not threads['loader']['dispatch']
    assert threads['main']['op_calls'] == 1.5            # 3 top-level
    assert threads['main']['op_mean_us'] == pytest.approx(2500 / 3)
    assert 'dispatching threads main, autograd' in profile_trace.report(s)


def test_profile_steps_traces_after_a_warm_up(tmp_path):
    calls = []

    def step_fn(state, batch, gen):
        calls.append(torch.rand((), generator=gen).item())
        return SimpleNamespace(step=state.step + 1,
                               w=state.w @ batch['x']), {}

    state = SimpleNamespace(step=torch.zeros((), dtype=torch.int64),
                            w=torch.eye(8))
    out = profile_steps(step_fn, state, {'x': torch.eye(8) * 2},
                        torch.Generator().manual_seed(0), str(tmp_path), 3)
    assert int(out.step) == 4 and len(calls) == 4 and len(set(calls)) == 4
    s = profile_trace.analyze(profile_trace.load_events(str(tmp_path)), 3)
    assert s['dispatch']['busy_ms'] > 0
    names = {e.get('name') for e in
             profile_trace.load_events(str(tmp_path))}
    assert 'aten::mm' in names


def test_train_cli_traces_a_window(tmp_path):
    cfg = write_cli_config(tmp_path, str(tmp_path / 'unused.txt'))
    wd = tmp_path / 'w'
    state = train_cli.main([cfg, '--work-dir', str(wd), '--device', 'cpu',
                            '--no-validate', '--max-iters', '2',
                            '--profile', '2', '1'])
    assert int(state.step) == 2
    s = profile_trace.main([str(wd / 'profile')])
    assert s['device_ms'] == 0.0                          # no card here
    assert s['dispatch']['busy_ms'] > 0
    log = ''.join(p.read_text() for p in wd.glob('*.log'))
    assert 'traced steps 2-2' in log and 'torch: ' in log
