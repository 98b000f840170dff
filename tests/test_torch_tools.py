"""The port's tools and demos on the CPU, in f32, against the JAX package's
(the root ``tools/`` and ``demo/`` scripts run in this process) on the same
numpy inputs and weights (the port's seeded weights, which the JAX
package loads from a reference-layout ``.pth``): the CLI fixture config of
tests/_torch_port.py (a 2-layer ViT of 64, 21 classes, test images at
keep-ratio (96, 64)); the JAX ViT runs its Pallas kernel in interpret
mode. Tolerances are stated where a test holds one.

- ``tools.test --launcher env`` on 2 gloo ranks: one process's metrics
  exactly, the same ``--show-dir`` PNGs, ``--out`` pickle and
  ``--format-only`` files, byte for byte; exact path and ``--aug-test``.
- ``tools.print_config``: the JAX tool's text.
- ``tools.publish_model --to-pth``: the ``.pth`` equals JAX
  ``export_reference_state_dict`` of the same variables, key for key and
  value for value; the published name is the same on a second run; the
  published directory and ``.pth`` evaluate as the checkpoint.
- ``tools.ensemble_test``: probabilities within 1e-4 of the JAX mean of
  ``inference`` over two variable sets; the JAX tool's metrics.
- ``tools.per_image_eval`` and ``tools.measure_eval_divergence``: the JAX
  tools' JSON lines (at bucket 16, agreement 1 and ΔmIoU 0).
- ``tools.get_flops``: an analytic count of the tiny model's products.
- ``tools.benchmark``: the line, and a trace ``tools.profile_trace`` reads.
- ``demo.image_demo`` and ``demo.video_demo`` (a stub ``cv2``): the JAX
  demos' files; without ``cv2`` both raise ImportError.
- ``dist_test.sh``, ``slurm_train.sh``, ``slurm_test.sh`` (and
  ``dist_train.sh``): the command they run, through stub ``python`` and
  ``srun`` programs that print their arguments.
"""
import importlib.util
import json
import os
import os.path as osp
import pickle
import re
import subprocess
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
from s4former_tpu.core.checkpoint import export_reference_state_dict
from s4former_tpu.models.segmentors.inference import inference as j_inference
from s4former_tpu_torch import apis
from s4former_tpu_torch.core.checkpoint import (save_checkpoint,
                                                state_dict_from_jax_variables)
from s4former_tpu_torch.data import build_dataset
from s4former_tpu_torch.demo import image_demo, video_demo
from s4former_tpu_torch.semi.train_step import create_train_state
from s4former_tpu_torch.tools import (benchmark, ensemble_test, get_flops,
                                      measure_eval_divergence,
                                      per_image_eval, print_config,
                                      profile_trace, publish_model)
from s4former_tpu_torch.tools import test as test_cli
from tests._stub_cv2 import StubCv2
from tests._torch_port import (FIXTURE, cli_test_worker, jax_variables,
                               run_ranks, warm_forward, write_cli_config)

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / 's4former_tpu_torch' / 'tools'
N_VAL = 5          # in groups of 4: rank 0 predicts 4 images, rank 1 one
# probabilities of two f32 forwards (sums in another order)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def tools_setup(tmp_path_factory):
    """The CLI config on 5 val images; two sets of seeded weights of the
    port's model (predictions of many classes an image), each as a
    training checkpoint directory of the port's runner and as a
    reference-layout ``.pth``, and the JAX package's variables loaded from
    that ``.pth``."""
    d = tmp_path_factory.mktemp('tools')
    with open(osp.join(FIXTURE, 'datasplits', 'fixture', 'val.txt')) as f:
        stems = [s for s in f.read().split() if s][:N_VAL]
    split = d / 'val.txt'
    split.write_text('\n'.join(stems) + '\n')
    cfg = write_cli_config(d, str(split))
    variables, pths, ckpts = [], [], []
    for seed in (0, 1):
        seg = apis.init_segmentor(cfg, seed=seed, device='cpu')
        ckpts.append(save_checkpoint(str(d / f'run{seed}'), 6,
                                     create_train_state(seg.model, ema=True)))
        pths.append(str(d / f'w{seed}.pth'))
        torch.save({'state_dict': seg.model.state_dict()}, pths[-1])
        js = japis.init_segmentor(cfg, pths[-1])
        variables.append(jax.tree_util.tree_map(
            np.asarray, {'params': js.variables['params'],
                         'batch_stats': js.variables['batch_stats']}))
    return SimpleNamespace(dir=d, cfg=cfg, js=js, variables=variables,
                           pths=pths, ckpts=ckpts, stems=stems)


def _jax_tool(path, argv, capsys):
    """Run a root JAX script's ``main`` in this process; returns what it
    printed."""
    spec = importlib.util.spec_from_file_location(
        'jax_' + Path(path).stem, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    old = sys.argv
    sys.argv = [path] + argv
    try:
        capsys.readouterr()
        module.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def _files(directory):
    return {n: (Path(directory) / n).read_bytes()
            for n in sorted(os.listdir(directory))}


# ------------------------------------------------------ tools.test, ranks
_CITYSCAPES = ['--cfg-options', 'data.test.type=CityscapesDataset',
               'data.test.img_suffix=.jpg', 'data.test.seg_map_suffix=.png']


@pytest.mark.parametrize('case', ['exact', 'aug_test', 'format_only'])
def test_test_cli_on_two_ranks_equals_one_process(tools_setup, case):
    s = tools_setup
    base = s.dir / f'ranks_{case}'
    runs = {}
    for world in (1, 2):
        out = base / f'w{world}'
        out.mkdir(parents=True)
        if case == 'format_only':
            flags = ['--format-only', '--imgfile-prefix', str(out / 'fmt')] \
                + _CITYSCAPES
        else:
            flags = ['--show-dir', str(out / 'vis'), '--out',
                     str(out / 'preds.pkl')] + \
                (['--aug-test'] if case == 'aug_test' else [])
        argv = [s.cfg, s.ckpts[0]] + flags
        if world == 1:
            warm_forward(s.cfg)       # as each rank is (cli_test_worker)
            runs[world] = test_cli.main(argv + ['--device', 'cpu'])
        else:
            run_ranks(cli_test_worker, 2, argv, str(out / 'metrics.json'),
                      init=False)
            with open(out / 'metrics.json') as f:
                runs[world] = json.load(f)
    one, two = base / 'w1', base / 'w2'
    if case == 'format_only':
        assert runs[1] is None and runs[2] is None
        got = _files(two / 'fmt')
        assert sorted(got) == [f'{stem}.png' for stem in s.stems]
        assert got == _files(one / 'fmt')
        return
    np.testing.assert_equal(runs[2], runs[1])     # metrics, exactly
    assert 0 < runs[1]['aAcc'] < 1
    got = _files(two / 'vis')
    assert sorted(got) == [f'{stem}.png' for stem in s.stems]
    assert got == _files(one / 'vis')
    assert (two / 'preds.pkl').read_bytes() == \
        (one / 'preds.pkl').read_bytes()
    with open(one / 'preds.pkl', 'rb') as f:
        assert len(pickle.load(f)) == N_VAL


# ------------------------------------------------------------- the tools
@pytest.mark.parametrize('which', ['cli', 'fullflag_options'])
def test_print_config_matches_jax(tools_setup, capsys, which):
    if which == 'cli':
        argv = [tools_setup.cfg]
    else:
        argv = [str(REPO / 'configs' / 'setr' /
                    'setr_fixture_voc_mini_fullflag.py'),
                '--cfg-options', 'optimizer.lr=0.5', 'runner.max_iters=7']
    want = _jax_tool('tools/print_config.py', argv, capsys)
    text = print_config.main(argv)
    assert capsys.readouterr().out == want
    assert want.startswith('Config:\n') and text + '\n' == want
    if which != 'cli':
        assert 'lr=0.5' in text and 'max_iters=7' in text


def test_publish_model_matches_the_jax_export(tools_setup, capsys):
    s = tools_setup
    out, pth = publish_model.main([s.ckpts[0], str(s.dir / 'pub'),
                                   '--to-pth'])
    again, _ = publish_model.main([s.ckpts[0], str(s.dir / 'pub'),
                                   '--to-pth'])
    assert again == out and re.fullmatch(r'.*/pub-[0-9a-f]{8}', out)
    assert sorted(os.listdir(s.dir)).count(osp.basename(out)) == 1
    assert not osp.exists(out + '.tmp')
    # the student alone: no SGD buffers, no EMA teacher, no step
    raw = torch.load(osp.join(out, 'state.pt'), weights_only=True)
    assert sorted(raw) == ['model']
    # the .pth: JAX's export of the same variables, key for key
    want = export_reference_state_dict(s.variables[0])
    got = torch.load(pth, weights_only=True)
    assert got['meta'] == {'exported_by': 's4former_tpu_torch'}
    assert list(got['state_dict']) == list(raw['model'])
    assert sorted(got['state_dict']) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got['state_dict'][k].numpy(),
                                      np.asarray(v), err_msg=k)
    # the published directory and .pth evaluate as the checkpoint does
    capsys.readouterr()
    metrics = [test_cli.main([s.cfg, c, '--device', 'cpu'])
               for c in (s.ckpts[0], out, pth)]
    np.testing.assert_equal(metrics[1], metrics[0])
    np.testing.assert_equal(metrics[2], metrics[0])
    assert metrics[0]['aAcc'] > 0.02


def test_ensemble_matches_jax(tools_setup, capsys):
    s = tools_setup
    js = [japis.init_segmentor(s.cfg) for _ in s.variables]
    for j, v in zip(js, s.variables):
        j.variables = jax.tree_util.tree_map(jnp.asarray, v)
    segs = [apis.init_segmentor(s.cfg, c, device='cpu') for c in s.ckpts]
    ds = build_dataset(segs[0].cfg.data['test'])
    for idx in (0, N_VAL - 1):
        item = ds.get_item_deterministic(idx, seed=0)[0]
        img = np.asarray(item['img'], np.float32)[None]
        want = sum(np.asarray(j_inference(
            jax.jit(j.apply_fn), jnp.asarray(img), 21, mode=j.mode,
            crop_size=j.crop_size, stride=j.stride)) for j in js) / len(js)
        got = ensemble_test.ensemble_probs(segs, torch.from_numpy(img), 21)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    printed = _jax_tool('tools/ensemble_test.py', [s.cfg] + s.pths, capsys)
    want = eval(printed.strip().splitlines()[-1], {'nan': np.nan})
    got = ensemble_test.main([s.cfg] + s.ckpts + ['--device', 'cpu'])
    np.testing.assert_equal(got, want)
    assert got['aAcc'] > 0.02
    assert got['aAcc'] > 0.02


def _jax_variables_for(monkeypatch, variables):
    """The JAX tools read their weights with ``load_inference_variables``
    (an orbax directory); hand them the test's variables instead."""
    import s4former_tpu.core.checkpoint as j_checkpoint
    monkeypatch.setattr(j_checkpoint, 'load_inference_variables',
                        lambda path: jax.tree_util.tree_map(jnp.asarray,
                                                            variables))


def test_per_image_eval_matches_jax(tools_setup, capsys, monkeypatch):
    s = tools_setup
    _jax_variables_for(monkeypatch, s.variables[1])
    printed = _jax_tool('tools/per_image_eval.py', [s.cfg, 'ckpt', '--cpu'],
                        capsys)
    want = [json.loads(line) for line in printed.strip().splitlines()]
    got = per_image_eval.main([s.cfg, s.ckpts[1], '--cpu'])
    assert capsys.readouterr().out.strip().splitlines() == \
        printed.strip().splitlines()
    assert got == want and len(got) == N_VAL + 1
    assert got[-1]['n'] == N_VAL


@pytest.mark.parametrize('bucket', [16, 256])
def test_measure_eval_divergence_matches_jax(tools_setup, capsys,
                                             monkeypatch, bucket):
    s = tools_setup
    got = measure_eval_divergence.main([s.cfg, s.ckpts[1], '--cpu',
                                        '--bucket', str(bucket)])
    if bucket == 16:          # the model's own pad: the same computation
        assert got['argmax_agreement_mean'] == 1.0
        assert got['abs_dmIoU'] == 0.0
        assert got == measure_eval_divergence.main([s.cfg, s.ckpts[1],
                                                    '--cpu'])
        return
    _jax_variables_for(monkeypatch, s.variables[1])
    printed = _jax_tool('tools/measure_eval_divergence.py',
                        [s.cfg, 'ckpt', '--cpu', '--bucket', str(bucket)],
                        capsys)
    assert got == json.loads(printed.strip().splitlines()[-1])
    assert got['argmax_agreement_mean'] < 1.0     # the pad band shows


def _tiny_model_flops(h, w):
    """The tiny model's products at (1, h, w, 3), 2 FLOPs a multiply-add:
    the 16x16 patch embedding, per ViT layer its qkv, projection and two
    FFN linears (embed 64, hidden 256) and the attention's q kᵀ and p v
    (4 heads of 16, L tokens with the cls token), then the SETR-PUP head:
    a 3x3 conv 64 -> 16 on the token grid, x4 up, a 3x3 conv 16 -> 16 and
    the 1x1 classifier 16 -> 21 (before its deferred x4 up)."""
    gh, gw = h // 16, w // 16
    n = gh * gw
    seq = n + 1
    embed = 2 * 16 * 16 * 3 * 64 * n
    linears = 2 * seq * 64 * (3 * 64 + 64 + 256 + 256)
    attention = 4 * 4 * seq * seq * 16
    head = 2 * 9 * 64 * 16 * n + 2 * 9 * 16 * 16 * (16 * n) + \
        2 * 16 * 21 * (16 * n)
    return embed + 2 * (linears + attention) + head, 2 * attention


def test_get_flops_counts_the_products(tools_setup, capsys):
    s = tools_setup
    got = get_flops.main([s.cfg, '--shape', '64', '96', '--device', 'cpu'])
    total, attention = _tiny_model_flops(64, 96)
    assert got['flops'] == total and got['attention_flops'] == attention
    out = capsys.readouterr().out
    assert 'Input shape: (1, 64, 96, 3)' in out and 'Params: 0.18 M' in out
    assert got['params'] == sum(
        p.numel() for p in apis.init_segmentor(s.cfg, device='cpu')
        .model.parameters())
    # the JAX tool's XLA cost analysis of the same forward counts the
    # elementwise work too: measured 1.494x this count on this model
    from s4former_tpu.models import init_segmentor_variables
    model = s.js.model
    variables = init_segmentor_variables(model, jax.random.PRNGKey(0),
                                         (1, 64, 96, 3))
    xla = jax.jit(lambda img: model.apply(variables, img, train=False)) \
        .lower(jnp.zeros((1, 64, 96, 3), jnp.float32)).cost_analysis()
    xla = float((xla[0] if isinstance(xla, list) else xla)['flops'])
    print(f'get_flops: port {total} FLOPs, JAX XLA {xla:.0f} '
          f'({xla / total:.3f}x)')
    assert 1.0 < xla / total < 2.0


def test_get_flops_refuses_an_attention_it_did_not_see(tools_setup,
                                                       monkeypatch):
    """A ViT whose layers reach the attention by another name than the one
    get_flops wraps would go uncounted on the card: it raises instead."""
    import s4former_tpu_torch.models.backbones.vit as vit
    from s4former_tpu_torch.ops.attention import multi_head_attention
    forward = vit.MultiheadSelfAttention.forward

    def bound_elsewhere(self, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(vit, 'multi_head_attention', multi_head_attention)
            return forward(self, *args, **kwargs)
    monkeypatch.setattr(vit.MultiheadSelfAttention, 'forward',
                        bound_elsewhere)
    with pytest.raises(RuntimeError, match='uncounted'):
        get_flops.main([tools_setup.cfg, '--shape', '64', '96', '--device',
                        'cpu'])


def test_benchmark_prints_the_line_and_writes_a_trace(tools_setup, capsys):
    trace = tools_setup.dir / 'bench_trace'
    got = benchmark.main([tools_setup.cfg, '--shape', '64', '--device',
                          'cpu', '--iters', '2', '--warmup', '1',
                          '--trace', str(trace)])
    out = capsys.readouterr().out
    m = re.search(r'Overall fps: ([0-9.]+) img/s  \(([0-9.]+) ms/img\)',
                  out)
    assert m and got['iters'] == 2 and got['batch'] == 1
    assert float(m.group(1)) == pytest.approx(got['fps'], rel=1e-2)
    s = profile_trace.main([str(trace), '--steps', '2'])
    assert s['dispatch']['busy_ms'] > 0 and s['device_ms'] == 0.0


# ------------------------------------------------------------- the demos
def test_image_demo_matches_jax(tools_setup, capsys):
    s = tools_setup
    img = osp.join(FIXTURE, 'JPEGImages', s.stems[0] + '.jpg')
    _jax_tool('demo/image_demo.py',
              [img, s.cfg, s.pths[0], '--out', str(s.dir / 'demo_jax.png')],
              capsys)
    pred = image_demo.main([img, s.cfg, s.pths[0], '--device', 'cpu',
                            '--out', str(s.dir / 'demo_port.png')])
    assert (s.dir / 'demo_port.png').read_bytes() == \
        (s.dir / 'demo_jax.png').read_bytes()
    seg = apis.init_segmentor(s.cfg, s.pths[0], device='cpu')
    np.testing.assert_array_equal(
        np.asarray(Image.open(s.dir / 'demo_port.png')),
        apis.show_result_pyplot(seg, img, pred))


def test_video_demo_matches_jax_with_a_stub_cv2(tools_setup, capsys,
                                                monkeypatch):
    s = tools_setup
    frames = [np.asarray(Image.open(osp.join(
        FIXTURE, 'JPEGImages', stem + '.jpg')).convert('RGB'))
        for stem in s.stems[:2]]
    written = {}
    for pkg in ('jax', 'port'):
        stub = StubCv2(frames)
        monkeypatch.setitem(sys.modules, 'cv2', stub)
        argv = ['frames', s.cfg, s.pths[0], '--palette', 'voc',
                '--output-file', 'out.avi']
        if pkg == 'jax':
            _jax_tool('demo/video_demo.py', argv, capsys)
        else:
            assert video_demo.main(argv + ['--device', 'cpu']) == 2
        written[pkg] = (stub.opened, stub.written)
    assert written['port'][0] == written['jax'][0] == \
        ('out.avi', 'MJPG', 25.0, (500, 375))
    assert len(written['port'][1]) == 2
    for got, want in zip(written['port'][1], written['jax'][1]):
        np.testing.assert_array_equal(got, want)


def test_video_demo_needs_cv2(tools_setup, monkeypatch, capsys):
    s = tools_setup
    monkeypatch.setitem(sys.modules, 'cv2', None)     # not importable
    argv = ['frames', s.cfg, s.pths[0], '--output-file', 'out.avi']
    with pytest.raises(ImportError):
        _jax_tool('demo/video_demo.py', argv, capsys)
    with pytest.raises(ImportError):
        video_demo.main(argv + ['--device', 'cpu'])


# ------------------------------------------------------ launch scripts
_STUB = '#!/bin/sh\necho "$(basename "$0") $*" >> "$STUB_LOG"\n'


@pytest.mark.parametrize('script', ['dist_test', 'slurm_train', 'slurm_test',
                                    'dist_train'])
def test_launch_script_forms_the_command(tmp_path, script):
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    for name in ('python', 'srun'):
        (bin_dir / name).write_text(_STUB)
        (bin_dir / name).chmod(0o755)
    log = tmp_path / 'log'
    args = {'dist_test': ['CFG', 'CKPT', '2', '--eval', 'mIoU'],
            'dist_train': ['CFG', '2', '--work-dir', 'W'],
            'slurm_train': ['PART', 'JOB', 'CFG', '--work-dir', 'W'],
            'slurm_test': ['PART', 'JOB', 'CFG', 'CKPT', '--eval', 'mIoU']}
    env = {**os.environ, 'PATH': f'{bin_dir}:{os.environ["PATH"]}',
           'STUB_LOG': str(log), 'PORT': '29601', 'GPUS': '8',
           'SRUN_ARGS': '--quotatype=auto'}
    subprocess.run(['bash', str(TOOLS / f'{script}.sh')] + args[script],
                   env=env, check=True, timeout=60)
    want = {
        'dist_test': 'python -m torch.distributed.run --nproc_per_node 2 '
                     '--master_port 29601 -m s4former_tpu_torch.tools.test '
                     'CFG CKPT --launcher env --eval mIoU',
        'dist_train': 'python -m torch.distributed.run --nproc_per_node 2 '
                      '--master_port 29601 -m s4former_tpu_torch.tools.train '
                      'CFG --launcher env --work-dir W',
        'slurm_train': 'srun -p PART --job-name=JOB --gres=gpu:4 --ntasks=8 '
                       '--ntasks-per-node=4 --cpus-per-task=5 '
                       '--kill-on-bad-exit=1 --quotatype=auto python -u -m '
                       's4former_tpu_torch.tools.train CFG --launcher slurm '
                       '--auto-resume --work-dir W',
        'slurm_test': 'srun -p PART --job-name=JOB --gres=gpu:4 --ntasks=8 '
                      '--ntasks-per-node=4 --cpus-per-task=5 '
                      '--kill-on-bad-exit=1 --quotatype=auto python -u -m '
                      's4former_tpu_torch.tools.test CFG CKPT --launcher '
                      'slurm --eval mIoU'}[script]
    assert log.read_text() == want + '\n'
