"""The port's tensor parallelism and ZeRO-3 (``s4former_tpu_torch/parallel/
tp.py``) on the CPU: tiny models, ranks spawned into a gloo group as in
tests/test_torch_parallel.py (workers in tests/_torch_port.py).

- The plan: for the tiny ViT and a tiny MiT, the port's split of every
  parameter, mapped through the weight bridge, is JAX ``tp_param_specs``
  on the 8-device CPU mesh (mp = 2 and 4, with and without ZeRO-3); the
  packed qkv's pieces are head-aligned row blocks and gather back whole.
- The step: 2 ranks (data 1 x model 2) and ZeRO-3 on 2 ranks (data 2)
  against the jitted JAX step on the unsharded global batch of 4, 3 steps:
  losses at ``LOSS_RTOL``, parameters, EMA, momentum and BN statistics at
  1e-4 absolute (JAX test_tp.py's own bound); the whole tensors identical
  on every rank and the split ones still split after every step.
- Both together, 4 ranks (data 2 x model 2, ZeRO-3), and the MiT on 2 model
  ranks: one step against the port's own single process.
- The CLI: ``tools.train --launcher env --model-parallel 2`` (--zero3) on 2
  ranks with a checkpoint at 2, then a resume onto another split; its
  checkpoint has an unsharded run's keys, shapes and dtypes.
"""
import copy
import os
import os.path as osp
import subprocess
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.parallel.mesh import make_mesh as j_make_mesh
from s4former_tpu.parallel.tp import tp_param_specs
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch.core.checkpoint import (state_dict_from_jax_variables,
                                                train_state_dicts_from_jax)
from s4former_tpu_torch.parallel import tp
from tests import _torch_port as port
from tests.test_torch_parallel import CASES, _batches, _flagship_model
from tests.test_torch_train_step import LOSS_RTOL, STEP_KW

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
STATE_ATOL = 1e-4
STEPS = 3


# ---------------------------------------------------------------- plan
def _jax_params(kind):
    if kind == 'vit':
        return port.jax_train_model(seed=0, ema=False)[1].params
    from s4former_tpu.models import build_segmentor as j_build
    from s4former_tpu.models import init_segmentor_variables
    model = j_build(port.mit_model_cfg())
    return jax.jit(lambda key: init_segmentor_variables(
        model, key, (1, 64, 64, 3)))(jax.random.PRNGKey(0))['params']


def _markers(params, specs, axis):
    """Per leaf: the index along the dim its spec puts on ``axis`` (plus
    one), zeros where no dim is; the bridge carries it to the port's
    layout, where the marked dim is the one that varies."""
    def leaf(x, spec):
        out = np.zeros(x.shape, np.float32)
        for d, name in enumerate(spec):
            if name == axis:
                shape = [1] * x.ndim
                shape[d] = x.shape[d]
                out = out + np.arange(1, x.shape[d] + 1,
                                      dtype=np.float32).reshape(shape)
        return out
    return jax.tree_util.tree_map(
        leaf, params, specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))


def _varying(t: torch.Tensor):
    """The dim along which ``t`` varies, None if it is constant."""
    a = t.numpy()
    dims = [d for d in range(a.ndim) if a.shape[d] > 1 and
            np.ptp(a, axis=d).max() > 0]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


@pytest.mark.parametrize('zero3', [False, True], ids=['tp', 'zero3'])
@pytest.mark.parametrize('mp', [2, 4])
@pytest.mark.parametrize('kind', ['vit', 'mit'])
def test_plan_is_jax_tp_param_specs(kind, mp, zero3):
    params = _jax_params(kind)
    mesh = j_make_mesh(8, model_parallel=mp)
    specs = tp_param_specs(params, mesh, zero3)
    marked = {axis: state_dict_from_jax_variables(
        {'params': _markers(params, specs, axis)})
        for axis in ('model', 'data')}
    names = marked['model']
    port_specs = tp.param_specs({n: tuple(t.shape) for n, t in names.items()},
                                mp, 8 // mp if zero3 else 1)
    n_split = 0
    for name, t in names.items():
        spec = port_specs.get(name, tp.Spec())
        assert (_varying(t), _varying(marked['data'][name])) == \
            (spec.model, spec.data), name
        n_split += spec != tp.Spec()
    # attn proj + fc1 + fc2 (+ the ViT's qkv) and the split biases a block
    assert n_split == {'vit': 2 * 6, 'mit': 4 * 4}[kind]


def test_qkv_pieces_are_head_rows_and_gather_whole():
    """ViT of 4 heads of 16 on mp = 2 and 4 (with a ZeRO-3 axis of 2): rank
    m holds heads m*H/mp.. of each of q, k and v; the pieces gather back to
    the whole tensor through ``ShardPlan.gather``'s reassembly."""
    c, heads, d = 64, 4, 16
    w = torch.randn(3 * c, c)
    for mp, z in ((2, 1), (4, 1), (2, 2)):
        plan = tp.ShardPlan({'w': tp.Spec(model=0, data=1, blocks=3)},
                            mp, z)
        per = heads // mp * d
        pieces = {}
        for m in range(mp):
            for r in range(z):
                with mock.patch.object(tp, 'model_rank', lambda: m), \
                        mock.patch.object(tp, 'data_rank', lambda: r):
                    pieces[m, r] = plan.local('w', w)
            rows = torch.cat([w[j * c + m * per:j * c + (m + 1) * per]
                              for j in range(3)])
            assert torch.equal(torch.cat([pieces[m, r] for r in range(z)],
                                         1), rows)

        for m in range(mp):
            def fake_gather(x, dim, group, index, n, m=m):
                """The ranks' pieces in rank order: over the data axis
                (dim 1) those of model index m, then over the model axis
                (dim 0) each model index's data-gathered piece."""
                if dim == 1:
                    return torch.cat([pieces[m, i] for i in range(n)], 1)
                return torch.cat([torch.cat([pieces[j, i] for i in range(z)],
                                            1) for j in range(n)], 0)
            with mock.patch.object(tp, 'all_gather', fake_gather), \
                    mock.patch.object(tp, 'model_rank', lambda: m):
                assert torch.equal(plan.gather('w', pieces[m, 0]), w)


def test_heads_that_do_not_divide_are_refused():
    model = port.torch_train_model()
    with pytest.raises(ValueError, match='4 attention heads.*3'):
        tp._check_heads(model, 3)
    tp._check_heads(model, 2)


# ---------------------------------------------------------------- step
@pytest.fixture(scope='module')
def jax_trajectory():
    """The jitted JAX step, 3 steps on the global batches of 4 of
    tests/test_torch_parallel.py (flagship flags); the port's inputs."""
    model_cfg = _flagship_model()
    jmodel, jstate = port.jax_train_model(seed=0, cfg=copy.deepcopy(
        model_cfg))
    sds = train_state_dicts_from_jax(jstate)
    jstep = jax.jit(j_make_semi_train_step(
        jmodel, JSemiConfig(**CASES['flagship']), **STEP_KW))
    key = jax.random.PRNGKey(0)
    batches, logs = _batches(), []
    for batch in batches:
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
        logs.append({k: float(v) for k, v in jlogs.items()})
    return {'model_cfg': model_cfg, 'flags': CASES['flagship'],
            'state': sds, 'batches': batches, 'step_kw': STEP_KW,
            'logs': logs, 'final': train_state_dicts_from_jax(jstate),
            'annealed': float(jstate.annealed_momentum)}


def _run(tmp_path, data, world, mp, zero3, name='run'):
    inp = str(tmp_path / f'{name}_in.pt')
    out = str(tmp_path / f'{name}_out.pt')
    torch.save(dict(data, mp=mp, zero3=zero3), inp)
    port.run_ranks(port.dp_trajectory_worker, world, inp, out)
    return torch.load(out, weights_only=False)


def _assert_close(got, want_logs, want_state, what):
    for i, (logs, wl) in enumerate(zip(got['logs'], want_logs)):
        assert sorted(logs) == sorted(wl), i
        for k, v in wl.items():
            np.testing.assert_allclose(logs[k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'{what} step {i} {k}')
    for which in ('model', 'momentum', 'ema'):
        assert sorted(want_state[which]) == sorted(got[which]), which
        for name, w in want_state[which].items():
            assert tuple(got[which][name].shape) == tuple(w.shape), name
            np.testing.assert_allclose(
                got[which][name].numpy(), w.numpy(), rtol=0, atol=STATE_ATOL,
                err_msg=f'{what} {which} {name}')


@pytest.mark.parametrize('grid', ['tp_1x2', 'zero3_2x1'])
def test_sharded_step_matches_jax_on_the_global_batch(grid, jax_trajectory,
                                                      tmp_path):
    world, mp, zero3 = {'tp_1x2': (2, 2, False),
                        'zero3_2x1': (2, 1, True)}[grid]
    ref = jax_trajectory
    got = _run(tmp_path, {k: ref[k] for k in ('model_cfg', 'flags', 'state',
                                              'batches', 'step_kw')},
               world, mp, zero3)
    assert got['same'] == [True] * STEPS        # the whole tensors agree
    assert got['sharded'] == [True] * STEPS     # the split ones stay split
    for logs in got['logs']:
        assert 0.05 < logs['mask_ratio'] < 0.95
        assert logs['unsup.loss_ncr_unsup'] > 0
    _assert_close(got, ref['logs'], ref['final'], grid)
    assert got['step'] == STEPS
    np.testing.assert_allclose(got['annealed'], ref['annealed'],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('case', ['vit_2x2_zero3', 'mit_1x2'])
def test_sharded_step_matches_the_single_process(case, jax_trajectory,
                                                 tmp_path):
    """One step on 4 ranks (data 2 x model 2, ZeRO-3) of the flagship, and
    the MiT [1,1,1,1] split over 2 model ranks, against the port's own
    single process on the same state and global batch."""
    if case == 'mit_1x2':
        from tests.test_torch_parallel import _jax_mit_state
        _, jstate = _jax_mit_state()
        data = {'model_cfg': port.mit_model_cfg(), 'flags': CASES['mit'],
                'state': train_state_dicts_from_jax(jstate),
                'step_kw': STEP_KW}
        world, mp, zero3 = 2, 2, False
    else:
        data = {k: jax_trajectory[k] for k in ('model_cfg', 'flags', 'state',
                                               'step_kw')}
        world, mp, zero3 = 4, 2, True
    data['batches'] = jax_trajectory['batches'][:1]
    single = _run(tmp_path, data, 1, 1, False, 'single')
    got = _run(tmp_path, data, world, mp, zero3, 'sharded')
    assert got['same'] == [True] and got['sharded'] == [True]
    _assert_close(got, single['logs'], single, case)


# ----------------------------------------------------------------- CLI
def _train(cfg, wd, world, *argv):
    env = {**os.environ, 'PORT': str(port.free_port()),
           'OMP_NUM_THREADS': '2', 'PYTHONPATH': REPO}
    proc = subprocess.run(
        ['bash', osp.join(REPO, 's4former_tpu_torch', 'tools',
                          'dist_train.sh'), cfg, str(world), '--device',
         'cpu', '--work-dir', wd] + list(argv),
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_train_cli_model_parallel_checkpoints_whole_and_resumes(tmp_path):
    """``dist_train.sh CONFIG 2 --model-parallel 2 --zero3 --device cpu``:
    3 steps of the global 4 + 4 (one data group reads all of it) with eval
    and checkpoints at 2; the checkpoint holds the unsharded run's keys,
    shapes and dtypes; then ``--auto-resume`` to 4 on the ZeRO-3 split
    alone (data 2, model 1): a checkpoint cut anew onto another split."""
    from tests.test_torch_runner import _split
    cfg = port.write_cli_config(tmp_path, _split(tmp_path, 2))
    wd, ref = str(tmp_path / 'work'), str(tmp_path / 'single')
    _train(cfg, wd, 2, '--max-iters', '3', '--model-parallel', '2',
           '--zero3')
    logs = [n for n in os.listdir(wd) if n.endswith('.log')]
    text = open(osp.join(wd, logs[0])).read()
    assert '2 ranks (env), 1 data x 2 model' in text
    assert 'sharded state: model axis = 2 (Megatron), zero3 = True; ' \
        '12 split tensors' in text
    assert 'Eval @ iter 2' in text
    assert sorted(n for n in os.listdir(wd) if n.startswith('iter_')) == \
        ['iter_2', 'iter_3']
    _train(cfg, ref, 1, '--max-iters', '1', '--no-validate')
    got = torch.load(osp.join(wd, 'iter_3', 'state.pt'), weights_only=True)
    want = torch.load(osp.join(ref, 'iter_1', 'state.pt'), weights_only=True)
    for key in ('model', 'momentum', 'ema_model'):
        assert {n: (tuple(t.shape), t.dtype) for n, t in got[key].items()} \
            == {n: (tuple(t.shape), t.dtype) for n, t in want[key].items()}

    _train(cfg, wd, 2, '--auto-resume', '--max-iters', '4', '--zero3')
    text = open(osp.join(wd, sorted(n for n in os.listdir(wd)
                                    if n.endswith('.log'))[-1])).read()
    assert f'resumed from {osp.join(wd, "iter_3")} (iter 3)' in text
    assert 'model axis = 1 (Megatron), zero3 = True' in text
    assert osp.isfile(osp.join(wd, 'iter_4', 'state.pt'))
