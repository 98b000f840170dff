"""The port's data parallelism (``s4former_tpu_torch/parallel/``) on the CPU:
2 ranks in spawned processes joined by a gloo group, tiny models.

- The launchers' env mapping against the JAX ``init_distributed`` on the
  env dicts of tests/test_core/test_distributed.py, and the refusals.
- The collectives (``tests/_torch_port.py:dp_collectives_worker``): gather
  and block exact for f32, int and bool; SyncBN's forward, backward and
  running statistics against batch norm on the global batch.
- The slice as a whole: the port's 2-rank step against the jitted JAX step
  on the unsharded global batch of 4, 3 steps at 1e-4 (losses relative,
  parameters, EMA, BN statistics and SGD buffers absolute), the ranks'
  states bit-identical after every step. Cases: the flagship flags with
  the main head's CE over non-ignored pixels, the ignore label spread
  unevenly over the blocks and CutMix pairs across the rank boundary;
  adaptive CutMix (its permutation over the global batch) with the
  supervised ClassMix (i with i+1); the MiT [1,1,1,1] with its flags.
  The JAX draws are handed to the port as ``dbg_`` overrides at the
  global batch, as tests/test_torch_ablation_step.py does.
- The loader's blocks, the sharded eval's metrics (exactly the
  single-process ones), and ``tools.train --launcher env`` through
  ``s4former_tpu_torch/tools/dist_train.sh`` with 2 CPU ranks.
"""
import copy
import json
import os
import os.path as osp
import subprocess
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.parallel import distributed as jdist
from s4former_tpu.semi.config import SemiConfig as JSemiConfig
from s4former_tpu.semi.train_step import \
    make_semi_train_step as j_make_semi_train_step
from s4former_tpu_torch.core.checkpoint import train_state_dicts_from_jax
from s4former_tpu_torch.parallel import distributed as dist
from tests import _torch_port as port
from tests.test_torch_ablation import j_adaptive_draws, j_class_scores
from tests.test_torch_ablation_step import _draw_key, _step_keys
from tests.test_torch_train_step import LOSS_RTOL, S4_FLAGS, STEP_KW

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORLD, B, IMG, STEPS = 2, 4, 64, 3
STATE_ATOL = 1e-4


# ------------------------------------------------------------ launchers
def test_first_host_matches_jax():
    for nodelist in ('node001', 'n[001-004]', 'n[007,012]', 'gpu-a,gpu-b'):
        assert dist._first_host(nodelist) == jdist._first_host(nodelist)


# (launcher, the JAX test's env, the port's env for the same group)
ENVS = {
    'slurm': ({'SLURM_NODELIST': 'tpu[042-043]', 'SLURM_NTASKS': '2',
               'SLURM_PROCID': '1'},) * 2,
    'mpi': ({'OMPI_COMM_WORLD_SIZE': '4', 'OMPI_COMM_WORLD_RANK': '2'},) * 2,
    'env': ({'JAX_COORDINATOR_ADDRESS': 'h0:99', 'JAX_NUM_PROCESSES': '4',
             'JAX_PROCESS_ID': '3'},
            {'MASTER_ADDR': 'h0', 'MASTER_PORT': '99', 'WORLD_SIZE': '4',
             'RANK': '3', 'LOCAL_RANK': '1'}),
}


@pytest.mark.parametrize('launcher', list(ENVS))
def test_launcher_env_matches_jax(launcher):
    jenv, env = ENVS[launcher]
    with mock.patch.dict(os.environ, jenv, clear=True), \
            mock.patch('jax.distributed.initialize') as init:
        assert jdist.init_distributed(launcher, coordinator_port=1234)
    want = init.call_args.kwargs
    got = dist.launcher_env(launcher, port=1234, environ=env)
    assert got['init_method'] == 'tcp://' + want['coordinator_address']
    assert (got['world_size'], got['rank']) == (want['num_processes'],
                                                want['process_id'])
    assert got['local_rank'] == (1 if launcher == 'env' else 0)


def test_launchers_refused():
    assert dist.launcher_env('none') is None
    assert dist.init_distributed('none', device='cpu') == torch.device('cpu')
    assert not dist.is_distributed() and dist.world_size() == 1
    with pytest.raises(ValueError, match='no TPU'):
        dist.launcher_env('tpu')
    with pytest.raises(ValueError, match='unknown launcher'):
        dist.launcher_env('pytorch')
    env = {'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': '1', 'WORLD_SIZE': '2',
           'RANK': '1', 'LOCAL_RANK': '1'}
    with mock.patch.dict(os.environ, env):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            dist.init_distributed('env')        # no card here
        # NCCL puts one rank on each card: a second rank on a one-card
        # host is an error, not a gloo fallback
        with mock.patch('torch.cuda.is_available', return_value=True), \
                mock.patch('torch.cuda.device_count', return_value=1):
            with pytest.raises(RuntimeError, match='one rank per card'):
                dist.init_distributed('env')
        with pytest.raises(ValueError, match='NCCL'):
            dist.init_distributed('env', backend='nccl', device='cpu')
    assert not dist.is_distributed()


# ---------------------------------------------------------- collectives
def test_collectives_and_sync_bn(tmp_path):
    out = str(tmp_path / 'ok')
    port.run_ranks(port.dp_collectives_worker, WORLD, out)
    assert open(out).read() == 'ok'


# ------------------------------------------------------- the 2-rank step
def _boxes(step):
    """CutMix boxes for the global batch of 4: sample 1 (rank 0's last)
    takes its box from sample 2 (rank 1's first), sample 3 from 0."""
    masks = np.ones((B, IMG, IMG), np.float32)
    for i in range(B):
        masks[i, 8 * i + step:8 * i + 30 + step, 10 + 4 * i:44 + 4 * i] = 0
    return masks


def _perms(step):
    rows = [np.roll(np.arange(4), step + i) for i in range(B)]
    rows[2] = np.arange(4)              # an unshuffled sample
    return np.stack(rows).astype(np.int32)


def _batches():
    """Global batches with the ignore label spread unevenly: rank 0's
    block holds most of it."""
    rs = np.random.RandomState(11)
    out = []
    for step in range(STEPS):
        gt = rs.randint(0, 5, (B, IMG, IMG)).astype(np.int32)
        gt[0, :40] = 255
        gt[1, :, :20] = 255
        gt[3, :5, :5] = 255
        out.append({
            'sup_img': rs.randn(B, IMG, IMG, 3).astype(np.float32),
            'sup_gt': gt,
            'unsup_teacher_img': rs.randn(B, IMG, IMG, 3).astype(np.float32),
            'unsup_student_img': rs.randn(B, IMG, IMG, 3).astype(np.float32),
            'dbg_cutmix_mask': _boxes(step),
            'dbg_patchmix_perm': _perms(step)})
    return out


def _flagship_model():
    cfg = copy.deepcopy(port.TRAIN_MODEL)
    cfg['decode_head']['loss_decode']['avg_non_ignore'] = True
    return cfg


def _jax_mit_state():
    from s4former_tpu.models import build_segmentor as j_build
    from s4former_tpu.models import init_segmentor_variables
    from s4former_tpu.semi.train_step import create_train_state
    model = j_build(port.mit_model_cfg())
    v = jax.jit(lambda key: init_segmentor_variables(
        model, key, (1, 64, 64, 3)))(jax.random.PRNGKey(0))
    student = port.perturbed({'params': v['params'],
                              'batch_stats': v['batch_stats']}, 0)
    teacher = port.perturbed(student, 1, std=0.05)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, student),
                               ema=True)
    return model, state.replace(
        ema_params=jax.tree_util.tree_map(jnp.asarray, teacher['params']),
        ema_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               teacher['batch_stats']))


BASE = dict(S4_FLAGS, strong_aug_prob=1.0, momentum_head_exp=0.0)
CASES = {
    'flagship': dict(S4_FLAGS),
    'adaptive_sup_classmix': dict(BASE, use_cutmix_adaptive=True,
                                  sup_ClassMix=True),
    # the MiT flags of tests/test_torch_mit.py (threshold 0.4)
    'mit': dict(ema=True, ema_momentum=0.99, unsup_weight=1.0,
                unsup_confidence=0.4, attn_mask_seperate_head=True,
                attn_mask_weight=5.0, adaptive_attn_mask=True,
                use_PatchShuffle_w_Cutmix=True, PatchMix_N=2,
                negative_class_ranking=True,
                negative_class_ranking_mode='unsup_only'),
}


def _draws(case, key, step):
    """The JAX step's draws of the adaptive and supervised ClassMix at the
    global batch, as the port's ``dbg_`` overrides."""
    if case != 'adaptive_sup_classmix':
        return {}
    r_sup, k = _step_keys(key, step)
    out = {'dbg_sup_classmix_scores': j_class_scores(_draw_key(r_sup), B,
                                                     False, 0)}
    out.update({'dbg_adaptive_' + n: v for n, v in
                j_adaptive_draws(k[3], B, (IMG, IMG)).items()})
    return {n: np.asarray(v) for n, v in out.items()}


@pytest.mark.parametrize('case', list(CASES))
def test_two_rank_step_matches_jax_on_the_global_batch(case, tmp_path,
                                                       monkeypatch):
    flags = CASES[case]
    if case == 'mit':
        jmodel, jstate = _jax_mit_state()
        model_cfg = port.mit_model_cfg()
    else:
        model_cfg = _flagship_model() if case == 'flagship' else \
            port.TRAIN_MODEL
        jcfg = copy.deepcopy(model_cfg)
        jmodel, jstate = port.jax_train_model(seed=0, cfg=jcfg)
    if case == 'adaptive_sup_classmix':
        # the supervised ClassMix's 0.5 gate, opened in JAX (the port's
        # override opens its own)
        original = jax.random.bernoulli
        monkeypatch.setattr(
            jax.random, 'bernoulli',
            lambda key, p=0.5, shape=None: jnp.asarray(True)
            if shape is None or tuple(shape) == () else
            original(key, p, shape))
    sds = train_state_dicts_from_jax(jstate)
    jstep = jax.jit(j_make_semi_train_step(jmodel, JSemiConfig(**flags),
                                           **STEP_KW))
    key = jax.random.PRNGKey(0)
    port_batches, jlogs_by_step = [], []
    for i, batch in enumerate(_batches()):
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
        jlogs_by_step.append({k: float(v) for k, v in jlogs.items()})
        port_batches.append(dict(batch, **_draws(case, key, i)))
    inp, out = str(tmp_path / 'in.pt'), str(tmp_path / 'out.pt')
    torch.save({'model_cfg': model_cfg, 'flags': flags, 'state': sds,
                'batches': port_batches, 'step_kw': STEP_KW}, inp)
    port.run_ranks(port.dp_trajectory_worker, WORLD, inp, out)
    got = torch.load(out, weights_only=False)

    assert got['same'] == [True] * STEPS       # ranks bit-identical
    for i, (logs, jlogs) in enumerate(zip(got['logs'], jlogs_by_step)):
        assert sorted(logs) == sorted(jlogs), i
        for k, v in jlogs.items():
            np.testing.assert_allclose(logs[k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f'{case} step {i} {k}')
        assert 0.05 < logs['mask_ratio'] < 0.95, i
        assert logs['unsup.loss_ncr_unsup'] > 0, i
    assert got['step'] == int(jstate.step) == STEPS
    want = train_state_dicts_from_jax(jstate)
    for which in ('model', 'momentum', 'ema'):
        assert sorted(want[which]) == sorted(got[which]), which
        for name, w in want[which].items():
            np.testing.assert_allclose(
                got[which][name].numpy(), w.numpy(), rtol=0, atol=STATE_ATOL,
                err_msg=f'{case} {which} {name}')
    if flags.get('momentum_head_exp'):
        np.testing.assert_allclose(got['annealed'],
                                   float(jstate.annealed_momentum),
                                   rtol=LOSS_RTOL)


def test_draws_reach_across_the_blocks():
    """The cases above read across the ranks' blocks (rank 0 holds samples
    0 and 1, rank 1 samples 2 and 3): adaptive CutMix's permutation moves
    samples between them, and sample 1's CutMix box takes sample 2's
    pixels at every step."""
    key = jax.random.PRNGKey(0)
    perms = [_draws('adaptive_sup_classmix', key, i)['dbg_adaptive_perm']
             for i in range(STEPS)]
    assert any((p < 2) != (j < 2) for perm in perms
               for j, p in enumerate(perm)), perms
    assert all((_boxes(i)[1] == 0).any() for i in range(STEPS))


# -------------------------------------------------------------- loader
def test_loader_blocks_stack_to_the_single_process_batch(tmp_path):
    """Every rank runs the sampler with one seed at the global counts and
    builds its block; the blocks, stacked, are the single-process batch
    (items made by ``get_item_deterministic``)."""
    import s4former_tpu_torch.data  # noqa: F401
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.data import SemiLoader, build_dataset
    from tests.test_torch_runner import _split
    cfg = Config.fromfile(port.write_cli_config(tmp_path,
                                                _split(tmp_path, 1)))

    class Deterministic:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, idx):
            return self.ds.get_item_deterministic(idx, seed=0)

    sup = Deterministic(build_dataset(cfg.data['train']['sup']))
    unsup = Deterministic(build_dataset(cfg.data['train']['unsup']))

    def batches(shard):
        loader = SemiLoader(sup, unsup, sup_per_batch=4, unsup_per_batch=4,
                            num_workers=2, seed=3, max_iter_size=2,
                            shard=shard)
        try:
            return list(loader)
        finally:
            loader.close()
    single = batches((0, 1))
    blocks = [batches((r, WORLD)) for r in range(WORLD)]
    assert len(single) == 2
    for i, want in enumerate(single):
        assert sorted(want) == sorted(blocks[0][i])
        for k, v in want.items():
            assert blocks[0][i][k].shape[0] == v.shape[0] // WORLD, k
            np.testing.assert_array_equal(
                np.concatenate([b[i][k] for b in blocks]), v, err_msg=k)
    with pytest.raises(ValueError, match='divide'):
        SemiLoader(sup, unsup, sup_per_batch=3, unsup_per_batch=4,
                   shard=(0, WORLD))


# ---------------------------------------------------------------- eval
def test_sharded_eval_equals_the_single_process_eval(tmp_path):
    """The val set's forwards split over 2 ranks and their histograms
    summed give the single-process metrics exactly (5 images in groups of
    2: rank 0 predicts groups 0 and 2, rank 1 group 1)."""
    import s4former_tpu_torch.data  # noqa: F401
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import make_eval_fn
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.semi.train_step import create_train_state
    from tests.test_torch_runner import _split
    cfg_path = port.write_cli_config(tmp_path, _split(tmp_path, 5))
    cfg = Config.fromfile(cfg_path)
    # seeded weights: predictions of many classes an image
    model = init_segmentor(cfg, seed=0, device='cpu').model
    weights = str(tmp_path / 'weights.pt')
    torch.save(model.state_dict(), weights)
    want = make_eval_fn(build_dataset(cfg.data['val']), batch_size=2)(
        create_train_state(model))
    out = str(tmp_path / 'metrics.json')
    port.run_ranks(port.dp_eval_worker, WORLD, cfg_path, weights, out)
    with open(out) as f:
        got = json.load(f)
    assert got == want
    assert 0 < want['aAcc'] < 1


# ----------------------------------------------------------------- CLI
def _dist_train(cfg, wd, *argv):
    env = {**os.environ, 'PORT': str(port.free_port()),
           'OMP_NUM_THREADS': '2', 'PYTHONPATH': REPO}
    proc = subprocess.run(
        ['bash', osp.join(REPO, 's4former_tpu_torch', 'tools',
                          'dist_train.sh'), cfg, str(WORLD), '--device',
         'cpu', '--work-dir', wd] + list(argv),
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_train_cli_two_ranks_writes_once_and_resumes(tmp_path):
    """``dist_train.sh CONFIG 2 --device cpu`` (torchrun, ``--launcher
    env``, gloo): 3 steps of 2 + 2 a rank with eval and checkpoints at 2;
    rank 0 alone writes the log, the metrics and the checkpoints; then
    ``--auto-resume`` to 4 on both ranks."""
    from tests.test_torch_runner import _split
    cfg = port.write_cli_config(tmp_path, _split(tmp_path, 2))
    wd = str(tmp_path / 'work')
    _dist_train(cfg, wd, '--max-iters', '3')
    logs = [n for n in os.listdir(wd) if n.endswith('.log')]
    assert len(logs) == 1, logs                   # rank 0 only
    text = open(osp.join(wd, logs[0])).read()
    assert '2 ranks (env)' in text
    assert '2 + 2 a step a rank, 4 + 4 global' in text
    with open(osp.join(wd, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert [r['step'] for r in records if r['prefix'] == 'train'] == [1, 2, 3]
    assert [r['step'] for r in records if r['prefix'] == 'val'] == [2]
    assert sorted(n for n in os.listdir(wd) if n.startswith('iter_')) == \
        ['iter_2', 'iter_3']
    assert open(osp.join(wd, 'work_is_done')).read() == 'iter 3\n'

    _dist_train(cfg, wd, '--auto-resume', '--max-iters', '4')
    logs = sorted(n for n in os.listdir(wd) if n.endswith('.log'))
    assert len(logs) == 2, logs
    text = open(osp.join(wd, logs[-1])).read()
    assert f'resumed from {osp.join(wd, "iter_3")} (iter 3)' in text
    assert osp.isfile(osp.join(wd, 'iter_4', 'state.pt'))
    with open(osp.join(wd, 'metrics.jsonl')) as f:
        steps = [json.loads(line)['step'] for line in f]
    assert steps.count(4) == 2 and steps.count(3) == 1     # train + val
