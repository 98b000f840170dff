"""The port's pipeline parallelism (``s4former_tpu_torch/parallel/pp.py``)
against JAX ``parallel/pp.py`` on the CPU.

The same numpy weights (JAX ``TransformerEncoderLayer``s stacked as the
backbone's scan, perturbed with seeded noise, crossed through the weight
bridge's stacked-layer path) and inputs go through JAX ``pipeline_apply`` /
``pipeline_apply_tp`` on the CPU mesh and through the port on spawned gloo
ranks (``tests/_torch_port.py:pp_worker``), on the same grids:

- GPipe, pipe 4 (M = 4) and data 2 x pipe 2 (M = 4); the port at M = 2
  against itself at M = 4 and JAX at M = 2;
- GPipe x Megatron TP, data 1 x pipe 2 x model 2 and data 2 x pipe 1 x
  model 2, and with sequence parallelism (16 tokens);
- forward at ``FWD_TOL``, loss at ``LOSS_RTOL``, the stage gradients at
  ``GRAD_RTOL`` / ``GRAD_ATOL`` (JAX test_pp.py's own bounds), the input's
  gradient against JAX's sequential stack; every rank's result equal;
- the ValueErrors where JAX asserts.

Without a process group: the stage's schedule and ``_tp_block`` against
the JAX functions on one device, the qkv pieces against ``_repack_qkv``,
the rank grid against JAX's mesh layouts, the meshes' and the batch's
ValueErrors. Two spawns of 4 ranks, each with a timeout.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.models.backbones.vit import \
    TransformerEncoderLayer as JLayer
from s4former_tpu.parallel.pp import _repack_qkv
from s4former_tpu.parallel.pp import make_pp_mesh as j_make_pp_mesh
from s4former_tpu.parallel.pp import make_pp_tp_mesh as j_make_pp_tp_mesh
from s4former_tpu.parallel.pp import pipeline_apply as j_pipeline_apply
from s4former_tpu.parallel.pp import pipeline_apply_tp as j_pipeline_apply_tp
from s4former_tpu.parallel.ring_attention import \
    make_cp_mesh as j_make_cp_mesh
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models.backbones.vit import TransformerEncoderLayer
from s4former_tpu_torch.parallel import distributed, mesh, pp, tp
from tests import _torch_port as port

NUM_LAYERS, C, HEADS, T = 8, 16, 2, 17        # JAX test_pp.py's
FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
BUBBLE_TOL = 1e-4                             # M = 2 against M = 4
RANKS_TIMEOUT = 180.0


def _jax_stack(seed=0):
    layer = JLayer(embed_dims=C, num_heads=HEADS, feedforward_channels=4 * C,
                   use_flash=False)
    keys = jax.random.split(jax.random.PRNGKey(0), NUM_LAYERS)
    stacked = jax.vmap(
        lambda k: layer.init(k, jnp.zeros((1, T, C)))['params'])(keys)

    def layer_fn(p, x):
        return layer.apply({'params': p}, x)[0]
    return layer_fn, port.perturbed(stacked, seed)


def _bridge(stacked):
    """The bridge's names of a stacked layer tree: '{i}.ln1.weight', ..."""
    sd = state_dict_from_jax_variables(
        {'params': {'backbone_m': {'layers': {'block': stacked}}}})
    pre = 'backbone.layers.'
    return {k[len(pre):]: v.numpy() for k, v in sd.items()}


def _sequential(layer_fn, stacked, x):
    out, _ = jax.lax.scan(lambda c, p1: (layer_fn(p1, c), None), x, stacked)
    return out


def _inputs(seed, tokens=T):
    rs = np.random.RandomState(seed)
    return (rs.randn(8, tokens, C).astype(np.float32),
            rs.randn(8, tokens, C).astype(np.float32))


def _jax_case(fn, layer_fn, stacked, x, tgt):
    """JAX's output, loss and stage gradients (bridge names) of
    ``fn(params, x)``, and the input's gradient through the sequential
    stack."""
    def loss(p):
        out = fn(p, x)
        return jnp.mean((out - tgt) ** 2), out
    (l, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    x_grad = jax.grad(lambda x: jnp.mean(
        (_sequential(layer_fn, stacked, x) - tgt) ** 2))(x)
    return {'out': np.asarray(out), 'loss': float(l),
            'grads': _bridge(g), 'x_grad': np.asarray(x_grad)}


def _spawn(tmp_path, cases, stacked):
    inp, out = str(tmp_path / 'cases.pt'), str(tmp_path / 'result')
    torch.save({'cases': cases, 'state': _bridge(stacked),
                'num_layers': NUM_LAYERS, 'c': C, 'heads': HEADS}, inp)
    port.run_ranks(port.pp_worker, 4, inp, out, timeout=RANKS_TIMEOUT)
    return [torch.load(f'{out}.rank{r}', weights_only=False)
            for r in range(4)]


def _merged_grads(ranks, i):
    """The stage gradients of case i from every rank, each name's copies
    checked equal (data and model ranks hold the same whole gradient)."""
    out = {}
    for r in ranks:
        for k, g in r[i]['grads'].items():
            if k in out:
                np.testing.assert_array_equal(g, out[k], err_msg=k)
            out[k] = g
    return out


def _assert_matches(ranks, i, ref, fwd_tol=FWD_TOL):
    for r in ranks:
        np.testing.assert_allclose(r[i]['out'], ref['out'], rtol=fwd_tol,
                                   atol=fwd_tol)
        np.testing.assert_allclose(r[i]['loss'], ref['loss'],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[i]['x_grad'], ref['x_grad'],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    grads = _merged_grads(ranks, i)
    assert sorted(grads) == sorted(ref['grads'])
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref['grads'][k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_pipeline_matches_jax(tmp_path):
    """pipe 4 and data 2 x pipe 2 at M = 4, and pipe 4 at M = 2, against
    JAX pipeline_apply on the same grids (4 of the 8 CPU devices)."""
    layer_fn, stacked = _jax_stack(0)
    x, tgt = _inputs(1)
    grids = [((1, 4, 1), 4), ((2, 2, 1), 4), ((1, 4, 1), 2)]
    cases = [{'kind': 'pp', 'grid': g, 'M': m, 'x': x, 'tgt': tgt}
             for g, m in grids]
    ranks = _spawn(tmp_path, cases, stacked)
    for i, ((dp, s, _), m) in enumerate(grids):
        mesh_j = j_make_pp_mesh(num_stages=s, n_devices=dp * s)
        ref = _jax_case(
            lambda p, x: j_pipeline_apply(layer_fn, p, x, mesh_j, m),
            layer_fn, stacked, x, tgt)
        _assert_matches(ranks, i, ref)
    # the microbatch count is a schedule knob only
    np.testing.assert_allclose(ranks[0][2]['out'], ranks[0][0]['out'],
                               rtol=BUBBLE_TOL, atol=1e-5)
    for r in ranks:
        errors = [c['errors'] for c in r]
        assert '7 layers do not divide into 4 stages' in errors[0]['layers']
        assert 'does not split into 4 microbatches' in \
            errors[0]['microbatches']
        assert 'does not divide over 2 data ranks' in errors[1]['data_rows']


def test_pipeline_tp_matches_jax(tmp_path):
    """data 1 x pipe 2 x model 2 (with and without sequence parallelism,
    16 tokens for SP) and data 2 x pipe 1 x model 2 against JAX
    pipeline_apply_tp on the same grids."""
    layer_fn, stacked = _jax_stack(2)
    x, tgt = _inputs(3)
    x16, tgt16 = _inputs(4, tokens=16)
    cases = [{'kind': 'tp', 'grid': (1, 2, 2), 'M': 4, 'x': x, 'tgt': tgt},
             {'kind': 'sp', 'grid': (1, 2, 2), 'M': 4, 'x': x16,
              'tgt': tgt16},
             {'kind': 'tp', 'grid': (2, 1, 2), 'M': 2, 'x': x, 'tgt': tgt}]
    ranks = _spawn(tmp_path, cases, stacked)
    for i, case in enumerate(cases):
        dp, s, mp = case['grid']
        mesh_j = j_make_pp_tp_mesh(num_stages=s, model_parallel=mp,
                                   n_devices=dp * s * mp)
        ref = _jax_case(
            lambda p, x: j_pipeline_apply_tp(
                p, x, mesh_j, case['M'], HEADS,
                sequence_parallel=case['kind'] == 'sp'),
            layer_fn, stacked, case['x'], case['tgt'])
        _assert_matches(ranks, i, ref)
    for r in ranks:
        for c in r:
            assert 'do not divide over a model axis of 2' in \
                c['errors']['heads']
            assert 'pad them to a multiple' in c['errors']['tokens']
        assert '7 layers do not divide into 2 stages' in \
            r[0]['errors']['layers']


@pytest.mark.parametrize('kind', ['pp', 'tp', 'sp'])
def test_one_process_matches_jax(kind):
    """No process group: every collective is the identity and the
    schedule runs one stage of all the layers (GPipe's M ticks), against
    the JAX function on a one-device mesh: forward, loss and gradients."""
    layer_fn, stacked = _jax_stack(5)
    x, tgt = _inputs(6, tokens=16 if kind == 'sp' else T)
    if kind == 'pp':
        mesh_j = j_make_pp_mesh(num_stages=1, n_devices=1)
        ref = _jax_case(lambda p, x: j_pipeline_apply(layer_fn, p, x,
                                                      mesh_j, 4),
                        layer_fn, stacked, x, tgt)
    else:
        mesh_j = j_make_pp_tp_mesh(1, 1, n_devices=1)
        ref = _jax_case(lambda p, x: j_pipeline_apply_tp(
            p, x, mesh_j, 4, HEADS, sequence_parallel=kind == 'sp'),
            layer_fn, stacked, x, tgt)
    layers = port._layer_stack(_bridge(stacked), NUM_LAYERS, C, HEADS)
    xt = torch.from_numpy(x).requires_grad_()
    if kind == 'pp':
        stage = pp.stage_layers(layers)
        out = pp.pipeline_apply(None, stage, xt, 4)
    else:
        leaves = pp.tp_stage_leaves(layers)
        out = pp.pipeline_apply_tp(leaves, xt, 4, HEADS, kind == 'sp')
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    if kind == 'pp':
        grads = {k: p.grad.numpy() for k, p in stage.named_parameters()}
    else:
        grads = {f'{i}.{name}': leaf[short].grad.numpy()
                 for i, leaf in enumerate(leaves)
                 for name, short in pp.LEAF_NAMES}
    np.testing.assert_allclose(out.detach().numpy(), ref['out'],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(loss.item(), ref['loss'], rtol=LOSS_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), ref['x_grad'],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert sorted(grads) == sorted(ref['grads'])
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref['grads'][k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize('mp', [1, 2, 4])
def test_qkv_pieces_are_jax_repack(mp):
    """Model rank m's qkv leaves (``tp_stage_leaves``, cut by
    ``parallel/tp.py``'s head-aligned plan) are shard m of JAX
    ``_repack_qkv``'s output axis, kernel and bias; the other leaves are
    JAX pipeline_apply_tp's specs (fc1 column-split, proj and fc2
    row-split, the rest whole)."""
    c, heads = 32, 4
    rs = np.random.RandomState(mp)
    layers = torch.nn.ModuleList([TransformerEncoderLayer(c, heads, 4 * c)])
    with torch.no_grad():
        for p in layers.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
    whole = dict(layers[0].named_parameters())
    kernel = whole['attn.attn.in_proj_weight'].detach().numpy().T
    bias = whole['attn.attn.in_proj_bias'].detach().numpy()
    packed_k = np.asarray(_repack_qkv(jnp.asarray(kernel), c, heads, mp))
    packed_b = np.asarray(_repack_qkv(jnp.asarray(bias), c, heads, mp))
    width, hidden = 3 * c // mp, 4 * c // mp
    # (leaf, parameter, split dim, piece size)
    splits = (('fc1_w', 'ffn.layers.0.0.weight', 0, hidden),
              ('fc1_b', 'ffn.layers.0.0.bias', 0, hidden),
              ('proj_w', 'attn.attn.out_proj.weight', 1, c // mp),
              ('fc2_w', 'ffn.layers.1.weight', 1, hidden))
    for m in range(mp):
        with mock.patch.object(pp, 'model_size', lambda: mp), \
                mock.patch.object(tp, 'model_rank', lambda: m):
            leaf = pp.tp_stage_leaves(layers)[0]
        cols = slice(m * width, (m + 1) * width)
        np.testing.assert_array_equal(leaf['qkv_w'].detach().numpy().T,
                                      packed_k[:, cols])
        np.testing.assert_array_equal(leaf['qkv_b'].detach().numpy(),
                                      packed_b[cols])
        for short, name, dim, size in splits:
            np.testing.assert_array_equal(
                leaf[short].detach().numpy(),
                whole[name].detach().numpy().take(
                    range(m * size, (m + 1) * size), axis=dim))
        for short in ('ln1_w', 'ln1_b', 'proj_b', 'ln2_w', 'ln2_b',
                      'fc2_b'):
            name = dict((s, n) for n, s in pp.LEAF_NAMES)[short]
            np.testing.assert_array_equal(leaf[short].detach().numpy(),
                                          whole[name].detach().numpy())


@pytest.mark.parametrize('kind', ['pp', 'pp_tp', 'cp'])
def test_rank_grid_is_jax_mesh_layout(kind, monkeypatch):
    """Each of 8 ranks' (data, pipe, ctx, model) indices on the port's grid
    is the position of device r in JAX's mesh of the same kind:
    ``make_pp_mesh(4)`` (data, pipe), ``make_pp_tp_mesh(2, 2)`` (data,
    pipe, model), ``make_cp_mesh`` (ctx)."""
    devices = jax.devices()[:8]
    if kind == 'pp':
        jmesh, sizes = j_make_pp_mesh(4, n_devices=8), dict(pp=4)
    elif kind == 'pp_tp':
        jmesh, sizes = j_make_pp_tp_mesh(2, 2, n_devices=8), dict(pp=2,
                                                                   mp=2)
    else:
        jmesh, sizes = j_make_cp_mesh(8), dict(cp=8)
    where = {d.id: idx for idx, d in np.ndenumerate(jmesh.devices)}
    names = jmesh.axis_names
    monkeypatch.setattr(distributed, 'world_size', lambda: 8)
    for key, size in sizes.items():
        monkeypatch.setitem(distributed._GRID, key, size)
    for r, dev in enumerate(devices):
        monkeypatch.setattr(distributed, 'rank', lambda r=r: r)
        mine = {'data': distributed.data_rank(),
                'pipe': distributed.pipe_rank(),
                'ctx': distributed.ctx_rank(),
                'model': distributed.model_rank()}
        assert {n: mine[n] for n in names} == dict(zip(names,
                                                       where[dev.id])), r
        assert all(mine[n] == 0 for n in mine if n not in names)


@pytest.mark.parametrize('what', ['pp_mesh', 'pp_tp_mesh', 'cp_mesh',
                                  'microbatches', 'empty_stage'])
def test_value_errors_without_a_group(what):
    """One process: the meshes refuse axes the world does not divide into
    (JAX asserts n % axes == 0), the pipeline a batch M does not divide
    (b % m) and an empty stage; before any collective."""
    calls = {
        'pp_mesh': (lambda: mesh.make_pp_mesh(2),
                    'do not divide into pipelines of 2 stages'),
        'pp_tp_mesh': (lambda: mesh.make_pp_tp_mesh(1, 2),
                       'do not divide into 1 stages of 2 model ranks'),
        'cp_mesh': (lambda: mesh.make_cp_mesh(3),
                    'do not divide into rings of 3'),
        'microbatches': (lambda: pp.pipeline_apply(
            None, torch.nn.ModuleList([torch.nn.Identity()]),
            torch.zeros(6, 2), 4), 'does not split into 4 microbatches'),
        'empty_stage': (lambda: pp.pipeline_apply(
            None, torch.nn.ModuleList(), torch.zeros(4, 2), 2),
                        'needs at least one layer')}
    fn, msg = calls[what]
    with pytest.raises(ValueError, match=msg):
        fn()
    assert distributed._GRID['pp'] == distributed._GRID['mp'] == 1
