"""The ViT's layer remat (``remat_layers``, ``remat_policy``) in the port.

- Remat off, ``'dots'`` and ``'full'`` give the same loss and gradients
  (f32, 1e-6) with dropout and drop path live, and leave the generator in
  the same state: the masks are drawn before the checkpointed call.
- The same for a whole UniMatch train step (logs, parameters after the
  update, the generator).
- ``'dots'`` saves the outputs of the layer's matrix products (the
  policy sees the four linears as ``addmm``); other policies recompute all.
- Against the JAX ViT with ``remat_layers`` True and False: loss and
  gradients of a train forward with the PASA bias, dropout and drop path
  given the same (shape, keep) masks in both packages.
- Remat is not entered without gradients (eval, ``no_grad``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.models import dropout as tdrop
from s4former_tpu_torch.models.backbones import vit
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import (make_semi_train_step,
                                                train_state_from_jax)
from tests._torch_port import TRAIN_MODEL, jax_train_model
from tests.test_torch_ablation import _FixedMasks
from tests.test_torch_train_step import STEP_KW
from tests.test_torch_unimatch import UNIMATCH, _batches

POLICIES = ['off', 'dots', 'full']
RATES = dict(drop_rate=0.1, drop_path_rate=0.2, attn_drop_rate=0.1)
ATOL = 1e-6
# JAX (XLA) vs the port (ATen), f32 sums in another order
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6


def _cfg(policy, **backbone):
    cfg = copy.deepcopy(TRAIN_MODEL)
    cfg['backbone'].update(backbone, remat_layers=policy != 'off',
                           remat_policy='full' if policy == 'full' else 'dots')
    return cfg


def _inputs(seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    bias = rs.randn(2, 1, 17, 17).astype(np.float32)
    return x, bias


@pytest.fixture(scope='module')
def jax_base():
    return jax_train_model(seed=0)


def _port_model(jstate, policy, **backbone):
    model = build_segmentor(_cfg(policy, **backbone))
    train_state_from_jax(model, jstate)
    return model


def _port_loss_grads(model, x, bias, gen):
    out = model.forward_decode_from_img(
        torch.from_numpy(x), train=True, attn_bias=torch.from_numpy(bias),
        generator=gen)
    loss = out.square().mean()
    params = {n: p for n, p in model.named_parameters()
              if not n.startswith('auxiliary_head')}
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


@pytest.mark.parametrize('policy', ['dots', 'full'])
def test_remat_matches_no_remat(jax_base, policy):
    _, jstate = jax_base
    x, bias = _inputs()
    runs = {}
    for p in ('off', policy):
        gen = torch.Generator().manual_seed(5)
        loss, grads = _port_loss_grads(_port_model(jstate, p, **RATES), x,
                                       bias, gen)
        runs[p] = (loss, grads, gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = runs['off'], runs[policy]
    np.testing.assert_allclose(l1, l0, rtol=ATOL)
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    assert torch.equal(s1, s0)
    assert l0 > 0


@pytest.mark.parametrize('policy', ['dots', 'full'])
def test_unimatch_step_with_remat_matches_no_remat(jax_base, policy):
    """A UniMatch step (2 teacher and 4 student passes, drop path and
    dropout live): the same logs, parameters and generator state."""
    _, jstate = jax_base
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()
             if not k.startswith('dbg_')}
    runs = {}
    for p in ('off', policy):
        state = train_state_from_jax(build_segmentor(_cfg(p, **RATES)),
                                     jstate)
        step = make_semi_train_step(state.model, SemiConfig(**UNIMATCH),
                                    **STEP_KW)
        gen = torch.Generator().manual_seed(2)
        state, logs = step(state, batch, gen)
        runs[p] = ({k: float(v) for k, v in logs.items()},
                   state.model.state_dict(), gen.get_state())
    (l0, sd0, s0), (l1, sd1, s1) = runs['off'], runs[policy]
    assert sorted(l1) == sorted(l0)
    for k, v in l0.items():
        np.testing.assert_allclose(l1[k], v, rtol=ATOL, atol=1e-9,
                                   err_msg=k)
    for name, t in sd0.items():
        np.testing.assert_allclose(sd1[name].numpy(), t.numpy(), rtol=0,
                                   atol=ATOL, err_msg=name)
    assert torch.equal(s1, s0)
    assert l0['unsup.loss_seg_unsup_1'] > 0


def test_dots_policy_saves_the_products(jax_base, monkeypatch):
    _, jstate = jax_base
    seen = []
    original = vit.save_dots

    def save_dots(ctx, op, *args, **kwargs):
        decision = original(ctx, op, *args, **kwargs)
        seen.append((op, decision))
        return decision
    monkeypatch.setattr(vit, 'save_dots', save_dots)
    x, bias = _inputs()
    for policy in ('dots', 'full'):
        seen.clear()
        _port_loss_grads(_port_model(jstate, policy), x, bias,
                         torch.Generator())
        saved = [op for op, d in seen
                 if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
        if policy == 'full':
            assert seen == []
            continue
        # 2 layers x (qkv, out proj, fc1, fc2), and the plain attention's
        # two products on the CPU
        assert saved.count(torch.ops.aten.addmm.default) == 2 * 4
        assert saved.count(torch.ops.aten.bmm.default) == 2 * 2
        assert len(seen) > len(saved)        # the rest is recomputed
    assert vit.remat_kwargs('full') == vit.remat_kwargs('anything') == {}
    assert 'context_fn' in vit.remat_kwargs('dots')


@pytest.fixture(scope='module')
def jax_loss_grads(jax_base):
    """The JAX ViT's train-forward loss and gradients (through the weight
    bridge, by port name) with ``remat_layers`` True and False, the
    dropout and drop-path masks fixed by (shape, keep)."""
    _, jstate = jax_base
    x, bias = _inputs()
    out = {}
    fixed = _FixedMasks()
    original = jax.random.bernoulli
    jax.random.bernoulli = fixed.bernoulli
    try:
        for remat in (True, False):
            cfg = _cfg('off', **RATES)
            cfg['backbone'].update(use_flash=False, remat_layers=remat)
            jmodel = j_build_segmentor(cfg)
            bs = jstate.batch_stats

            def loss_fn(params):
                logits, _ = jmodel.apply(
                    {'params': params, 'batch_stats': bs},
                    method='forward_decode_from_img', img=jnp.asarray(x),
                    train=True, attn_bias=jnp.asarray(bias),
                    mutable=['batch_stats'],
                    rngs={'dropout': jax.random.PRNGKey(0)})
                return jnp.mean(jnp.square(logits))
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
            sd = state_dict_from_jax_variables(
                {'params': jax.tree_util.tree_map(np.asarray, grads),
                 'batch_stats': jax.tree_util.tree_map(np.asarray, bs)})
            out[remat] = (float(loss), sd)
    finally:
        jax.random.bernoulli = original
    return out


@pytest.mark.parametrize('policy', POLICIES)
@pytest.mark.parametrize('jax_remat', [True, False])
def test_remat_matches_jax(jax_base, jax_loss_grads, monkeypatch, jax_remat,
                           policy):
    _, jstate = jax_base
    want_loss, want = jax_loss_grads[jax_remat]
    fixed = _FixedMasks()
    monkeypatch.setattr(tdrop, 'keep_mask', fixed.keep_mask)
    x, bias = _inputs()
    loss, grads = _port_loss_grads(_port_model(jstate, policy, **RATES), x,
                                   bias, torch.Generator())
    assert {(2, 17, 64), (2, 17, 256), (2, 1, 1)} <= set(fixed.port_shapes)
    np.testing.assert_allclose(loss, want_loss, rtol=JAX_RTOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=name)


def test_remat_is_not_entered_without_gradients(jax_base, monkeypatch):
    _, jstate = jax_base
    calls = []
    original = vit.checkpoint

    def checkpoint(*args, **kwargs):
        calls.append(kwargs)
        return original(*args, **kwargs)
    monkeypatch.setattr(vit, 'checkpoint', checkpoint)
    model = _port_model(jstate, 'full', **RATES)
    x = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        model.forward_decode_from_img(x, train=True,
                                      generator=torch.Generator())
    with torch.inference_mode():
        model.forward_decode_from_img(x, train=False)
    assert calls == []
    model.forward_decode_from_img(x, train=True, generator=torch.Generator())
    assert len(calls) == 2                       # one a layer
    assert all(kw['use_reentrant'] is False for kw in calls)
    # off: never
    calls.clear()
    _port_model(jstate, 'off', **RATES).forward_decode_from_img(
        x, train=True, generator=torch.Generator())
    assert calls == []
