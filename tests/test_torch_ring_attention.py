"""The port's ring attention (``s4former_tpu_torch/parallel/ring_attention.py``)
against JAX ``parallel/ring_attention.py`` on the CPU.

The same numpy q, k, v, bias and output cotangent (JAX
test_ring_attention.py's shapes: B 2, L 32, H 2, D 8, a per-head bias of
3 N(0, 1)) go through JAX ``ring_attention_sharded`` on a ('ctx',) CPU mesh
and through the port's on spawned gloo ranks
(``tests/_torch_port.py:ring_worker``): rings of 4 with and without the
bias, and two rings of 2 (a data axis of 2). Forward at 1e-5, the
gradients of q, k and v at 2e-4 / 2e-5 (JAX's own bounds); every rank's
result equal. Without a process group: the log-sum-exp merge of blocks and
the blocks' backward shares against the whole sequence's, a ring of one
against JAX, and the ValueError for a bias that requires grad. On the card
the ring's blocks run kernels #1-#4; ``tests/test_torch_cuda.py`` holds
them to the dense kernel there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.parallel.ring_attention import (make_cp_mesh,
                                                  ring_attention_sharded)
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.parallel import ring_attention as ring
from tests import _torch_port as port

B, L, H, D = 2, 32, 2, 8
FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _inputs(seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, L, H, D).astype(np.float32) for _ in range(4))
    bias = (3.0 * rs.randn(B, H, L, L)).astype(np.float32)
    return q, k, v, do, bias


def _jax_ring(cp, q, k, v, do, bias):
    """JAX's output and the vjp of ``do`` in q, k and v."""
    mesh = make_cp_mesh(cp)

    def f(q, k, v):
        return ring_attention_sharded(q, k, v, mesh, bias=bias)
    o, vjp = jax.vjp(jax.jit(f), q, k, v)
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def test_ring_matches_jax(tmp_path):
    """Rings of 4 without and with the bias, and two rings of 2 with it,
    against JAX on the same ring size; the ValueError of a length a ring
    does not divide."""
    q, k, v, do, bias = _inputs(0)
    cases = [dict(cp=4, bias=None), dict(cp=4, bias=bias),
             dict(cp=2, bias=bias)]
    for c in cases:
        c.update(q=q, k=k, v=v, do=do)
    inp, out = str(tmp_path / 'cases.pt'), str(tmp_path / 'result')
    torch.save({'cases': cases}, inp)
    port.run_ranks(port.ring_worker, 4, inp, out, timeout=180.0)
    ranks = [torch.load(f'{out}.rank{r}', weights_only=False)
             for r in range(4)]
    for i, c in enumerate(cases):
        o_ref, g_ref = _jax_ring(c['cp'], q, k, v, do, c['bias'])
        for r in ranks:
            np.testing.assert_allclose(r[i]['o'], o_ref, rtol=FWD_TOL,
                                       atol=FWD_TOL)
            for got, ref in zip(r[i]['grads'], g_ref):
                np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL)
            # CPU tensors: the plain versions, no kernel launched
            assert r[i]['launches'] == [0, 0, 0, 0]
            assert f'31 tokens do not split over a ring of {c["cp"]}' in \
                r[i]['length_error']


@pytest.mark.parametrize('with_bias', [False, True])
def test_one_rank_ring_matches_jax(with_bias):
    """No process group: a ring of one (one block) against JAX's ring on a
    one-device mesh, forward and the vjp."""
    q, k, v, do, bias = _inputs(1)
    bias = bias if with_bias else None
    o_ref, g_ref = _jax_ring(1, q, k, v, do, bias)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = ring.ring_attention_sharded(
        qt, kt, vt, None if bias is None else torch.from_numpy(bias))
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), o_ref, rtol=FWD_TOL,
                               atol=FWD_TOL)
    for t, ref in zip((qt, kt, vt), g_ref):
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize('cp', [2, 4])
def test_ring_blocks_compose_to_the_whole(cp):
    """The ring's arithmetic with every rank in one process: for each
    query chunk, the flash forward on each k/v chunk (the bias's column
    block, ``_bias_block``) merged by ``_merge`` is the whole sequence's o
    and lse; the flash backward of each block given the whole o and lse
    sums to the whole's dq, dk and dv."""
    q, k, v, do, bias = (torch.from_numpy(t) for t in _inputs(2))
    o_ref, lse_ref = fa.flash_attention_fwd(q, k, v, bias)
    dq_ref, dk_ref, dv_ref = fa.flash_attention_bwd(q, k, v, bias, o_ref,
                                                    lse_ref, do)
    n = L // cp
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(cp):
        rows = slice(r * n, (r + 1) * n)
        q_r, b_r = q[:, rows], bias[:, :, rows]
        o = lse = None
        dq = torch.zeros_like(q_r)
        for src in range(cp):
            cols = slice(src * n, (src + 1) * n)
            blk = ring._bias_block(b_r, src, n)
            o_j, lse_j = fa.flash_attention_fwd(q_r, k[:, cols], v[:, cols],
                                                blk)
            o, lse = (o_j, lse_j) if o is None else \
                ring._merge(o, lse, o_j, lse_j)
            dq_j, dk_j, dv_j = fa.flash_attention_bwd(
                q_r, k[:, cols], v[:, cols], blk, o_ref[:, rows],
                lse_ref[:, :, rows], do[:, rows])
            dq += dq_j
            dk[:, cols] += dk_j
            dv[:, cols] += dv_j
        torch.testing.assert_close(o, o_ref[:, rows], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse, lse_ref[:, :, rows], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(dq, dq_ref[:, rows], rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(dk, dk_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('entry', ['ring_attention',
                                   'ring_attention_sharded'])
def test_bias_requiring_grad_raises(entry):
    """The flash functions give the bias no gradient, so the ring refuses
    a bias that requires one (JAX would differentiate it) rather than give
    it a silent zero."""
    q, k, v, _, bias = (torch.from_numpy(t) for t in _inputs(3))
    with pytest.raises(ValueError, match='gives the bias no gradient'):
        getattr(ring, entry)(q, k, v, bias.requires_grad_())
