"""The port's ops held to the JAX package on the CPU, in f32: the flash
forward's plain version against the Pallas kernel run in interpret mode,
dot_product_attention, resize and the PASA bias."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.ops import attention as jattn
from s4former_tpu.ops import flash_attention as jfa
from s4former_tpu.ops.resize import resize as j_resize
from s4former_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from s4former_tpu.semi import pasa as jpasa
from s4former_tpu_torch.ops import attention as attn
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.ops import resize
from s4former_tpu_torch.semi import pasa

B, L, H, D = 2, 130, 2, 64


@pytest.fixture(scope='module')
def qkvb():
    rs = np.random.RandomState(0)
    q, k, v = (rs.normal(0, 0.5, (B, L, H, D)).astype(np.float32)
               for _ in range(3))
    biases = {'none': None,
              'broadcast': rs.normal(0, 1.0, (B, 1, L, L)).astype(np.float32),
              'per_head': rs.normal(0, 1.0, (B, H, L, L)).astype(np.float32)}
    return q, k, v, biases


def _jax_fwd_with_lse(q, k, v, bias):
    """The JAX wrapper's preprocessing (flash_attention.py:613-657) around
    the Pallas forward ``_fwd``, in interpret mode, returning (o, lse)."""
    lp = -(-L // 128) * 128
    scale = 1.0 / D ** 0.5              # a power of two: folded into q

    def to_bh(x):
        x = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, L, D)
        return jnp.pad(x, ((0, 0), (0, lp - L), (0, 0)))

    b = None
    if bias is not None:
        b = jnp.pad(jnp.asarray(bias),
                    ((0, 0), (0, 0), (0, lp - L), (0, lp - L)),
                    constant_values=jfa.NEG_INF)
    o, lse = jfa._fwd(to_bh(q * scale), to_bh(k), to_bh(v), b, H, 1.0, lp, lp,
                      L, bias is None, interpret=True)
    o = np.asarray(o)[:, :L].reshape(B, H, L, D).transpose(0, 2, 1, 3)
    return o, np.asarray(lse).reshape(B, H, lp)[:, :, :L]


@pytest.mark.parametrize('bias_kind', ['none', 'broadcast', 'per_head'])
def test_flash_forward_matches_pallas_interpret(qkvb, bias_kind):
    """o and the valid lse rows of the port's CPU path against the Pallas
    forward kernel (tolerance 1e-5: f32 sums in another order), and the
    public JAX ``flash_attention`` output."""
    q, k, v, biases = qkvb
    bias = biases[bias_kind]
    o_j, lse_j = _jax_fwd_with_lse(q, k, v, bias)
    fa.launch_count = 0
    o, lse = fa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias))
    assert fa.launch_count == 0      # the CPU never reaches the kernel
    assert o.shape == (B, L, H, D) and lse.shape == (B, H, L)
    np.testing.assert_allclose(o.numpy(), o_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=1e-5, atol=1e-5)
    o_pub = jfa.flash_attention(q, k, v, bias, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pub),
                               rtol=1e-5, atol=1e-5)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(qkvb):
    q, k, v = (torch.from_numpy(a) for a in qkvb[:3])
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match='shape'):
        fa.flash_attention(q, k[:, :-1], v)
    with pytest.raises(ValueError, match='bias'):
        fa.flash_attention(q, k, v, torch.zeros(B, 3, L, L))
    with pytest.raises(TypeError, match='bias'):      # the ViT casts it
        fa.flash_attention(q, k, v, torch.zeros(B, 1, L, L).double())
    with pytest.raises(ValueError, match='CUDA or CPU'):
        fa.flash_attention(q.to('meta'), k.to('meta'), v.to('meta'))


@pytest.mark.parametrize('with_bias', [False, True])
def test_dot_product_attention_with_probs(qkvb, with_bias):
    q, k, v, biases = qkvb
    bias = biases['broadcast'] if with_bias else None
    o_j, p_j = jattn.dot_product_attention(q, k, v, bias, return_probs=True)
    o, p = attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), return_probs=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=1e-5,
                               atol=1e-6)
    # the dispatch: probabilities take the plain path, else flash
    o2, p2 = attn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias))
    assert p2 is None
    np.testing.assert_allclose(o2.numpy(), o.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('in_hw,out_hw', [((7, 11), (16, 24)),
                                          ((32, 20), (13, 9)),
                                          ((5, 8), (5, 17))],
                         ids=['up', 'down', 'width_only'])
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    x = np.random.RandomState(1).normal(
        size=(2, *in_hw, 3)).astype(np.float32)
    ref = np.asarray(j_resize_bilinear(jnp.asarray(x), out_hw,
                                       align_corners))
    out = resize.resize_bilinear(torch.from_numpy(x), out_hw, align_corners)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_resize_entry_point_and_nearest():
    rs = np.random.RandomState(2)
    x = rs.normal(size=(1, 6, 10, 4)).astype(np.float32)
    lab = rs.randint(0, 21, (2, 6, 10)).astype(np.int32)
    np.testing.assert_allclose(
        resize.resize(torch.from_numpy(x), scale_factor=1.5,
                      mode='bilinear').numpy(),
        np.asarray(j_resize(jnp.asarray(x), scale_factor=1.5,
                            mode='bilinear')), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        resize.resize(torch.from_numpy(lab), size=(9, 4),
                      mode='nearest').numpy(),
        np.asarray(j_resize(jnp.asarray(lab), size=(9, 4),
                            mode='nearest')))


@pytest.mark.parametrize('adaptive', [True, False])
def test_pasa_bias_matches_jax_with_ties(adaptive):
    """Per-patch unconfidence from a {0,1} mask has many ties; the stable
    argsort must zero the same query rows as jnp.argsort."""
    rs = np.random.RandomState(3)
    conf = (rs.rand(2, 64, 80) > 0.3).astype(np.float32)
    conf[:, :32] = 1.0                       # a band of exact-zero ties
    u_j = jpasa.patch_unconfidence(jnp.asarray(conf), 16)
    u = pasa.patch_unconfidence(torch.from_numpy(conf), 16)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), atol=1e-7)
    assert len(np.unique(u.numpy())) < u.numel()         # ties present
    b_j = jpasa.build_pasa_bias(u_j, 5.0, adaptive)
    b = pasa.build_pasa_bias(u, 5.0, adaptive)
    assert b.shape == (2, 1, 21, 21)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), atol=1e-6)


def _jax_grads(q, k, v, bias, g, blocks):
    """jax.grad of the public flash_attention (Pallas interpret mode) for
    the cotangent g."""
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, bias, interpret=True,
                                           **blocks) * g)
    return [np.asarray(t) for t in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize('bias_kind', ['none', 'broadcast', 'per_head'])
@pytest.mark.parametrize('route', ['fused', 'two_kernel'])
def test_flash_backward_matches_pallas_interpret(qkvb, route, bias_kind):
    """dq, dk, dv of the port's autograd Function on CPU tensors (its plain
    backward) against jax.grad through the Pallas backward kernels: default
    blocks take the fused kernel at L=130, blk_q=blk_k=128 the dk/dv + dq
    pair. Tolerance 1e-5 relative to max |grad| (f32 sums in another
    order)."""
    q, k, v, biases = qkvb
    bias = biases[bias_kind]
    g = np.random.RandomState(9).normal(0, 1.0, (B, L, H, D)).astype(
        np.float32)
    blocks = {} if route == 'fused' else dict(blk_q=128, blk_k=128)
    want = _jax_grads(q, k, v, bias, g, blocks)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    counts = (fa.fused_launch_count, fa.dkv_launch_count, fa.dq_launch_count)
    o = fa.flash_attention(tq, tk, tv, tb)
    (o * torch.from_numpy(g)).sum().backward()
    assert counts == (fa.fused_launch_count, fa.dkv_launch_count,
                      fa.dq_launch_count)     # the CPU never reaches them
    assert tb is None or tb.grad is None      # the bias gets no gradient
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, 'qkv'):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale, err_msg=f'd{name}')


def test_flash_backward_reference_rounds_like_the_kernels():
    """In bf16 the plain backward rounds p and ds to bf16 before their
    products (the TPU kernels' rounding points): it differs from f32
    autograd by bf16 rounding, and equals itself computed from bf16 p."""
    rs = np.random.RandomState(4)
    q, k, v, do = (torch.from_numpy(rs.normal(0, 0.5, (1, 40, 2, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_reference(q, k, v)
    dq, dk, dv = fa.flash_attention_backward_reference(q, k, v, None, o, lse,
                                                       do)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) / 8.0
    p = torch.exp(s - lse[..., None]).to(torch.bfloat16).float()
    dv_ref = torch.einsum('bhqk,bqhd->bkhd', p, do.float()).to(torch.bfloat16)
    assert torch.equal(dv, dv_ref)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    of, _ = fa.flash_attention_reference(qf, kf, vf)
    (of * do.float()).sum().backward()
    for got, ref in ((dq, qf.grad), (dk, kf.grad), (dv, vf.grad)):
        assert (got.float() - ref).abs().max() < 2e-2
