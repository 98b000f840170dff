"""The CUDA kernels against their plain versions on the card. Marked
``cuda``: they skip without a GPU. On a machine with one:
``python -m pytest tests/test_torch_cuda.py -m cuda``."""
import pytest
import torch

from s4former_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels have no CPU mode)')
    return torch.device('cuda')


# the tile edges (one row, a 64-row tile less or more one), the ragged
# L = 1025 of the flagship, and two lengths between; each bias is a
# contiguous [B, 1|H, L, L] tensor, whose rows are 2 L bytes apart in bf16
# (most not on 16 bytes, odd ones not even on 4)
LENGTHS = [1, 63, 64, 65, 130, 257, 1025]


@pytest.mark.parametrize('bias_heads', [None, 1, 3])
@pytest.mark.parametrize('length', LENGTHS)
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda, bias_heads, length, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, d = 2, 3, 64
    qkv = torch.randn((b, length, 3 * h * d), generator=g, device=cuda)
    q, k, v = [t.view(b, length, h, d)
               for t in qkv.to(dtype).split(h * d, -1)]
    bias = None if bias_heads is None else torch.randn(
        (b, bias_heads, length, length), generator=g, device=cuda).to(dtype)
    before = fa.launch_count
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, bias)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= 1e-3


def _grad_inputs(cuda, b, length, h, dtype, bias_heads, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    d = 64
    qkv = torch.randn((b, length, 3 * h * d), generator=g, device=cuda)
    q, k, v = [t.view(b, length, h, d)
               for t in qkv.to(dtype).split(h * d, -1)]
    bias = None if bias_heads is None else torch.randn(
        (b, bias_heads, length, length), generator=g, device=cuda).to(dtype)
    do = torch.randn((b, length, h, d), generator=g, device=cuda).to(dtype)
    return q, k, v, bias, do


def _assert_grads_close(got, ref, tol, atol=0.0):
    """max abs error of each gradient <= tol * its max |value| + atol (f32:
    sums in another order, and dq's atomic adds in a run-dependent order;
    bf16: then the rounding of dq, at most one ulp, 2^-7 of its max
    |value|)."""
    for a, r, name in zip(got, ref, ('dq', 'dk', 'dv')):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        scale = r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * scale + atol, (name, err, scale)


@pytest.mark.parametrize('route', ['fused', 'dkv_dq'])
@pytest.mark.parametrize('bias_heads', [None, 1, 3])
@pytest.mark.parametrize('length', LENGTHS)
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_backward_kernels_match_plain(cuda, route, bias_heads, length,
                                            dtype, tol):
    """Each backward route against the plain backward. At L = 1 the exact
    dq and dk are 0 (ds = dp - delta = 0): both sides hold only the f32
    rounding of dp - delta, ~1e-7, so that case adds 1e-5 absolute."""
    q, k, v, bias, do = _grad_inputs(cuda, 2, length, 3, dtype, bias_heads)
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    ref = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    args = (q, k, v, bias, do, lse, fa.row_delta(o, do))
    counts = (fa.fused_launch_count, fa.dkv_launch_count, fa.dq_launch_count)
    if route == 'fused':
        got = fa.launch_bwd_fused(*args)
        want = (counts[0] + 1, counts[1], counts[2])
    else:
        dk, dv = fa.launch_bwd_dkv(*args)
        got = (fa.launch_bwd_dq(*args), dk, dv)
        want = (counts[0], counts[1] + 1, counts[2] + 1)
    torch.cuda.synchronize()
    assert (fa.fused_launch_count, fa.dkv_launch_count,
            fa.dq_launch_count) == want
    _assert_grads_close(got, ref, tol, atol=1e-5 if length == 1 else 0.0)


@pytest.mark.parametrize('length,route', [(1025, 'fused'), (1600, 'dkv_dq')])
def test_flash_autograd_dispatches_by_length(cuda, length, route):
    """Up to FULL_Q_MAX tokens the gradient takes the fused kernel, above it
    the dk/dv and dq kernels, as the JAX backward dispatches."""
    q, k, v, bias, do = _grad_inputs(cuda, 1, length, 2, torch.bfloat16, 1)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    counts = (fa.fused_launch_count, fa.dkv_launch_count, fa.dq_launch_count)
    o = fa.flash_attention(q, k, v, bias)
    o.backward(do)
    torch.cuda.synchronize()
    grew = (fa.fused_launch_count - counts[0], fa.dkv_launch_count -
            counts[1], fa.dq_launch_count - counts[2])
    assert grew == ((1, 0, 0) if route == 'fused' else (0, 1, 1))
    o2, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(), bias)
    ref = fa.flash_attention_backward_reference(q.detach(), k.detach(),
                                                v.detach(), bias, o2, lse, do)
    _assert_grads_close((q.grad, k.grad, v.grad), ref, 1e-2)


def _pasa_inputs(cuda, b, length, seed):
    """q, k, v, do at H = 12 and the PASA bias of ``build_pasa_bias`` (the
    teacher's per-patch unconfidence, weight 5, adaptive), bf16."""
    from s4former_tpu_torch.semi.pasa import build_pasa_bias
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, _, do = _grad_inputs(cuda, b, length, 12, torch.bfloat16, None,
                                  seed=seed)
    unconf = torch.rand((b, length - 1), generator=g, device=cuda)
    bias = build_pasa_bias(unconf, 5.0, adaptive=True).to(torch.bfloat16)
    return q, k, v, bias, do


def test_tc_kernels_training_batch(cuda):
    """B = 16 at L = 1025, H = 12 with the PASA bias (the fused 2B unsup
    pass of the training step), forward and fused backward."""
    q, k, v, bias, do = _pasa_inputs(cuda, 16, 1025, seed=16)
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    ro, rlse = fa.flash_attention_reference(q, k, v, bias)
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= 1e-3
    del ro, rlse
    ref = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    got = fa.launch_bwd_fused(q, k, v, bias, do, lse, fa.row_delta(o, do))
    torch.cuda.synchronize()
    _assert_grads_close(got, ref, 1e-2)


def test_tc_kernels_refuse_misaligned_views(cuda):
    """A bf16 q view one element off its 16-byte alignment is refused by
    every tensor-core launcher, not copied."""
    b, length, h, d = 1, 65, 2, 64
    q, k, v, _, do = _grad_inputs(cuda, b, length, h, torch.bfloat16, None)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = flat[1:].view(b, length, h, d)
    with pytest.raises(ValueError, match='16-byte aligned'):
        fa.flash_attention_fwd(q_off, k, v)
    o, lse = fa.flash_attention_fwd(q, k, v)
    for launcher in (fa.launch_bwd_fused, fa.launch_bwd_dkv,
                     fa.launch_bwd_dq):
        with pytest.raises(ValueError, match='16-byte aligned'):
            launcher(q_off, k, v, None, do, lse, fa.row_delta(o, do))


@pytest.mark.parametrize('pasa', [False, True])
def test_long_route_at_768_crops(cuda, pasa):
    """B = 2 at L = 2305, H = 12 (two 768² crops, the shape the dk/dv and dq
    kernels take in training), without a bias and with the PASA bias."""
    q, k, v, bias, do = _pasa_inputs(cuda, 2, 2305, seed=23)
    bias = bias if pasa else None
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    ref = fa.flash_attention_backward_reference(q, k, v, bias, o, lse, do)
    args = (q, k, v, bias, do, lse, fa.row_delta(o, do))
    dk, dv = fa.launch_bwd_dkv(*args)
    got = (fa.launch_bwd_dq(*args), dk, dv)
    torch.cuda.synchronize()
    _assert_grads_close(got, ref, 1e-2)


def test_dq_kernel_is_deterministic(cuda):
    """The dq kernel owns its q rows and sums in a fixed order: two launches
    give the same bits (B = 1, L = 2305, H = 12, PASA bias)."""
    q, k, v, bias, do = _pasa_inputs(cuda, 1, 2305, seed=5)
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    args = (q, k, v, bias, do, lse, fa.row_delta(o, do))
    first = fa.launch_bwd_dq(*args)
    second = fa.launch_bwd_dq(*args)
    torch.cuda.synchronize()
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, second)
