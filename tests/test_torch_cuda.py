"""The CUDA kernels against their plain versions on the card. Marked
``cuda``: they skip without a GPU. On a machine with one:
``python -m pytest tests/test_torch_cuda.py -m cuda``."""
import threading
import time

import numpy as np
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


def test_prefetcher_batches_arrive_whole(cuda):
    """``_DevicePrefetcher`` on the card: 32 distinct batches of the CLI's
    keys and shapes (4 + 4 at 512²), each read twice on the consuming
    stream and compared with its host source bit for bit.

    - The first read is issued at once, on an idle stream. Every eighth
      batch's copies queue behind a ~100 ms spin on the copy stream, so a
      read that did not wait for them (``wait_stream``) would show.
    - Every eighth batch the second read waits behind ~90 ms of matmuls
      that allocate and free, and the host lets the prefetcher copy two
      more batches meanwhile: memory handed to a later copy before the
      read would show (``record_stream``)."""
    from s4former_tpu_torch.core.runner import PREFETCH_DEPTH, \
        _DevicePrefetcher
    rng = np.random.default_rng(0)
    img = rng.standard_normal((4, 512, 512, 3), dtype=np.float32)
    gt = rng.integers(0, 21, (4, 512, 512), dtype=np.int32)
    sources = [{'sup_img': img + np.float32(i), 'sup_gt': gt + i,
                'unsup_teacher_img': img - np.float32(i),
                'unsup_student_img': img * np.float32(i + 2)}
               for i in range(32)]
    w = torch.randn((4096, 4096), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) / 64
    stream = torch.cuda.current_stream(cuda)
    started = threading.Event()
    prefetcher = []

    def feed():     # runs on the prefetcher's thread
        started.wait()
        for i, src in enumerate(sources):
            if i % 8 == 2:
                with torch.cuda.stream(prefetcher[0]._side):
                    torch.cuda._sleep(200_000_000)
            yield src

    pf = _DevicePrefetcher(feed(), cuda)
    prefetcher.append(pf)
    started.set()
    early, late = [], []
    for i in range(len(sources)):
        heavy = i % 8 == 7
        if not heavy:
            stream.synchronize()
        batch = pf.get()
        early.append({k: t.clone() for k, t in batch.items()})
        if heavy:
            x = w
            for _ in range(32):
                x = (x @ w).tanh()
        late.append({k: t.clone() for k, t in batch.items()})
        del batch
        if heavy:   # the next copies start while the matmuls run
            deadline = time.monotonic() + 10
            while pf._q.qsize() < min(PREFETCH_DEPTH, len(sources) - i - 1) \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
    with pytest.raises(StopIteration):
        pf.get()
    pf.close()
    torch.cuda.synchronize()
    for i, src in enumerate(sources):
        for k, v in src.items():
            want = torch.from_numpy(v)
            assert torch.equal(early[i][k].cpu(), want), (i, k, 'first read')
            assert torch.equal(late[i][k].cpu(), want), (i, k, 'second read')


# ------------------------------------------------------- the SegFormer MiT
def _mit_pair(cuda, **cfg_kw):
    """The tiny MiT of tests/_torch_port.py with one set of seeded weights
    on the CPU and on the card, f32 without TF32."""
    from s4former_tpu_torch.models import (build_segmentor,
                                           init_segmentor_weights)
    from tests._torch_port import mit_model_cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_segmentor(mit_model_cfg(**cfg_kw))
    init_segmentor_weights(cpu, torch.Generator().manual_seed(0))
    gpu = build_segmentor(mit_model_cfg(**cfg_kw))
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu.to(cuda)


def _no_flash_launches():
    return (fa.launch_count, fa.fused_launch_count, fa.dkv_launch_count,
            fa.dq_launch_count)


def test_mit_forward_matches_cpu(cuda):
    """The MiT + SegFormer head on the card against the CPU, with and
    without a PASA map, f32: logits within 1e-4; no flash kernel runs."""
    cpu, gpu = _mit_pair(cuda)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 128, 128, 3).astype(np.float32))
    unconf = torch.from_numpy((rs.rand(2, 128, 128) > 0.4).astype(
        np.float32))
    before = _no_flash_launches()
    for bias in (None, unconf):
        with torch.no_grad():
            want = cpu.forward_decode_from_img(x, attn_bias=bias)
            got = gpu.forward_decode_from_img(
                x.to(cuda), attn_bias=None if bias is None else
                bias.to(cuda))
        assert got.shape == want.shape == (2, 32, 32, 5)
        assert (got.cpu() - want).abs().max().item() <= 1e-4
    assert _no_flash_launches() == before


def test_mit_step_matches_cpu(cuda):
    """One step of the _MT_w_ours flags (EMA, adaptive PASA, PatchShuffle
    + CutMix injected, NCR, drop rates 0) on the card and on the CPU from
    the same weights: losses within 1e-4 relative, the updated parameters
    within 1e-4 abs."""
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    flags = SemiConfig(
        ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.3,
        attn_mask_seperate_head=True, attn_mask_weight=5.0,
        adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True,
        PatchMix_N=2, negative_class_ranking=True,
        negative_class_ranking_mode='unsup_only')
    rs = np.random.RandomState(1)
    masks = np.ones((2, 64, 64), np.float32)
    masks[0, 8:40, 16:48] = 0
    batch = {'sup_img': rs.randn(2, 64, 64, 3).astype(np.float32),
             'sup_gt': rs.randint(0, 5, (2, 64, 64)).astype(np.int32),
             'unsup_teacher_img': rs.randn(2, 64, 64, 3).astype(np.float32),
             'unsup_student_img': rs.randn(2, 64, 64, 3).astype(np.float32),
             'dbg_cutmix_mask': masks,
             'dbg_patchmix_perm': np.array([[2, 0, 3, 1], [1, 0, 3, 2]],
                                           np.int32)}
    out = {}
    for model, device in zip(_mit_pair(cuda), ('cpu', cuda)):
        state = create_train_state(model, ema=True)
        step = make_semi_train_step(model, flags, num_classes=5,
                                    base_lr=0.01, max_iters=100)
        state, logs = step(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()},
                           torch.Generator(device=device).manual_seed(0))
        out[str(device)] = ({k: float(v) for k, v in logs.items()},
                            {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items()})
    (lc, sc), (lg, sg) = out['cpu'], out[str(cuda)]
    assert 0 < lc['mask_ratio'] < 1 and lc['unsup.loss_ncr_unsup'] > 0
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * max(abs(v), 1e-3), k
    for k, v in sc.items():
        assert (sg[k].float() - v.float()).abs().max().item() <= 1e-4, k


def test_mit_drop_path_and_dropout_rerun_on_card(cuda):
    """Drop path 0.5 and head dropout 0.5 drawn on the card from a CUDA
    generator: the same seed gives the same train forward, another seed
    another; eval ignores both."""
    _, gpu = _mit_pair(cuda, drop_path_rate=0.5, dropout_ratio=0.5)
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    with torch.no_grad():
        outs = [gpu.forward_decode_from_img(
            x, train=True, generator=torch.Generator(device=cuda).manual_seed(
                s)) for s in (0, 0, 1)]
        assert torch.equal(outs[0], outs[1])
        assert not torch.equal(outs[0], outs[2])
        assert torch.equal(gpu.forward_decode_from_img(x),
                           gpu.forward_decode_from_img(x))


@pytest.mark.parametrize('what', ['dropout', 'drop_path', 'fdrop'])
def test_keep_rates_on_card(cuda, what):
    """Dropout (keep 0.9), drop path (keep 0.8) and fdrop (keep 0.5) drawn
    on the card from a CUDA generator keep their rate within 5 sigma, and
    kept values are scaled by 1/keep."""
    from s4former_tpu_torch.models import dropout as drop
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((64, 32, 32, 64), generator=gen, device=cuda) + 0.5
    if what == 'dropout':
        out, keep, units = drop.dropout(x, 0.1, gen), 0.9, x.numel()
        kept = out != 0
    elif what == 'drop_path':
        x = x.reshape(64 * 32, 32, 64)
        out, keep, units = drop.drop_path(x, 0.2, gen), 0.8, x.shape[0]
        kept = (out != 0).all(dim=(1, 2))
        assert torch.equal(kept, (out != 0).any(dim=(1, 2)))
    else:
        out, keep, units = drop.channel_dropout(x, gen), 0.5, 64 * 64
        kept = (out != 0).all(dim=(1, 2))
        assert torch.equal(kept, (out != 0).any(dim=(1, 2)))
    sigma = (units * keep * (1 - keep)) ** 0.5
    assert abs(int(kept.sum()) - units * keep) <= 5 * sigma
    nz = out != 0
    torch.testing.assert_close(out[nz], x[nz] / keep)


# ------------------------------------------------------ remat and UniMatch
# a tiny ViT whose heads are 64 wide, as the kernels take: embed 128, 2
# heads, 2 layers; the SETR heads of tests/_torch_port.py:TRAIN_MODEL
def _vit_cfg(**backbone):
    import copy
    from tests._torch_port import TRAIN_MODEL
    cfg = copy.deepcopy(TRAIN_MODEL)
    cfg['backbone'].update(embed_dims=128, num_heads=2, **backbone)
    for head in [cfg['decode_head']] + cfg['auxiliary_head']:
        head['in_channels'] = 128
    return cfg


def _vit_pair(cuda, **backbone):
    """The tiny ViT with one set of seeded weights on the CPU and on the
    card, f32 without TF32."""
    from s4former_tpu_torch.models import (build_segmentor,
                                           init_segmentor_weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_segmentor(_vit_cfg(**backbone))
    init_segmentor_weights(cpu, torch.Generator().manual_seed(0))
    gpu = build_segmentor(_vit_cfg(**backbone))
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu.to(cuda)


@pytest.mark.parametrize('policy', ['dots', 'full'])
def test_remat_with_the_flash_function(cuda, policy):
    """Remat around the flash Function on the card, dropout and drop path
    live (CUDA generator), f32 with a PASA bias: the loss and gradients of
    remat off within 1e-5 (the fused backward's atomic dq), the same
    generator state, and the forward kernel launched once more a layer."""
    from s4former_tpu_torch.models import build_segmentor
    rates = dict(drop_rate=0.1, drop_path_rate=0.2)
    _, ref = _vit_pair(cuda, **rates)
    model = build_segmentor(_vit_cfg(remat_layers=True, remat_policy=policy,
                                     **rates)).to(cuda)
    model.load_state_dict(ref.state_dict())
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 64, 64, 3), generator=g, device=cuda)
    bias = torch.randn((2, 1, 17, 17), generator=g, device=cuda)
    out = {}
    for name, m in (('off', ref), (policy, model)):
        gen = torch.Generator(device=cuda).manual_seed(5)
        before = (fa.launch_count, fa.fused_launch_count)
        loss = m.forward_decode_from_img(x, train=True, attn_bias=bias,
                                         generator=gen).square().mean()
        params = [p for n, p in m.named_parameters()
                  if not n.startswith('auxiliary_head')]
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[name] = (loss.item(), grads, gen.get_state(),
                     (fa.launch_count - before[0],
                      fa.fused_launch_count - before[1]))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out['off'], out[policy]
    assert n0 == (2, 2) and n1 == (4, 2)
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for a, b in zip(g1, g0):
        assert (a - b).abs().max().item() <= 1e-5 * max(
            b.abs().max().item(), 1e-6)
    assert torch.equal(s1, s0)


def test_unimatch_step_matches_cpu(cuda):
    """One UniMatch step (EMA, PASA head 1, two PatchShuffled streams with
    injected boxes and permutations, NCR) on the card and on the CPU from
    the same weights: losses within 1e-4 relative, the updated parameters
    within 1e-4 abs; 2 layers x (2 teacher + 4 student) forward and 2 x 4
    fused backward launches."""
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    flags = SemiConfig(
        ema=True, ema_momentum=0.99, unimatch=True, unsup_weight=1.0,
        unsup_confidence=0.3, attn_mask_seperate_head=True,
        attn_mask_weight=5.0, adaptive_attn_mask=True,
        use_PatchShuffle=True, PatchMix_N=2, negative_class_ranking=True,
        negative_class_ranking_mode='unsup_only')
    rs = np.random.RandomState(1)
    batch = {'sup_gt': rs.randint(0, 5, (2, 64, 64)).astype(np.int32)}
    for key in ('sup_img', 'unsup_teacher_img', 'unsup_student_img',
                'unsup_student_2_img', 'unsup_teacher_mix_img',
                'unsup_student_mix_img', 'unsup_student_2_mix_img'):
        batch[key] = rs.randn(2, 64, 64, 3).astype(np.float32)
    for idx in (1, 2):
        masks = np.ones((2, 64, 64), np.float32)
        masks[0, 8 * idx:32 + 8 * idx, 16:48] = 0
        batch[f'dbg_um_cutmix_mask_{idx}'] = masks
        batch[f'dbg_um_patchmix_perm_{idx}'] = np.array(
            [[2, 0, 3, 1], [1, 0, 3, 2]], np.int32)[::3 - 2 * idx].copy()
    out = {}
    for model, device in zip(_vit_pair(cuda), ('cpu', cuda)):
        state = create_train_state(model, ema=True)
        step = make_semi_train_step(model, flags, num_classes=5,
                                    base_lr=0.01, max_iters=100)
        before = (fa.launch_count, fa.fused_launch_count)
        state, logs = step(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()},
                           torch.Generator(device=device).manual_seed(0))
        launches = (fa.launch_count - before[0],
                    fa.fused_launch_count - before[1])
        out[str(device)] = ({k: float(v) for k, v in logs.items()},
                            {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items()}, launches)
    (lc, sc, nc), (lg, sg, ng) = out['cpu'], out[str(cuda)]
    assert nc == (0, 0) and ng == (12, 8)
    assert 0 < lc['mask_ratio'] < 1 and lc['unsup.loss_ncr_unsup_2'] > 0
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * max(abs(v), 1e-3), k
    for k, v in sc.items():
        assert (sg[k].float() - v.float()).abs().max().item() <= 1e-4, k


@pytest.mark.parametrize('heads', [6, 3])
@pytest.mark.parametrize('dtype,tol,bwd_tol', [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 2e-2, 1e-2)])
def test_kernels_at_a_tensor_parallel_rank_heads(cuda, heads, dtype, tol,
                                                 bwd_tol):
    """Kernel #1 and the fused backward at the heads of a tensor-parallel
    rank of DeiT-B (12 heads over a model axis of 2 and of 4): q, k, v
    views of the rank's [B, L, 3 H 64] product (an H stride of 64
    elements), B = 8, L = 1025, with and without the PASA bias."""
    from s4former_tpu_torch.semi.pasa import build_pasa_bias
    for pasa in (False, True):
        q, k, v, _, do = _grad_inputs(cuda, 8, 1025, heads, dtype, None)
        assert q.stride()[1:] == (3 * heads * 64, 64, 1)
        bias = None
        if pasa:
            g = torch.Generator(device=cuda).manual_seed(5)
            bias = build_pasa_bias(torch.rand((8, 1024), generator=g,
                                              device=cuda), 5.0,
                                   adaptive=True).to(dtype)
        before = (fa.launch_count, fa.fused_launch_count)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        got = fa.launch_bwd_fused(q, k, v, bias, do, lse,
                                  fa.row_delta(o, do))
        torch.cuda.synchronize()
        assert (fa.launch_count - before[0],
                fa.fused_launch_count - before[1]) == (1, 1)
        ro, rlse = fa.flash_attention_reference(q, k, v, bias)
        assert (o.float() - ro.float()).abs().max().item() <= tol
        assert (lse - rlse).abs().max().item() <= 1e-3
        ref = fa.flash_attention_backward_reference(q, k, v, bias, o, lse,
                                                    do)
        _assert_grads_close(got, ref, bwd_tol)


def test_use_flash_off_launches_no_kernel(cuda):
    """``use_flash=False`` is the config's choice of the plain attention:
    a forward launches no kernel; the default launches kernel #1 in every
    layer."""
    from s4former_tpu_torch.registry import BACKBONES
    import s4former_tpu_torch.models  # noqa: F401
    x = torch.randn((1, 64, 64, 3), device=cuda)
    for use_flash, want in ((False, 0), (True, 2)):
        torch.manual_seed(0)
        model = BACKBONES.build(dict(
            type='VisionTransformer', img_size=(64, 64), patch_size=16,
            embed_dims=128, num_layers=2, num_heads=2, out_indices=(1,),
            use_flash=use_flash)).to(cuda)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.02)
        before = fa.launch_count
        with torch.no_grad():
            out = model(x)[0]
        torch.cuda.synchronize()
        assert fa.launch_count - before == want
        assert torch.isfinite(out).all()


def test_row_split_partials_round_once(cuda):
    """A row-split product of 2 model ranks (``partial_product`` of each
    rank's input columns, summed, the bias added) rounds its f32 sum to
    bf16 once, as the unsplit product does: almost every output equals the
    unsplit one, where a sum of bf16-rounded partials moves many by an
    ulp; the gradients are the unsplit product's."""
    from s4former_tpu_torch.models.backbones.vit import (linear,
                                                         partial_product)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((8, 1025, 3072), generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    w = (0.02 * torch.randn((768, 3072), generator=g,
                            device=cuda)).requires_grad_()
    b = 0.02 * torch.randn(768, generator=g, device=cuda)
    bf16 = torch.bfloat16
    whole = linear(x, w, b, bf16)
    cols = [slice(0, 1536), slice(1536, 3072)]
    split = (sum(partial_product(x[..., c], w[:, c], bf16) for c in cols) +
             b.to(bf16).float()).to(bf16)
    rounded = sum(linear(x[..., c], w[:, c], None, bf16) for c in cols) + \
        b.to(bf16)
    once = (split != whole).float().mean().item()
    twice = (rounded != whole).float().mean().item()
    print(f'row-split outputs that differ from the unsplit product: f32 '
          f'partials {once:.6f}, bf16 partials {twice:.6f}')
    assert once < 0.01 < twice
    go = torch.randn(whole.shape, generator=g, device=cuda).to(bf16)
    for a, r in zip(torch.autograd.grad(split, (x, w), go),
                    torch.autograd.grad(whole, (x, w), go)):
        assert torch.equal(a, r)


def test_ade_150_class_step_matches_cpu(cuda):
    """One flagship S4Former step (EMA, PASA, PatchShuffle + CutMix with
    injected boxes and permutations, NCR) with 150 classes on the decode
    head and both aux heads, labels 0-149 and 255 as ADE20K's
    ``reduce_zero_label`` leaves them, on the card and on the CPU from the
    same weights: losses within 1e-4 relative, the updated parameters
    within 1e-4 abs; 2 layers x 3 forward and 2 fused backward launches."""
    from s4former_tpu_torch.models import build_segmentor
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    cpu, gpu = _vit_pair(cuda)
    models = []
    for model in (cpu, gpu):
        cfg = _vit_cfg()
        for head in [cfg['decode_head']] + cfg['auxiliary_head']:
            head['num_classes'] = 150
        wide = build_segmentor(cfg)
        sd = model.state_dict()
        gen = torch.Generator().manual_seed(3)
        wide.load_state_dict({k: sd[k] if sd[k].shape == v.shape else
                              0.02 * torch.randn(v.shape, generator=gen)
                              for k, v in wide.state_dict().items()})
        models.append(wide.to(next(model.parameters()).device))
    flags = SemiConfig(
        ema=True, ema_momentum=0.99, unsup_weight=1.0, unsup_confidence=0.0,
        attn_mask_seperate_head=True, attn_mask_weight=5.0,
        adaptive_attn_mask=True, use_PatchShuffle_w_Cutmix=True,
        PatchMix_N=2, negative_class_ranking=True,
        negative_class_ranking_mode='unsup_only')
    rs = np.random.RandomState(2)
    gt = rs.randint(0, 150, (2, 64, 64)).astype(np.int32)
    gt[rs.rand(2, 64, 64) < 0.1] = 255
    masks = np.ones((2, 64, 64), np.float32)
    masks[0, 8:40, 16:48] = 0
    masks[1, 0:32, 24:56] = 0
    batch = {'sup_gt': gt, 'dbg_cutmix_mask': masks,
             'dbg_patchmix_perm': np.array([[1, 0, 3, 2], [2, 3, 0, 1]],
                                           np.int32)}
    for key in ('sup_img', 'unsup_teacher_img', 'unsup_student_img'):
        batch[key] = rs.randn(2, 64, 64, 3).astype(np.float32)
    out = {}
    for model, device in zip(models, ('cpu', cuda)):
        state = create_train_state(model, ema=True)
        step = make_semi_train_step(model, flags, num_classes=150,
                                    base_lr=0.01, max_iters=100)
        before = (fa.launch_count, fa.fused_launch_count)
        state, logs = step(state, {k: torch.from_numpy(v).to(device)
                                   for k, v in batch.items()},
                           torch.Generator(device=device).manual_seed(0))
        launches = (fa.launch_count - before[0],
                    fa.fused_launch_count - before[1])
        out[str(device)] = ({k: float(v) for k, v in logs.items()},
                            {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items()}, launches)
    (lc, sc, nc), (lg, sg, ng) = out['cpu'], out[str(cuda)]
    assert nc == (0, 0) and ng == (6, 4)
    assert lc['mask_ratio'] > 0 and lc['unsup.loss_ncr_unsup'] > 0
    assert sc['decode_head.conv_seg.weight'].shape[0] == 150
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * max(abs(v), 1e-3), k
    for k, v in sc.items():
        assert (sg[k].float() - v.float()).abs().max().item() <= 1e-4, k
