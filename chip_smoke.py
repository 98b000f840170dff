#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``s4former_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source, started together), holds each kernel to its plain PyTorch version
on the card, then drives the port's two paths through its entry points:

- serving: the flagship model (DeiT-B SETR-PUP at 512², seeded random
  weights) once in f32 against the same model on the CPU, then in the
  config's bf16 over the fixture images, plain and with the teacher-PASA
  bias;
- training: the S4Former step (``semi.train_step``) of
  ``..._MT_w_ours.py``, one f32 step against the same step on the CPU at
  4 layers, then bf16 at full depth on 8+8 fixture images at 512² (timed
  and profiled), one step each of ``..._MT.py`` and ``..._sup.py``, and
  supervised steps at 768² crops (L = 2305 tokens: the two-kernel
  backward), the first, 3 timed and 1 profiled.

Every phase prints one JSON line; any failed check raises and the script
exits nonzero without its last line. Each path runs with the kernels'
launch counts set to 0 just before it and read just after. The line before
the last lists the kernels; the last line is the device summary
``{"ok": true, "device": {...}}``. Without CUDA it fails at once: there is
no CPU fallback. Imports nothing of JAX or of the JAX package.
"""
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
_CFG_STEM = os.path.join(REPO, 'configs', 'setr', 'setr_deit-base_pup_bs_8_'
                         '512x512_80k_pascal_1over16_split_classic_')
CONFIGS = {'sup': _CFG_STEM + 'sup.py',
           'MT': _CFG_STEM + 'semi_beta_1_th_0.95_MT.py',
           'ours': _CFG_STEM + 'semi_beta_1_th_0.95_MT_w_ours.py'}
CONFIG = CONFIGS['sup']
IMAGES = os.path.join(REPO, 'data', 'fixtures', 'voc_mini', 'JPEGImages',
                      '*.jpg')
LABELS = os.path.join(REPO, 'data', 'fixtures', 'voc_mini',
                      'SegmentationClass')
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 without
# tensor cores (the f32 kernel must not round to TF32), HBM3 bandwidth
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain on the card. f32: the same f32 sums in another order.
# bf16: both read the same bf16 q, k, v and score in f32; o is rounded to
# bf16 (half an ulp of |o| <= ~4 is 1.6e-2) after sums in another order
TOL = {'float32': {'o': 1e-4, 'lse': 1e-4},
       'bfloat16': {'o': 2e-2, 'lse': 1e-3}}
# main path f32, card vs CPU, on softmax probabilities: 12 layers and 5
# convs of f32 sums in another order (cuBLAS/cuDNN vs the CPU's kernels)
TOL_MAIN_F32 = 1e-3
# backward kernels vs the plain backward: the max abs error of each of dq,
# dk, dv over that gradient's max |value|. Both compute p and ds alike; the
# fused kernel's dq adds its k tiles' sums atomically, in a run-dependent
# order, and in bf16 every kernel sums its products on the tensor cores in
# another order than cuBLAS. f32: those sums in another order; bf16: then
# the rounding of each gradient to bf16, which moves it by at most one ulp,
# 2^-7 = 7.8e-3 of its max |value|
TOL_BWD = {'float32': 1e-4, 'bfloat16': 1e-2}
# the backward kernels' L x L x D products and the [B, L, H, D] outputs
# they write (each reads q, k, v, o, do): the fused kernel does s, dp, dv,
# dk and dq, the dk/dv kernel all but dq, the dq kernel s, dp and dq
BWD_WORK = {'flash_attn_bwd_fused': (5, 3), 'flash_attn_bwd_dkv': (4, 2),
            'flash_attn_bwd_dq': (3, 1)}
# one f32 training step, card vs CPU: losses relative, parameter updates
# relative to the largest CPU update (4 layers, 5 heads, f32 sums in
# another order, and pseudo-labels thresholded on the teacher's output)
TOL_TRAIN_F32 = 1e-3
# the teacher's max softmax probability over 21 classes with the seeded
# random weights of the 4-layer f32 model lies in 0.05-0.082 (median 0.072)
# on the fixture image, so 0.1 would leave no pixel confident; 0.07 makes
# about half of them confident and the unsup losses live
UNSUP_CONFIDENCE_F32 = 0.07
KERNELS = ('flash_attn_fwd', 'flash_attn_bwd_fused', 'flash_attn_bwd_dkv',
           'flash_attn_bwd_dq')
# the bf16 device functions that must run on the tensor cores, fed by
# asynchronous copies (the build phase reads their SASS), and how many
# instances of each the libraries hold: with and without a bias, and the
# dk/dv template with and without the fused dq
TC_KERNELS = {'flash_attn_fwd_tc_kernel': 2, 'flash_attn_bwd_kv_tc_kernel': 4,
              'flash_attn_bwd_dq_tc_kernel': 2}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, iters=50, warmup=5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters=20) -> float:
    """Device time of one ``fn()`` replayed from a CUDA graph: a library
    call's time without the host's dispatch, which at the smaller shapes
    takes longer than the call's kernels and would be timed instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, iters=iters, warmup=2)
    del graph
    return ms


def attention_inputs(b, l, h, dtype, bias_kind, gen):
    """q, k, v as the ViT makes them (strided views of one fused qkv
    projection) and a bias of the given kind, in their dtype."""
    import torch
    from s4former_tpu_torch.semi.pasa import build_pasa_bias
    d = 64
    qkv = torch.randn((b, l, 3 * h * d), generator=gen, device='cuda')
    q, k, v = [t.view(b, l, h, d) for t in qkv.to(dtype).split(h * d, -1)]
    if bias_kind is None:
        bias = None
    elif bias_kind == 'pasa':
        unconf = torch.rand((b, l - 1), generator=gen, device='cuda')
        bias = build_pasa_bias(unconf, 5.0, adaptive=True)
    else:
        heads = 1 if bias_kind == 'random_b1' else h
        bias = torch.randn((b, heads, l, l), generator=gen, device='cuda')
    return q, k, v, None if bias is None else bias.to(dtype)


def bound_ms(q, bias, n_products, n_tensors):
    """Least time on the card for attention-shaped work on q's shapes: the
    larger of its ``n_products`` L x L x D products (2 L^2 D FLOP each per
    image and head) over the dtype's peak, and its bytes over HBM bandwidth:
    ``n_tensors`` [B, L, H, D] tensors read or written once, one f32 row
    statistic [B, H, L], and the bias read once (per image, or per head
    when it has one per head)."""
    b, l, h, d = q.shape
    elt = q.element_size()
    flops = 2.0 * l * l * d * n_products * b * h
    nbytes = n_tensors * b * l * h * d * elt + b * h * l * 4
    if bias is not None:
        nbytes += b * bias.shape[1] * l * l * elt
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace('torch.', '')] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def check_forward(fa, q, k, v, bias, o, lse, where):
    """The forward kernel's o and lse against the plain forward at TOL.
    Returns the max abs error of o."""
    import torch
    ro, rlse = fa.flash_attention_reference(q, k, v, bias)
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    tol = TOL[str(q.dtype).replace('torch.', '')]
    check(torch.isfinite(o).all().item(), f'non-finite o {where}')
    check(err_o <= tol['o'] and err_lse <= tol['lse'],
          f'forward kernel disagrees with plain: {where} err_o={err_o} '
          f'err_lse={err_lse}')
    return err_o, err_lse


def forward_times(fa, q, k, v, bias):
    """The forward kernel's time, its plain version's, the library call's
    (F.scaled_dot_product_attention with the same mask, replayed from a
    CUDA graph) and its bound, at these inputs."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {'ms': cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, bias)),
           'plain_ms': cuda_time_ms(
               lambda: fa.flash_attention_reference(q, k, v, bias), iters=5,
               warmup=1),
           'library_ms': graph_time_ms(
               lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=bias))}
    # 2 products (q k^T, p v); q, k, v read, o written, lse
    out['bound_ms'], out['bound_by'] = bound_ms(q, bias, 2, 4)
    return out


def phase_kernels(fa):
    """Kernel vs plain version on the card at the main path's shapes, plus
    the ragged L=130. Returns the kernels line's entry."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, bias_kind in ((2, 1025, 'pasa'), (2, 1025, 'random_b1'),
                                (2, 1025, 'random_bh'), (2, 1025, None),
                                (2, 130, 'random_b1'), (2, 130, None),
                                (1, 1025, None), (1, 1025, 'pasa')):
            q, k, v, bias = attention_inputs(b, l, 12, dtype, bias_kind, gen)
            o, lse = fa.flash_attention_fwd(q, k, v, bias)
            name = str(dtype).replace('torch.', '')
            tol = TOL[name]
            err_o, err_lse = check_forward(fa, q, k, v, bias, o, lse,
                                           f'{name} B={b} L={l} '
                                           f'bias={bias_kind}')
            case = dict(dtype=name, B=b, L=l, H=12, D=64, bias=bias_kind,
                        max_abs_err=err_o, lse_max_abs_err=err_lse,
                        tol_o=tol['o'], tol_lse=tol['lse'])
            if l == 1025:
                case.update(forward_times(fa, q, k, v, bias))
            cases.append(case)
            emit({'phase': 'kernel_check', **case})
    # the headline entry: the shape and type the served requests launch
    main = next(c for c in cases if c['dtype'] == 'bfloat16' and
                c['B'] == 1 and c['bias'] is None)
    return {'name': 'flash_attn_fwd', 'route': 'cuda',
            'source': 's4former_tpu_torch/ops/csrc/flash_attn_fwd.cu',
            'replaces': 's4former_tpu/ops/flash_attention.py:88',
            'launches': None,
            'max_abs_err': max(c['max_abs_err'] for c in cases
                               if c['dtype'] == 'bfloat16'),
            'ms': main['ms'], 'kernel_ms': main['ms'],
            'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
            'bound_by': main['bound_by'], 'library_ms': main['library_ms'],
            'shape': 'B=1 L=1025 H=12 D=64 bfloat16, no bias',
            'cases': [c for c in cases if 'ms' in c]}


def counts(fa):
    return {'flash_attn_fwd': fa.launch_count,
            'flash_attn_bwd_fused': fa.fused_launch_count,
            'flash_attn_bwd_dkv': fa.dkv_launch_count,
            'flash_attn_bwd_dq': fa.dq_launch_count}


def reset_counts(fa):
    fa.launch_count = fa.fused_launch_count = 0
    fa.dkv_launch_count = fa.dq_launch_count = 0


def grad_errors(got, ref):
    """max abs error and max |value| of the plain gradient, per gradient:
    ([err_dq, err_dk, err_dv], [max_dq, max_dk, max_dv])."""
    errs = [(a.float() - r.float()).abs().max().item()
            for a, r in zip(got, ref)]
    return errs, [r.float().abs().max().item() for r in ref]


def phase_kernels_bwd(fa):
    """Each backward kernel vs the plain backward on the card, at the
    training path's shapes (B = 8 and the fused 2B pass's 16 at L = 1025,
    no bias / PASA / per-head bias), the ragged L = 130 and L = 2305 (768²
    crops); the forward that gives them o and lse is held to the plain
    forward at each. Times at the headline shapes, and the forward's at
    the training shapes. Returns the kernels line's entries, the forward's
    max abs error in bf16 and its timed cases."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(1)
    shapes = [(1, 1025, None), (1, 1025, 'pasa'), (1, 1025, 'random_bh'),
              (2, 1025, None), (2, 1025, 'pasa'), (8, 1025, None),
              (16, 1025, 'pasa'), (2, 130, 'random_b1'), (2, 130, None),
              (2, 2305, None), (1, 2305, 'pasa')]
    timed = {('bfloat16', 1, 1025, None), ('bfloat16', 8, 1025, None),
             ('bfloat16', 16, 1025, 'pasa'), ('bfloat16', 2, 2305, None),
             ('bfloat16', 1, 2305, 'pasa')}
    # the training step's forward shapes (teacher and sup pass; 2B pass)
    fwd_timed = {('bfloat16', 8, 1025, None), ('bfloat16', 16, 1025, 'pasa')}
    fwd_cases = []
    launchers = {'flash_attn_bwd_fused': fa.launch_bwd_fused,
                 'flash_attn_bwd_dkv': fa.launch_bwd_dkv,
                 'flash_attn_bwd_dq': fa.launch_bwd_dq}
    entries = {name: [] for name in BWD_WORK}
    fwd_err_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace('torch.', '')
        for b, l, bias_kind in shapes:
            where = f'{dname} B={b} L={l} bias={bias_kind}'
            q, k, v, bias = attention_inputs(b, l, 12, dtype, bias_kind, gen)
            do = torch.randn(q.shape, generator=gen, device='cuda').to(dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, bias)
            err_o, err_lse = check_forward(fa, q, k, v, bias, o, lse, where)
            fwd_case = dict(dtype=dname, B=b, L=l, H=12, D=64,
                            bias=bias_kind, max_abs_err=err_o,
                            lse_max_abs_err=err_lse, tol_o=TOL[dname]['o'],
                            tol_lse=TOL[dname]['lse'])
            if (dname, b, l, bias_kind) in fwd_timed:
                fwd_case.update(forward_times(fa, q, k, v, bias))
                fwd_cases.append(fwd_case)
            emit({'phase': 'kernel_check', **fwd_case,
                  'for': 'kernel_check_bwd'})
            if dname == 'bfloat16':
                fwd_err_bf16 = max(fwd_err_bf16, err_o)
            delta = fa.row_delta(o, do)
            args = (q, k, v, bias, do, lse, delta)
            ref = fa.flash_attention_backward_reference(q, k, v, bias, o, lse,
                                                        do)
            dk, dv = fa.launch_bwd_dkv(*args)
            runs = {'flash_attn_bwd_dkv': (ref[0], dk, dv),
                    'flash_attn_bwd_dq': (fa.launch_bwd_dq(*args),) + ref[1:]}
            if l <= fa.FULL_Q_MAX:
                runs['flash_attn_bwd_fused'] = fa.launch_bwd_fused(*args)
            torch.cuda.synchronize()
            tol = TOL_BWD[dname]
            is_timed = (dname, b, l, bias_kind) in timed
            if is_timed:    # one plain and one library time per shape
                plain_ms = cuda_time_ms(
                    lambda: fa.flash_attention_backward_reference(
                        q, k, v, bias, o, lse, do), iters=5, warmup=1)
                library_ms = sdpa_backward_ms(q, k, v, bias, do)
            for name, got in runs.items():
                errs, peaks = grad_errors(got, ref)
                rel = max(e / p for e, p in zip(errs, peaks))
                case = dict(dtype=dname, B=b, L=l, H=12, D=64,
                            bias=bias_kind, max_abs_err=max(errs),
                            abs_err_dq_dk_dv=errs, max_abs_dq_dk_dv=peaks,
                            max_rel_err=rel, tol=tol)
                if is_timed:
                    case['ms'] = cuda_time_ms(
                        lambda: launchers[name](*args), iters=10, warmup=2)
                    case['plain_ms'] = plain_ms
                    case['library_ms'] = library_ms
                    products, outputs = BWD_WORK[name]
                    case['bound_ms'], case['bound_by'] = bound_ms(
                        q, bias, products, 5 + outputs)
                entries[name].append(case)
                emit({'phase': 'kernel_check_bwd', 'kernel': name, **case})
                check(all(torch.isfinite(t).all().item() for t in got),
                      f'non-finite {name} {where}')
                check(rel <= tol, f'{name} disagrees with the plain backward:'
                      f' {where} err={errs} max |grad|={peaks}')
            del ref, runs, args, o, lse, do, dk, dv, delta
    out = {}
    headline = {'flash_attn_bwd_fused': (16, 1025, 'pasa'),
                'flash_attn_bwd_dkv': (2, 2305, None),
                'flash_attn_bwd_dq': (2, 2305, None)}
    for name, cases in entries.items():
        b, l, bias_kind = headline[name]
        main = next(c for c in cases if c['dtype'] == 'bfloat16' and
                    (c['B'], c['L'], c['bias']) == (b, l, bias_kind))
        out[name] = {
            'name': name, 'route': 'cuda',
            'source': 's4former_tpu_torch/ops/csrc/flash_attn_bwd.cu',
            'replaces': {'flash_attn_bwd_fused':
                         's4former_tpu/ops/flash_attention.py:251',
                         'flash_attn_bwd_dkv':
                         's4former_tpu/ops/flash_attention.py:197',
                         'flash_attn_bwd_dq':
                         's4former_tpu/ops/flash_attention.py:372'}[name],
            'launches': None,
            'max_abs_err': max(c['max_abs_err'] for c in cases
                               if c['dtype'] == 'bfloat16'),
            'max_rel_err': max(c['max_rel_err'] for c in cases
                               if c['dtype'] == 'bfloat16'),
            'max_rel_err_is': 'max abs error / max |grad|, per gradient, bf16',
            'ms': main['ms'], 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': main['library_ms'],
            'shape': f'B={b} L={l} H=12 D=64 bfloat16, bias={bias_kind}',
            'cases': [c for c in cases if 'ms' in c]}
    return out, fwd_err_bf16, fwd_cases


def sdpa_backward_ms(q, k, v, bias, do):
    """The backward of F.scaled_dot_product_attention with the same mask
    (dq, dk and dv together: the library call that covers each of the
    three kernels): forward + torch.autograd.grad, minus the forward, each
    replayed from a CUDA graph."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    return graph_time_ms(fwd_bwd) - graph_time_ms(fwd)


def load_config(dtype, name='sup', num_layers=None):
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(CONFIGS[name])
    if dtype is not None:
        cfg.model.backbone.dtype = dtype
        cfg.model.decode_head.dtype = dtype
        for head in cfg.model.auxiliary_head:
            head.dtype = dtype
    if num_layers is not None:
        cfg.model.backbone.num_layers = num_layers
        cfg.model.backbone.out_indices = tuple(range(num_layers))
    return cfg


def phase_main_f32(fa, images):
    """The flagship in f32 on the card against the same weights on the
    CPU, one 512² request. Returns the card's probabilities."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config('float32')
    gpu = init_segmentor(cfg, seed=0, device='cuda')
    cpu = init_segmentor(cfg, seed=0, device='cpu')
    x, _ = _prepare_image(gpu, images[0])
    check(x.shape == (1, 512, 512, 3), f'request shape {x.shape}')
    fa.launch_count = 0
    p_gpu = gpu.probs(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    launches = fa.launch_count
    check(launches == 12, f'f32 forward launched the kernel {launches} '
          f'times, not 12')
    t0 = time.perf_counter()
    p_cpu = cpu.probs(torch.from_numpy(x))
    cpu_s = time.perf_counter() - t0
    check(fa.launch_count == 12, 'the CPU forward reached the kernel')
    check(p_gpu.shape == (1, 512, 512, 21), f'probs shape {p_gpu.shape}')
    check(torch.isfinite(p_gpu).all().item(), 'non-finite f32 probs')
    err = (p_gpu.cpu() - p_cpu).abs().max().item()
    agree = (p_gpu.cpu().argmax(-1) == p_cpu.argmax(-1)).float().mean()
    emit({'phase': 'main_f32_vs_cpu', 'launches': launches,
          'probs_max_abs_err': err, 'tol': TOL_MAIN_F32,
          'argmax_agreement': agree.item(), 'cpu_forward_s': cpu_s})
    check(err <= TOL_MAIN_F32, f'f32 card vs CPU probs differ by {err}')
    del gpu, cpu
    torch.cuda.empty_cache()
    return p_gpu


def phase_main_bf16(fa, images, p_f32, gpu_line):
    """The flagship as configured (bf16): inference_segmentor serves every
    fixture image, inference_with_teacher_pasa two of them."""
    import numpy as np
    import torch
    from PIL import Image
    from s4former_tpu_torch.apis import (_prepare_image, inference_segmentor,
                                         inference_with_teacher_pasa,
                                         init_segmentor)
    cfg = load_config(None)
    check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
    seg = init_segmentor(cfg, seed=0, device='cuda')
    teacher = init_segmentor(cfg, seed=1, device='cuda').model.state_dict()
    ema = {k: v for k, v in teacher.items()
           if k.startswith(('backbone.', 'decode_head.'))}
    inference_segmentor(seg, images[0])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, pasa_lat = [], []
    reset_counts(fa)                               # the main path starts
    for path in images:
        with Image.open(path) as im:
            hw = (im.height, im.width)
        before = fa.launch_count
        t0 = time.perf_counter()
        labels = inference_segmentor(seg, path)   # ends in a device->host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
        n = fa.launch_count - before
        check(n == 12, f'request launched the kernel {n} times, not 12')
        check(labels.shape == hw and labels.min() >= 0 and labels.max() < 21,
              f'bad label map for {path}')
    peak = torch.cuda.max_memory_allocated()
    for path in images[:2]:
        with Image.open(path) as im:
            hw = (im.height, im.width)
        before = fa.launch_count
        t0 = time.perf_counter()
        labels = inference_with_teacher_pasa(seg, path, ema)
        pasa_lat.append((time.perf_counter() - t0) * 1e3)
        n = fa.launch_count - before
        check(n == 24, f'teacher-PASA request launched the kernel {n} '
              f'times, not 24 (teacher + student)')
        check(labels.shape == hw, f'bad PASA label map for {path}')
    path_counts = counts(fa)                       # the main path ends
    launches = path_counts['flash_attn_fwd']
    lat = np.asarray(latencies)
    prep = []                  # the host's decode + normalise + pad alone
    for path in images:
        t0 = time.perf_counter()
        _prepare_image(seg, path)
        prep.append((time.perf_counter() - t0) * 1e3)
    x, _ = _prepare_image(seg, images[0])
    p_bf16 = seg.probs(torch.from_numpy(x).cuda())
    check(torch.isfinite(p_bf16).all().item(), 'non-finite bf16 probs')
    emit({'phase': 'main_bf16', 'requests': len(images),
          'request_ms': [round(t, 3) for t in latencies],
          'request_ms_mean': float(lat.mean()),
          'request_ms_p50': float(np.median(lat)),
          'request_ms_max': float(lat.max()),
          'img_per_s': len(images) / (lat.sum() / 1e3),
          'prepare_ms_mean': float(np.mean(prep)),
          'pasa_request_ms': pasa_lat,
          'peak_mem_bytes': peak,
          'bf16_vs_f32_probs_max_abs_diff':
              (p_bf16 - p_f32).abs().max().item(),
          'bf16_vs_f32_argmax_agreement':
              (p_bf16.argmax(-1) == p_f32.argmax(-1)).float().mean().item(),
          'launches': path_counts, 'gpu': gpu_line})
    check(path_counts['flash_attn_bwd_fused'] == 0 and
          path_counts['flash_attn_bwd_dkv'] == 0, 'serving ran a backward')
    return seg, path_counts


def device_profile(fn, n_top):
    """Run ``fn()`` once under torch.profiler: (its result, the wall time,
    the device time by kernel and the device's busy share of the wall
    time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and
                   ev.self_device_time_total > 0), reverse=True)
    device_us = sum(r[0] for r in rows)
    return out, {'wall_us': wall_us, 'device_us': device_us,
                 'device_busy_share': device_us / wall_us,
                 'top': [{'kernel': k[:100], 'device_us': us, 'calls': n}
                         for us, k, n in rows[:n_top]]}


def phase_profile(seg, images):
    """Device time by kernel over one bf16 request, and the device's busy
    share of the request's wall time."""
    from s4former_tpu_torch.apis import inference_segmentor
    _, prof = device_profile(lambda: inference_segmentor(seg, images[1]), 14)
    emit({'phase': 'profile_bf16_request', **prof})


def fixture_arrays(images, size):
    """Normalised NHWC images and their label maps, padded bottom/right to
    size x size (image 0, label 255) as the configs' Pad does, or cropped
    top-left where larger."""
    import numpy as np
    from PIL import Image
    from s4former_tpu_torch.apis import _DEFAULT_NORM
    mean = np.asarray(_DEFAULT_NORM['mean'], np.float32)
    std = np.asarray(_DEFAULT_NORM['std'], np.float32)
    xs, ys = [], []
    for path in images:
        stem = os.path.splitext(os.path.basename(path))[0]
        with Image.open(path) as im:
            x = (np.asarray(im.convert('RGB'), np.float32) - mean) / std
        with Image.open(os.path.join(LABELS, stem + '.png')) as im:
            y = np.asarray(im).astype(np.int64)
        x, y = x[:size, :size], y[:size, :size]
        h, w = y.shape
        xs.append(np.pad(x, ((0, size - h), (0, size - w), (0, 0))))
        ys.append(np.pad(y, ((0, size - h), (0, size - w)),
                         constant_values=255))
    return np.stack(xs), np.stack(ys)


def train_batch(images, n_sup, n_unsup, size=512):
    """The step's batch: sup images + labels, and unsup images for the
    teacher and the student (the same views: the augmentation pipelines
    are not ported)."""
    x, y = fixture_arrays(images[:n_sup + n_unsup], size)
    batch = {'sup_img': x[:n_sup], 'sup_gt': y[:n_sup]}
    if n_unsup:
        batch['unsup_teacher_img'] = x[n_sup:]
        batch['unsup_student_img'] = x[n_sup:]
    return batch


def step_kwargs(cfg):
    """make_semi_train_step's schedule and optimizer from a config."""
    opt, lr = cfg.optimizer, cfg.lr_config
    keys = (opt.get('paramwise_cfg') or {}).get('custom_keys') or {}
    return dict(base_lr=opt.lr, max_iters=cfg.runner.max_iters,
                power=lr.power, min_lr=lr.min_lr, sgd_momentum=opt.momentum,
                weight_decay=opt.weight_decay,
                custom_keys={k: v['lr_mult'] for k, v in keys.items()})


def make_trainer(name, device, dtype=None, num_layers=None, **semi_over):
    """(state, train_step, cfg) for config ``name`` through the port's
    entry points, with seeded random weights."""
    import dataclasses
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    cfg = load_config(dtype, name, num_layers)
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                               **semi_over)
    model = init_segmentor(cfg, seed=0, device=device).model
    state = create_train_state(model, ema=semi.ema)
    step = make_semi_train_step(model, semi, model.num_classes,
                                **step_kwargs(cfg))
    return state, step, cfg


def to_device(batch, device):
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def floats(logs):
    return {k: float(v) for k, v in logs.items()}


def phase_train_f32_vs_cpu(fa, images):
    """One S4Former step of ``..._MT_w_ours.py`` in f32 at full width, depth
    cut to 4 layers (out_indices 0-3), 1 sup + 1 unsup image at 512², the
    same CutMix box and PatchShuffle permutation: on the card and on the
    CPU from the same weights. The threshold is UNSUP_CONFIDENCE_F32 so the
    unsup losses are live. Returns the card's launch counts."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = train_batch(images, 1, 1)
    mask = np.ones((1, 512, 512), np.float32)
    mask[0, 96:352, 128:320] = 0
    batch['dbg_cutmix_mask'] = mask
    batch['dbg_patchmix_perm'] = np.random.RandomState(0).permutation(
        16)[None].astype(np.int32)
    runs = {}
    for device in ('cuda', 'cpu'):
        state, step, _ = make_trainer(
            'ours', device, 'float32', 4,
            unsup_confidence=UNSUP_CONFIDENCE_F32)
        before = {n: p.detach().cpu().clone()
                  for n, p in state.model.named_parameters()}
        dev_batch = to_device(batch, device)
        reset_counts(fa)
        t0 = time.perf_counter()
        state, logs = step(state, dev_batch,
                           torch.Generator(device=device).manual_seed(0))
        if device == 'cuda':
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        delta = {n: p.detach().cpu() - before[n]
                 for n, p in state.model.named_parameters()}
        runs[device] = (floats(logs), delta, seconds, counts(fa))
        del state, step, dev_batch
        torch.cuda.empty_cache()
    (lg, dg, sg, cg), (lc, dc, sc, cc) = runs['cuda'], runs['cpu']
    check(cg == {'flash_attn_fwd': 12, 'flash_attn_bwd_fused': 8,
                 'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0},
          f'f32 step launches {cg}')
    check(not any(cc.values()), 'the CPU step reached a kernel')
    check(sorted(lg) == sorted(lc), 'log keys differ')
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc}
    scale = max(d.abs().max().item() for d in dc.values())
    upd_err = max((dg[n] - dc[n]).abs().max().item() for n in dc)
    emit({'phase': 'train_f32_vs_cpu', 'config': 'ours',
          'cut': 'num_layers 12 -> 4, out_indices (0, 1, 2, 3)',
          'batch': f'1 sup + 1 unsup at 512², unsup_confidence '
                   f'{UNSUP_CONFIDENCE_F32}',
          'losses_card': lg, 'losses_cpu': lc, 'loss_rel_err': loss_err,
          'update_max_abs_err': upd_err, 'update_max_abs_cpu': scale,
          'tol': TOL_TRAIN_F32, 'card_step_s': sg, 'cpu_step_s': sc,
          'launches': cg})
    check(lc['mask_ratio'] > 0 and lc['unsup.loss_seg_unsup'] > 0,
          'the unsup losses are not live')
    check(all(np.isfinite(v) for v in lg.values()), 'non-finite losses')
    check(max(loss_err.values()) <= TOL_TRAIN_F32,
          f'f32 losses, card vs CPU: {loss_err}')
    check(upd_err <= TOL_TRAIN_F32 * scale,
          f'f32 parameter updates differ by {upd_err} (max {scale})')
    return cg


def timed_steps(state, step, batch, gen, n):
    import torch
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, logs = step(state, batch, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, logs, ms


def phase_train_bf16(fa, images, gpu_line):
    """The flagship ``..._MT_w_ours.py`` as written (bf16, 12 layers), the
    global batch of bench.py on one card: 8 sup + 8 unsup fixture images at
    512². 2 warm-up steps, 5 timed. Returns (state, step, batch, gen,
    counts of the timed steps)."""
    import numpy as np
    import torch
    state, step, cfg = make_trainer('ours', 'cuda')
    check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
    batch = to_device(train_batch(images, 8, 8), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    state, _, warm_ms = timed_steps(state, step, batch, gen, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 5)
    path_counts = counts(fa)                       # the main path ends
    lg = floats(logs)
    ms_arr = np.asarray(ms)
    emit({'phase': 'train_bf16', 'config': 'ours', 'batch': '8 + 8 at 512²',
          'warmup_step_ms': warm_ms, 'step_ms': ms,
          'step_ms_mean': float(ms_arr.mean()),
          'step_ms_p50': float(np.median(ms_arr)),
          'img_per_s': 16 / (ms_arr.mean() / 1e3),
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'mask_ratio': lg['mask_ratio'], 'logs': lg,
          'launches': path_counts,
          'launches_per_step': {k: v / 5 for k, v in path_counts.items()},
          'gpu': gpu_line})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check(path_counts == {'flash_attn_fwd': 36 * 5,
                          'flash_attn_bwd_fused': 24 * 5,
                          'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0},
          f'flagship step launches {path_counts}, not 36 forward and 24 '
          f'fused backward a step')
    return state, step, batch, gen, path_counts


def phase_profile_train(state, step, batch, gen):
    """Device time by kernel over one flagship bf16 step, and the device's
    busy share of the step's wall time."""
    (state, _), prof = device_profile(lambda: step(state, batch, gen), 20)
    emit({'phase': 'profile_train_step', 'config': 'ours', **prof})
    return state


def phase_train_one_step(fa, images, phase, name, n_sup, n_unsup, expect,
                         size=512, timed=0):
    """One bf16 step of another flagship config through the same entry
    points; with ``timed``, that many more steps timed (the first is their
    warm-up) and one under the profiler. Checked for finite logs and the
    kernels' launch counts: ``expect`` a step. Returns the counts of all
    the steps."""
    import numpy as np
    import torch
    state, step, _ = make_trainer(name, 'cuda')
    batch = to_device(train_batch(images, n_sup, n_unsup, size), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    reset_counts(fa)
    state, logs, ms = timed_steps(state, step, batch, gen, 1 + timed)
    times = {'first_step_ms': ms[0]}
    if timed:
        (state, logs), prof = device_profile(
            lambda: step(state, batch, gen), 12)
        times.update(step_ms=ms[1:], step_ms_mean=float(np.mean(ms[1:])),
                     step_ms_p50=float(np.median(ms[1:])), profile=prof)
    path_counts = counts(fa)
    n_steps = 1 + timed + (timed > 0)
    lg = floats(logs)
    emit({'phase': phase, 'config': name,
          'batch': f'{n_sup} + {n_unsup} at {size}²',
          'tokens': (size // 16) ** 2 + 1, **times, 'logs': lg,
          'launches': path_counts})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check(path_counts == {k: n * n_steps for k, n in expect.items()},
          f'{phase}: {n_steps} steps launch {path_counts}, not {expect} a '
          f'step')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def phase_build(libs, seconds):
    """Per kernel function of the built libraries: registers and spills
    (ptxas), tensor-core instructions and asynchronous copies (SASS). Every
    instance of the bf16 kernels must hold both, and spill nothing."""
    from s4former_tpu_torch.ops import cuda_build
    functions = {}
    for lib in libs:
        info = cuda_build.ptxas_info(lib.with_suffix('.log').read_text())
        sass = cuda_build.sass_counts(cuda_build.dump_sass(lib))
        for name in sorted(set(info) | set(sass)):
            functions[name] = {**info.get(name, {}), **sass.get(name, {})}
    emit({'phase': 'build', 'seconds': seconds, 'functions': functions})
    for marker, instances in TC_KERNELS.items():
        found = {n: f for n, f in functions.items() if marker in n}
        check(len(found) == instances, f'{len(found)} instances of {marker} '
              f'in the built libraries, not {instances}')
        for name, f in found.items():
            check(f.get('tensor_core', 0) > 0 and f.get('async_copy', 0) > 0,
                  f'{name}: no tensor-core instruction or no asynchronous '
                  f'copy in its SASS: {f}')
            check(f.get('spill_stores') == 0 and f.get('spill_loads') == 0,
                  f'{name} spills registers: {f}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; the port '
              'runs on an NVIDIA GPU and has no CPU fallback here',
              file=sys.stderr)
        return 1
    gpu_line = gpu_name_and_power_limit()
    emit({'phase': 'device', 'nvidia_smi': gpu_line,
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'kind': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count()})

    sys.path.insert(0, REPO)
    from s4former_tpu_torch.ops import cuda_build
    from s4former_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    libs = cuda_build.build_all([fa.SOURCE, fa.BWD_SOURCE])
    fa.load_library()
    fa.load_bwd_library()
    phase_build(libs, time.perf_counter() - t0)

    images = sorted(glob.glob(IMAGES))
    check(len(images) == 16, f'expected 16 fixture images, found '
          f'{len(images)}')
    entries = {'flash_attn_fwd': phase_kernels(fa)}
    bwd_entries, fwd_err_train, fwd_train_cases = phase_kernels_bwd(fa)
    entries.update(bwd_entries)
    fwd = entries['flash_attn_fwd']     # the training shapes' forward too
    fwd['max_abs_err'] = max(fwd['max_abs_err'], fwd_err_train)
    fwd['cases'] += fwd_train_cases
    paths = {}
    p_f32 = phase_main_f32(fa, images)
    seg, paths['serve_bf16'] = phase_main_bf16(fa, images, p_f32, gpu_line)
    phase_profile(seg, images)
    del seg
    torch.cuda.empty_cache()

    paths['train_f32'] = phase_train_f32_vs_cpu(fa, images)
    state, step, batch, gen, paths['train_bf16'] = phase_train_bf16(
        fa, images, gpu_line)
    state = phase_profile_train(state, step, batch, gen)
    del state, step, batch, gen
    torch.cuda.empty_cache()
    # ..._MT.py takes the sequential unsup path, ..._sup.py has no unsup
    # branch
    paths['train_bf16_MT'] = phase_train_one_step(
        fa, images, 'train_bf16_MT', 'MT', 8, 8,
        {'flash_attn_fwd': 36, 'flash_attn_bwd_fused': 24,
         'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0})
    paths['train_bf16_sup'] = phase_train_one_step(
        fa, images, 'train_bf16_sup', 'sup', 8, 0,
        {'flash_attn_fwd': 12, 'flash_attn_bwd_fused': 12,
         'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0})
    # 2 images cropped/padded to 768², the Cityscapes crop of
    # configs/_base_/datasets/cityscapes_768x768_1over16_split_CPS_semi.py:
    # the pos-embed is resized at run time, and L = 2305 > FULL_Q_MAX takes
    # the dk/dv + dq kernels; the first step, 3 timed, 1 profiled
    paths['train_long'] = phase_train_one_step(
        fa, images, 'train_long', 'sup', 2, 0,
        {'flash_attn_fwd': 12, 'flash_attn_bwd_fused': 0,
         'flash_attn_bwd_dkv': 12, 'flash_attn_bwd_dq': 12}, size=768,
        timed=3)

    for name in KERNELS:
        entries[name]['launches'] = sum(p[name] for p in paths.values())
        entries[name]['launches_by_path'] = {k: p[name]
                                             for k, p in paths.items()}
        check(entries[name]['launches'] > 0, f'{name} never ran on a path')
    print(gpu_line)
    emit({'kernels': [entries[name] for name in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
