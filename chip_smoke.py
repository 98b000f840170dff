#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``s4former_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source, started together), holds each kernel to its plain PyTorch version
on the card, then drives the port's paths through its entry points:

- serving: the flagship model (DeiT-B SETR-PUP at 512², seeded random
  weights) once in f32 against the same model on the CPU, then in the
  config's bf16 over the fixture images, plain and with the teacher-PASA
  bias;
- training: the S4Former step (``semi.train_step``) of
  ``..._MT_w_ours.py``, one f32 step against the same step on the CPU at
  4 layers, then bf16 at full depth on 8+8 fixture images at 512² (timed
  and profiled), one step each of ``..._MT.py`` and ``..._sup.py``, and
  supervised steps at 768² crops (L = 2305 tokens: the two-kernel
  backward), the first, 3 timed and 1 profiled; 4 + 4 steps of
  ``..._MT_w_ours.py`` from one batch (5 timed, 1 profiled), the CLI's
  step without its loader;
- the native host library (``s4former_tpu_torch/native``, built with g++
  beside the nvcc builds): which functions are native (decode only where
  jpeglib.h and png.h were found), each held bit for bit to its plain
  PIL/numpy version on the fixture JPEGs at 500x375 and at 512², and one
  sample of the flagship pipelines (sup, strong and weak views) timed on
  the plain and the native functions, on 1 thread and on the loader's 8;
- train and evaluate: ``python -m s4former_tpu_torch.tools.train`` (run
  in-process through its ``main``) on ``setr_fixture_voc_mini_fullflag.py``
  from a backbone-only DeiT-B file with bare keys (seeded weights), for
  12 steps of 4 + 4 fixture images through the port's pipelines, loader,
  runner, exact in-loop eval at iters 6 and 12 and checkpoints;
  ``--auto-resume`` on to 15; ``tools.test`` on ``iter_12`` against the
  in-loop mIoU; then 9-step runs from the same backbone in the timm
  layout, on the native and on the plain host functions in turns, the
  last 3 steps of two of them traced (``--profile``) and read by
  ``tools/profile_trace.py``;
- test: ``tools.test`` on ``iter_12`` with ``--aug-test --show-dir``
  (six ratios and flip over the 16 fixture images) and with
  ``--format-only`` (Cityscapes label-id files); kernel #1 is held to its
  plain version at the TTA shapes in ``kernel_check``;
- the SegFormer slice (``configs/segformer/``, MiT-B4 at full width, 19
  classes, seeded weights, frames and labels made from a seed with
  numpy), which launches none of the kernels: ``..._sup.py`` serving one
  2048x1024 frame by slide inference (768² windows at stride 512) in f32
  at depth [1, 1, 2, 1] against the CPU, then in bf16 at full depth over 8
  PNGs (one request each, one profiled); one f32 step of
  ``..._MT_w_ours.py`` at depth [1, 1, 1, 1], 1 + 1 at 768², drop rates 0,
  against the CPU; the bf16 step at full depth and the config's 4 + 4,
  drop path and dropout live (the first, 3 timed, 1 profiled by operator
  class); ``tools.train`` on a seeded Cityscapes tree (6 steps, slide eval
  and checkpoints at 3 and 6), ``--auto-resume`` to 8, and ``tools.test``
  (``--eval mIoU`` against the in-loop mIoU, ``--format-only``).

Every phase prints one JSON line; any failed check raises and the script
exits nonzero without its last line. Each path runs with the kernels'
launch counts set to 0 just before it and read just after. The line before
the last lists the kernels; the last line is the device summary
``{"ok": true, "device": {...}}``. Without CUDA it fails at once: there is
no CPU fallback. Imports nothing of JAX or of the JAX package.
"""
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
_CFG_STEM = os.path.join(REPO, 'configs', 'setr', 'setr_deit-base_pup_bs_8_'
                         '512x512_80k_pascal_1over16_split_classic_')
CONFIGS = {'sup': _CFG_STEM + 'sup.py',
           'MT': _CFG_STEM + 'semi_beta_1_th_0.95_MT.py',
           'ours': _CFG_STEM + 'semi_beta_1_th_0.95_MT_w_ours.py'}
CONFIG = CONFIGS['sup']
FULLFLAG = os.path.join(REPO, 'configs', 'setr',
                        'setr_fixture_voc_mini_fullflag.py')
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
# offline tools.test vs the in-loop eval at the same checkpoint: the same
# exact path, but a bf16 forward in another process may flip a few
# boundary pixels
TOL_MIOU = 1e-3
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


def tta_lengths(images, crop=(512, 512), patch=16):
    """The token counts ``tools.test --aug-test`` gives kernel #1 on these
    images: each image resized by each TTA ratio (``int`` of the scaled
    size), padded to at least the crop, then by the ViT to the patch size;
    + the cls token. The flip runs as a forward of its own (B = 1)."""
    from PIL import Image
    from s4former_tpu_torch.apis import TTA_RATIOS
    out = set()
    for path in images:
        with Image.open(path) as im:
            w, h = im.size
        for r in TTA_RATIOS:
            ph = max(crop[0], max(1, int(h * r)))
            pw = max(crop[1], max(1, int(w * r)))
            out.add(-(-ph // patch) * -(-pw // patch) + 1)
    return sorted(out)


def phase_kernels(fa, tta_ls):
    """Kernel vs plain version on the card at the main path's shapes, plus
    the ragged L=130 and the TTA shapes ``tta_ls`` (B = 1). Returns the
    kernels line's entry."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = []
    shapes = [(2, 1025, 'pasa'), (2, 1025, 'random_b1'),
              (2, 1025, 'random_bh'), (2, 1025, None),
              (2, 130, 'random_b1'), (2, 130, None),
              (1, 1025, None), (1, 1025, 'pasa'),
              # the fixture eval: 683x512 padded to 688x512, a 43x32 grid
              # + cls, 4 a flush
              (4, 1377, None)]
    shapes += [(1, l, None) for l in tta_ls if l != 1025]
    timed_ls = {1025, 1377} | set(tta_ls)
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, bias_kind in shapes:
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
            if l in timed_ls:
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
    training paths' shapes at L = 1025 (8 + 8: B = 8 and the fused 2B
    pass's 16 with PASA; the CLI's 4 + 4: B = 4 and 8 with PASA; no bias /
    PASA / per-head bias), the ragged L = 130 and L = 2305 (768² crops);
    the forward that gives them o and lse is held to the plain forward at
    each. Times at the headline shapes, and the forward's at the training
    shapes. Returns the kernels line's entries, the forward's max abs
    error in bf16 and its timed cases."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(1)
    shapes = [(1, 1025, None), (1, 1025, 'pasa'), (1, 1025, 'random_bh'),
              (2, 1025, None), (2, 1025, 'pasa'), (4, 1025, None),
              (8, 1025, 'pasa'), (8, 1025, None), (16, 1025, 'pasa'),
              (2, 130, 'random_b1'), (2, 130, None), (2, 2305, None),
              (1, 2305, 'pasa')]
    # the training steps' shapes (teacher and sup pass; fused 2B pass) at
    # 8 + 8 and 4 + 4
    train_shapes = {('bfloat16', 8, 1025, None),
                    ('bfloat16', 16, 1025, 'pasa'),
                    ('bfloat16', 4, 1025, None),
                    ('bfloat16', 8, 1025, 'pasa')}
    timed = train_shapes | {('bfloat16', 1, 1025, None),
                            ('bfloat16', 2, 2305, None),
                            ('bfloat16', 1, 2305, 'pasa')}
    fwd_timed = train_shapes
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
    cfg = load_config(dtype, name, num_layers)
    return trainer_from_config(cfg, device, **semi_over) + (cfg,)


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
                         size=512, timed=0, trace_dir=None):
    """One bf16 step of another flagship config through the same entry
    points; with ``timed``, that many more steps timed (the first is their
    warm-up) and one under the profiler; with ``trace_dir``, then a
    warm-up step and 3 steps traced by ``core.hooks.profile_steps`` and
    read by ``tools/profile_trace.py``. Checked for finite logs and the
    kernels' launch counts: ``expect`` a step. Returns the counts of all
    the steps and the trace's summary (or None)."""
    import numpy as np
    import torch
    from s4former_tpu_torch.core.hooks import profile_steps
    from s4former_tpu_torch.tools import profile_trace
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
    summary = None
    if trace_dir:
        state = profile_steps(step, state, batch, gen, trace_dir, 3)
        summary = profile_trace.analyze(
            profile_trace.load_events(trace_dir), steps=3)
        print(f'trace of {phase}, 3 steps from one batch:\n' +
              profile_trace.report(summary), flush=True)
        times['trace'] = summary
    path_counts = counts(fa)
    n_steps = 1 + timed + (timed > 0) + (4 if trace_dir else 0)
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
    return path_counts, summary


# ------------------------------------------------------- native host path
@contextlib.contextmanager
def host_functions(kind):
    """The data pipelines on the native library ('native', as they run)
    or on its plain PIL/numpy versions ('plain') inside the block."""
    from s4former_tpu_torch.data.pipelines import transforms
    saved = transforms.native
    if kind == 'plain':
        transforms.native = transforms.PLAIN_HOST
    try:
        yield
    finally:
        transforms.native = saved


def fixture_files(images, tmp):
    """(JPEG, label PNG) paths: the fixture files at 500x375, and each
    resized to 512x512 (PIL bilinear / nearest) and encoded again (JPEG
    quality 95; 'P' PNG with the label's palette)."""
    from PIL import Image
    pairs = []
    for path in images:
        stem = os.path.splitext(os.path.basename(path))[0]
        label = os.path.join(LABELS, stem + '.png')
        pairs.append((path, label))
        with Image.open(path) as im:
            big = im.convert('RGB').resize((512, 512), Image.BILINEAR)
        jpg = os.path.join(tmp, stem + '_512.jpg')
        big.save(jpg, quality=95)
        with Image.open(label) as im:
            lab = im.resize((512, 512), Image.NEAREST)
            lab.putpalette(im.getpalette() or [])
        png = os.path.join(tmp, stem + '_512.png')
        lab.save(png)
        pairs.append((jpg, png))
    return pairs


def native_mismatches(pairs):
    """{function: number of inputs where native != plain} over every
    (image, label) pair, with the pipelines' parameters: decode (where
    native), resize bilinear and nearest up and down, brightness and
    contrast, saturation, hue, normalize."""
    import numpy as np
    from s4former_tpu_torch import native
    from s4former_tpu_torch.data.pipelines import transforms as T
    bad = {}
    mean = np.asarray([123.675, 116.28, 103.53], np.float32)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)

    def same(name, a, b):
        bad[name] = bad.get(name, 0) + int(
            a.dtype != b.dtype or a.shape != b.shape or
            not np.array_equal(a, b))
    for img_path, label_path in pairs:
        img = T.read_rgb_plain(img_path)
        lab = T.read_label_plain(label_path)
        if native.HAS_DECODE:
            with open(img_path, 'rb') as f:
                same('decode_rgb', native.decode_rgb(f.read()), img)
            with open(label_path, 'rb') as f:
                same('decode_label', native.decode_label(f.read()), lab)
        h, w = lab.shape
        for r in (0.61, 1.37, 2.0):
            size = (int(w * r + 0.5), int(h * r + 0.5))
            same('resize_bilinear', native.resize_u8(img, size),
                 T.resize_plain(img, size))
            same('resize_nearest', native.resize_u8(lab, size, True),
                 T.resize_plain(lab, size, True))
        for alpha, beta in ((1.0, 23.7), (1.0, -31.2), (1.31, 0.0),
                            (0.58, 0.0)):
            same('convert_u8', native.convert_u8(img, alpha, beta),
                 T.convert_plain(img, alpha, beta))
        for alpha in (0.63, 1.42):
            same('saturation_u8', native.saturation_u8(img, alpha),
                 T.saturate_plain(img, alpha))
        for dh in (-11, 14):
            same('hue_u8', native.hue_u8(img, dh), T.hue_plain(img, dh))
        same('normalize_f32', native.normalize_f32(img, mean, std),
             T.normalize_plain(img, mean, std))
    return bad


def pipeline_sample_ms(sup_ds, unsup_ds, n, threads):
    """Host ms a sample (one sup item and one unsup item: the sup, strong
    and weak views) over ``n`` samples on ``threads`` threads: wall time
    over ``n``."""
    def sample(i):
        sup_ds.get_item_deterministic(i % len(sup_ds), seed=i)
        unsup_ds.get_item_deterministic(i % len(unsup_ds), seed=i)
    sample(0)
    t0 = time.perf_counter()
    if threads == 1:
        for i in range(n):
            sample(i)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(sample, range(n)))
    return (time.perf_counter() - t0) * 1e3 / n


def phase_native(images, library, gpu_line):
    """The native library: which functions it serves, each bit-exact to
    its plain version on the fixture files at 500x375 and 512², the
    pipelines' samples too, and one sample's host time, plain and native,
    on 1 thread and on the loader's 8."""
    import numpy as np
    from s4former_tpu_torch import native
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.data import build_dataset
    has_decode = native.HAS_DECODE
    decode = 'native' if has_decode else \
        'plain: PIL (built without jpeglib.h/png.h)'
    functions = {'decode_rgb': decode, 'decode_label': decode,
                 **{name: 'native' for name in (
                     'resize_u8 (bilinear, nearest)', 'convert_u8',
                     'saturation_u8', 'hue_u8', 'normalize_f32')}}
    emit({'phase': 'native_build', 'library': str(library),
          'has_decode': has_decode, 'functions': functions})
    with tempfile.TemporaryDirectory() as tmp:
        pairs = fixture_files(images, tmp)
        bad = native_mismatches(pairs)
    cfg = Config.fromfile(FULLFLAG)
    sup_ds = build_dataset(cfg.data.train.sup)
    unsup_ds = build_dataset(cfg.data.train.unsup)
    threads = cfg.data.get('workers_per_gpu', 4) * 2   # the CLI's loader
    samples = {}
    for kind in ('native', 'plain'):
        with host_functions(kind):
            samples[kind] = [sup_ds.get_item_deterministic(i, seed=3)
                             for i in range(2)] + \
                [unsup_ds.get_item_deterministic(i, seed=3)
                 for i in range(2)]
    sample_bad = sum(
        not np.array_equal(np.asarray(a[key]), np.asarray(b[key]))
        for x, y in zip(samples['native'], samples['plain'])
        for a, b in zip(x if isinstance(x, list) else [x],
                        y if isinstance(y, list) else [y])
        for key in ('img', 'gt_semantic_seg'))
    ms = {}
    for kind in ('plain', 'native', 'native', 'plain'):   # in turns
        with host_functions(kind):
            for n_threads, n in ((1, 8), (threads, 4 * threads)):
                ms.setdefault(f'{kind}_{n_threads}_threads', []).append(
                    pipeline_sample_ms(sup_ds, unsup_ds, n, n_threads))
    emit({'phase': 'native', 'has_decode': has_decode,
          'inputs': f'{len(pairs)} (JPEG, label PNG) pairs: the fixture '
                    f'files at 500x375 and at 512x512',
          'mismatches': bad, 'pipeline_sample_mismatches': sample_bad,
          'sample': 'one sup item + one unsup item (sup, strong and weak '
                    'views) of setr_fixture_voc_mini_fullflag.py',
          'sample_ms': ms,
          'sample_ms_mean': {k: float(np.mean(v)) for k, v in ms.items()},
          'loader_threads': threads, 'gpu': gpu_line})
    check(len(bad) == (8 if has_decode else 6) and not any(bad.values()),
          f'native functions differ from their plain versions: {bad}')
    check(sample_bad == 0, f'{sample_bad} pipeline arrays differ between '
          f'the native and the plain host functions')


# ---------------------------------------------------- pretrained DeiT files
_TIMM = (('ln1.', 'norm1.'), ('ln2.', 'norm2.'),
         ('attn.attn.in_proj_weight', 'attn.qkv.weight'),
         ('attn.attn.in_proj_bias', 'attn.qkv.bias'),
         ('attn.attn.out_proj.', 'attn.proj.'),
         ('ffn.layers.0.0.', 'mlp.fc1.'), ('ffn.layers.1.', 'mlp.fc2.'))


def to_timm(key):
    """An OpenMMLab ViT key (no ``backbone.``) -> its timm DeiT name."""
    if key.startswith('layers.'):
        i, rest = key[len('layers.'):].split('.', 1)
        for mm, timm in _TIMM:
            rest = rest.replace(mm, timm)
        return f'blocks.{i}.{rest}'
    return key.replace('patch_embed.projection.', 'patch_embed.proj.')


def write_deit_files(directory, seed=7):
    """Backbone-only DeiT-B files of the flagship's ViT from seeded weights,
    as a user downloads them: bare keys in the OpenMMLab layout
    ('bare') and timm names ('timm'), each with a pos-embed on the 14x14
    grid of 224² pretraining, ``dist_token``, the final ``norm.*`` and the
    1000-way ``head.*``. Returns (paths, the model's backbone tensor
    count)."""
    import torch
    from s4former_tpu_torch.apis import init_segmentor
    model = init_segmentor(FULLFLAG, seed=seed, device='cpu').model
    bare = {k[len('backbone.'):]: v for k, v in model.state_dict().items()
            if k.startswith('backbone.')}
    gen = torch.Generator().manual_seed(seed)
    dim = bare['cls_token'].shape[-1]
    bare['pos_embed'] = 0.02 * torch.randn((1, 1 + 14 * 14, dim),
                                           generator=gen)
    extras = {'dist_token': (1, 1, dim), 'norm.weight': (dim,),
              'norm.bias': (dim,), 'head.weight': (1000, dim),
              'head.bias': (1000,)}
    n_backbone = len(bare)
    paths = {}
    for layout in ('bare', 'timm'):
        sd = dict(bare) if layout == 'bare' else \
            {to_timm(k): v for k, v in bare.items()}
        sd.update({k: 0.02 * torch.randn(shape, generator=gen)
                   for k, shape in extras.items()})
        paths[layout] = os.path.join(directory, f'deit_base_{layout}.pth')
        torch.save(sd, paths[layout])
    del model
    return paths, n_backbone


def read_logs(wd):
    return ''.join(open(os.path.join(wd, n)).read()
                   for n in sorted(os.listdir(wd)) if n.endswith('.log'))


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def add_counts(a, b):
    return {k: a[k] + b[k] for k in a}


def phase_train_cli(fa, gpu_line, wd, deit, n_backbone):
    """The port's training CLI on ``setr_fixture_voc_mini_fullflag.py`` as
    written (bf16, DeiT-B at full depth, 4 + 4 fixture images at 512² a
    step through the real pipelines and loader) from the bare-key DeiT-B
    file ``deit``, whose every backbone tensor the log must report loaded,
    for 12 steps with eval and checkpoints every 6 and logs every 3; then
    ``--auto-resume`` to 15; then ``tools.test`` on ``iter_12``, whose mIoU
    must be the in-loop one's within TOL_MIOU. Each run's launches are
    counted on their own: 36 forward and 24 fused backward a step, 12
    forward a flush of 4 val images. Returns the three runs' counts summed
    and the run's step and data-wait windows."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    opts = ['--cfg-options', 'evaluation.interval=6',
            'checkpoint_config.interval=6', 'log_config.interval=3']
    n_val, flush = 16, 4
    per_eval = 12 * -(-n_val // flush)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    state = train_cli.main([FULLFLAG, '--work-dir', wd, '--max-iters', '12',
                            '--load-from', deit] + opts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)                      # the main path ends
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == 12, f'trained to step {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    loaded = f'({n_backbone} of {n_backbone} backbone tensors)'
    check(loaded in read_logs(wd), f'the log does not report {loaded} '
          f'loaded from {deit}')
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [3, 6, 9, 12] and
          sorted(val) == [6, 12], f'logged steps {records}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(train_counts == {'flash_attn_fwd': 36 * 12 + 2 * per_eval,
                           'flash_attn_bwd_fused': 24 * 12,
                           'flash_attn_bwd_dkv': 0,
                           'flash_attn_bwd_dq': 0},
          f'12 steps + 2 evals launched {train_counts}, not 36 forward '
          f'+ 24 fused a step and {per_eval} forward an eval')

    reset_counts(fa)
    state = train_cli.main([FULLFLAG, '--work-dir', wd, '--auto-resume',
                            '--max-iters', '15'] + opts)
    torch.cuda.synchronize()
    resume_counts = counts(fa)
    check(int(state.step) == 15, f'resumed run ended at '
          f'{int(state.step)}, not 15')
    del state
    torch.cuda.empty_cache()
    resumed = f'resumed from {os.path.join(wd, "iter_12")}'
    check(resumed in read_logs(wd), f'no "{resumed}" in the log')
    check(resume_counts == {'flash_attn_fwd': 36 * 3,
                            'flash_attn_bwd_fused': 24 * 3,
                            'flash_attn_bwd_dkv': 0,
                            'flash_attn_bwd_dq': 0},
          f'3 resumed steps launched {resume_counts}')

    reset_counts(fa)
    t0 = time.perf_counter()
    results = test_cli.main([FULLFLAG, os.path.join(wd, 'iter_12')])
    test_s = time.perf_counter() - t0
    test_counts = counts(fa)
    check(test_counts['flash_attn_fwd'] == per_eval and
          sum(test_counts.values()) == per_eval,
          f'offline test launched {test_counts}')
    in_loop = val[12]['mIoU']
    gap = abs(results['mIoU'] - in_loop)
    step_ms = [r['step_ms'] for r in train]
    windows = {'step_ms': step_ms,
               'data_wait_ms': [r['data_wait_ms'] for r in train]}
    emit({'phase': 'train_cli', 'config': os.path.basename(FULLFLAG),
          'batch': '4 + 4 at 512², bf16, 12 layers',
          'pretrained': f'{os.path.basename(deit)}: {loaded} loaded',
          'losses': {r['step']: r['loss'] for r in train},
          'mask_ratio': {r['step']: r['mask_ratio'] for r in train},
          'logs_iter_12': train[-1],
          'step_ms_windows': step_ms,
          'step_ms_mean_after_first': float(np.mean(step_ms[1:])),
          'step_ms_p50_after_first': float(np.median(step_ms[1:])),
          'data_wait_ms_windows': windows['data_wait_ms'],
          'eval_s': {s: r['eval_s'] for s, r in val.items()},
          'miou': {s: r['mIoU'] for s, r in val.items()},
          'train_run_s': train_s, 'peak_mem_bytes': peak,
          'launches': {'train': train_counts, 'resume': resume_counts,
                       'test': test_counts},
          'resumed': resumed, 'test_miou': results['mIoU'],
          'in_loop_miou_iter_12': in_loop, 'miou_gap': gap,
          'tol': TOL_MIOU, 'test_run_s': test_s, 'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{in_loop}: {gap} > {TOL_MIOU}')
    return (add_counts(add_counts(train_counts, resume_counts), test_counts),
            windows)


def phase_train_cli_host(fa, gpu_line, root, deit, n_backbone, windows,
                         no_loader):
    """9-step CLI runs of the same config from the timm-layout DeiT-B
    file, no eval, logs every 3, on the native and on the plain host
    functions in turns (native, plain, plain, native); the first two trace
    steps 7-9 (``--profile 7 3``), read by ``tools/profile_trace.py``
    beside the no-loader step's trace ``no_loader``. Each run's log must
    report every backbone tensor loaded. Returns the runs' counts."""
    import numpy as np
    from s4former_tpu_torch.tools import profile_trace
    from s4former_tpu_torch.tools import train as train_cli
    opts = ['--cfg-options', 'checkpoint_config.interval=9',
            'log_config.interval=3']
    loaded = f'({n_backbone} of {n_backbone} backbone tensors)'
    total = None
    runs = []
    for i, kind in enumerate(('native', 'plain', 'plain', 'native')):
        wd = os.path.join(root, f'host_{i}_{kind}')
        traced = i < 2
        reset_counts(fa)
        with host_functions(kind):
            state = train_cli.main(
                [FULLFLAG, '--work-dir', wd, '--max-iters', '9',
                 '--no-validate', '--load-from', deit] +
                (['--profile', '7', '3'] if traced else []) + opts)
        run_counts = counts(fa)
        check(int(state.step) == 9, f'{kind} run ended at {int(state.step)}')
        del state
        check(loaded in read_logs(wd), f'the {kind} run does not report '
              f'{loaded} loaded from {deit}')
        check(run_counts == {'flash_attn_fwd': 36 * 9,
                             'flash_attn_bwd_fused': 24 * 9,
                             'flash_attn_bwd_dkv': 0,
                             'flash_attn_bwd_dq': 0},
              f'9 {kind} steps launched {run_counts}')
        train = [r for r in read_jsonl(os.path.join(wd, 'metrics.jsonl'))
                 if r['prefix'] == 'train']
        run = {'host': kind, 'traced_steps': '7-9' if traced else None,
               'step_ms_windows': [r['step_ms'] for r in train],
               'data_wait_ms_windows': [r['data_wait_ms'] for r in train]}
        if traced:
            run['trace'] = profile_trace.analyze(profile_trace.load_events(
                os.path.join(wd, 'profile')), steps=3)
            print(f'trace of the {kind} run, steps 7-9:\n' +
                  profile_trace.report(run['trace']), flush=True)
        runs.append(run)
        total = run_counts if total is None else add_counts(total, run_counts)
        shutil.rmtree(wd, ignore_errors=True)
    # untraced windows: 2 of the traced runs, 2-3 of the others
    steady = {kind: [ms for r in runs if r['host'] == kind
                     for ms in r['step_ms_windows'][1:2 if r['traced_steps']
                                                   else 3]]
              for kind in ('native', 'plain')}
    emit({'phase': 'train_cli_host', 'config': os.path.basename(FULLFLAG),
          'pretrained': f'{os.path.basename(deit)}: {loaded} loaded',
          'runs': runs,
          'step_ms_untraced': steady,
          'step_ms_untraced_mean': {k: float(np.mean(v))
                                    for k, v in steady.items()},
          'main_run_native': windows,
          'no_loader_trace': no_loader, 'gpu': gpu_line})
    return total


def phase_test_cli(fa, gpu_line, ckpt, root):
    """``tools.test`` on the run's checkpoint at full width: ``--aug-test
    --show-dir`` over the 16 fixture images (6 ratios x (1 + flip)
    forwards an image, 12 launches of kernel #1 each), then
    ``--format-only`` with the test set read as Cityscapes (the ported
    dataset with a submission format; the exact path, 12 launches a flush
    of 4). Both must write a file an image; the TTA mIoU a number."""
    import numpy as np
    from s4former_tpu_torch.apis import TTA_RATIOS
    from s4former_tpu_torch.tools import test as test_cli
    n_val, flush = 16, 4
    vis, fmt = os.path.join(root, 'vis'), os.path.join(root, 'fmt')
    per_image = 12 * len(TTA_RATIOS) * 2
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    results = test_cli.main([FULLFLAG, ckpt, '--aug-test', '--show-dir',
                             vis])
    aug_s = time.perf_counter() - t0
    aug_counts = counts(fa)                        # the main path ends
    reset_counts(fa)
    t0 = time.perf_counter()
    none = test_cli.main([FULLFLAG, ckpt, '--format-only',
                          '--imgfile-prefix', fmt, '--cfg-options',
                          'data.test.type=CityscapesDataset',
                          'data.test.img_suffix=.jpg',
                          'data.test.seg_map_suffix=.png'])
    fmt_s = time.perf_counter() - t0
    fmt_counts = counts(fa)
    painted, formatted = sorted(os.listdir(vis)), sorted(os.listdir(fmt))
    emit({'phase': 'test_cli', 'config': os.path.basename(FULLFLAG),
          'aug_test_miou': results['mIoU'], 'aug_test_s': aug_s,
          'aug_test_s_per_image': aug_s / n_val,
          'kernel1_launches_per_image': aug_counts['flash_attn_fwd'] / n_val,
          'painted_files': len(painted), 'format_only_files': len(formatted),
          'format_only_s': fmt_s,
          'launches': {'aug_test': aug_counts, 'format_only': fmt_counts},
          'gpu': gpu_line})
    check(np.isfinite(results['mIoU']) and 0 <= results['mIoU'] <= 1,
          f'--aug-test mIoU {results["mIoU"]}')
    check(none is None, '--format-only evaluated')
    check(len(painted) == n_val and len(formatted) == n_val,
          f'{len(painted)} painted and {len(formatted)} formatted files, '
          f'not {n_val} each')
    check(aug_counts == {'flash_attn_fwd': per_image * n_val,
                         'flash_attn_bwd_fused': 0, 'flash_attn_bwd_dkv': 0,
                         'flash_attn_bwd_dq': 0},
          f'--aug-test launched {aug_counts}, not {per_image} forward an '
          f'image')
    per_eval = 12 * -(-n_val // flush)
    check(fmt_counts['flash_attn_fwd'] == per_eval and
          sum(fmt_counts.values()) == per_eval,
          f'--format-only launched {fmt_counts}')
    return add_counts(aug_counts, fmt_counts)


# ------------------------------------------------- SegFormer / MiT-B4 path
_MIT_STEM = os.path.join(REPO, 'configs', 'segformer', 'segformer_mit-b4_bs_'
                         '8_768x768_40k_cityscapes_1over16_split_CPS_')
MIT_CONFIGS = {'sup': _MIT_STEM + 'sup.py',
               'ours': _MIT_STEM + 'semi_MT_w_ours.py'}
# depth cuts of the MiT-B4 ([3, 8, 27, 3]) for the f32 card-vs-CPU phases
MIT_SERVE_F32_DEPTH = (1, 1, 2, 1)
MIT_TRAIN_F32_DEPTH = (1, 1, 1, 1)
MIT_CLASSES = 19
# Cityscapes frames and the training crop
CITY_HW = (1024, 2048)
MIT_CROP = 768
# operator classes of the MiT step's device time, by the aten operator that
# launched each kernel (BN has no operator of its own: its mean, rsqrt and
# affine are among the elementwise and reduction kernels)
OP_CLASSES = (
    ('attention matmul (bmm)', ('aten::bmm', 'aten::baddbmm')),
    ('linear matmul', ('aten::mm', 'aten::addmm')),
    ('softmax', ('aten::_softmax', 'aten::_softmax_backward_data')),
    ('layer_norm', ('aten::native_layer_norm',
                    'aten::native_layer_norm_backward')),
    ('conv', ('aten::cudnn_convolution', 'aten::_conv_depthwise2d',
              'aten::convolution_backward', 'aten::_convolution',
              'aten::cudnn_convolution_add_relu')),
    ('resize (bilinear gather + lerp, its index_add backward)',
     ('aten::index_select', 'aten::lerp', 'aten::index_add_',
      'aten::index_add', 'aten::index_select_backward')),
)


def load_mit_config(name, dtype=None, depth=None, drop=True):
    """A segformer config as written, with the compute dtype set, the
    depth cut to ``depth`` blocks a stage, and, with ``drop=False``, drop
    path and head dropout at 0."""
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(MIT_CONFIGS[name])
    if dtype is not None:
        cfg.model.backbone.dtype = dtype
        cfg.model.decode_head.dtype = dtype
    if depth is not None:
        cfg.model.backbone.num_layers = list(depth)
    if not drop:
        cfg.model.backbone.drop_path_rate = 0.0
        cfg.model.decode_head.dropout_ratio = 0.0
    return cfg


def city_scene(rs, hw=CITY_HW, block=32):
    """A seeded street-like frame: blocky trainId labels (19 classes and
    255) and an RGB image of each block's class colour plus noise."""
    import numpy as np
    from s4former_tpu_torch.core.class_names import cityscapes_palette
    palette = np.asarray(cityscapes_palette() + [[0, 0, 0]], np.int16)
    ids = rs.choice(list(range(MIT_CLASSES)) + [255],
                    (hw[0] // block, hw[1] // block),
                    p=[0.95 / MIT_CLASSES] * MIT_CLASSES + [0.05])
    label = np.kron(ids, np.ones((block, block), np.int64))
    colour = palette[np.where(label == 255, MIT_CLASSES, label)]
    img = np.clip(colour + rs.randint(-24, 25, colour.shape), 0, 255)
    return img.astype(np.uint8), label.astype(np.uint8)


def write_city_pngs(rs, directory, n):
    """n seeded 2048x1024 RGB PNGs (fast zlib level) -> their paths."""
    from PIL import Image
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        img, _ = city_scene(rs)
        paths.append(os.path.join(directory, f'frame_{i:02d}.png'))
        Image.fromarray(img).save(paths[-1], compress_level=1)
    return paths


def mit_train_batch(rs, n_sup, n_unsup, size=MIT_CROP):
    """A step's batch of seeded scenes cropped to ``size``², normalised
    as the pipelines do: sup images + labels, and unsup images (one view
    for the teacher and the student)."""
    import numpy as np
    from s4former_tpu_torch.apis import _DEFAULT_NORM
    mean = np.asarray(_DEFAULT_NORM['mean'], np.float32)
    std = np.asarray(_DEFAULT_NORM['std'], np.float32)
    xs, ys = [], []
    for _ in range(n_sup + n_unsup):
        img, label = city_scene(rs, (size, size))
        xs.append((img.astype(np.float32) - mean) / std)
        ys.append(label.astype(np.int32))
    x, y = np.stack(xs), np.stack(ys)
    batch = {'sup_img': x[:n_sup], 'sup_gt': y[:n_sup]}
    if n_unsup:
        batch['unsup_teacher_img'] = x[n_sup:]
        batch['unsup_student_img'] = x[n_sup:]
    return batch


def all_zero(path_counts):
    return not any(path_counts.values())


def phase_mit_serve_f32(fa, image):
    """``..._sup.py`` in f32 cut to depth MIT_SERVE_F32_DEPTH, one seeded
    2048x1024 frame through slide inference (768² windows at stride 512:
    8 of them), on the card and on the CPU from the same seeded weights.
    Returns the card's launch counts."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    from s4former_tpu_torch.models.segmentors.inference import window_origins
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_mit_config('sup', 'float32', MIT_SERVE_F32_DEPTH)
    gpu = init_segmentor(cfg, seed=0, device='cuda')
    cpu = init_segmentor(cfg, seed=0, device='cpu')
    check((gpu.mode, gpu.crop_size, gpu.stride) ==
          ('slide', (768, 768), (512, 512)), 'slide geometry')
    windows = len(window_origins(*CITY_HW, gpu.crop_size, gpu.stride))
    check(windows == 8, f'{windows} windows on a 2048x1024 frame')
    x, _ = _prepare_image(gpu, image)
    check(x.shape == (1,) + CITY_HW + (3,), f'request shape {x.shape}')
    reset_counts(fa)                               # the main path starts
    p_gpu = gpu.probs(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    path_counts = counts(fa)                       # the main path ends
    t0 = time.perf_counter()
    p_cpu = cpu.probs(torch.from_numpy(x))
    cpu_s = time.perf_counter() - t0
    check(p_gpu.shape == (1,) + CITY_HW + (MIT_CLASSES,),
          f'probs shape {p_gpu.shape}')
    check(torch.isfinite(p_gpu).all().item(), 'non-finite f32 probs')
    err = (p_gpu.cpu() - p_cpu).abs().max().item()
    agree = (p_gpu.cpu().argmax(-1) == p_cpu.argmax(-1)).float().mean()
    emit({'phase': 'mit_serve_f32_vs_cpu', 'config': 'sup',
          'cut': f'depth [3, 8, 27, 3] -> {list(MIT_SERVE_F32_DEPTH)}',
          'windows': windows, 'probs_max_abs_err': err,
          'tol': TOL_MAIN_F32, 'argmax_agreement': agree.item(),
          'cpu_forward_s': cpu_s, 'launches': path_counts})
    check(all_zero(path_counts), f'the MiT launched a kernel: {path_counts}')
    check(err <= TOL_MAIN_F32, f'f32 card vs CPU probs differ by {err}')
    del gpu, cpu, p_gpu, p_cpu
    torch.cuda.empty_cache()
    return path_counts


def phase_mit_serve_bf16(fa, images, gpu_line):
    """``..._sup.py`` at full depth in bf16: ``inference_segmentor`` serves
    each seeded 2048x1024 PNG of ``images`` as one request (8 slide
    windows); one more request under the profiler."""
    import numpy as np
    import torch
    from s4former_tpu_torch.apis import inference_segmentor, init_segmentor
    seg = init_segmentor(load_mit_config('sup', 'bfloat16'), seed=0,
                         device='cuda')
    inference_segmentor(seg, images[0])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    reset_counts(fa)                               # the main path starts
    for path in images:
        t0 = time.perf_counter()
        labels = inference_segmentor(seg, path)   # ends in a device->host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(labels.shape == CITY_HW and labels.min() >= 0 and
              labels.max() < MIT_CLASSES, f'bad label map for {path}')
    path_counts = counts(fa)                       # the main path ends
    peak = torch.cuda.max_memory_allocated()
    _, prof = device_profile(lambda: inference_segmentor(seg, images[1]), 12)
    lat = np.asarray(latencies)
    emit({'phase': 'mit_serve_bf16', 'config': 'sup',
          'requests': len(images), 'frame': '2048x1024 PNG, slide 768/512',
          'request_ms': [round(t, 3) for t in latencies],
          'request_ms_mean': float(lat.mean()),
          'request_ms_p50': float(np.median(lat)),
          'peak_mem_bytes': peak, 'profile': prof,
          'launches': path_counts, 'gpu': gpu_line})
    check(all_zero(path_counts), f'the MiT launched a kernel: {path_counts}')
    del seg
    torch.cuda.empty_cache()
    return path_counts


def trainer_from_config(cfg, device, **semi_over):
    """(state, train_step) of a config through the port's entry points,
    with seeded random weights."""
    import dataclasses
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                               **semi_over)
    model = init_segmentor(cfg, seed=0, device=device).model
    state = create_train_state(model, ema=semi.ema)
    step = make_semi_train_step(model, semi, model.num_classes,
                                **step_kwargs(cfg))
    return state, step


def phase_mit_train_f32_vs_cpu(fa):
    """One S4Former step of ``..._MT_w_ours.py`` in f32 cut to depth
    MIT_TRAIN_F32_DEPTH, drop path and dropout at 0, 1 + 1 seeded scenes at
    768², the same CutMix box and PatchShuffle permutation, on the card and
    on the CPU from the same weights. The confidence threshold is the
    median of the CPU teacher's max softmax on the unsup image (the seeded
    teacher is far below the config's 0.95), so about half of the pixels
    are confident: the stage-4 PASA bias, NCR and pseudo-CE are live.
    Returns the card's launch counts."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(5)
    batch = mit_train_batch(rs, 1, 1)
    mask = np.ones((1, MIT_CROP, MIT_CROP), np.float32)
    mask[0, 128:512, 192:480] = 0
    batch['dbg_cutmix_mask'] = mask
    batch['dbg_patchmix_perm'] = rs.permutation(36)[None].astype(np.int32)
    cfg = load_mit_config('ours', 'float32', MIT_TRAIN_F32_DEPTH, drop=False)
    state, _ = trainer_from_config(cfg, 'cpu')
    with torch.no_grad():
        t_logits = state.model.forward_decode_from_img(
            torch.from_numpy(batch['unsup_teacher_img']), train=False)
    threshold = float(torch.softmax(t_logits.float(), -1).amax(-1).median())
    runs = {}
    for device in ('cuda', 'cpu'):
        state, step = trainer_from_config(cfg, device,
                                          unsup_confidence=threshold)
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
    check(sorted(lg) == sorted(lc), 'log keys differ')
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc}
    scale = max(d.abs().max().item() for d in dc.values())
    upd_err = max((dg[n] - dc[n]).abs().max().item() for n in dc)
    emit({'phase': 'mit_train_f32_vs_cpu', 'config': 'ours',
          'cut': f'depth [3, 8, 27, 3] -> {list(MIT_TRAIN_F32_DEPTH)}; drop '
                 f'path and head dropout 0',
          'batch': f'1 sup + 1 unsup at {MIT_CROP}², unsup_confidence '
                   f'{threshold} (median teacher max-prob)',
          'mask_ratio': lc['mask_ratio'], 'mask_ratio_card': lg['mask_ratio'],
          'losses_card': lg, 'losses_cpu': lc, 'loss_rel_err': loss_err,
          'update_max_abs_err': upd_err, 'update_max_abs_cpu': scale,
          'tol': TOL_TRAIN_F32, 'card_step_s': sg, 'cpu_step_s': sc,
          'launches': cg})
    check(all_zero(cg) and all_zero(cc), f'the MiT launched a kernel: {cg}')
    check(0 < lc['mask_ratio'] < 1, f'mask_ratio {lc["mask_ratio"]}')
    check(lc['unsup.loss_seg_unsup'] > 0 and lc['unsup.loss_ncr_unsup'] > 0,
          'the unsup losses are not live')
    check(all(np.isfinite(v) for v in lg.values()), 'non-finite losses')
    check(max(loss_err.values()) <= TOL_TRAIN_F32,
          f'f32 losses, card vs CPU: {loss_err}')
    check(upd_err <= TOL_TRAIN_F32 * scale,
          f'f32 parameter updates differ by {upd_err} (max {scale})')
    return cg


def device_time_by_class(averages):
    """Device time (µs) of a profiled run (its ``key_averages()``) by
    operator class: each CPU
    operator's own kernels (``self_device_time_total``) summed over the
    classes of OP_CLASSES, the rest as 'elementwise, reductions, copies
    (incl. BN, GELU, losses, SGD)'. The MixFFN's depthwise 3x3 conv is
    split from the other convs by its cuDNN kernels' names (grouped /
    one-channel-a-group kernels)."""
    import re
    from torch.autograd import DeviceType
    out = {}
    depthwise = 0.0
    for ev in averages:
        us = ev.self_device_time_total
        if us <= 0:
            continue
        if ev.device_type == DeviceType.CUDA:
            if re.search(r'grouped|depthwise|_c1_k1', ev.key):
                depthwise += us
            continue
        cls = next((c for c, ops in OP_CLASSES if ev.key in ops),
                   'elementwise, reductions, copies (incl. BN, GELU, '
                   'losses, SGD)')
        out[cls] = out.get(cls, 0.0) + us
    if depthwise:
        out['conv'] = out.get('conv', 0.0) - depthwise
        out['depthwise conv 3x3'] = depthwise
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def phase_mit_train_bf16(fa, gpu_line, n_sup, n_unsup):
    """``..._MT_w_ours.py`` at full depth in bf16, drop path and head
    dropout live, from one fixed batch of seeded scenes at 768²: the first
    step, 3 timed, 1 profiled (device time by kernel and by operator
    class). Returns the launch counts."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = load_mit_config('ours', 'bfloat16')
    state, step = trainer_from_config(cfg, 'cuda')
    batch = to_device(mit_train_batch(np.random.RandomState(6), n_sup,
                                      n_unsup), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, logs = step(state, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path_counts = counts(fa)                       # the main path ends
    peak = torch.cuda.max_memory_allocated()
    averages = prof.key_averages()
    by_class = device_time_by_class(averages)
    kernels = [ev for ev in averages if ev.device_type == DeviceType.CUDA]
    device_us = sum(ev.self_device_time_total for ev in kernels)
    top = sorted(((ev.self_device_time_total, ev.key[:100], ev.count)
                  for ev in kernels), reverse=True)[:15]
    lg = floats(logs)
    timed = np.asarray(ms[1:])
    emit({'phase': 'mit_train_bf16', 'config': 'ours',
          'batch': f'{n_sup} + {n_unsup} at {MIT_CROP}², bf16, depth '
                   f'[3, 8, 27, 3], drop path 0.1 and dropout 0.1 live',
          'first_step_ms': ms[0], 'step_ms': ms[1:],
          'step_ms_mean': float(timed.mean()),
          'step_ms_p50': float(np.median(timed)),
          'img_per_s': (n_sup + n_unsup) / (timed.mean() / 1e3),
          'peak_mem_bytes': peak, 'mask_ratio': lg['mask_ratio'],
          'logs': lg, 'profile': {
              'wall_us': wall_us, 'device_us': device_us,
              'device_busy_share': device_us / wall_us,
              'by_class_us': by_class,
              'classified_us': sum(by_class.values()),
              'top': [{'kernel': k, 'device_us': us, 'calls': n}
                      for us, k, n in top]},
          'launches': path_counts, 'gpu': gpu_line})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check(all_zero(path_counts), f'the MiT launched a kernel: {path_counts}')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def write_city_tree(root, seed=8, n_sup=8, n_unsup=8, n_val=2):
    """A Cityscapes-layout tree of seeded 2048x1024 frames (PNG) and their
    trainId labels (L PNG), n_sup + n_unsup in train and n_val in val, and
    split files of their stems. Returns the split paths."""
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    splits = {'sup': [], 'unsup': [], 'val': []}
    names = ['sup'] * n_sup + ['unsup'] * n_unsup + ['val'] * n_val
    for i, which in enumerate(names):
        part = 'val' if which == 'val' else 'train'
        city = 'frankfurt' if part == 'val' else ('aachen', 'bremen')[i % 2]
        stem = f'{city}/{city}_{i:06d}_000019'
        img, label = city_scene(rs)
        for sub, suffix, arr in (('leftImg8bit', '_leftImg8bit.png', img),
                                 ('gtFine', '_gtFine_labelTrainIds.png',
                                  label)):
            path = os.path.join(root, sub, part, stem + suffix)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(arr).save(path, compress_level=1)
        splits[which].append(stem)
    paths = {}
    for which, stems in splits.items():
        paths[which] = os.path.join(root, f'{which}.txt')
        with open(paths[which], 'w') as f:
            f.write('\n'.join(stems) + '\n')
    return paths


def phase_mit_train_cli(fa, gpu_line, root, n_sup, n_unsup):
    """The port's training CLI on ``..._MT_w_ours.py`` (bf16, full depth,
    ``n_sup`` + ``n_unsup`` a step through the Cityscapes pipelines) over a
    seeded Cityscapes tree: 6 steps with slide eval and checkpoints at 3
    and 6; ``--auto-resume`` to 8; ``tools.test --eval mIoU`` on
    ``iter_6`` within TOL_MIOU of the in-loop mIoU; ``--format-only``
    writes label-id PNGs. Returns the runs' launch counts summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    splits = write_city_tree(os.path.join(root, 'city'))
    data_root = os.path.join(root, 'city')
    cfg_path = MIT_CONFIGS['ours']
    opts = ['--cfg-options', 'model.backbone.dtype=bfloat16',
            'model.decode_head.dtype=bfloat16', 'evaluation.interval=3',
            'checkpoint_config.interval=3', 'log_config.interval=3',
            f'samples_per_gpu_sup={n_sup}',
            f'samples_per_gpu_unsup={n_unsup}']
    for key, split in (('data.train.sup', 'sup'),
                       ('data.train.unsup', 'unsup'), ('data.val', 'val'),
                       ('data.test', 'val')):
        opts += [f'{key}.data_root={data_root}',
                 f'{key}.split={splits[split]}']
    wd = os.path.join(root, 'mit_work')
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    state = train_cli.main([cfg_path, '--work-dir', wd, '--max-iters', '6']
                           + opts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)                      # the main path ends
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == 6, f'trained to step {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [3, 6] and sorted(val) == [3, 6],
          f'logged steps {records}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(all('unsup.loss_seg_unsup' in r for r in train),
          'the unsup branch did not run')

    reset_counts(fa)
    state = train_cli.main([cfg_path, '--work-dir', wd, '--auto-resume',
                            '--max-iters', '8'] + opts)
    torch.cuda.synchronize()
    resume_counts = counts(fa)
    check(int(state.step) == 8, f'resumed run ended at {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    resumed = f'resumed from {os.path.join(wd, "iter_6")}'
    check(resumed in read_logs(wd), f'no "{resumed}" in the log')

    reset_counts(fa)
    t0 = time.perf_counter()
    results = test_cli.main([cfg_path, os.path.join(wd, 'iter_6'),
                             '--eval', 'mIoU'] + opts)
    test_s = time.perf_counter() - t0
    fmt = os.path.join(root, 'mit_fmt')
    none = test_cli.main([cfg_path, os.path.join(wd, 'iter_6'),
                          '--format-only', '--imgfile-prefix', fmt] + opts)
    test_counts = counts(fa)
    in_loop = val[6]['mIoU']
    gap = abs(results['mIoU'] - in_loop)
    formatted = sorted(os.listdir(fmt))
    emit({'phase': 'mit_train_cli', 'config': os.path.basename(cfg_path),
          'batch': f'{n_sup} + {n_unsup} at {MIT_CROP}² from 2048x1024 '
                   f'PNGs, bf16, depth [3, 8, 27, 3]',
          'data': '8 labeled, 8 unlabeled, 2 val seeded frames',
          'losses': {r['step']: r['loss'] for r in train},
          'mask_ratio': {r['step']: r['mask_ratio'] for r in train},
          'step_ms_windows': [r['step_ms'] for r in train],
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'eval_s': {s: r['eval_s'] for s, r in val.items()},
          'miou': {s: r['mIoU'] for s, r in val.items()},
          'train_run_s': train_s, 'peak_mem_bytes': peak,
          'launches': {'train': train_counts, 'resume': resume_counts,
                       'test': test_counts},
          'resumed': resumed, 'test_miou': results['mIoU'],
          'in_loop_miou_iter_6': in_loop, 'miou_gap': gap, 'tol': TOL_MIOU,
          'test_run_s': test_s, 'format_only_files': len(formatted),
          'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{in_loop}: {gap} > {TOL_MIOU}')
    check(none is None and len(formatted) == 2,
          f'--format-only wrote {formatted}')
    total = add_counts(add_counts(train_counts, resume_counts), test_counts)
    check(all_zero(total), f'the MiT launched a kernel: {total}')
    shutil.rmtree(wd, ignore_errors=True)
    return total


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
    t_start = time.perf_counter()
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
    os.chdir(REPO)             # the configs' data roots are repo-relative
    from s4former_tpu_torch.native import build as native_build
    from s4former_tpu_torch.ops import cuda_build
    from s4former_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:   # g++ beside the two nvcc builds
        native_lib = pool.submit(native_build.build)
        libs = cuda_build.build_all([fa.SOURCE, fa.BWD_SOURCE])
        native_lib = native_lib.result()
    fa.load_library()
    fa.load_bwd_library()
    phase_build(libs, time.perf_counter() - t0)

    images = sorted(glob.glob(IMAGES))
    check(len(images) == 16, f'expected 16 fixture images, found '
          f'{len(images)}')
    phase_native(images, native_lib, gpu_line)
    tta_ls = tta_lengths(images)
    entries = {'flash_attn_fwd': phase_kernels(fa, tta_ls)}
    bwd_entries, fwd_err_train, fwd_train_cases = phase_kernels_bwd(fa)
    entries.update(bwd_entries)
    fwd = entries['flash_attn_fwd']     # the training shapes' forward too
    fwd['max_abs_err'] = max(fwd['max_abs_err'], fwd_err_train)
    fwd['cases'] += fwd_train_cases
    fwd['tta_lengths'] = tta_ls
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
    paths['train_bf16_MT'], _ = phase_train_one_step(
        fa, images, 'train_bf16_MT', 'MT', 8, 8,
        {'flash_attn_fwd': 36, 'flash_attn_bwd_fused': 24,
         'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0})
    paths['train_bf16_sup'], _ = phase_train_one_step(
        fa, images, 'train_bf16_sup', 'sup', 8, 0,
        {'flash_attn_fwd': 12, 'flash_attn_bwd_fused': 12,
         'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0})
    # 2 images cropped/padded to 768², the Cityscapes crop of
    # configs/_base_/datasets/cityscapes_768x768_1over16_split_CPS_semi.py:
    # the pos-embed is resized at run time, and L = 2305 > FULL_Q_MAX takes
    # the dk/dv + dq kernels; the first step, 3 timed, 1 profiled
    paths['train_long'], _ = phase_train_one_step(
        fa, images, 'train_long', 'sup', 2, 0,
        {'flash_attn_fwd': 12, 'flash_attn_bwd_fused': 0,
         'flash_attn_bwd_dkv': 12, 'flash_attn_bwd_dq': 12}, size=768,
        timed=3)
    with tempfile.TemporaryDirectory() as root:
        # train_cli's step (4 + 4) from one fixed batch, no loader beside
        # it: what the host pipeline adds to the CLI's step; its trace is
        # read beside the CLI's
        paths['train_bf16_4x4'], no_loader = phase_train_one_step(
            fa, images, 'train_bf16_4x4', 'ours', 4, 4,
            {'flash_attn_fwd': 36, 'flash_attn_bwd_fused': 24,
             'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}, timed=5,
            trace_dir=os.path.join(root, 'trace_4x4'))
        deit, n_backbone = write_deit_files(root)
        wd = os.path.join(root, 'work')
        paths['train_cli'], windows = phase_train_cli(
            fa, gpu_line, wd, deit['bare'], n_backbone)
        paths['test_cli'] = phase_test_cli(
            fa, gpu_line, os.path.join(wd, 'iter_12'), root)
        shutil.rmtree(wd, ignore_errors=True)
        paths['train_cli_host'] = phase_train_cli_host(
            fa, gpu_line, root, deit['timm'], n_backbone, windows,
            no_loader)

        # the SegFormer MiT-B4 slice: no flash kernel runs on it
        import numpy as np
        frames = write_city_pngs(np.random.RandomState(4),
                                 os.path.join(root, 'frames'), 8)
        mit_cfg = load_mit_config('ours')
        mit_batch = (mit_cfg.samples_per_gpu_sup,
                     mit_cfg.samples_per_gpu_unsup)
        seconds = {}
        for name, run in (
                ('mit_serve_f32', lambda: phase_mit_serve_f32(fa, frames[0])),
                ('mit_serve_bf16',
                 lambda: phase_mit_serve_bf16(fa, frames, gpu_line)),
                ('mit_train_f32', lambda: phase_mit_train_f32_vs_cpu(fa)),
                ('mit_train_bf16',
                 lambda: phase_mit_train_bf16(fa, gpu_line, *mit_batch)),
                ('mit_train_cli', lambda: phase_mit_train_cli(
                    fa, gpu_line, root, *mit_batch))):
            t0 = time.perf_counter()
            paths[name] = run()
            seconds[name] = time.perf_counter() - t0
        emit({'phase': 'mit_seconds', **seconds,
              'total': sum(seconds.values())})

    for name in KERNELS:
        entries[name]['launches'] = sum(p[name] for p in paths.values())
        entries[name]['launches_by_path'] = {k: p[name]
                                             for k, p in paths.items()}
        check(entries[name]['launches'] > 0, f'{name} never ran on a path')
    emit({'phase': 'total', 'seconds': time.perf_counter() - t_start})
    print(gpu_line)
    emit({'kernels': [entries[name] for name in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
