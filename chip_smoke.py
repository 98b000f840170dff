#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``s4former_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
to its plain PyTorch version on the card, then serves the flagship model
(DeiT-B SETR-PUP at 512², seeded random weights) through the port's entry
points: once in f32 against the same model on the CPU, then in the config's
bf16 over the fixture images, plain and with the teacher-PASA bias. Every
phase prints one JSON line; any failed check raises and the script exits
nonzero without its last line. The last line is the device summary
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
CONFIG = os.path.join(
    REPO, 'configs', 'setr', 'setr_deit-base_pup_bs_8_512x512_80k_pascal_'
    '1over16_split_classic_sup.py')
IMAGES = os.path.join(REPO, 'data', 'fixtures', 'voc_mini', 'JPEGImages',
                      '*.jpg')
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


def attention_inputs(b, l, h, dtype, bias_kind, gen):
    """q, k, v as the ViT makes them (strided views of one fused qkv
    projection) and a bias of the given kind."""
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
    return q, k, v, bias


def flash_bound_ms(q, bias):
    """Least time on the card: the larger of the operations over the peak
    for the dtype and the bytes (q, k, v, o, lse once; the bias once per
    image, or per head when it has one per head) over HBM bandwidth."""
    b, l, h, d = q.shape
    elt = q.element_size()
    flops = 4.0 * b * h * l * l * d
    nbytes = 4 * b * l * h * d * elt + b * h * l * 4
    if bias is not None:
        nbytes += b * bias.shape[1] * l * l * elt
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace('torch.', '')] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def phase_kernels(fa):
    """Kernel vs plain version on the card at the main path's shapes, plus
    the ragged L=130. Returns the kernels line's entry."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, bias_kind in ((2, 1025, 'pasa'), (2, 1025, 'random_b1'),
                                (2, 1025, 'random_bh'), (2, 1025, None),
                                (2, 130, 'random_b1'), (2, 130, None),
                                (1, 1025, None), (1, 1025, 'pasa')):
            q, k, v, bias = attention_inputs(b, l, 12, dtype, bias_kind, gen)
            o, lse = fa.flash_attention_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_attention_reference(q, k, v, bias)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            name = str(dtype).replace('torch.', '')
            tol = TOL[name]
            check(torch.isfinite(o).all().item(), f'non-finite o {name}')
            check(err_o <= tol['o'] and err_lse <= tol['lse'],
                  f'kernel disagrees with plain: {name} B={b} L={l} '
                  f'bias={bias_kind} err_o={err_o} err_lse={err_lse}')
            case = dict(dtype=name, B=b, L=l, H=12, D=64, bias=bias_kind,
                        max_abs_err=err_o, lse_max_abs_err=err_lse,
                        tol_o=tol['o'], tol_lse=tol['lse'])
            if l == 1025:
                bq = bias.to(dtype) if bias is not None else None
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                case['ms'] = cuda_time_ms(
                    lambda: fa.flash_attention_fwd(q, k, v, bias))
                case['plain_ms'] = cuda_time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, bias))
                case['library_ms'] = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           attn_mask=bq))
                case['bound_ms'], case['bound_by'] = flash_bound_ms(q, bias)
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


def load_config(dtype):
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(CONFIG)
    if dtype is not None:
        cfg.model.backbone.dtype = dtype
        cfg.model.decode_head.dtype = dtype
        for head in cfg.model.auxiliary_head:
            head.dtype = dtype
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
    fa.launch_count = 0                            # the main path starts
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
    launches = fa.launch_count                     # the main path ends
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
          'launches': launches, 'gpu': gpu_line})
    return seg, launches


def phase_profile(seg, images):
    """Device time by kernel over one bf16 request (torch.profiler), and
    the device's busy share of the request's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from s4former_tpu_torch.apis import inference_segmentor
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_segmentor(seg, images[1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and
                   ev.self_device_time_total > 0), reverse=True)
    device_us = sum(r[0] for r in rows)
    emit({'phase': 'profile_bf16_request', 'wall_us': wall_us,
          'device_us': device_us, 'device_busy_share': device_us / wall_us,
          'top': [{'kernel': k[:100], 'device_us': us, 'calls': n}
                  for us, k, n in rows[:14]]})


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
    fa.load_library()
    log = cuda_build.library_path(fa.SOURCE).with_suffix('.log')
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'ptxas': [ln.strip() for ln in log.read_text().splitlines()
                    if 'registers' in ln or 'spill' in ln]})

    images = sorted(glob.glob(IMAGES))
    check(len(images) == 16, f'expected 16 fixture images, found '
          f'{len(images)}')
    entry = phase_kernels(fa)
    p_f32 = phase_main_f32(fa, images)
    seg, entry['launches'] = phase_main_bf16(fa, images, p_f32, gpu_line)
    phase_profile(seg, images)

    print(gpu_line)
    emit({'kernels': [entry]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
