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
- eval and tools, on the training run's checkpoints (its evals' panels
  are checked in ``train_cli``): ``tools.test --launcher env`` over NCCL
  with min(2, cards) ranks against one process (``--show-dir --out``:
  metrics, PNGs and pickle equal); ``benchmark`` (``..._sup.py`` at 512²,
  B = 1 and 8), ``get_flops`` (the card's count against the CPU's),
  ``ensemble_test`` over ``iter_6`` + ``iter_12``, ``per_image_eval``,
  ``measure_eval_divergence``, ``publish_model --to-pth`` and
  ``tools.test`` on the ``.pth``, ``print_config``, ``image_demo`` and
  ``video_demo`` over the fixture frames through a stub ``cv2``;
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
  (``--eval mIoU`` against the in-loop mIoU, ``--format-only``);
- the datasets (``ade_train_cli``): ``..._MT_w_ours.py`` with
  ``ADE20KDataset`` and 150 classes on every head, on a seeded ADE20K tree
  (16 + 16 + 16 JPEGs at ADE's sizes, labels 0-150): ``tools.train`` 6
  steps of 4 + 4 from the seeded DeiT-B file, ``tools.test --show-dir``
  against the in-loop mIoU, a ``ConcatDataset`` of the val halves with
  separate and merged evaluation, and ``--eval cityscapes`` on the
  Cityscapes tree, which must raise the missing-package ImportError;
- the ablation flags of the step (``ablation_*``): one f32 step of
  ``..._MT_w_ours.py`` at 4 layers with every flag group whose draws can be
  handed to both devices, against the CPU; three bf16 flag sets at full
  width, 4 + 4 at 512² (strong mixes; adaptive CutMix, PatchShuffle +
  ClassMix and the supervised mixes; dropout, drop path, head dropout,
  fdrop, EMA head dropout, supervised NCR, ``sup_ema``, layer decay and a
  sigmoid aux CE), each step's launches checked against the passes its
  flags imply; MiT-B4 with fdrop at 4 + 4, 768²; ``tools.train`` with the
  regularisers by ``--cfg-options``, 6 steps, resumed to 8;
- UniMatch and the ViT's remat (``unimatch_*``, ``remat_*``): one f32
  UniMatch step against the CPU (``..._MT_w_ours.py`` at 4 layers, 2 + 2 at
  512², head 1 as the PASA pass and as the fdrop pass; MiT-B4 at depth
  [1, 1, 1, 1], 1 + 1 at 768²), the streams' boxes and permutations
  injected; the bf16 UniMatch step at full depth, 8 + 8 at 512² with its
  mix stream (timed, profiled); the flagship and the UniMatch 8 + 8 steps
  with remat off, 'dots' and 'full' (losses and updates against remat off,
  step time, peak memory); ``tools.train`` on a UniMatch variant of the
  fixture config (``UniSemiDataset``, three-branch pipelines with
  RandomGrayscale and GaussianBlur), 3 steps, resumed to 6, and
  ``tools.test`` against the in-loop mIoU;
- data parallelism (``dp_*``, each phase's ranks started by
  ``torch.distributed.run`` on this script's ``--dp-worker`` mode): 2
  ranks on one card over gloo against one process, the f32 step of
  ``..._MT_w_ours.py`` at 4 layers, 3 steps of 4 + 4 global (2 + 2 a
  rank), the ranks' states bit-identical and the hard pseudo-labels that
  differ from one process's counted, then again with each rank's teacher
  logits pinned to one process's; the bf16 flagship at 4 + 4 a
  rank (step and all-reduce time, peak a rank), and with more cards the
  same over NCCL, one rank a card (up to 4); ``tools.train --launcher
  env`` over NCCL with min(2, cards) ranks on the fixture config, 6 steps,
  resumed to 8, rank 0 alone writing (its eval panels too), and
  ``tools.test`` against the in-loop mIoU;
- sharded training (``tp_*``, ``zero3_*``; ``parallel/tp.py``): kernels
  #1-#4 held at H = 6 and 3, the heads of a tensor-parallel rank; the f32
  step at 4 layers split as data 1 x model 2 (2 ranks, gloo on cuda:0)
  and data 2 x model 2 with ZeRO-3 (4 ranks; NCCL with 4 cards) against
  one process, within the data-parallel bounds; the bf16 flagship on one
  global 4 + 4 batch in one process, 1 x 2 and 2 x 2 with ZeRO-3 (step and
  device ms, peak memory, the floats and heads a rank); ``tools.train
  --model-parallel 2 --zero3`` on 4 ranks, 3 steps with eval and a
  checkpoint (the layout of ``train_cli``'s), resumed to 4, and
  ``tools.test`` on it against the in-loop mIoU.

Kernel #1 is held to its plain version at every forward shape a path
launched: the shapes listed up front (the TTA and whole-image eval token
counts worked out from the fixture images), and at the end any other
that the launches recorded, the ranks' included.

Every phase prints one JSON line; any failed check raises and the script
exits nonzero without its last line. Each path runs with the kernels'
launch counts set to 0 just before it and read just after. The line before
the last lists the kernels; the last line is the device summary
``{"ok": true, "device": {...}}``. Without CUDA it fails at once: there is
no CPU fallback. Imports nothing of JAX or of the JAX package.
"""
import contextlib
import glob
import io
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
    FWD_HELD.add(fwd_shape(q, bias))
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


def eval_lengths(patch=16, buckets=(16, 256)):
    """The token counts the whole-image evals give kernel #1 on the
    fixture val set: each pipeline image of ``FULLFLAG``'s val set padded
    to the patch size (tools.test, ensemble_test, measure_eval_divergence
    at its default bucket, the demos, serving) or to a multiple of 256
    (per_image_eval), + the cls token."""
    import numpy as np
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.data import build_dataset
    ds = build_dataset(Config.fromfile(FULLFLAG).data['val'])
    out = set()
    for idx in range(len(ds)):
        item = ds.get_item_deterministic(idx, seed=0)
        h, w = np.asarray((item[0] if isinstance(item, list)
                           else item)['img']).shape[:2]
        for m in buckets:
            out.add(-(-h // m) * -(-w // m) * (m // patch) ** 2 + 1)
    return sorted(out)


# kernel #1's forward shapes, each (dtype, B, L, H, bias: None, 'b1' one
# row for all heads, 'bh' one a head): those held against the plain
# version (``check_forward``) and those launched (``record_fwd_shapes``,
# in the parent and in every rank)
FWD_HELD, FWD_SEEN = set(), set()


def fwd_shape(q, bias):
    b, l, h, _ = q.shape
    kind = None if bias is None else ('b1' if bias.shape[1] == 1 else 'bh')
    return (str(q.dtype).replace('torch.', ''), b, l, h, kind)


def record_fwd_shapes(fa):
    """Wrap kernel #1's launcher so that every launch adds its shape to
    FWD_SEEN; the launch and its count stay the launcher's."""
    launch = fa._launch_fwd

    def recording(q, k, v, bias):
        FWD_SEEN.add(fwd_shape(q, bias))
        return launch(q, k, v, bias)
    fa._launch_fwd = recording


def phase_kernels_seen(fa, entry):
    """Kernel #1 against its plain version at every forward shape a path
    launched that no earlier check held (random inputs, a random bias of
    the path's kind), so that no shape a path brings goes unheld; adds
    them to the kernels line's ``entry``. The shapes held here belong in
    ``phase_kernels``' list."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(2)
    late = sorted(FWD_SEEN - FWD_HELD, key=str)
    kinds = {None: None, 'b1': 'random_b1', 'bh': 'random_bh'}
    for name, b, l, h, kind in late:
        q, k, v, bias = attention_inputs(b, l, h, getattr(torch, name),
                                         kinds[kind], gen)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        err_o, err_lse = check_forward(fa, q, k, v, bias, o, lse,
                                       f'{name} B={b} L={l} bias={kind}')
        emit({'phase': 'kernel_check', 'for': 'seen_on_a_path',
              'dtype': name, 'B': b, 'L': l, 'H': h, 'D': 64, 'bias': kind,
              'max_abs_err': err_o, 'lse_max_abs_err': err_lse,
              'tol_o': TOL[name]['o'], 'tol_lse': TOL[name]['lse']})
        if name == 'bfloat16':
            entry['max_abs_err'] = max(entry['max_abs_err'], err_o)
        del q, k, v, bias, o, lse
    entry['shapes_held_late'] = late
    emit({'phase': 'kernel_shapes', 'launched': len(FWD_SEEN),
          'held': len(FWD_HELD), 'held_late': late})
    check(FWD_SEEN <= FWD_HELD, 'forward shapes launched but not held: '
          f'{sorted(FWD_SEEN - FWD_HELD, key=str)}')


def phase_kernels(fa, tta_ls, eval_ls):
    """Kernel vs plain version on the card at the main path's shapes, plus
    the ragged L=130, the TTA shapes ``tta_ls`` and the whole-image eval
    shapes ``eval_ls`` (B = 1). Returns the kernels line's entry."""
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
    shapes += [(1, l, None) for l in sorted(set(tta_ls) | set(eval_ls))
               if l != 1025]
    timed_ls = {1025, 1377} | set(tta_ls) | set(eval_ls)
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
    pass's 16 with PASA; the CLI's 4 + 4: B = 4 and 8 with PASA; the 2 + 2
    f32 steps, a data-parallel rank's among them: B = 2 and 4 with PASA;
    no bias / PASA / per-head bias), the ragged L = 130 and L = 2305 (768²
    crops);
    the forward that gives them o and lse is held to the plain forward at
    each. Times at the headline shapes, and the forward's at the training
    shapes. Returns the kernels line's entries, the forward's max abs
    error in bf16 and its timed cases."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(1)
    shapes = [(1, 1025, None), (1, 1025, 'pasa'), (1, 1025, 'random_bh'),
              (2, 1025, None), (2, 1025, 'pasa'), (4, 1025, None),
              (4, 1025, 'pasa'), (8, 1025, 'pasa'), (8, 1025, None),
              (16, 1025, 'pasa'),
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


# the heads a tensor-parallel rank of DeiT-B attends over: 12 split over a
# model axis of 2 and of 4
TP_HEADS = (6, 3)


def phase_kernels_tp(fa, entries):
    """Kernels #1-#4 against their plain versions at H = 6 and 3, the heads
    of a tensor-parallel rank (q, k, v strided views of the rank's
    [B, L, 3 H 64] product, as the sharded ViT makes them), f32 and bf16,
    at the tolerances above. The forward at every B the sharded paths
    launch at L = 1025 (no bias and PASA's b1 bias) and at the eval's
    B = 4, L = 1377, timed at B = 8 and 16 and at the eval shape; the
    fused backward at B = 8, L = 1025; the dk/dv and dq kernels at B = 2,
    L = 2305. Each timed row with its bound, the plain version's time and
    the library call's. The rows go to the kernels line's entries
    (``cases``, with their H)."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(3)
    fwd_shapes = [(b, 1025, kind) for b in (2, 4, 8, 16)
                  for kind in (None, 'pasa')] + [(4, 1377, None)]
    fwd_timed = {(8, 1025, None), (8, 1025, 'pasa'), (16, 1025, None),
                 (16, 1025, 'pasa'), (4, 1377, None)}
    bwd_shapes = [(8, 1025, None), (8, 1025, 'pasa'), (2, 2305, None)]
    launchers = {'flash_attn_bwd_fused': fa.launch_bwd_fused,
                 'flash_attn_bwd_dkv': fa.launch_bwd_dkv,
                 'flash_attn_bwd_dq': fa.launch_bwd_dq}
    fwd_entry = entries['flash_attn_fwd']
    for h in TP_HEADS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace('torch.', '')
            for b, l, kind in fwd_shapes:
                q, k, v, bias = attention_inputs(b, l, h, dtype, kind, gen)
                o, lse = fa.flash_attention_fwd(q, k, v, bias)
                err_o, err_lse = check_forward(
                    fa, q, k, v, bias, o, lse,
                    f'{dname} B={b} L={l} H={h} bias={kind}')
                case = dict(dtype=dname, B=b, L=l, H=h, D=64, bias=kind,
                            max_abs_err=err_o, lse_max_abs_err=err_lse,
                            tol_o=TOL[dname]['o'], tol_lse=TOL[dname]['lse'])
                if (b, l, kind) in fwd_timed:
                    case.update(forward_times(fa, q, k, v, bias))
                    fwd_entry['cases'].append(case)
                if dname == 'bfloat16':
                    fwd_entry['max_abs_err'] = max(fwd_entry['max_abs_err'],
                                                   err_o)
                emit({'phase': 'kernel_check', 'for': 'tensor_parallel',
                      **case})
                del q, k, v, bias, o, lse
            for b, l, kind in bwd_shapes:
                where = f'{dname} B={b} L={l} H={h} bias={kind}'
                q, k, v, bias = attention_inputs(b, l, h, dtype, kind, gen)
                do = torch.randn(q.shape, generator=gen,
                                 device='cuda').to(dtype)
                o, lse = fa.flash_attention_fwd(q, k, v, bias)
                check_forward(fa, q, k, v, bias, o, lse, where)
                args = (q, k, v, bias, do, lse, fa.row_delta(o, do))
                ref = fa.flash_attention_backward_reference(
                    q, k, v, bias, o, lse, do)
                names = ['flash_attn_bwd_fused'] if l <= fa.FULL_Q_MAX \
                    else ['flash_attn_bwd_dkv', 'flash_attn_bwd_dq']
                plain_ms = cuda_time_ms(
                    lambda: fa.flash_attention_backward_reference(
                        q, k, v, bias, o, lse, do), iters=3, warmup=1)
                library_ms = sdpa_backward_ms(q, k, v, bias, do)
                for name in names:
                    got = launchers[name](*args)
                    if name == 'flash_attn_bwd_dkv':
                        got = (ref[0],) + tuple(got)
                    elif name == 'flash_attn_bwd_dq':
                        got = (got,) + tuple(ref[1:])
                    torch.cuda.synchronize()
                    errs, peaks = grad_errors(got, ref)
                    rel = max(e / p for e, p in zip(errs, peaks))
                    products, outputs = BWD_WORK[name]
                    bound, bound_by = bound_ms(q, bias, products,
                                               5 + outputs)
                    case = dict(dtype=dname, B=b, L=l, H=h, D=64, bias=kind,
                                max_abs_err=max(errs),
                                abs_err_dq_dk_dv=errs,
                                max_abs_dq_dk_dv=peaks, max_rel_err=rel,
                                tol=TOL_BWD[dname],
                                ms=cuda_time_ms(lambda: launchers[name](
                                    *args), iters=10, warmup=2),
                                plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound, bound_by=bound_by)
                    entry = entries[name]
                    entry['cases'].append(case)
                    if dname == 'bfloat16':
                        entry['max_abs_err'] = max(entry['max_abs_err'],
                                                   max(errs))
                        entry['max_rel_err'] = max(entry['max_rel_err'], rel)
                    emit({'phase': 'kernel_check_bwd', 'kernel': name,
                          'for': 'tensor_parallel', **case})
                    check(all(torch.isfinite(t).all().item() for t in got),
                          f'non-finite {name} {where}')
                    check(rel <= TOL_BWD[dname], f'{name} disagrees with the '
                          f'plain backward: {where} err={errs} max '
                          f'|grad|={peaks}')
                del q, k, v, bias, do, o, lse, args, ref


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


VAL_SPLIT = os.path.join(REPO, 'data', 'fixtures', 'voc_mini', 'datasplits',
                         'fixture', 'val.txt')


def check_eval_panels(wd, steps):
    """The runner's eval panels of each eval in ``steps``:
    ``eval_vis/iter_N/000.png`` to ``003.png``, panel i image | GT |
    prediction of val image i at its original size, (H, 3 W, 3). Returns
    their shapes by step."""
    import numpy as np
    from PIL import Image
    with open(VAL_SPLIT) as f:
        stems = f.read().split()[:4]
    sizes = []
    for stem in stems:
        with Image.open(os.path.join(os.path.dirname(IMAGES),
                                     stem + '.jpg')) as im:
            sizes.append(im.size)
    out = {}
    for it in steps:
        d = os.path.join(wd, 'eval_vis', f'iter_{it}')
        names = sorted(os.listdir(d)) if os.path.isdir(d) else []
        check(names == [f'{i:03d}.png' for i in range(4)],
              f'eval panels of iter {it}: {names}')
        shapes = [np.asarray(Image.open(os.path.join(d, n))).shape
                  for n in names]
        check(shapes == [(h, 3 * w, 3) for w, h in sizes],
              f'eval panels of iter {it}: shapes {shapes}, images {sizes}')
        out[it] = shapes
    return out


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
    panels = check_eval_panels(wd, (6, 12))
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
          'eval_panels': panels,
          'train_run_s': train_s, 'peak_mem_bytes': peak,
          'launches': {'train': train_counts, 'resume': resume_counts,
                       'test': test_counts},
          'resumed': resumed, 'test_miou': results['mIoU'],
          'in_loop_miou_iter_12': in_loop, 'miou_gap': gap,
          'tol': TOL_MIOU, 'test_run_s': test_s, 'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{in_loop}: {gap} > {TOL_MIOU}')
    CHECKPOINT_LAYOUT.update(checkpoint_layout(os.path.join(wd, 'iter_12')))
    PEAKS['train_cli'] = peak
    return (add_counts(add_counts(train_counts, resume_counts), test_counts),
            windows)


# train_cli's checkpoint: each part's tensor names, shapes and dtypes (the
# sharded CLI's must equal it)
CHECKPOINT_LAYOUT = {}
# peak device memory of the CLI training runs, by phase
PEAKS = {}


def checkpoint_layout(path):
    import torch
    raw = torch.load(os.path.join(path, 'state.pt'), map_location='cpu',
                     weights_only=True)
    return {key: {n: [list(t.shape), str(t.dtype)]
                  for n, t in raw[key].items()}
            for key in ('model', 'momentum', 'ema_model')}


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


# ------------------------------------------- eval over ranks, tools, demos
def read_files(directory):
    return {n: open(os.path.join(directory, n), 'rb').read()
            for n in sorted(os.listdir(directory))}


def phase_test_cli_ranks(fa, gpu_line, ckpt, root):
    """``tools.test --launcher env`` over NCCL with K = min(2, cards) ranks
    (one a card; on one card the launcher path with K = 1) against one
    process, the exact path with ``--show-dir --out`` on ``ckpt``: the
    metrics equal (``==``), the painted PNGs and the ``.pkl`` byte-equal,
    and the forward launches summed over the ranks one process's (12 a
    flush of 4). Returns both runs' launches summed, and the single
    process's metrics."""
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    k = min(DP_RANKS, torch.cuda.device_count())
    n_val, flush = 16, 4
    per_eval = 12 * -(-n_val // flush)
    dirs = {name: os.path.join(root, f'test_{name}')
            for name in ('one', 'ranks')}

    def argv(d):
        return [FULLFLAG, ckpt, '--show-dir', os.path.join(d, 'vis'),
                '--out', os.path.join(d, 'preds.pkl')]
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    single = test_cli.main(argv(dirs['one']))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_counts = counts(fa)                        # the main path ends
    t0 = time.perf_counter()
    ranks, _ = run_ranks('test', {'argv': argv(dirs['ranks']) +
                                  ['--launcher', 'env']}, k, root, 600)
    ranks_s = time.perf_counter() - t0
    rank_counts = sum_counts(ranks)
    single = json.loads(json.dumps(single))        # as the ranks report it
    same_metrics = [json.dumps(r['metrics'], sort_keys=True) ==
                    json.dumps(single, sort_keys=True) for r in ranks]
    vis = {n: read_files(os.path.join(d, 'vis')) for n, d in dirs.items()}
    pkl = {n: open(os.path.join(d, 'preds.pkl'), 'rb').read()
           for n, d in dirs.items()}
    emit({'phase': 'test_cli_ranks', 'config': os.path.basename(FULLFLAG),
          'ranks': k, 'cards': torch.cuda.device_count(), 'backend': 'nccl',
          'miou_one': single['mIoU'],
          'miou_ranks': [r['metrics']['mIoU'] for r in ranks],
          'metrics_equal': same_metrics,
          'painted_files': len(vis['ranks']),
          'painted_equal': vis['ranks'] == vis['one'],
          'pkl_equal': pkl['ranks'] == pkl['one'],
          'launches_one': one_counts,
          'launches_per_rank': [r['launches'] for r in ranks],
          'one_s': one_s, 'ranks_s': ranks_s, 'gpu': gpu_line})
    check(all(same_metrics), 'the ranks\' metrics are not one process\'s')
    check(len(vis['one']) == n_val and vis['ranks'] == vis['one'],
          'the ranks\' --show-dir files are not one process\'s')
    check(pkl['ranks'] == pkl['one'], 'the ranks\' --out file is not one '
          'process\'s')
    want = dict({n: 0 for n in KERNELS}, flash_attn_fwd=per_eval)
    check(one_counts == want and rank_counts == want,
          f'launches: one process {one_counts}, the ranks {rank_counts}, '
          f'not {per_eval} forward')
    return add_counts(one_counts, rank_counts), single


def phase_tools_cli(fa, gpu_line, wd, root, images, test_miou):
    """The root tools and the demos at full width, each run as ``-m`` would
    run it, its launches of kernel #1 counted on their own: ``benchmark``
    on ``..._sup.py`` at 512², B = 1 and 8 (12 a forward); ``get_flops`` at
    512² on the card and on the CPU (the same count); ``ensemble_test`` over
    ``iter_6`` + ``iter_12`` (24 an image); ``per_image_eval`` (17 lines);
    ``measure_eval_divergence`` at the default bucket (agreement >= 1 -
    1e-3, |ΔmIoU| <= TOL_MIOU); ``publish_model --to-pth`` of ``iter_12``
    and ``tools.test`` on the ``.pth`` (the mIoU of ``iter_12``,
    ``test_miou``, exactly); ``print_config``; ``image_demo`` on one
    fixture JPEG (its PNG ``show_result_pyplot(inference_segmentor(...))``);
    ``video_demo`` over the 16 fixture frames through a stub ``cv2`` that
    exists only in this phase (12 a frame). Returns the launches summed."""
    import numpy as np
    import torch
    from PIL import Image
    from s4former_tpu_torch.apis import (inference_segmentor, init_segmentor,
                                         show_result_pyplot)
    from s4former_tpu_torch.demo import image_demo, video_demo
    from s4former_tpu_torch.tools import (benchmark, ensemble_test,
                                          get_flops, measure_eval_divergence,
                                          per_image_eval, print_config,
                                          publish_model)
    from s4former_tpu_torch.tools import test as test_cli
    n_val = 16
    it6, it12 = (os.path.join(wd, f'iter_{i}') for i in (6, 12))
    seconds, launches, out = {}, {}, {}

    def run(name, want_fwd, fn):
        reset_counts(fa)                           # the main path starts
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = counts(fa)                # the main path ends
        check(launches[name] == dict({n: 0 for n in KERNELS},
                                     flash_attn_fwd=want_fwd),
              f'{name} launched {launches[name]}, not {want_fwd} forward')
        return result

    bench_iters, bench_warmup = 100, 10
    for b in (1, 8):
        r = run(f'benchmark_b{b}', 12 * (bench_iters + bench_warmup),
                lambda: benchmark.main([CONFIGS['sup'], '--batch', str(b),
                                        '--iters', str(bench_iters),
                                        '--warmup', str(bench_warmup)]))
        out[f'benchmark_b{b}'] = {'img_per_s': r['fps'],
                                  'ms_per_img': r['ms_per_img'],
                                  'launches_per_iter': launches[
                                      f'benchmark_b{b}']['flash_attn_fwd'] /
                                  (bench_iters + bench_warmup)}
    card = run('get_flops', 12, lambda: get_flops.main([CONFIGS['sup']]))
    cpu = run('get_flops_cpu', 0, lambda: get_flops.main(
        [CONFIGS['sup'], '--device', 'cpu']))
    out['get_flops'] = {'params_M': card['params'] / 1e6,
                        'gflops': card['flops'] / 1e9,
                        'attention_gflops': card['attention_flops'] / 1e9,
                        'cpu_gflops': cpu['flops'] / 1e9}
    check(card['flops'] == cpu['flops'] and card['params'] == cpu['params'],
          f'get_flops: card {card}, CPU {cpu}')
    ens = run('ensemble_test', 24 * n_val,
              lambda: ensemble_test.main([FULLFLAG, it6, it12]))
    out['ensemble_test'] = {k: ens[k] for k in ('aAcc', 'mIoU', 'mAcc')}
    lines = run('per_image_eval', 12 * n_val,
                lambda: per_image_eval.main([FULLFLAG, it12]))
    out['per_image_eval'] = {'lines': len(lines), 'aggregate': lines[-1]}
    div = run('measure_eval_divergence', 24 * n_val,
              lambda: measure_eval_divergence.main([FULLFLAG, it12]))
    out['measure_eval_divergence'] = div
    pub, pth = run('publish_model', 0, lambda: publish_model.main(
        [it12, os.path.join(root, 'published'), '--to-pth']))
    on_pth = run('test_on_published_pth', 12 * -(-n_val // 4),
                 lambda: test_cli.main([FULLFLAG, pth]))
    out['publish_model'] = {'published': os.path.basename(pub),
                            'test_miou_pth': on_pth['mIoU'],
                            'test_miou_iter_12': test_miou}
    with contextlib.redirect_stdout(io.StringIO()):     # returned too
        text = run('print_config', 0,
                   lambda: print_config.main([FULLFLAG]))
    demo_png = os.path.join(root, 'demo.png')
    run('image_demo', 12, lambda: image_demo.main(
        [images[0], FULLFLAG, it12, '--out', demo_png]))
    seg = init_segmentor(FULLFLAG, it12)
    demo_same = np.array_equal(
        np.asarray(Image.open(demo_png)),
        show_result_pyplot(seg, images[0],
                           inference_segmentor(seg, images[0])))
    del seg
    from tests._stub_cv2 import StubCv2
    stub = StubCv2([np.asarray(Image.open(p).convert('RGB'))
                    for p in images])
    cv2 = sys.modules.get('cv2')
    sys.modules['cv2'] = stub                      # this phase only
    try:
        frames = run('video_demo', 12 * len(images), lambda: video_demo.main(
            ['frames', FULLFLAG, it12, '--palette', 'voc',
             '--output-file', os.path.join(root, 'out.avi')]))
    finally:
        if cv2 is None:
            del sys.modules['cv2']
        else:
            sys.modules['cv2'] = cv2
    out['video_demo'] = {'frames': frames, 'written': len(stub.written)}
    emit({'phase': 'tools_cli', 'config': os.path.basename(FULLFLAG),
          'tools': out, 'image_demo_equal': demo_same,
          'print_config_lines': text.count('\n') + 1,
          'seconds': seconds, 'launches': launches, 'gpu': gpu_line})
    check(len(lines) == n_val + 1 and lines[-1]['n'] == n_val,
          f'per_image_eval printed {len(lines)} records')
    check(div['argmax_agreement_mean'] >= 1 - 1e-3 and
          div['abs_dmIoU'] <= TOL_MIOU, f'eval divergence {div}')
    check(on_pth['mIoU'] == test_miou, f'tools.test on {pth}: mIoU '
          f'{on_pth["mIoU"]}, on iter_12 {test_miou}')
    check(text.startswith('Config:\n'), 'print_config printed no config')
    check(demo_same, 'image_demo\'s PNG is not show_result_pyplot of '
          'inference_segmentor')
    check(frames == len(images) and len(stub.written) == len(images),
          f'video_demo: {frames} frames, {len(stub.written)} written')
    check(all(np.isfinite(v) for v in out['ensemble_test'].values()) and
          all(r['img_per_s'] > 0 for k, r in out.items()
              if k.startswith('benchmark')), f'tools {out}')
    total = {n: 0 for n in KERNELS}
    for c in launches.values():
        total = add_counts(total, c)
    return total


def run_eval_tools(fa, gpu_line, wd, root, images):
    """The eval-and-tools slice's phases on the train_cli run's
    checkpoints; returns their launch counts by path and prints their
    seconds."""
    paths, seconds = {}, {}
    t0 = time.perf_counter()
    paths['test_cli_ranks'], single = phase_test_cli_ranks(
        fa, gpu_line, os.path.join(wd, 'iter_12'), root)
    seconds['test_cli_ranks'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths['tools_cli'] = phase_tools_cli(fa, gpu_line, wd, root, images,
                                         single['mIoU'])
    seconds['tools_cli'] = time.perf_counter() - t0
    emit({'phase': 'eval_tools_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths

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


def trainer_from_config(cfg, device, paramwise_cfg=None, **semi_over):
    """(state, train_step) of a config through the port's entry points,
    with seeded random weights; ``paramwise_cfg`` turns on the layer-wise
    LR decay."""
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
                                paramwise_cfg=paramwise_cfg,
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


# ------------------------------------------------ the ADE20K datasets slice
# ADE20K's image sizes (its short side is 512 in the mmseg release): two
# landscape and one portrait in three
ADE_SIZES = ((683, 512), (512, 683), (640, 512))
ADE_CLASSES = 150


def write_ade_tree(root, seed=13, n_sup=16, n_unsup=16, n_val=16):
    """An ADE20K-layout tree of seeded JPEGs at ADE's sizes and their label
    PNGs: ``images/{training,validation}`` and ``annotations/`` beside,
    labels of 32-pixel blocks over 1-150 with a share of 0 ("other", which
    ``reduce_zero_label`` turns into 255), and ``sup.txt``/``unsup.txt``
    split files of the training stems. Returns the val stems and their
    (w, h) sizes."""
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    splits = {'sup': [], 'unsup': [], 'val': []}
    val_sizes = []
    names = ['sup'] * n_sup + ['unsup'] * n_unsup + ['val'] * n_val
    for i, which in enumerate(names):
        part = 'validation' if which == 'val' else 'training'
        stem = f'ADE_{"val" if which == "val" else "train"}_{i + 1:08d}'
        w, h = ADE_SIZES[i % len(ADE_SIZES)]
        if which == 'val':
            val_sizes.append((w, h))
        blocks = rs.randint(1, ADE_CLASSES + 1, (-(-h // 32), -(-w // 32)))
        blocks[rs.rand(*blocks.shape) < 0.1] = 0
        label = np.kron(blocks, np.ones((32, 32), np.int64))[:h, :w]
        img = rs.randint(0, 96, (h, w, 3)) + \
            (label[..., None] * np.array([37, 91, 53])) % 160
        for sub, ext, arr in (('images', '.jpg', img.astype(np.uint8)),
                              ('annotations', '.png',
                               label.astype(np.uint8))):
            os.makedirs(os.path.join(root, sub, part), exist_ok=True)
            Image.fromarray(arr).save(os.path.join(root, sub, part,
                                                   stem + ext))
        splits[which].append(stem)
    for which in ('sup', 'unsup'):
        with open(os.path.join(root, f'{which}.txt'), 'w') as f:
            f.write('\n'.join(splits[which]) + '\n')
    return splits['val'], val_sizes


def ade_cli_config(root, data_root):
    """``..._MT_w_ours.py`` on an ADE20K tree, written to ``root``: it
    inherits the config by ``_base_`` and puts ``ADE20KDataset`` in sup,
    unsup, val and test (the config's pipelines; the labels through
    ``reduce_zero_label``; val and test read the whole validation folder
    through the keep-ratio test pipeline), and 150 classes on the decode
    head and the four aux heads (``--cfg-options`` sets no list item)."""
    import copy
    from s4former_tpu_torch.config import Config
    base = Config.fromfile(CONFIGS['ours']).to_dict()

    def ade(which, part, pipeline, split=None):
        pipeline = copy.deepcopy(pipeline)
        for t in pipeline:
            if t['type'] == 'LoadAnnotations':
                t['reduce_zero_label'] = True
        out = dict(_delete_=True, type='ADE20KDataset', data_root=data_root,
                   img_dir=f'images/{part}', ann_dir=f'annotations/{part}',
                   pipeline=pipeline)
        if split:
            out['split'] = split
        return out
    train = base['data']['train']
    data = dict(
        train=dict(sup=ade('sup', 'training', train['sup']['pipeline'],
                           'sup.txt'),
                   unsup=ade('unsup', 'training', train['unsup']['pipeline'],
                             'unsup.txt')),
        val=ade('val', 'validation', base['data']['val']['pipeline']),
        test=ade('test', 'validation', base['data']['test']['pipeline']))
    aux = copy.deepcopy(base['model']['auxiliary_head'])
    for head in aux:
        head['num_classes'] = ADE_CLASSES
    path = os.path.join(root, 'setr_deit-base_pup_512x512_ade20k_MT_w_ours.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{CONFIGS["ours"]!r}]\n'
                f'data = {data!r}\n'
                f'model = dict(decode_head=dict(num_classes={ADE_CLASSES}), '
                f'auxiliary_head={aux!r})\n')
    return path


def ade_concat_config(root, ade_cfg, data_root, val_stems):
    """``ade_cfg`` with ``data.test`` a ``ConcatDataset`` of the two halves
    of the val stems (split files), separate evaluation."""
    from s4former_tpu_torch.config import Config
    test = Config.fromfile(ade_cfg).to_dict()['data']['test']
    halves = []
    for i, stems in enumerate((val_stems[:len(val_stems) // 2],
                               val_stems[len(val_stems) // 2:])):
        split = os.path.join(root, f'ade_val_{i}.txt')
        with open(split, 'w') as f:
            f.write('\n'.join(stems) + '\n')
        halves.append(dict(test, split=split))
    path = os.path.join(root, 'ade20k_concat_test.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{ade_cfg!r}]\n'
                f'data = dict(test=dict(_delete_=True, type="ConcatDataset",'
                f' separate_eval=True, datasets={halves!r}))\n')
    return path


def eval_flushes(shapes, batch=4):
    """The exact eval's flushes over images of these shapes: one group a
    shape, ``batch`` images a flush."""
    from collections import Counter
    return sum(-(-n // batch) for n in Counter(shapes).values())


def phase_ade_train_cli(fa, gpu_line, root, deit, n_backbone):
    """The flagship on ADE20K through the port's CLIs: ``tools.train`` on
    ``..._MT_w_ours.py`` with ``ADE20KDataset`` and 150 classes (bf16,
    DeiT-B at full depth from the bare-key DeiT-B file, 4 + 4 at 512² a
    step through the real pipelines and loader) over a seeded ADE20K tree,
    6 steps with eval and checkpoint at 6; ``tools.test --eval mIoU
    --show-dir`` on ``iter_6`` within TOL_MIOU of the in-loop mIoU; then
    ``tools.test`` on a ``ConcatDataset`` of the two val halves, with
    separate evaluation (keys ``0_``, ``1_``) and merged (one histogram:
    the whole folder's mIoU); then ``--eval cityscapes`` on the Cityscapes
    phase's tree (``mit_train_cli``), which must raise the JAX package's
    missing-package ImportError. Returns the runs' launch counts summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    data_root = os.path.join(root, 'ade')
    val_stems, val_sizes = write_ade_tree(data_root)
    cfg_path = ade_cli_config(root, data_root)
    wd = os.path.join(root, 'ade_work')
    opts = ['--cfg-options', 'evaluation.interval=6',
            'checkpoint_config.interval=6', 'log_config.interval=3']
    # the keep-ratio (2048, 512) test pipeline leaves a short side of 512
    # as it is, so each image size is one shape of the eval (L = 1377 for
    # 683 x 512 either way round, 1281 for 640 x 512)
    per_eval = 12 * eval_flushes(val_sizes)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    state = train_cli.main([cfg_path, '--work-dir', wd, '--max-iters', '6',
                            '--load-from', deit] + opts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)                      # the main path ends
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == 6, f'trained to step {int(state.step)}')
    n_classes = state.model.num_classes
    del state
    torch.cuda.empty_cache()
    check(n_classes == ADE_CLASSES, f'the model has {n_classes} classes')
    loaded = f'({n_backbone} of {n_backbone} backbone tensors)'
    check(loaded in read_logs(wd), f'the log does not report {loaded}')
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [3, 6] and sorted(val) == [6],
          f'logged steps {records}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(train_counts == {'flash_attn_fwd': 36 * 6 + per_eval,
                           'flash_attn_bwd_fused': 24 * 6,
                           'flash_attn_bwd_dkv': 0,
                           'flash_attn_bwd_dq': 0},
          f'6 steps + 1 eval launched {train_counts}, not 36 forward + 24 '
          f'fused a step and {per_eval} forward an eval')

    reset_counts(fa)
    t0 = time.perf_counter()
    vis = os.path.join(root, 'ade_vis')
    ckpt = os.path.join(wd, 'iter_6')
    results = test_cli.main([cfg_path, ckpt, '--eval', 'mIoU',
                             '--show-dir', vis])
    test_s = time.perf_counter() - t0
    concat_cfg = ade_concat_config(root, cfg_path, data_root, val_stems)
    separate = test_cli.main([concat_cfg, ckpt])
    merged = test_cli.main([concat_cfg, ckpt, '--cfg-options',
                            'data.test.separate_eval=False'])
    test_counts = counts(fa)
    check(test_counts == {'flash_attn_fwd': 3 * per_eval,
                          'flash_attn_bwd_fused': 0,
                          'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0},
          f'3 offline tests launched {test_counts}, not {per_eval} forward '
          f'each')
    in_loop = val[6]['mIoU']
    gap = abs(results['mIoU'] - in_loop)
    painted = sorted(os.listdir(vis))
    check(painted == [f'{s}.png' for s in val_stems],
          f'--show-dir wrote {painted}')
    check(sorted({k.split('_', 1)[0] for k in separate}) == ['0', '1'],
          f'separate concat eval keys {sorted(separate)}')
    merged_gap = abs(merged['mIoU'] - results['mIoU'])
    check(merged_gap <= TOL_MIOU, f'merged concat mIoU {merged["mIoU"]} '
          f'vs the whole folder {results["mIoU"]}')

    # the official Cityscapes evaluator on mit_train_cli's tree: the
    # package is not installed, so the JAX package's ImportError
    reset_counts(fa)
    city = os.path.join(root, 'city')
    city_opts = ['--cfg-options', 'model.backbone.dtype=bfloat16',
                 'model.decode_head.dtype=bfloat16',
                 f'data.test.data_root={city}',
                 f'data.test.split={os.path.join(city, "val.txt")}']
    try:
        test_cli.main([MIT_CONFIGS['ours'], '--eval', 'cityscapes',
                       '--imgfile-prefix', os.path.join(root, 'city_eval')]
                      + city_opts)
        error = None
    except ImportError as e:
        error = str(e)
    city_counts = counts(fa)
    check(error is not None and 'cityscapesscripts' in error,
          f'--eval cityscapes without cityscapesscripts: {error!r}')
    check(all_zero(city_counts), f'the MiT launched a kernel: '
          f'{city_counts}')
    step_ms = [r['step_ms'] for r in train]
    emit({'phase': 'ade_train_cli', 'config': os.path.basename(cfg_path),
          'batch': '4 + 4 at 512², bf16, 12 layers, 150 classes',
          'data': f'{len(val_stems)} + 16 + 16 seeded JPEGs at '
                  f'{ADE_SIZES}, labels 0-150',
          'pretrained': f'{os.path.basename(deit)}: {loaded} loaded',
          'losses': {r['step']: r['loss'] for r in train},
          'mask_ratio': {r['step']: r['mask_ratio'] for r in train},
          'step_ms_windows': step_ms,
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'eval_s': val[6]['eval_s'], 'miou': val[6]['mIoU'],
          'train_run_s': train_s, 'peak_mem_bytes': peak,
          'peak_mem_bytes_21_classes': PEAKS.get('train_cli'),
          'launches': {'train': train_counts, 'test': test_counts,
                       'cityscapes': city_counts},
          'test_miou': results['mIoU'], 'in_loop_miou_iter_6': in_loop,
          'miou_gap': gap, 'tol': TOL_MIOU, 'test_run_s': test_s,
          'show_dir_files': len(painted),
          'concat_separate': {k: v for k, v in separate.items()
                              if k.split('_', 1)[1] in ('aAcc', 'mIoU')},
          'concat_merged_miou': merged['mIoU'],
          'concat_merged_gap': merged_gap,
          'cityscapes_metric': error, 'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{in_loop}: {gap} > {TOL_MIOU}')
    shutil.rmtree(wd, ignore_errors=True)
    return add_counts(add_counts(train_counts, test_counts), city_counts)


# ---------------------------------------------------- the ablation flags
# the flag sets of ``ablation_train_bf16``, over ``..._MT_w_ours.py``: every
# flag ported for the ablations is live at full width in one of them. The
# flagship's PatchShuffle + CutMix is off in (a) and (b), which shuffle
# otherwise (a second shuffle would leave the first one's undone).
ABLATION_SETS = {
    'a_strong_mixes': dict(
        use_PatchShuffle_w_Cutmix=False, use_CutMix=True, patchwise=True,
        use_CutOut=True, use_ClassMix=True, mix_with_labeled=True,
        use_PatchShuffle=True, sup_cutmix=True),
    'b_adaptive_ps_classmix': dict(
        use_PatchShuffle_w_Cutmix=False, use_cutmix_adaptive=True,
        use_PatchShuffle_w_Classmix=True, sup_ClassMix=True),
    'c_regularisers': dict(
        use_fdrop=True, attn_mask_w_fdrop=True, momentum_head_dropout=0.1,
        negative_class_ranking_mode='both', sup_ema=True),
}
# set (c)'s model and optimizer: ViT dropout, drop path and attention
# dropout, SETR head dropout, sigmoid CE on the aux heads, layer decay
ABLATION_RATES = dict(drop_rate=0.1, drop_path_rate=0.1, attn_drop_rate=0.1)
ABLATION_DROPOUT_RATIO = 0.1
ABLATION_LAYER_DECAY = dict(num_layers=12, decay_rate=0.65)
# ablation_f32_vs_cpu: every group of the ablation tests whose draws
# chip_smoke can hand both devices (fdrop's masks are drawn in the model;
# 'sup_only' and sup_ClassMix exclude 'both' and sup_cutmix)
ABLATION_F32 = dict(
    use_CutMix=True, patchwise=True, use_CutOut=True, use_ClassMix=True,
    mix_with_labeled=True, use_PatchShuffle=True,
    use_PatchShuffle_w_Classmix=True, use_cutmix_adaptive=True,
    sup_cutmix=True, momentum_head_dropout=0.5,
    negative_class_ranking_mode='both', sup_ema=True)


def ablation_config(name, dtype=None, num_layers=None, regularisers=False):
    """``..._MT_w_ours.py``; with ``regularisers`` set (c)'s rates, head
    dropout and sigmoid aux CE."""
    cfg = load_config(dtype, name, num_layers)
    if regularisers:
        cfg.model.backbone.update(ABLATION_RATES)
        cfg.model.decode_head.dropout_ratio = ABLATION_DROPOUT_RATIO
        for head in cfg.model.auxiliary_head:
            head.dropout_ratio = ABLATION_DROPOUT_RATIO
            head.loss_decode.use_sigmoid = True
    return cfg


def predicted_launches(semi, num_layers, remat=False):
    """The flash kernels' launches a step at L = 1025 from the flags: every
    ViT forward launches the forward kernel once a layer and every student
    pass the fused backward once a layer. Teacher (twice under UniMatch,
    whose batches carry the mix stream); the EMA on the labeled images
    (supervised NCR or sup_ema); the supervised pass; the supervised NCR
    pass; the unsup passes: UniMatch's head 1 and two streams, else one
    fused 2B pass or PASA, fdrop and the final pass. With ``remat`` each
    student pass launches the forward once more a layer (the layer's
    recomputation in the backward)."""
    ncr_sup = semi.negative_class_ranking and \
        semi.negative_class_ranking_mode in ('sup_only', 'both')
    fused = (semi.fuse_unsup_passes and semi.attn_mask_seperate_head and
             not semi.use_fdrop and not semi.attn_mask_w_fdrop)
    if semi.unimatch:
        teacher, unsup = 2, 3
    else:
        teacher = 1
        unsup = 1 if fused else (int(semi.attn_mask_seperate_head) +
                                 int(semi.use_fdrop) + 1)
    student = 1 + int(ncr_sup) + unsup
    fwd = teacher + int(ncr_sup or semi.sup_ema) + student * (1 + remat)
    return {'flash_attn_fwd': fwd * num_layers,
            'flash_attn_bwd_fused': student * num_layers,
            'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}


def ablation_draws(semi, n, size, num_classes, n_head_params, seed=0):
    """Every draw of ``semi``'s mixes and EMA head skips, made once with a
    CPU generator, as ``dbg_`` batch keys for both devices."""
    import torch
    from s4former_tpu_torch.semi import mixes
    from s4former_tpu_torch.semi.ema import head_skip_draw
    gen = torch.Generator().manual_seed(seed)
    hw = (size, size)
    ps = semi.patchsize * semi.PatchMix_N
    dummy = torch.zeros((n, size, size, 1))

    def perm():
        return mixes.patch_shuffle(gen, dummy, semi.PatchMix_N,
                                   semi.patchsize, semi.patchmix_ratio)[1]
    out = {
        'strong_cutmix_mask': mixes.mix_masks(gen, n, hw, semi.cutout_area,
                                              semi.patchwise, ps),
        'cutout_mask': mixes.mix_masks(gen, n, hw, semi.cutout_area,
                                       semi.patchwise, ps),
        'classmix_scores': mixes.class_scores(gen, n, num_classes, hw,
                                              semi.patchwise, 128),
        'shuffle_perm': perm(),
        'cutmix_mask': mixes.random_box_mask(gen, n, hw, semi.cutout_area),
        'patchmix_perm': perm(),
        'ps_classmix_scores': mixes.class_scores(gen, n, num_classes, hw,
                                                 semi.patchwise, ps),
        'sup_cutmix_mask': mixes.random_box_mask(gen, n, hw, 2.0),
        'sup_classmix_scores': mixes.class_scores(gen, n, num_classes, hw),
        'ema_head_skip': head_skip_draw(gen, n_head_params,
                                        semi.momentum_head_dropout, 'cpu')}
    out.update({'adaptive_' + k: v for k, v in
                mixes.adaptive_draws(gen, n, hw).items()})
    return {'dbg_' + k: v.numpy() for k, v in out.items()}


def phase_ablation_f32_vs_cpu(fa, images):
    """One S4Former step of ``..._MT_w_ours.py`` with ABLATION_F32's flags
    and set (c)'s layer decay and sigmoid aux CE, in f32 at full width,
    depth cut to 4 layers, 2 + 2 images at 512², dropout rates 0: on the
    card and on the CPU from the same weights and the same draws (every
    mix, gate and EMA head skip from ``ablation_draws``). Tolerances of
    train_f32_vs_cpu. Returns the card's launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ablation_config('ours', 'float32', 4, regularisers=True)
    for head in [cfg.model.decode_head] + list(cfg.model.auxiliary_head):
        head.dropout_ratio = 0.0
    cfg.model.backbone.update({k: 0.0 for k in ABLATION_RATES})
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                               unsup_confidence=UNSUP_CONFIDENCE_F32,
                               **ABLATION_F32)
    batch = train_batch(images, 2, 2)
    layer_decay = dict(ABLATION_LAYER_DECAY, num_layers=4)
    runs = {}
    for device in ('cuda', 'cpu'):
        state, step = trainer_from_config(
            cfg, device, layer_decay, unsup_confidence=UNSUP_CONFIDENCE_F32,
            **ABLATION_F32)
        if device == 'cuda':
            n_head = len(list(state.model.decode_head.parameters()))
            batch.update(ablation_draws(semi, 2, 512, state.model.num_classes,
                                        n_head))
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
    expect = predicted_launches(semi, 4)
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc}
    scale = max(d.abs().max().item() for d in dc.values())
    upd_err = max((dg[n] - dc[n]).abs().max().item() for n in dc)
    emit({'phase': 'ablation_f32_vs_cpu', 'config': 'ours',
          'flags': {k: v for k, v in ABLATION_F32.items()},
          'layer_decay': layer_decay, 'sigmoid_aux_ce': True,
          'cut': 'num_layers 12 -> 4, out_indices (0, 1, 2, 3); dropout, '
                 'drop path and head dropout 0',
          'batch': f'2 sup + 2 unsup at 512², unsup_confidence '
                   f'{UNSUP_CONFIDENCE_F32}',
          'losses_card': lg, 'losses_cpu': lc, 'loss_rel_err': loss_err,
          'update_max_abs_err': upd_err, 'update_max_abs_cpu': scale,
          'tol': TOL_TRAIN_F32, 'card_step_s': sg, 'cpu_step_s': sc,
          'launches': cg, 'launches_predicted': expect})
    check(cg == expect, f'f32 ablation step launches {cg}, not {expect}')
    check(not any(cc.values()), 'the CPU step reached a kernel')
    check(sorted(lg) == sorted(lc), 'log keys differ')
    check(lc['mask_ratio'] > 0 and lc['unsup.loss_seg_unsup'] > 0 and
          lc['loss_ncr_sup'] > 0 and lc['loss_decode_sup_ema'] > 0,
          'the ablation losses are not live')
    check(all(np.isfinite(v) for v in lg.values()), 'non-finite losses')
    check(max(loss_err.values()) <= TOL_TRAIN_F32,
          f'f32 ablation losses, card vs CPU: {loss_err}')
    check(upd_err <= TOL_TRAIN_F32 * scale,
          f'f32 ablation updates differ by {upd_err} (max {scale})')
    return cg


def phase_ablation_train_bf16(fa, images, gpu_line):
    """``..._MT_w_ours.py`` in bf16 at full depth, 4 + 4 fixture images at
    512² from one batch, once for each of ABLATION_SETS ((c) with its
    rates, head dropout, sigmoid aux CE and layer decay): the first step, 3
    timed (mean, p50), 1 profiled; the flash launches of every step checked
    against the flags' predicted passes; peak memory; finite losses.
    Returns the launch counts of the three sets summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    total = None
    batch = to_device(train_batch(images, 4, 4), 'cuda')
    for name, flags in ABLATION_SETS.items():
        regularisers = name.startswith('c_')
        cfg = ablation_config('ours', None, None, regularisers)
        check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
        state, step = trainer_from_config(
            cfg, 'cuda', ABLATION_LAYER_DECAY if regularisers else None,
            **flags)
        semi = SemiConfig.from_model_cfg(dict(cfg.model, **flags))
        expect = predicted_launches(semi, 12)
        gen = torch.Generator(device='cuda').manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)                           # the main path starts
        state, logs, ms = timed_steps(state, step, batch, gen, 4)
        (state, logs), prof = device_profile(
            lambda: step(state, batch, gen), 12)
        path_counts = counts(fa)                   # the main path ends
        peak = torch.cuda.max_memory_allocated()
        lg = floats(logs)
        timed = np.asarray(ms[1:])
        emit({'phase': 'ablation_train_bf16', 'set': name, 'flags': flags,
              'regularisers': dict(ABLATION_RATES,
                                   dropout_ratio=ABLATION_DROPOUT_RATIO,
                                   sigmoid_aux_ce=True,
                                   layer_decay=ABLATION_LAYER_DECAY)
              if regularisers else None,
              'batch': '4 + 4 at 512², bf16, 12 layers',
              'first_step_ms': ms[0], 'step_ms': ms[1:],
              'step_ms_mean': float(timed.mean()),
              'step_ms_p50': float(np.median(timed)),
              'img_per_s': 8 / (timed.mean() / 1e3),
              'peak_mem_bytes': peak, 'mask_ratio': lg['mask_ratio'],
              'logs': lg, 'profile': prof, 'launches': path_counts,
              'launches_per_step_predicted': expect, 'gpu': gpu_line})
        check(all(np.isfinite(v) for v in lg.values()),
              f'{name}: non-finite logs {lg}')
        check(path_counts == {k: 5 * v for k, v in expect.items()},
              f'{name}: 5 steps launched {path_counts}, not {expect} a step')
        total = path_counts if total is None else add_counts(total,
                                                             path_counts)
        del state, step
        torch.cuda.empty_cache()
    return total


def phase_ablation_mit_fdrop(fa, gpu_line, n_sup, n_unsup):
    """MiT-B4 ``..._MT_w_ours.py`` in bf16 with ``use_fdrop`` and
    ``attn_mask_w_fdrop``, drop path and head dropout live, ``n_sup`` +
    ``n_unsup`` seeded scenes at 768²: 2 steps, timed; fdrop's loss live,
    finite losses, peak memory, and no flash launch."""
    import numpy as np
    import torch
    cfg = load_mit_config('ours', 'bfloat16')
    state, step = trainer_from_config(cfg, 'cuda', use_fdrop=True,
                                      attn_mask_w_fdrop=True)
    batch = to_device(mit_train_batch(np.random.RandomState(6), n_sup,
                                      n_unsup), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 2)
    path_counts = counts(fa)                       # the main path ends
    lg = floats(logs)
    emit({'phase': 'ablation_mit_fdrop', 'config': 'ours',
          'batch': f'{n_sup} + {n_unsup} at {MIT_CROP}², bf16, depth '
                   f'[3, 8, 27, 3], fdrop + PASA fdrop, drop path 0.1 and '
                   f'dropout 0.1 live',
          'step_ms': ms, 'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'mask_ratio': lg['mask_ratio'], 'logs': lg,
          'launches': path_counts, 'gpu': gpu_line})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check('unsup.loss_seg_unsup_fdrop' in lg, 'no fdrop loss')
    check(all_zero(path_counts), f'the MiT launched a kernel: {path_counts}')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def phase_ablation_train_cli(fa, gpu_line, root):
    """``tools.train`` on ``setr_fixture_voc_mini_fullflag.py`` (bf16,
    DeiT-B, 4 + 4 a step) with set (c) through ``--cfg-options``: ViT
    dropout, drop path and attention dropout, SETR head dropout, fdrop
    with the PASA pass, EMA head dropout, NCR 'both', sup_ema, layer decay
    through ``optimizer.paramwise_cfg`` and the main head's CE as sigmoid
    (the config takes no list keys, so the aux heads' cannot be set). 6
    steps, eval and checkpoint at 6, then ``--auto-resume`` to 8; each run's
    launches checked against the flags' passes and the eval's. Returns
    the runs' counts summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.tools import train as train_cli
    sets = ABLATION_SETS['c_regularisers']
    opts = ['--cfg-options', 'evaluation.interval=6',
            'checkpoint_config.interval=6', 'log_config.interval=3',
            'model.decode_head.dropout_ratio=0.1',
            'model.decode_head.loss_decode.use_sigmoid=True',
            'optimizer.paramwise_cfg.num_layers=12',
            'optimizer.paramwise_cfg.decay_rate=0.65'] + \
        [f'model.backbone.{k}={v}' for k, v in ABLATION_RATES.items()] + \
        [f'model.{k}={v}' for k, v in sets.items()]
    from s4former_tpu_torch.config import Config
    semi = SemiConfig.from_model_cfg(dict(Config.fromfile(FULLFLAG).model,
                                          **sets))
    per_step = predicted_launches(semi, 12)
    per_eval = 12 * 4                              # 16 val images, 4 a flush
    wd = os.path.join(root, 'ablation_work')
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    state = train_cli.main([FULLFLAG, '--work-dir', wd, '--max-iters', '6']
                           + opts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)                      # the main path ends
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == 6, f'trained to step {int(state.step)}')
    check(state.model.backbone.drop_path_rate == 0.1 and
          state.model.decode_head.dropout_ratio == 0.1,
          'the --cfg-options did not reach the model')
    del state
    torch.cuda.empty_cache()
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [3, 6] and sorted(val) == [6],
          f'logged steps {records}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check({'loss_ncr_sup', 'loss_decode_sup_ema',
           'unsup.loss_seg_unsup_fdrop'} <= set(train[-1]),
          f'the ablation losses are not logged: {sorted(train[-1])}')
    want = {k: 6 * v for k, v in per_step.items()}
    want['flash_attn_fwd'] += per_eval
    check(train_counts == want, f'6 steps + 1 eval launched '
          f'{train_counts}, not {want}')

    reset_counts(fa)
    state = train_cli.main([FULLFLAG, '--work-dir', wd, '--auto-resume',
                            '--max-iters', '8'] + opts)
    torch.cuda.synchronize()
    resume_counts = counts(fa)
    check(int(state.step) == 8, f'resumed run ended at {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    resumed = f'resumed from {os.path.join(wd, "iter_6")}'
    check(resumed in read_logs(wd), f'no "{resumed}" in the log')
    check(resume_counts == {k: 2 * v for k, v in per_step.items()},
          f'2 resumed steps launched {resume_counts}')
    emit({'phase': 'ablation_train_cli', 'config': os.path.basename(FULLFLAG),
          'cfg_options': opts[1:], 'batch': '4 + 4 at 512², bf16, 12 layers',
          'losses': {r['step']: r['loss'] for r in train},
          'logs_iter_6': train[-1],
          'step_ms_windows': [r['step_ms'] for r in train],
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'miou_6': val[6]['mIoU'], 'eval_s': val[6]['eval_s'],
          'train_run_s': train_s, 'peak_mem_bytes': peak,
          'launches': {'train': train_counts, 'resume': resume_counts},
          'launches_per_step_predicted': per_step, 'resumed': resumed,
          'gpu': gpu_line})
    shutil.rmtree(wd, ignore_errors=True)
    return add_counts(train_counts, resume_counts)


def run_ablation(fa, images, gpu_line, root):
    """The ablation slice's phases; returns their launch counts by path
    and prints their seconds."""
    mit_cfg = load_mit_config('ours')
    mit_batch = (mit_cfg.samples_per_gpu_sup, mit_cfg.samples_per_gpu_unsup)
    paths, seconds = {}, {}
    for name, run in (
            ('ablation_f32', lambda: phase_ablation_f32_vs_cpu(fa, images)),
            ('ablation_train_bf16',
             lambda: phase_ablation_train_bf16(fa, images, gpu_line)),
            ('ablation_mit_fdrop',
             lambda: phase_ablation_mit_fdrop(fa, gpu_line, *mit_batch)),
            ('ablation_train_cli',
             lambda: phase_ablation_train_cli(fa, gpu_line, root))):
        t0 = time.perf_counter()
        paths[name] = run()
        seconds[name] = time.perf_counter() - t0
    emit({'phase': 'ablation_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths


# ------------------------------------------------------ UniMatch and remat
# UniMatch over ``..._MT_w_ours.py``: the two streams PatchShuffled, the
# flagship's PatchShuffle + CutMix off (UniMatch runs no strong-mix cascade)
UNIMATCH_FLAGS = dict(unimatch=True, use_PatchShuffle=True,
                      use_PatchShuffle_w_Cutmix=False)
REMAT = {'off': dict(remat_layers=False),
         'dots': dict(remat_layers=True, remat_policy='dots'),
         'full': dict(remat_layers=True, remat_policy='full')}
# one bf16 step with remat against the same step without, from the same
# weights, batch and draws: the forwards are the same kernels on the same
# inputs, but the fused backward adds dq over its k tiles with atomics in a
# run-dependent order and every gradient is rounded to bf16 (2^-8 of its
# value), so losses and updates agree to bf16 rounding, relative to the
# loss and to the largest update. Two runs without remat are compared too.
TOL_REMAT_BF16 = 2e-2


def unimatch_batch(images, n_sup, n_unsup, size=512):
    """``train_batch`` with UniMatch's views: the unsup images are the
    teacher's and the first student's view, their mirror images the second
    student's; the labeled images in reverse order are the mix-source
    stream (the same three views). ``n_unsup <= n_sup``."""
    import numpy as np
    batch = train_batch(images, n_sup, n_unsup, size)
    return with_mix_views(batch, batch['sup_img'][::-1][:n_unsup])


def with_mix_views(batch, mix):
    """``batch`` with the second student view (the unsup images mirrored)
    and the mix-source stream's three views of ``mix``."""
    import numpy as np

    def mirror(x):
        return np.ascontiguousarray(x[:, :, ::-1])
    batch = dict(batch)
    mix = np.ascontiguousarray(mix)
    batch['unsup_student_2_img'] = mirror(batch['unsup_student_img'])
    batch['unsup_teacher_mix_img'] = batch['unsup_student_mix_img'] = mix
    batch['unsup_student_2_mix_img'] = mirror(mix)
    return batch


def unimatch_draws(semi, n, size, seed=0):
    """Fixed boxes (a square of a quarter of the image each) and
    super-patch permutations of the two streams, as the ``dbg_um_*`` keys
    of both devices."""
    import numpy as np
    rs = np.random.RandomState(seed)
    gg = (size // (semi.patchsize * semi.PatchMix_N)) ** 2
    out = {}
    for idx in (1, 2):
        mask = np.ones((n, size, size), np.float32)
        for b in range(n):
            y, x = rs.randint(0, size // 2, 2)
            mask[b, y:y + size // 2, x:x + size // 2] = 0
        out[f'dbg_um_cutmix_mask_{idx}'] = mask
        out[f'dbg_um_patchmix_perm_{idx}'] = np.stack(
            [rs.permutation(gg) for _ in range(n)]).astype(np.int32)
    return out


@contextlib.contextmanager
def masks_from_cpu(seed=0):
    """The models' dropout, drop-path and fdrop masks
    (``models.dropout.keep_mask``) drawn from one seeded CPU generator and
    moved to the tensor's device, so the card and the CPU drop the same
    values; the step's own generator is not used for them."""
    import torch
    from s4former_tpu_torch.models import dropout
    original = dropout.keep_mask
    gen = torch.Generator().manual_seed(seed)

    def keep_mask(generator, keep, shape, device):
        return (torch.rand(tuple(shape), generator=gen) < keep).to(device)
    dropout.keep_mask = keep_mask
    try:
        yield
    finally:
        dropout.keep_mask = original


def unimatch_step_vs_cpu(fa, cfg, batch, semi_over):
    """One step of ``cfg`` on the card and on the CPU from the same seeded
    weights, batch, injected draws and masks: (logs, parameter updates,
    seconds, launch counts) by device."""
    import torch
    runs = {}
    for device in ('cuda', 'cpu'):
        state, step = trainer_from_config(cfg, device, **semi_over)
        before = {n: p.detach().cpu().clone()
                  for n, p in state.model.named_parameters()}
        dev_batch = to_device(batch, device)
        reset_counts(fa)
        t0 = time.perf_counter()
        with masks_from_cpu():
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
    return runs


def phase_unimatch_f32_vs_cpu(fa, images):
    """One UniMatch step in f32 against the CPU, the streams' boxes and
    permutations injected: ``..._MT_w_ours.py`` at full width, depth cut to
    4 layers, 2 + 2 at 512², dropout and drop path 0, the threshold
    UNSUP_CONFIDENCE_F32, with head 1 as the PASA pass and as the fdrop
    pass (``attn_mask_seperate_head`` off; its fdrop masks from
    ``masks_from_cpu``); then MiT-B4 ``_MT_w_ours`` at depth
    MIT_TRAIN_F32_DEPTH, 1 + 1 at 768², the threshold the CPU teacher's
    median max-probability. Tolerances of train_f32_vs_cpu. Returns the
    card's launch counts summed."""
    import dataclasses
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = []
    vit_cfg = load_config('float32', 'ours', 4)
    vit_cfg.model.backbone.update(drop_rate=0.0, drop_path_rate=0.0)
    vit_batch = unimatch_batch(images, 2, 2)
    for head in ('pasa', 'fdrop'):
        over = dict(UNIMATCH_FLAGS, unsup_confidence=UNSUP_CONFIDENCE_F32,
                    attn_mask_seperate_head=head == 'pasa')
        cases.append((f'deit_{head}', vit_cfg, vit_batch, over, 512))
    mit_cfg = load_mit_config('ours', 'float32', MIT_TRAIN_F32_DEPTH,
                              drop=False)
    mit_batch = mit_train_batch(np.random.RandomState(5), 1, 1)
    mit_batch = with_mix_views(mit_batch, mit_batch['sup_img'])
    state, _ = trainer_from_config(mit_cfg, 'cpu')
    with torch.no_grad():
        t_logits = state.model.forward_decode_from_img(
            torch.from_numpy(mit_batch['unsup_teacher_img']), train=False)
    threshold = float(torch.softmax(t_logits.float(), -1).amax(-1).median())
    del state
    cases.append(('mit_pasa', mit_cfg, mit_batch,
                  dict(UNIMATCH_FLAGS, unsup_confidence=threshold), MIT_CROP))
    total = None
    for name, cfg, batch, over, size in cases:
        semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                                   **over)
        n = batch['unsup_student_img'].shape[0]
        batch = dict(batch, **unimatch_draws(semi, n, size))
        runs = unimatch_step_vs_cpu(fa, cfg, batch, over)
        (lg, dg, sg, cg), (lc, dc, sc, cc) = runs['cuda'], runs['cpu']
        mit = name.startswith('mit')
        expect = {k: 0 for k in KERNELS} if mit else \
            predicted_launches(semi, 4)
        loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6)
                    for k in lc}
        scale = max(d.abs().max().item() for d in dc.values())
        upd_err = max((dg[n_] - dc[n_]).abs().max().item() for n_ in dc)
        head = 'unsup.loss_seg_unsup_fdrop' if name == 'deit_fdrop' else \
            'unsup.loss_seg_unsup_attn_mask'
        emit({'phase': 'unimatch_f32_vs_cpu', 'case': name,
              'config': 'ours', 'flags': over,
              'cut': f'depth [3, 8, 27, 3] -> {list(MIT_TRAIN_F32_DEPTH)}'
                     if mit else 'num_layers 12 -> 4, out_indices (0, 1, '
                                 '2, 3); dropout and drop path 0',
              'batch': f'{n} + {n} at {size}² (+ the mix stream), '
                       f'unsup_confidence {over["unsup_confidence"]}',
              'losses_card': lg, 'losses_cpu': lc, 'loss_rel_err': loss_err,
              'update_max_abs_err': upd_err, 'update_max_abs_cpu': scale,
              'tol': TOL_TRAIN_F32, 'card_step_s': sg, 'cpu_step_s': sc,
              'launches': cg, 'launches_predicted': expect})
        check(cg == expect, f'{name}: launches {cg}, not {expect}')
        check(not any(cc.values()), f'{name}: the CPU step reached a kernel')
        check(sorted(lg) == sorted(lc), f'{name}: log keys differ')
        check(0 < lc['mask_ratio'] < 1 and lc[head] > 0 and
              lc['unsup.loss_seg_unsup_1'] > 0 and
              lc['unsup.loss_ncr_unsup_2'] > 0,
              f'{name}: the UniMatch losses are not live: {lc}')
        check(all(np.isfinite(v) for v in lg.values()),
              f'{name}: non-finite losses')
        check(max(loss_err.values()) <= TOL_TRAIN_F32,
              f'{name}: f32 losses, card vs CPU: {loss_err}')
        check(upd_err <= TOL_TRAIN_F32 * scale,
              f'{name}: f32 updates differ by {upd_err} (max {scale})')
        total = cg if total is None else add_counts(total, cg)
    return total


def remat_config(name, remat):
    """A flagship config as written (bf16) with the ViT's remat set."""
    cfg = load_config(None, name)
    cfg.model.backbone.update(REMAT[remat])
    return cfg


def phase_unimatch_train_bf16(fa, images, gpu_line):
    """UniMatch on ``..._MT_w_ours.py`` in bf16 at full depth, 8 + 8 at
    512² (bench.py's batch) from one fixed batch with its mix stream, the
    streams PatchShuffled: the first step, 3 timed (mean, p50), 1 profiled;
    every step's launches against predicted_launches (72 + 48); peak
    memory. Returns the launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    cfg = remat_config('ours', 'off')
    check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                               **UNIMATCH_FLAGS)
    expect = predicted_launches(semi, 12)
    check(expect['flash_attn_fwd'] == 72 and
          expect['flash_attn_bwd_fused'] == 48, f'prediction {expect}')
    state, step = trainer_from_config(cfg, 'cuda', **UNIMATCH_FLAGS)
    batch = to_device(unimatch_batch(images, 8, 8), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 4)
    (state, logs), prof = device_profile(lambda: step(state, batch, gen), 14)
    path_counts = counts(fa)                       # the main path ends
    peak = torch.cuda.max_memory_allocated()
    lg = floats(logs)
    timed = np.asarray(ms[1:])
    emit({'phase': 'unimatch_train_bf16', 'config': 'ours',
          'flags': UNIMATCH_FLAGS, 'batch': '8 + 8 at 512² (+ the mix '
          'stream), bf16, 12 layers', 'first_step_ms': ms[0],
          'step_ms': ms[1:], 'step_ms_mean': float(timed.mean()),
          'step_ms_p50': float(np.median(timed)),
          'img_per_s': 16 / (timed.mean() / 1e3), 'peak_mem_bytes': peak,
          'mask_ratio': lg['mask_ratio'], 'logs': lg, 'profile': prof,
          'launches': path_counts, 'launches_per_step_predicted': expect,
          'gpu': gpu_line})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check({'unsup.loss_seg_unsup_attn_mask', 'unsup.loss_seg_unsup_1',
           'unsup.loss_seg_unsup_2'} <= set(lg), f'UniMatch logs {sorted(lg)}')
    check(path_counts == {k: 5 * v for k, v in expect.items()},
          f'5 UniMatch steps launched {path_counts}, not {expect} a step')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def phase_remat_train_bf16(fa, images, gpu_line):
    """The flagship ``..._MT_w_ours.py`` 8 + 8 step and the UniMatch 8 + 8
    step (bf16, 12 layers, one fixed batch), each with remat off, 'dots'
    and 'full': the first step's losses and parameter updates against
    remat off's (and a second run without remat) within TOL_REMAT_BF16;
    then 3 steps timed and 1 profiled, with peak memory; launches against
    predicted_launches with remat (60 + 24, 120 + 48). Returns the counts
    summed."""
    import dataclasses
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    total = None
    for regime, over in (('flagship', {}), ('unimatch', UNIMATCH_FLAGS)):
        batch = to_device(unimatch_batch(images, 8, 8) if over else
                          train_batch(images, 8, 8), 'cuda')
        first = {}
        for remat in ('off', 'dots', 'full', 'off_again'):
            cfg = remat_config('ours', remat.split('_')[0])
            semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                                       **over)
            expect = predicted_launches(semi, 12, remat != 'off' and
                                        remat != 'off_again')
            state, step = trainer_from_config(cfg, 'cuda', **over)
            before = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}
            gen = torch.Generator(device='cuda').manual_seed(0)
            torch.cuda.synchronize()
            reset_counts(fa)                       # the main path starts
            state, logs, ms = timed_steps(state, step, batch, gen, 1)
            delta = {n: (p.detach() - before[n]).float().cpu()
                     for n, p in state.model.named_parameters()}
            del before
            first[remat] = (floats(logs), delta)
            if remat == 'off_again':
                path_counts = counts(fa)
                del state, step
                torch.cuda.empty_cache()
                check(path_counts == expect, f'{regime}, remat off again: '
                      f'launched {path_counts}, not {expect}')
                break
            torch.cuda.reset_peak_memory_stats()
            state, _, timed = timed_steps(state, step, batch, gen, 3)
            (state, _), prof = device_profile(
                lambda: step(state, batch, gen), 6)
            path_counts = counts(fa)               # the main path ends
            peak = torch.cuda.max_memory_allocated()
            del state, step
            torch.cuda.empty_cache()
            lg, dg = first[remat]
            l0, d0 = first['off']
            scale = max(d.abs().max().item() for d in d0.values())
            loss_err = {k: abs(lg[k] - l0[k]) / max(abs(l0[k]), 1e-6)
                        for k in l0 if 'loss' in k}
            upd_err = max((dg[n] - d0[n]).abs().max().item() for n in d0)
            emit({'phase': 'remat_train_bf16', 'regime': regime,
                  'remat': REMAT[remat], 'config': 'ours', 'flags': over,
                  'batch': '8 + 8 at 512², bf16, 12 layers',
                  'first_step_ms': ms[0], 'step_ms': timed,
                  'step_ms_mean': float(np.mean(timed)),
                  'step_ms_p50': float(np.median(timed)),
                  'peak_mem_bytes': peak, 'profile': prof,
                  'loss_rel_err_vs_off': loss_err,
                  'update_max_abs_err_vs_off': upd_err,
                  'update_max_abs_off': scale, 'tol': TOL_REMAT_BF16,
                  'launches': path_counts,
                  'launches_per_step_predicted': expect, 'gpu': gpu_line})
            check(all(np.isfinite(v) for v in lg.values()),
                  f'{regime} {remat}: non-finite logs {lg}')
            check(path_counts == {k: 5 * v for k, v in expect.items()},
                  f'{regime} {remat}: 5 steps launched {path_counts}, not '
                  f'{expect} a step')
            check(max(loss_err.values()) <= TOL_REMAT_BF16,
                  f'{regime} {remat}: losses vs remat off {loss_err}')
            check(upd_err <= TOL_REMAT_BF16 * scale,
                  f'{regime} {remat}: updates vs remat off {upd_err} (max '
                  f'{scale})')
            total = path_counts if total is None else add_counts(
                total, path_counts)
        l0, d0 = first['off']
        la, da = first['off_again']
        emit({'phase': 'remat_train_bf16', 'regime': regime,
              'remat': 'off, a second run',
              'loss_rel_err_vs_off': {
                  k: abs(la[k] - l0[k]) / max(abs(l0[k]), 1e-6)
                  for k in l0 if 'loss' in k},
              'update_max_abs_err_vs_off': max(
                  (da[n] - d0[n]).abs().max().item() for n in d0)})
        total = add_counts(total, path_counts)
        del first, batch
        torch.cuda.empty_cache()
    return total


def unimatch_cli_config(root):
    """A UniMatch variant of ``setr_fixture_voc_mini_fullflag.py`` written
    to ``root``: it inherits the file by ``_base_`` and sets
    ``UniSemiDataset`` with three-branch unsup pipelines (the teacher's
    view as the file writes it, and two student views that add
    RandomGrayscale and GaussianBlur after its photometric distortion) and
    their ``_mix``-tagged copies as ``unsup_mix``, and the UniMatch flags."""
    import copy
    from s4former_tpu_torch.config import Config
    base = Config.fromfile(FULLFLAG).to_dict()
    unsup = base['data']['train']['unsup']
    branch_at = next(i for i, t in enumerate(unsup['pipeline'])
                     if t['type'] == 'MultiBranch')
    branches = unsup['pipeline'][branch_at]
    weak, strong = branches['unsup_teacher'], branches['unsup_student']
    at = next(i for i, t in enumerate(strong)
              if t['type'] == 'PhotoMetricDistortion') + 1
    strong = strong[:at] + [dict(type='RandomGrayscale', prob=0.2),
                            dict(type='GaussianBlur', prob=0.5)] + strong[at:]

    def tagged(steps, tag):
        steps = copy.deepcopy(steps)
        for t in steps:
            if t['type'] == 'ExtraAttrs':
                t['tag'] = tag
        return steps

    def pipeline(suffix):
        return unsup['pipeline'][:branch_at] + [dict(type='MultiBranch', **{
            'unsup_teacher' + suffix: tagged(weak, 'unsup_teacher' + suffix),
            'unsup_student' + suffix: tagged(strong,
                                             'unsup_student' + suffix),
            'unsup_student_2' + suffix: tagged(strong,
                                               'unsup_student_2' + suffix)})]
    mix = dict(unsup, pipeline=pipeline('_mix'))
    path = os.path.join(root, 'setr_fixture_voc_mini_unimatch.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{FULLFLAG!r}]\n'
                f'data = dict(train=dict(\n'
                f'    type="UniSemiDataset",\n'
                f'    unsup=dict(pipeline={pipeline("")!r}),\n'
                f'    unsup_mix={mix!r}))\n'
                f'model = dict(**{UNIMATCH_FLAGS!r})\n')
    return path


def phase_unimatch_train_cli(fa, gpu_line, root):
    """``tools.train`` on the UniMatch variant of the fixture config (bf16,
    DeiT-B, 4 + 4 a step and the mix stream through the loader): 3 steps,
    eval and checkpoint at 3, then ``--auto-resume`` to 6 (eval and
    checkpoint at 6); launches of each run against the UniMatch step's and
    the eval's; ``data_wait_ms``; ``tools.test`` on ``iter_6`` within
    TOL_MIOU of the in-loop mIoU. Returns the runs' counts summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    cfg_path = unimatch_cli_config(root)
    semi = SemiConfig.from_model_cfg(Config.fromfile(cfg_path).model)
    check(semi.unimatch and semi.use_PatchShuffle, 'UniMatch flags')
    per_step = predicted_launches(semi, 12)
    per_eval = 12 * 4                              # 16 val images, 4 a flush
    opts = ['--cfg-options', 'evaluation.interval=3',
            'checkpoint_config.interval=3', 'log_config.interval=3']
    wd = os.path.join(root, 'unimatch_work')
    want = {k: 3 * v for k, v in per_step.items()}
    want['flash_attn_fwd'] += per_eval
    runs, peaks = {}, {}
    for name, argv in (('train', ['--max-iters', '3']),
                       ('resume', ['--auto-resume', '--max-iters', '6'])):
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)                           # the main path starts
        t0 = time.perf_counter()
        state = train_cli.main([cfg_path, '--work-dir', wd] + argv + opts)
        torch.cuda.synchronize()
        runs[name] = (counts(fa), time.perf_counter() - t0)
        peaks[name] = torch.cuda.max_memory_allocated()
        check(int(state.step) == (3 if name == 'train' else 6),
              f'{name}: ended at step {int(state.step)}')
        del state
        torch.cuda.empty_cache()
        check(runs[name][0] == want, f'{name}: 3 steps + 1 eval launched '
              f'{runs[name][0]}, not {want}')
    resumed = f'resumed from {os.path.join(wd, "iter_3")}'
    check(resumed in read_logs(wd), f'no "{resumed}" in the log')
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [3, 6] and sorted(val) == [3, 6],
          f'logged steps {records}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(all({'unsup.loss_seg_unsup_1', 'unsup.loss_seg_unsup_2',
               'unsup.loss_seg_unsup_attn_mask'} <= set(r) for r in train),
          f'the UniMatch losses are not logged: {sorted(train[-1])}')
    reset_counts(fa)
    t0 = time.perf_counter()
    results = test_cli.main([cfg_path, os.path.join(wd, 'iter_6')])
    test_s = time.perf_counter() - t0
    test_counts = counts(fa)
    check(test_counts == dict({k: 0 for k in KERNELS},
                              flash_attn_fwd=per_eval),
          f'offline test launched {test_counts}')
    in_loop = val[6]['mIoU']
    gap = abs(results['mIoU'] - in_loop)
    emit({'phase': 'unimatch_train_cli',
          'config': os.path.basename(cfg_path),
          'base': os.path.basename(FULLFLAG),
          'batch': '4 + 4 at 512² (+ 4 of the mix stream, three views '
                   'each), bf16, 12 layers',
          'losses': {r['step']: r['loss'] for r in train},
          'mask_ratio': {r['step']: r['mask_ratio'] for r in train},
          'logs_iter_6': train[-1],
          'step_ms_windows': [r['step_ms'] for r in train],
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'eval_s': {s: r['eval_s'] for s, r in val.items()},
          'miou': {s: r['mIoU'] for s, r in val.items()},
          'run_s': {k: v[1] for k, v in runs.items()},
          'peak_mem_bytes': peaks,
          'launches': {'train': runs['train'][0],
                       'resume': runs['resume'][0], 'test': test_counts},
          'launches_per_step_predicted': per_step, 'resumed': resumed,
          'test_miou': results['mIoU'], 'in_loop_miou_iter_6': in_loop,
          'miou_gap': gap, 'tol': TOL_MIOU, 'test_run_s': test_s,
          'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{in_loop}: {gap} > {TOL_MIOU}')
    shutil.rmtree(wd, ignore_errors=True)
    return add_counts(add_counts(runs['train'][0], runs['resume'][0]),
                      test_counts)


def run_unimatch(fa, images, gpu_line, root):
    """The UniMatch slice's phases (and the ViT's remat); returns their
    launch counts by path and prints their seconds."""
    paths, seconds = {}, {}
    for name, run in (
            ('unimatch_f32', lambda: phase_unimatch_f32_vs_cpu(fa, images)),
            ('unimatch_train_bf16',
             lambda: phase_unimatch_train_bf16(fa, images, gpu_line)),
            ('remat_train_bf16',
             lambda: phase_remat_train_bf16(fa, images, gpu_line)),
            ('unimatch_train_cli',
             lambda: phase_unimatch_train_cli(fa, gpu_line, root))):
        t0 = time.perf_counter()
        paths[name] = run()
        seconds[name] = time.perf_counter() - t0
    emit({'phase': 'unimatch_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths


# ------------------------------------------------------- data parallelism
# 2-rank step vs the single-process step on the same global batch, f32 on
# the card: losses relative; parameter and EMA changes over the 3 steps
# relative to the single-process run's largest change (f32 sums split
# over the ranks and summed, and cuBLAS picking its algorithms for batches
# of 2 instead of 4), plus DP_ULPS f32 roundings of the largest value: the
# EMA moves ~1e-5 of a value in 3 steps, so one rounding of the stored
# value is already ~3e-3 of its change. BN running statistics relative to
# their largest value: each step makes them anew from f32 moments of the
# batch (E[x²] − mean² over ~10^6 values a channel), whose rounding scales
# with the moments, not with the statistics' change
TOL_DP_F32 = 1e-3
DP_ULPS = 2
DP_RANKS = 2


def dp_global_batches(images, n, steps):
    """``steps`` global batches of n + n fixture images at 512², the ignore
    label spread unevenly over two blocks: the first block's two sup
    labels lose a band of rows or columns to 255."""
    out = []
    for s in range(steps):
        names = [images[(s * 2 * n + i) % len(images)] for i in range(2 * n)]
        batch = train_batch(names, n, n)
        batch['sup_gt'][0, :160] = 255
        batch['sup_gt'][1, :, :96] = 255
        out.append(batch)
    return out


def save_batches(batches, directory):
    import numpy as np
    paths = []
    for i, batch in enumerate(batches):
        paths.append(os.path.join(directory, f'batch_{i}.npz'))
        np.savez(paths[-1], **batch)
    return paths


def load_batch(path, device):
    import numpy as np
    with np.load(path) as z:
        return to_device({k: z[k] for k in z.files}, device)


def state_tensors(state):
    """The state's tensors by name, as CPU copies: student and EMA state
    dicts (parameters and BN statistics) and the SGD buffers."""
    out = {f'model.{k}': v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    out.update({f'ema.{k}': v.detach().cpu().clone()
                for k, v in state.ema_model.state_dict().items()})
    out.update({f'momentum.{k}': v.detach().cpu().clone()
                for k, v in state.momentum.items()})
    return out


def identical_across_ranks(state):
    """Every tensor of the state bit for bit rank 0's, on every rank (of a
    split state, every tensor each rank holds whole)."""
    import torch
    import torch.distributed as dist
    split = set(state.plan.split_names()) if state.plan else set()
    tensors = [t for sd in (state.model.state_dict(),
                            state.ema_model.state_dict(), state.momentum)
               for n, t in sd.items() if n not in split]
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    bad = (flat.view(torch.int32) != ref.view(torch.int32)).sum().reshape(1)
    dist.all_reduce(bad)
    return int(bad) == 0


def whole_state_tensors(state):
    """``state_tensors`` of a (split) state, gathered whole: every rank
    joins the gather; None on all but rank 0."""
    from s4former_tpu_torch.core.checkpoint import host_state
    from s4former_tpu_torch.parallel.distributed import is_main
    payload = host_state(state, is_main())
    if payload is None:
        return None
    out = {}
    for prefix, key in (('model.', 'model'), ('ema.', 'ema_model'),
                        ('momentum.', 'momentum')):
        out.update({prefix + k: v for k, v in payload[key].items()})
    return out


def still_split(state, full_shapes):
    """Every split parameter (and its SGD buffer) still holds its piece,
    not the whole tensor."""
    if state.plan is None:
        return False
    params = dict(state.model.named_parameters())
    return all(tuple(params[n].shape) != full_shapes[n] and
               tuple(state.momentum[n].shape) == tuple(params[n].shape)
               for n in state.plan.split_names())


def dp_rank_step_f32(fa, spec, device):
    """One rank of dp_step_f32_vs_single (and, with the single process's
    teacher logits pinned, of dp_step_f32_pinned_teacher): the 4-layer f32
    step on this rank's block of each global batch. With SPEC's 'mp' > 1
    or 'zero3', the ranks form a (data, model) grid and the state is split
    (tp_step_f32_vs_single, zero3_step_f32_vs_single)."""
    import torch
    from s4former_tpu_torch.parallel.mesh import (make_mesh, replicate_state,
                                                  shard_batch)
    from s4former_tpu_torch.parallel.tp import shard_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, step, _ = make_trainer('ours', device, 'float32', 4,
                                  unsup_confidence=UNSUP_CONFIDENCE_F32)
    state = replicate_state(state)
    full_shapes = {n: tuple(p.shape)
                   for n, p in state.model.named_parameters()}
    make_mesh(spec.get('mp', 1))
    state = shard_state(state, zero3=spec.get('zero3', False))
    gen = torch.Generator(device=device).manual_seed(0)
    logs_by_step, same, teacher = [], [], []
    unhook = teacher_hook(
        reference=torch.load(spec['teacher'], weights_only=True),
        pin=spec['pin'], stats=teacher)
    reset_counts(fa)                               # the main path starts
    for path in spec['batches']:
        state, logs = step(state, shard_batch(load_batch(path, device)), gen)
        logs_by_step.append(floats(logs))
        same.append(identical_across_ranks(state))
    torch.cuda.synchronize()
    launches = counts(fa)                          # the main path ends
    unhook()
    tensors = whole_state_tensors(state)
    if tensors is not None:
        torch.save(tensors, spec['state_out'])
    return {'logs': logs_by_step, 'same': same, 'launches': launches,
            'teacher': teacher, 'split': still_split(state, full_shapes),
            'heads': sorted({s[3] for s in FWD_SEEN})}


def dp_rank_train_bf16(fa, spec, device):
    """One rank of dp_train_bf16: the flagship as written, this rank's
    4 + 4 of the global batch; 2 warm-up steps, 5 timed. The gradient
    all-reduce is timed inside each step (synchronised before and after,
    so it includes waiting for the other rank) and alone after a barrier
    on a bucket of the same size."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from s4former_tpu_torch.parallel import mesh
    from s4former_tpu_torch.semi import train_step as ts
    state, step, cfg = make_trainer('ours', device)
    check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
    state = mesh.replicate_state(state)
    batch = mesh.shard_batch(load_batch(spec['batches'][0], device))
    gen = torch.Generator(device=device).manual_seed(0)
    state, _, warm_ms = timed_steps(state, step, batch, gen, 2)
    reduce_ms = []

    def timed_reduce(grads, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mesh.all_reduce_grads(grads, *args)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    ts.all_reduce_grads = timed_reduce
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 5)
    launches = counts(fa)                          # the main path ends
    ts.all_reduce_grads = mesh.all_reduce_grads
    peak = torch.cuda.max_memory_allocated(device)
    same = identical_across_ranks(state)
    n = sum(p.numel() for p in state.model.parameters())
    bucket = torch.zeros(n, device=device)
    dist.barrier()
    alone = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(bucket)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    ms_arr = np.asarray(ms)
    return {'warmup_step_ms': warm_ms, 'step_ms': ms,
            'step_ms_mean': float(ms_arr.mean()),
            'step_ms_p50': float(np.median(ms_arr)),
            'allreduce_ms_in_step': reduce_ms,
            'allreduce_ms_alone': alone, 'bucket_bytes': 4 * n,
            'peak_mem_bytes': peak, 'launches': launches,
            'logs': floats(logs), 'same': same}


def dp_rank_cli(fa, spec, device):
    """One rank of dp_train_cli: ``tools.train`` as ``-m`` would run it."""
    import torch
    from s4former_tpu_torch.tools import train as train_cli
    reset_counts(fa)                               # the main path starts
    state = train_cli.main(spec['argv'])
    torch.cuda.synchronize()
    return {'launches': counts(fa), 'step': int(state.step),
            'peak_mem_bytes': torch.cuda.max_memory_allocated()}


def dp_rank_test(fa, spec, device):
    """One rank of test_cli_ranks: ``tools.test`` as ``-m`` would run it."""
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    reset_counts(fa)                               # the main path starts
    metrics = test_cli.main(spec['argv'])
    torch.cuda.synchronize()
    return {'launches': counts(fa), 'metrics': metrics}


def tp_rank_train_bf16(fa, spec, device):
    """One rank of tp_train_bf16: the flagship as written on SPEC's grid
    (model axis 'mp', 'zero3'), its data index's block of one global
    batch; 2 warm-up steps, 3 timed, one under the profiler. Reports what
    a rank holds: its parameters' floats (the EMA and the SGD buffers hold
    as many) against the whole model's."""
    import numpy as np
    import torch
    from s4former_tpu_torch.parallel import mesh
    from s4former_tpu_torch.parallel.tp import shard_state
    state, step, cfg = make_trainer('ours', device)
    check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
    state = mesh.replicate_state(state)
    whole = sum(p.numel() for p in state.model.parameters())
    full_shapes = {n: tuple(p.shape)
                   for n, p in state.model.named_parameters()}
    mesh.make_mesh(spec['mp'])
    state = shard_state(state, zero3=spec['zero3'])
    torch.cuda.empty_cache()
    held = sum(p.numel() for p in state.model.parameters())
    batch = mesh.shard_batch(load_batch(spec['batches'][0], device))
    gen = torch.Generator(device=device).manual_seed(0)
    state, _, warm_ms = timed_steps(state, step, batch, gen, 2)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 3)
    launches = counts(fa)                          # the main path ends
    peak = torch.cuda.max_memory_allocated(device)
    (state, _), prof = device_profile(lambda: step(state, batch, gen), 8)
    ms_arr = np.asarray(ms)
    return {'warmup_step_ms': warm_ms, 'step_ms': ms,
            'step_ms_mean': float(ms_arr.mean()),
            'device_ms': prof['device_us'] / 1e3,
            'device_busy_share': prof['device_busy_share'],
            'top_kernels': prof['top'], 'peak_mem_bytes': peak,
            'launches': launches, 'heads': sorted({s[3] for s in FWD_SEEN}),
            'param_floats': held, 'param_floats_whole': whole,
            'state_floats': 3 * held, 'split': still_split(state,
                                                           full_shapes),
            'same': identical_across_ranks(state), 'logs': floats(logs)}


DP_RANK_PHASES = {'step_f32': dp_rank_step_f32,
                  'tp_train_bf16': tp_rank_train_bf16,
                  'train_bf16': dp_rank_train_bf16, 'cli': dp_rank_cli,
                  'test': dp_rank_test}


def dp_worker(kind, spec_path):
    """One rank of a data-parallel phase, started by ``python -m
    torch.distributed.run ... chip_smoke.py --dp-worker KIND SPEC``. The
    step phases join the group of SPEC's 'backend' and 'device' (gloo with
    every rank on cuda:0, since NCCL takes one card per rank; or NCCL, one
    rank a card); the CLIs set up their own group. Writes its result to
    SPEC's 'out' + '.rank{RANK}.json'."""
    import torch
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    from s4former_tpu_torch.ops import flash_attention as fa
    from s4former_tpu_torch.parallel.distributed import init_distributed
    fa.load_library()                              # built by the parent
    fa.load_bwd_library()
    record_fwd_shapes(fa)
    device = None
    if kind not in ('cli', 'test'):
        device = init_distributed('env', backend=spec['backend'],
                                  device=spec['device'])
    try:
        result = DP_RANK_PHASES[kind](fa, spec, device)
    finally:
        if device is not None:
            torch.distributed.destroy_process_group()
    result['fwd_shapes'] = sorted(FWD_SEEN, key=str)
    with open(f"{spec['out']}.rank{os.environ['RANK']}.json", 'w') as f:
        json.dump(result, f)
    return 0


def run_ranks(kind, spec, n, directory, timeout):
    """``n`` ranks of ``kind`` under torch.distributed.run; returns their
    results, rank 0 first."""
    spec = dict(spec, out=os.path.join(directory, kind))
    spec_path = os.path.join(directory, f'{kind}.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           f'--nproc_per_node={n}', os.path.abspath(__file__),
           '--dp-worker', kind, spec_path]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-6000:], file=sys.stderr)
        print(proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f'{n} ranks of {kind} exited with '
          f'{proc.returncode}')
    results = []
    for r in range(n):
        with open(f"{spec['out']}.rank{r}.json") as f:
            results.append(json.load(f))
        FWD_SEEN.update(tuple(x) for x in results[-1]['fwd_shapes'])
    return results, proc.stdout


def sum_counts(results):
    out = {k: 0 for k in KERNELS}
    for r in results:
        out = add_counts(out, r['launches'])
    return out


def teacher_hook(record=None, reference=None, pin=False, stats=None):
    """Wrap ``semi.train_step.extract_teacher_info``, from whose teacher
    logits a step makes all of its pseudo-labels, confidence mask, PASA
    bias and NCR targets. ``record`` (a list) gets each call's logits on
    the CPU. With ``reference`` (the single process's logits, one a call),
    each call appends to ``stats`` how many of this rank's hard labels
    (255 where unconfident) differ from those of the single process's rows,
    and the largest logit difference; with ``pin`` those rows then take the
    place of the rank's own logits. Returns a function that unwraps it."""
    from s4former_tpu_torch.parallel.mesh import local_rows
    from s4former_tpu_torch.semi import train_step as ts
    original = ts.extract_teacher_info
    calls = iter(reference or ())

    def hooked(logits, *args):
        if record is not None:
            record.append(logits.float().cpu())
        if reference is not None:
            theirs = local_rows(next(calls)).to(logits.device)
            own = original(logits, *args).hard_label
            stats.append({
                'hard_labels_differ': int(
                    (own != original(theirs, *args).hard_label).sum()),
                'pixels': own.numel(),
                'logits_max_abs_err': (logits.float() -
                                       theirs).abs().max().item()})
            if pin:
                logits = theirs.to(logits.dtype)
        return original(logits, *args)
    ts.extract_teacher_info = hooked
    return lambda: setattr(ts, 'extract_teacher_info', original)


def teacher_margins(steps, threshold):
    """A step each, over the single process's teacher logits: the range of
    the max softmax probability, its least distance from ``threshold``,
    the least gap between the two largest probabilities and the pixels
    whose gap is under 1e-6 (near-ties that another sum order can turn
    into another hard label)."""
    import torch
    out = []
    for logits in steps:
        top = torch.softmax(logits, -1).topk(2, -1).values
        gap = top[..., 0] - top[..., 1]
        out.append({'max_prob': [top[..., 0].min().item(),
                                 top[..., 0].max().item()],
                    'nearest_to_threshold': (top[..., 0] - threshold)
                    .abs().min().item(),
                    'least_top2_gap': gap.min().item(),
                    'top2_gap_under_1e-6': int((gap < 1e-6).sum())})
    return out


def single_step_f32(fa, batches, **hook):
    """The 4-layer f32 ``..._MT_w_ours.py`` step in this process from a
    fresh seeded trainer, one step a global batch of ``batches``, its
    teacher wrapped by ``teacher_hook(**hook)``. Returns the state's
    tensors before and after, the logs, the launches and the seconds."""
    import torch
    state, step, _ = make_trainer('ours', 'cuda', 'float32', 4,
                                  unsup_confidence=UNSUP_CONFIDENCE_F32)
    before = state_tensors(state)
    gen = torch.Generator(device='cuda').manual_seed(0)
    logs = []
    unhook = teacher_hook(**hook)
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        for path in batches:
            state, out = step(state, load_batch(path, 'cuda'), gen)
            logs.append(floats(out))
        torch.cuda.synchronize()
    finally:
        unhook()
    seconds = time.perf_counter() - t0
    launches = counts(fa)
    after = state_tensors(state)
    del state, step
    torch.cuda.empty_cache()
    return before, after, logs, launches, seconds


def dp_errors(other, other_logs, single, single_logs, before):
    """``other`` (a state's tensors and logs) against the single run:
    each loss's relative error a step, and per group (model, EMA, SGD
    buffers) and kind (parameters, BN statistics) the largest abs error
    with the single run's largest change and value and the limit of
    TOL_DP_F32 (BN statistics against the larger of their change and
    value) plus DP_ULPS f32 roundings of the largest value."""
    import numpy as np
    loss_err = [{k: abs(r[k] - s[k]) / max(abs(s[k]), 1e-6) for k in s}
                for r, s in zip(other_logs, single_logs)]
    errs = {}
    for group in ('model.', 'ema.', 'momentum.'):
        for kind, keep in (('params', lambda n: 'running_' not in n),
                           ('bn_stats', lambda n: 'running_' in n)):
            names = [n for n in single if n.startswith(group) and keep(n)]
            if not names:
                continue
            change = max((single[n] - before[n]).abs().max().item()
                         for n in names)
            top = max(single[n].abs().max().item() for n in names)
            err = max((other[n] - single[n]).abs().max().item()
                      for n in names)
            scale = max(change, top) if kind == 'bn_stats' else change
            errs[group + kind] = {
                'max_abs_err': err, 'max_abs_change_single': change,
                'max_abs_single': top, 'err_over_change': err / change,
                'limit': TOL_DP_F32 * scale +
                DP_ULPS * float(np.finfo(np.float32).eps) * top}
    return loss_err, errs


def phase_dp_step_f32(fa, images, gpu_line, root):
    """Two ranks on cuda:0 (gloo) against one process: the 4-layer f32
    ``..._MT_w_ours.py`` step at full width, 3 steps on global batches of
    4 + 4 at 512² (2 + 2 a rank), threshold UNSUP_CONFIDENCE_F32, the
    ignore label uneven over the blocks, the mixes drawn from one seeded
    generator. Losses, the changes of parameters and EMA, and the BN
    statistics within TOL_DP_F32; the ranks' states bit-identical after
    every step; 12 forward + 8 fused launches a step on each rank, as on
    one. The SGD buffers' error is printed, not held. Prints, a step, the
    single process's teacher margins and how many of each rank's hard
    pseudo-labels differ from the single process's; and, as the floor of
    these errors, one process run again on the same inputs against
    itself (the fused backward adds dq atomically, in a run-dependent
    order).

    Then the ranks again with each rank's teacher logits replaced by the
    single process's rows (``dp_step_f32_pinned_teacher``, ROADMAP Queue 3
    item 1): every pseudo-label, confidence mask, PASA bias and NCR target
    is then the single process's, and the error left comes from the
    student's side. Held to the same limits.

    Then the sharded steps against the same single process, at the same
    limits, with the rerun floor beside them: ``tp_step_f32_vs_single``,
    2 ranks on cuda:0 over gloo as data 1 x model 2 (tensor parallelism:
    each rank attends over 6 heads and holds its pieces of the split
    weights, EMA and SGD buffers), and ``zero3_step_f32_vs_single``, 4 ranks
    as data 2 x model 2 with ZeRO-3 (NCCL, one rank a card, with 4 cards;
    else gloo on cuda:0). Each rank launches what one process does, its
    state is still split after step 3, and the tensors it holds whole are
    bit-identical across the ranks. Returns the launches of each
    grid's ranks summed, by path: dp_step_f32 (both data-parallel runs),
    tp_step_f32 and zero3_step_f32."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = save_batches(dp_global_batches(images, 4, 3), root)
    teacher, teacher_again = [], []
    before, single, single_logs, single_counts, single_s = single_step_f32(
        fa, batches, record=teacher)
    check(len(teacher) == len(batches), f'{len(teacher)} teacher calls in '
          f'{len(batches)} steps')
    _, again, again_logs, _, _ = single_step_f32(
        fa, batches, reference=teacher, stats=teacher_again)
    again_loss, again_errs = dp_errors(again, again_logs, single,
                                       single_logs, before)
    rerun = {'teacher_vs_first': teacher_again,
             'loss_rel_err': [max(e.values()) for e in again_loss],
             'err_over_change': {k: e['err_over_change']
                                 for k, e in again_errs.items()}}
    teacher_out = os.path.join(root, 'dp_teacher.pt')
    torch.save(teacher, teacher_out)
    margins = teacher_margins(teacher, UNSUP_CONFIDENCE_F32)
    del teacher
    check(all(s['mask_ratio'] > 0 and s['unsup.loss_seg_unsup'] > 0 and
              s['unsup.loss_ncr_unsup'] > 0 for s in single_logs),
          'the unsup losses are not live')
    launches = {}
    # (phase, teacher pinned, ranks, model axis, ZeRO-3, backend, device):
    # gloo puts every rank on cuda:0; NCCL one rank a card
    nccl4 = torch.cuda.device_count() >= 4
    grids = [('dp_step_f32_vs_single', False, DP_RANKS, 1, False, 'gloo',
              'cuda:0'),
             ('dp_step_f32_pinned_teacher', True, DP_RANKS, 1, False,
              'gloo', 'cuda:0'),
             ('tp_step_f32_vs_single', False, 2, 2, False, 'gloo',
              'cuda:0'),
             ('zero3_step_f32_vs_single', False, 4, 2, True,
              'nccl' if nccl4 else 'gloo', 'cuda' if nccl4 else 'cuda:0')]
    for phase, pin, n_ranks, mp, zero3, backend, device in grids:
        state_out = os.path.join(root, f'{phase}.pt')
        t0 = time.perf_counter()
        ranks, _ = run_ranks('step_f32', {
            'batches': batches, 'state_out': state_out,
            'teacher': teacher_out, 'pin': pin, 'backend': backend,
            'device': device, 'mp': mp, 'zero3': zero3}, n_ranks, root, 600)
        ranks_s = time.perf_counter() - t0
        loss_err, errs = dp_errors(torch.load(state_out, weights_only=True),
                                   ranks[0]['logs'], single, single_logs,
                                   before)
        emit({'phase': phase, 'config': 'ours',
              'ranks': n_ranks, 'grid': f'data {n_ranks // mp} x model '
                                        f'{mp}, zero3 {zero3}',
              'backend': f'{backend}, ' + ('every rank on cuda:0'
                                           if device == 'cuda:0' else
                                           'one rank a card'),
              'heads_per_rank': ranks[0]['heads'],
              'split_after_last_step': [r['split'] for r in ranks],
              'cut': 'num_layers 12 -> 4, out_indices (0, 1, 2, 3)',
              'batch': f'3 steps of 4 + 4 at 512² global, '
                       f'{4 * mp // n_ranks} + {4 * mp // n_ranks} a data '
                       f'index, unsup_confidence {UNSUP_CONFIDENCE_F32}',
              'teacher_pinned': pin, 'teacher_margins_single': margins,
              'teacher_vs_single_by_rank': [r['teacher'] for r in ranks],
              'single_vs_itself': rerun,
              'losses_dp': ranks[0]['logs'], 'losses_single': single_logs,
              'loss_rel_err': loss_err, 'state_err': errs,
              'ranks_identical_each_step': [r['same'] for r in ranks],
              'launches_per_rank': [r['launches'] for r in ranks],
              'launches_single': single_counts, 'tol': TOL_DP_F32,
              'single_s': single_s, 'ranks_s': ranks_s, 'gpu': gpu_line})
        for r in ranks:
            check(r['same'] == [True] * 3, f'ranks differ: {r["same"]}')
            check(r['split'] == (mp > 1 or zero3), f'{phase}: split after '
                  f'step 3: {r["split"]}')
            check(r['heads'] == [12 // mp], f'{phase}: a rank attended '
                  f'over {r["heads"]} heads')
            check(r['launches'] == {'flash_attn_fwd': 36,
                                    'flash_attn_bwd_fused': 24,
                                    'flash_attn_bwd_dkv': 0,
                                    'flash_attn_bwd_dq': 0},
                  f'a rank launched {r["launches"]} in 3 steps')
            check(len(r['teacher']) == len(batches), f'{phase}: '
                  f'{len(r["teacher"])} teacher calls')
        check(single_counts == ranks[0]['launches'], 'single-process '
              f'launches {single_counts}')
        check(all(np.isfinite(v) for r in ranks[0]['logs']
                  for v in r.values()), 'non-finite losses')
        check(max(max(e.values()) for e in loss_err) <= TOL_DP_F32,
              f'{phase}: 2-rank losses vs one process: {loss_err}')
        for name, e in errs.items():
            check(name.startswith('momentum.') or
                  e['max_abs_err'] <= e['limit'],
                  f'{phase}: {name}: 2 ranks vs one process {e}')
        path = phase.split('_vs_')[0].replace('_pinned_teacher', '')
        launches[path] = add_counts(launches.get(path, {n: 0 for n in
                                                        KERNELS}),
                                    sum_counts(ranks))
    return launches


def phase_dp_train_bf16(fa, images, gpu_line, root, n, on_one_card):
    """The flagship as written (bf16, 12 layers), 4 + 4 a rank (the
    paper's per-GPU batch) on ``n`` ranks: all on cuda:0 over gloo
    (``on_one_card``), else one a card over NCCL. Step time, the gradient
    all-reduce's time, peak memory and launches of each rank (those of the
    single-process 4 + 4 step: 36 forward and 24 fused a step). Returns
    the ranks' launches summed."""
    import numpy as np
    batches = save_batches(dp_global_batches(images, 4 * n, 1), root)
    spec = {'batches': batches, 'backend': 'gloo' if on_one_card else None,
            'device': 'cuda:0' if on_one_card else 'cuda'}
    t0 = time.perf_counter()
    ranks, _ = run_ranks('train_bf16', spec, n, root, 600)
    step_s = float(np.mean([r['step_ms_mean'] for r in ranks])) / 1e3
    emit({'phase': 'dp_train_bf16' if on_one_card else
          'dp_train_bf16_cards',
          'config': 'ours', 'ranks': n,
          'backend': 'gloo, every rank on cuda:0' if on_one_card else
          'nccl, one rank a card',
          'batch': f'4 + 4 a rank at 512² ({4 * n} + {4 * n} global), '
                   f'bf16, 12 layers',
          'img_per_s_global': 8 * n / step_s,
          'per_rank': [{k: v for k, v in r.items() if k != 'logs'}
                       for r in ranks],
          'logs_rank0': ranks[0]['logs'], 'run_s': time.perf_counter() - t0,
          'gpu': gpu_line})
    for r in ranks:
        check(r['same'], 'the ranks\' states differ')
        check(r['launches'] == {'flash_attn_fwd': 36 * 5,
                                'flash_attn_bwd_fused': 24 * 5,
                                'flash_attn_bwd_dkv': 0,
                                'flash_attn_bwd_dq': 0},
              f'a rank launched {r["launches"]} in 5 steps, not 36 forward '
              f'and 24 fused a step')
        check(all(np.isfinite(v) for v in ranks[0]['logs'].values()),
              f'non-finite logs {ranks[0]["logs"]}')
    return sum_counts(ranks)


def phase_dp_train_cli(fa, gpu_line, root):
    """``torch.distributed.run --nproc_per_node K`` of ``tools.train
    --launcher env`` (NCCL, one card a rank; K = min(2, cards)) on
    ``setr_fixture_voc_mini_fullflag.py`` as written, 4 + 4 a rank: 6
    steps with eval and a checkpoint at 6, then ``--auto-resume`` to 8;
    rank 0 alone writes logs, metrics and checkpoints; then ``tools.test``
    (one process) on ``iter_6``, whose mIoU must be the in-loop one's.
    Returns the launches of every rank and run, and the test's, summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    k = min(DP_RANKS, torch.cuda.device_count())
    wd = os.path.join(root, 'dp_work')
    opts = ['--cfg-options', 'evaluation.interval=6',
            'checkpoint_config.interval=6', 'log_config.interval=2']
    n_val, flush = 16, 4
    per_eval = 12 * -(-n_val // flush)
    runs = {}
    for name, argv, steps in (
            ('train', ['--max-iters', '6'], 6),
            ('resume', ['--auto-resume', '--max-iters', '8'], 2)):
        t0 = time.perf_counter()
        ranks, _ = run_ranks('cli', {'argv': [FULLFLAG, '--work-dir', wd,
                                              '--launcher', 'env'] + argv +
                                     opts}, k, root, 600)
        runs[name] = (ranks, time.perf_counter() - t0)
        want_step = 6 if name == 'train' else 8
        check(all(r['step'] == want_step for r in ranks),
              f'{name}: ranks ended at {[r["step"] for r in ranks]}')
        total = sum_counts(ranks)
        want = {'flash_attn_fwd': 36 * steps * k +
                (per_eval if name == 'train' else 0),
                'flash_attn_bwd_fused': 24 * steps * k,
                'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
        check(total == want, f'{name}: {k} ranks launched {total}, not '
              f'{want}')
    logs = sorted(n for n in os.listdir(wd) if n.endswith('.log'))
    check(len(logs) == 2, f'log files {logs}: one a run, rank 0 only')
    text = read_logs(wd)
    resumed = f'resumed from {os.path.join(wd, "iter_6")} (iter 6)'
    check(resumed in text, f'no "{resumed}" in the log')
    if k > 1:
        check(f'{k} ranks (env)' in text, f'the log names no {k} ranks')
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [2, 4, 6, 8] and sorted(val) == [6],
          f'logged steps {[(r["prefix"], r["step"]) for r in records]}')
    check(sorted(n for n in os.listdir(wd) if n.startswith('iter_')) ==
          ['iter_6', 'iter_8'], f'checkpoints {os.listdir(wd)}')
    panels = check_eval_panels(wd, (6,))
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    reset_counts(fa)
    results = test_cli.main([FULLFLAG, os.path.join(wd, 'iter_6')])
    test_counts = counts(fa)
    check(test_counts == dict({n: 0 for n in KERNELS},
                              flash_attn_fwd=per_eval),
          f'offline test launched {test_counts}')
    in_loop = val[6]['mIoU']
    gap = abs(results['mIoU'] - in_loop)
    emit({'phase': 'dp_train_cli', 'config': os.path.basename(FULLFLAG),
          'ranks': k, 'cards': torch.cuda.device_count(), 'backend': 'nccl',
          'batch': f'4 + 4 a rank at 512² ({4 * k} + {4 * k} global), '
                   f'bf16, 12 layers',
          'losses': {r['step']: r['loss'] for r in train},
          'step_ms_windows': [r['step_ms'] for r in train],
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'eval_s': val[6]['eval_s'], 'in_loop_miou_iter_6': in_loop,
          'test_miou': results['mIoU'], 'miou_gap': gap,
          'miou_equal': results['mIoU'] == in_loop, 'tol': TOL_MIOU,
          'run_s': {n: v[1] for n, v in runs.items()},
          'launches_per_rank': {n: [r['launches'] for r in v[0]]
                                for n, v in runs.items()},
          'peak_mem_bytes_per_rank': {n: [r['peak_mem_bytes'] for r in v[0]]
                                      for n, v in runs.items()},
          'launches_test': test_counts, 'resumed': resumed,
          'eval_panels': panels, 'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{in_loop}: {gap} > {TOL_MIOU}')
    shutil.rmtree(wd, ignore_errors=True)
    out = test_counts
    for ranks, _ in runs.values():
        out = add_counts(out, sum_counts(ranks))
    return out


def one_process_4x4(fa, images):
    """The one-process flagship step at 4 + 4 (what tp_train_bf16's grids
    split): 2 warm-up steps, 3 timed, one profiled; its peak memory and
    parameter floats."""
    import numpy as np
    import torch
    state, step, _ = make_trainer('ours', 'cuda')
    batch = to_device(train_batch(images, 4, 4), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    state, _, _ = timed_steps(state, step, batch, gen, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    state, logs, ms = timed_steps(state, step, batch, gen, 3)
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    (state, _), prof = device_profile(lambda: step(state, batch, gen), 8)
    held = sum(p.numel() for p in state.model.parameters())
    del state, step, batch
    torch.cuda.empty_cache()
    return {'step_ms': ms, 'step_ms_mean': float(np.mean(ms)),
            'device_ms': prof['device_us'] / 1e3,
            'device_busy_share': prof['device_busy_share'],
            'peak_mem_bytes': peak, 'launches': launches, 'heads': [12],
            'param_floats': held, 'state_floats': 3 * held,
            'logs': floats(logs)}, launches


def phase_tp_train_bf16(fa, images, gpu_line, root):
    """The flagship as written (bf16, DeiT-B, 12 layers) at 512² on one
    global batch of 4 + 4, split three ways in one call: one process; 2
    ranks as data 1 x model 2 (each attends over 6 heads); 4 ranks as data
    2 x model 2 with ZeRO-3 (2 + 2 a data index). Step ms, device ms and
    busy share, peak memory, launches and heads a rank, and the floats a
    rank's state holds. Over gloo on one card this shows equality, memory
    and launches, not speed: each block's two activation all-reduces make
    a host round trip there. Each rank must launch one process's 36
    forward and 24 fused backward a step, at 12/mp heads. Returns the
    ranks' launches summed."""
    import torch
    single, single_counts = one_process_4x4(fa, images)
    batches = save_batches(dp_global_batches(images, 4, 1), root)
    nccl = torch.cuda.device_count() >= 4
    per_step = {'flash_attn_fwd': 36, 'flash_attn_bwd_fused': 24,
                'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
    grids, total = {}, {n: 0 for n in KERNELS}
    for name, n, mp, zero3 in (('tp_1x2', 2, 2, False),
                               ('tp_zero3_2x2', 4, 2, True)):
        backend, device = ('nccl', 'cuda') if nccl and n <= 4 else \
            ('gloo', 'cuda:0')
        t0 = time.perf_counter()
        ranks, _ = run_ranks('tp_train_bf16', {
            'batches': batches, 'mp': mp, 'zero3': zero3,
            'backend': backend, 'device': device}, n, os.path.join(
                root), 600)
        grids[name] = {'ranks': n, 'grid': f'data {n // mp} x model {mp}',
                       'zero3': zero3, 'backend': backend,
                       'run_s': time.perf_counter() - t0,
                       'per_rank': [{k: v for k, v in r.items()
                                     if k != 'logs'} for r in ranks],
                       'logs_rank0': ranks[0]['logs']}
        for r in ranks:
            check(r['launches'] == {k: 3 * v for k, v in per_step.items()},
                  f'{name}: a rank launched {r["launches"]} in 3 steps')
            check(r['heads'] == [12 // mp], f'{name}: heads {r["heads"]}')
            check(r['split'] and r['same'], f'{name}: split {r["split"]}, '
                  f'whole tensors identical {r["same"]}')
            check(all(v == v for v in r['logs'].values()), f'{name}: NaN '
                  f'logs {r["logs"]}')
        total = add_counts(total, sum_counts(ranks))
    emit({'phase': 'tp_train_bf16', 'config': 'ours',
          'batch': '4 + 4 at 512² global, bf16, 12 layers',
          'one_process': single, 'grids': grids,
          'note': 'gloo on one card: activation all-reduces go through '
                  'the host; equality, memory and launches, not speed',
          'gpu': gpu_line})
    check(single_counts == {k: 3 * v for k, v in per_step.items()},
          f'one process launched {single_counts}')
    return add_counts(total, single_counts)


def phase_tp_train_cli(fa, gpu_line, root):
    """``torch.distributed.run --nproc_per_node 4`` of ``tools.train
    --launcher env --model-parallel 2 --zero3`` (data 2 x model 2; NCCL one
    rank a card with 4 cards, else gloo with every rank on cuda:0) on
    ``setr_fixture_voc_mini_fullflag.py``, 1 + 1 a rank (the global 4 + 4
    of one process, 2 + 2 a data index): 3 steps with eval and a checkpoint
    at 3, then ``--auto-resume`` to 4; the checkpoint has train_cli's
    names, shapes and dtypes; ``tools.test`` (one process) on ``iter_3``
    gives the in-loop mIoU within TOL_MIOU. Under ZeRO-3 every rank runs
    every eval forward. Returns the launches of every rank and run, and
    the test's, summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    n, nccl = 4, torch.cuda.device_count() >= 4
    grid = ['--model-parallel', '2', '--zero3'] + (
        [] if nccl else ['--backend', 'gloo', '--device', 'cuda:0'])
    wd = os.path.join(root, 'tp_work')
    opts = ['--cfg-options', 'evaluation.interval=3',
            'checkpoint_config.interval=3', 'log_config.interval=1',
            'samples_per_gpu_sup=1', 'samples_per_gpu_unsup=1']
    per_eval = 12 * -(-16 // 4)
    runs = {}
    for name, argv, steps, evals in (
            ('train', ['--max-iters', '3'], 3, 1),
            ('resume', ['--auto-resume', '--max-iters', '4'], 1, 0)):
        t0 = time.perf_counter()
        ranks, _ = run_ranks('cli', {'argv': [FULLFLAG, '--work-dir', wd,
                                              '--launcher', 'env'] + grid +
                                     argv + opts}, n, root, 900)
        runs[name] = (ranks, time.perf_counter() - t0)
        for r in ranks:
            want = {'flash_attn_fwd': 36 * steps + per_eval * evals,
                    'flash_attn_bwd_fused': 24 * steps,
                    'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
            check(r['launches'] == want, f'tp_train_cli {name}: a rank '
                  f'launched {r["launches"]}, not {want}')
    text = read_logs(wd)
    for line in ('4 ranks (env), 2 data x 2 model',
                 'sharded state: model axis = 2 (Megatron), zero3 = True',
                 f'resumed from {os.path.join(wd, "iter_3")} (iter 3)'):
        check(line in text, f'tp_train_cli: no "{line}" in the log')
    layout = checkpoint_layout(os.path.join(wd, 'iter_3'))
    check(layout == CHECKPOINT_LAYOUT, 'the sharded checkpoint differs from '
          'train_cli\'s in names, shapes or dtypes')
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    losses = {r['step']: r['loss'] for r in records
              if r['prefix'] == 'train'}
    check(sorted(val) == [3] and all(np.isfinite(v) for v in
                                     losses.values()),
          f'tp_train_cli records {records}')
    reset_counts(fa)
    results = test_cli.main([FULLFLAG, os.path.join(wd, 'iter_3')])
    test_counts = counts(fa)
    gap = abs(results['mIoU'] - val[3]['mIoU'])
    emit({'phase': 'tp_train_cli', 'config': os.path.basename(FULLFLAG),
          'ranks': n, 'grid': 'data 2 x model 2, zero3',
          'backend': 'nccl, one rank a card' if nccl else
          'gloo, every rank on cuda:0',
          'batch': '1 + 1 a rank, 4 + 4 global at 512², bf16, 12 layers',
          'losses': losses, 'in_loop_miou_iter_3': val[3]['mIoU'],
          'eval_s': val[3]['eval_s'], 'test_miou': results['mIoU'],
          'miou_gap': gap, 'tol': TOL_MIOU,
          'checkpoint_equals_train_cli': True,
          'run_s': {k: v[1] for k, v in runs.items()},
          'launches_per_rank': {k: [r['launches'] for r in v[0]]
                                for k, v in runs.items()},
          'peak_mem_bytes_per_rank': {k: [r['peak_mem_bytes'] for r in v[0]]
                                      for k, v in runs.items()},
          'launches_test': test_counts, 'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'tp_train_cli: offline mIoU {results["mIoU"]} '
          f'vs in-loop {val[3]["mIoU"]}')
    shutil.rmtree(wd, ignore_errors=True)
    out = test_counts
    for ranks, _ in runs.values():
        out = add_counts(out, sum_counts(ranks))
    return out


def run_dp(fa, images, gpu_line, root):
    """The data-parallel slice's phases; returns their launch counts by
    path and prints their seconds."""
    import torch
    paths, seconds = {}, {}
    for name, run in (
            ('dp_step_f32', lambda: phase_dp_step_f32(fa, images, gpu_line,
                                                      root)),
            ('tp_train_bf16', lambda: phase_tp_train_bf16(
                fa, images, gpu_line, root)),
            ('tp_train_cli', lambda: phase_tp_train_cli(fa, gpu_line,
                                                        root)),
            ('dp_train_bf16', lambda: phase_dp_train_bf16(
                fa, images, gpu_line, root, DP_RANKS, on_one_card=True)),
            ('dp_train_cli', lambda: phase_dp_train_cli(fa, gpu_line,
                                                        root))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result = run()
        seconds[name] = time.perf_counter() - t0
        if name == 'dp_step_f32':      # by path, the sharded grids too
            paths.update(result)
        else:
            paths[name] = result
    cards = torch.cuda.device_count()
    if cards > 1:
        # the multi-card path itself: one rank a card over NCCL
        t0 = time.perf_counter()
        paths['dp_train_bf16_cards'] = phase_dp_train_bf16(
            fa, images, gpu_line, root, min(4, cards), on_one_card=False)
        seconds['dp_train_bf16_cards'] = time.perf_counter() - t0
    else:
        emit({'phase': 'dp_train_bf16_cards', 'skipped': f'{cards} card'})
    emit({'phase': 'dp_seconds', **seconds, 'total': sum(seconds.values())})
    return paths


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
    if sys.argv[1:2] == ['--dp-worker']:
        return dp_worker(*sys.argv[2:4])
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
    record_fwd_shapes(fa)
    phase_build(libs, time.perf_counter() - t0)

    images = sorted(glob.glob(IMAGES))
    check(len(images) == 16, f'expected 16 fixture images, found '
          f'{len(images)}')
    phase_native(images, native_lib, gpu_line)
    tta_ls, eval_ls = tta_lengths(images), eval_lengths()
    entries = {'flash_attn_fwd': phase_kernels(fa, tta_ls, eval_ls)}
    bwd_entries, fwd_err_train, fwd_train_cases = phase_kernels_bwd(fa)
    entries.update(bwd_entries)
    fwd = entries['flash_attn_fwd']     # the training shapes' forward too
    fwd['max_abs_err'] = max(fwd['max_abs_err'], fwd_err_train)
    fwd['cases'] += fwd_train_cases
    phase_kernels_tp(fa, entries)       # at a tensor-parallel rank's heads
    fwd['tta_lengths'], fwd['eval_lengths'] = tta_ls, eval_ls
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
        # the eval-and-tools slice on the same checkpoints
        paths.update(run_eval_tools(fa, gpu_line, wd, root, images))
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
        # the datasets slice: the flagship on ADE20K (150 classes), a
        # concat test set, and the Cityscapes metric on the tree above
        t0 = time.perf_counter()
        paths['ade_train_cli'] = phase_ade_train_cli(
            fa, gpu_line, root, deit['bare'], n_backbone)
        emit({'phase': 'ade_seconds', 'ade_train_cli':
              time.perf_counter() - t0})
        # the ablation slice: the rest of the step's flags
        paths.update(run_ablation(fa, images, gpu_line, root))
        # the UniMatch slice and the ViT's remat
        paths.update(run_unimatch(fa, images, gpu_line, root))
        # data parallelism: 2 ranks
        paths.update(run_dp(fa, images, gpu_line, root))

    # kernel #1 at each forward shape the paths launched
    phase_kernels_seen(fa, fwd)
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
