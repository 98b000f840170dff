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
  ``..._MT_w_ours.py`` from one batch (3 timed, 1 profiled), the CLI's
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
  in-loop mIoU; then two 9-step runs from the same backbone in the timm
  layout, on the native and then the plain host functions, the last 3
  steps of each traced (``--profile``) and read by
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
  at depth [1, 1, 2, 1] against the CPU, then in bf16 at full depth over 4
  PNGs (one request each, one profiled); one f32 step of
  ``..._MT_w_ours.py`` at depth [1, 1, 1, 1], 1 + 1 at 768², drop rates 0,
  against the CPU; the bf16 step at full depth and the config's 4 + 4,
  drop path and dropout live (the first, 2 timed, 1 profiled by operator
  class); ``tools.train`` on a seeded Cityscapes tree (4 steps, slide eval
  and checkpoints at 2 and 4), ``--auto-resume`` to 5, and ``tools.test``
  (``--eval mIoU`` against the in-loop mIoU, ``--format-only``);
- the datasets (``ade_train_cli``): ``..._MT_w_ours.py`` with
  ``ADE20KDataset`` and 150 classes on every head, on a seeded ADE20K tree
  (16 + 16 + 16 JPEGs at ADE's sizes, labels 0-150): ``tools.train`` 6
  steps of 4 + 4 from the seeded DeiT-B file, ``tools.test --show-dir``
  against the in-loop mIoU, a ``ConcatDataset`` of the val halves with
  separate and merged evaluation, and ``--eval cityscapes`` on the
  Cityscapes tree, which must raise the missing-package ImportError;
- the ViT model zoo (``mla_*``, ``segmenter_*``): SETR-MLA (ViT-L, 24
  layers of 16 heads over 1024 tokens, no cls token; the MLA neck, the
  SETR-MLA head and four FCN aux heads) and Segmenter (ViT-B and the
  mask-transformer head), each ``configs/_base_/models/``'s model in
  ``setr_fixture_voc_mini_fullflag.py`` (21 classes, bf16 backbone; MLA's
  PASA off, as no cls token can take its bias), seeded weights: serving
  one 512² request in f32 at 4 layers against the CPU, then at full depth
  in bf16 over the 16 fixture JPEGs; one f32 step at 4 layers against the
  CPU (threshold leaving half of the pixels confident); the bf16 step at
  full depth, 4 + 4 (the first, 3 timed), launches as the flags predict;
  ``tools.train`` on the MLA config, 4 steps of 2 + 2 with eval and a
  checkpoint holding ``neck.*``, and ``tools.test`` on it against the
  in-loop mIoU; kernels #1 and #2 are held at H = 16 in
  ``kernel_check``;
- the CNN slice (``cnn_*``; ``cnn_config`` puts each ResNet base of
  ``configs/_base_/models/`` into ``setr_fixture_voc_mini_fullflag.py``,
  21 classes, every S4Former flag, the mixes' ``patchsize`` 8; f32, TF32
  off, no kernel launched): DeepLabV3+ on ResNetV1c-50-D8 serving one
  512² request in f32 against the CPU, then the 16 fixture JPEGs; one f32
  step, 1 + 1, against the CPU (the CPU teacher's logits pinned) at
  ResNetV1c-18 and 512², and at ResNetV1c-50 and 256² against the
  witness of the CPU's own step on inputs moved by one ulp; the 4 + 4 step at full depth (the
  first, 3 timed, peak memory); PSPNet, FPN, CCNet and ICNet each serving
  one image and taking one 2 + 2 step; ``tools.train`` 2 steps of 2 + 2
  with eval and a checkpoint holding the ResNet's BN statistics, which
  loads the trained student bit for bit, and ``tools.test`` on it: the
  trained student's label maps bit for bit and the in-loop mIoU;
  DeepLabV3+ on ResNeXt-50 (32x4d) and on ResNeSt-50 one request each
  against the CPU;
- the Swin/HRNet slice (``upernet_swin_*``, ``ocrnet_*``; ``cnn_config``
  with ``upernet_swin.py``, ``patchsize`` 16, or ``ocrnet_hr18.py``, the
  cascade, ``patchsize`` 4; f32, TF32 off, no kernel launched): each model
  one request against the CPU, 8 requests, the 2 + 2 step on crops scaled
  to cover 512², one step at 1 + 1, 256² against the CPU's and its
  one-ulp witness (OCRNet's comparisons from BN statistics set from their
  inputs); ``tools.train`` on OCRNet with eval, a checkpoint loading the
  trained student bit for bit, ``--auto-resume`` and ``tools.test``;
- the ablation flags of the step (``ablation_*``): one f32 step of
  ``..._MT_w_ours.py`` at 4 layers with every flag group whose draws can be
  handed to both devices, against the CPU; three bf16 flag sets at full
  width and 4 layers, 4 + 4 at 512² (strong mixes; adaptive CutMix, PatchShuffle +
  ClassMix and the supervised mixes; dropout, drop path, head dropout,
  fdrop, EMA head dropout, supervised NCR, ``sup_ema``, layer decay and a
  sigmoid aux CE), each step's launches checked against the passes its
  flags imply; MiT-B4 with fdrop at 4 + 4, 768²; ``tools.train`` with the
  regularisers by ``--cfg-options``, 6 steps, resumed to 8;
- UniMatch and the ViT's remat (``unimatch_*``, ``remat_*``): one f32
  UniMatch step against the CPU (``..._MT_w_ours.py`` at 4 layers, 1 + 1 at
  512², head 1 as the PASA pass and as the fdrop pass; MiT-B4 at depth
  [1, 1, 1, 1], 1 + 1 at 768²), the streams' boxes and permutations
  injected; the bf16 UniMatch step at full depth, 8 + 8 at 512² with its
  mix stream (timed, profiled); the flagship and the UniMatch 8 + 8 steps
  at 4 layers with remat off, 'dots' and 'full' (losses and updates
  against remat off, step time, peak memory); ``tools.train`` on a
  UniMatch variant of the fixture config (``UniSemiDataset``,
  three-branch pipelines with RandomGrayscale and GaussianBlur), 3 steps,
  resumed to 6, and ``tools.test`` against the in-loop mIoU;
- data parallelism (``dp_*``; the ranks of this and the next two items
  started by ``torch.distributed.run`` on this script's ``--dp-worker``
  mode, the tasks that need the same ranks in one start-up,
  ``run_together``, the ranks writing their results to files): 2
  ranks on one card over gloo against one process, the f32 step of
  ``..._MT_w_ours.py`` at 4 layers, 3 steps of 4 + 4 global (2 + 2 a
  rank), the ranks' states bit-identical and the hard pseudo-labels that
  differ from one process's counted, then again with each rank's teacher
  logits pinned to one process's; the bf16 flagship at 4 + 4 a
  rank (step and all-reduce time, peak a rank), and with more cards the
  same over NCCL, one rank a card (up to 4); ``tools.train --launcher
  env`` over NCCL with min(2, cards) ranks on the fixture config, 6 steps,
  resumed to 8, rank 0 alone writing (its eval panels too), and
  ``tools.test`` against the in-loop mIoU. Ranks start once a rank
  count: on one card 2 (the 2-rank f32 grids, the 1 x 2 bf16 step and
  dp_train_bf16), 4 (the sharded ``tools.train`` and its resume, then the
  ZeRO-3 f32 grid, the 2 x 2 bf16 step, the pipeline and ring grids);
  the tasks of one rank (the data-parallel ``tools.train``, its resume and
  ``test_cli_ranks``' ``tools.test`` on one card) run in this process
  under the launcher's environment;
- sharded training (``tp_*``, ``zero3_*``; ``parallel/tp.py``): kernels
  #1-#4 held at H = 6 and 3, the heads of a tensor-parallel rank; the f32
  step at 4 layers split as data 1 x model 2 (2 ranks, gloo on cuda:0)
  and data 2 x model 2 with ZeRO-3 (4 ranks; NCCL with 4 cards) against
  one process, within the data-parallel bounds; the bf16 flagship at 4
  layers on one global 4 + 4 batch in one process, 1 x 2 and 2 x 2 with
  ZeRO-3 (step and device ms, peak memory, the floats and heads a rank);
  ``tools.train --model-parallel 2 --zero3`` on 4 ranks at 4 layers, 2
  steps with eval and a checkpoint (the layout of ``train_cli``'s first 4
  layers), resumed to 3, and
  ``tools.test`` on it against the in-loop mIoU;
- pipeline and context parallelism (``parallel/pp.py``,
  ``parallel/ring_attention.py``), 4 ranks (gloo on one card) for every
  grid: ring attention at B = 1, L =
  4096, H = 12 in bf16 and f32, rings of 2 (blocks of 2048: the dk/dv and
  dq kernels) and of 4 (1024: the fused one), without and with a PASA
  bias, against the one-process flash kernels and their plain versions;
  GPipe of DeiT-B's 12 layers (bf16; f32 at 4) on [8, 1025, 768] tokens
  over pipe 4 (M = 8) and data 2 x pipe 2 (M = 4), and GPipe x Megatron
  TP over data 1 x pipe 2 x model 2 (M = 4; with sequence parallelism at
  L = 1026), against the one-process sequential stack.

Each kernel is held to its plain version at every shape a path launched:
the shapes listed up front (the TTA and whole-image eval token counts
worked out from the fixture images, the ring's blocks), and at the end
any other that the launches recorded, the ranks' included.

Every phase prints one JSON line, with ``t``, the seconds since the start
(so a run that is cut or fails shows how far it got and where the time
went); any failed check raises and the script exits nonzero without its
last line. Each path runs with the kernels'
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
import re
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
# the ring attention phases' sequence: a 1024² image at patch 16, 64 x 64
# tokens (the long-token use JAX ring_attention.py's docstring names); rings
# of 2 (blocks of 2048: the dk/dv and dq kernels) and of 4 (1024: fused)
RING_L = 4096
RING_CPS = (2, 4)
# a pipeline against the one-process sequential stack on the card: max abs
# error over the reference's max |value|, per tensor (the output, x's
# gradient, each stage parameter's). f32: the same sums on other GEMM
# shapes (a microbatch's rows, a rank's columns). bf16: those GEMMs round
# each output to bf16 (2^-8 of a value) at other places, and 12 layers
# carry a layer's rounding on; a misrouted microbatch, stage or gradient sum
# is off by O(1)
TOL_PP = {'float32': 1e-4, 'bfloat16': 5e-2}
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


# the script's start: every phase line carries 't', the seconds since it,
# so a run that is cut or fails shows how far it got and where time went
T_START = time.perf_counter()


def emit(obj):
    if 'phase' in obj:
        obj = {**obj, 't': round(time.perf_counter() - T_START, 1)}
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
    # captured on the side stream: ``torch.cuda.graph``'s context also
    # empties the caching allocator (and in some versions collects
    # garbage) first, a fifth of a second a capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    ms = cuda_time_ms(graph.replay, iters=iters, warmup=2)
    del graph
    return ms


def attention_inputs(b, l, h, dtype, bias_kind, gen):
    """q, k, v as the ViT makes them (strided views of one fused qkv
    projection) and a bias of the given kind, in their dtype. 'pasa_block'
    is a ring step's bias: the rows of one query chunk and the columns of
    the next k/v chunk of a PASA bias over RING_L tokens, a strided view."""
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
    elif bias_kind == 'pasa_block':
        unconf = torch.rand((b, RING_L - 1), generator=gen, device='cuda')
        bias = build_pasa_bias(unconf, 5.0, adaptive=True).to(dtype)[
            :, :, :l, l:2 * l]
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
# version (``check_forward``) and those launched (``record_shapes``, in the
# parent and in every rank); the backward kernels' likewise, each (kernel,
# dtype, B, L, H, bias)
FWD_HELD, FWD_SEEN = set(), set()
BWD_HELD, BWD_SEEN = set(), set()


def fwd_shape(q, bias):
    b, l, h, _ = q.shape
    kind = None if bias is None else ('b1' if bias.shape[1] == 1 else 'bh')
    return (str(q.dtype).replace('torch.', ''), b, l, h, kind)


def record_shapes(fa):
    """Wrap the kernels' launchers so that every launch adds its shape to
    FWD_SEEN or BWD_SEEN; the launch and its count stay the launcher's."""
    launch = fa._launch_fwd

    def recording(q, k, v, bias):
        FWD_SEEN.add(fwd_shape(q, bias))
        return launch(q, k, v, bias)
    fa._launch_fwd = recording
    for name in BWD_WORK:
        attr = 'launch_' + name.replace('flash_attn_', '')
        setattr(fa, attr, _recording_bwd(name, getattr(fa, attr)))


def _recording_bwd(name, launch):
    def recording(q, k, v, bias, *rest):
        BWD_SEEN.add((name,) + fwd_shape(q, bias))
        return launch(q, k, v, bias, *rest)
    return recording


def phase_kernels_seen(fa, entries):
    """Each kernel against its plain version at every shape a path
    launched that no earlier check held (random inputs, a random bias of
    the path's kind), so that no shape a path brings goes unheld; adds
    them to the kernels line's ``entries``. The shapes held here belong in
    ``phase_kernels``' or ``phase_kernels_bwd``'s lists."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(2)
    late = sorted(FWD_SEEN - FWD_HELD, key=str)
    kinds = {None: None, 'b1': 'random_b1', 'bh': 'random_bh'}
    entry = entries['flash_attn_fwd']
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
    late_bwd = sorted(BWD_SEEN - BWD_HELD, key=str)
    for kernel, name, b, l, h, kind in late_bwd:
        where = f'{kernel} {name} B={b} L={l} H={h} bias={kind}'
        q, k, v, bias = attention_inputs(b, l, h, getattr(torch, name),
                                         kinds[kind], gen)
        do = torch.randn(q.shape, generator=gen, device='cuda').to(q.dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        ref = fa.flash_attention_backward_reference(q, k, v, bias, o, lse,
                                                    do)
        args = (q, k, v, bias, do, lse, fa.row_delta(o, do))
        got = getattr(fa, 'launch_' + kernel.replace('flash_attn_', ''))(
            *args)
        if kernel == 'flash_attn_bwd_dkv':
            got = (ref[0],) + tuple(got)
        elif kernel == 'flash_attn_bwd_dq':
            got = (got,) + tuple(ref[1:])
        torch.cuda.synchronize()
        errs, peaks = grad_errors(got, ref)
        rel = max(e / p for e, p in zip(errs, peaks))
        emit({'phase': 'kernel_check_bwd', 'for': 'seen_on_a_path',
              'kernel': kernel, 'dtype': name, 'B': b, 'L': l, 'H': h,
              'D': 64, 'bias': kind, 'abs_err_dq_dk_dv': errs,
              'max_abs_dq_dk_dv': peaks, 'max_rel_err': rel,
              'tol': TOL_BWD[name]})
        check(rel <= TOL_BWD[name], f'{kernel} disagrees with the plain '
              f'backward: {where} err={errs} max |grad|={peaks}')
        BWD_HELD.add((kernel, name, b, l, h, kind))
        if name == 'bfloat16':
            entries[kernel]['max_abs_err'] = max(
                entries[kernel]['max_abs_err'], max(errs))
            entries[kernel]['max_rel_err'] = max(
                entries[kernel]['max_rel_err'], rel)
        del q, k, v, bias, do, o, lse, ref, args, got
    for kernel in BWD_WORK:
        entries[kernel]['shapes_held_late'] = [s[1:] for s in late_bwd
                                               if s[0] == kernel]
    emit({'phase': 'kernel_shapes', 'launched': len(FWD_SEEN),
          'held': len(FWD_HELD), 'held_late': late,
          'bwd_launched': len(BWD_SEEN), 'bwd_held': len(BWD_HELD),
          'bwd_held_late': late_bwd})
    check(FWD_SEEN <= FWD_HELD, 'forward shapes launched but not held: '
          f'{sorted(FWD_SEEN - FWD_HELD, key=str)}')
    check(BWD_SEEN <= BWD_HELD, 'backward shapes launched but not held: '
          f'{sorted(BWD_SEEN - BWD_HELD, key=str)}')


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
    crops), and a ring block of RING_L tokens over 2 and 4 ranks (L = 2048
    and 1024, no bias and a PASA bias's strided column block);
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
    ring = [(1, RING_L // cp, kind) for cp in RING_CPS
            for kind in (None, 'pasa_block')]
    shapes += ring
    # the training steps' shapes (teacher and sup pass; fused 2B pass) at
    # 8 + 8 and 4 + 4
    train_shapes = {('bfloat16', 8, 1025, None),
                    ('bfloat16', 16, 1025, 'pasa'),
                    ('bfloat16', 4, 1025, None),
                    ('bfloat16', 8, 1025, 'pasa')}
    ring_timed = {('bfloat16',) + shape for shape in ring}
    timed = train_shapes | ring_timed | {('bfloat16', 1, 1025, None),
                                         ('bfloat16', 2, 2305, None),
                                         ('bfloat16', 1, 2305, 'pasa')}
    fwd_timed = train_shapes | ring_timed
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
                BWD_HELD.add((name,) + fwd_shape(q, bias))
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
    B = 4, L = 1377 and at the pipeline x TP ranks' B = 2, L = 1026
    (sequence parallelism's pad), timed at B = 8 and 16 and at the eval
    shape; the fused backward at B = 8, L = 1025 and at those ranks' B = 2,
    L = 1025 and 1026; the dk/dv and dq kernels at B = 2, L = 2305, all
    timed. Each timed row with its bound, the plain version's time and
    the library call's. The rows go to the kernels line's entries
    (``cases``, with their H)."""
    fwd_shapes = [(b, 1025, kind) for b in (2, 4, 8, 16)
                  for kind in (None, 'pasa')] + [(4, 1377, None),
                                                 (2, 1026, None)]
    fwd_timed = {(8, 1025, None), (8, 1025, 'pasa'), (16, 1025, None),
                 (16, 1025, 'pasa'), (4, 1377, None)}
    bwd_shapes = [(8, 1025, None), (8, 1025, 'pasa'), (2, 2305, None),
                  (2, 1025, None), (2, 1026, None)]
    hold_kernels_at(fa, entries, TP_HEADS, fwd_shapes, fwd_timed,
                    bwd_shapes, set(bwd_shapes), 'tensor_parallel', seed=3)


def phase_kernels_zoo(fa, entries):
    """Kernels #1 and #2 against their plain versions at SETR-MLA's ViT-L:
    H = 16 over L = 1024 tokens (no cls token), f32 and bf16. The forward
    at B = 1 (serving) and at the B of each MLA step pass (1 + 1 f32, the
    CLI's 2 + 2, 4 + 4; 8 as a larger batch), and at the eval's B = 4,
    L = 1376 (43 x 32 patches); the fused backward at B = 1, 2, 4 and 8.
    Timed in bf16 at B = 1, 4, 8 and the eval shape (forward) and at B = 4
    and 8 (backward)."""
    fwd_shapes = [(b, MLA_L, None) for b in (1, 2, 4, 8)] + \
        [(4, 1376, None)]
    fwd_timed = {(1, MLA_L, None), (4, MLA_L, None), (8, MLA_L, None),
                 (4, 1376, None)}
    bwd_shapes = [(b, MLA_L, None) for b in (1, 2, 4, 8)]
    hold_kernels_at(fa, entries, (MLA_HEADS,), fwd_shapes, fwd_timed,
                    bwd_shapes, {(4, MLA_L, None), (8, MLA_L, None)},
                    'zoo', seed=4)


def hold_kernels_at(fa, entries, heads, fwd_shapes, fwd_timed, bwd_shapes,
                    bwd_timed, purpose, seed):
    """The kernels against their plain versions at each of ``heads``, in
    f32 and bf16: the forward at ``fwd_shapes`` (B, L, bias kind), the
    backward kernels that L takes at ``bwd_shapes``; the shapes in
    ``fwd_timed`` / ``bwd_timed`` with their times, bound, plain and
    library times, added to the kernels line's ``entries`` (``cases``).
    Each check line names ``purpose``."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(seed)
    launchers = {'flash_attn_bwd_fused': fa.launch_bwd_fused,
                 'flash_attn_bwd_dkv': fa.launch_bwd_dkv,
                 'flash_attn_bwd_dq': fa.launch_bwd_dq}
    fwd_entry = entries['flash_attn_fwd']
    for h in heads:
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
                emit({'phase': 'kernel_check', 'for': purpose, **case})
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
                is_timed = (b, l, kind) in bwd_timed
                if is_timed:
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
                    case = dict(dtype=dname, B=b, L=l, H=h, D=64, bias=kind,
                                max_abs_err=max(errs),
                                abs_err_dq_dk_dv=errs,
                                max_abs_dq_dk_dv=peaks, max_rel_err=rel,
                                tol=TOL_BWD[dname])
                    entry = entries[name]
                    if is_timed:
                        products, outputs = BWD_WORK[name]
                        bound, bound_by = bound_ms(q, bias, products,
                                                   5 + outputs)
                        case.update(
                            ms=cuda_time_ms(lambda: launchers[name](*args),
                                            iters=10, warmup=2),
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound, bound_by=bound_by)
                        entry['cases'].append(case)
                    if dname == 'bfloat16':
                        entry['max_abs_err'] = max(entry['max_abs_err'],
                                                   max(errs))
                        entry['max_rel_err'] = max(entry['max_rel_err'], rel)
                    emit({'phase': 'kernel_check_bwd', 'kernel': name,
                          'for': purpose, **case})
                    check(all(torch.isfinite(t).all().item() for t in got),
                          f'non-finite {name} {where}')
                    check(rel <= TOL_BWD[dname], f'{name} disagrees with the '
                          f'plain backward: {where} err={errs} max '
                          f'|grad|={peaks}')
                    BWD_HELD.add((name,) + fwd_shape(q, bias))
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


def cut_depth(backbone, num_layers):
    """A ViT config's depth cut to ``num_layers``, its taps moved to the
    last layers (so every layer still reaches a head and the main head
    reads the last one)."""
    taps = len(backbone.out_indices)
    backbone.num_layers = num_layers
    backbone.out_indices = tuple(range(num_layers))[-taps:]


def load_config(dtype, name='sup', num_layers=None):
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(CONFIGS[name])
    if dtype is not None:
        cfg.model.backbone.dtype = dtype
        cfg.model.decode_head.dtype = dtype
        for head in cfg.model.auxiliary_head:
            head.dtype = dtype
    if num_layers is not None:
        cut_depth(cfg.model.backbone, num_layers)
    return cfg


def phase_main_f32(fa, images):
    """The flagship in f32 on the card against the same weights on the
    CPU, one 512² request. Returns the card's probabilities."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config('float32')
    p_cpu, cpu_s, cpu_launches = cpu_half('main_f32', images)
    gpu = init_segmentor(cfg, seed=0, device='cuda')
    x, _ = _prepare_image(gpu, images[0])
    check(x.shape == (1, 512, 512, 3), f'request shape {x.shape}')
    fa.launch_count = 0
    p_gpu = gpu.probs(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    launches = fa.launch_count
    check(launches == 12, f'f32 forward launched the kernel {launches} '
          f'times, not 12')
    check(cpu_launches == 0, 'the CPU forward reached the kernel')
    check(p_gpu.shape == (1, 512, 512, 21), f'probs shape {p_gpu.shape}')
    check(torch.isfinite(p_gpu).all().item(), 'non-finite f32 probs')
    err = (p_gpu.cpu() - p_cpu).abs().max().item()
    agree = (p_gpu.cpu().argmax(-1) == p_cpu.argmax(-1)).float().mean()
    emit({'phase': 'main_f32_vs_cpu', 'launches': launches,
          'probs_max_abs_err': err, 'tol': TOL_MAIN_F32,
          'argmax_agreement': agree.item(), 'cpu_forward_s': cpu_s})
    check(err <= TOL_MAIN_F32, f'f32 card vs CPU probs differ by {err}')
    del gpu
    torch.cuda.empty_cache()
    return p_gpu


def cpu_main_f32(fa, images, root):
    """``phase_main_f32``'s CPU request: (probabilities, seconds, kernel
    launches)."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    cpu = init_segmentor(load_config('float32'), seed=0, device='cpu')
    x, _ = _prepare_image(cpu, images[0])
    fa.launch_count = 0
    t0 = time.perf_counter()
    p_cpu = cpu.probs(torch.from_numpy(x))
    return p_cpu, time.perf_counter() - t0, fa.launch_count


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


def device_rows(prof):
    """(device µs, name, calls) of each kernel, copy or fill of a finished
    torch.profiler run, largest first, summed from the trace's raw device
    events (``key_averages`` would first build and walk the tree of every
    host operator: seconds for a training step)."""
    from torch.autograd import DeviceType
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            row = by_name.setdefault(ev.name(), [0.0, 0])
            row[0] += ev.duration_ns() / 1e3
            row[1] += 1
    return sorted(((us, k, n) for k, (us, n) in by_name.items()),
                  reverse=True)


def device_profile(fn, n_top):
    """Run ``fn()`` once under torch.profiler: (its result, the wall time,
    the device time by kernel and the device's busy share of the wall
    time), the device's events by ``device_rows``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
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


def fixture_arrays(images, size, cover=False):
    """Normalised NHWC images and their label maps, padded bottom/right to
    size x size (image 0, label 255) as the configs' Pad does, or cropped
    top-left where larger; with ``cover`` first scaled (PIL bilinear,
    labels nearest) so that the shorter side is ``size``: no padding."""
    import numpy as np
    from PIL import Image
    from s4former_tpu_torch.apis import _DEFAULT_NORM
    mean = np.asarray(_DEFAULT_NORM['mean'], np.float32)
    std = np.asarray(_DEFAULT_NORM['std'], np.float32)
    xs, ys = [], []
    for path in images:
        stem = os.path.splitext(os.path.basename(path))[0]
        with Image.open(path) as im, \
                Image.open(os.path.join(LABELS, stem + '.png')) as lab:
            im = im.convert('RGB')
            if cover:
                scale = size / min(im.size)
                hw = (round(im.width * scale), round(im.height * scale))
                im = im.resize(hw, Image.BILINEAR)
                lab = lab.resize(hw, Image.NEAREST)
            x = (np.asarray(im, np.float32) - mean) / std
            y = np.asarray(lab).astype(np.int64)
        x, y = x[:size, :size], y[:size, :size]
        h, w = y.shape
        xs.append(np.pad(x, ((0, size - h), (0, size - w), (0, 0))))
        ys.append(np.pad(y, ((0, size - h), (0, size - w)),
                         constant_values=255))
    return np.stack(xs), np.stack(ys)


def train_batch(images, n_sup, n_unsup, size=512, cover=False):
    """The step's batch: sup images + labels, and unsup images for the
    teacher and the student (the same views: the augmentation pipelines
    are not ported); ``cover`` as ``fixture_arrays``'."""
    x, y = fixture_arrays(images[:n_sup + n_unsup], size, cover)
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


def one_step(fa, state, step, batch, device, wrap=contextlib.nullcontext):
    """One step of ``step`` from ``state`` on the numpy ``batch``, on
    ``device``, inside ``wrap()``: (logs, each parameter's update on the
    CPU, seconds, launch counts)."""
    import torch
    before = {n: p.detach().cpu().clone()
              for n, p in state.model.named_parameters()}
    dev_batch = to_device(batch, device)
    reset_counts(fa)
    t0 = time.perf_counter()
    with wrap():
        state, logs = step(state, dev_batch,
                           torch.Generator(device=device).manual_seed(0))
    if device == 'cuda':
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    delta = {n: p.detach().cpu() - before[n]
             for n, p in state.model.named_parameters()}
    out = (floats(logs), delta, seconds, counts(fa))
    del state, step, dev_batch
    torch.cuda.empty_cache()
    return out


def flagship_f32_batch(images):
    """``phase_train_f32_vs_cpu``'s batch: 1 + 1 at 512², a CutMix box and
    a seeded PatchShuffle permutation."""
    import numpy as np
    batch = train_batch(images, 1, 1)
    mask = np.ones((1, 512, 512), np.float32)
    mask[0, 96:352, 128:320] = 0
    batch['dbg_cutmix_mask'] = mask
    batch['dbg_patchmix_perm'] = np.random.RandomState(0).permutation(
        16)[None].astype(np.int32)
    return batch


def cpu_train_f32(fa, images, root):
    """``phase_train_f32_vs_cpu``'s CPU step."""
    state, step, _ = make_trainer('ours', 'cpu', 'float32', 4,
                                  unsup_confidence=UNSUP_CONFIDENCE_F32)
    return one_step(fa, state, step, flagship_f32_batch(images), 'cpu')


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
    lc, dc, sc, cc = cpu_half('train_f32', images)
    state, step, _ = make_trainer('ours', 'cuda', 'float32', 4,
                                  unsup_confidence=UNSUP_CONFIDENCE_F32)
    lg, dg, sg, cg = one_step(fa, state, step, flagship_f32_batch(images),
                              'cuda')
    del state, step
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
    for kind in ('plain', 'native'):
        with host_functions(kind):
            for n_threads, n in ((1, 4), (threads, 2 * threads)):
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
    file, no eval, logs every 3, on the native and then the plain host
    functions; each traces steps 7-9 (``--profile 7 3``), read by
    ``tools/profile_trace.py`` beside the no-loader step's trace
    ``no_loader``. Each run's log must
    report every backbone tensor loaded. Returns the runs' counts."""
    import numpy as np
    from s4former_tpu_torch.tools import profile_trace
    from s4former_tpu_torch.tools import train as train_cli
    opts = ['--cfg-options', 'checkpoint_config.interval=9',
            'log_config.interval=3']
    loaded = f'({n_backbone} of {n_backbone} backbone tensors)'
    total = None
    runs = []
    for i, kind in enumerate(('native', 'plain')):
        wd = os.path.join(root, f'host_{i}_{kind}')
        reset_counts(fa)
        with host_functions(kind):
            state = train_cli.main(
                [FULLFLAG, '--work-dir', wd, '--max-iters', '9',
                 '--no-validate', '--load-from', deit, '--profile', '7',
                 '3'] + opts)
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
        run = {'host': kind, 'traced_steps': '7-9',
               'step_ms_windows': [r['step_ms'] for r in train],
               'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
               'trace': profile_trace.analyze(profile_trace.load_events(
                   os.path.join(wd, 'profile')), steps=3)}
        print(f'trace of the {kind} run, steps 7-9:\n' +
              profile_trace.report(run['trace']), flush=True)
        runs.append(run)
        total = run_counts if total is None else add_counts(total, run_counts)
        shutil.rmtree(wd, ignore_errors=True)
    # the untraced window after the first: steps 4-6
    steady = {r['host']: r['step_ms_windows'][1:2] for r in runs}
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


def test_cli_dirs(root):
    return {name: os.path.join(root, f'test_{name}')
            for name in ('one', 'ranks')}


def test_cli_argv(ckpt, d):
    return [FULLFLAG, ckpt, '--show-dir', os.path.join(d, 'vis'), '--out',
            os.path.join(d, 'preds.pkl')]


def test_cli_one(fa, ckpt, root):
    """The one-process half of test_cli_ranks: ``tools.test`` on ``ckpt``
    with ``--show-dir --out``. Returns (its launches, its metrics, its
    seconds)."""
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    single = test_cli.main(test_cli_argv(ckpt, test_cli_dirs(root)['one']))
    torch.cuda.synchronize()
    return counts(fa), single, time.perf_counter() - t0


def phase_test_cli_ranks(fa, gpu_line, ckpt, root, one):
    """``tools.test --launcher env`` over NCCL with K = min(2, cards) ranks
    (one a card; on one card the launcher path with K = 1) against one
    process (``one``: ``test_cli_one``'s launches, metrics and seconds),
    the exact path with ``--show-dir --out`` on ``ckpt``: the metrics
    equal (``==``), the painted PNGs and the ``.pkl`` byte-equal, and the
    forward launches summed over the ranks one process's (12 a flush of
    4). The ranks start with the data-parallel slice's CLI ranks
    (``run_dp``). Returns both runs' launches summed."""
    import torch
    k = min(DP_RANKS, torch.cuda.device_count())
    n_val, flush = 16, 4
    per_eval = 12 * -(-n_val // flush)
    dirs = test_cli_dirs(root)
    one_counts, single, one_s = one
    ranks, = yield [rank_task('test', {'argv': test_cli_argv(
        ckpt, dirs['ranks']) + ['--launcher', 'env']}, k)]
    ranks_s = max(r['seconds'] for r in ranks)
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
          'one_s': one_s, 'ranks_task_s': ranks_s, 'gpu': gpu_line})
    check(all(same_metrics), 'the ranks\' metrics are not one process\'s')
    check(len(vis['one']) == n_val and vis['ranks'] == vis['one'],
          'the ranks\' --show-dir files are not one process\'s')
    check(pkl['ranks'] == pkl['one'], 'the ranks\' --out file is not one '
          'process\'s')
    want = dict({n: 0 for n in KERNELS}, flash_attn_fwd=per_eval)
    check(one_counts == want and rank_counts == want,
          f'launches: one process {one_counts}, the ranks {rank_counts}, '
          f'not {per_eval} forward')
    return add_counts(one_counts, rank_counts)


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

    bench_iters, bench_warmup = 50, 5
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
    checkpoints; returns their launch counts by path and the test_cli_ranks
    phase, whose ranks start with the data-parallel slice's (``run_dp``)
    on a link of ``iter_12`` that outlives ``wd``; prints their
    seconds."""
    seconds = {}
    ckpt = os.path.join(root, 'test_cli_ranks_iter_12')
    shutil.copytree(os.path.join(wd, 'iter_12'), ckpt, copy_function=os.link)
    t0 = time.perf_counter()
    one = test_cli_one(fa, ckpt, root)
    seconds['test_cli_one'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = {'tools_cli': phase_tools_cli(fa, gpu_line, wd, root, images,
                                          one[1]['mIoU'])}
    seconds['tools_cli'] = time.perf_counter() - t0
    emit({'phase': 'eval_tools_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths, ('test_cli_ranks', lambda: phase_test_cli_ranks(
        fa, gpu_line, ckpt, root, one))


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
    p_cpu, cpu_s = cpu_half('mit_serve_f32', None)
    gpu = init_segmentor(cfg, seed=0, device='cuda')
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
    del gpu, p_gpu, p_cpu
    torch.cuda.empty_cache()
    return path_counts


def cpu_mit_serve_f32(fa, images, root):
    """``phase_mit_serve_f32``'s CPU request: (probabilities, seconds).
    Its frame is the first of ``write_city_pngs`` from RandomState(4), as
    ``main`` writes them."""
    import numpy as np
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    frame, = write_city_pngs(np.random.RandomState(4),
                             os.path.join(root, 'frames'), 1)
    cpu = init_segmentor(load_mit_config('sup', 'float32',
                                         MIT_SERVE_F32_DEPTH),
                         seed=0, device='cpu')
    x, _ = _prepare_image(cpu, frame)
    t0 = time.perf_counter()
    p_cpu = cpu.probs(torch.from_numpy(x))
    return p_cpu, time.perf_counter() - t0


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


def trainer_from_config(cfg, device, paramwise_cfg=None, weights=None,
                        **semi_over):
    """(state, train_step) of a config through the port's entry points,
    with seeded random weights (overlaid by the state dict ``weights`` if
    given: the student's and the EMA teacher's); ``paramwise_cfg`` turns
    on the layer-wise LR decay."""
    from s4former_tpu_torch.apis import init_segmentor
    model = init_segmentor(cfg, seed=0, device=device).model
    if weights is not None:
        model.load_state_dict(weights)
    return trainer_of(model, cfg, paramwise_cfg, **semi_over)


def trainer_of(model, cfg, paramwise_cfg=None, **semi_over):
    """(state, train_step) of a built model (``init_segmentor``'s) and its
    config."""
    import dataclasses
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                               **semi_over)
    state = create_train_state(model, ema=semi.ema)
    step = make_semi_train_step(model, semi, model.num_classes,
                                paramwise_cfg=paramwise_cfg,
                                **step_kwargs(cfg))
    return state, step


def mit_f32_batch():
    """``phase_mit_train_f32_vs_cpu``'s batch: 1 + 1 seeded scenes at
    MIT_CROP², a CutMix box and a seeded PatchShuffle permutation."""
    import numpy as np
    rs = np.random.RandomState(5)
    batch = mit_train_batch(rs, 1, 1)
    mask = np.ones((1, MIT_CROP, MIT_CROP), np.float32)
    mask[0, 128:512, 192:480] = 0
    batch['dbg_cutmix_mask'] = mask
    batch['dbg_patchmix_perm'] = rs.permutation(36)[None].astype(np.int32)
    return batch


def cpu_mit_train_f32(fa, images, root):
    """``phase_mit_train_f32_vs_cpu``'s threshold (the median of the CPU
    teacher's max softmax) and CPU step."""
    import torch
    batch = mit_f32_batch()
    cfg = load_mit_config('ours', 'float32', MIT_TRAIN_F32_DEPTH, drop=False)
    state, _ = trainer_from_config(cfg, 'cpu')
    with torch.no_grad():
        t_logits = state.model.forward_decode_from_img(
            torch.from_numpy(batch['unsup_teacher_img']), train=False)
    threshold = float(torch.softmax(t_logits.float(), -1).amax(-1).median())
    state, step = trainer_from_config(cfg, 'cpu', unsup_confidence=threshold)
    return threshold, one_step(fa, state, step, batch, 'cpu')


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
    threshold, (lc, dc, sc, cc) = cpu_half('mit_train_f32', None)
    cfg = load_mit_config('ours', 'float32', MIT_TRAIN_F32_DEPTH, drop=False)
    state, step = trainer_from_config(cfg, 'cuda', unsup_confidence=threshold)
    lg, dg, sg, cg = one_step(fa, state, step, mit_f32_batch(), 'cuda')
    del state, step
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


def device_time_by_class(prof):
    """Device time (µs) of a profiled run by operator class: each CPU
    operator's own kernels (the kernels it launched, not its children's:
    ``key_averages``' ``self_device_time_total``, without walking the
    tree for every operator) summed over the classes of OP_CLASSES, the
    rest as 'elementwise, reductions, copies (incl. BN, GELU, losses,
    SGD)'. The MixFFN's depthwise 3x3 conv is split from the other convs
    by its cuDNN kernels' names (grouped / one-channel-a-group
    kernels)."""
    import re
    from torch.autograd import DeviceType
    out = {}
    depthwise = sum(us for us, name, _ in device_rows(prof)
                    if re.search(r'grouped|depthwise|_c1_k1', name))
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or ev.is_async:
            continue
        us = sum(k.duration for k in ev.kernels)
        if us <= 0:
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
    step, 2 timed, 1 profiled (device time by kernel and by operator
    class). Returns the launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = load_mit_config('ours', 'bfloat16')
    state, step = trainer_from_config(cfg, 'cuda')
    batch = to_device(mit_train_batch(np.random.RandomState(6), n_sup,
                                      n_unsup), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, logs = step(state, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path_counts = counts(fa)                       # the main path ends
    peak = torch.cuda.max_memory_allocated()
    by_class = device_time_by_class(prof)
    rows = device_rows(prof)
    device_us = sum(r[0] for r in rows)
    top = [(us, k[:100], n) for us, k, n in rows[:15]]
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
    seeded Cityscapes tree: 4 steps with slide eval and checkpoints at 2
    and 4; ``--auto-resume`` to 5; ``tools.test --eval mIoU`` on
    ``iter_4`` within TOL_MIOU of the in-loop mIoU; ``--format-only``
    writes label-id PNGs. Returns the runs' launch counts summed."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    splits = write_city_tree(os.path.join(root, 'city'))
    data_root = os.path.join(root, 'city')
    cfg_path = MIT_CONFIGS['ours']
    opts = ['--cfg-options', 'model.backbone.dtype=bfloat16',
            'model.decode_head.dtype=bfloat16', 'evaluation.interval=2',
            'checkpoint_config.interval=2', 'log_config.interval=2',
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
    state = train_cli.main([cfg_path, '--work-dir', wd, '--max-iters', '4']
                           + opts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)                      # the main path ends
    peak = torch.cuda.max_memory_allocated()
    check(int(state.step) == 4, f'trained to step {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    check([r['step'] for r in train] == [2, 4] and sorted(val) == [2, 4],
          f'logged steps {records}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(all('unsup.loss_seg_unsup' in r for r in train),
          'the unsup branch did not run')

    reset_counts(fa)
    state = train_cli.main([cfg_path, '--work-dir', wd, '--auto-resume',
                            '--max-iters', '5'] + opts)
    torch.cuda.synchronize()
    resume_counts = counts(fa)
    check(int(state.step) == 5, f'resumed run ended at {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    resumed = f'resumed from {os.path.join(wd, "iter_4")}'
    check(resumed in read_logs(wd), f'no "{resumed}" in the log')

    reset_counts(fa)
    t0 = time.perf_counter()
    results = test_cli.main([cfg_path, os.path.join(wd, 'iter_4'),
                             '--eval', 'mIoU'] + opts)
    test_s = time.perf_counter() - t0
    fmt = os.path.join(root, 'mit_fmt')
    none = test_cli.main([cfg_path, os.path.join(wd, 'iter_4'),
                          '--format-only', '--imgfile-prefix', fmt] + opts)
    test_counts = counts(fa)
    in_loop = val[4]['mIoU']
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
          'in_loop_miou_iter_4': in_loop, 'miou_gap': gap, 'tol': TOL_MIOU,
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


# ----------------------------------------------------- the ViT model zoo
ZOO_MODELS = {'mla': 'setr_mla.py', 'segmenter': 'segmenter_vit-b_mask.py'}
# the f32 card-vs-CPU phases' depth: 4 layers, the taps the last ones
ZOO_F32_LAYERS = 4
# SETR-MLA's ViT-L: 24 layers of 16 heads over 1024 tokens (no cls token)
MLA_HEADS, MLA_L = 16, 1024


def zoo_config(root, which):
    """``setr_fixture_voc_mini_fullflag.py`` (the fixture run of
    ``..._MT_w_ours.py``: VOC fixture data, every S4Former flag) with its
    model replaced by that of ``configs/_base_/models/`` ``setr_mla.py``
    ('mla': ViT-L, the MLA neck, SETRMLAHead, four FCN aux heads) or
    ``segmenter_vit-b_mask.py`` ('segmenter': ViT-B, the mask-transformer
    head, no aux heads), written to ``root`` as ``ade_cli_config`` writes
    its config: 21 classes on every head, the backbone in the flagship's
    bf16 (the neck and heads compute in f32, as JAX's). SETR-MLA's ViT has
    no cls token, so its PASA is off (``attn_mask_seperate_head=False``;
    the JAX package cannot build that bias either); PatchShuffle with
    CutMix, NCR and the EMA stay on. Returns the path."""
    from s4former_tpu_torch.config import Config
    model = Config.fromfile(os.path.join(
        REPO, 'configs', '_base_', 'models', ZOO_MODELS[which])).to_dict()[
            'model']
    aux = model.get('auxiliary_head') or []
    for head in [model['decode_head']] + aux:
        head['num_classes'] = 21
    over = dict(backbone=dict(model['backbone'], _delete_=True,
                              dtype='bfloat16'),
                decode_head=dict(model['decode_head'], _delete_=True),
                auxiliary_head=aux)
    if 'neck' in model:
        over['neck'] = model['neck']
    if which == 'mla':
        over['attn_mask_seperate_head'] = False
    path = os.path.join(root, f'{which}_voc_mini_MT_w_ours.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{FULLFLAG!r}]\nmodel = {over!r}\n')
    return path


def zoo_cfg(path, dtype=None, num_layers=None, drop=True):
    """A zoo config with the backbone's dtype set, its depth cut to
    ``num_layers`` (the taps moved to the last layers), and with
    ``drop=False`` every dropout and drop path at 0."""
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(path)
    bb = cfg.model.backbone
    if dtype is not None:
        bb.dtype = dtype
    if num_layers is not None:
        cut_depth(bb, num_layers)
    if not drop:
        bb.drop_rate = 0.0
        if cfg.model.decode_head.type == 'SegmenterMaskTransformerHead':
            cfg.model.decode_head.drop_path_rate = 0.0
    return cfg


def phase_zoo_serve_f32(fa, which, path, image):
    """The zoo model in f32 at ZOO_F32_LAYERS layers on the card against
    the same seeded weights on the CPU, one 512² request; probabilities
    within TOL_MAIN_F32. Returns the card's launch counts."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = zoo_cfg(path, 'float32', ZOO_F32_LAYERS)
    p_cpu, cpu_s = cpu_half(f'zoo_serve_f32:{which}', [image])
    gpu = init_segmentor(cfg, seed=0, device='cuda')
    x, _ = _prepare_image(gpu, image)
    reset_counts(fa)                               # the main path starts
    p_gpu = gpu.probs(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    path_counts = counts(fa)                       # the main path ends
    check(p_gpu.shape == (1, 512, 512, 21), f'probs shape {p_gpu.shape}')
    check(torch.isfinite(p_gpu).all().item(), 'non-finite f32 probs')
    err = (p_gpu.cpu() - p_cpu).abs().max().item()
    agree = (p_gpu.cpu().argmax(-1) == p_cpu.argmax(-1)).float().mean()
    emit({'phase': f'{which}_serve_f32_vs_cpu',
          'config': os.path.basename(path),
          'cut': f'num_layers -> {ZOO_F32_LAYERS}, out_indices '
                 f'{tuple(cfg.model.backbone.out_indices)}',
          'probs_max_abs_err': err, 'tol': TOL_MAIN_F32,
          'argmax_agreement': agree.item(), 'cpu_forward_s': cpu_s,
          'launches': path_counts})
    check(path_counts == dict({n: 0 for n in KERNELS},
                              flash_attn_fwd=ZOO_F32_LAYERS),
          f'{which} f32 request launched {path_counts}')
    check(err <= TOL_MAIN_F32, f'{which} f32 card vs CPU probs differ by '
          f'{err}')
    del gpu
    torch.cuda.empty_cache()
    return path_counts


def cpu_zoo_serve_f32(fa, which, images, root):
    """``phase_zoo_serve_f32``'s CPU request of ``images[0]``:
    (probabilities, seconds)."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    cpu = init_segmentor(zoo_cfg(zoo_config(root, which), 'float32',
                                 ZOO_F32_LAYERS), seed=0, device='cpu')
    x, _ = _prepare_image(cpu, images[0])
    t0 = time.perf_counter()
    p_cpu = cpu.probs(torch.from_numpy(x))
    return p_cpu, time.perf_counter() - t0


def phase_zoo_serve_bf16(fa, which, path, images, gpu_line):
    """The zoo model at full depth in bf16 through ``init_segmentor`` and
    ``inference_segmentor``: one request a fixture JPEG (padded to 512²),
    each launching kernel #1 once a layer. Returns the launch counts."""
    import numpy as np
    import torch
    from PIL import Image
    from s4former_tpu_torch.apis import inference_segmentor, init_segmentor
    seg = init_segmentor(path, seed=0, device='cuda')
    layers = len(seg.model.backbone.layers)
    inference_segmentor(seg, images[0])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    reset_counts(fa)                               # the main path starts
    for img in images:
        with Image.open(img) as im:
            hw = (im.height, im.width)
        before = fa.launch_count
        t0 = time.perf_counter()
        labels = inference_segmentor(seg, img)    # ends in a device->host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
        n = fa.launch_count - before
        check(n == layers, f'{which} request launched the kernel {n} times, '
              f'not {layers}')
        check(labels.shape == hw and labels.min() >= 0 and labels.max() < 21,
              f'bad label map for {img}')
    path_counts = counts(fa)                       # the main path ends
    lat = np.asarray(latencies)
    emit({'phase': f'{which}_serve_bf16', 'config': os.path.basename(path),
          'layers': layers, 'heads': seg.model.backbone.num_heads,
          'requests': len(images),
          'request_ms': [round(t, 3) for t in latencies],
          'request_ms_mean': float(lat.mean()),
          'request_ms_p50': float(np.median(lat)),
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'launches': path_counts, 'gpu': gpu_line})
    check(path_counts == dict({n: 0 for n in KERNELS},
                              flash_attn_fwd=layers * len(images)),
          f'{which} serving launched {path_counts}')
    del seg
    torch.cuda.empty_cache()
    return path_counts


def half_confident(max_prob):
    """A confidence threshold that leaves about half of the pixels of the
    teacher's max softmax ``max_prob`` confident, in the middle of the
    widest gap between neighbouring values of its middle fifth: the card's
    and the CPU's teacher then label the same pixels unless they differ
    by half that gap (at the median itself one pixel sits on the edge, and
    on a 32 x 32 head output one flip moves a loss by 0.2%)."""
    v = max_prob.flatten().sort().values
    lo, hi = int(0.4 * v.numel()), int(0.6 * v.numel())
    i = lo + int((v[lo + 1:hi + 1] - v[lo:hi]).argmax())
    return float((v[i] + v[i + 1]) / 2)


def cpu_zoo_train_f32(fa, which, images, root):
    """``phase_zoo_train_f32``'s threshold (``half_confident`` of the CPU
    teacher) and CPU step."""
    import torch
    batch = flagship_f32_batch(images)
    cfg = zoo_cfg(zoo_config(root, which), 'float32', ZOO_F32_LAYERS,
                  drop=False)
    state, _ = trainer_from_config(cfg, 'cpu')
    with torch.no_grad():
        t_logits = state.model.forward_decode_from_img(
            torch.from_numpy(batch['unsup_teacher_img']), train=False)
    threshold = half_confident(torch.softmax(t_logits.float(), -1).amax(-1))
    state, step = trainer_from_config(cfg, 'cpu', unsup_confidence=threshold)
    return threshold, one_step(fa, state, step, batch, 'cpu')


def phase_zoo_train_f32(fa, which, path, images):
    """One S4Former step of the zoo config in f32 at ZOO_F32_LAYERS layers,
    dropout and drop path at 0, 1 + 1 fixture images at 512², the same
    CutMix box and PatchShuffle permutation, on the card and on the CPU
    from the same seeded weights. The threshold (``half_confident``) makes
    about half of the CPU teacher's pixels confident, so pseudo-CE and NCR
    (and Segmenter's PASA) are live. Losses within TOL_TRAIN_F32 relative,
    updates within TOL_TRAIN_F32 of the largest CPU update. Returns the
    card's launches."""
    import numpy as np
    import torch
    from s4former_tpu_torch.semi.config import SemiConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threshold, (lc, dc, sc, cc) = cpu_half(f'zoo_train_f32:{which}', images)
    cfg = zoo_cfg(path, 'float32', ZOO_F32_LAYERS, drop=False)
    state, step = trainer_from_config(cfg, 'cuda', unsup_confidence=threshold)
    lg, dg, sg, cg = one_step(fa, state, step, flagship_f32_batch(images),
                              'cuda')
    del state, step
    want = predicted_launches(SemiConfig.from_model_cfg(cfg.model),
                              ZOO_F32_LAYERS)
    check(sorted(lg) == sorted(lc), 'log keys differ')
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc}
    scale = max(d.abs().max().item() for d in dc.values())
    upd_err = max((dg[n] - dc[n]).abs().max().item() for n in dc)
    emit({'phase': f'{which}_train_f32_vs_cpu',
          'config': os.path.basename(path),
          'cut': f'num_layers -> {ZOO_F32_LAYERS}, dropout and drop path 0',
          'batch': f'1 sup + 1 unsup at 512², unsup_confidence {threshold} '
                   f'(half of the teacher\'s pixels confident)',
          'mask_ratio': lc['mask_ratio'], 'losses_card': lg,
          'losses_cpu': lc, 'loss_rel_err': loss_err,
          'update_max_abs_err': upd_err, 'update_max_abs_cpu': scale,
          'tol': TOL_TRAIN_F32, 'card_step_s': sg, 'cpu_step_s': sc,
          'launches': cg, 'predicted_launches': want})
    check(cg == want, f'{which} f32 step launched {cg}, not {want}')
    check(not any(cc.values()), 'the CPU step reached a kernel')
    check(0 < lc['mask_ratio'] < 1, f'mask_ratio {lc["mask_ratio"]}')
    check(lc['unsup.loss_seg_unsup'] > 0 and lc['unsup.loss_ncr_unsup'] > 0,
          'the unsup losses are not live')
    check(all(np.isfinite(v) for v in lg.values()), 'non-finite losses')
    check(max(loss_err.values()) <= TOL_TRAIN_F32,
          f'{which} f32 losses, card vs CPU: {loss_err}')
    check(upd_err <= TOL_TRAIN_F32 * scale, f'{which} f32 parameter '
          f'updates differ by {upd_err} (max {scale})')
    return cg


def phase_zoo_train_bf16(fa, which, path, images, gpu_line):
    """The zoo config's step at full depth in bf16 (dropout and drop path
    as configured), 4 + 4 fixture images at 512²: the first step, 3 timed;
    peak memory; launches ``predicted_launches`` a step. Returns the
    counts of the 4 steps."""
    import numpy as np
    import torch
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.semi.config import SemiConfig
    cfg = Config.fromfile(path)
    state, step = trainer_from_config(cfg, 'cuda')
    layers = cfg.model.backbone.num_layers
    want = predicted_launches(SemiConfig.from_model_cfg(cfg.model), layers)
    batch = to_device(train_batch(images, 4, 4), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 4)
    path_counts = counts(fa)                       # the main path ends
    lg = floats(logs)
    emit({'phase': f'{which}_train_bf16', 'config': os.path.basename(path),
          'layers': layers, 'heads': cfg.model.backbone.num_heads,
          'batch': '4 + 4 at 512², bf16 backbone', 'first_step_ms': ms[0],
          'step_ms': ms[1:], 'step_ms_mean': float(np.mean(ms[1:])),
          'img_per_s': 8 / (np.mean(ms[1:]) / 1e3),
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'logs': lg, 'launches': path_counts,
          'predicted_launches_per_step': want, 'gpu': gpu_line})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check(path_counts == {k: 4 * v for k, v in want.items()},
          f'{which} bf16: 4 steps launched {path_counts}, not {want} a step')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def phase_mla_train_cli(fa, gpu_line, root, path):
    """``tools.train`` on the MLA config (ViT-L at full depth, bf16, seeded
    weights), 4 steps of 2 + 2 through the fixture pipelines, eval and a
    checkpoint at 4; the checkpoint holds ``neck.*``; ``tools.test`` on
    ``iter_4`` within TOL_MIOU of the in-loop mIoU. Launches: 72 forward +
    48 fused a step (PASA off: the sequential pass), 24 forward an eval
    flush. Returns the counts of both runs."""
    import numpy as np
    import torch
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    wd = os.path.join(root, 'mla_work')
    per_eval = zoo_cfg(path).model.backbone.num_layers * -(-16 // 4)
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    state = train_cli.main([path, '--work-dir', wd, '--max-iters', '4',
                            '--cfg-options', 'evaluation.interval=4',
                            'checkpoint_config.interval=4',
                            'log_config.interval=2',
                            'samples_per_gpu_sup=2',
                            'samples_per_gpu_unsup=2'])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)
    check(int(state.step) == 4, f'trained to step {int(state.step)}')
    del state
    torch.cuda.empty_cache()
    ckpt = os.path.join(wd, 'iter_4')
    saved = torch.load(os.path.join(ckpt, 'state.pt'), map_location='cpu',
                       weights_only=True, mmap=True)
    neck = sorted(k for k in saved['model'] if k.startswith('neck.'))
    del saved
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    reset_counts(fa)
    t0 = time.perf_counter()
    results = test_cli.main([path, ckpt])
    test_s = time.perf_counter() - t0
    test_counts = counts(fa)                       # the main path ends
    gap = abs(results['mIoU'] - val[4]['mIoU']) if 4 in val else None
    per_step = {'flash_attn_fwd': 72, 'flash_attn_bwd_fused': 48}
    emit({'phase': 'mla_train_cli', 'config': os.path.basename(path),
          'batch': '2 + 2 at 512², bf16 ViT-L, 24 layers',
          'losses': {r['step']: r['loss'] for r in train},
          'step_ms_windows': [r['step_ms'] for r in train],
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'eval_s': val.get(4, {}).get('eval_s'),
          'in_loop_miou_iter_4': val.get(4, {}).get('mIoU'),
          'test_miou': results['mIoU'], 'miou_gap': gap, 'tol': TOL_MIOU,
          'checkpoint_neck_tensors': len(neck), 'train_run_s': train_s,
          'test_run_s': test_s,
          'launches': {'train': train_counts, 'test': test_counts},
          'gpu': gpu_line})
    check([r['step'] for r in train] == [2, 4] and sorted(val) == [4],
          f'logged steps {[(r["prefix"], r["step"]) for r in records]}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(len(neck) == 24, f'the checkpoint holds {len(neck)} neck tensors')
    check(train_counts == dict(
        {n: 0 for n in KERNELS},
        flash_attn_fwd=4 * per_step['flash_attn_fwd'] + per_eval,
        flash_attn_bwd_fused=4 * per_step['flash_attn_bwd_fused']),
        f'4 steps + 1 eval launched {train_counts}')
    check(test_counts == dict({n: 0 for n in KERNELS},
                              flash_attn_fwd=per_eval),
          f'tools.test launched {test_counts}')
    check(gap <= TOL_MIOU, f'offline mIoU {results["mIoU"]} vs in-loop '
          f'{val[4]["mIoU"]}: {gap} > {TOL_MIOU}')
    shutil.rmtree(wd, ignore_errors=True)
    return add_counts(train_counts, test_counts)


def run_zoo(fa, images, gpu_line, root):
    """The ViT model-zoo slice: SETR-MLA (ViT-L at H = 16, no cls token)
    and Segmenter (ViT-B) through the serving and training entry points;
    prints 'zoo_seconds'. Returns the launch counts by path."""
    paths, seconds = {}, {}
    configs = {which: zoo_config(root, which) for which in ZOO_MODELS}
    phases = []
    for which, path in configs.items():
        phases += [
            (f'{which}_serve_f32', lambda w=which, p=path:
             phase_zoo_serve_f32(fa, w, p, images[0])),
            (f'{which}_serve_bf16', lambda w=which, p=path:
             phase_zoo_serve_bf16(fa, w, p, images, gpu_line)),
            (f'{which}_train_f32', lambda w=which, p=path:
             phase_zoo_train_f32(fa, w, p, images)),
            (f'{which}_train_bf16', lambda w=which, p=path:
             phase_zoo_train_bf16(fa, w, p, images, gpu_line))]
    phases.append(('mla_train_cli', lambda: phase_mla_train_cli(
        fa, gpu_line, root, configs['mla'])))
    for name, run in phases:
        t0 = time.perf_counter()
        paths[name] = run()
        seconds[name] = time.perf_counter() - t0
    emit({'phase': 'zoo_seconds', **seconds, 'total': sum(seconds.values())})
    return paths


# ------------------------------------------------------------ the CNN slice
# the ResNet bases of configs/_base_/models/ (ResNetV1c-50; -D8 but FPN)
CNN_MODELS = {'deeplabv3plus': 'deeplabv3plus_r50-d8.py',
              'pspnet': 'pspnet_r50-d8.py', 'fpn': 'fpn_r50.py',
              'ccnet': 'ccnet_r50-d8.py', 'icnet': 'icnet_r50-d8.py',
              'upernet_swin': 'upernet_swin.py', 'ocrnet': 'ocrnet_hr18.py',
              'bisenetv1': 'bisenetv1_r18-d32.py', 'bisenetv2': 'bisenetv2.py',
              'stdc': 'stdc.py', 'fast_scnn': 'fast_scnn.py',
              'cgnet': 'cgnet.py', 'erfnet': 'erfnet_fcn.py',
              'lraspp': 'lraspp_m-v3-d8.py'}
# the mixes' super-patch unit: a -D8 head undoes the PatchShuffle on its
# 1/8 map in blocks of PatchMix_N features, so the image's super-patches
# must be 8 * PatchMix_N pixels (at the default 16 the step fails on the
# shapes, in JAX as in the port); OCRNet's first stage undoes it on its
# 1/4 map (4), ERFNet's FCN head on its 1/2 map (2); no head of
# UPerNet-Swin or LR-ASPP undoes it (the default 16). The other real-time
# CNNs' decode heads read a 1/8 map (8)
CNN_PATCHSIZE = 8
PATCHSIZE = {'upernet_swin': 16, 'ocrnet': 4, 'erfnet': 2, 'lraspp': 16}
# the backbones put in DeepLabV3+'s place (``cnn_config``'s ``backbone``):
# ResNeXt-50 (32x4d) and ResNeSt-50 with their defaults and the -D8
# stages of the ResNetV1c they replace
CNN_BACKBONES = {'resnext': dict(type='ResNeXt', groups=32, base_width=4),
                 'resnest': dict(type='ResNeSt', stem_channels=64, radix=2,
                                 reduction_factor=4, avg_down_stride=True)}


def model_heads(model):
    """Every head config of a model config: the decode head (a cascade's
    stages) and the aux heads."""
    head = model['decode_head']
    return (list(head) if isinstance(head, (list, tuple)) else [head]) + \
        list(model.get('auxiliary_head') or [])


def cnn_config(root, which, backbone=None):
    """``setr_fixture_voc_mini_fullflag.py`` (the fixture run of
    ``..._MT_w_ours.py``: VOC fixture data, every S4Former flag) with its
    model replaced by that of ``configs/_base_/models/`` ``CNN_MODELS
    [which]`` (its segmentor type too: OCRNet's cascade), its backbone's
    keys updated by ``CNN_BACKBONES[backbone]`` if given, written to
    ``root`` as ``zoo_config`` writes its config: 21 classes on every
    head but STDC's 2-class ``STDCHead`` (trained on the 21-class labels with
    the cross-entropy, as JAX's step trains it), the mixes' ``patchsize``
    PATCHSIZE's (else CNN_PATCHSIZE). PASA stays on (the CNNs and Swin ignore
    the bias, as JAX's do; the PASA pass still runs, in the fused 2B batch),
    and PatchShuffle with CutMix, NCR and the EMA. The backbones compute in f32
    (JAX's have no dtype).
    Returns the path."""
    from s4former_tpu_torch.config import Config
    model = Config.fromfile(os.path.join(
        REPO, 'configs', '_base_', 'models', CNN_MODELS[which])).to_dict()[
            'model']
    for head in model_heads(model):
        if head['type'] != 'STDCHead':      # STDC's keeps its 2 classes
            head['num_classes'] = 21
    head = model['decode_head']
    over = dict(type=model['type'],
                backbone=dict(model['backbone'],
                              **CNN_BACKBONES.get(backbone, {}),
                              _delete_=True),
                decode_head=head if isinstance(head, list) else
                dict(head, _delete_=True),
                auxiliary_head=model.get('auxiliary_head') or [],
                patchsize=PATCHSIZE.get(which, CNN_PATCHSIZE))
    for key in ('neck', 'num_stages'):
        if key in model:
            over[key] = model[key]
    path = os.path.join(root, f'{backbone or which}_voc_mini_MT_w_ours.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{FULLFLAG!r}]\nmodel = {over!r}\n')
    return path


def conv_settings():
    """The cuDNN and matmul settings a phase ran under (the script turns
    TF32 off in its first f32 phase and leaves it off)."""
    import torch
    return {'tf32_matmul': torch.backends.cuda.matmul.allow_tf32,
            'tf32_cudnn': torch.backends.cudnn.allow_tf32,
            'cudnn_benchmark': torch.backends.cudnn.benchmark,
            'cudnn_deterministic': torch.backends.cudnn.deterministic}


def calibrate_bn(model, x):
    """Set each BN's running statistics to those of its input in one
    eval forward of ``x`` (a forward pre-hook writes them before the BN
    runs, so each sees the calibrated layers before it), as a trained
    model's statistics fit its data."""
    import torch
    from s4former_tpu_torch.models.decode_heads.setr_up import BatchNorm

    def pre(bn, args):
        v = args[0].float()
        dims = tuple(range(v.dim() - 1))
        bn.running_mean.copy_(v.mean(dims))
        bn.running_var.copy_(v.var(dims, unbiased=False))
    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()


def f32_config(root, which):
    """The config file of ``which``, written to ``root``: this slice's
    models by ``context_config``, 'resnext' and 'resnest' as DeepLabV3+'s
    backbone, the rest by ``cnn_config``."""
    if which == 'mobilenet_v2' or which in CONTEXT_HEADS:
        return context_config(root, which)
    if which in CNN_BACKBONES:
        return cnn_config(root, 'deeplabv3plus', which)
    return cnn_config(root, which)


def calibrates(which):
    """Whether ``which``'s f32 phases first set its BN statistics from
    their inputs (``calibrate_bn``): OCRNet's and REALTIME_CALIBRATE's."""
    return which == 'ocrnet' or which in REALTIME_CALIBRATE


def cpu_serve_f32(fa, which, images, root):
    """``phase_cnn_serve_f32``'s CPU request of ``images[0]``:
    (probabilities, seconds, the calibrated weights or None)."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    from s4former_tpu_torch.config import Config
    cpu = init_segmentor(Config.fromfile(f32_config(root, which)), seed=0,
                         device='cpu')
    x, _ = _prepare_image(cpu, images[0])
    weights = None
    if calibrates(which):
        calibrate_bn(cpu.model, torch.from_numpy(x))
        weights = cpu.model.state_dict()
    t0 = time.perf_counter()
    p_cpu = cpu.probs(torch.from_numpy(x))
    return p_cpu, time.perf_counter() - t0, weights


def phase_cnn_serve_f32(fa, which, root, image, name):
    """The config of ``which`` (``f32_config``) at full depth in f32 on the
    card against the same seeded weights on the CPU (``cpu_half``), one
    512² request; probabilities within TOL_MAIN_F32; no kernel launch.
    Where it ``calibrates``, the BN statistics are first set on the CPU
    from the request (``calibrate_bn``) and copied to the card. Returns
    the card's counts."""
    import torch
    from s4former_tpu_torch.apis import _prepare_image, init_segmentor
    from s4former_tpu_torch.config import Config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = f32_config(root, which)
    p_cpu, cpu_s, weights = cpu_half(f'serve_f32:{which}', [image], root)
    gpu = init_segmentor(Config.fromfile(path), seed=0, device='cuda')
    x, _ = _prepare_image(gpu, image)
    if weights is not None:
        gpu.model.load_state_dict(weights)
    reset_counts(fa)                               # the main path starts
    p_gpu = gpu.probs(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    path_counts = counts(fa)                       # the main path ends
    same = p_gpu.shape == p_cpu.shape == (1, 512, 512, 21)
    err = (p_gpu.cpu() - p_cpu).abs().max().item() if same else None
    agree = (p_gpu.cpu().argmax(-1) == p_cpu.argmax(-1)).float().mean() \
        .item() if same else None
    emit({'phase': name, 'config': os.path.basename(path),
          'probs_shape': list(p_gpu.shape), 'probs_max_abs_err': err,
          'tol': TOL_MAIN_F32, 'argmax_agreement': agree,
          'cpu_forward_s': cpu_s, 'settings': conv_settings(),
          'launches': path_counts})
    check(same, f'probs shapes {tuple(p_gpu.shape)}, {tuple(p_cpu.shape)}')
    check(torch.isfinite(p_gpu).all().item(), 'non-finite f32 probs')
    check(all_zero(path_counts), f'a CNN request launched {path_counts}')
    check(err <= TOL_MAIN_F32, f'{name}: f32 card vs CPU probs differ '
          f'by {err}')
    del gpu
    torch.cuda.empty_cache()
    return path_counts


def phase_cnn_serve(fa, path, images, gpu_line, name='cnn_serve'):
    """A CNN config through ``init_segmentor`` and ``inference_segmentor``:
    one request a fixture JPEG (padded to 512²) after a warm-up, each
    label map checked; no kernel launch. Returns the counts and the
    segmentor."""
    import numpy as np
    import torch
    from PIL import Image
    from s4former_tpu_torch.apis import inference_segmentor, init_segmentor
    seg = init_segmentor(path, seed=0, device='cuda')
    inference_segmentor(seg, images[0])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, bad = [], []
    reset_counts(fa)                               # the main path starts
    for img in images:
        with Image.open(img) as im:
            hw = (im.height, im.width)
        t0 = time.perf_counter()
        labels = inference_segmentor(seg, img)    # ends in a device->host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
        if not (labels.shape == hw and labels.min() >= 0 and
                labels.max() < 21):
            bad.append(os.path.basename(img))
    path_counts = counts(fa)                       # the main path ends
    lat = np.asarray(latencies)
    emit({'phase': name, 'config': os.path.basename(path),
          'requests': len(images),
          'request_ms': [round(t, 3) for t in latencies],
          'request_ms_mean': float(lat.mean()),
          'request_ms_p50': float(np.median(lat)),
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'bad_label_maps': bad, 'settings': conv_settings(),
          'launches': path_counts, 'gpu': gpu_line})
    check(not bad, f'bad label maps for {bad}')
    check(all_zero(path_counts), f'CNN serving launched {path_counts}')
    return path_counts, seg


# the f32 step runs twice. Through ResNet-50's ~50 train-mode BN + ReLU
# pairs two f32 sum orders put a ReLU input that sits within rounding of 0
# on either side, and its BN's backward spreads the change over its
# channel (seen on the CPU, tests/test_torch_cnn_step.py): the card's and
# the CPU's updates of the stem and layer1 part by ~2e-2 of the largest
# update, and so do the CPU's own on inputs moved by one f32 ulp
# (``ulp_moved``). So at depth 50 (at CNN_WITNESS_SIZE², where the CPU's
# two steps take ~4 s each, not ~18 s as at 512²) each parameter's
# card-vs-CPU distance is held to CNN_WITNESS_MULT x that witness's
# distance (or TOL_TRAIN_F32 of the largest update), and at
# ResNetV1c-CNN_F32_DEPTH and 512², where card and CPU agree to 1.4e-4,
# every update is held to TOL_TRAIN_F32 of the largest.
CNN_F32_DEPTH = 18
CNN_WITNESS_SIZE = 256
CNN_WITNESS_MULT = 4


def cnn_f32_cfg(path, depth=None):
    """The config (DeepLabV3+'s at ResNetV1c-``depth``: below 50 the heads'
    inputs narrowed to its stages, BasicBlocks keep their width), every
    head's dropout at 0."""
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(path)
    heads = model_heads(cfg.model)
    if depth is not None and depth < 50:
        cfg.model.backbone.depth = depth
        base = cfg.model.backbone.get('base_channels', 64)
        widths = [base * 2 ** i for i in range(4)]   # BasicBlock stages
        cfg.model.decode_head.in_channels = widths[3]
        cfg.model.decode_head.c1_in_channels = widths[0]
        for head in heads[1:]:
            head.in_channels = widths[head.in_index]
    for head in heads:
        head.dropout_ratio = 0.0
    return cfg


def cnn_f32_batch(images, size=512, patchsize=CNN_PATCHSIZE):
    """1 + 1 fixture images at size², a CutMix box (rows 3/16-11/16,
    columns 1/4-5/8) and a seeded PatchShuffle permutation of the
    super-patches of ``patchsize`` * PatchMix_N (8) pixels (``dbg_*``)."""
    import numpy as np
    batch = train_batch(images, 1, 1, size)
    mask = np.ones((1, size, size), np.float32)
    mask[0, size * 3 // 16:size * 11 // 16, size // 4:size * 5 // 8] = 0
    batch['dbg_cutmix_mask'] = mask
    grid = size // (patchsize * 8)                 # PatchMix_N 8
    batch['dbg_patchmix_perm'] = np.random.RandomState(0).permutation(
        grid * grid)[None].astype(np.int32)
    return batch


def ulp_moved(batch):
    """``batch`` with every image value moved one f32 ulp up or down
    (seeded)."""
    import numpy as np
    rs = np.random.RandomState(0)
    out = dict(batch)
    for k in ('sup_img', 'unsup_teacher_img', 'unsup_student_img'):
        x = batch[k]
        to = np.where(rs.rand(*x.shape) < 0.5, -np.inf, np.inf)
        out[k] = np.nextafter(x, to.astype(np.float32))
    return out


def cnn_f32_threshold(cfg, batch, weights=None):
    """``half_confident`` of the CPU's teacher on the batch (from
    ``weights`` if given): the card's step takes the CPU teacher's logits
    (``teacher_hook``, pinned), so the CPU's labels are the ones that
    count."""
    import torch
    state, _ = trainer_from_config(cfg, 'cpu', weights=weights)
    with torch.no_grad():
        t_logits = state.model.forward_decode_from_img(
            torch.from_numpy(batch['unsup_teacher_img']), train=False)
    return half_confident(torch.softmax(t_logits.float(), -1).amax(-1))


def cnn_f32_step(fa, cfg, batch, threshold, device, hook, weights=None,
                 buffers=()):
    """One step of ``cfg`` from the seeded weights (or ``weights``) on
    ``device`` under the teacher hook ``hook()``: (logs, the updates of
    the parameters and of the state-dict entries ``buffers``, on the CPU,
    seconds, launch counts)."""
    import torch
    state, step = trainer_from_config(cfg, device, weights=weights,
                                      unsup_confidence=threshold)
    before = {n: p.detach().cpu().clone()
              for n, p in state.model.named_parameters()}
    before.update({n: state.model.state_dict()[n].cpu().clone()
                   for n in buffers})
    dev_batch = to_device(batch, device)
    unhook = hook()
    reset_counts(fa)
    t0 = time.perf_counter()
    try:
        state, logs = step(state, dev_batch,
                           torch.Generator(device=device).manual_seed(0))
        if device == 'cuda':
            torch.cuda.synchronize()
    finally:
        unhook()
    seconds = time.perf_counter() - t0
    delta = {n: p.detach().cpu() - before[n]
             for n, p in state.model.named_parameters()}
    sd = state.model.state_dict()
    delta.update({n: sd[n].cpu() - before[n] for n in buffers})
    launches = counts(fa)
    del state, step, dev_batch
    torch.cuda.empty_cache()
    return floats(logs), delta, seconds, launches


def witness_case(which, root, images):
    """(cfg, batch, calibrate, buffers) of ``which``'s 1 + 1 step at
    CNN_WITNESS_SIZE² (``f32_step_vs_witness``): its config written to
    ``root`` (``f32_config``), every head's dropout 0 (ERFNet's
    backbone's too), the mixes' super-patches of its ``patchsize``; its BN
    statistics set from the batch where it ``calibrates``; EMANet's
    ``bases`` held too."""
    cfg = cnn_f32_cfg(f32_config(root, which))
    if which in REALTIME and 'dropout_ratio' in cfg.model.backbone:
        cfg.model.backbone.dropout_ratio = 0.0            # ERFNet's
    batch = cnn_f32_batch(images, CNN_WITNESS_SIZE, cfg.model.patchsize)
    buffers = (EMA_BASES,) if which == 'emanet' else ()
    return cfg, batch, calibrates(which), buffers


def cpu_witness(fa, which, images, root):
    """The CPU's half of ``f32_step_vs_witness`` for ``which``: the
    calibrated weights (or None), the threshold (``cnn_f32_threshold``),
    the CPU's step (its teacher's logits recorded) and the witness's (the
    CPU step on ``ulp_moved`` inputs, its teacher pinned to the CPU's)."""
    import numpy as np
    import torch
    cfg, batch, calibrate, buffers = witness_case(which, root, images)
    weights = None
    if calibrate:
        from s4former_tpu_torch.apis import init_segmentor
        model = init_segmentor(cfg, seed=0, device='cpu').model
        calibrate_bn(model, torch.from_numpy(np.concatenate(
            [batch['sup_img'], batch['unsup_teacher_img']])))
        weights = model.state_dict()
    threshold = cnn_f32_threshold(cfg, batch, weights)
    record, stats_w = [], []
    cpu = cnn_f32_step(fa, cfg, batch, threshold, 'cpu',
                       lambda: teacher_hook(record=record), weights, buffers)
    wit = cnn_f32_step(
        fa, cfg, ulp_moved(batch), threshold, 'cpu',
        lambda: teacher_hook(reference=record, pin=True, stats=stats_w),
        weights, buffers)
    return {'weights': weights, 'threshold': threshold, 'record': record,
            'cpu': cpu, 'wit': wit, 'stats_w': stats_w}


def f32_step_vs_witness(fa, which, root, images):
    """One S4Former step of ``which`` (``witness_case``, f32) from the
    seeded weights on the CPU, again on the CPU on ``ulp_moved`` inputs
    (the witness), both from ``cpu_half``, and on the card, the teacher
    of each pinned to the CPU's (``teacher_hook``), the threshold
    ``half_confident`` of the CPU's teacher. Where the case calibrates,
    the weights' BN statistics are first set on the CPU from the batch's
    sup and teacher images (``calibrate_bn``), the same for every step.
    Its ``buffers`` (state-dict keys, EMAHead's ``bases``): each one's
    change in the step, card against CPU, within CNN_WITNESS_MULT x the
    witness's distance or TOL_TRAIN_F32 of the CPU's largest change, and
    moved by the card's step. Returns the line's fields and the launches
    of the three steps; ``check_witness`` holds them."""
    import torch
    cfg, batch, _, buffers = witness_case(which, root, images)
    half = cpu_half(f'witness:{which}', images, root)
    threshold, record = half['threshold'], half['record']
    stats, stats_w = [], half['stats_w']
    (lc, dc, sc, cc), (lw, dw, sw, cw) = half['cpu'], half['wit']
    lg, dg, sg, cg = cnn_f32_step(
        fa, cfg, batch, threshold, 'cuda',
        lambda: teacher_hook(reference=record, pin=True, stats=stats),
        half['weights'], buffers)
    kept = {}
    for n in buffers:
        card, cpu, wit = dg.pop(n), dc.pop(n), dw.pop(n)
        kept[n] = {'err': (card - cpu).abs().max().item(),
                   'allowed': max(
                       CNN_WITNESS_MULT * (wit - cpu).abs().max().item(),
                       TOL_TRAIN_F32 * cpu.abs().max().item()),
                   'moved': card.abs().max().item()}
    scale = max(d.abs().max().item() for d in dc.values())
    leaves = []
    for n in dc:
        err = (dg[n] - dc[n]).abs().max().item()
        wit = (dw[n] - dc[n]).abs().max().item()
        leaves.append((err / max(CNN_WITNESS_MULT * wit,
                                 TOL_TRAIN_F32 * scale), n, err, wit,
                       dc[n].abs().max().item()))
    leaves.sort()
    return {
        'batch': f'1 sup + 1 unsup at {batch["sup_img"].shape[1]}², '
                 f'unsup_confidence {threshold}',
        'mask_ratio': lc.get('mask_ratio'), 'losses_card': lg,
        'losses_cpu': lc,
        'loss_rel_err': {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6)
                         for k in lc if k in lg},
        'update_max_abs_cpu': scale, 'witness_mult': CNN_WITNESS_MULT,
        # (err / allowed, name, |card - CPU|, |witness - CPU|, largest CPU
        #  update of the parameter)
        'update_err_worst': leaves[-4:],
        'update_err_abs_max': max(r[2] for r in leaves),
        'witness_abs_max': max(r[3] for r in leaves),
        'teacher_pinned': stats, 'witness_teacher': stats_w,
        # the CPU teacher's max probabilities within 1e-6 of the threshold:
        # pixels whose confidence the devices' softmaxes may put on either
        # side of it, pinned logits or not
        'teacher_near_threshold': sum(
            int(((torch.softmax(t, -1).amax(-1) - threshold).abs() < 1e-6)
                .sum()) for t in record),
        'card_step_s': sg, 'cpu_step_s': sc, 'witness_step_s': sw,
        'buffers': kept,
        'log_keys_same': sorted(lg) == sorted(lc)}, (cg, cc, cw)


# ------------------------------------------------------------ the CPU side
# The f32 phases' CPU halves (the CPU's steps, requests and head runs, and
# the one-ulp witnesses) read nothing that the card computes. ``main``
# starts a second process, ``chip_smoke.py --cpu-side DIR`` (``cpu_side``),
# at nice CPU_SIDE_NICE on CPU_SIDE_THREADS threads and without the card,
# that computes them in the order the phases take them (``cpu_jobs``)
# while this process drives the card; a phase takes its half with
# ``cpu_half``. Without it (a phase run alone) the half runs here.
CPU_SIDE_THREADS = 4
CPU_SIDE_NICE = 19
CPU_SIDE = None


def cpu_jobs():
    """Every CPU half, in the order ``main`` takes them."""
    return (['main_f32', 'train_f32', 'mit_serve_f32', 'mit_train_f32']
            + [f'{kind}:{which}' for which in ZOO_MODELS
               for kind in ('zoo_serve_f32', 'zoo_train_f32')]
            + ['serve_f32:deeplabv3plus', 'cnn_f32', 'witness:deeplabv3plus',
               'serve_f32:resnext', 'serve_f32:resnest']
            + [f'{kind}:{which}' for which in SWIN_HRNET + REALTIME +
               ('mobilenet_v2',) for kind in ('serve_f32', 'witness')]
            + [job for which in CONTEXT_HEADS for job in
               [f'head:{which}'] + (['witness:emanet']
                                    if which == 'emanet' else [])]
            + ['ablation_f32']
            + [f'unimatch:{name}' for name in UNIMATCH_F32_CASES])


def run_cpu_job(name, images, root):
    """The CPU half ``name`` (a ``cpu_jobs`` entry), its configs and files
    written to ``root``."""
    from s4former_tpu_torch.ops import flash_attention as fa
    kind, _, which = name.partition(':')
    if which:
        job = {'zoo_serve_f32': cpu_zoo_serve_f32,
               'zoo_train_f32': cpu_zoo_train_f32,
               'serve_f32': cpu_serve_f32, 'witness': cpu_witness,
               'head': cpu_head, 'unimatch': cpu_unimatch}[kind]
        return job(fa, which, images, root)
    job = {'main_f32': cpu_main_f32, 'train_f32': cpu_train_f32,
           'mit_serve_f32': cpu_mit_serve_f32,
           'mit_train_f32': cpu_mit_train_f32, 'cnn_f32': cpu_cnn_f32,
           'ablation_f32': cpu_ablation_f32}[kind]
    return job(fa, images, root)


def job_file(name):
    return name.replace(':', '_') + '.pt'


def cpu_half(name, images, root=None):
    """The CPU half ``name``: from the CPU side if it runs (waiting for
    it), else computed here (``images`` and ``root`` as the phase has
    them; a temporary directory for ``root`` if None)."""
    if CPU_SIDE is not None:
        return CPU_SIDE.get(name)
    if root is not None:
        return run_cpu_job(name, images, root)
    with tempfile.TemporaryDirectory() as tmp:
        return run_cpu_job(name, images, tmp)


def cpu_side(directory):
    """The CPU side's process: each of ``cpu_jobs`` in turn on the fixture
    images, its configs and files in a subdirectory of ``directory``, its
    result saved to ``directory`` (written under another name, then
    renamed) and a line of its seconds printed."""
    import torch
    os.nice(CPU_SIDE_NICE)
    torch.set_num_threads(CPU_SIDE_THREADS)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    images = sorted(glob.glob(IMAGES))
    root = os.path.join(directory, 'work')
    os.makedirs(root)
    for name in cpu_jobs():
        t0 = time.perf_counter()
        result = run_cpu_job(name, images, root)
        path = os.path.join(directory, job_file(name))
        torch.save(result, path + '.tmp')
        os.replace(path + '.tmp', path)
        print(json.dumps({'job': name, 'seconds': time.perf_counter() - t0}),
              flush=True)
    return 0


class CpuSide:
    """The running CPU side (``cpu_side``) on ``directory``: ``get`` waits
    for a half and loads it (its file then goes), ``waited`` keeps how
    long each wait took, ``close`` ends the process."""

    def __init__(self, directory):
        self.dir = directory
        self.log = os.path.join(directory, 'cpu_side.log')
        with open(self.log, 'w') as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--cpu-side',
                 directory], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
        self.waited = {}

    def get(self, name):
        import torch
        path = os.path.join(self.dir, job_file(name))
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                with open(self.log) as f:
                    tail = f.read()[-6000:]
                raise SmokeFailure(f'the CPU side exited with '
                                   f'{self.proc.returncode} before {name}:'
                                   f'\n{tail}')
            time.sleep(0.02)
        self.waited[name] = time.perf_counter() - t0
        out = torch.load(path, weights_only=False)
        os.remove(path)
        return out

    def job_seconds(self):
        with open(self.log) as f:
            return {r['job']: r['seconds'] for r in map(json.loads, f)
                    if 'job' in r}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def check_witness(name, r, launches):
    """``f32_step_vs_witness``'s bounds: the same log keys, live unsup
    losses, finite losses within TOL_TRAIN_F32 relative, every parameter
    within its allowed distance, no kernel launch."""
    import numpy as np
    lc = r['losses_cpu']
    check(r['log_keys_same'], f'{name}: log keys differ')
    check(all(all_zero(c) for c in launches), f'{name} launched {launches}')
    check(0 < lc['mask_ratio'] < 1, f'{name}: mask_ratio {lc["mask_ratio"]}')
    check(lc['unsup.loss_seg_unsup'] > 0 and lc['unsup.loss_ncr_unsup'] > 0
          and lc['unsup.loss_seg_unsup_attn_mask'] > 0,
          f'{name}: the unsup losses are not live')
    check(all(np.isfinite(v) for v in r['losses_card'].values()),
          f'{name}: non-finite losses')
    check(max(r['loss_rel_err'].values()) <= TOL_TRAIN_F32,
          f'{name}: f32 losses, card vs CPU: {r["loss_rel_err"]}')
    check(r['update_err_worst'][-1][0] <= 1, f'{name}: f32 updates beyond '
          f'the witness: {r["update_err_worst"]}')
    for key, b in r['buffers'].items():
        check(b['err'] <= b['allowed'] and b['moved'] > 0,
              f'{name}: {key} after the step, card vs CPU: {b}')


def cpu_cnn_f32(fa, images, root):
    """``phase_cnn_train_f32``'s CPU step at ResNetV1c-CNN_F32_DEPTH:
    (threshold, the teacher's logits, the step)."""
    cfg = cnn_f32_cfg(cnn_config(root, 'deeplabv3plus'), CNN_F32_DEPTH)
    batch = cnn_f32_batch(images)
    threshold = cnn_f32_threshold(cfg, batch)
    record = []
    cpu = cnn_f32_step(fa, cfg, batch, threshold, 'cpu',
                       lambda: teacher_hook(record=record))
    return threshold, record, cpu


def phase_cnn_train_f32(fa, path, images):
    """One S4Former step of DeepLabV3+ in f32, 1 + 1 fixture images,
    dropout 0, the same CutMix box and PatchShuffle permutation, on the CPU
    (``cpu_half``) and on the card from the same seeded weights. The
    threshold (``half_confident``, from the CPU's teacher) leaves about
    half of the teacher's pixels confident, so pseudo-CE, NCR and the PASA
    pass are live; the card's step takes the CPU teacher's logits
    (``teacher_hook``, pinned: its labels, mask and bias are the CPU's;
    the labels its own logits would give are counted). At
    ResNetV1c-CNN_F32_DEPTH and 512²: losses within TOL_TRAIN_F32
    relative, updates within TOL_TRAIN_F32 of the largest CPU update. At
    ResNetV1c-50 (full depth) and CNN_WITNESS_SIZE²: losses as before, and
    every parameter's update within CNN_WITNESS_MULT x the witness's
    distance from the CPU's (the CPU step on ``ulp_moved`` inputs, the
    teacher pinned to the CPU's) or TOL_TRAIN_F32 of the largest CPU
    update. No kernel launch. Returns the card's counts."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cnn_f32_cfg(path, CNN_F32_DEPTH)
    batch = cnn_f32_batch(images)
    root = os.path.dirname(path)
    threshold, record, (lc, dc, sc, cc) = cpu_half('cnn_f32', images, root)
    stats = []
    lg, dg, sg, cg = cnn_f32_step(
        fa, cfg, batch, threshold, 'cuda',
        lambda: teacher_hook(reference=record, pin=True, stats=stats))
    same_keys = sorted(lg) == sorted(lc)
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc
                if k in lg}
    scale = max(d.abs().max().item() for d in dc.values())
    by_param = sorted(((dg[n] - dc[n]).abs().max().item(), n) for n in dc)
    upd_err = by_param[-1][0]

    # ResNetV1c-50 against the witness
    depth50, launches50 = f32_step_vs_witness(fa, 'deeplabv3plus', root,
                                              images)
    emit({'phase': 'cnn_train_f32_vs_cpu', 'config': os.path.basename(path),
          'cut': f'ResNetV1c-{CNN_F32_DEPTH}, dropout 0',
          'batch': f'1 sup + 1 unsup at 512², unsup_confidence {threshold} '
                   f'(half of the teacher\'s pixels confident)',
          'mask_ratio': lc.get('mask_ratio'), 'losses_card': lg,
          'losses_cpu': lc, 'loss_rel_err': loss_err,
          'update_max_abs_err': upd_err, 'update_max_abs_cpu': scale,
          'update_err_largest': by_param[-3:], 'tol': TOL_TRAIN_F32,
          'teacher_pinned': stats,
          'card_step_s': sg, 'cpu_step_s': sc, 'depth50': depth50,
          'settings': conv_settings(),
          'launches': add_counts(cg, launches50[0])})
    check(same_keys, f'log keys differ: {sorted(lg)} vs {sorted(lc)}')
    check(all_zero(cg) and all_zero(cc), f'a CNN step launched {cg}, {cc}')
    check(0 < lc['mask_ratio'] < 1, f'mask_ratio {lc["mask_ratio"]}')
    check(lc['unsup.loss_seg_unsup'] > 0 and lc['unsup.loss_ncr_unsup'] > 0
          and lc['unsup.loss_seg_unsup_attn_mask'] > 0,
          'the unsup losses are not live')
    check(all(np.isfinite(v) for v in lg.values()), 'non-finite losses')
    check(max(loss_err.values()) <= TOL_TRAIN_F32,
          f'DeepLabV3+ f32 losses, card vs CPU: {loss_err}')
    check(upd_err <= TOL_TRAIN_F32 * scale, f'DeepLabV3+ f32 parameter '
          f'updates differ by {upd_err} (max {scale})')
    check_witness('ResNetV1c-50 DeepLabV3+', depth50, launches50)
    return add_counts(cg, launches50[0])


def phase_cnn_train(fa, path, images, gpu_line, n=4, timed=3,
                    name='cnn_train', cover=False, moved=()):
    """The config's step (DeepLabV3+'s) at full depth, f32, dropout as
    configured, ``n`` + ``n`` fixture images at 512² (``cover``: scaled to
    cover it, ``fixture_arrays``): the first step, ``timed`` timed; peak
    memory; finite logs; no kernel launch; each buffer of ``moved`` (a
    state-dict key) changed by the steps. Returns the counts of the
    steps."""
    import numpy as np
    import torch
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    cfg = Config.fromfile(path)
    state, step = trainer_of(init_segmentor(cfg, seed=0,
                                            device='cuda').model, cfg)
    batch = to_device(train_batch(images, n, n, cover=cover), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = {k: state.model.state_dict()[k].clone() for k in moved}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, 1 + timed)
    path_counts = counts(fa)                       # the main path ends
    lg = floats(logs)
    shift = {k: (state.model.state_dict()[k] - v).abs().max().item()
             for k, v in before.items()}
    emit({'phase': name, 'config': os.path.basename(path),
          'moved': shift,
          'batch': f'{n} + {n} at 512²' + (', scaled to cover it' if cover
                                           else '') + ', f32',
          'first_step_ms': ms[0],
          'step_ms': ms[1:], 'step_ms_mean': float(np.mean(ms[1:])),
          'img_per_s': 2 * n / (np.mean(ms[1:]) / 1e3),
          'peak_mem_bytes': torch.cuda.max_memory_allocated(),
          'logs': lg, 'settings': conv_settings(), 'launches': path_counts,
          'gpu': gpu_line})
    check(all(np.isfinite(v) for v in lg.values()), f'non-finite logs {lg}')
    check(all_zero(path_counts), f'{name} launched {path_counts}')
    check(all(v > 0 for v in shift.values()), f'{name}: unmoved {shift}')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def phase_cnn_bases(fa, root, images, gpu_line):
    """PSPNet, FPN, CCNet and ICNet at full width (their base models in the
    fixture config, as ``cnn_config`` writes them): one request each
    through ``inference_segmentor`` after a warm-up, then one 2 + 2 step
    at 512² from the served weights; finite losses, step ms, peak memory;
    no kernel launch. Returns the counts."""
    import numpy as np
    import torch
    from PIL import Image
    from s4former_tpu_torch.apis import inference_segmentor, init_segmentor
    from s4former_tpu_torch.config import Config
    batch = to_device(train_batch(images, 2, 2), 'cuda')
    results, total = {}, {n: 0 for n in KERNELS}
    for which in ('pspnet', 'fpn', 'ccnet', 'icnet'):
        path = cnn_config(root, which)
        cfg = Config.fromfile(path)
        seg = init_segmentor(cfg, seed=0, device='cuda')
        inference_segmentor(seg, images[0])      # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)                           # the main path starts
        t0 = time.perf_counter()
        labels = inference_segmentor(seg, images[1])
        request_ms = (time.perf_counter() - t0) * 1e3
        with Image.open(images[1]) as im:
            hw = [im.height, im.width]
        state, step = trainer_of(seg.model, cfg)
        gen = torch.Generator(device='cuda').manual_seed(0)
        state, logs, ms = timed_steps(state, step, batch, gen, 1)
        path_counts = counts(fa)                   # the main path ends
        results[which] = {
            'request_ms': request_ms, 'label_shape': list(labels.shape),
            'image_hw': hw,
            'labels_in_range': bool(labels.min() >= 0 and
                                    labels.max() < 21),
            'step_ms': ms[0], 'logs': floats(logs),
            'peak_mem_bytes': torch.cuda.max_memory_allocated(),
            'parameters': sum(p.numel() for p in seg.model.parameters()),
            'launches': path_counts}
        total = add_counts(total, path_counts)
        del seg, state, step
        torch.cuda.empty_cache()
    emit({'phase': 'cnn_bases', 'batch': '2 + 2 at 512², f32, one step '
          '(its first: cuDNN picks its algorithms in it)',
          'models': results, 'settings': conv_settings(), 'gpu': gpu_line})
    for which, r in results.items():
        check(r['label_shape'] == r['image_hw'] and r['labels_in_range'],
              f'{which}: bad label map {r["label_shape"]}')
        check(all(np.isfinite(v) for v in r['logs'].values()),
              f'{which}: non-finite logs {r["logs"]}')
        check(all_zero(r['launches']), f'{which} launched {r["launches"]}')
    return total


def phase_cnn_train_cli(fa, gpu_line, root, path, name='cnn_train_cli',
                        bn_buffers=110, resume=False):
    """``tools.train`` on the config (DeepLabV3+'s: ResNetV1c-50 at full
    depth, f32, seeded weights), 2 steps of 2 + 2 through the fixture
    pipelines, eval and a checkpoint at 2 (with ``resume`` then
    ``--auto-resume`` to 3); the checkpoint holds the backbone's
    ``bn_buffers`` BN statistics (student and teacher), and the model that
    ``tools.test``'s loader (``init_segmentor``) builds from it holds every
    parameter and buffer of the trained student bit for bit; ``tools.test
    --out`` on ``iter_2`` gives the label maps that the in-loop eval's
    ``iter_predictions`` gives on the trained student, bit for bit, and
    an mIoU within TOL_MIOU of the in-loop one (a seeded model's mIoU is
    near 0, so that check alone would pass a wrong checkpoint); no kernel
    launch. Returns the counts of both runs."""
    import pickle

    import numpy as np
    import torch
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import iter_predictions
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.tools import test as test_cli
    from s4former_tpu_torch.tools import train as train_cli
    wd = os.path.join(root, f'{name}_work')
    opts = ['--cfg-options', 'evaluation.interval=2',
            'checkpoint_config.interval=2', 'log_config.interval=1',
            'samples_per_gpu_sup=2', 'samples_per_gpu_unsup=2']
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    state = train_cli.main([path, '--work-dir', wd, '--max-iters', '2'] +
                           opts)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts(fa)
    steps = int(state.step)
    ckpt = os.path.join(wd, 'iter_2')
    cfg = Config.fromfile(path)
    test_cfg = cfg.model.get('test_cfg') or {}
    dataset = build_dataset(cfg.data['test'])
    with torch.no_grad():
        trained_maps = dict(iter_predictions(
            state.model, dataset, mode=test_cfg.get('mode', 'whole'),
            crop_size=tuple(test_cfg.get('crop_size',
                                         cfg.get('crop_size', (512, 512)))),
            stride=tuple(test_cfg.get('stride', (341, 341)))))
    trained = state.model.state_dict()
    loaded = init_segmentor(cfg, checkpoint=ckpt, device='cuda').model \
        .state_dict()
    differ = sorted(k for k in trained if k not in loaded or
                    not torch.equal(trained[k], loaded[k]))
    n_tensors = len(trained)
    del state, trained, loaded
    torch.cuda.empty_cache()
    saved = torch.load(os.path.join(ckpt, 'state.pt'), map_location='cpu',
                       weights_only=True, mmap=True)
    bn = {part: sum(1 for k in saved[part] if k.startswith('backbone.') and
                    k.endswith(('running_mean', 'running_var')))
          for part in ('model', 'ema_model')}
    del saved
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    train = [r for r in records if r['prefix'] == 'train']
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    out = os.path.join(root, f'{name}_test_preds.pkl')
    reset_counts(fa)
    t0 = time.perf_counter()
    results = test_cli.main([path, ckpt, '--out', out])
    test_s = time.perf_counter() - t0
    test_counts = counts(fa)
    resumed = None
    if resume:
        resumed = int(train_cli.main([path, '--work-dir', wd,
                                      '--auto-resume', '--max-iters', '3'] +
                                     opts).step)
        test_counts = add_counts(test_counts, counts(fa))
    log = read_logs(wd)                            # the main path ends
    with open(out, 'rb') as f:
        offline = pickle.load(f)
    maps_differ = [i for i, m in enumerate(offline)
                   if not np.array_equal(m, trained_maps.get(i))]
    classes = sorted({int(c) for m in offline for c in np.unique(m)})
    gap = abs(results['mIoU'] - val[2]['mIoU']) if 2 in val else None
    emit({'phase': name, 'config': os.path.basename(path),
          'batch': '2 + 2 at 512², f32', 'steps': steps,
          'resumed_to': resumed, 'losses': {r['step']: r['loss'] for r in train},
          'step_ms_windows': [r['step_ms'] for r in train],
          'data_wait_ms_windows': [r['data_wait_ms'] for r in train],
          'eval_s': val.get(2, {}).get('eval_s'),
          'in_loop_miou_iter_2': val.get(2, {}).get('mIoU'),
          'in_loop_aacc_iter_2': val.get(2, {}).get('aAcc'),
          'test_miou': results['mIoU'], 'test_aacc': results['aAcc'],
          'miou_gap': gap, 'tol': TOL_MIOU,
          'loaded_tensors_differing': differ, 'tensors': n_tensors,
          'label_maps': len(offline), 'label_maps_differing': maps_differ,
          'classes_predicted': classes,
          'checkpoint_backbone_bn_buffers': bn, 'train_run_s': train_s,
          'test_run_s': test_s, 'settings': conv_settings(),
          'launches': {'train': train_counts, 'test': test_counts},
          'gpu': gpu_line})
    check(steps == 2, f'trained to step {steps}')
    check([r['step'] for r in train] == [1, 2] and sorted(val) == [2],
          f'logged steps {[(r["prefix"], r["step"]) for r in records]}')
    check(all(np.isfinite(r['loss']) for r in train), f'losses {train}')
    check(bn == {'model': bn_buffers, 'ema_model': bn_buffers},
          f'the checkpoint holds {bn} backbone BN statistics')
    check(not differ, f'the checkpoint loads {len(differ)} of {n_tensors} '
          f'tensors other than trained: {differ[:5]}')
    check(len(offline) == len(dataset) == len(trained_maps) > 0 and
          not maps_differ, f'tools.test label maps {maps_differ} differ '
          f'from the trained student\'s ({len(offline)} maps)')
    check(all_zero(train_counts) and all_zero(test_counts),
          f'{name} launched {train_counts}, {test_counts}')
    check(not resume or (resumed == 3 and
                         f'resumed from {ckpt} (iter 2)' in log),
          f'{name}: resumed to {resumed}')
    check(gap is not None and gap <= TOL_MIOU, f'offline mIoU '
          f'{results["mIoU"]} vs in-loop {val.get(2, {}).get("mIoU")}: '
          f'{gap} > {TOL_MIOU}')
    shutil.rmtree(wd, ignore_errors=True)
    return add_counts(train_counts, test_counts)


def run_cnn(fa, images, gpu_line, root):
    """The CNN slice: DeepLabV3+ on ResNetV1c-50-D8 through serving (f32
    against the CPU, the 16 fixture JPEGs), training (f32 against the CPU,
    the 4 + 4 step, the CLI and tools.test), PSPNet, FPN, CCNet and ICNet
    each serving and taking a step, and DeepLabV3+ on ResNeXt-50 (32x4d)
    and on ResNeSt-50 serving one request in f32 against the CPU; prints
    'cnn_seconds'. Returns the launch counts by path (all zero: no kernel
    runs on a CNN)."""
    import torch
    torch.cuda.empty_cache()
    paths, seconds = {}, {}
    path = cnn_config(root, 'deeplabv3plus')

    def serve():
        counts_, seg = phase_cnn_serve(fa, path, images, gpu_line)
        del seg
        torch.cuda.empty_cache()
        return counts_
    for name, run in (
            ('cnn_serve_f32', lambda: phase_cnn_serve_f32(
                fa, 'deeplabv3plus', root, images[0],
                'cnn_serve_f32_vs_cpu')),
            ('cnn_serve', serve),
            ('cnn_train_f32', lambda: phase_cnn_train_f32(fa, path, images)),
            ('cnn_train', lambda: phase_cnn_train(fa, path, images,
                                                  gpu_line)),
            ('cnn_bases', lambda: phase_cnn_bases(fa, root, images,
                                                  gpu_line)),
            # ResNeXt-50 and ResNeSt-50 in DeepLabV3+'s place
            ('resnext_serve_f32', lambda: phase_cnn_serve_f32(
                fa, 'resnext', root, images[0], 'resnext_serve_f32_vs_cpu')),
            ('resnest_serve_f32', lambda: phase_cnn_serve_f32(
                fa, 'resnest', root, images[0], 'resnest_serve_f32_vs_cpu')),
            ('cnn_train_cli', lambda: phase_cnn_train_cli(fa, gpu_line, root,
                                                          path))):
        t0 = time.perf_counter()
        paths[name] = run()
        seconds[name] = time.perf_counter() - t0
    emit({'phase': 'cnn_seconds', **seconds, 'total': sum(seconds.values())})
    return paths


# ------------------------------------------------ Swin and HRNet (OCRNet)
# the Swin/HRNet slice's models in the fixture config (``cnn_config``):
# UPerNet on Swin-T and the OCRNet cascade on HRNet-W18
SWIN_HRNET = ('upernet_swin', 'ocrnet')


def run_swin_hrnet(fa, images, gpu_line, root):
    """UPerNet-Swin-T and OCRNet-HRNet-18 at full width and depth, f32,
    TF32 off, every S4Former flag (``cnn_config``: 21 classes, the mixes'
    ``patchsize`` 16 and 4): each serving a 500x375 request against the
    CPU (probabilities within TOL_MAIN_F32; OCRNet's BN statistics first
    set from the request, ``calibrate_bn``: with the seeded ones, mean 0
    and variance 1, HRNet's eval-mode features grow to ~7e3 and its logits
    to ~1.1e3, the softmax saturates, and pixels whose two largest logits
    lie within f32 rounding of each other flip between the devices: 10 of
    262144 on an H100, a probability error of 0.98), 8 requests
    (the mean ms), the
    2 + 2 step from one batch (the first and 2 timed; img/s, peak memory;
    the fixture images scaled to cover 512², as no zero padding: with the
    seeded zero biases a zero-padded image patch is an exact zero token,
    whose LayerNorms have no variance, and on the CPU the first step at
    512² then moves Swin's patch-embedding bias by 5.0e23, the second is
    NaN),
    and one step at 1 + 1, 256², against the CPU's and the witness's
    (``f32_step_vs_witness``; OCRNet's BN statistics set from the batch
    first, as for its request: with the seeded ones its eval-mode teacher
    is certain of every pixel, so no threshold leaves any unconfident and
    the unsup losses are dead); then ``tools.train`` on OCRNet (2 steps,
    eval, checkpoint, ``--auto-resume`` to 3) and ``tools.test``, the
    checkpoint's tensors and label maps bit for bit the trained
    student's. None launches a kernel (Swin's 32-wide heads run plain, as
    JAX's). Prints 'swin_hrnet_seconds'. Returns the counts by path."""
    import torch
    paths, seconds = {}, {}

    def serve(which, path):
        path_counts, seg = phase_cnn_serve(fa, path, images[:8], gpu_line,
                                           f'{which}_serve')
        del seg
        torch.cuda.empty_cache()
        return path_counts

    def train_f32(which, path):
        r, launches = f32_step_vs_witness(fa, which, root, images)
        emit({'phase': f'{which}_train_f32_vs_cpu',
              'config': os.path.basename(path), **r,
              'tol': TOL_TRAIN_F32, 'settings': conv_settings(),
              'launches': launches[0]})
        check_witness(which, r, launches)
        return launches[0]
    for which in SWIN_HRNET:
        path = cnn_config(root, which)
        for name, run in (
                ('serve_f32', lambda: phase_cnn_serve_f32(
                    fa, which, root, images[0],
                    f'{which}_serve_f32_vs_cpu')),
                ('serve', lambda: serve(which, path)),
                ('train', lambda: phase_cnn_train(
                    fa, path, images, gpu_line, n=2, timed=2,
                    name=f'{which}_train', cover=True)),
                ('train_f32', lambda: train_f32(which, path))):
            t0 = time.perf_counter()
            paths[f'{which}_{name}'] = run()
            seconds[f'{which}_{name}'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # HRNet-W18: 305 BNs
    paths['ocrnet_train_cli'] = phase_cnn_train_cli(
        fa, gpu_line, root, cnn_config(root, 'ocrnet'), 'ocrnet_train_cli',
        bn_buffers=610, resume=True)
    seconds['ocrnet_train_cli'] = time.perf_counter() - t0
    emit({'phase': 'swin_hrnet_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths


# ------------------------------------------------ the real-time CNNs
# BiSeNetV1 (ResNet-18), BiSeNetV2, STDC1, Fast-SCNN, CGNet, ERFNet and
# LR-ASPP on MobileNetV3-large, each the model of its base config in the
# fixture config (``cnn_config``). Each one's S4Former step is held
# against the CPU's and the witness's (``f32_step_vs_witness``; ERFNet's
# backbone dropout off, as every head's): STDC trains its 2-class
# STDCHead on the 21-class labels (the cross-entropy gives the labels 2-20
# an nll of 0, as JAX's one-hot does). These steps found PyTorch's
# channels-last average-pool backward wrong on the card
# (``ops/resize.py:avg_pool_nhwc``)
REALTIME = ('bisenetv1', 'bisenetv2', 'stdc', 'fast_scnn', 'cgnet',
            'erfnet', 'lraspp')
# the models whose seeded BN statistics are first set from the request or
# the batch (``calibrate_bn``): CGNet's seeded eval-mode logits reach ~56
# on a 512² fixture request on the CPU, its softmax saturates (median max
# probability 0.996), and near-ties would flip between the devices;
# LR-ASPP's seeded teacher is flat: on the 256² witness batch most of its
# max probabilities lie within 1e-6 of the median threshold, so the two
# devices' softmaxes of one pinned logit map put different pixels above it
# and the unsup losses part by ~0.5% (the step line's
# 'teacher_near_threshold' counts them; 0 once calibrated)
REALTIME_CALIBRATE = ('cgnet', 'lraspp')


def phase_avg_pool_nhwc():
    """PyTorch's CUDA average-pool backward on the channels-last view of
    an NHWC map (3x3, stride 2, padding 1: BiSeNetV2's BGA, STDC's
    stride-2 modules, ResNeSt's avd pool) against the CPU's, beside the
    port's ``ops/resize.py:avg_pool_nhwc`` (a contiguous NCHW copy), which
    must agree within 1e-6 of the largest gradient entry. Returns the
    counts (no kernel)."""
    import torch
    import torch.nn.functional as F
    from s4former_tpu_torch.ops.resize import avg_pool_nhwc
    x0 = torch.randn(2, 64, 64, 32,
                     generator=torch.Generator().manual_seed(0))
    g0 = torch.randn(2, 32, 32, 32,
                     generator=torch.Generator().manual_seed(1))
    fns = {'torch_channels_last': lambda x: F.avg_pool2d(
               x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1),
           'avg_pool_nhwc': lambda x: avg_pool_nhwc(x, 3, 2, 1)}
    errs = {}
    for name, fn in fns.items():
        grads = []
        for device in ('cpu', 'cuda'):
            x = x0.detach().to(device).requires_grad_(True)
            fn(x).backward(g0.to(device))
            grads.append(x.grad.cpu())
        errs[name] = ((grads[1] - grads[0]).abs().max() /
                      grads[0].abs().max()).item()
    emit({'phase': 'avg_pool_nhwc', 'shape': [2, 64, 64, 32],
          'grad_rel_err_vs_cpu': errs, 'tol': 1e-6})
    check(errs['avg_pool_nhwc'] <= 1e-6, f'avg_pool_nhwc gradient on the '
          f'card parts from the CPU\'s by {errs["avg_pool_nhwc"]}')
    return {name: 0 for name in KERNELS}


def run_realtime(fa, images, gpu_line, root):
    """The real-time CNNs at their configs' full width and depth, f32,
    TF32 off, every S4Former flag (``cnn_config``: 21 classes but STDC's
    2-class head, the mixes' ``patchsize`` 8, ERFNet's 2, LR-ASPP's 16):
    each serving a 500x375 request against the CPU (probabilities within
    TOL_MAIN_F32; REALTIME_CALIBRATE's BN statistics set from the request
    first), 4 requests after a warm-up (the mean ms), the 2 + 2 step at
    512² (the first and 2 timed; img/s, peak memory); the 1 + 1 step at
    256² against the CPU's and the witness's (``f32_step_vs_witness``;
    REALTIME_CALIBRATE's BN statistics set from the batch), STDC's with
    the 2-class head's loss among its logs; first ``phase_avg_pool_nhwc``.
    None launches a kernel. Prints 'realtime_seconds'. Returns
    the counts by path."""
    import numpy as np
    import torch
    paths, seconds = {}, {}
    t0 = time.perf_counter()
    paths['avg_pool_nhwc'] = phase_avg_pool_nhwc()
    seconds['avg_pool_nhwc'] = time.perf_counter() - t0

    def serve(which, path):
        path_counts, seg = phase_cnn_serve(fa, path, images[:4], gpu_line,
                                           f'{which}_serve')
        del seg
        torch.cuda.empty_cache()
        return path_counts

    def train_f32(which, path):
        r, launches = f32_step_vs_witness(fa, which, root, images)
        heads = [(h.type, h.num_classes)
                 for h in model_heads(cnn_f32_cfg(path).model)[1:]]
        emit({'phase': f'{which}_train_f32_vs_cpu',
              'config': os.path.basename(path), **r,
              'aux_head_classes': heads, 'tol': TOL_TRAIN_F32,
              'settings': conv_settings(), 'launches': launches[0]})
        check_witness(which, r, launches)
        if which == 'stdc':
            aux = f'aux_{heads.index(("STDCHead", 2))}.loss_ce'
            check(all(np.isfinite(r[k].get(aux, np.nan))
                      for k in ('losses_card', 'losses_cpu')),
                  f'stdc: the 2-class STDCHead did not train: {heads}, '
                  f'{sorted(r["losses_card"])}')
        return launches[0]
    for which in REALTIME:
        path = cnn_config(root, which)
        runs = [('serve_f32', lambda: phase_cnn_serve_f32(
                    fa, which, root, images[0],
                    f'{which}_serve_f32_vs_cpu')),
                ('serve', lambda: serve(which, path)),
                ('train', lambda: phase_cnn_train(
                    fa, path, images, gpu_line, n=2, timed=2,
                    name=f'{which}_train')),
                ('train_f32', lambda: train_f32(which, path))]
        for name, run in runs:
            t0 = time.perf_counter()
            paths[f'{which}_{name}'] = run()
            seconds[f'{which}_{name}'] = time.perf_counter() - t0
    emit({'phase': 'realtime_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths


# ------------------------------------------------ the context heads
# the heads of JAX zoo_heads.py on ResNetV1c-50-D8 (``cnn_config``'s
# DeepLabV3+ backbone and FCN aux head), each with mmseg's ``*_r50-d8``
# head settings (PSANet's mask at its 512x512 configs' (66, 66)), 21
# classes; and DeepLabV3 on MobileNetV2-D8 (``deeplabv3_m-v2-d8``: the
# ASPP on stage 6 of 320, the FCN aux head on stage 4 of 96)
CONTEXT_HEADS = {
    'nonlocal': dict(type='NLHead', reduction=2, use_scale=True,
                     mode='embedded_gaussian'),
    'gcnet': dict(type='GCHead', ratio=1 / 4., pooling_type='att',
                  fusion_types=('channel_add',)),
    'dnl': dict(type='DNLHead', reduction=2, use_scale=True,
                mode='embedded_gaussian'),
    'ann': dict(type='ANNHead', in_channels=[1024, 2048], in_index=[2, 3],
                project_channels=256, query_scales=(1,),
                key_pool_scales=(1, 3, 6, 8)),
    'apcnet': dict(type='APCHead', pool_scales=(1, 2, 3, 6)),
    'dmnet': dict(type='DMHead', filter_sizes=(1, 3, 5, 7)),
    'emanet': dict(type='EMAHead', channels=256, ema_channels=512,
                   num_bases=64, num_stages=3, momentum=0.1),
    'encnet': dict(type='EncHead', in_channels=[512, 1024, 2048],
                   in_index=(1, 2, 3), num_codes=32, use_se_loss=True,
                   add_lateral=False,
                   loss_se_decode=dict(type='CrossEntropyLoss',
                                       use_sigmoid=True, loss_weight=0.2)),
    'isanet': dict(type='ISAHead', isa_channels=256, down_factor=(8, 8)),
    'psanet': dict(type='PSAHead', mask_size=(66, 66),
                   psa_type='bi-direction', compact=False, shrink_factor=2,
                   normalization_factor=1.0, psa_softmax=True),
    'danet': dict(type='DAHead', pam_channels=64),
}
# the mixes' super-patches: EncHead never undoes the PatchShuffle (JAX
# l.631), so it keeps the default 16; every other head here undoes it on
# the 1/8 map (8)
CONTEXT_PATCHSIZE = {'encnet': 16}
CONTEXT_STEPS = ('emanet', 'psanet', 'danet')
EMA_BASES = 'decode_head.ema_module.bases'
# the head alone, card against CPU (f32, train mode; ReLU signs pinned to
# the CPU's, ``phase_context_head_f32``): each tensor (the logits, each
# feature's gradient, each parameter's gradient) within CNN_WITNESS_MULT x
# its one-ulp witness's distance on either device, or this share of the
# largest CPU entry of its group (the f32 step's TOL_TRAIN_F32)
TOL_HEAD_F32 = 1e-3
# a ReLU input whose sign the card and the CPU see differently must be a
# tie: within this share of that ReLU input's largest CPU value on both
# devices (f32 sums in another order part by ~1e-6 of it; a fault that
# flipped a real value would part by O(1))
TOL_TIE = 1e-4


def context_config(root, which):
    """The fixture config (as ``cnn_config`` writes it) with a model of
    this slice: ``mobilenet_v2`` or a key of CONTEXT_HEADS. Returns the
    path."""
    ce = dict(type='CrossEntropyLoss', loss_weight=1.0)
    if which == 'mobilenet_v2':
        backbone = dict(type='MobileNetV2', widen_factor=1.,
                        strides=(1, 2, 2, 1, 1, 1, 1),
                        dilations=(1, 1, 1, 2, 2, 4, 4),
                        out_indices=(1, 2, 4, 6))
        head = dict(type='ASPPHead', in_channels=320, in_index=3,
                    channels=512, dilations=(1, 12, 24, 36))
        aux_in = 96
    else:
        from s4former_tpu_torch.config import Config
        backbone = Config.fromfile(os.path.join(
            REPO, 'configs', '_base_', 'models',
            CNN_MODELS['deeplabv3plus'])).to_dict()['model']['backbone']
        head = dict(dict(in_channels=2048, in_index=3, channels=512),
                    **CONTEXT_HEADS[which])
        aux_in = 1024
    head = dict(head, dropout_ratio=0.1, num_classes=21, align_corners=False,
                loss_decode=ce, _delete_=True)
    aux = [dict(type='FCNHead', in_channels=aux_in, in_index=2,
                channels=256, num_convs=1, concat_input=False,
                dropout_ratio=0.1, num_classes=21, align_corners=False,
                loss_decode=dict(ce, loss_weight=0.4))]
    over = dict(type='EncoderDecoder',
                backbone=dict(backbone, _delete_=True), decode_head=head,
                auxiliary_head=aux,
                patchsize=CONTEXT_PATCHSIZE.get(which, CNN_PATCHSIZE))
    path = os.path.join(root, f'{which}_voc_mini_MT_w_ours.py')
    with open(path, 'w') as f:
        f.write(f'_base_ = [{FULLFLAG!r}]\nmodel = {over!r}\n')
    return path


class ReluPin:
    """``torch.nn.functional.relu``, which every ReLU of the heads calls,
    patched for the head checks. Without ``masks`` the ReLUs run as they
    are and each call's input is kept (``inputs``, on the CPU); with
    ``masks`` (a recorded run's signs, one a call) each call passes its
    input where the mask is set, whatever its own sign, and ``flips`` gets
    a call's (index, the positions, |input| there) where its own sign
    differs."""

    def __init__(self, masks=None):
        self.masks, self.inputs, self.flips, self.calls = masks, [], [], 0

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self.original = F.relu

        def relu(x, inplace=False):
            i, self.calls = self.calls, self.calls + 1
            if self.masks is None:
                self.inputs.append(x.detach().cpu())
                return self.original(x)
            mask = self.masks[i].to(x.device)
            check(mask.shape == x.shape, f'ReLU call {i}: {tuple(x.shape)}, '
                  f'recorded {tuple(mask.shape)}')
            flip = (x.detach() > 0) != mask
            if flip.any():
                self.flips.append((i, flip.nonzero().cpu(),
                                   x.detach()[flip].abs().cpu()))
            return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
        F.relu = relu
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.relu = self.original


def head_case(which, root):
    """(the decode head of ``context_config(root, which)``, dropout 0,
    seeded; the ResNetV1c-50-D8 features of one 256² image: seeded ReLU'd
    noise at the stages' widths, 64² x 256, 32² x 512, 1024, 2048; the
    same with every non-zero value moved one ulp up or down, seeded (a
    zero stays: one ulp from 0 is a subnormal, which the CPU computes
    with slowly); a seeded cotangent of the logits)."""
    import numpy as np
    import torch
    import s4former_tpu_torch.models  # noqa: F401  (registers the heads)
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.registry import MODELS
    cfg = Config.fromfile(context_config(root, which))
    torch.manual_seed(0)
    head = MODELS.build(dict(cfg.model.decode_head, dropout_ratio=0.0))
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(1, s, s, c, generator=gen).relu()
             for s, c in ((64, 256), (32, 512), (32, 1024), (32, 2048))]
    cot = torch.randn(1, 32, 32, 21, generator=gen)
    rs = np.random.RandomState(0)
    moved = []
    for f in feats:
        x = f.numpy()
        to = np.where(rs.rand(*x.shape) < 0.5, -np.inf, np.inf)
        moved.append(torch.from_numpy(np.where(
            x == 0, x, np.nextafter(x, to.astype(np.float32)))))
    return head, feats, moved, cot


def head_grads(fa, head, device, inputs, cot, pin):
    """The head (a copy on ``device``) in train mode on ``inputs``, its
    logits times ``cot`` summed and differentiated, inside ``pin`` (a
    ``ReluPin``): ({'logits', 'input i', parameter names: on the CPU},
    seconds, launch counts)."""
    import copy
    import torch
    h = copy.deepcopy(head).to(device)
    xs = [f.detach().to(device).requires_grad_(True) for f in inputs]
    reset_counts(fa)
    t0 = time.perf_counter()
    with pin:
        out = h(xs, train=True)
        (out * cot.to(device)).sum().backward()
    if device == 'cuda':
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grads = {'logits': out.detach().cpu()}
    grads.update({f'input {i}': x.grad.cpu() for i, x in enumerate(xs)
                  if x.grad is not None})
    grads.update({n: p.grad.cpu() for n, p in h.named_parameters()
                  if p.grad is not None})
    return grads, seconds, counts(fa)


def cpu_head(fa, which, images, root):
    """``phase_context_head_f32``'s CPU half: the head's run (its ReLU
    inputs kept) and the witness's on the moved features (the ReLUs
    pinned to the run's signs)."""
    head, feats, moved, cot = head_case(which, root)
    rec = ReluPin()
    cpu, cpu_s, cc = head_grads(fa, head, 'cpu', feats, cot, rec)
    masks = [z > 0 for z in rec.inputs]
    wit, _, _ = head_grads(fa, head, 'cpu', moved, cot, ReluPin(masks))
    return {'cpu': cpu, 'wit': wit, 'relu_inputs': rec.inputs,
            'cpu_s': cpu_s, 'launches': cc}


def phase_context_head_f32(fa, which, root):
    """The decode head of ``context_config(root, which)`` alone (dropout
    0), seeded, in train mode, f32, forward and backward on the
    ResNetV1c-50-D8 features of one 256² image and a seeded cotangent of
    the logits (``head_case``), on the CPU and on the card, and on both
    again on the features moved one ulp (the witness on each device). The
    card's ReLUs and both witnesses' take the CPU run's signs
    (``ReluPin``): a ReLU input at a tie, which the two devices' f32 sums
    put on either side of 0, would otherwise move a weight gradient's
    entries above it by percents of the largest (GCNet's ``conv_cat``:
    one entry of its BN output, 1.9%). Each entry where the card's own
    sign differs must be such a tie (TOL_TIE). Then every tensor (the
    logits, each feature's and each parameter's gradient) within
    CNN_WITNESS_MULT x the larger witness distance of its own, or
    TOL_HEAD_F32 of the largest CPU entry of its group. Returns the
    counts of the card's call (no kernel)."""
    import torch
    head, feats, moved, cot = head_case(which, root)
    half = cpu_half(f'head:{which}', None, root)
    cpu, wit, z = half['cpu'], half['wit'], half['relu_inputs']
    masks = [v > 0 for v in z]
    pin = ReluPin(masks)
    card, card_s, launches = head_grads(fa, head, 'cuda', feats, cot, pin)
    card_wit, _, _ = head_grads(fa, head, 'cuda', moved, cot,
                                ReluPin(masks))
    check(pin.calls == len(masks), f'{which}: {pin.calls} ReLU calls on '
          f'the card, {len(masks)} on the CPU')
    ties = []
    for i, where, card_abs in pin.flips:
        cpu_abs = z[i][tuple(where.t())].abs()
        scale = z[i].abs().max().item()
        ties.append({'call': i, 'shape': list(z[i].shape),
                     'entries': len(card_abs),
                     'worst': max(card_abs.max().item(),
                                  cpu_abs.max().item()) / max(scale, 1e-30)})
    groups = {'logits': ['logits'],
              'inputs': [n for n in cpu if n.startswith('input')],
              'params': [n for n in cpu if n != 'logits' and
                         not n.startswith('input')]}
    rows = []
    for group, names in groups.items():
        scale = max(cpu[n].abs().max().item() for n in names)
        for n in names:
            if n not in card:
                continue
            err = (card[n] - cpu[n]).abs().max().item()
            w = max((wit[n] - cpu[n]).abs().max().item(),
                    (card_wit[n] - card[n]).abs().max().item())
            allowed = max(CNN_WITNESS_MULT * w, TOL_HEAD_F32 * scale)
            rows.append((err / allowed, n, err, w, allowed))
    rows.sort()
    emit({'phase': f'{which}_head_f32_vs_cpu',
          'head': head.__class__.__name__,
          'features': '1 x 256² of ResNetV1c-50-D8',
          'logits_shape': list(card['logits'].shape),
          'tensors': len(cpu), 'witness_mult': CNN_WITNESS_MULT,
          'tol': TOL_HEAD_F32, 'relu_calls': len(masks),
          # entries whose sign the card's own sums put otherwise: (call,
          # how many, the larger |input| on either device over the call's
          # largest CPU |input|)
          'relu_ties': ties, 'tol_tie': TOL_TIE,
          # (err / allowed, name, max |card - CPU|, the larger witness
          #  distance, allowed)
          'err_over_allowed_worst': rows[-3:],
          'card_s': card_s, 'cpu_s': half['cpu_s'], 'launches': launches})
    check(tuple(card['logits'].shape) == (1, 32, 32, 21), f'{which}: '
          f'logits {tuple(card["logits"].shape)}')
    check(sorted(card) == sorted(cpu), f'{which}: gradients on '
          f'{sorted(set(card) ^ set(cpu))} differ in presence')
    check(all_zero(launches) and all_zero(half['launches']),
          f'{which} head launched {launches}, {half["launches"]}')
    check(all(t['worst'] <= TOL_TIE for t in ties),
          f'{which}: a ReLU sign differs beyond a tie: {ties}')
    check(rows[-1][0] <= 1, f'{which}: f32 head, card vs CPU beyond the '
          f'witness: {rows[-3:]}')
    return launches


def run_context(fa, images, gpu_line, root):
    """The context-head slice, f32, TF32 off, every S4Former flag
    (``context_config``). DeepLabV3 on MobileNetV2-D8: a 500x375 request
    against the CPU (probabilities within TOL_MAIN_F32), 4 requests, the
    2 + 2 step at 512² (the first and 2 timed), the 1 + 1 step at 256²
    against the CPU's and the witness's (``f32_step_vs_witness``). Each
    head of CONTEXT_HEADS on ResNetV1c-50-D8: alone against the CPU
    (``phase_context_head_f32``), then one request at 512² after a
    warm-up (ms, peak memory). CONTEXT_STEPS: the 2 + 2 step at 512²
    (EMANet's ``bases`` must move), and EMANet's 1 + 1 step at 256²
    against the CPU's and the witness's, its ``bases`` held too. None
    launches a kernel. Prints 'context_seconds'. Returns the counts by
    path."""
    import torch
    paths, seconds = {}, {}

    def serve(which, path, n):
        path_counts, seg = phase_cnn_serve(fa, path, images[:n], gpu_line,
                                           f'{which}_serve')
        del seg
        torch.cuda.empty_cache()
        return path_counts

    def train_f32(which, path):
        r, launches = f32_step_vs_witness(fa, which, root, images)
        emit({'phase': f'{which}_train_f32_vs_cpu',
              'config': os.path.basename(path), **r, 'tol': TOL_TRAIN_F32,
              'settings': conv_settings(), 'launches': launches[0]})
        check_witness(which, r, launches)
        return launches[0]
    runs = []
    path = context_config(root, 'mobilenet_v2')
    runs += [('mobilenet_v2_serve_f32', lambda: phase_cnn_serve_f32(
                 fa, 'mobilenet_v2', root, images[0],
                 'mobilenet_v2_serve_f32_vs_cpu')),
             ('mobilenet_v2_serve', lambda: serve('mobilenet_v2', path, 4)),
             ('mobilenet_v2_train', lambda: phase_cnn_train(
                 fa, path, images, gpu_line, n=2, timed=2,
                 name='mobilenet_v2_train')),
             ('mobilenet_v2_train_f32', lambda: train_f32('mobilenet_v2',
                                                          path))]
    for which in CONTEXT_HEADS:
        p = context_config(root, which)
        runs += [(f'{which}_head_f32',
                  lambda w=which: phase_context_head_f32(fa, w, root)),
                 (f'{which}_serve', lambda w=which, p=p: serve(w, p, 1))]
        if which in CONTEXT_STEPS:
            moved = (EMA_BASES,) if which == 'emanet' else ()
            runs.append((f'{which}_train', lambda w=which, p=p, m=moved:
                         phase_cnn_train(fa, p, images, gpu_line, n=2,
                                         timed=2, name=f'{w}_train',
                                         moved=m)))
        if which == 'emanet':
            runs.append(('emanet_train_f32', lambda p=p: train_f32(
                'emanet', p)))
    for name, run in runs:
        t0 = time.perf_counter()
        paths[name] = run()
        seconds[name] = time.perf_counter() - t0
    emit({'phase': 'context_seconds', **seconds,
          'total': sum(seconds.values())})
    return paths


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
# ablation_train_bf16's depth: the flags' passes and launches at the
# flagship's width, the 12 layers cut to 4 (one tap a layer)
ABLATION_BF16_LAYERS = 4
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


def ablation_f32_case():
    """``phase_ablation_f32_vs_cpu``'s (cfg, SemiConfig, layer decay)."""
    import dataclasses
    from s4former_tpu_torch.semi.config import SemiConfig
    cfg = ablation_config('ours', 'float32', 4, regularisers=True)
    for head in [cfg.model.decode_head] + list(cfg.model.auxiliary_head):
        head.dropout_ratio = 0.0
    cfg.model.backbone.update({k: 0.0 for k in ABLATION_RATES})
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                               unsup_confidence=UNSUP_CONFIDENCE_F32,
                               **ABLATION_F32)
    return cfg, semi, dict(ABLATION_LAYER_DECAY, num_layers=4)


def cpu_ablation_f32(fa, images, root):
    """``phase_ablation_f32_vs_cpu``'s batch (2 + 2 at 512² and every draw
    of ``ablation_draws``, which the card's step takes too) and CPU
    step."""
    cfg, semi, layer_decay = ablation_f32_case()
    state, step = trainer_from_config(
        cfg, 'cpu', layer_decay, unsup_confidence=UNSUP_CONFIDENCE_F32,
        **ABLATION_F32)
    n_head = len(list(state.model.decode_head.parameters()))
    batch = dict(train_batch(images, 2, 2), **ablation_draws(
        semi, 2, 512, state.model.num_classes, n_head))
    return batch, one_step(fa, state, step, batch, 'cpu')


def phase_ablation_f32_vs_cpu(fa, images):
    """One S4Former step of ``..._MT_w_ours.py`` with ABLATION_F32's flags
    and set (c)'s layer decay and sigmoid aux CE, in f32 at full width,
    depth cut to 4 layers, 2 + 2 images at 512², dropout rates 0: on the
    card and on the CPU from the same weights and the same draws (every
    mix, gate and EMA head skip from ``ablation_draws``). Tolerances of
    train_f32_vs_cpu. Returns the card's launch counts."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, semi, layer_decay = ablation_f32_case()
    batch, (lc, dc, sc, cc) = cpu_half('ablation_f32', images)
    state, step = trainer_from_config(
        cfg, 'cuda', layer_decay, unsup_confidence=UNSUP_CONFIDENCE_F32,
        **ABLATION_F32)
    lg, dg, sg, cg = one_step(fa, state, step, batch, 'cuda')
    del state, step
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
    """``..._MT_w_ours.py`` in bf16 at full width, depth cut to
    ABLATION_BF16_LAYERS, 4 + 4 fixture images at 512² from one batch, once
    for each of ABLATION_SETS ((c) with its rates, head dropout, sigmoid
    aux CE and layer decay over those layers): the first step, 2
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
        cfg = ablation_config('ours', None, ABLATION_BF16_LAYERS,
                              regularisers)
        check(cfg.model.backbone.dtype == 'bfloat16', 'flagship dtype')
        layer_decay = dict(ABLATION_LAYER_DECAY,
                           num_layers=ABLATION_BF16_LAYERS)
        state, step = trainer_from_config(
            cfg, 'cuda', layer_decay if regularisers else None, **flags)
        semi = SemiConfig.from_model_cfg(dict(cfg.model, **flags))
        expect = predicted_launches(semi, ABLATION_BF16_LAYERS)
        gen = torch.Generator(device='cuda').manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)                           # the main path starts
        state, logs, ms = timed_steps(state, step, batch, gen, 3)
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
                                   layer_decay=layer_decay)
              if regularisers else None,
              'batch': f'4 + 4 at 512², bf16, {ABLATION_BF16_LAYERS} '
                       f'layers',
              'first_step_ms': ms[0], 'step_ms': ms[1:],
              'step_ms_mean': float(timed.mean()),
              'step_ms_p50': float(np.median(timed)),
              'img_per_s': 8 / (timed.mean() / 1e3),
              'peak_mem_bytes': peak, 'mask_ratio': lg['mask_ratio'],
              'logs': lg, 'profile': prof, 'launches': path_counts,
              'launches_per_step_predicted': expect, 'gpu': gpu_line})
        check(all(np.isfinite(v) for v in lg.values()),
              f'{name}: non-finite logs {lg}')
        check(path_counts == {k: 4 * v for k, v in expect.items()},
              f'{name}: 4 steps launched {path_counts}, not {expect} a step')
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
# remat_train_bf16's depth: remat off, 'dots' and 'full' compared at the
# same depth, the flagship's 12 layers cut to 4 (one tap a layer)
REMAT_LAYERS = 4


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
    mix = np.array(mix)        # a copy: a reversed view of one image keeps
    # its negative stride through ascontiguousarray, which torch refuses
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


UNIMATCH_F32_CASES = ('deit_pasa', 'deit_fdrop', 'mit_pasa')


def unimatch_case(name, images, threshold=None):
    """(cfg, batch with the streams' draws, the step's flags, SemiConfig,
    crop) of a case of ``phase_unimatch_f32_vs_cpu``: 'deit_pasa' and
    'deit_fdrop' at 4 layers and 512²; 'mit_pasa' at MIT_TRAIN_F32_DEPTH
    and MIT_CROP² with ``threshold``."""
    import dataclasses
    import numpy as np
    from s4former_tpu_torch.semi.config import SemiConfig
    if name.startswith('deit'):
        cfg = load_config('float32', 'ours', 4)
        cfg.model.backbone.update(drop_rate=0.0, drop_path_rate=0.0)
        batch = unimatch_batch(images, 1, 1)
        over = dict(UNIMATCH_FLAGS, unsup_confidence=UNSUP_CONFIDENCE_F32,
                    attn_mask_seperate_head=name == 'deit_pasa')
        size = 512
    else:
        cfg = load_mit_config('ours', 'float32', MIT_TRAIN_F32_DEPTH,
                              drop=False)
        batch = mit_train_batch(np.random.RandomState(5), 1, 1)
        batch = with_mix_views(batch, batch['sup_img'])
        over = dict(UNIMATCH_FLAGS, unsup_confidence=threshold)
        size = MIT_CROP
    semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model), **over)
    n = batch['unsup_student_img'].shape[0]
    return cfg, dict(batch, **unimatch_draws(semi, n, size)), over, semi, size


def cpu_unimatch(fa, name, images, root):
    """A case's threshold (for 'mit_pasa' the CPU teacher's median
    max-probability) and its CPU step, the fdrop masks
    ``masks_from_cpu``'s."""
    import torch
    threshold = None
    if name == 'mit_pasa':
        cfg, batch, _, _, _ = unimatch_case(name, images)
        state, _ = trainer_from_config(cfg, 'cpu')
        with torch.no_grad():
            t_logits = state.model.forward_decode_from_img(
                torch.from_numpy(batch['unsup_teacher_img']), train=False)
        threshold = float(torch.softmax(t_logits.float(), -1).amax(-1)
                          .median())
    cfg, batch, over, _, _ = unimatch_case(name, images, threshold)
    state, step = trainer_from_config(cfg, 'cpu', **over)
    return threshold, one_step(fa, state, step, batch, 'cpu', masks_from_cpu)


def phase_unimatch_f32_vs_cpu(fa, images):
    """One UniMatch step in f32 against the CPU, the streams' boxes and
    permutations injected: ``..._MT_w_ours.py`` at full width, depth cut to
    4 layers, 1 + 1 at 512², dropout and drop path 0, the threshold
    UNSUP_CONFIDENCE_F32, with head 1 as the PASA pass and as the fdrop
    pass (``attn_mask_seperate_head`` off; its fdrop masks from
    ``masks_from_cpu``); then MiT-B4 ``_MT_w_ours`` at depth
    MIT_TRAIN_F32_DEPTH, 1 + 1 at 768², the threshold the CPU teacher's
    median max-probability. Tolerances of train_f32_vs_cpu. Returns the
    card's launch counts summed."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = None
    for name in UNIMATCH_F32_CASES:
        threshold, (lc, dc, sc, cc) = cpu_half(f'unimatch:{name}', images)
        cfg, batch, over, semi, size = unimatch_case(name, images, threshold)
        n = batch['unsup_student_img'].shape[0]
        state, step = trainer_from_config(cfg, 'cuda', **over)
        lg, dg, sg, cg = one_step(fa, state, step, batch, 'cuda',
                                  masks_from_cpu)
        del state, step
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


def remat_config(name, remat, num_layers=None):
    """A flagship config as written (bf16) with the ViT's remat set, the
    depth cut to ``num_layers`` if given."""
    cfg = load_config(None, name, num_layers)
    cfg.model.backbone.update(REMAT[remat])
    return cfg


def phase_unimatch_train_bf16(fa, images, gpu_line):
    """UniMatch on ``..._MT_w_ours.py`` in bf16 at full depth, 8 + 8 at
    512² (bench.py's batch) from one fixed batch with its mix stream, the
    streams PatchShuffled: the first step, 2 timed (mean, p50), 1 profiled;
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
    state, logs, ms = timed_steps(state, step, batch, gen, 3)
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
    check(path_counts == {k: 4 * v for k, v in expect.items()},
          f'4 UniMatch steps launched {path_counts}, not {expect} a step')
    del state, step, batch
    torch.cuda.empty_cache()
    return path_counts


def phase_remat_train_bf16(fa, images, gpu_line):
    """The flagship ``..._MT_w_ours.py`` 8 + 8 step and the UniMatch 8 + 8
    step (bf16, DeiT-B width, depth cut to REMAT_LAYERS, one fixed batch),
    each with remat off, 'dots' and 'full': the first step's losses and
    parameter updates against remat off's (and a second run without
    remat) within TOL_REMAT_BF16; then 2 steps timed and 1 profiled, with
    peak memory; launches against predicted_launches with remat (5 + 2 and
    10 + 4 a layer). Returns the counts summed."""
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
            cfg = remat_config('ours', remat.split('_')[0], REMAT_LAYERS)
            semi = dataclasses.replace(SemiConfig.from_model_cfg(cfg.model),
                                       **over)
            expect = predicted_launches(semi, REMAT_LAYERS,
                                        remat not in ('off', 'off_again'))
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
            state, _, timed = timed_steps(state, step, batch, gen, 2)
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
                  'batch': f'8 + 8 at 512², bf16, {REMAT_LAYERS} layers',
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
            check(path_counts == {k: 4 * v for k, v in expect.items()},
                  f'{regime} {remat}: 4 steps launched {path_counts}, not '
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
# dp_train_bf16's timed steps a rank (after one warm-up)
DP_TIMED = 3


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


def save_batches(batches, directory, name):
    """The batches as ``name``_i.npz files in ``directory``."""
    import numpy as np
    paths = []
    for i, batch in enumerate(batches):
        paths.append(os.path.join(directory, f'{name}_{i}.npz'))
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
    split = set(state.plan.split_names()) if state.plan else set()
    return same_on_every_rank([
        t for sd in (state.model.state_dict(), state.ema_model.state_dict(),
                     state.momentum) for n, t in sd.items() if n not in split])


def same_on_every_rank(tensors):
    """The tensors bit for bit rank 0's on every rank of the world."""
    import torch
    import torch.distributed as dist
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
    4 + 4 of the global batch; a warm-up step, DP_TIMED timed. The gradient
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
    state, _, warm_ms = timed_steps(state, step, batch, gen, 1)
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
    state, logs, ms = timed_steps(state, step, batch, gen, DP_TIMED)
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
    torch.cuda.reset_peak_memory_stats()
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
    batch; a warm-up step, TP_TIMED timed, one under the profiler. Reports
    what a rank holds: its parameters' floats (the EMA and the SGD buffers
    hold as many) against the whole model's."""
    import numpy as np
    import torch
    from s4former_tpu_torch.parallel import mesh
    from s4former_tpu_torch.parallel.tp import shard_state
    state, step, cfg = make_trainer('ours', device, None, TP_LAYERS)
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
    state, _, warm_ms = timed_steps(state, step, batch, gen, 1)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(fa)                               # the main path starts
    state, logs, ms = timed_steps(state, step, batch, gen, TP_TIMED)
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


def rel_err(got, ref):
    """The max abs error over the reference's max |value|."""
    ref = ref.float()
    return (got.float() - ref).abs().max().item() / max(
        ref.abs().max().item(), 1e-30)


def ring_rank_case(fa, device, dtype, cp, bias_kind):
    """One case of ring_attention_*: the rings of ``cp`` ranks (a data
    axis of 4 / cp) run ``ring_attention_sharded`` on the same whole q, k,
    v [1, RING_L, 12, 64] (and a PASA bias [1, 1, RING_L, RING_L]) and the
    backward of sum(o * do), counted; then, outside the count, the rank's
    lse by ``ring_attention_fwd``, and rank 0 holds o, lse, dq, dk and dv
    to the one-process flash kernels on the whole sequence and to their
    plain versions."""
    import torch
    from s4former_tpu_torch.parallel.distributed import ctx_rank, rank
    from s4former_tpu_torch.parallel.mesh import make_cp_mesh, reset_mesh
    from s4former_tpu_torch.parallel.ring_attention import (
        ring_attention_fwd, ring_attention_sharded)
    make_cp_mesh(cp)
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v, bias = attention_inputs(1, RING_L, 12, dtype, bias_kind, gen)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize(device)
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    o = ring_attention_sharded(*leaves, bias)
    (o.float() * do.float()).sum().backward()
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts(fa)                          # the main path ends
    grads = [t.grad for t in leaves]
    out = {'cp': cp, 'bias': bias_kind, 'ms': ms, 'launches': launches,
           'same_on_every_rank': same_on_every_rank([o] + grads)}
    n = RING_L // cp
    rows = slice(ctx_rank() * n, (ctx_rank() + 1) * n)
    _, lse = ring_attention_fwd(q[:, rows], k[:, rows], v[:, rows],
                                None if bias is None else bias[:, :, rows])
    if rank() == 0:
        o_k, lse_k = fa.flash_attention_fwd(q, k, v, bias)
        g_k = fa.flash_attention_bwd(q, k, v, bias, o_k, lse_k, do)
        o_p, lse_p = fa.flash_attention_reference(q, k, v, bias)
        g_p = fa.flash_attention_backward_reference(q, k, v, bias, o_p,
                                                    lse_p, do)
        for key, (o_r, lse_r, g_r) in (('vs_kernel', (o_k, lse_k, g_k)),
                                       ('vs_plain', (o_p, lse_p, g_p))):
            out[key] = {
                'o': (o.float() - o_r.float()).abs().max().item(),
                'lse': (lse - lse_r[:, :, rows]).abs().max().item(),
                'dq_dk_dv': [rel_err(a, b) for a, b in zip(grads, g_r)]}
        del o_k, lse_k, g_k, o_p, lse_p, g_p
    reset_mesh()
    return out


def seeded_layers(num_layers, dtype, device, seed=21):
    """DeiT-B's transformer layers (768 wide, 12 heads, 3072 hidden) in
    ``dtype`` with seeded weights, the same on every rank: N(0, 0.02),
    LayerNorm scales N(1, 0.02)."""
    import torch
    from s4former_tpu_torch.models.backbones.vit import \
        TransformerEncoderLayer
    gen = torch.Generator().manual_seed(seed)
    layers = torch.nn.ModuleList([
        TransformerEncoderLayer(768, 12, 3072, dtype=getattr(torch, dtype))
        for _ in range(num_layers)])
    with torch.no_grad():
        for name, p in layers.named_parameters():
            mean = 1.0 if name.endswith(('ln1.weight', 'ln2.weight')) \
                else 0.0
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + mean)
    return layers.to(device)


def token_batch(l, dtype, device, seed):
    """Tokens [8, l, 768] and an output cotangent, the same on every
    rank."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((8, l, 768), generator=gen,
                        device=device).to(getattr(torch, dtype))
            for _ in range(2)]


def stack_reference(layers, x, cot):
    """The one-process sequential stack: its output, and the gradients of
    sum(out * cot) in x and in every parameter (by the stack's names)."""
    xr = x.detach().requires_grad_()
    out = xr
    for layer in layers:
        out = layer(out)
    (out.float() * cot.float()).sum().backward()
    ref = {'out': out.detach(), 'x_grad': xr.grad,
           'grads': {n: p.grad for n, p in layers.named_parameters()}}
    for p in layers.parameters():
        p.grad = None
    return ref


def timed_pipeline(fa, device, run, x, cot):
    """``run(x)`` and the backward of sum(out * cot), counted and timed:
    (out, x's gradient, ms, launches)."""
    import torch
    xr = x.detach().requires_grad_()
    torch.cuda.synchronize(device)
    reset_counts(fa)                               # the main path starts
    t0 = time.perf_counter()
    out = run(xr)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    return out, xr.grad, ms, counts(fa)            # the main path ends


def pp_rank_case(fa, device, layers, x, cot, ref, stages, m):
    """One grid of pp_*: GPipe of ``layers`` over ``stages`` (the rest of
    the 4 ranks the data axis), M = m, against ``ref``."""
    from s4former_tpu_torch.parallel.distributed import data_size, pipe_rank
    from s4former_tpu_torch.parallel.mesh import make_pp_mesh, reset_mesh
    from s4former_tpu_torch.parallel.pp import pipeline_apply, stage_layers
    make_pp_mesh(stages)
    stage = stage_layers(layers)
    first = pipe_rank() * len(stage)
    out, x_grad, ms, launches = timed_pipeline(
        fa, device, lambda xr: pipeline_apply(None, stage, xr, m), x, cot)
    grad_err = 0.0
    for name, p in stage.named_parameters():
        i, rest = name.split('.', 1)
        grad_err = max(grad_err, rel_err(
            p.grad, ref['grads'][f'{first + int(i)}.{rest}']))
        p.grad = None
    res = {'grid': f'data {data_size()} x pipe {stages}', 'M': m,
           'stages': stages, 'stage': pipe_rank(), 'layers': len(stage),
           'ms': ms,
           'launches': launches, 'out': rel_err(out, ref['out']),
           'x_grad': rel_err(x_grad, ref['x_grad']), 'grads': grad_err,
           'stage_param_floats': sum(p.numel() for p in stage.parameters()),
           'stack_param_floats': sum(p.numel() for p in layers.parameters())}
    reset_mesh()
    return res


def pp_tp_rank_case(fa, device, layers, x, cot, ref, sequence_parallel):
    """One case of pp_tp_bf16: data 1 x pipe 2 x model 2, M = 4,
    ``pipeline_apply_tp`` of the rank's leaves against ``ref`` (the
    reference's gradients cut to the rank's pieces by the same plan)."""
    from s4former_tpu_torch.parallel import tp
    from s4former_tpu_torch.parallel.distributed import model_rank, pipe_rank
    from s4former_tpu_torch.parallel.mesh import make_pp_tp_mesh, reset_mesh
    from s4former_tpu_torch.parallel.pp import (LEAF_NAMES, pipeline_apply_tp,
                                                stage_layers, tp_stage_leaves)
    make_pp_tp_mesh(2, 2)
    leaves = tp_stage_leaves(layers)
    stage = stage_layers(layers)
    plan = tp.ShardPlan(tp.param_specs(
        {n: tuple(p.shape) for n, p in stage.named_parameters()}, 2), 2, 1)
    first = pipe_rank() * len(stage)
    out, x_grad, ms, launches = timed_pipeline(
        fa, device, lambda xr: pipeline_apply_tp(leaves, xr, 4, 12,
                                                 sequence_parallel), x, cot)
    grad_err = max(
        rel_err(leaf[short].grad,
                plan.local(f'{i}.{name}', ref['grads'][f'{first + i}.{name}']))
        for i, leaf in enumerate(leaves) for name, short in LEAF_NAMES)
    res = {'grid': 'data 1 x pipe 2 x model 2', 'M': 4, 'stages': 2,
           'layers': len(stage), 'sequence_parallel': sequence_parallel,
           'L': x.shape[1], 'stage': pipe_rank(),
           'model_rank': model_rank(), 'ms': ms,
           'launches': launches, 'out': rel_err(out, ref['out']),
           'x_grad': rel_err(x_grad, ref['x_grad']), 'grads': grad_err,
           'leaf_floats': sum(p.numel() for p in leaves.parameters())}
    reset_mesh()
    return res


def pp_rank_phases(fa, spec, device):
    """One of the 4 ranks of the pipeline and ring phases (every grid
    of them in one start-up): ring_attention_{bf16,f32}, then pp_bf16 (12
    layers) and pp_f32 (4) on pipe 4 (M = 8) and data 2 x pipe 2 (M = 4),
    then pp_tp_bf16 without and with sequence parallelism (L = 1025,
    1026), each against the one-process sequential stack of the same
    seeded layers on the same tokens."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'ring': [], 'pp': [], 'pp_tp': []}
    for dtype in (torch.bfloat16, torch.float32):
        for cp in RING_CPS:
            for bias_kind in (None, 'pasa'):
                out['ring'].append(dict(ring_rank_case(
                    fa, device, dtype, cp, bias_kind),
                    dtype=str(dtype).replace('torch.', '')))
    for dtype, depth in (('bfloat16', 12), ('float32', 4)):
        layers = seeded_layers(depth, dtype, device)
        x, cot = token_batch(1025, dtype, device, seed=22)
        ref = stack_reference(layers, x, cot)
        for stages, m in ((4, 8), (2, 4)):
            out['pp'].append(dict(pp_rank_case(fa, device, layers, x, cot,
                                               ref, stages, m),
                                  dtype=dtype, depth=depth))
        if dtype == 'bfloat16':
            for sp, l in ((False, 1025), (True, 1026)):
                if l != x.shape[1]:
                    x, cot = token_batch(l, dtype, device, seed=23)
                    ref = stack_reference(layers, x, cot)
                out['pp_tp'].append(pp_tp_rank_case(fa, device, layers, x,
                                                    cot, ref, sp))
        del layers, x, cot, ref
        torch.cuda.empty_cache()
    return out


DP_RANK_PHASES = {'step_f32': dp_rank_step_f32,
                  'tp_train_bf16': tp_rank_train_bf16,
                  'train_bf16': dp_rank_train_bf16, 'cli': dp_rank_cli,
                  'test': dp_rank_test, 'parallel': pp_rank_phases}


def dp_worker(spec_path):
    """The ranks' side of a start-up by ``launch_ranks``: ``python -m
    torch.distributed.run ... chip_smoke.py --dp-worker SPEC``. SPEC lists
    tasks, each a rank phase of DP_RANK_PHASES with its spec, run one after
    the other in this process; a task of fewer 'ranks' than the start-up
    runs on the lowest ranks, in a group of that size, and the others
    pass it by. A step task runs in a process group of its
    'backend' and 'device' (gloo with every rank on cuda:0, since NCCL
    takes one card per rank; or NCCL, one rank a card), kept for the next
    step task that wants the same one (the mesh is reset after each); CLI
    tasks (tools.train / tools.test with ``--launcher env``) set up and
    tear down their own. Whenever a task needs a new group, its store is
    made on the task's own port, so no group reads another's keys. Each
    task's result carries its seconds and the kernel shapes it launched;
    the results go to SPEC's 'out' + '.rank{RANK}.json'."""
    import torch
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    from s4former_tpu_torch.ops import flash_attention as fa
    from s4former_tpu_torch.parallel.distributed import init_distributed
    from s4former_tpu_torch.parallel.mesh import reset_mesh
    fa.load_library()                              # built by the parent
    fa.load_bwd_library()
    record_shapes(fa)
    group = device = None          # the live group's (backend, device)
    # a task starts from the process defaults, as in a start-up of its own
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    results = []
    world = int(os.environ['WORLD_SIZE'])
    try:
        for task in spec['tasks']:
            n = task.get('ranks') or world
            if int(os.environ['RANK']) >= n:
                results.append(None)       # a task of the lower ranks
                continue
            os.environ['WORLD_SIZE'] = str(n)
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
            want = None if task['kind'] in ('cli', 'test') else (
                task['backend'], task['device'], n)
            if group is not None and group != want:
                torch.distributed.destroy_process_group()
                group = device = None
            if 'port' in task:
                os.environ['MASTER_PORT'] = str(task['port'])
                os.environ.pop('TORCHELASTIC_USE_AGENT_STORE', None)
            if want is not None and group is None:
                device = init_distributed('env', backend=want[0],
                                          device=want[1])
                group = want
            before = (set(FWD_SEEN), set(BWD_SEEN))
            FWD_SEEN.clear()
            BWD_SEEN.clear()
            t0 = time.perf_counter()
            result = DP_RANK_PHASES[task['kind']](fa, task['spec'], device)
            result['seconds'] = time.perf_counter() - t0
            result['fwd_shapes'] = sorted(FWD_SEEN, key=str)
            result['bwd_shapes'] = sorted(BWD_SEEN, key=str)
            FWD_SEEN.update(before[0])
            BWD_SEEN.update(before[1])
            if group is not None:
                reset_mesh()
            torch.cuda.empty_cache()
            results.append(result)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    with open(f"{spec['out']}.rank{os.environ['RANK']}.json", 'w') as f:
        json.dump(results, f)
    return 0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch_ranks(tasks, n, directory, timeout):
    """One start-up of ``n`` ranks under torch.distributed.run running
    ``tasks`` (each {'kind', 'spec', 'ranks', 'backend', 'device'}; a task
    of fewer ranks on the lowest) in turn (``dp_worker``); with more than
    one, each task gets a port of its own for a group it makes. Returns
    each task's results, rank 0 first."""
    if len(tasks) > 1:
        tasks = [dict(t, port=free_port()) for t in tasks]
    name = '_'.join(t['kind'] for t in tasks)[:60] + f'_{n}'
    out = os.path.join(directory, name)
    spec_path = out + '.json'
    with open(spec_path, 'w') as f:
        json.dump({'tasks': tasks, 'out': out}, f)
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           f'--nproc_per_node={n}', os.path.abspath(__file__),
           '--dp-worker', spec_path]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-6000:], file=sys.stderr)
        print(proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f'{n} ranks of {[t["kind"] for t in tasks]} '
          f'exited with {proc.returncode}')
    by_rank = []
    for r in range(n):
        with open(f'{out}.rank{r}.json') as f:
            by_rank.append(json.load(f))
        for result in filter(None, by_rank[-1]):
            FWD_SEEN.update(tuple(x) for x in result['fwd_shapes'])
            BWD_SEEN.update(tuple(x) for x in result['bwd_shapes'])
    return [[ranks[i] for ranks in by_rank if ranks[i] is not None]
            for i in range(len(tasks))]


def run_here(fa, tasks):
    """CLI tasks of one rank run in this process, each under a launcher
    environment of one rank (a store on a port of its own): what a
    start-up of one rank would run, without the ~20 s of starting it. On
    one card the phases of min(2, cards) ranks have one. Returns each
    task's results as ``launch_ranks`` does."""
    keys = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK')
    saved = {k: os.environ.get(k) for k in keys}
    results = []
    try:
        for task in tasks:
            os.environ.update(MASTER_ADDR='127.0.0.1',
                              MASTER_PORT=str(free_port()), RANK='0',
                              WORLD_SIZE='1', LOCAL_RANK='0')
            t0 = time.perf_counter()
            result = DP_RANK_PHASES[task['kind']](fa, task['spec'], None)
            result['seconds'] = time.perf_counter() - t0
            results.append([result])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return results


def rank_task(kind, spec, n, backend=None, device=None):
    """A task a phase yields to ``run_together``: ``kind`` on ``n`` ranks,
    step tasks in a group of ``backend`` on ``device``."""
    return {'kind': kind, 'spec': spec, 'ranks': n, 'backend': backend,
            'device': device}


def run_together(fa, phases, directory, timeout=900):
    """Phases whose ranks share start-ups. Each of ``phases`` (name, a
    function returning a generator) does its own work first, then yields
    the list of its rank tasks (``rank_task``) once, is sent their results
    (each task's ranks, rank 0 first) and returns its launch counts. The
    tasks of every phase that run on the same number of ranks go to one
    start-up, the CLI tasks first, then the step tasks, each kind in the
    phases' order: starting the ranks (interpreter, torch, the card) is
    the cost this saves. Tasks of more than one rank but fewer than the
    most any task asks for run in that start-up too, on its lowest ranks,
    after its CLI tasks and before its own step tasks. CLI tasks of one
    rank run in this process (``run_here``). Returns (each phase's value,
    each phase's seconds: its own work and its tasks' on the ranks, each
    start-up's wall seconds)."""
    import torch
    gens, asked, seconds = {}, {}, {}
    for name, make in phases:
        t0 = time.perf_counter()
        gens[name] = make()
        asked[name] = next(gens[name])
        seconds[name] = time.perf_counter() - t0
    torch.cuda.empty_cache()        # the ranks share the card
    groups = {}
    most = max((t['ranks'] for tasks in asked.values() for t in tasks),
               default=1)
    for name, tasks in asked.items():
        for i, t in enumerate(tasks):
            n = most if t['ranks'] > 1 else 1
            groups.setdefault(n, []).append((name, i, t))
    results = {name: [None] * len(tasks) for name, tasks in asked.items()}
    startups = {}
    for n, items in groups.items():
        # the CLI runs first, each as the first of its kind in fresh
        # processes (their in-loop evals then run as in a start-up of
        # their own); then the step tasks
        items.sort(key=lambda item: (item[2]['kind'] not in ('cli', 'test'),
                                     item[2]['ranks'] == n))
        t0 = time.perf_counter()
        tasks = [t for _, _, t in items]
        here = n == 1 and all(t['kind'] in ('cli', 'test') for t in tasks)
        if here:
            done = run_here(fa, tasks)
        else:
            done = launch_ranks(tasks, n, directory, timeout)
        label = ('this process: ' if here else f'{n} ranks: ') + ', '.join(
            f'{name}/{t["kind"]}' + ('' if t['ranks'] == n else
                                     f' on {t["ranks"]}')
            for name, _, t in items)
        startups[label] = time.perf_counter() - t0
        for (name, i, _), ranks in zip(items, done):
            results[name][i] = ranks
            seconds[name] += max(r['seconds'] for r in ranks)
    out = {}
    for name, gen in gens.items():
        t0 = time.perf_counter()
        try:
            gen.send(results[name])
        except StopIteration as stop:
            out[name] = stop.value
        else:
            raise SmokeFailure(f'{name} asked for ranks twice')
        seconds[name] += time.perf_counter() - t0
    return out, seconds, startups


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
    batches = save_batches(dp_global_batches(images, 4, 3), root, 'dp_step')
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
    states = {phase: os.path.join(root, f'{phase}.pt') for phase, *_ in grids}
    results = yield [rank_task('step_f32', {
        'batches': batches, 'state_out': states[phase], 'teacher':
        teacher_out, 'pin': pin, 'mp': mp, 'zero3': zero3}, n_ranks,
        backend, device)
        for phase, pin, n_ranks, mp, zero3, backend, device in grids]
    for (phase, pin, n_ranks, mp, zero3, backend, device), ranks in zip(
            grids, results):
        state_out = states[phase]
        ranks_s = max(r['seconds'] for r in ranks)
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
              'single_s': single_s, 'ranks_task_s': ranks_s,
              'gpu': gpu_line})
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
    batches = save_batches(dp_global_batches(images, 4 * n, 1), root,
                           f'dp_train_{n}')
    backend = 'gloo' if on_one_card else None
    device = 'cuda:0' if on_one_card else 'cuda'
    ranks, = yield [rank_task('train_bf16', {'batches': batches}, n,
                              backend, device)]
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
          'logs_rank0': ranks[0]['logs'],
          'ranks_task_s': max(r['seconds'] for r in ranks),
          'gpu': gpu_line})
    for r in ranks:
        check(r['same'], 'the ranks\' states differ')
        check(r['launches'] == {'flash_attn_fwd': 36 * DP_TIMED,
                                'flash_attn_bwd_fused': 24 * DP_TIMED,
                                'flash_attn_bwd_dkv': 0,
                                'flash_attn_bwd_dq': 0},
              f'a rank launched {r["launches"]} in {DP_TIMED} steps, not 36 '
              f'forward and 24 fused a step')
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
    plan = (('train', ['--max-iters', '6'], 6),
            ('resume', ['--auto-resume', '--max-iters', '8'], 2))
    results = yield [rank_task('cli', {'argv': [FULLFLAG, '--work-dir', wd,
                                                '--launcher', 'env'] + argv +
                                       opts}, k)
                     for _, argv, _ in plan]
    for (name, argv, steps), ranks in zip(plan, results):
        runs[name] = (ranks, max(r['seconds'] for r in ranks))
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
          'ranks_task_s': {n: v[1] for n, v in runs.items()},
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


# tp_train_bf16's timed steps, after one warm-up step, in one process and
# on each grid's ranks; its depth and tp_train_cli's (the 12 layers cut to
# 4, one tap a layer: over gloo on one card these runs show equality,
# layout, memory and launches, not speed)
TP_TIMED = 2
TP_LAYERS = 4


def one_process_4x4(fa, images):
    """The one-process flagship step at 4 + 4 (what tp_train_bf16's grids
    split): a warm-up step, TP_TIMED timed, one profiled; its peak memory
    and parameter floats."""
    import numpy as np
    import torch
    state, step, _ = make_trainer('ours', 'cuda', None, TP_LAYERS)
    batch = to_device(train_batch(images, 4, 4), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    state, _, _ = timed_steps(state, step, batch, gen, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    state, logs, ms = timed_steps(state, step, batch, gen, TP_TIMED)
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
    """The flagship (bf16, DeiT-B width, depth cut to TP_LAYERS) at 512² on
    one global batch of 4 + 4, split three ways in one call: one process;
    2 ranks as data 1 x model 2 (each attends over 6 heads); 4 ranks as
    data 2 x model 2 with ZeRO-3 (2 + 2 a data index). Step ms, device ms
    and busy share, peak memory, launches and heads a rank, and the floats
    a rank's state holds. Over gloo on one card this shows equality,
    memory and launches, not speed: each block's two activation
    all-reduces make a host round trip there. Each rank must launch one
    process's 3 forward and 2 fused backward a layer a step, at 12/mp
    heads. Returns the ranks' launches summed."""
    import torch
    single, single_counts = one_process_4x4(fa, images)
    batches = save_batches(dp_global_batches(images, 4, 1), root, 'tp_train')
    nccl = torch.cuda.device_count() >= 4
    per_step = {'flash_attn_fwd': 3 * TP_LAYERS,
                'flash_attn_bwd_fused': 2 * TP_LAYERS,
                'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
    grids, total = {}, {n: 0 for n in KERNELS}
    plan = (('tp_1x2', 2, 2, False), ('tp_zero3_2x2', 4, 2, True))
    backends = {n: ('nccl', 'cuda') if nccl and n <= 4 else
                ('gloo', 'cuda:0') for _, n, _, _ in plan}
    results = yield [rank_task('tp_train_bf16', {
        'batches': batches, 'mp': mp, 'zero3': zero3}, n, *backends[n])
        for _, n, mp, zero3 in plan]
    for (name, n, mp, zero3), ranks in zip(plan, results):
        grids[name] = {'ranks': n, 'grid': f'data {n // mp} x model {mp}',
                       'zero3': zero3, 'backend': backends[n][0],
                       'ranks_task_s': max(r['seconds'] for r in ranks),
                       'per_rank': [{k: v for k, v in r.items()
                                     if k != 'logs'} for r in ranks],
                       'logs_rank0': ranks[0]['logs']}
        for r in ranks:
            check(r['launches'] == {k: TP_TIMED * v
                                    for k, v in per_step.items()},
                  f'{name}: a rank launched {r["launches"]} in {TP_TIMED} '
                  f'steps')
            check(r['heads'] == [12 // mp], f'{name}: heads {r["heads"]}')
            check(r['split'] and r['same'], f'{name}: split {r["split"]}, '
                  f'whole tensors identical {r["same"]}')
            check(all(v == v for v in r['logs'].values()), f'{name}: NaN '
                  f'logs {r["logs"]}')
        total = add_counts(total, sum_counts(ranks))
    emit({'phase': 'tp_train_bf16', 'config': 'ours',
          'batch': f'4 + 4 at 512² global, bf16, {TP_LAYERS} layers',
          'cut': f'num_layers 12 -> {TP_LAYERS}',
          'one_process': single, 'grids': grids,
          'note': 'gloo on one card: activation all-reduces go through '
                  'the host; equality, memory and launches, not speed',
          'gpu': gpu_line})
    check(single_counts == {k: TP_TIMED * v for k, v in per_step.items()},
          f'one process launched {single_counts}')
    return add_counts(total, single_counts)


def phase_tp_train_cli(fa, gpu_line, root):
    """``torch.distributed.run --nproc_per_node 4`` of ``tools.train
    --launcher env --model-parallel 2 --zero3`` (data 2 x model 2; NCCL one
    rank a card with 4 cards, else gloo with every rank on cuda:0) on
    ``setr_fixture_voc_mini_fullflag.py`` with its depth cut to
    TP_LAYERS, 1 + 1 a rank (the global 4 + 4 of one process, 2 + 2 a
    data index): 2 steps with eval and a checkpoint at 2, then
    ``--auto-resume`` to 3; the checkpoint has train_cli's names, shapes
    and dtypes, less its deeper layers; ``tools.test`` (one process) on
    ``iter_2``
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
    depth = [f'model.backbone.num_layers={TP_LAYERS}',
             f'model.backbone.out_indices={tuple(range(TP_LAYERS))}'
             .replace(' ', '')]
    opts = ['--cfg-options', 'evaluation.interval=2',
            'checkpoint_config.interval=2', 'log_config.interval=1',
            'samples_per_gpu_sup=1', 'samples_per_gpu_unsup=1'] + depth
    per_eval = TP_LAYERS * -(-16 // 4)
    runs = {}
    plan = (('train', ['--max-iters', '2'], 2, 1),
            ('resume', ['--auto-resume', '--max-iters', '3'], 1, 0))
    results = yield [rank_task('cli', {'argv': [FULLFLAG, '--work-dir', wd,
                                                '--launcher', 'env'] + grid +
                                       argv + opts}, n)
                     for _, argv, _, _ in plan]
    for (name, argv, steps, evals), ranks in zip(plan, results):
        runs[name] = (ranks, max(r['seconds'] for r in ranks))
        for r in ranks:
            want = {'flash_attn_fwd': 3 * TP_LAYERS * steps +
                    per_eval * evals,
                    'flash_attn_bwd_fused': 2 * TP_LAYERS * steps,
                    'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
            check(r['launches'] == want, f'tp_train_cli {name}: a rank '
                  f'launched {r["launches"]}, not {want}')
    text = read_logs(wd)
    for line in ('4 ranks (env), 2 data x 2 model',
                 'sharded state: model axis = 2 (Megatron), zero3 = True',
                 f'resumed from {os.path.join(wd, "iter_2")} (iter 2)'):
        check(line in text, f'tp_train_cli: no "{line}" in the log')
    layout = checkpoint_layout(os.path.join(wd, 'iter_2'))
    kept = {key: {n: v for n, v in part.items()
                  if int((re.match(r'backbone\.layers\.(\d+)\.', n) or
                          [0, 0])[1]) < TP_LAYERS}
            for key, part in CHECKPOINT_LAYOUT.items()}
    check(layout == kept, 'the sharded checkpoint differs from train_cli\'s '
          f'first {TP_LAYERS} layers in names, shapes or dtypes')
    records = read_jsonl(os.path.join(wd, 'metrics.jsonl'))
    val = {r['step']: r for r in records if r['prefix'] == 'val'}
    losses = {r['step']: r['loss'] for r in records
              if r['prefix'] == 'train'}
    check(sorted(val) == [2] and all(np.isfinite(v) for v in
                                     losses.values()),
          f'tp_train_cli records {records}')
    reset_counts(fa)
    results = test_cli.main([FULLFLAG, os.path.join(wd, 'iter_2'),
                             '--cfg-options'] + depth)
    test_counts = counts(fa)
    gap = abs(results['mIoU'] - val[2]['mIoU'])
    emit({'phase': 'tp_train_cli', 'config': os.path.basename(FULLFLAG),
          'ranks': n, 'grid': 'data 2 x model 2, zero3',
          'backend': 'nccl, one rank a card' if nccl else
          'gloo, every rank on cuda:0',
          'batch': f'1 + 1 a rank, 4 + 4 global at 512², bf16, '
                   f'{TP_LAYERS} layers',
          'losses': losses, 'in_loop_miou_iter_2': val[2]['mIoU'],
          'eval_s': val[2]['eval_s'], 'test_miou': results['mIoU'],
          'miou_gap': gap, 'tol': TOL_MIOU,
          'checkpoint_equals_train_cli': True,
          'ranks_task_s': {k: v[1] for k, v in runs.items()},
          'launches_per_rank': {k: [r['launches'] for r in v[0]]
                                for k, v in runs.items()},
          'peak_mem_bytes_per_rank': {k: [r['peak_mem_bytes'] for r in v[0]]
                                      for k, v in runs.items()},
          'launches_test': test_counts, 'gpu': gpu_line})
    check(gap <= TOL_MIOU, f'tp_train_cli: offline mIoU {results["mIoU"]} '
          f'vs in-loop {val[2]["mIoU"]}')
    shutil.rmtree(wd, ignore_errors=True)
    out = test_counts
    for ranks, _ in runs.values():
        out = add_counts(out, sum_counts(ranks))
    return out


def run_dp(fa, images, gpu_line, root, more):
    """The data-parallel, sharded, pipeline and ring phases, their rank
    tasks started together (``run_together``): on one card the 2-rank step
    grids, the 1 x 2 sharded step and dp_train_bf16 in one start-up;
    tp_train_cli's runs, then the ZeRO-3 step, the 2 x 2 sharded step and
    the pipeline and ring grids in one of 4 ranks; dp_train_cli's train and
    resume on min(2, cards) ranks (in this process when that is one), with
    ``more``, the other phases whose ranks start with these:
    test_cli_ranks. Prints 'dp_seconds' (each
    phase's own work and its tasks' seconds on the ranks, and each
    start-up's wall seconds) and 'pp_seconds'. Returns the launch counts
    by path."""
    import torch
    cards = torch.cuda.device_count()
    phases = [
        ('dp_step_f32', lambda: phase_dp_step_f32(fa, images, gpu_line,
                                                  root)),
        ('tp_train_bf16', lambda: phase_tp_train_bf16(fa, images, gpu_line,
                                                      root)),
        ('tp_train_cli', lambda: phase_tp_train_cli(fa, gpu_line, root)),
        ('dp_train_bf16', lambda: phase_dp_train_bf16(
            fa, images, gpu_line, root, DP_RANKS, on_one_card=True)),
        ('dp_train_cli', lambda: phase_dp_train_cli(fa, gpu_line, root)),
        ('pp', lambda: phase_pp(fa, gpu_line))] + list(more)
    if cards > 1:
        # the multi-card path itself: one rank a card over NCCL
        phases.append(('dp_train_bf16_cards', lambda: phase_dp_train_bf16(
            fa, images, gpu_line, root, min(4, cards), on_one_card=False)))
    else:
        emit({'phase': 'dp_train_bf16_cards', 'skipped': f'{cards} card'})
    t0 = time.perf_counter()
    out, seconds, startups = run_together(fa, phases, root)
    wall = time.perf_counter() - t0
    paths = {}
    for name, result in out.items():
        if name in ('dp_step_f32', 'pp'):      # by path
            paths.update(result)
        else:
            paths[name] = result
    pp_s = seconds.pop('pp')
    emit({'phase': 'dp_seconds', **seconds, 'startups_s': startups,
          'total': wall})
    emit({'phase': 'pp_seconds', 'run_s': pp_s})
    return paths


def ring_launches(fa, cp):
    """A rank's launches in one ring call: one forward a step; the fused
    backward a step for chunks up to FULL_Q_MAX, else dk/dv and dq."""
    long_blocks = RING_L // cp > fa.FULL_Q_MAX
    return {'flash_attn_fwd': cp,
            'flash_attn_bwd_fused': 0 if long_blocks else cp,
            'flash_attn_bwd_dkv': cp if long_blocks else 0,
            'flash_attn_bwd_dq': cp if long_blocks else 0}


def phase_pp(fa, gpu_line):
    """The pipeline- and context-parallel slice: 4 ranks (gloo, every rank
    on cuda:0) serve every grid (``pp_rank_phases``); prints
    ring_attention_bf16, ring_attention_f32, pp_bf16, pp_f32 and
    pp_tp_bf16 and fails unless each case holds its tolerance and each
    rank launched exactly the kernels its grid implies. Yields its rank
    task (``run_together``); returns the ranks' launches summed, by
    path."""
    ranks, = yield [rank_task('parallel', {}, 4, 'gloo', 'cuda:0')]
    paths = {'ring_attention': {n: 0 for n in KERNELS},
             'pp': {n: 0 for n in KERNELS}, 'pp_tp': {n: 0 for n in KERNELS}}
    for dname in ('bfloat16', 'float32'):
        short = {'bfloat16': 'bf16', 'float32': 'f32'}[dname]
        cases = []
        for i, case in enumerate(ranks[0]['ring']):
            if case['dtype'] != dname:
                continue
            per_rank = [r['ring'][i] for r in ranks]
            want = ring_launches(fa, case['cp'])
            for r in per_rank:
                check(r['launches'] == want, f'ring cp={case["cp"]} '
                      f'{dname}: a rank launched {r["launches"]}, not {want}')
                check(r['same_on_every_rank'], f'ring cp={case["cp"]}: '
                      f'ranks differ')
                paths['ring_attention'] = add_counts(
                    paths['ring_attention'], r['launches'])
            for key in ('vs_kernel', 'vs_plain'):
                errs = case[key]
                check(errs['o'] <= TOL[dname]['o'] and
                      errs['lse'] <= TOL[dname]['lse'] and
                      max(errs['dq_dk_dv']) <= TOL_BWD[dname],
                      f'ring cp={case["cp"]} bias={case["bias"]} {dname} '
                      f'{key}: {errs}')
            cases.append({**{k: v for k, v in case.items()
                             if k not in ('launches', 'ms')},
                          'ms_per_rank': [r['ms'] for r in per_rank],
                          'launches_per_rank': [r['launches']
                                                for r in per_rank],
                          'block_L': RING_L // case['cp']})
        emit({'phase': f'ring_attention_{short}', 'B': 1, 'L': RING_L,
              'H': 12, 'D': 64, 'ranks': 4,
              'grid': 'data 4 / cp x ctx cp, gloo on cuda:0', 'cases': cases,
              'tol_o': TOL[dname]['o'], 'tol_lse': TOL[dname]['lse'],
              'tol_grad': TOL_BWD[dname],
              'errors_are': 'o, lse: max abs error; dq, dk, dv: max abs '
                            'error / max |grad| of the reference',
              'gpu': gpu_line})
    for key, phases in (('pp', ('pp_bf16', 'pp_f32')),
                        ('pp_tp', ('pp_tp_bf16',))):
        for phase in phases:
            dname = 'float32' if phase.endswith('f32') else 'bfloat16'
            cases = []
            for i, case in enumerate(ranks[0][key]):
                if case.get('dtype', 'bfloat16') != dname:
                    continue
                per_rank = [r[key][i] for r in ranks]
                # every tick's layers, forward and backward
                per = (case['M'] + case['stages'] - 1) * case['layers']
                want = {'flash_attn_fwd': per, 'flash_attn_bwd_fused': per,
                        'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}
                for r in per_rank:
                    check(r['launches'] == want, f'{phase} {case["grid"]}: '
                          f'a rank launched {r["launches"]}, not {want}')
                    worst = max(r['out'], r['x_grad'], r['grads'])
                    check(worst <= TOL_PP[dname], f'{phase} {case["grid"]} '
                          f'stage {r["stage"]}: out {r["out"]}, x grad '
                          f'{r["x_grad"]}, stage grads {r["grads"]} > '
                          f'{TOL_PP[dname]}')
                    paths[key] = add_counts(paths[key], r['launches'])
                cases.append({'grid': case['grid'], 'M': case['M'],
                              'per_rank': per_rank})
            emit({'phase': phase, 'tokens': '[8, 1025, 768]' if key == 'pp'
                  else '[8, 1025 | 1026, 768]', 'heads': 12,
                  'layers': 4 if dname == 'float32' else 12,
                  'cases': cases, 'tol': TOL_PP[dname],
                  'errors_are': 'max abs error / max |value| of the '
                                'one-process sequential stack, per tensor',
                  'gpu': gpu_line})
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
        return dp_worker(sys.argv[2])
    if sys.argv[1:2] == ['--cpu-side']:
        return cpu_side(sys.argv[2])
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
          'count': torch.cuda.device_count(),
          'host_cpus': os.cpu_count(),
          'cpus_allowed': len(os.sched_getaffinity(0)),
          'torch_threads': torch.get_num_threads()})

    sys.path.insert(0, REPO)
    os.chdir(REPO)             # the configs' data roots are repo-relative
    from s4former_tpu_torch.native import build as native_build
    from s4former_tpu_torch.ops import cuda_build
    from s4former_tpu_torch.ops import flash_attention as fa
    global CPU_SIDE
    side_dir = tempfile.mkdtemp(prefix='chip_smoke_cpu_side_')
    CPU_SIDE = CpuSide(side_dir)
    try:
        return drive(fa, native_build, cuda_build, gpu_line)
    finally:
        CPU_SIDE.close()
        shutil.rmtree(side_dir, ignore_errors=True)


def drive(fa, native_build, cuda_build, gpu_line) -> int:
    """``main``'s phases, the CPU side running."""
    import torch
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:   # g++ beside the two nvcc builds
        native_lib = pool.submit(native_build.build)
        libs = cuda_build.build_all([fa.SOURCE, fa.BWD_SOURCE])
        native_lib = native_lib.result()
    fa.load_library()
    fa.load_bwd_library()
    record_shapes(fa)
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
    phase_kernels_zoo(fa, entries)      # at SETR-MLA's ViT-L heads
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
             'flash_attn_bwd_dkv': 0, 'flash_attn_bwd_dq': 0}, timed=3,
            trace_dir=os.path.join(root, 'trace_4x4'))
        deit, n_backbone = write_deit_files(root)
        wd = os.path.join(root, 'work')
        paths['train_cli'], windows = phase_train_cli(
            fa, gpu_line, wd, deit['bare'], n_backbone)
        paths['test_cli'] = phase_test_cli(
            fa, gpu_line, os.path.join(wd, 'iter_12'), root)
        # the eval-and-tools slice on the same checkpoints
        eval_paths, test_cli_ranks = run_eval_tools(fa, gpu_line, wd, root,
                                                    images)
        paths.update(eval_paths)
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
                 lambda: phase_mit_serve_bf16(fa, frames[:4], gpu_line)),
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
        # the ViT model zoo: SETR-MLA (ViT-L, H = 16) and Segmenter
        paths.update(run_zoo(fa, images, gpu_line, root))
        # the CNN slice: DeepLabV3+ and the other ResNet bases (no kernel)
        paths.update(run_cnn(fa, images, gpu_line, root))
        # UPerNet-Swin-T and OCRNet-HRNet-18 (no kernel)
        paths.update(run_swin_hrnet(fa, images, gpu_line, root))
        # the real-time CNNs: BiSeNetV1/V2, STDC, Fast-SCNN, CGNet,
        # ERFNet, LR-ASPP (no kernel)
        paths.update(run_realtime(fa, images, gpu_line, root))
        # the context heads: DeepLabV3 on MobileNetV2-D8 and the NL, GC,
        # DNL, ANN, APC, DM, EMA, Enc, ISA, PSA and DA heads (no kernel)
        paths.update(run_context(fa, images, gpu_line, root))
        # the ablation slice: the rest of the step's flags
        paths.update(run_ablation(fa, images, gpu_line, root))
        # the UniMatch slice and the ViT's remat
        paths.update(run_unimatch(fa, images, gpu_line, root))
        # data, tensor, pipeline and context parallelism: 2 and 4 ranks
        # (and test_cli_ranks' ranks)
        paths.update(run_dp(fa, images, gpu_line, root, [test_cli_ranks]))

    # each kernel at each shape the paths launched
    phase_kernels_seen(fa, entries)
    for name in KERNELS:
        entries[name]['launches'] = sum(p[name] for p in paths.values())
        entries[name]['launches_by_path'] = {k: p[name]
                                             for k, p in paths.items()}
        check(entries[name]['launches'] > 0, f'{name} never ran on a path')
    # how long each phase waited for its CPU half, and each half's seconds
    # in the CPU side
    emit({'phase': 'cpu_side', 'threads': CPU_SIDE_THREADS,
          'nice': CPU_SIDE_NICE, 'waited_s': CPU_SIDE.waited,
          'total_waited_s': sum(CPU_SIDE.waited.values()),
          'jobs_s': CPU_SIDE.job_seconds()})
    emit({'phase': 'total', 'seconds': time.perf_counter() - T_START})
    print(gpu_line)
    emit({'kernels': [entries[name] for name in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
