"""Inference throughput (counterpart of ``tools/benchmark.py``; reference:
tools/benchmark.py:23-81, which times 200 forwards):

    python -m s4former_tpu_torch.tools.benchmark CONFIG [--shape H [W]]
        [--batch B] [--iters 200] [--warmup 10] [--trace DIR]
        [--device cuda|cpu] [--cfg-options k=v ...]

The config's model with seeded random weights, in eval mode under
``torch.inference_mode``, forwards one random [B, H, W, 3] batch: the
warm-up forwards, then the timed ones between two
``torch.cuda.synchronize`` calls. Prints ``Overall fps: X img/s (Y
ms/img)``. ``--trace DIR`` records the timed loop with ``torch.profiler``
into ``DIR/trace.json`` (``core.hooks.StepTrace``), which
``python -m s4former_tpu_torch.tools.profile_trace DIR --steps ITERS``
reads. Runs on a CUDA device unless ``--device cpu`` is given; without a
card it fails.
"""
import argparse
import contextlib
import time

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Benchmark a segmentor')
    parser.add_argument('config')
    parser.add_argument('--shape', type=int, nargs='+', default=[512, 512])
    parser.add_argument('--batch', type=int, default=1)
    parser.add_argument('--iters', type=int, default=200)
    parser.add_argument('--warmup', type=int, default=10)
    parser.add_argument('--trace', metavar='DIR', default=None,
                        help='record the timed loop with torch.profiler '
                             'into DIR/trace.json')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def main(argv=None):
    """Benchmark; returns {'fps', 'ms_per_img', 'seconds', 'iters',
    'batch', 'shape'}."""
    args = parse_args(argv)
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device(args.device)

    import numpy as np
    import torch
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.hooks import StepTrace

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    h, w = (args.shape * 2)[:2]
    model = init_segmentor(cfg, device=device).model
    img = torch.from_numpy(np.random.RandomState(0).randn(
        args.batch, h, w, 3).astype(np.float32)).to(device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        for _ in range(args.warmup):
            model(img)
        sync()
        trace = (StepTrace(args.trace, device) if args.trace
                 else contextlib.nullcontext())
        with trace:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(img)
            sync()
            dt = time.perf_counter() - t0
    if args.trace:
        print(f'profiler trace written to {trace.path}')
    fps = args.iters * args.batch / dt
    ms = 1000 * dt / args.iters / args.batch
    print(f'Overall fps: {fps:.2f} img/s  ({ms:.2f} ms/img)')
    return {'fps': fps, 'ms_per_img': ms, 'seconds': dt,
            'iters': args.iters, 'batch': args.batch, 'shape': (h, w)}


if __name__ == '__main__':
    main()
