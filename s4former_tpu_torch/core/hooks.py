"""Metric logging hook (counterpart of ``JsonlLoggerHook`` in
``s4former_tpu/core/hooks.py``; reference: the MMSegWandbHook contract,
mmseg/core/hook/wandblogger_hook.py:15).

``JsonlLoggerHook`` appends one JSON object per logging event to
``work_dir/metrics.jsonl``: ``step``, ``time``, ``prefix`` ('train' or
'val') and the float metrics. ``log_eval_images`` writes the validation
image | GT | prediction panels of an eval to ``work_dir/eval_vis/iter_N/``
(JAX hooks.py:49-103). When the optional ``wandb`` package is importable and
a run is live, both also go to it, the panels as a ``wandb.Table``.

Profiling (JAX ``profile_steps``, hooks.py:105, on ``jax.profiler``):
``StepTrace`` records a window of steps with ``torch.profiler``, host
(every thread's operator calls and CUDA runtime calls) and, on a card,
device activity, and writes it as a chrome trace, ``trace.json`` in its
directory; ``profile_steps`` traces steps of one fixed batch after a
warm-up step outside the trace, and the runner traces a window of a
training run (``tools/train.py --profile``).
``s4former_tpu_torch/tools/profile_trace.py`` reads the trace.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict

import torch

from s4former_tpu_torch.registry import HOOKS


@HOOKS.register_module()
class JsonlLoggerHook:
    """Append one JSON object per logging event to metrics.jsonl."""

    def __init__(self, work_dir: str, filename: str = 'metrics.jsonl'):
        os.makedirs(work_dir, exist_ok=True)
        self.path = osp.join(work_dir, filename)
        self._wandb = None
        try:
            import wandb  # optional
            if wandb.run is not None:
                self._wandb = wandb
        except Exception:
            pass

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = 'train'):
        record = {'step': int(step), 'time': time.time(), 'prefix': prefix}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, 'a') as f:
            f.write(json.dumps(record) + '\n')
        if self._wandb is not None:
            self._wandb.log({f'{prefix}/{k}': v for k, v in
                             metrics.items()}, step=step)

    def log_eval_images(self, step: int, images, preds, gts,
                        palette=None, max_images: int = 8) -> str:
        """Side-by-side image | GT overlay | prediction overlay panels of
        the first ``max_images`` samples, as PNGs under
        ``work_dir/eval_vis/iter_{step}/{i:03d}.png`` and, with a live wandb
        run, a ``wandb.Table`` (reference MMSegWandbHook val table,
        wandblogger_hook.py:199-317). A float image is stretched to uint8
        by its min and max, and resized to the label map's shape; label
        255 paints as class 0. Returns the directory."""
        import numpy as np
        from PIL import Image
        from s4former_tpu_torch.data.pipelines.transforms import _pil_resize
        from s4former_tpu_torch.utils.palette import paint_result
        out_dir = osp.join(osp.dirname(self.path), 'eval_vis',
                           f'iter_{int(step)}')
        os.makedirs(out_dir, exist_ok=True)
        if palette is None:
            palette = np.random.RandomState(42).randint(
                0, 255, (256, 3)).tolist()
        rows = []
        for i, (img, pred, gt) in enumerate(zip(images, preds, gts)):
            if i >= max_images:
                break
            img = np.asarray(img)
            if img.dtype != np.uint8:
                lo, hi = float(img.min()), float(img.max())
                img = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(
                    np.uint8)
            pred, gt = np.asarray(pred), np.asarray(gt)
            if img.shape[:2] != pred.shape[:2]:
                # the captured input is at the eval pipeline's scale; the
                # label maps at the original shape
                img = _pil_resize(img, (pred.shape[1], pred.shape[0]))
            pred_vis = paint_result(img, np.where(pred == 255, 0, pred),
                                    palette)
            gt_vis = paint_result(img, np.where(gt == 255, 0, gt), palette)
            path = osp.join(out_dir, f'{i:03d}.png')
            Image.fromarray(np.concatenate([img, gt_vis, pred_vis],
                                           axis=1)).save(path)
            rows.append((path, pred, gt))
        if self._wandb is not None and rows:
            wandb = self._wandb
            table = wandb.Table(columns=['image', 'ground_truth',
                                         'prediction'])
            for path, pred, gt in rows:
                table.add_data(
                    wandb.Image(path),
                    wandb.Image(path, masks={
                        'ground_truth': {'mask_data': gt}}),
                    wandb.Image(path, masks={
                        'prediction': {'mask_data': pred}}))
            wandb.log({'val/examples': table}, step=int(step))
        return out_dir


class StepTrace:
    """A ``torch.profiler`` recording of the steps run inside ``with``:
    CPU activity, and CUDA activity when ``device`` is a card. On exit it
    waits for the card, then writes ``out_dir/trace.json``
    (``self.path``)."""

    TRACE_FILE = 'trace.json'

    def __init__(self, out_dir: str, device):
        from torch.profiler import ProfilerActivity, profile
        self.device = torch.device(device)
        self.path = osp.join(out_dir, self.TRACE_FILE)
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        self._prof = profile(activities=activities)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
        return False


def profile_steps(step_fn, state, batch, generator: torch.Generator,
                  out_dir: str, num_steps: int = 3):
    """Trace ``num_steps`` train steps of one batch into
    ``out_dir/trace.json``, after one warm-up step outside the trace (JAX
    hooks.py:105; ``generator`` takes the place of its ``rng``). Returns
    the final state."""
    device = state.step.device
    state, _ = step_fn(state, batch, generator)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    with StepTrace(out_dir, device):
        for _ in range(num_steps):
            state, _ = step_fn(state, batch, generator)
    return state
