"""Metric logging hook (counterpart of ``JsonlLoggerHook`` in
``s4former_tpu/core/hooks.py``; reference: the MMSegWandbHook contract,
mmseg/core/hook/wandblogger_hook.py:15).

``JsonlLoggerHook`` appends one JSON object per logging event to
``work_dir/metrics.jsonl``: ``step``, ``time``, ``prefix`` ('train' or
'val') and the float metrics. The validation-image panels
(``log_eval_images``) are still to be ported.

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

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = 'train'):
        record = {'step': int(step), 'time': time.time(), 'prefix': prefix}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, 'a') as f:
            f.write(json.dumps(record) + '\n')


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
