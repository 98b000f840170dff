"""Metric logging hook (counterpart of ``JsonlLoggerHook`` in
``s4former_tpu/core/hooks.py``; reference: the MMSegWandbHook contract,
mmseg/core/hook/wandblogger_hook.py:15).

``JsonlLoggerHook`` appends one JSON object per logging event to
``work_dir/metrics.jsonl``: ``step``, ``time``, ``prefix`` ('train' or
'val') and the float metrics. The validation-image panels
(``log_eval_images``) and ``profile_steps`` are still to be ported.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict

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
