"""Semi-supervised batch loader: sampler + thread pool + prefetch queue (the
port's copy of ``s4former_tpu/data/loader.py``; reference:
mmseg/datasets/samplers/semi_sampler.py:9-150, builder.py:116-309).

- ``SemiBalanceSampler``: an endless stream of (sup, unsup, mix) index
  lists with a fixed count per batch (4 + 4 in the paper configs), each
  source reshuffled on its own when used up, seeded per epoch.
- ``SemiLoader``: pipelines run in a thread pool and are stacked into the
  numpy batch dict the train step reads (``sup_img``, ``sup_gt``,
  ``unsup_teacher_img``, ``unsup_student_img``, ...), behind a bounded
  queue so host augmentation overlaps the device's step. The runner's
  prefetcher moves the batches to the card.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from s4former_tpu_torch.registry import SAMPLERS

QUEUE_DEPTH = 2   # finished batches waiting for the runner


@SAMPLERS.register_module()
class SemiBalanceSampler:
    """Fixed-ratio multi-source index stream (semi_sampler.py:9-150).

    ``by_prob`` is accepted and ignored, as in the reference, which stores
    it (semi_sampler.py:35) and never reads it. Each ``__iter__`` pass
    draws from pools permuted by a generator seeded with (seed + epoch)
    and advances the epoch (reference :66-69).
    """

    def __init__(self, num_sup: int, num_unsup: int,
                 sup_per_batch: int, unsup_per_batch: int,
                 seed: int = 0, by_prob: bool = False,
                 num_mix: int = 0,
                 max_iter_size: Optional[int] = None, **kwargs):
        self.num_sup = num_sup
        self.num_unsup = num_unsup
        self.num_mix = num_mix
        self.sup_per_batch = sup_per_batch
        self.unsup_per_batch = unsup_per_batch
        self.seed = seed
        self.max_iter_size = max_iter_size
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[List[int], List[int], List[int]]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        pools: Dict[str, List[int]] = {'sup': [], 'unsup': [], 'mix': []}
        sizes = {'sup': self.num_sup, 'unsup': self.num_unsup,
                 'mix': self.num_mix}
        counts = {'sup': self.sup_per_batch, 'unsup': self.unsup_per_batch,
                  'mix': self.unsup_per_batch if self.num_mix else 0}
        it = 0
        while self.max_iter_size is None or it < self.max_iter_size:
            draw = {}
            for name in pools:
                n = counts[name]
                if n == 0:
                    draw[name] = []
                    continue
                while len(pools[name]) < n:
                    pools[name].extend(rng.permutation(sizes[name]).tolist())
                draw[name] = [pools[name].pop(0) for _ in range(n)]
            yield draw['sup'], draw['unsup'], draw['mix']
            it += 1


def _stack_tagged(items, default_tag: str) -> Dict[str, np.ndarray]:
    """Group pipeline outputs by their ``tag`` (ExtraAttrs) and stack them:
    '{tag}_img' (f32 NHWC) and '{tag}_gt' (int32) for each tag present.
    Takes plain result dicts or MultiBranch lists (builder.py:295-303)."""
    groups: Dict[str, list] = {}
    for it in items:
        for b in it if isinstance(it, list) else [it]:
            groups.setdefault(b.get('tag', default_tag), []).append(b)
    out: Dict[str, np.ndarray] = {}
    for tag, results in groups.items():
        out[f'{tag}_img'] = np.stack([r['img'] for r in results]
                                     ).astype(np.float32)
        if 'gt_semantic_seg' in results[0]:
            out[f'{tag}_gt'] = np.stack(
                [r['gt_semantic_seg'] for r in results]).astype(np.int32)
    return out


class SemiLoader:
    """Iterator of train-step batch dicts.

    The sup and unsup datasets are indexed by a SemiBalanceSampler; items
    run through their pipelines in a thread pool; finished batches wait in
    a queue of ``QUEUE_DEPTH`` batches. ``unsup_mix_dataset`` is the UniMatch
    third source (its batch keys are ``*_mix_img``).
    """

    def __init__(self, sup_dataset, unsup_dataset=None,
                 unsup_mix_dataset=None,
                 sup_per_batch: int = 4, unsup_per_batch: int = 4,
                 num_workers: int = 8, seed: int = 0,
                 max_iter_size: Optional[int] = None):
        self.sup = sup_dataset
        self.unsup = unsup_dataset
        self.unsup_mix = unsup_mix_dataset
        self.sampler = SemiBalanceSampler(
            len(sup_dataset),
            len(unsup_dataset) if unsup_dataset is not None else 0,
            sup_per_batch,
            unsup_per_batch if unsup_dataset is not None else 0,
            num_mix=(len(unsup_mix_dataset)
                     if unsup_mix_dataset is not None else 0),
            seed=seed, max_iter_size=max_iter_size)
        self.num_workers = num_workers
        self.pool: Optional[ThreadPoolExecutor] = None
        self._queue: 'queue.Queue' = queue.Queue(maxsize=QUEUE_DEPTH)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _make_batch(self, sup_idx, unsup_idx, mix_idx
                    ) -> Dict[str, np.ndarray]:
        def submit(dataset, indices):
            if dataset is None:
                return []
            return [self.pool.submit(dataset.__getitem__, i)
                    for i in indices]
        sup_futs = submit(self.sup, sup_idx)
        unsup_futs = submit(self.unsup, unsup_idx)
        mix_futs = submit(self.unsup_mix, mix_idx)
        batch = _stack_tagged([f.result() for f in sup_futs], 'sup')
        if unsup_futs:
            batch.update(_stack_tagged([f.result() for f in unsup_futs],
                                       'unsup_student'))
        if mix_futs:
            batch.update(_stack_tagged([f.result() for f in mix_futs],
                                       'unsup_student_mix'))
        return batch

    def _put(self, item) -> bool:
        """Queue ``item`` unless the loader is closed first."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            for sup_idx, unsup_idx, mix_idx in self.sampler:
                if self._stop.is_set() or not self._put(
                        self._make_batch(sup_idx, unsup_idx, mix_idx)):
                    return
            self._put(None)
        except Exception as e:  # surfaced to the consumer by __iter__
            self._put(e)

    def __iter__(self):
        if self._thread is None:
            self.pool = ThreadPoolExecutor(max_workers=self.num_workers)
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True, name='s4-loader')
            self._thread.start()
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            if isinstance(batch, Exception):
                raise batch
            yield batch

    def close(self):
        """Stop the producer and the pool; pending pipelines are
        cancelled."""
        self._stop.set()
        if self.pool is not None:
            self.pool.shutdown(wait=False, cancel_futures=True)
        if self._thread is not None:
            self._thread.join(timeout=10)
