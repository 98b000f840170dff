"""Iteration-based training runner and the exact in-loop evaluation
(counterpart of ``s4former_tpu/core/runner.py``; reference:
mmseg/apis/train.py:70-269 with mmcv's IterBasedRunner, TextLoggerHook,
EvalHook and CheckpointHook).

- ``IterBasedRunner`` calls the port's train step directly (eager; the
  student, SGD buffers and teacher update in place). Each step's
  ``torch.Generator`` is reseeded from (seed, step), so a resumed run draws
  the same CutMix boxes and shuffles as an uninterrupted one, as the JAX
  step derives its key from ``state.step``. The host reads the step's logs
  only every ``log_interval`` steps: between logs the loop waits on
  nothing but the loader. Every log writes ``data_wait_ms`` (host ms a
  step blocked on the loader) and ``step_ms`` (the window's time a step,
  eval and checkpoint time taken out) to ``metrics.jsonl``; every eval
  its metrics and ``eval_s`` and its first images' panels
  (``eval_vis/iter_N/``), and the best mIoU a ``best/`` checkpoint.
  With ``profile=(first, n)`` the steps first..first+n-1 (counting from
  1) run under ``core.hooks.StepTrace``, loader and prefetcher running,
  into ``work_dir/profile/trace.json``.
- ``_DevicePrefetcher`` moves batches to the card on a side CUDA stream
  from pinned memory while the step runs.
- ``make_eval_fn``: per image the raw head logits of the pipeline image,
  padded to the patch size (the padding the ViT would add itself), are
  resized to the label's shape by the two per-image interp matrices of
  ``eval_resize_matrices`` (head resolution -> image -> original shape,
  the reference's two bilinear resizes composed), then argmax: the
  reference's whole-image inference, exactly.

Under data parallelism (``parallel/``) every rank runs the loop; only rank
0 writes logs, metrics, traces and checkpoints, all ranks wait for each
other before a resume (which loads on every rank, onto its card) and at
the end of the run; the eval splits the forwards over the ranks and sums
their histograms, so its metrics are the single-process ones, bit for bit,
and rank 0 paints the panels from the label maps the ranks send it.
"""
from __future__ import annotations

import logging
import os.path as osp
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from s4former_tpu_torch.core import checkpoint as ckpt_lib
from s4former_tpu_torch.core.hooks import JsonlLoggerHook, StepTrace
from s4former_tpu_torch.core.metrics import pre_eval_to_metrics
from s4former_tpu_torch.ops.resize import interp_matrix_np
from s4former_tpu_torch.parallel.distributed import (barrier, is_main, rank,
                                                     world_size)
from s4former_tpu_torch.parallel.mesh import global_sum
from s4former_tpu_torch.utils.logger import get_root_logger

# batches copied to the card ahead of the step, and how long ``run`` waits
# for that many before its first step
PREFETCH_DEPTH = 2
WARM_TIMEOUT_S = 60.0

class _DevicePrefetcher:
    """A thread takes batches (dicts of numpy arrays) from the loader and
    copies them to ``device``, up to ``PREFETCH_DEPTH`` ahead of the step.

    On CUDA each array is copied into pinned host memory and sent with a
    ``non_blocking`` copy on a side stream. ``get`` makes the consuming
    stream wait for the side stream, so the step cannot read a batch still
    in flight, and records each tensor on the consuming stream, so the
    allocator does not hand its memory to the next copy while the step
    still reads it. Loader errors are raised by ``get``."""

    def __init__(self, data_iter: Iterator, device):
        self.device = torch.device(device)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == 'cuda' else None)
        self._q: 'queue.Queue' = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._sentinel = object()

        def work():
            try:
                for item in data_iter:
                    if self._stop.is_set() or not self._put(
                            self._to_device(item)):
                        return
                self._put(self._sentinel)
            except Exception as e:  # raised again by get()
                self._put(e)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name='s4-prefetch')
        self._thread.start()

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        if self._side is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in batch.items()}
        with torch.cuda.stream(self._side):
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    .pin_memory().to(self.device, non_blocking=True)
                    for k, v in batch.items()}

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def get(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._sentinel:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        if self._side is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_stream(self._side)
            for t in item.values():
                t.record_stream(consumer)
        return item

    def warm(self):
        """Wait until the queue is full (or ``WARM_TIMEOUT_S``), so the
        first steps start from ready batches."""
        deadline = time.monotonic() + WARM_TIMEOUT_S
        while self._q.qsize() < self._q.maxsize and \
                self._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


class IterBasedRunner:
    def __init__(self,
                 train_step: Callable,
                 state,
                 loader: Iterable,
                 max_iters: int,
                 work_dir: str,
                 log_interval: int = 50,
                 checkpoint_interval: int = 5750,
                 eval_interval: int = 1150,
                 eval_fn: Optional[Callable] = None,
                 seed: int = 0,
                 logger: Optional[logging.Logger] = None,
                 profile: Optional[Tuple[int, int]] = None):
        self.train_step = train_step
        self.state = state
        self.loader = loader
        self.max_iters = max_iters
        self.work_dir = work_dir
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.eval_interval = eval_interval
        self.eval_fn = eval_fn
        self.seed = seed
        self.device = state.step.device
        self.generator = torch.Generator(device=self.device)
        self.logger = logger or get_root_logger()
        self.best_miou = -1.0
        self.is_main = is_main()
        self.metrics_hook = JsonlLoggerHook(work_dir)
        self.profile = profile if self.is_main else None

    def resume(self, path: Optional[str] = None, auto: bool = False):
        barrier()
        if path is None and auto:
            path = ckpt_lib.find_latest_checkpoint(self.work_dir)
        if path:
            self.state = ckpt_lib.load_checkpoint(path, self.state)
            self.logger.info(f'resumed from {path} '
                             f'(iter {int(self.state.step)})')

    def run(self):
        it = int(self.state.step)
        prefetcher = _DevicePrefetcher(iter(self.loader), self.device)
        trace = None
        try:
            prefetcher.warm()
            t_window = time.perf_counter()
            data_wait = 0.0   # host time blocked on the prefetch queue
            off_step = 0.0    # eval and checkpoint time inside the window
            while it < self.max_iters:
                if self.profile and it + 1 == self.profile[0]:
                    trace = StepTrace(osp.join(self.work_dir, 'profile'),
                                      self.device).__enter__()
                t_data = time.perf_counter()
                batch = prefetcher.get()
                data_wait += time.perf_counter() - t_data
                self.generator.manual_seed(step_seed(self.seed, it))
                self.state, logs = self.train_step(self.state, batch,
                                                   self.generator)
                it += 1
                if trace is not None and it + 1 == sum(self.profile):
                    trace.__exit__(None, None, None)
                    self.logger.info(f'traced steps {self.profile[0]}-{it} '
                                     f'into {trace.path}')
                    trace = None
                if it % self.log_interval == 0:
                    host_logs = {k: float(v) for k, v in logs.items()}
                    dt = time.perf_counter() - t_window - off_step
                    t_window = time.perf_counter()
                    off_step = 0.0
                    host_logs['data_wait_ms'] = \
                        1e3 * data_wait / self.log_interval
                    host_logs['step_ms'] = 1e3 * dt / self.log_interval
                    data_wait = 0.0
                    self._log(it, host_logs)
                t_off = time.perf_counter()
                if self.eval_fn is not None and it % self.eval_interval == 0:
                    self._evaluate(it)
                if it % self.checkpoint_interval == 0:
                    self._checkpoint(it)
                off_step += time.perf_counter() - t_off
        finally:
            if trace is not None:       # the run ended inside the window
                trace.__exit__(None, None, None)
            prefetcher.close()
        if it % self.checkpoint_interval != 0:  # avoid a double final save
            self._checkpoint(it)
        if self.is_main:
            # work_is_done must mean "the checkpoints on disk are complete"
            ckpt_lib.finalize_pending_saves()
            # completion sentinel: the reference's Slurm array wrappers
            # cancel pending restart jobs when this file appears
            # (run_setr_supervised.sh:10-14)
            with open(osp.join(self.work_dir, 'work_is_done'), 'w') as f:
                f.write(f'iter {it}\n')
        barrier()
        return self.state

    def _log(self, it: int, host_logs: Dict[str, float]):
        if not self.is_main:
            return
        step_ms = host_logs['step_ms']
        msg = ', '.join(f'{k}: {v:.4f}' for k, v in sorted(host_logs.items())
                        if k not in ('step_ms', 'data_wait_ms'))
        self.logger.info(
            f'Iter [{it}/{self.max_iters}] {1e3 / step_ms:.2f} it/s, '
            f'data_wait {host_logs["data_wait_ms"]:.0f} ms/it, {msg}')
        self.metrics_hook.log(it, host_logs)
        if host_logs.get('mask_ratio', 1.0) == 0.0 and \
                it <= 5 * self.log_interval:
            self.logger.info(
                'note: mask_ratio=0 — no teacher pixel above the confidence '
                'threshold yet, so unsup losses are 0; expected early in '
                'training / from random init')

    def _evaluate(self, it: int):
        t0 = time.perf_counter()
        metrics = self.eval_fn(self.state)
        eval_s = time.perf_counter() - t0
        if not self.is_main:
            return
        miou = float(metrics.get('mIoU', np.nan))
        self.logger.info(
            f'Eval @ iter {it}: ' +
            ', '.join(f'{k}: {v:.4f}' for k, v in metrics.items()) +
            f' ({eval_s:.1f}s)')
        self.metrics_hook.log(it, {**metrics, 'eval_s': eval_s},
                              prefix='val')
        samples = getattr(self.eval_fn, 'last_samples', None)
        if samples:
            self.metrics_hook.log_eval_images(
                it, *zip(*samples),
                palette=getattr(self.eval_fn, 'palette', None))
        if miou > self.best_miou:
            self.best_miou = miou
            ckpt_lib.save_checkpoint(
                osp.join(self.work_dir, 'best'), it, self.state, keep=1,
                meta={'mIoU': miou, 'iter': it}, block=False)

    def _checkpoint(self, it: int):
        if not self.is_main:
            return
        # the state is on the host when save returns; the write goes on in
        # the background, so the step loop resumes at once
        path = ckpt_lib.save_checkpoint(self.work_dir, it, self.state,
                                        meta={'iter': it}, block=False)
        self.logger.info(f'saving checkpoint {path} (async)')


# ----------------------------------------------------------------- eval
def _pad_to_bucket(img: np.ndarray, bucket: int):
    """Round H and W of an NHWC batch up to multiples of ``bucket`` (zeros
    bottom/right). Returns (padded, (h, w) valid size)."""
    h, w = img.shape[1:3]
    ph = -(-h // bucket) * bucket
    pw = -(-w // bucket) * bucket
    if (ph, pw) != (h, w):
        img = np.pad(img, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
    return img, (h, w)


def infer_pad_divisor(model) -> int:
    """The model's own corner-pad granularity: a ViT pads its input to a
    multiple of its patch size before embedding (reference
    AdaptivePadding, mmseg/models/utils/embed.py:12-81), so pre-padding an
    eval image to that multiple changes nothing the network computes."""
    p = getattr(getattr(model, 'backbone', None), 'patch_size', None)
    return int(p) if isinstance(p, int) and p > 1 else 1


def eval_resize_matrices(vh: int, vw: int, lh: int, lw: int,
                         ph: int, pw: int, gt_shape,
                         align: bool, out_bucket: int):
    """Per-image (gh-bucketed x ph) and (gw-bucketed x pw) logit-resize
    matrices of the reference's two-stage chain (encoder_decoder.py:281-296
    and :1118-1172): raw head logits at ``(lh, lw)`` --bilinear--> the
    valid image shape ``(vh, vw)`` --bilinear--> ``gt_shape``. Both stages
    are 2-tap interp matrices, so their product is one matrix. ``ph``/
    ``pw`` are the logit tensor's dims; columns past ``lh``/``lw`` are
    zero, as are rows past ``gt_shape``."""
    gh, gw = gt_shape
    bh = -(-gh // out_bucket) * out_bucket
    bw = -(-gw // out_bucket) * out_bucket
    m_h = np.zeros((bh, ph), np.float32)
    m_w = np.zeros((bw, pw), np.float32)
    for m, lsrc, v, g in ((m_h, lh, vh, gh), (m_w, lw, vw, gw)):
        m2 = (np.eye(v, dtype=np.float32) if g == v
              else interp_matrix_np(v, g, align))
        if lsrc == v:
            m[:g, :v] = m2
        else:
            m[:g, :lsrc] = m2 @ interp_matrix_np(lsrc, v, align)
    return m_h, m_w


def iter_predictions(model, dataset, batch_size: int = 4,
                     mode: str = 'whole', crop_size=(512, 512),
                     stride=(341, 341), shard: Tuple[int, int] = (0, 1),
                     images: Optional[Dict[int, np.ndarray]] = None
                     ) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
    """(index, int32 label map at the label's shape) for every item of
    ``dataset``, in flush order. With ``shard=(rank, world)`` the groups
    are numbered in flush order and group g is predicted on rank
    g % world; the other groups' items come as (index, None), so every
    rank knows the flush order.

    Items are padded to the model's own pad divisor (the patch size: the
    padding the network would add itself, so the logits are the
    reference's) and grouped by (padded input, label bucket) shape; each
    group of ``batch_size`` runs as one forward (a partial group repeats
    its last image), then the per-image resize matrices and the argmax on
    the model's device. Only the int32 prediction comes back to the host.
    The raw head logits are resized in full (whole mode); ``mode`` 'slide'
    averages windows of ``crop_size`` at ``stride`` at input resolution
    and resizes their valid region instead. ``images``: for each index
    among its keys, the valid region of the pipeline image is stored there
    as it is read, on every rank (the eval panels)."""
    from s4former_tpu_torch.models.segmentors.inference import \
        slide_inference
    device = next(model.parameters()).device
    n_cls = model.num_classes
    align = model.align_corners
    bucket = infer_pad_divisor(model)
    bsz = max(1, int(batch_size))
    matrix_cache: Dict = {}
    n_flushed = [0]

    def flush(entries):
        n = len(entries)
        n_flushed[0] += 1
        if (n_flushed[0] - 1) % shard[1] != shard[0]:
            return [(e[0], None) for e in entries]
        padded = entries + [entries[-1]] * (bsz - n)
        imgs = np.concatenate([e[1] for e in padded], axis=0)
        with torch.inference_mode():
            x = torch.from_numpy(imgs).to(device)
            if mode == 'slide':
                logits = slide_inference(model, x, n_cls, crop_size, stride)
            else:
                logits = model.forward_decode_from_img(x, train=False)
            lh, lw = logits.shape[1:3]
            mh, mw = [], []
            for _, _, vh, vw, gt in padded:
                key = (vh, vw, lh, lw) + tuple(gt.shape)
                if key not in matrix_cache:
                    sh, sw = (vh, vw) if mode == 'slide' else (lh, lw)
                    matrix_cache[key] = eval_resize_matrices(
                        vh, vw, sh, sw, lh, lw, gt.shape, align, bucket)
                mh.append(matrix_cache[key][0])
                mw.append(matrix_cache[key][1])
            m_h = torch.from_numpy(np.stack(mh)).to(device)
            m_w = torch.from_numpy(np.stack(mw)).to(device)
            y = torch.einsum('noh,nhwc->nowc', m_h, logits.float())
            y = torch.einsum('npw,nhwc->nhpc', m_w, y)
            preds = y.argmax(dim=-1).to(torch.int32).cpu().numpy()
        return [(idx, pred[:gt.shape[0], :gt.shape[1]])
                for (idx, _, _, _, gt), pred in zip(entries, preds[:n])]

    buffers: Dict = {}   # shape key -> pending entries
    for idx in range(len(dataset)):
        item = dataset.get_item_deterministic(idx, seed=0)
        if isinstance(item, list):   # MultiScaleFlipAug, one scale
            item = item[0]
        img = np.asarray(item['img'], np.float32)[None]
        img, (vh, vw) = _pad_to_bucket(img, bucket)
        if images is not None and idx in images:
            images[idx] = img[0, :vh, :vw]
        gt = dataset.get_gt_seg_map(idx)
        key = (img.shape[1], img.shape[2],
               -(-gt.shape[0] // bucket), -(-gt.shape[1] // bucket))
        pend = buffers.setdefault(key, [])
        pend.append((idx, img, vh, vw, gt))
        if len(pend) == bsz:
            yield from flush(pend)
            buffers[key] = []
    for pend in buffers.values():
        if pend:
            yield from flush(pend)


def reduce_pre_eval(local: Dict[int, tuple], order, num_classes: int,
                    device) -> list:
    """Per-image confusion histograms (``dataset.pre_eval``'s tuples) in
    the single-process order ``order``. In a process group each image's
    histograms are on the rank that predicted it; they are summed over the
    ranks through a zero-filled [image, (intersect, union, pred area,
    label area), class] table on ``device`` (counts below 2^24: exact in
    f32), so every rank gets every image's."""
    if world_size() > 1:
        n = max(order) + 1 if order else 0
        table = torch.zeros((n, 4, num_classes), device=device)
        for idx, hists in local.items():
            table[idx] = torch.from_numpy(np.stack(hists))
        table = global_sum(table).cpu().numpy()
        local = {idx: tuple(table[idx]) for idx in order}
    return [local[idx] for idx in order]


def gather_on_main(local: Dict) -> Dict:
    """Every rank's ``local`` dict merged on rank 0, by one
    ``gather_object``; the other ranks get ``{}``. Without a group,
    ``local`` itself."""
    if world_size() == 1:
        return local
    parts = [None] * world_size() if is_main() else None
    dist.gather_object(local, parts, dst=0)
    return {k: v for part in parts for k, v in part.items()} \
        if is_main() else {}


def make_eval_fn(dataset, batch_size: int = 4, mode: str = 'whole',
                 crop_size=(512, 512), stride=(341, 341),
                 capture_images: int = 4):
    """``eval_fn(state) -> {'aAcc', 'mIoU', 'mAcc'}`` over ``dataset`` with
    the state's student (``state.model``), streaming
    per-image confusion histograms (the reference's pre_eval path,
    custom.py:302 + eval_hooks.py). See ``iter_predictions``. In a process
    group each rank predicts its share of the groups; the per-image
    histograms are summed over the ranks (``reduce_pre_eval``) and reduced
    in the single-process flush order.

    ``eval_fn.last_samples`` holds (pipeline image at its valid size,
    prediction, label map) of the images of index < ``capture_images``,
    in index order, and ``eval_fn.palette`` the dataset's palette: the
    eval panels the runner logs (JAX runner.py:476-501), on rank 0. Every
    rank reads every image; of a prediction made on another rank only its
    label map comes over (``gather_on_main``)."""
    def eval_fn(state):
        shard = (rank(), world_size())
        device = next(state.model.parameters()).device
        order, local, preds = [], {}, {}
        images = dict.fromkeys(range(min(capture_images, len(dataset))))
        for idx, pred in iter_predictions(state.model, dataset, batch_size,
                                          mode, crop_size, stride, shard,
                                          images):
            order.append(idx)
            if pred is not None:
                local[idx] = dataset.pre_eval([pred], [idx])[0]
                if idx < capture_images:
                    preds[idx] = pred
        preds = gather_on_main(preds)
        eval_fn.last_samples = [
            (images[idx], preds[idx], dataset.get_gt_seg_map(idx))
            for idx in sorted(preds)]
        tables = pre_eval_to_metrics(
            reduce_pre_eval(local, order, state.model.num_classes, device),
            ('mIoU',))
        return {'aAcc': float(tables['aAcc']),
                'mIoU': float(np.nanmean(tables['IoU'])),
                'mAcc': float(np.nanmean(tables['Acc']))}
    eval_fn.last_samples = []
    eval_fn.palette = getattr(dataset, 'PALETTE', None)
    return eval_fn
