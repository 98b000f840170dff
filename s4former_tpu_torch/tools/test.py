"""Evaluation CLI of the port (counterpart of ``tools/test.py``; reference:
tools/test.py with single_gpu_test and multi_gpu_test, mmseg/apis/test.py):

    python -m s4former_tpu_torch.tools.test CONFIG [CHECKPOINT]
        [--eval mIoU] [--aug-test] [--out preds.pkl] [--show-dir D]
        [--format-only [--imgfile-prefix P]] [--opacity 0.5]
        [--launcher none|env|slurm|mpi] [--device cuda|cpu]
        [--cfg-options k=v ...]

CHECKPOINT is a training checkpoint directory of the port's runner
(``work_dir/iter_N``, or one ``tools.publish_model`` wrote) or a
reference-layout ``.pth``. The test set goes through the in-loop eval's
exact path (``core.runner.iter_predictions``), so at the same checkpoint
the mIoU is the runner's; with ``--aug-test`` each image goes through
``apis.inference_segmentor_tta`` instead (six ratios and flip, softmax
averaged at the original size). ``--show-dir`` writes each prediction
painted over its image (``utils.palette``), ``--format-only`` the
dataset's submission files (``dataset.format_results``; of the ported
datasets only ``CityscapesDataset`` and the two built on it have one) and
skips the evaluation. ``--eval cityscapes`` writes those files into
``--imgfile-prefix`` too and scores them with the official
``cityscapesscripts`` evaluator, which must be installed (an
``ImportError`` otherwise, as in the JAX package); other metrics beside
it come from the histograms.
Runs on a CUDA device unless ``--device cpu`` is given; without a card it
fails.

Over ranks: with ``--launcher env`` (``torchrun``, or
``s4former_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT NGPUS``),
``slurm`` or ``mpi`` one process runs on each card (``cuda:{LOCAL_RANK}``,
NCCL; gloo with ``--device cpu``). The exact path gives rank r the flush
groups g with g % world == r, so every image is predicted in the batch one
process would put it in; ``--aug-test`` gives rank r the images with
idx % world == r. The per-image histograms are summed over the ranks and
reduced in the single-process order, so the metrics equal one process's.
The rank that predicts an image writes its ``--show-dir`` and
``--format-only`` files: they are per image, so no label map has to move
for them, and the bytes are those one process writes. ``--out`` needs
every label map in one file: rank 0 gathers them and writes it. Every
rank returns the metrics; rank 0 alone logs and prints.

Not ported, and refused with ``NotImplementedError``: the JAX CLI's eval
fast mode (``S4_EVAL_BUCKET``), which bounds XLA recompiles; the port's
eager eval has none to bound.
"""
import argparse
import os
import os.path as osp
import re

import numpy as np

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Test a segmentor (PyTorch port)')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--eval', nargs='+', default=['mIoU'])
    parser.add_argument('--aug-test', action='store_true',
                        help='multi-scale (0.5-1.75) + flip TTA '
                             '(reference tools/test.py --aug-test)')
    parser.add_argument('--out', help='dump the label maps here (.pkl)')
    parser.add_argument('--show-dir', help='save painted results here')
    parser.add_argument('--format-only', action='store_true',
                        help='write submission files via '
                             'dataset.format_results, skip evaluation')
    parser.add_argument('--imgfile-prefix', default='format_results',
                        help='output dir for --format-only')
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'tpu', 'slurm', 'mpi', 'env'],
                        help="process-group bootstrap, one process a "
                             "card ('tpu' is refused: no TPU here)")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def _predictions(args, cfg, model, dataset, shard):
    """(index, label map at the label's shape) for every test image, in the
    single-process order: the exact path, or TTA with ``--aug-test``. An
    image another rank of ``shard`` = (rank, world) predicts comes as
    (index, None)."""
    from s4former_tpu_torch.core.runner import iter_predictions
    test_cfg = cfg.model.get('test_cfg') or {}
    if args.aug_test:
        from s4former_tpu_torch.apis import Segmentor, inference_segmentor_tta
        segmentor = Segmentor(model, cfg, next(model.parameters()).device)
        for idx in range(len(dataset)):
            yield idx, (inference_segmentor_tta(
                segmentor, dataset.img_infos[idx]['filename'])
                if idx % shard[1] == shard[0] else None)
        return
    # slide geometry from test_cfg (reference slide_inference reads
    # test_cfg.crop_size/stride); the train crop is the fallback
    crop = tuple(test_cfg.get('crop_size', cfg.get('crop_size', (512, 512))))
    stride = tuple(test_cfg.get('stride', (341, 341)))
    yield from iter_predictions(model, dataset,
                                mode=test_cfg.get('mode', 'whole'),
                                crop_size=crop, stride=stride, shard=shard)


def _fresh(a):
    out = np.empty(a.shape, np.uint8)
    out[...] = a
    return out


def main(argv=None):
    """Evaluate; returns the metrics dict of ``dataset.evaluate``, or None
    with ``--format-only``."""
    args = parse_args(argv)
    if os.environ.get('S4_EVAL_BUCKET'):
        raise NotImplementedError(
            'not ported: the eval fast mode (S4_EVAL_BUCKET); the port '
            'evaluates on the exact path')
    # a CUDA device without a card is an error (no CPU fallback)
    from s4former_tpu_torch.parallel.distributed import (init_distributed,
                                                         is_distributed)
    device = init_distributed(args.launcher, device=args.device)
    import torch.distributed as dist
    try:
        return _test(args, device)
    finally:
        if is_distributed():
            dist.destroy_process_group()


def _test(args, device):
    import logging
    import pickle

    from PIL import Image
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import (gather_on_main,
                                                reduce_pre_eval)
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.parallel.distributed import (barrier, is_main,
                                                         rank, world_size)
    from s4former_tpu_torch.utils.collect_env import format_env
    from s4former_tpu_torch.utils.logger import get_root_logger
    from s4former_tpu_torch.utils.palette import paint_result

    logger = get_root_logger()
    if not is_main():
        logger.setLevel(logging.ERROR)
    logger.info('environment:\n' + format_env())
    shard = (rank(), world_size())
    if shard[1] > 1:
        logger.info(f'{shard[1]} ranks ({args.launcher})')
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    model = init_segmentor(cfg, checkpoint=args.checkpoint,
                           device=device).model

    dataset = build_dataset(cfg.data['test'])
    # the official Cityscapes evaluator reads submission files
    cityscapes = 'cityscapes' in args.eval and not args.format_only
    order, local, preds = [], {}, {}
    for idx, pred in _predictions(args, cfg, model, dataset, shard):
        order.append(idx)
        if pred is None:
            continue
        if args.out:
            preds[idx] = pred.astype(np.uint8)
        if args.show_dir:
            os.makedirs(args.show_dir, exist_ok=True)
            info = dataset.img_infos[idx]
            painted = paint_result(info['filename'], pred, dataset.PALETTE,
                                   opacity=args.opacity)
            Image.fromarray(painted).save(osp.join(
                args.show_dir, osp.basename(info['ori_filename'])
                .replace('.jpg', '.png')))
        if args.format_only or cityscapes:
            # one image at a time: the predictions never sit in memory
            # together (the reference collects them first)
            dataset.format_results([pred], args.imgfile_prefix,
                                   indices=[idx])
        if not args.format_only:
            local[idx] = dataset.pre_eval([pred], [idx])[0]
        if len(order) % 50 == 0:
            logger.info(f'{len(order)}/{len(dataset)} images')
    if args.out:
        if shard[1] > 1:
            # copies into fresh arrays: an unpickled array's dtype is an
            # object of its own, which would pickle again with each array
            # and change the file's bytes
            preds = {k: _fresh(v) for k, v in gather_on_main(preds).items()}
        if is_main():
            with open(args.out, 'wb') as f:
                pickle.dump([preds[i] for i in sorted(preds)], f)
            logger.info(f'wrote {len(preds)} predictions to {args.out}')
    if args.format_only:
        barrier()            # every rank's files are written
        logger.info(f'wrote submission files to {args.imgfile_prefix}')
        return None

    kwargs = {}
    if cityscapes:
        barrier()            # every rank's files are written
        kwargs['imgfile_prefix'] = args.imgfile_prefix
    results = dataset.evaluate(
        reduce_pre_eval(local, order, len(dataset.CLASSES), device),
        metric=args.eval, **kwargs)
    barrier()
    for k, v in results.items():
        # per-class entries stay out of the log, a concat source's too
        if not re.sub(r'^\d+_', '', k).startswith(
                ('IoU.', 'Acc.', 'Dice.', 'Fscore.')):
            logger.info(f'{k}: {v:.4f}' if isinstance(v, float)
                        else f'{k}: {v}')
    if is_main():
        print({k: round(v, 4) for k, v in results.items()
               if k in ('aAcc', 'mIoU', 'mAcc', 'mDice', 'mFscore')})
    return results


if __name__ == '__main__':
    main()
