"""Evaluation CLI of the port (counterpart of ``tools/test.py``; reference:
tools/test.py and single_gpu_test, mmseg/apis/test.py:34):

    python -m s4former_tpu_torch.tools.test CONFIG [CHECKPOINT]
        [--eval mIoU] [--aug-test] [--out preds.pkl] [--show-dir D]
        [--format-only [--imgfile-prefix P]] [--opacity 0.5]
        [--device cuda|cpu] [--cfg-options k=v ...]

CHECKPOINT is a training checkpoint directory of the port's runner
(``work_dir/iter_N``) or a reference-layout ``.pth``. The test set goes
through the in-loop eval's exact path (``core.runner.iter_predictions``),
so at the same checkpoint the mIoU is the runner's; with ``--aug-test``
each image goes through ``apis.inference_segmentor_tta`` instead (six
ratios and flip, softmax averaged at the original size). ``--show-dir``
writes each prediction painted over its image (``utils.palette``),
``--format-only`` the dataset's submission files
(``dataset.format_results``; of the ported datasets only
``CityscapesDataset`` has one) and skips the evaluation. Runs on one CUDA
device unless ``--device cpu`` is given.

Not ported, and refused with ``NotImplementedError``: the JAX CLI's eval
fast mode (``S4_EVAL_BUCKET``), which bounds XLA recompiles; the port's
eager eval has none to bound.
"""
import argparse
import os
import os.path as osp

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Test a segmentor (PyTorch port, one GPU)')
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
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def _predictions(args, cfg, model, dataset):
    """(index, label map at the label's shape) for every test image: the
    exact eval path, or TTA with ``--aug-test``."""
    from s4former_tpu_torch.core.runner import iter_predictions
    test_cfg = cfg.model.get('test_cfg') or {}
    if args.aug_test:
        from s4former_tpu_torch.apis import Segmentor, inference_segmentor_tta
        segmentor = Segmentor(model, cfg, next(model.parameters()).device)
        for idx in range(len(dataset)):
            yield idx, inference_segmentor_tta(
                segmentor, dataset.img_infos[idx]['filename'])
        return
    # slide geometry from test_cfg (reference slide_inference reads
    # test_cfg.crop_size/stride); the train crop is the fallback
    crop = tuple(test_cfg.get('crop_size', cfg.get('crop_size', (512, 512))))
    stride = tuple(test_cfg.get('stride', (341, 341)))
    yield from iter_predictions(model, dataset,
                                mode=test_cfg.get('mode', 'whole'),
                                crop_size=crop, stride=stride)


def main(argv=None):
    """Evaluate; returns the metrics dict of ``dataset.evaluate``, or None
    with ``--format-only``."""
    args = parse_args(argv)
    if os.environ.get('S4_EVAL_BUCKET'):
        raise NotImplementedError(
            'not ported: the eval fast mode (S4_EVAL_BUCKET); the port '
            'evaluates on the exact path')
    from s4former_tpu_torch.parallel.distributed import resolve_device
    device = resolve_device(args.device)

    import pickle

    import numpy as np
    from PIL import Image
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.checkpoint import load_model_state_dict
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.utils.collect_env import format_env
    from s4former_tpu_torch.utils.logger import get_root_logger
    from s4former_tpu_torch.utils.palette import paint_result

    logger = get_root_logger()
    logger.info('environment:\n' + format_env())
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    pth = args.checkpoint if args.checkpoint and \
        args.checkpoint.endswith(('.pth', '.pt')) else None
    model = init_segmentor(cfg, checkpoint=pth, device=device).model
    if args.checkpoint and pth is None:
        model.load_state_dict(load_model_state_dict(args.checkpoint))
    if args.checkpoint:
        logger.info(f'loaded {args.checkpoint}')

    dataset = build_dataset(cfg.data['test'])
    pre_eval_results, preds = [], {}
    for n, (idx, pred) in enumerate(_predictions(args, cfg, model, dataset),
                                    1):
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
        if args.format_only:
            # one image at a time: the predictions never sit in memory
            # together (the reference collects them first)
            dataset.format_results([pred], args.imgfile_prefix,
                                   indices=[idx])
        else:
            pre_eval_results.extend(dataset.pre_eval([pred], [idx]))
        if n % 50 == 0:
            logger.info(f'{n}/{len(dataset)} images')
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump([preds[i] for i in sorted(preds)], f)
        logger.info(f'wrote {len(preds)} predictions to {args.out}')
    if args.format_only:
        logger.info(f'wrote submission files to {args.imgfile_prefix}')
        return None

    results = dataset.evaluate(pre_eval_results, metric=args.eval)
    for k, v in results.items():
        if not k.startswith(('IoU.', 'Acc.', 'Dice.', 'Fscore.')):
            logger.info(f'{k}: {v:.4f}')
    print({k: round(v, 4) for k, v in results.items()
           if k in ('aAcc', 'mIoU', 'mAcc', 'mDice', 'mFscore')})
    return results


if __name__ == '__main__':
    main()
