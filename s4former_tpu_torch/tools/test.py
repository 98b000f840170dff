"""Evaluation CLI of the port (counterpart of ``tools/test.py``; reference:
tools/test.py and single_gpu_test, mmseg/apis/test.py:34):

    python -m s4former_tpu_torch.tools.test CONFIG [CHECKPOINT]
        [--eval mIoU] [--out preds.pkl] [--device cuda|cpu]
        [--cfg-options k=v ...]

CHECKPOINT is a training checkpoint directory of the port's runner
(``work_dir/iter_N``) or a reference-layout ``.pth``. The test set goes
through the in-loop eval's exact path (``core.runner.iter_predictions``),
so at the same checkpoint the mIoU is the runner's. Runs on one CUDA
device unless ``--device cpu`` is given. Not ported yet, and refused with
``NotImplementedError``: ``--aug-test``, ``--show-dir`` and
``--format-only``.
"""
import argparse

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Test a segmentor (PyTorch port, one GPU)')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--eval', nargs='+', default=['mIoU'])
    parser.add_argument('--aug-test', action='store_true',
                        help='multi-scale + flip TTA (not ported)')
    parser.add_argument('--out', help='dump the label maps here (.pkl)')
    parser.add_argument('--show-dir', help='painted results (not ported)')
    parser.add_argument('--format-only', action='store_true',
                        help='submission files only (not ported)')
    parser.add_argument('--imgfile-prefix', default='format_results',
                        help='output dir for --format-only')
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def main(argv=None):
    """Evaluate; returns the metrics dict of ``dataset.evaluate``."""
    args = parse_args(argv)
    unported = [flag for flag, on in (('--aug-test', args.aug_test),
                                      ('--show-dir', args.show_dir),
                                      ('--format-only', args.format_only))
                if on]
    if unported:
        raise NotImplementedError(f'not ported yet: {", ".join(unported)}')
    from s4former_tpu_torch.tools.train import resolve_device
    device = resolve_device(args.device)

    import pickle

    import numpy as np
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.checkpoint import load_model_state_dict
    from s4former_tpu_torch.core.runner import iter_predictions
    from s4former_tpu_torch.data import build_dataset
    from s4former_tpu_torch.utils.logger import get_root_logger

    logger = get_root_logger()
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
    test_cfg = cfg.model.get('test_cfg') or {}
    # slide geometry from test_cfg (reference slide_inference reads
    # test_cfg.crop_size/stride); the train crop is the fallback
    crop = tuple(test_cfg.get('crop_size', cfg.get('crop_size', (512, 512))))
    stride = tuple(test_cfg.get('stride', (341, 341)))
    pre_eval_results, preds = [], {}
    for idx, pred in iter_predictions(model, dataset,
                                      mode=test_cfg.get('mode', 'whole'),
                                      crop_size=crop, stride=stride):
        if args.out:
            preds[idx] = pred.astype(np.uint8)
        pre_eval_results.extend(dataset.pre_eval([pred], [idx]))
        if len(pre_eval_results) % 50 == 0:
            logger.info(f'{len(pre_eval_results)}/{len(dataset)} images')
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump([preds[i] for i in sorted(preds)], f)
        logger.info(f'wrote {len(preds)} predictions to {args.out}')

    results = dataset.evaluate(pre_eval_results, metric=args.eval)
    for k, v in results.items():
        if not k.startswith(('IoU.', 'Acc.', 'Dice.', 'Fscore.')):
            logger.info(f'{k}: {v:.4f}')
    print({k: round(v, 4) for k, v in results.items()
           if k in ('aAcc', 'mIoU', 'mAcc', 'mDice', 'mFscore')})
    return results


if __name__ == '__main__':
    main()
