"""Training CLI of the port (counterpart of ``tools/train.py``; reference:
tools/train.py:115-255):

    python -m s4former_tpu_torch.tools.train CONFIG [--work-dir D]
        [--load-from X.pth] [--resume-from D/iter_N] [--auto-resume]
        [--seed N] [--max-iters N] [--no-validate] [--device cuda|cpu]
        [--profile FIRST N] [--cfg-options k=v ...]

config -> datasets -> ``SemiLoader`` -> ``make_semi_train_step`` ->
``IterBasedRunner`` with periodic exact eval and checkpoints. The log
starts with the environment (``utils.collect_env``) and says how many of
the model's tensors the pretrained file overlaid. ``--profile FIRST N``
traces steps FIRST..FIRST+N-1 into ``WORK_DIR/profile/trace.json``
(``python -m s4former_tpu_torch.tools.profile_trace`` reads it). Runs on one
CUDA device unless ``--device cpu`` is given; without a card it fails.
Not ported yet, and refused with ``NotImplementedError``:
``--model-parallel`` > 1, ``--zero3``, a ``--launcher`` other than 'none',
the UniMatch mix stream, and layer-wise LR decay (the train step refuses
``paramwise_cfg``).
"""
import argparse
import os
import os.path as osp
import time

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Train a segmentor (PyTorch port, one GPU)')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--load-from', help='initial weights (.pth)')
    parser.add_argument('--resume-from', help='checkpoint dir to resume from')
    parser.add_argument('--auto-resume', action='store_true')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--diff-seed', action='store_true',
                        help='fold the process index into the seed '
                             '(reference --diff_seed); one process here, '
                             'index 0')
    parser.add_argument('--deterministic', action='store_true',
                        help='cuDNN deterministic, no autotune (reference '
                             '--deterministic)')
    parser.add_argument('--max-iters', type=int, default=None,
                        help='override runner.max_iters')
    parser.add_argument('--no-validate', action='store_true')
    parser.add_argument('--model-parallel', type=int, default=1,
                        help='tensor-parallel size (not ported: 1 only)')
    parser.add_argument('--zero3', action='store_true',
                        help='ZeRO-3 sharding (not ported)')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'tpu', 'slurm', 'mpi', 'env'],
                        help="multi-process bootstrap (not ported: 'none')")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--profile', nargs=2, type=int, default=None,
                        metavar=('FIRST', 'N'),
                        help='trace steps FIRST..FIRST+N-1 (from 1) into '
                             'WORK_DIR/profile/trace.json')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def check_unported(args):
    if args.model_parallel > 1 or args.zero3 or args.launcher != 'none':
        raise NotImplementedError(
            'not ported yet: --model-parallel > 1, --zero3 and --launcher '
            'other than none (multi-card training)')


def resolve_device(name: str):
    """The torch device for ``--device``; a CUDA device without a card is
    an error (no CPU fallback)."""
    import torch
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device; '
                           'pass --device cpu to run on the CPU')
    return device


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    args = parse_args(argv)
    check_unported(args)
    device = resolve_device(args.device)

    import torch
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import IterBasedRunner, make_eval_fn
    from s4former_tpu_torch.data import SemiLoader, build_dataset
    from s4former_tpu_torch.semi.config import SemiConfig
    from s4former_tpu_torch.semi.train_step import (create_train_state,
                                                    make_semi_train_step)
    from s4former_tpu_torch.utils.collect_env import format_env
    from s4former_tpu_torch.utils.logger import get_root_logger

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    work_dir = args.work_dir or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(osp.join(work_dir, osp.basename(args.config)))
    logger = get_root_logger(osp.join(
        work_dir, time.strftime('%Y%m%d_%H%M%S') + '.log'))
    logger.info('environment:\n' + format_env())
    logger.info(f'device: {device}' + (
        f' ({torch.cuda.get_device_name(device)})'
        if device.type == 'cuda' else ''))

    # seeded weights, overlaid by the pretrained .pth (--load-from, else
    # the backbone's init_cfg checkpoint when that file exists)
    init_ckpt = args.load_from
    init_cfg = cfg.model.get('backbone', {}).get('init_cfg')
    if init_ckpt is None and isinstance(init_cfg, dict):
        init_ckpt = init_cfg.get('checkpoint')
    if init_ckpt and not osp.isfile(init_ckpt):
        logger.warning(f'pretrained {init_ckpt} not found; training from '
                       f'scratch')
        init_ckpt = None
    # init_segmentor logs how many tensors the file overlaid, and raises
    # when it overlays none
    model = init_segmentor(cfg, checkpoint=init_ckpt, seed=args.seed,
                           device=device).model
    semi_cfg = SemiConfig.from_model_cfg(cfg.model)
    state = create_train_state(model, ema=semi_cfg.ema)

    # data
    train_cfg = cfg.data['train']
    sup_ds = build_dataset(train_cfg['sup']) if 'sup' in train_cfg else \
        build_dataset(train_cfg)
    unsup_ds = None
    if semi_cfg.ema and train_cfg.get('unsup'):
        unsup_ds = build_dataset(train_cfg['unsup'])
        if train_cfg.get('unsup_mix') or train_cfg.get('unsup2'):
            raise NotImplementedError(
                'not ported yet: the UniMatch mix stream (unsup_mix)')
    sup_pb = cfg.get('samples_per_gpu_sup',
                     cfg.data.get('samples_per_gpu', 8) // 2
                     if unsup_ds is not None
                     else cfg.data.get('samples_per_gpu', 8))
    unsup_pb = cfg.get('samples_per_gpu_unsup', sup_pb) \
        if unsup_ds is not None else 0
    loader = SemiLoader(sup_ds, unsup_ds, sup_per_batch=sup_pb,
                        unsup_per_batch=unsup_pb,
                        num_workers=cfg.data.get('workers_per_gpu', 4) * 2,
                        seed=args.seed)
    logger.info(f'sup dataset: {len(sup_ds)} imgs' +
                (f', unsup: {len(unsup_ds)} imgs' if unsup_ds else '') +
                f'; {sup_pb} + {unsup_pb} a step')

    # train step from the config
    opt = cfg.get('optimizer', {})
    lr_cfg = cfg.get('lr_config', {})
    pw_cfg = opt.get('paramwise_cfg', {}) or {}
    custom_keys = {k: v.get('lr_mult', 1.0)
                   for k, v in pw_cfg.get('custom_keys', {}).items()}
    layer_decay = None
    if 'num_layers' in pw_cfg and 'decay_rate' in pw_cfg:
        layer_decay = dict(num_layers=pw_cfg['num_layers'],
                           decay_rate=pw_cfg['decay_rate'],
                           decay_type=pw_cfg.get('decay_type', 'layer_wise'))
    max_iters = args.max_iters or cfg.get('runner', {}).get('max_iters',
                                                            80001)
    grad_clip = (cfg.get('optimizer_config', {}) or {}).get('grad_clip')
    step_fn = make_semi_train_step(
        model, semi_cfg, num_classes=model.num_classes,
        base_lr=opt.get('lr', 0.01), max_iters=max_iters,
        power=lr_cfg.get('power', 0.9), min_lr=lr_cfg.get('min_lr', 1e-4),
        sgd_momentum=opt.get('momentum', 0.9),
        weight_decay=opt.get('weight_decay', 0.0),
        custom_keys=custom_keys or None,
        grad_clip_norm=grad_clip.get('max_norm') if grad_clip else None,
        paramwise_cfg=layer_decay)

    eval_fn = None
    if not args.no_validate and 'val' in cfg.data:
        try:
            val_ds = build_dataset(cfg.data['val'])
            # slide geometry from test_cfg, as tools.test reads it
            test_cfg = cfg.model.get('test_cfg') or {}
            eval_fn = make_eval_fn(
                val_ds, mode=test_cfg.get('mode', 'whole'),
                crop_size=tuple(test_cfg.get(
                    'crop_size', cfg.get('crop_size', (512, 512)))),
                stride=tuple(test_cfg.get('stride', (341, 341))))
        except FileNotFoundError as e:
            logger.warning(f'val dataset unavailable ({e}); skipping eval')

    runner = IterBasedRunner(
        step_fn, state, loader, max_iters=max_iters, work_dir=work_dir,
        log_interval=cfg.get('log_config', {}).get('interval', 50),
        checkpoint_interval=cfg.get('checkpoint_config', {}).get(
            'interval', 5750),
        eval_interval=cfg.get('evaluation', {}).get('interval', 1150),
        eval_fn=eval_fn, seed=args.seed, logger=logger,
        profile=tuple(args.profile) if args.profile else None)
    try:
        runner.resume(args.resume_from, auto=args.auto_resume)
        return runner.run()
    finally:
        loader.close()


if __name__ == '__main__':
    main()
