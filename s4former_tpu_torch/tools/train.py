"""Training CLI of the port (counterpart of ``tools/train.py``; reference:
tools/train.py:115-255):

    python -m s4former_tpu_torch.tools.train CONFIG [--work-dir D]
        [--load-from X.pth] [--resume-from D/iter_N] [--auto-resume]
        [--seed N] [--diff-seed] [--max-iters N] [--no-validate]
        [--launcher none|env|slurm|mpi] [--device cuda|cuda:N|cpu]
        [--backend nccl|gloo] [--model-parallel MP] [--zero3]
        [--profile FIRST N] [--cfg-options k=v ...]

config -> datasets -> ``SemiLoader`` -> ``make_semi_train_step`` ->
``IterBasedRunner`` with periodic exact eval and checkpoints. The log
starts with the environment (``utils.collect_env``) and says how many of
the model's tensors the pretrained file overlaid. ``--profile FIRST N``
traces steps FIRST..FIRST+N-1 into ``WORK_DIR/profile/trace.json``
(``python -m s4former_tpu_torch.tools.profile_trace`` reads it). Runs on one
CUDA device unless ``--device cpu`` is given; without a card it fails.
Every flag of the S4Former step runs, set in the config or with
``--cfg-options`` (e.g. ``model.use_fdrop=True``,
``model.backbone.drop_path_rate=0.1``,
``model.backbone.remat_layers=True``); ``optimizer.paramwise_cfg``'s
``num_layers`` and ``decay_rate`` turn on the layer-wise LR decay, as in
JAX tools/train.py:166-187. UniMatch takes ``model.unimatch=True`` and a
mix-source stream, ``data.train.unsup_mix`` (or ``unsup2``, as
``UniSemiDataset`` names it), whose pipeline tags its views
``unsup_teacher_mix``, ``unsup_student_mix`` and ``unsup_student_2_mix``
(JAX tools/train.py:140-154).

Data parallelism: with ``--launcher env`` (``torchrun``, or
``s4former_tpu_torch/tools/dist_train.sh CONFIG NGPUS``), ``slurm`` or
``mpi`` one process runs on each card (``cuda:{LOCAL_RANK}``, NCCL; gloo
with ``--device cpu``). ``samples_per_gpu`` is the batch of each rank, as
in the reference, so the global batch is it times the number of ranks;
the step on it is the single-process step on the global batch
(``parallel/mesh.py``). Parameters are broadcast from rank 0;
``--diff-seed`` adds the data index to the seed of the data order and the
step's draws. Rank 0 alone writes logs and checkpoints.

Sharded training (JAX tools/train.py:39-47, 126-131): ``--model-parallel
MP`` lays the ranks out as a (data, model) grid (rank r: data index
r // MP, model index r % MP) and splits the ViT's (or MiT's) attention and
FFN weights over each model group, Megatron's column/row splits
(``parallel/tp.py``); ``--zero3`` also splits the rule-matched kernels,
their EMA twins and SGD buffers over the data group. As in JAX the global
batch is ``samples_per_gpu`` times the number of ranks, so a data group
reads a block of ``samples_per_gpu × MP``. The world must divide by MP
and each ViT's heads by MP (ValueError otherwise); ``--zero3`` on one rank
changes nothing. Checkpoints are whole, as an unsharded run's, and a
resume cuts them to the run's own split.

    python -m torch.distributed.run --nproc_per_node 4 \
        -m s4former_tpu_torch.tools.train CONFIG --launcher env \
        --model-parallel 2 [--zero3]
"""
import argparse
import logging
import os
import os.path as osp
import time

from s4former_tpu_torch.config import DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Train a segmentor (PyTorch port)')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--load-from', help='initial weights (.pth)')
    parser.add_argument('--resume-from', help='checkpoint dir to resume from')
    parser.add_argument('--auto-resume', action='store_true')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--diff-seed', action='store_true',
                        help='add the rank to the seed (reference '
                             '--diff_seed)')
    parser.add_argument('--deterministic', action='store_true',
                        help='cuDNN deterministic, no autotune (reference '
                             '--deterministic)')
    parser.add_argument('--max-iters', type=int, default=None,
                        help='override runner.max_iters')
    parser.add_argument('--no-validate', action='store_true')
    parser.add_argument('--model-parallel', type=int, default=1,
                        help='tensor-parallel size: the model axis of the '
                             '(data, model) rank grid (Megatron splits, '
                             'parallel/tp.py); 1 = data parallelism only')
    parser.add_argument('--zero3', action='store_true',
                        help='ZeRO-3: also split the matched weights, '
                             'their EMA twins and SGD buffers over the '
                             'data axis')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'tpu', 'slurm', 'mpi', 'env'],
                        help="process-group bootstrap, one process a "
                             "card ('tpu' is refused: no TPU here)")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; cuda:{LOCAL_RANK} under a "
                             "launcher), 'cuda:N' (every rank on card N) "
                             "or 'cpu'")
    parser.add_argument('--backend', default=None, choices=['nccl', 'gloo'],
                        help='process-group backend (default: NCCL on CUDA '
                             'devices, gloo on the CPU); gloo lets several '
                             'ranks share one card')
    parser.add_argument('--profile', nargs=2, type=int, default=None,
                        metavar=('FIRST', 'N'),
                        help='trace steps FIRST..FIRST+N-1 (from 1) into '
                             'WORK_DIR/profile/trace.json')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    return parser.parse_args(argv)


def check_grid(args):
    """The refusals of a model axis, before any process joins a group:
    the world (from the launcher's environment) must divide by it (JAX's
    ``make_mesh`` assert), and so must a ViT config's heads (the port
    splits the packed qkv at head boundaries)."""
    mp = args.model_parallel
    if mp == 1:
        return
    from s4former_tpu_torch.parallel.distributed import launcher_env
    spec = launcher_env(args.launcher)
    world = spec['world_size'] if spec else 1
    if mp < 1 or world % mp:
        raise ValueError(f'--model-parallel {mp}: {world} rank(s) do not '
                         f'divide into model axes of {mp}')
    from s4former_tpu_torch.config import Config
    backbone = Config.fromfile(args.config).model.get('backbone', {})
    heads = backbone.get('num_heads', 12) \
        if backbone.get('type') == 'VisionTransformer' else None
    if heads is not None and heads % mp:
        raise ValueError(f'--model-parallel {mp}: the ViT has {heads} '
                         f'heads, which do not divide over {mp} ranks')


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    args = parse_args(argv)
    check_grid(args)
    # a CUDA device without a card is an error (no CPU fallback)
    from s4former_tpu_torch.parallel.distributed import (
        init_distributed, is_distributed)
    from s4former_tpu_torch.parallel.mesh import make_mesh, reset_mesh
    device = init_distributed(args.launcher, backend=args.backend,
                              device=args.device)
    import torch.distributed as dist
    try:
        make_mesh(args.model_parallel)
        return _train(args, device)
    finally:
        reset_mesh()
        if is_distributed():
            dist.destroy_process_group()


def _train(args, device):
    import torch
    import s4former_tpu_torch.data  # noqa: F401  (registers datasets)
    from s4former_tpu_torch.apis import init_segmentor
    from s4former_tpu_torch.config import Config
    from s4former_tpu_torch.core.runner import IterBasedRunner, make_eval_fn
    from s4former_tpu_torch.data import SemiLoader, build_dataset
    from s4former_tpu_torch.parallel.distributed import (
        data_rank, data_size, is_main, model_size, world_size)
    from s4former_tpu_torch.parallel.mesh import replicate_state
    from s4former_tpu_torch.parallel.tp import shard_state
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
    n_ranks = world_size()
    if args.diff_seed:
        # a model group's ranks draw alike
        args.seed = args.seed + data_rank()

    work_dir = args.work_dir or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if is_main():
        cfg.dump(osp.join(work_dir, osp.basename(args.config)))
        logger = get_root_logger(osp.join(
            work_dir, time.strftime('%Y%m%d_%H%M%S') + '.log'))
    else:
        logger = get_root_logger()
        logger.setLevel(logging.ERROR)
    logger.info('environment:\n' + format_env())
    logger.info(f'device: {device}' + (
        f' ({torch.cuda.get_device_name(device)})'
        if device.type == 'cuda' else '') +
        (f'; {n_ranks} ranks ({args.launcher})' if n_ranks > 1 else '') +
        (f', {data_size()} data x {model_size()} model'
         if model_size() > 1 else ''))

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
    state = replicate_state(create_train_state(model, ema=semi_cfg.ema))
    if args.model_parallel > 1 or args.zero3:
        state = shard_state(state, zero3=args.zero3)
        logger.info(f'sharded state: model axis = {args.model_parallel} '
                    f'(Megatron), zero3 = {args.zero3}' +
                    ('' if state.plan is None else
                     f'; {len(state.plan.split_names())} split tensors'))

    # data
    train_cfg = cfg.data['train']
    sup_ds = build_dataset(train_cfg['sup']) if 'sup' in train_cfg else \
        build_dataset(train_cfg)
    unsup_ds = unsup_mix_ds = None
    if semi_cfg.ema and train_cfg.get('unsup'):
        unsup_ds = build_dataset(train_cfg['unsup'])
        # UniSemiDataset's third source: the UniMatch mix stream
        mix_cfg = train_cfg.get('unsup_mix') or train_cfg.get('unsup2')
        if mix_cfg:
            unsup_mix_ds = build_dataset(mix_cfg)
    sup_pb = cfg.get('samples_per_gpu_sup',
                     cfg.data.get('samples_per_gpu', 8) // 2
                     if unsup_ds is not None
                     else cfg.data.get('samples_per_gpu', 8))
    unsup_pb = cfg.get('samples_per_gpu_unsup', sup_pb) \
        if unsup_ds is not None else 0
    # samples_per_gpu is a rank's batch; the sampler draws the global one
    # and each data index builds its block (samples_per_gpu x model axis)
    loader = SemiLoader(sup_ds, unsup_ds, unsup_mix_ds,
                        sup_per_batch=sup_pb * n_ranks,
                        unsup_per_batch=unsup_pb * n_ranks,
                        num_workers=cfg.data.get('workers_per_gpu', 4) * 2,
                        seed=args.seed, shard=(data_rank(), data_size()))
    logger.info(f'sup dataset: {len(sup_ds)} imgs' +
                (f', unsup: {len(unsup_ds)} imgs' if unsup_ds else '') +
                (f', unsup_mix: {len(unsup_mix_ds)} imgs' if unsup_mix_ds
                 else '') +
                f'; {sup_pb} + {unsup_pb} a step' +
                (f' a rank, {sup_pb * n_ranks} + {unsup_pb * n_ranks} '
                 f'global' if n_ranks > 1 else ''))

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
