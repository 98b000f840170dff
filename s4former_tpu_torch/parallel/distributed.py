"""Process-group bootstrap (counterpart of
``s4former_tpu/parallel/distributed.py``; reference: tools/train.py:87-91,
tools/dist_train.sh, tools/slurm_train.sh).

One process per card, as the reference's ``torch.distributed.launch`` runs
it: rank ``r`` of ``N`` drives ``cuda:{LOCAL_RANK}`` and feeds the
contiguous block ``r`` of the global batch (``local_batch_slice``).

Launchers (the JAX package's names and env mapping):

- 'none'  : one process, no group.
- 'env'   : torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
            ``WORLD_SIZE`` and ``LOCAL_RANK`` (the reference's 'pytorch'
            launcher, ``tools/dist_train.sh``).
- 'slurm' : the first host of ``SLURM_STEP_NODELIST`` (else
            ``SLURM_NODELIST``) at ``port``, ``SLURM_NTASKS``,
            ``SLURM_PROCID``, ``SLURM_LOCALID``.
- 'mpi'   : ``MASTER_ADDR`` (else 127.0.0.1) at ``port``,
            ``OMPI_COMM_WORLD_SIZE``, ``OMPI_COMM_WORLD_RANK``,
            ``OMPI_COMM_WORLD_LOCAL_RANK``.
- 'tpu'   : refused; there is no TPU here.

The backend is NCCL for CUDA devices and gloo for the CPU unless the
caller names one. NCCL takes one card per rank: more ranks on a host than
it has cards is an error, never a silent fallback to gloo.

The ranks form a grid of up to four axes, (data, pipe, ctx, model), the
last fastest: rank ``r`` is ``((d * pp + p) * cp + c) * mp + m``. The
functions in ``parallel/mesh.py`` lay out JAX's meshes on it: ``make_mesh``
(data, model), ``make_pp_mesh`` (data, pipe), ``make_pp_tp_mesh`` (data,
pipe, model) and ``make_cp_mesh`` (data, ctx); an axis a mesh lacks has
size 1. Without a grid the data axis is the world. A data group's ranks
feed the same rows (``local_batch_slice``).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

# the sizes of the pipe, ctx and model axes and this rank's group of each
# axis (None: the world), set by the mesh functions of ``parallel.mesh``
_GRID = {'pp': 1, 'cp': 1, 'mp': 1, 'data': None, 'pipe': None,
         'ctx': None, 'model': None}


def _first_host(nodelist: str) -> str:
    """First hostname of a Slurm nodelist ('n[001-004]' -> 'n001')."""
    if '[' not in nodelist:
        return nodelist.split(',')[0]
    prefix, rest = nodelist.split('[', 1)
    first = rest.split(',')[0].split('-')[0].rstrip(']')
    return prefix + first


def launcher_env(launcher: str, port: int = 29500,
                 environ: Optional[Mapping[str, str]] = None
                 ) -> Optional[Dict]:
    """The group a launcher's environment describes: ``init_method``
    (tcp://host:port), ``world_size``, ``rank`` and ``local_rank``; None
    for 'none'."""
    env = os.environ if environ is None else environ
    if launcher in (None, 'none'):
        return None
    if launcher == 'tpu':
        raise ValueError("--launcher tpu: there is no TPU here; use env, "
                         "slurm or mpi")
    if launcher == 'env':
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = env['WORLD_SIZE'], env['RANK']
        local = env.get('LOCAL_RANK', '0')
    elif launcher == 'slurm':
        nodelist = env.get('SLURM_STEP_NODELIST',
                           env.get('SLURM_NODELIST', ''))
        addr = f'{_first_host(nodelist)}:{port}'
        world, rank = env['SLURM_NTASKS'], env['SLURM_PROCID']
        local = env.get('SLURM_LOCALID', '0')
    elif launcher == 'mpi':
        addr = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{port}"
        world = env['OMPI_COMM_WORLD_SIZE']
        rank = env['OMPI_COMM_WORLD_RANK']
        local = env.get('OMPI_COMM_WORLD_LOCAL_RANK', '0')
    else:
        raise ValueError(f'unknown launcher {launcher!r}; expected '
                         "none|tpu|slurm|mpi|env")
    return {'init_method': f'tcp://{addr}', 'world_size': int(world),
            'rank': int(rank), 'local_rank': int(local)}


def resolve_device(name: str) -> torch.device:
    """The torch device for ``--device``; a CUDA device without a card is
    an error (no CPU fallback)."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name}, but torch finds no CUDA '
                           f'device; pass --device cpu to run on the CPU')
    return device


def init_distributed(launcher: str = 'none', backend: Optional[str] = None,
                     device: str = 'cuda', port: int = 29500
                     ) -> torch.device:
    """Join the launcher's process group and return this process's device.

    ``device`` 'cuda' is ``cuda:{local_rank}``; a device with an index
    ('cuda:0') is taken as it is, so a caller may put several ranks on one
    card with ``backend='gloo'``; 'cpu' runs on the CPU. ``backend``
    defaults to NCCL on CUDA and gloo on the CPU."""
    spec = launcher_env(launcher, port)
    dev = resolve_device(device)
    if spec is None:
        return dev
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend == 'nccl' and dev.type != 'cuda':
        raise ValueError('NCCL runs on CUDA devices only; the CPU takes '
                         'gloo')
    if dev.type == 'cuda' and dev.index is None:
        n = torch.cuda.device_count()
        if spec['local_rank'] >= n:
            raise RuntimeError(
                f'local rank {spec["local_rank"]} but {n} CUDA device(s) on '
                f'this host: {backend} runs one rank per card; start at '
                f'most {n} processes a host')
        dev = torch.device('cuda', spec['local_rank'])
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=spec['init_method'],
                            world_size=spec['world_size'],
                            rank=spec['rank'])
    return dev


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    """True on rank 0 (and without a group): the process that writes logs
    and checkpoints."""
    return rank() == 0


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def model_size() -> int:
    """The model axis's size: the ranks that split one model (1 without a
    grid)."""
    return _GRID['mp']


def model_rank() -> int:
    return rank() % model_size()


def pipe_size() -> int:
    """The pipe axis's size: the stages of a pipeline (1 without one)."""
    return _GRID['pp']


def pipe_rank() -> int:
    return rank() // (_GRID['cp'] * _GRID['mp']) % _GRID['pp']


def ctx_size() -> int:
    """The ctx axis's size: the ranks that split one sequence (1 without
    a ring)."""
    return _GRID['cp']


def ctx_rank() -> int:
    return rank() // _GRID['mp'] % _GRID['cp']


def data_size() -> int:
    """The data axis's size: the ranks that feed distinct rows."""
    return world_size() // (_GRID['pp'] * _GRID['cp'] * _GRID['mp'])


def data_rank() -> int:
    return rank() // (_GRID['pp'] * _GRID['cp'] * _GRID['mp'])


def data_group():
    """The process group of this rank's data axis (None: the world)."""
    return _GRID['data']


def model_group():
    return _GRID['model']


def pipe_group():
    return _GRID['pipe']


def ctx_group():
    return _GRID['ctx']


def local_batch_slice(global_batch: int) -> slice:
    """This data index's contiguous block of a global batch of
    ``global_batch``; the batch must divide by the data axis's size."""
    n = data_size()
    if global_batch % n:
        raise ValueError(f'a global batch of {global_batch} does not '
                         f'divide over {n} ranks')
    per = global_batch // n
    return slice(data_rank() * per, (data_rank() + 1) * per)
