"""The run's environment, for the CLIs' logs (counterpart of
``s4former_tpu/utils/collect_env.py``; reference: mmseg/utils/
collect_env.py:1-18, logged at startup by tools/train.py:179-182).

Where the JAX package reports jax, XLA and the TPU, this reports torch,
its CUDA and cuDNN, the ``nvcc`` that builds the kernels, the cards, the
C++ compiler of the native host library, and the port's version.

    python -m s4former_tpu_torch.utils.collect_env
"""
from __future__ import annotations

import os
import subprocess
import sys
from collections import OrderedDict


def _version(cmd, keyword: str = '') -> str:
    """The first line of ``cmd``'s output that holds ``keyword``."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return 'not found'
    lines = [ln.strip() for ln in out.stdout.splitlines() if keyword in ln]
    return lines[0] if out.returncode == 0 and lines else 'not found'


def _git_hash() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(['git', 'rev-parse', '--short=7', 'HEAD'],
                             cwd=root, capture_output=True, text=True,
                             timeout=5)
    except (OSError, subprocess.SubprocessError):
        return 'unknown'
    return out.stdout.strip() or 'unknown'


def collect_env() -> 'OrderedDict[str, str]':
    import numpy
    import PIL
    import torch

    import s4former_tpu_torch
    from s4former_tpu_torch.native import build as native_build
    from s4former_tpu_torch.ops.cuda_build import find_nvcc

    info: 'OrderedDict[str, str]' = OrderedDict()
    info['sys.platform'] = sys.platform
    info['Python'] = sys.version.replace('\n', '')
    info['torch'] = torch.__version__
    info['CUDA (torch)'] = str(torch.version.cuda)
    info['cuDNN'] = str(torch.backends.cudnn.version()
                        if torch.backends.cudnn.is_available() else None)
    try:
        info['nvcc'] = _version([find_nvcc(), '--version'], 'release')
    except RuntimeError:
        info['nvcc'] = 'not found'
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        info['GPUs'] = f'{len(names)}x {names[0]}'
    else:
        info['GPUs'] = 'none'
    try:
        info['C++ (native host library)'] = _version(
            [native_build.find_cxx(), '--version'])
    except RuntimeError:
        info['C++ (native host library)'] = 'not found'
    info['numpy'] = numpy.__version__
    info['PIL'] = PIL.__version__
    info['s4former_tpu_torch'] = \
        f'{s4former_tpu_torch.__version__}+{_git_hash()}'
    return info


def format_env() -> str:
    return '\n'.join(f'{k}: {v}' for k, v in collect_env().items())


if __name__ == '__main__':
    print(format_env())
