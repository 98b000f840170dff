"""Build a CUDA source of the package into a shared library and load it.

Each kernel is a ``.cu`` file under ``ops/csrc`` with a plain C interface.
``nvcc`` compiles it for Hopper (``sm_90a``) into ``s4former_tpu_torch/build``
on first use, named by a hash of the source, and ``ctypes`` loads it. Nothing
is built when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (os.path.join(cuda_home, 'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f'{src.stem}-{digest}.so'


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same source hash
    exists; return the library's path. The compiler's output (registers,
    shared memory, spills) is kept beside it as ``.log``."""
    return build_all([source])[0]


def build_all(sources) -> list:
    """``build`` for several sources, one ``nvcc`` each, all started
    together; returns the libraries' paths in the order of ``sources``."""
    outs = [library_path(s) for s in sources]
    jobs = []
    for source, out in zip(sources, outs):
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp.so')
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC_DIR / source)]
        jobs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for source, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix('.log').write_text(stdout + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'nvcc failed on {source}:\n{stderr}')
        else:
            os.replace(tmp, out)   # atomic: a concurrent build sees all
    if failed:
        raise RuntimeError('\n'.join(failed))
    return outs


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
