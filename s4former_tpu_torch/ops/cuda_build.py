"""Build a CUDA source of the package into a shared library and load it.

Each kernel is a ``.cu`` file under ``ops/csrc`` with a plain C interface.
``nvcc`` compiles it for Hopper (``sm_90a``) into ``s4former_tpu_torch/build``
on first use, named by a hash of the source and of every ``csrc`` header it
includes, and ``ctypes`` loads it. Nothing is built when a module is
imported: the CPU tests import every module on a machine without ``nvcc``.

``ptxas_info`` and ``sass_counts`` read what was built: each kernel
function's registers and spills from the compiler's log, and its count of
tensor-core instructions and asynchronous copies from the SASS that
``cuobjdump --dump-sass`` (``dump_sass``) prints.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(source: str) -> list:
    """``csrc/<source>`` and every ``csrc`` file it includes with
    ``#include "..."``, directly or through another such file."""
    files, todo = [], [CSRC_DIR / source]
    while todo:
        f = todo.pop()
        if f in files:
            continue
        files.append(f)
        todo += [CSRC_DIR / name for name in _INCLUDE.findall(f.read_text())
                 if (CSRC_DIR / name).is_file()]
    return files


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(source_files(source)):
        h.update(f.name.encode() + b'\0' + f.read_bytes())
    return BUILD_DIR / f'{Path(source).stem}-{h.hexdigest()[:12]}.so'


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


def ptxas_info(log: str) -> dict:
    """{kernel function: {'registers', 'spill_stores', 'spill_loads'}} from
    the ``-Xptxas -v`` output kept beside a library (bytes of spills)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            cur['spill_stores'], cur['spill_loads'] = map(int, m.groups())
        m = re.search(r'Used (\d+) registers', line)
        if m:
            cur['registers'] = int(m.group(1))
    return out


# an instruction line of cuobjdump's SASS: /*0140*/ [@[!]P0] OPCODE.MODS ...
_SASS_OP = re.compile(r'^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?'
                      r'([A-Z][A-Z0-9_]*)')
TENSOR_CORE_OPS = ('HMMA', 'HGMMA')
ASYNC_COPY_OPS = ('LDGSTS', 'UTMALDG')


def sass_counts(sass: str) -> dict:
    """{kernel function: {'tensor_core': n, 'async_copy': n}} from a
    ``cuobjdump --dump-sass`` listing: the count of HMMA/HGMMA (tensor-core
    products) and LDGSTS/UTMALDG (asynchronous global-to-shared copies:
    cp.async, TMA) instructions in each function."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r'\s*Function\s*:\s*(\S+)', line)
        if m:
            cur = out.setdefault(m.group(1),
                                 {'tensor_core': 0, 'async_copy': 0})
            continue
        m = _SASS_OP.match(line)
        if cur is not None and m:
            op = m.group(1)
            cur['tensor_core'] += op in TENSOR_CORE_OPS
            cur['async_copy'] += op in ASYNC_COPY_OPS
    return out


def dump_sass(library: Path) -> str:
    """``cuobjdump --dump-sass`` of a built library (the toolkit's, beside
    nvcc)."""
    tool = Path(find_nvcc()).with_name('cuobjdump')
    return subprocess.run([str(tool), '--dump-sass', str(library)],
                          capture_output=True, text=True, check=True).stdout
