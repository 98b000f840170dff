"""Build ``native/src/s4_native.cpp`` into a shared library.

``g++ -O3 -shared -fPIC`` compiles it at first use into
``s4former_tpu_torch/build/`` (git ignores it), under a name hashed from
the source and the flags, so a changed source or flag set builds anew and
an unchanged one is reused. The compiler writes a temporary file of its
own, which ``os.replace`` then renames: processes or threads that build at
the same time each finish a whole library, and none can load a part of
one. A failed build raises with the compiler's messages.

The decoders need ``jpeglib.h`` and ``png.h``. Where the compiler finds
both, the library is linked against libjpeg and libpng and
``s4_has_decode()`` returns 1; elsewhere the source compiles without its
decoders (``__has_include``) and the library needs no image library.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

SOURCE = Path(__file__).resolve().parent / 'src' / 's4_native.cpp'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build'
# -ffp-contract=off: no fused multiply-add where numpy rounds the product
# (the plain versions' arithmetic, bit for bit)
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-ffp-contract=off',
             '-Wall')
DECODE_LIBS = ('-ljpeg', '-lpng')


def find_cxx() -> str:
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        raise RuntimeError('no C++ compiler (g++) on PATH: the native host '
                           'library s4_native is built at first use')
    return cxx


def decode_headers_found(cxx: str) -> bool:
    """Whether the compiler finds ``jpeglib.h`` and ``png.h``."""
    probe = '#include <jpeglib.h>\n#include <png.h>\n'
    proc = subprocess.run([cxx, '-E', '-x', 'c++', '-', '-o', os.devnull],
                          input=probe, capture_output=True, text=True)
    return proc.returncode == 0


def build_flags(cxx: str) -> List[str]:
    return list(CXX_FLAGS) + (list(DECODE_LIBS)
                              if decode_headers_found(cxx) else [])


def library_path(flags, source: Path = SOURCE,
                 build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update('\0'.join(flags).encode())
    return Path(build_dir) / f'{source.stem}-{h.hexdigest()[:12]}.so'


def build(build_dir: Optional[Path] = None, source: Path = SOURCE) -> Path:
    """The library's path, compiling it first unless a library of the same
    source and flags is there already."""
    build_dir = Path(build_dir or BUILD_DIR)
    cxx = find_cxx()
    flags = build_flags(cxx)
    # the libraries go after the source, where the linker looks for them
    compile_flags = [f for f in flags if f not in DECODE_LIBS]
    libs = [f for f in flags if f in DECODE_LIBS]
    out = library_path(flags, source, build_dir)
    if out.is_file():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.'
                        f'{threading.get_ident()}.tmp.so')
    proc = subprocess.run([cxx, *compile_flags, '-o', str(tmp), str(source),
                           *libs], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'building {source.name} failed '
                           f'({" ".join(proc.args)}):\n{proc.stderr}')
    os.replace(tmp, out)
    return out
