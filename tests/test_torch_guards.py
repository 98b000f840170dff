"""Guards of the port: it imports nothing of JAX or the JAX package, and
chip_smoke.py fails (without its result line) where there is no card or no
port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'orbax', 's4former_tpu')


def _port_files():
    return sorted((REPO / 's4former_tpu_torch').rglob('*.py')) + \
        [REPO / 'chip_smoke.py']


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(REPO)), m) for p in files
           for m in _imported_modules(p)
           if m.split('.')[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Here torch has no CUDA: the script must exit nonzero and print no
    result, in the repo and copied into a directory of its own."""
    script = REPO / 'chip_smoke.py'
    if where == 'alone':
        script = Path(shutil.copy(script, tmp_path / 'chip_smoke.py'))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
