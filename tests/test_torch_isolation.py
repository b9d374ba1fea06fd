"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "cleora_tpu")


def _port_sources():
    pkg = os.path.join(REPO, "cleora_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    assert not set(_imported_roots(path)) & set(_FORBIDDEN)


def test_embed_in_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import cleora_tpu_torch as ctt\n"
        "g = ctt.SparseMatrix.from_iterator(\n"
        "    iter(['a b', 'b c', 'c d', 'd a']), 'complex::reflexive::node')\n"
        "out = ctt.embed(g, feature_dim=8, num_iterations=3, device='cpu')\n"
        "assert out.shape == (4, 8) and np.isfinite(out).all()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'cleora_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_spectral_siblings_in_fresh_process_load_no_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import cleora_tpu_torch as ctt\n"
        "from cleora_tpu_torch import algorithms as alg\n"
        "g = ctt.SparseMatrix.from_iterator(\n"
        "    iter(['a b', 'b c', 'c d', 'd a', 'a c']),\n"
        "    'complex::reflexive::node')\n"
        "for fn in (alg.embed_prone, alg.embed_randne, alg.embed_hope,\n"
        "           alg.embed_netmf, alg.embed_grarep):\n"
        "    for kw in ({}, {'backend': 'device', 'device': 'cpu'}):\n"
        "        out = fn(g, feature_dim=4, **kw)\n"
        "        assert out.shape == (4, 4) and np.isfinite(out).all()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'cleora_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
