"""The port stands alone: sgrt_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package sgrt_tpu, and build no kernel when
imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sgrt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "sgrt_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
    assert len(PORT_FILES) > 10


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sgrt_tpu_torch\n"
        "for m in pkgutil.walk_packages(sgrt_tpu_torch.__path__, 'sgrt_tpu_torch.'):\n"
        "    if m.name != 'sgrt_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax') or m == 'sgrt_tpu'"
        " or m.startswith(('jax.', 'sgrt_tpu.'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('isolated', len([m for m in sys.modules if m.startswith('sgrt_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


def test_kernels_registry_and_precision_flags():
    from sgrt_tpu_torch.ops import kernels

    assert torch.backends.cuda.matmul.allow_tf32 is False
    for k in kernels.KERNELS:
        assert k.route in ("cuda", "triton")
        assert k.source.exists()
        path, line = k.replaces.split(":")
        src = (ROOT / path).read_text().splitlines()
        # a Pallas kernel is a private function; the tiling kernel replaces
        # the XLA chain of a public one
        want = "def _" if "pallas" in path else "def tile_indices("
        assert src[int(line) - 1].startswith(want), k.replaces
    launches = [k.launches for k in kernels.KERNELS]
    kernels.reset_launch_counts()
    assert all(k.launches == 0 for k in kernels.KERNELS)
    for k, n in zip(kernels.KERNELS, launches):
        k.launches = n
