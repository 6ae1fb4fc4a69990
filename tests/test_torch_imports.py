"""The port imports neither ``jax`` nor any module of the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (pytest's own has jax loaded already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "print(' '.join(names))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, names = proc.stdout.splitlines()[0], proc.stdout.splitlines()[1]
    assert int(count.split()[0]) >= 19
    for name in ("repro_torch.kernels.compact", "repro_torch.core.distributed",
                 "repro_torch.core.engine", "repro_torch.kernels.ops",
                 "repro_torch.core.vstate", "repro_torch.launch.cluster"):
        assert name in names.split()


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_reference_import(path):
    bad = [line for line in path.read_text().splitlines()
           if FORBIDDEN.match(line)]
    assert not bad, bad
