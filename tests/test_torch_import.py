"""The PyTorch port loads without JAX, and chip_smoke.py refuses to run
without a CUDA device."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "raytrace_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import raytrace_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    # A subprocess: this test process already imported jax (conftest).
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pattern.search(
        (REPO / "chip_smoke.py").read_text()) else []
    assert offenders == []


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout
