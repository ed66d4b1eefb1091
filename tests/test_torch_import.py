"""The PyTorch port loads without JAX and without the JAX package
(raytrace_tpu) or its top-level ``native``, and chip_smoke.py refuses to
run without a CUDA device."""

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
ref = sorted(m for m in sys.modules
             if m == "raytrace_tpu" or m.startswith("raytrace_tpu."))
assert not ref, ref
print(len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    # A subprocess: this test process already imported jax (conftest).
    # It also finds no module of the JAX package loaded.
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 35


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pattern.search(
        (REPO / "chip_smoke.py").read_text()) else []
    assert offenders == []


def test_port_sources_never_import_the_jax_package():
    pattern = re.compile(r"^\s*(import raytrace_tpu|from raytrace_tpu)(\.|\s|$)",
                         re.MULTILINE)
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
    # The pattern tells the JAX package from the port.
    assert pattern.search("from raytrace_tpu.models import compile_scene")
    assert pattern.search("import raytrace_tpu\n")
    assert not pattern.search("from raytrace_tpu_torch import cli")


def test_port_sources_never_import_the_native_package():
    """The port builds its own copy of the SAH builder
    (raytrace_tpu_torch/csrc/bvh_builder.cc, models/bvh_native.py) and
    never loads the JAX package's top-level ``native``."""
    pattern = re.compile(r"^\s*(import native|from native)(\.|\s|$)",
                         re.MULTILINE)
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("        from native import build_sah_bvh")
    assert pattern.search("import native\n")
    assert not pattern.search("from .bvh_native import build_sah_bvh")
    proc = _run(["-c", _IMPORT_ALL.replace(
        'print(len(names))',
        'assert "native" not in sys.modules\nprint(len(names))')], REPO)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout
