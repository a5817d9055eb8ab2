"""The port stands alone: it imports neither JAX nor the JAX package (nor
the oracle), and it never falls back to the CPU on its own."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import starks_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "starks_tpu_torch"


def _is_jax_package(name: str) -> bool:
    return name == "starks_tpu" or name.startswith("starks_tpu.")


def test_import_leaves_jax_and_jax_package_out():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        starks_tpu_torch.__path__, "starks_tpu_torch."))
    code = ("import json, sys, importlib\n"
            f"for m in {['starks_tpu_torch'] + modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"starks_tpu_torch.prover", "starks_tpu_torch.parallel.mesh",
            "starks_tpu_torch.parallel.ntt4step",
            "starks_tpu_torch.parallel.launch",
            "starks_tpu_torch.algebra.polynomial",
            "starks_tpu_torch.algebra.finite_field"} <= set(loaded)
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded if _is_jax_package(m)]
    assert "oracle" not in loaded


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    names = list(_imports(path))
    assert not [n for n in names if n == "jax" or n.startswith("jax.")]
    assert not [n for n in names if _is_jax_package(n)]
    if path.parent != ROOT:                  # chip_smoke may use the oracle
        assert not [n for n in names if n.split(".")[0] == "oracle"]


def test_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        starks_tpu_torch.mk_mimc_proof(3, 64, [1, 2, 3, 4])
