"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

`repro_torch` and `chip_smoke.py` must import and run on a machine that
has no JAX at all, so every module of the port is imported here with
`jax` blocked, and the sources are scanned for imports of either.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, f"repro_torch loaded JAX-package modules: {bad}"
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_port_module_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15  # every module was walked


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path.name} imports {mod}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Here there is no CUDA device: the script exits non-zero and prints
    no result line; alone in a directory it fails the same way."""
    for script in (ROOT / "chip_smoke.py",
                   tmp_path / "chip_smoke.py"):
        if not script.exists():
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                           capture_output=True, text=True, timeout=120,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
        if r.returncode == 0:
            pytest.skip("a CUDA device is present")
        assert '"ok"' not in r.stdout
