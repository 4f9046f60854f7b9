"""The port stands alone: importing ``repro_torch`` and every one of its
modules pulls in neither JAX nor anything of the JAX package ``repro``."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
assert {"repro_torch.serve", "repro_torch.serve.ann", "repro_torch.core.theory",
        "repro_torch.core.da_numpy", "repro_torch.data.datasets"} <= set(names), names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_repro_torch_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20 and bad.strip() == "[]"
