"""The port imports neither JAX nor the JAX package.

Checked in a fresh interpreter: this test process has JAX loaded already
(``tests/conftest.py``).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import r3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(r3d_tpu_torch.__path__, "r3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "r3d_tpu"))
print(len(names), leaked)
"""


def test_port_imports_no_jax_and_nothing_of_r3d_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 14
    assert leaked == "[]"
