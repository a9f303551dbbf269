"""convdr_torch stands alone: importing every module of the package, the
drivers included, loads neither JAX nor anything of convdr_tpu. Run in a
fresh interpreter, since the test process itself imports both."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import convdr_torch
names = [m.name for m in pkgutil.walk_packages(convdr_torch.__path__, "convdr_torch.")]
for name in names:
    importlib.import_module(name)
assert "convdr_torch.drivers.run_convdr_inference" in names, names
assert "convdr_torch.drivers.gen_passage_embeddings" in names, names
assert "convdr_torch.drivers.run_convdr_train" in names, names
assert "convdr_torch.train.loop" in names, names
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "convdr_tpu")
)
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _run(code, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_package_imports_no_jax(tmp_path):
    proc = _run(PROBE, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({os.path.join(REPO, 'chip_smoke.py')!r}, run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'convdr_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
