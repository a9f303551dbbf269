"""convdr_torch stands alone: importing every module of the package, the
drivers included, loads neither JAX nor anything of convdr_tpu (run in a
fresh interpreter, since the test process itself imports both), and no
source of the port names a path under the JAX package's ``native/`` or
``scripts/`` directories: it builds and runs its own copies."""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest

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
for name in ("convdr_torch.drivers.tokenize_collection", "convdr_torch.native_io",
             "convdr_torch.etl.ranking_data", "convdr_torch.scripts.rehearsal",
             "convdr_torch.drivers.build_ivf_index", "convdr_torch.retrieval.ivf",
             "convdr_torch.retrieval.pq_index", "convdr_torch.retrieval.refine",
             "convdr_torch.ops.kmeans", "convdr_torch.ops.pq", "convdr_torch.utils.transfer",
             "convdr_torch.parallel.mesh", "convdr_torch.parallel.sharded_search",
             "convdr_torch.parallel.dryrun", "convdr_torch.etl.cbor_car",
             "convdr_torch.etl.cast19", "convdr_torch.etl.cast20", "convdr_torch.etl.cast21",
             "convdr_torch.etl.orquac", "convdr_torch.etl.id_remap",
             "convdr_torch.data.process_fns", "convdr_torch.evaluation.qa_eval",
             "convdr_torch.utils.misc", "convdr_torch.scripts.attention_bwd_bench",
             "convdr_torch.utils.ocdbt", "convdr_torch.utils.zarr2"):
    assert name in names, names
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "convdr_tpu", "orbax",
                           "tensorstore", "zstandard")
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


# the host-surface modules of the last slice (the ETL, process fns, QA
# matching, misc), each alone in a fresh interpreter
ALONE = ["convdr_torch.etl.cbor_car", "convdr_torch.etl.common", "convdr_torch.etl.cast19",
         "convdr_torch.etl.cast20", "convdr_torch.etl.cast21", "convdr_torch.etl.orquac",
         "convdr_torch.etl.id_remap", "convdr_torch.data.process_fns",
         "convdr_torch.evaluation.qa_eval", "convdr_torch.utils.misc",
         # the orbax checkpoint layers
         "convdr_torch.utils.ocdbt", "convdr_torch.utils.zarr2",
         "convdr_torch.train.checkpoint"]


@pytest.mark.parametrize("module", ALONE)
def test_host_module_imports_alone_without_jax(tmp_path, module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'convdr_tpu', 'orbax', 'tensorstore', "
        "'zstandard'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({os.path.join(REPO, 'chip_smoke.py')!r}, run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'convdr_tpu', 'orbax', 'tensorstore', "
        "'zstandard'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def port_sources():
    return sorted(glob.glob(os.path.join(REPO, "convdr_torch", "**", "*.py"), recursive=True)
                  + [os.path.join(REPO, "chip_smoke.py")])


def test_port_sources_name_no_path_under_native_or_scripts():
    """String constants (docstrings aside) that name a path under native/
    or scripts/, or join one of them into a path."""
    under = re.compile(r"(^|[\\/\s'\"])(native|scripts)/")
    bad = []
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        docstrings = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
        }
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings and under.search(node.value)
                    and "convdr_torch/scripts/" not in node.value):
                bad.append(f"{path}:{node.lineno}: {node.value!r}")
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                    and any(isinstance(a, ast.Constant) and a.value in ("native", "scripts")
                            for a in node.args)):
                bad.append(f"{path}:{node.lineno}: joins a path under native/ or scripts/")
    assert not bad, bad
