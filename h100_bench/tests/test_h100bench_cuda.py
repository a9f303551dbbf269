"""On the card only (``-m cuda``; each test skips without one): whole runs
of each cell at the tiny size through the port's CUDA kernels, and each
cell's control (the plain reference in TF32 put in the program's place)
failing the cell's limits. The controls at the cells' own sizes are read
by ``calibrate.py``.

    python -m pytest -m cuda h100_bench/tests/test_h100bench_cuda.py
"""

import time

import pytest
import torch

from h100_bench import checks, harness
from h100_bench.tests.tinybench import tiny_bench, tiny_manifest

CELLS = ["ance-cast.serve-turns", "ance-cast.train-kd-rank", "dpr-orquac.batch-eval",
         "ance-cast.embed-passages"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_on_the_card_is_correct(tmp_path, card, cell):
    res = harness.run_cell(tiny_manifest(), cell, 2 ** 31 + 99, 0.5, True, card,
                           time.perf_counter(), bench=tiny_bench(tmp_path))
    assert res.pop("_forbidden") == []
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_the_control_fails_the_cells_limits(tmp_path, card, cell, seed):
    manifest = tiny_manifest()
    bench = tiny_bench(tmp_path)
    _wl, cfg, mix = harness.load_cell(manifest, cell, bench=bench)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Ctx(cfg, mix, seed, 0.5, card)
    numbers = harness.load_driver(mix["driver"], bench).control(ctx)
    verdicts = checks.verdict(numbers, checks.load_limits(cell))
    assert not all(v["ok"] for v in verdicts.values()), verdicts
