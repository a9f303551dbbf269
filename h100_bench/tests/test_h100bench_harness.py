"""The harness on the CPU at the tiny size: whole runs of each cell, the
isolation from JAX and from the program, files dropped in and found by
name, and the entry's refusals."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from h100_bench import harness
from h100_bench.tests.tinybench import run_tiny, tiny_bench, tiny_manifest

CELLS = ["ance-cast.serve-turns", "ance-cast.train-kd-rank", "dpr-orquac.batch-eval",
         "ance-cast.embed-passages"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct_and_reports_its_metrics(tmp_path, cell, trace):
    res = run_tiny(tmp_path, cell, trace=trace)
    assert res.pop("_forbidden") == []
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    manifest = harness.load_manifest()
    want = {m["name"] for m in harness.cell_metrics(manifest, cell, trace)}
    if trace:
        # on the CPU nothing reads from the device: only the host's metrics
        assert set(res["metrics"]) <= want and res["metrics"]
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == want
        assert res["metrics"]["setup_s"]["value"] > 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name


def run_python(code: str, cwd: str):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_the_harness_loads_no_jax_and_the_reference_no_program():
    code = """
        import sys, glob, os
        sys.path.insert(0, %r)
        from h100_bench import harness, checks, program, traffic, weights, work, devtrace, readers
        for d in ("search", "train"):
            harness.load_driver(d)
        for path in glob.glob(os.path.join(harness.BENCH, "metrics", "*.py")):
            harness.metric_reader(os.path.basename(path)[:-3])
        top = {n.split(".")[0] for n in sys.modules}
        print(sorted(top & {"jax", "jaxlib", "flax", "convdr_tpu"}))
    """ % harness.ROOT
    out = run_python(code, harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    code = """
        import sys
        sys.path.insert(0, %r)
        import h100_bench.reference.encoder, h100_bench.reference.search
        import h100_bench.reference.train
        print(sorted({n.split(".")[0] for n in sys.modules}
                     & {"convdr_torch", "jax", "jaxlib", "flax", "convdr_tpu"}))
    """ % harness.ROOT
    out = run_python(code, harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "convdr_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxlibx.sub", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_files_dropped_in_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric and a cell's limits added as files
    and entries run with no edit of the harness."""
    bench = tiny_bench(tmp_path)
    os.remove(os.path.join(bench, "mixes"))
    shutil.copytree(os.path.join(harness.BENCH, "tests", "tiny"), os.path.join(bench, "mixes"))
    os.remove(os.path.join(bench, "metrics"))
    shutil.copytree(os.path.join(harness.BENCH, "metrics"), os.path.join(bench, "metrics"))
    os.remove(os.path.join(bench, "limits"))
    shutil.copytree(os.path.join(harness.BENCH, "limits"), os.path.join(bench, "limits"))

    manifest = tiny_manifest()
    with open(os.path.join(harness.ROOT, manifest["configs"][0]["file"])) as f:
        cfg = json.load(f)
    cfg_file = tmp_path / "new-model.json"
    cfg_file.write_text(json.dumps(dict(cfg, name="new-model", num_hidden_layers=1)))
    mix = json.loads((tmp_path / "bench" / "mixes" / "serve-turns.json").read_text())
    (tmp_path / "bench" / "mixes" / "serve-short.json").write_text(
        json.dumps(dict(mix, name="serve-short", question_tokens=[2, 4])))
    (tmp_path / "bench" / "metrics" / "turn_p90_ms.new.py").write_text(
        "from h100_bench import readers\n\n\ndef read(obs):\n"
        "    return readers.latency_ms(obs, 90)\n")
    (tmp_path / "bench" / "limits" / "new-model.serve-short.json").write_text(
        (tmp_path / "bench" / "limits" / "ance-cast.serve-turns.json").read_text())
    manifest["configs"].append({"name": "new-model", "source": "https://example.org/cfg",
                                "file": os.path.relpath(cfg_file, harness.ROOT),
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "new-model.serve-short", "config": "new-model",
                                  "traffic": "serve-short", "chips": 1, "why": "a test"})
    manifest["end_to_end"][0]["workloads"].append("new-model.serve-short")
    manifest["per_layer"].append({"name": "turn_p90_ms.new", "unit": "ms", "better": "lower",
                                  "source": "host_clock", "layer": "serving front",
                                  "moves": "turn_p95_ms", "workloads": ["new-model.serve-short"]})
    wl, got_cfg, got_mix = harness.load_cell(manifest, "new-model.serve-short", bench=bench)
    assert got_cfg["num_hidden_layers"] == 1 and got_mix["question_tokens"] == [2, 4]
    import time

    import torch

    for trace in (False, True):
        res = harness.run_cell(manifest, "new-model.serve-short", 5, 0.3, trace,
                               torch.device("cpu"), time.perf_counter(), bench=bench)
        assert res["correct"], res["checks"]
        if trace:
            assert set(res["metrics"]) == {"turn_p90_ms.new"}
        else:
            assert set(res["metrics"]) == {"turn_p95_ms", "setup_s"}


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "ance-cast.serve-turns", "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "ance-cast.serve-turns", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "program under test is missing" in out.stderr
