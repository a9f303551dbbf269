"""A tiny copy of the benchmark for CPU tests: the real drivers, metric
readers and limits, the tiny mixes and configurations of ``tiny/``."""

from __future__ import annotations

import json
import os
import time

import torch

from h100_bench import harness

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def tiny_bench(tmp_path) -> str:
    """A bench directory under ``tmp_path``: the real ``drivers/``,
    ``metrics/`` and ``limits/``, the tiny mixes as ``mixes/``."""
    bench = os.path.join(str(tmp_path), "bench")
    os.makedirs(bench)
    for d in ("drivers", "metrics", "limits"):
        os.symlink(os.path.join(harness.BENCH, d), os.path.join(bench, d))
    os.symlink(TINY, os.path.join(bench, "mixes"))
    return bench


def tiny_manifest() -> dict:
    """BENCHMARK.json with each configuration's file the tiny one."""
    manifest = harness.load_manifest()
    for c in manifest["configs"]:
        c["file"] = os.path.relpath(os.path.join(TINY, c["name"] + ".json"), harness.ROOT)
    return manifest


def tiny_config(name: str) -> dict:
    with open(os.path.join(TINY, name + ".json")) as f:
        return json.load(f)


def tiny_mix(name: str) -> dict:
    with open(os.path.join(TINY, name + ".json")) as f:
        return json.load(f)


def run_tiny(tmp_path, cell: str, *, trace: bool = False, seconds: float = 0.5,
             seed: int = 2 ** 31 + 77) -> dict:
    """One run of ``cell`` on the CPU at the tiny size."""
    return harness.run_cell(tiny_manifest(), cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), bench=tiny_bench(tmp_path))
