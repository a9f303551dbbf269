"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration (a file of sizes) and its
traffic mix (``mixes/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``); each metric is a reader of its own
(``metrics/<metric>.py``); each cell's limits of the comparison are
``limits/<cell>.json``. A cell, a mix or a metric is added as files and
entries, with no edit here.

A run: the driver's set-up (kernels built, weights and inputs made on the
device, the program built and warmed up), the measured window, the traced
segment (``--trace 1``), then the comparison with the plain reference once
the program is freed. The result is one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "convdr_tpu")


@dataclass
class Ctx:
    """What a driver reads: the cell's configuration and mix, the run's
    seed and window, and the device."""

    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: torch.device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_file(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_cell(manifest: dict, name: str, bench: str = BENCH):
    """(workload entry, configuration, mix) of the cell ``name``."""
    wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "mixes", wl["traffic"] + ".json")) as f:
        mix = json.load(f)
    return wl, cfg, mix


def load_driver(name: str, bench: str = BENCH) -> ModuleType:
    return _load_file(os.path.join(bench, "drivers", name + ".py"), f"h100_bench_driver_{name}")


def metric_reader(name: str, bench: str = BENCH) -> Optional[Callable[[dict], Optional[float]]]:
    """``read(obs)`` of ``metrics/<name>.py``, or None if there is no such
    file."""
    path = os.path.join(bench, "metrics", name + ".py")
    if not os.path.exists(path):
        return None
    return _load_file(path, "h100_bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (``--trace 0``) or the per-layer metrics that read in it (``--trace 1``)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def read_metrics(entries: List[dict], obs: dict, bench: str = BENCH) -> Dict[str, dict]:
    """Each metric's value from its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in entries:
        reader = metric_reader(m["name"], bench)
        value = reader(obs) if reader is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run_cell(manifest: dict, cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, *, bench: str = BENCH) -> dict:
    """One run of ``cell``; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
    ``breakdown``, and last ``checks``: each compared number beside its
    limit)."""
    from h100_bench import checks, program

    wl, cfg, mix = load_cell(manifest, cell, bench)
    ctx = Ctx(cfg, mix, seed, seconds, device)
    # the configuration's precision, for the program and its reference alike
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    driver = load_driver(mix["driver"], bench)
    if device.type == "cuda":
        program.build_kernels()
    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    obs = driver.window(ctx, state)
    info = device_info(device, wl["chips"])
    obs["forbidden"] = forbidden_modules()
    if trace:
        obs.update(driver.traced(ctx, state))
    numbers = driver.check(ctx, state, obs)
    verdicts = checks.verdict(numbers, checks.load_limits(cell, bench))

    obs["setup_s"] = setup_s
    metrics = read_metrics(cell_metrics(manifest, cell, trace), obs, bench)
    result = {
        "correct": all(v["ok"] for v in verdicts.values()),
        "attempted": obs["attempted"],
        "failed": obs.get("failed", 0),
        "metrics": metrics,
        "device": info,
    }
    tr = obs.get("trace")
    if trace and tr is not None:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = {n: {"value": v["value"], "limit": v["limit"]} for n, v in verdicts.items()}
    result["_forbidden"] = sorted(set(obs["forbidden"]) | set(forbidden_modules()))
    return result
