"""The device trace of a traced segment: ``torch.profiler`` over the CPU and
the card, its Chrome trace read back for the device operations' intervals,
each kernel's time by name, the device's busy time and the idle gaps by
what the host was doing."""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

SPAN = "bench.traced_segment"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[(<]", name)[0][:96]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (raw name, seconds)
    device_ops: List[List] = field(default_factory=list)
    idle_gaps: List[List] = field(default_factory=list)

    def kernel_seconds(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Total device seconds and launches of kernels whose name holds
        any of ``patterns``."""
        hits = [s for n, s in self.kernels if any(p in n for p in patterns)]
        return sum(hits), len(hits)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_trace(events: List[dict]) -> Trace:
    """The :class:`Trace` of a Chrome trace's events around its one
    :data:`SPAN`."""
    spans = [e for e in events if e.get("name") == SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} '{SPAN}' spans, not one")
    span = spans[0]
    lo, hi = span["ts"], span["ts"] + span["dur"]
    dev, kernels = [], []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if b < lo or a > hi:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            dev.append((a, b))
            if cat == "kernel":
                kernels.append((e["name"], (b - a) / 1e6))
        elif (cat in HOST_CATS and e is not span and e.get("pid") == span.get("pid")
              and e.get("tid") == span.get("tid")):
            host.append((a, b, e["name"]))
    busy = _merge(dev)
    by_kernel: Dict[str, float] = collections.defaultdict(float)
    for n, s in kernels:
        by_kernel[short_name(n)] += s
    # idle gaps, each named by the innermost host operation running at its middle
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid) - 1
        best = None
        for k in range(j, max(-1, j - 256), -1):
            h = host[k]
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        gaps[best[2] if best else "host outside any traced operation"] += (b - a) / 1e6
    return Trace(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernels=kernels,
        device_ops=[[n, s] for n, s in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    )


def traced(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` under the profiler, inside :data:`SPAN`, ending in a
    device sync, and read the trace. The Chrome trace goes to a temporary
    file under ``TMPDIR`` and is removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read_trace(events)
