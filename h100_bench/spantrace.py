"""A traced segment with the program's spans: :func:`devtrace.traced`'s
:class:`~h100_bench.devtrace.Trace`, and beside it (``Trace.spans``) what
:func:`h100_bench.spans.read_spans` finds in the same Chrome trace for each
``convdr.*`` span of the calling process, which
:func:`h100_bench.spans.program_span` reads."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable

import torch

from h100_bench import devtrace, spans


def traced(fn: Callable[[], None], device: torch.device) -> devtrace.Trace:
    """Run ``fn`` under the profiler inside :data:`devtrace.SPAN`, ending in
    a device sync; the trace's reading with its spans. The Chrome trace
    goes to a temporary file under ``TMPDIR`` and is removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(devtrace.SPAN):
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
    tr = devtrace.read_trace(events)
    seg = [e for e in events if e.get("name") == devtrace.SPAN and e.get("ph") == "X"][0]
    lo, hi = seg["ts"], seg["ts"] + seg["dur"]
    busy = devtrace._merge([(max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi))
                            for e in events
                            if e.get("ph") == "X" and e.get("cat") in devtrace.DEVICE_CATS
                            and e["ts"] + e.get("dur", 0) >= lo and e["ts"] <= hi])
    tr.spans = spans.read_spans(events, lo, hi, busy, pid=seg.get("pid"))
    return tr
