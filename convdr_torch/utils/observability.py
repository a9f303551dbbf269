"""Observability: the metrics sink, phase timers and profiler traces.

The counterpart of ``convdr_tpu/utils/observability.py``:

  * :class:`MetricsLogger` -- append-only ``metrics.jsonl`` (one JSON object
    per log step: step, wall seconds since the logger opened, scalars);
  * :class:`PhaseTimer`    -- wall-clock seconds of a pipeline phase, logged
    at exit (and to a :class:`MetricsLogger` when one is given);
  * :func:`profile_trace`  -- a ``torch.profiler`` trace of a block of code
    (host and, on a card, CUDA activity) written as a Chrome trace under
    ``log_dir``; nothing at all when ``log_dir`` is empty.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

# the name of the span that covers the traced block in every trace
TRACE_SPAN = "profile_trace"


class MetricsLogger:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl",
                 prefix: str = ""):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self.prefix = prefix
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            rec[f"{self.prefix}{k}" if self.prefix else k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class PhaseTimer:
    """with PhaseTimer("search"): ... -> logs elapsed seconds."""

    def __init__(self, name: str, sink: Optional[MetricsLogger] = None,
                 step: int = 0):
        self.name = name
        self.sink = sink
        self.step = step

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        logger.info("phase %s: %.4fs", self.name, self.elapsed)
        if self.sink is not None:
            self.sink.log(self.step, {f"{self.name}_seconds": self.elapsed})


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the block with ``torch.profiler`` when ``log_dir`` is given:
    CPU activity, plus CUDA activity when a card is present, the block
    inside one ``TRACE_SPAN`` span. The Chrome trace is written to
    ``log_dir/trace-<pid>-<ms>.json`` when the block ends. No-op (no
    profiler, nothing written) when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(TRACE_SPAN):
            yield
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
