"""Observability: the ``metrics.jsonl`` sink of training.

The counterpart of ``convdr_tpu/utils/observability.py::MetricsLogger``: one
JSON object per log step (step, wall seconds since the logger opened,
scalars), appended and flushed. The JAX module's phase timers and profiler
traces are not ported yet (ROADMAP.md, tooling).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


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
