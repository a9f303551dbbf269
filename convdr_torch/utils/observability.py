"""Observability: the metrics sink, phase timers, profiler traces and the
program's spans.

The counterpart of ``convdr_tpu/utils/observability.py``:

  * :class:`MetricsLogger` -- append-only ``metrics.jsonl`` (one JSON object
    per log step: step, wall seconds since the logger opened, scalars);
  * :class:`PhaseTimer`    -- seconds of a pipeline phase, to the end of
    its device work when given a card, logged at exit (and to a
    :class:`MetricsLogger` when one is given);
  * :func:`profile_trace`  -- a ``torch.profiler`` trace of a block of code
    (host and, on a card, CUDA activity) written as a Chrome trace under
    ``log_dir``; nothing at all when ``log_dir`` is empty;
  * :func:`span`           -- a named span of the program (``convdr.*``),
    recorded only while a ``torch.profiler`` runs.

The spans, by layer (a span's device work is found in the trace through
the ``correlation`` ids of the launches made inside it; parentage is
nesting):

  * serving (``retrieval/online.py``): ``convdr.serve.turn`` (a whole
    ``search_tokens``) and, inside a replay, ``convdr.serve.copy_in``,
    ``convdr.serve.replay`` and ``convdr.serve.wait``;
  * training (``train/trainer.py``): ``convdr.train.step`` around
    ``convdr.train.student_fwd``, ``convdr.train.teacher_targets``,
    ``convdr.train.teacher_docs``, ``convdr.train.backward`` and
    ``convdr.train.optimizer``;
  * corpus embedding (``retrieval/embed_corpus.py``): ``convdr.embed.pass``
    around ``convdr.embed.batch`` (which holds ``convdr.embed.readback``)
    and ``convdr.embed.write_block``;
  * a decoder encoder (``models/deepseek_v2.py``): ``convdr.mla.attention``
    around each latent-attention block, ``convdr.moe.experts`` around each
    expert layer, ``convdr.moe.route`` inside it around the router and the
    ordering of its routed rows;
  * sharded search (``parallel/sharded_search.py``):
    ``convdr.shard.gather_merge`` around the ``all_gather`` of the shards'
    top-k lists and their merge;
  * ``convdr.phase.<name>``: a :class:`PhaseTimer`'s phase.

No span sits inside a CUDA-graph capture.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import torch

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


# what span() returns while no profiler runs: one shared object, entered
# and left at no cost
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("convdr.<layer>.<part>"): ...`` -- a span of the program
    in the profiler's trace: ``torch.profiler.record_function(name)`` while
    a profiler runs (its start and end on the profiler's clock, in the same
    Chrome trace as the kernels), else one shared no-op context (nothing
    allocated, no dispatcher call)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class PhaseTimer:
    """with PhaseTimer("search", device=dev): ... -> logs elapsed seconds.

    With a CUDA ``device`` the exit synchronizes it first, so the phase
    ends with its device work and not at its last enqueue. The phase is
    also the span ``convdr.phase.<name>``."""

    def __init__(self, name: str, sink: Optional[MetricsLogger] = None,
                 step: int = 0, device: Optional[torch.device] = None):
        self.name = name
        self.sink = sink
        self.step = step
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self._span = span(f"convdr.phase.{self.name}")
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self.t0
        self._span.__exit__(*exc)
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
