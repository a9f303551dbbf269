"""The program's own spans in a traced segment.

``convdr_torch.utils.observability.span`` records each ``convdr.*`` span
as a ``user_annotation`` event of the profiler's Chrome trace, on the same
clock as the device's operations. :func:`read_spans` gives, for each span
name, what the program did inside it: how often and how long on the host,
the device operations launched inside it (matched to their launching
runtime or driver call by ``args.correlation``, from any thread of the
process: autograd runs the backward on its own thread, and a graph
replay's kernels share ``cudaGraphLaunch``'s id), their device time, and
the host time in which the device ran nothing. :func:`program_span` is
what a metric reader takes from it.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

from h100_bench.devtrace import DEVICE_CATS, _merge

PREFIX = "convdr."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
KEYS = ("count", "host_s", "launches", "device_s", "idle_s")


def read_spans(events: List[dict], lo: float, hi: float,
               busy: Sequence[Tuple[float, float]],
               pid: Optional[int] = None) -> Dict[str, dict]:
    """Per ``convdr.*`` span name, over the spans that lie inside the
    segment [``lo``, ``hi``] (the trace's microseconds) on the host of
    process ``pid`` (any process when None):

    * ``count``: the spans;
    * ``host_s``: their summed durations;
    * ``launches``: the device operations (kernel, memcpy, memset) whose
      launching call starts inside one of them;
    * ``device_s``: the union of those operations' intervals, clipped to
      the segment;
    * ``idle_s``: the part of the spans' host intervals in which the
      device runs nothing, against ``busy`` (the device's busy intervals
      in the segment, merged and sorted).
    """
    def mine(e):
        return e.get("ph") == "X" and "ts" in e and (pid is None or e.get("pid") == pid)

    spans = [e for e in events if mine(e) and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)
             and e["ts"] >= lo and e["ts"] + e.get("dur", 0) <= hi]
    calls = sorted((e["ts"], e["args"]["correlation"]) for e in events
                   if mine(e) and e.get("cat") in LAUNCH_CATS
                   and "correlation" in e.get("args", {}))
    call_ts = [t for t, _ in calls]
    ops = collections.defaultdict(list)  # correlation -> [(start, end)] clipped
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                and "correlation" in e.get("args", {})):
            a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi)
            ops[e["args"]["correlation"]].append((a, max(a, b)))
    starts = [a for a, _ in busy]
    done = [0.0]  # busy microseconds before each busy interval ends
    for a, b in busy:
        done.append(done[-1] + b - a)

    def busy_before(x: float) -> float:
        k = bisect.bisect_right(starts, x)
        return done[k] - max(0.0, busy[k - 1][1] - x) if k else 0.0

    out: Dict[str, dict] = {}
    device: Dict[str, list] = collections.defaultdict(list)
    for s in spans:
        a, b = s["ts"], s["ts"] + s.get("dur", 0)
        r = out.setdefault(s["name"], dict.fromkeys(KEYS, 0))
        r["count"] += 1
        r["host_s"] += (b - a) / 1e6
        r["idle_s"] += ((b - a) - (busy_before(b) - busy_before(a))) / 1e6
        i, j = bisect.bisect_left(call_ts, a), bisect.bisect_right(call_ts, b)
        for _t, corr in calls[i:j]:
            r["launches"] += len(ops.get(corr, ()))
            device[s["name"]].extend(ops.get(corr, ()))
    for name, r in out.items():
        r["device_s"] = sum(b - a for a, b in _merge(device[name])) / 1e6
    return out


def program_span(obs: dict, name: str, key: str, per: str) -> Optional[float]:
    """The total ``key`` of span ``name`` in the traced segment over the
    ``count`` of span ``per``; None when the run's trace holds no spans or
    either span is absent (never a made-up 0)."""
    spans = getattr(obs.get("trace"), "spans", None) or {}
    s, p = spans.get(name), spans.get(per)
    if not s or not p or not p["count"]:
        return None
    return s[key] / p["count"]
