"""What the metric readers (``metrics/<name>.py``) share. A reader takes a
run's observations and returns a number, or None when the run holds
nothing for it to read; it never makes up a 0.

Observations (``obs``): ``latency_s`` (each call's host-clock seconds in the
window), ``window_s``, ``units`` (queries or examples the window
completed), ``least_s`` (each call's or step's least time at the peaks),
``setup_s``; with ``--trace 1`` also ``trace`` (:class:`~h100_bench.devtrace.
Trace`), ``work`` (each traced kernel family's :class:`~h100_bench.work.Work`
over the traced segment) and ``spans_ms`` (device ms of a part timed alone).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from h100_bench import work

# kernels of each function, by the names their CUDA sources give them
SCORES = ("scores_groupmax",)
ATTN_FWD = ("flash_fwd",)
ATTN_BWD = ("flash_bwd", "row_dot_kernel")


def latency_ms(obs: dict, q: float) -> Optional[float]:
    """The ``q``-th percentile of every call in the window, in ms."""
    lat = obs.get("latency_s")
    return float(np.percentile(np.asarray(lat), q)) * 1e3 if lat else None


def rate(obs: dict) -> Optional[float]:
    """Work completed over the window: all of it over all of the time."""
    return obs["units"] / obs["window_s"] if obs.get("units") else None


def span_ms(obs: dict, name: str) -> Optional[float]:
    return obs.get("spans_ms", {}).get(name)


def roofline(obs: dict, family: str, patterns: Sequence[str]) -> Optional[float]:
    """% of the least time of a function's work in the traced segment over
    its kernels' device time there."""
    tr, w = obs.get("trace"), obs.get("work", {}).get(family)
    if tr is None or w is None:
        return None
    seconds, launches = tr.kernel_seconds(patterns)
    if not launches or seconds <= 0:
        return None
    return 100.0 * w.least_s(work.peaks()) / seconds


def idle_share(obs: dict) -> Optional[float]:
    """% of the traced segment in which no operation ran on the device."""
    tr = obs.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(obs: dict) -> Optional[float]:
    """% of the window that the calls' or steps' least times at the peaks
    would fill."""
    least = obs.get("least_s")
    return 100.0 * sum(least) / obs["window_s"] if least else None
