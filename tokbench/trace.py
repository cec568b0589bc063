"""Reduction of a torch.profiler chrome trace to the device's activity.

The merge of kernel, copy and fill intervals into busy time is copied from
``jtokkit_tpu_torch/bench.py::_device_activity``, so that later changes to
the program cannot move it. The span is the traced calls' own: from the
first ``tokbench.call`` annotation's start to the last one's end.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

CALL = "tokbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
# the profiler's own step annotations cover the harness between calls
PROFILER_STEP = "ProfilerStep#"


@dataclass
class Activity:
    busy_s: float                    # device busy inside the span
    span_s: float                    # first traced call's issue to last return
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def merge_intervals(spans):
    """Sorted (start, end) pairs merged: (busy, [(gap start, gap end)])."""
    spans = sorted(spans)
    if not spans:
        return 0.0, []
    end = spans[0][0]
    busy, gaps = 0.0, []
    for lo, hi in spans:
        if lo > end:
            gaps.append((end, lo))
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy, gaps


def _innermost(host, t: float) -> str:
    """Name of the shortest host event that covers time ``t``."""
    best = None
    for lo, hi, name in host:
        if lo <= t <= hi and (best is None or hi - lo < best[0]):
            best = (hi - lo, name)
    return best[1] if best else "between calls"


def activity(events) -> Activity:
    """Device activity of the traced calls in a list of chrome trace events
    (timestamps and durations in microseconds)."""
    calls = [e for e in events if e.get("ph") == "X" and e.get("name") == CALL]
    if not calls:
        raise ValueError("the trace holds no traced call")
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    spans = [(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)) for e in device]
    busy, gaps = merge_intervals(spans)
    if spans:
        first = min(lo for lo, _hi in spans)
        last = max(hi for _lo, hi in spans)
        gaps = [(t0, first)] * (first > t0) + gaps + [(last, t1)] * (t1 > last)
    else:
        gaps = [(t0, t1)]
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e.get("dur", 0) / 1e6
    tid = calls[0].get("tid")
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("tid") == tid and not e["name"].startswith(PROFILER_STEP)]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return Activity(
        busy_s=busy / 1e6,
        span_s=(t1 - t0) / 1e6,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=[(_innermost(host, (lo + hi) / 2), (hi - lo) / 1e6)
                   for lo, hi in longest],
    )


def idle_pct(a) -> "float | None":
    """100 x (1 - busy / span) of an :class:`Activity`; None without one
    or where nothing ran on the card."""
    if a is None or a.busy_s <= 0:
        return None
    return 100.0 * (1.0 - a.busy_s / a.span_s)


def read_trace(path: str) -> Activity:
    with open(path) as f:
        return activity(json.load(f)["traceEvents"])
