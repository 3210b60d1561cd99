"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics read.

Device operations are the trace's kernels, copies and memsets. The window
is the host span ``window_span`` (it ends after a synchronisation). Busy
time is the union of the device operations' intervals inside it, so
overlapping operations count once. Each idle gap goes to the innermost
host span of the benchmark that was open at its middle.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "user_annotation"
TOP = 10


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_s(intervals: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in merge(intervals)) / 1e6


def summarize(doc: dict, window_span: str) -> dict:
    """``window_s``, ``busy_s``, ``htod_s`` (union of host-to-device copies),
    ``ops`` (name → [count, seconds], every device operation that starts in
    the window), ``kernels`` (how many of them are kernels), and the
    breakdown's ``device_ops`` and ``idle_gaps`` ([name, seconds], at most
    ten each)."""
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") == HOST_CAT]
    win = [e for e in host if e["name"] == window_span]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} spans {window_span!r}, not one")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    ops: Dict[str, list] = {}
    busy, htod = [], []
    kernels = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or not t0 <= e["ts"] < t1:
            continue
        a, b = e["ts"], min(e["ts"] + e["dur"], t1)
        busy.append((a, b))
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            htod.append((a, b))
        kernels += e["cat"] == "kernel"
        slot = ops.setdefault(e["name"], [0, 0.0])
        slot[0] += 1
        slot[1] += (b - a) / 1e6
    merged = merge(busy)
    gaps, cursor = [], t0
    for a, b in merged:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        gaps.append((cursor, t1))
    return dict(window_s=(t1 - t0) / 1e6, busy_s=sum(b - a for a, b in merged) / 1e6,
                htod_s=union_s(htod), ops=ops, kernels=kernels,
                device_ops=[[n, s] for n, (_, s) in
                            sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]],
                idle_gaps=_gaps_by_span(gaps, [e for e in host if e["name"] != window_span],
                                        window_span))


def _gaps_by_span(gaps, spans, outer: str) -> list:
    """Idle seconds by the innermost host span open at each gap's middle."""
    mids = [(a + b) / 2 for a, b in gaps]
    owner = [(float("inf"), outer)] * len(gaps)
    for s in spans:
        lo = bisect.bisect_left(mids, s["ts"])
        hi = bisect.bisect_right(mids, s["ts"] + s["dur"])
        for i in range(lo, hi):
            if s["dur"] < owner[i][0]:
                owner[i] = (s["dur"], s["name"])
    by_name: Dict[str, float] = {}
    for (a, b), (_, name) in zip(gaps, owner):
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
