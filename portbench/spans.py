"""The program's own spans in a ``torch.profiler`` Chrome trace.

The port marks its layer boundaries with ``record_function`` ranges whose
names start with ``s2p.`` (``s2p_tpu_torch/utils/profiling.py::annotate``).
``summarize`` reduces the trace that ``trace.summarize`` reads to one row per
such name:

- ``count``: the spans of that name that start in the window;
- ``launches``: kernels whose launching runtime call lies inside one of them
  (nested spans included), matched to the kernel by the trace's
  ``correlation`` id. A call from any thread of the span's process counts:
  a backward is launched from the autograd engine's own thread while the
  span that asked for it waits;
- ``device_s``: the device time of every operation (kernel, copy, memset)
  launched there, cut at the window's end as ``trace.summarize`` cuts it;
- ``syncs``: host-blocking runtime calls inside them (``SYNCS``);
- ``idle_s``: the device's idle gaps whose middle lies inside one of them.

Beside the rows, ``syncs`` counts the window's host-blocking calls.

The harness puts the table (``spans``) and ``self_ops`` (device time by
innermost span and operation) in every traced run's summary, and ``run.py
--trace 1`` prints the table. Run as a script, this runs one cell's traced
window through the harness: the table and ``self_ops`` on standard error,
the result line (with both) on standard output; it prints no result when
JAX or the JAX package was loaded. A cell outside ``BENCHMARK.json`` is
named with its ``--config`` and ``--traffic``:

    python3 portbench/spans.py --workload <cell> --seed <n> [--config C --traffic T]
"""

import time

STARTED = time.perf_counter()  # set-up counts from the start of the process

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "s2p."
PASS = "s2p.gen.forward"  # one generator pass: the program's pass counter
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
                   "cuEventSynchronize"))

# a span metric that BENCHMARK.json does not carry, which the script adds to its cell: the
# `mat` bridge renders on the fast path, which opens no `s2p.mat.cond`, so it reads none there
METRICS = [
    {"name": "cond_cat_share.bridge", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "MAT conditioning", "moves": "bridge_frames_per_s",
     "workloads": ["walker100-bridge-b256"]},
]


def _window(events: list, window_span: str) -> Tuple[float, float]:
    from portbench import trace

    win = [e for e in events if e.get("cat") == trace.HOST_CAT and e["name"] == window_span]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} spans {window_span!r}, not one")
    return win[0]["ts"], win[0]["ts"] + win[0]["dur"]


def _idle_gaps(events: list, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The window's idle gaps, as ``trace.summarize`` finds them."""
    from portbench import trace

    busy = trace.merge([(e["ts"], min(e["ts"] + e["dur"], t1)) for e in events
                        if e.get("cat") in trace.DEVICE_CATS and t0 <= e["ts"] < t1])
    gaps, cursor = [], t0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        gaps.append((cursor, t1))
    return gaps


def _parse(doc: dict, window_span: str):
    """The window's bounds, its ``s2p.*`` spans by name and process
    ([(start, end)], unmerged) and, by process, its runtime calls in time
    order as (start, device op name or None, kernel?, device seconds, blocks?)."""
    from portbench import trace

    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    t0, t1 = _window(events, window_span)
    inside = lambda e: t0 <= e["ts"] < t1
    ops = {}  # correlation id → (name, kernel?, device seconds)
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS and inside(e) and "correlation" in e.get("args", {}):
            ops[e["args"]["correlation"]] = (e["name"], int(e["cat"] == "kernel"),
                                             (min(e["ts"] + e["dur"], t1) - e["ts"]) / 1e6)
    calls: Dict[object, list] = {}
    spans: Dict[str, Dict[object, list]] = {}
    for e in events:
        if not inside(e):
            continue
        if e.get("cat") in RUNTIME_CATS:
            op, kernel, seconds = ops.get(e.get("args", {}).get("correlation"), (None, 0, 0.0))
            calls.setdefault(e.get("pid"), []).append(
                (e["ts"], op, kernel, seconds, int(e["name"] in SYNCS)))
        elif e.get("cat") == trace.HOST_CAT and e["name"].startswith(PREFIX):
            spans.setdefault(e["name"], {}).setdefault(e.get("pid"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    for c in calls.values():
        c.sort(key=lambda x: x[0])
    return events, t0, t1, spans, calls


class _Sums:
    """Prefix sums over one process's runtime calls (time order) of what
    each launched and whether it blocked."""

    def __init__(self, calls: list):
        self.ts = [c[0] for c in calls]
        self.sums = [(0, 0.0, 0)]
        for _, _, kernel, seconds, sync in calls:
            k, s, y = self.sums[-1]
            self.sums.append((k + kernel, s + seconds, y + sync))

    def within(self, a: float, b: float) -> Tuple[int, float, int]:
        lo, hi = bisect.bisect_left(self.ts, a), bisect.bisect_right(self.ts, b)
        return tuple(x - y for x, y in zip(self.sums[hi], self.sums[lo]))


def summarize(doc: dict, window_span: str) -> dict:
    """``{"by_name": {name: {count, launches, device_s, syncs, idle_s}},
    "syncs": n}`` over the ``s2p.*`` spans of the window ``window_span``."""
    from portbench import trace

    events, t0, t1, spans, calls = _parse(doc, window_span)
    sums = {pid: _Sums(c) for pid, c in calls.items()}
    gaps = _idle_gaps(events, t0, t1)
    mids = [(a + b) / 2 for a, b in gaps]
    widths = [(b - a) / 1e6 for a, b in gaps]
    by_name = {}
    for name in sorted(spans):
        launches, device_s, syncs, idle_s = 0, 0.0, 0, 0.0
        every = []
        for pid, intervals in spans[name].items():
            # spans of one name on several threads, or nested, count their calls once
            merged = trace.merge(intervals)
            every.extend(merged)
            for a, b in merged:
                if pid in sums:
                    k, s, y = sums[pid].within(a, b)
                    launches, device_s, syncs = launches + k, device_s + s, syncs + y
        for a, b in trace.merge(every):
            lo, hi = bisect.bisect_left(mids, a), bisect.bisect_right(mids, b)
            idle_s += sum(widths[lo:hi])
        by_name[name] = dict(count=sum(map(len, spans[name].values())), launches=launches,
                             device_s=device_s, syncs=syncs, idle_s=idle_s)
    return dict(by_name=by_name, syncs=sum(c[4] for cs in calls.values() for c in cs))


def self_ops(doc: dict, window_span: str, top: int = 24) -> list:
    """Device time by the innermost ``s2p.*`` span open at the launching call
    and the device operation's name: the ``top`` largest of [span, op,
    count, seconds]; a call in no such span counts under ``window_span``."""
    _, _, _, spans, calls = _parse(doc, window_span)
    owner = {pid: [(float("inf"), window_span)] * len(c) for pid, c in calls.items()}
    for name, by_pid in spans.items():
        for pid, intervals in by_pid.items():
            ts = [c[0] for c in calls.get(pid, [])]
            for a, b in intervals:
                for i in range(bisect.bisect_left(ts, a), bisect.bisect_right(ts, b)):
                    if b - a < owner[pid][i][0]:
                        owner[pid][i] = (b - a, name)
    out: Dict[tuple, list] = {}
    for pid, cs in calls.items():
        for (_, op, _, seconds, _), (_, name) in zip(cs, owner[pid]):
            if op is not None:
                slot = out.setdefault((name, op), [0, 0.0])
                slot[0] += 1
                slot[1] += seconds
    rows = sorted(out.items(), key=lambda kv: -kv[1][1])[:top]
    return [[name, op, n, s] for (name, op), (n, s) in rows]


# -- what the metric readers share ------------------------------------------

def table(rec):
    """The run's span table, or None where the program recorded no pass."""
    t = (rec.get("trace") or {}).get("spans")
    return t if t and PASS in t["by_name"] else None


def syncs_per_pass(rec):
    t = table(rec)
    return t["syncs"] / t["by_name"][PASS]["count"] if t else None


def syncs_per(rec, unit: str):
    """The window's host-blocking calls ÷ the units of work done in it; the
    count needs no span of the program."""
    t = (rec.get("trace") or {}).get("spans")
    n = rec["units"].get(unit)
    return t["syncs"] / n if t and n else None


def busy_share(rec, name: str):
    """The device time launched inside spans ``name`` ÷ the window's busy time, in %."""
    t = table(rec)
    if not t or name not in t["by_name"] or not rec["trace"]["busy_s"]:
        return None
    return 100.0 * t["by_name"][name]["device_s"] / rec["trace"]["busy_s"]


# -- the script ---------------------------------------------------------------

def format_table(t: dict) -> List[str]:
    rows = sorted(t["by_name"].items(), key=lambda kv: -kv[1]["device_s"])
    out = [f"{'span':<20} {'count':>7} {'launches':>9} {'device_s':>10} {'idle_s':>10} "
           f"{'syncs':>6}"]
    out += [f"{n:<20} {r['count']:>7} {r['launches']:>9} {r['device_s']:>10.6f} "
            f"{r['idle_s']:>10.6f} {r['syncs']:>6}" for n, r in rows]
    out.append(f"window syncs {t['syncs']}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--config", help="the configuration of a cell outside BENCHMARK.json")
    p.add_argument("--traffic", help="the traffic mix of a cell outside BENCHMARK.json")
    args = p.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    entry = (dict(name=args.workload, config=args.config, traffic=args.traffic, chips=1)
             if args.config else None)
    cell = harness.load_cell(args.workload, entry=entry)
    cell.per_layer += [m for m in METRICS if cell.name in m["workloads"]]
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tables: dict = {}
    result = harness.run_cell(cell, args.seed, 0.0, True, device, STARTED, tables=tables)
    bad = harness.forbidden_modules()
    if bad:
        print("the run loaded JAX or the JAX package: " + ", ".join(bad), file=sys.stderr)
        return 3
    spans, ops = tables["spans"], tables["self_ops"]
    print("\n".join(format_table(spans)), file=sys.stderr)
    for name, op, n, seconds in ops:
        print(f"{name:<20} {n:>7} {seconds:>10.6f} {op[:120]}", file=sys.stderr)
    print(json.dumps(dict(result, spans=spans, self_ops=ops)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
