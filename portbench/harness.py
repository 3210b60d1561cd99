"""The benchmark's machinery: cells found by name, seeded weights, the timed
window, the traced window and the result line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``,
whose ``driver`` names ``drivers/<driver>.py``); ``workloads/<cell>.json``
holds the cell's correctness limits. Each metric is read by
``metrics/<metric>.py``. Nothing here knows a cell, a driver or a metric by
name.

A driver module has ``setup(ctx) -> program`` and ``check(ctx, judged) ->
{reading: value}``. The program object has ``call(i) -> units`` (one closed-
loop call; ``units`` counts the work it did, e.g. frames), ``latency``
(whether each call ends on the host, so that its time is a latency), and
``finish() -> judged``, which hands over what the calls produced for the
comparison and drops the program's state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "s2p_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark from its file (names may hold dots and dashes)."""
    name = "portbench._by_file." + path.relative_to(BENCH).with_suffix("").as_posix().replace(
        "/", ".")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.traffic['driver']}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[dict] = None, entry: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``manifest`` (``BENCHMARK.json`` by default), or
    the one a ``workloads`` entry not in it describes (``entry``), whose
    configuration is then ``configs/<config>.json``."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    entry = entry or next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_file = next((ROOT / c["file"] for c in manifest["configs"]
                     if c["name"] == entry["config"]), BENCH / "configs" / f"{entry['config']}.json")
    return Cell(
        name=name, chips=entry["chips"], config=load_json(cfg_file),
        traffic=load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files, the seed, the device, and
    ``span`` (a profiler range while tracing, else nothing)."""
    cell: Cell
    seed: int
    device: Any
    tracing: bool = False

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def generator(self, tag: str):
        import torch

        return torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, tag))

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def seeded_weights(spec: Dict[str, tuple], gen, device, dtype=None) -> dict:
    """Weights for ``spec`` (name → shape) from one normal draw on the
    device: kernels scaled to variance 1/fan-in, biases to 0.02²."""
    import torch

    total = sum(math.prod(s) for s in spec.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in spec.items():
        n = math.prod(shape)
        scale = 0.02 if len(shape) == 1 else 1.0 / math.sqrt(math.prod(shape[1:]))
        out[name] = (flat[off:off + n].view(shape) * scale).to(dtype or flat.dtype)
        off += n
    return out


def set_precision(precision: str) -> None:
    """The numeric settings a cell runs under: PyTorch's defaults (cuDNN
    may take TF32, cuBLAS may not), stated so that nothing else sets them.
    ``precision`` is the configuration's, the one place a cell's is stated."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    if precision not in ("bf16", "f32-tf32"):
        raise ValueError(f"unknown precision {precision!r}")


def timed_window(prog, ctx: Ctx, seconds: float) -> dict:
    """Closed-loop calls until ``seconds`` have passed, then a sync; the
    window is the host time from its start to that sync."""
    ctx.sync()
    units: Dict[str, float] = {}
    latencies: List[float] = []
    t0 = time.perf_counter()
    calls = 0
    while True:
        t = time.perf_counter()
        got = prog.call(calls)
        if prog.latency:
            latencies.append(time.perf_counter() - t)
        for k, v in got.items():
            units[k] = units.get(k, 0) + v
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    return dict(window_s=time.perf_counter() - t0, calls=calls, units=units,
                latencies_s=latencies)


WINDOW_SPAN = "portbench.window"


def traced_window(prog, ctx: Ctx, calls: int) -> dict:
    """``calls`` calls under ``torch.profiler``, reduced to a summary of the
    device's intervals (``trace.summarize``) with the program's span table
    under ``spans`` (``spans.summarize``) and the device time by innermost
    span and operation under ``self_ops`` (``spans.self_ops``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import spans, trace

    ctx.sync()
    units: Dict[str, float] = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for i in range(calls):
                with record_function("portbench.call"):
                    got = prog.call(i)
                for k, v in got.items():
                    units[k] = units.get(k, 0) + v
            ctx.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        doc = load_json(Path(path))
        summary = trace.summarize(doc, WINDOW_SPAN)
        summary["spans"] = spans.summarize(doc, WINDOW_SPAN)
        summary["self_ops"] = spans.self_ops(doc, WINDOW_SPAN)
    finally:
        os.remove(path)
    return dict(window_s=summary["window_s"], calls=calls, units=units, latencies_s=[],
                trace=summary)


def read_metrics(metrics: List[dict], rec: dict) -> dict:
    out = {}
    for m in metrics:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every reading within its limit, and every limit read."""
    if set(readings) != set(limits):
        raise KeyError(f"readings {sorted(readings)} do not match limits {sorted(limits)}")
    return all(math.isfinite(v) and v <= limits[k] for k, v in readings.items())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, driver=None, tables: Optional[dict] = None) -> dict:
    """One run of ``cell``: set-up, the window (timed, or traced), the
    comparison with the reference. Returns the result line's object; a
    traced run puts its span table and ``self_ops`` under ``tables["spans"]``
    and ``tables["self_ops"]`` when given."""
    import torch

    driver = driver or cell.driver
    set_precision(cell.config["precision"])
    ctx = Ctx(cell, seed, device, tracing=bool(trace))
    prog = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - started
    if trace:
        rec = traced_window(prog, ctx, cell.traffic["trace_calls"])
        if tables is not None:
            tables.update((k, rec["trace"][k]) for k in ("spans", "self_ops"))
    else:
        rec = timed_window(prog, ctx, seconds)
    rec.update(setup_s=setup_s, config=cell.config, traffic=cell.traffic)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, rec)
    judged = prog.finish()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.check(ctx, judged)
    result = {"correct": judge(readings, cell.limits), "attempted": rec["calls"], "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell.chips if cuda else 1, "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        result["breakdown"] = {k: rec["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()}
    return result


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        import random

        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item
