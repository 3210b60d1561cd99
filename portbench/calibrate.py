"""Readings for the correctness limits of one cell, many seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds a,b,... \
        [--controls fp8,bf16] [--control-seeds c,d,e] [--out FILE] \
        [--config C --traffic T]

For each seed: the cell's set-up, the calls the comparison judges (as many
as a run judges), then the comparison (the program's readings). For each
control seed and control: the same, with the control in the program's
place. One JSON line per reading set, to standard output and ``--out``.
A cell outside ``BENCHMARK.json`` is named with its ``--config`` and
``--traffic``. Exits non-zero without a card, and stops, printing no further
line, once JAX or the JAX package is loaded. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def judged_calls(traffic: dict) -> int:
    return traffic.get("judged_calls", 1 if "rows_per_call" in traffic else 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    p.add_argument("--config", help="the configuration of a cell outside BENCHMARK.json")
    p.add_argument("--traffic", help="the traffic mix of a cell outside BENCHMARK.json")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    entry = (dict(name=args.workload, config=args.config, traffic=args.traffic, chips=1)
             if args.config else None)
    cell = harness.load_cell(args.workload, entry=entry)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    harness.set_precision(cell.config["precision"])
    driver = cell.driver
    out = open(args.out, "a") if args.out else None
    ints = lambda s: [int(x) for x in s.split(",") if x]
    runs = [(s, "program") for s in ints(args.seeds)]
    runs += [(s, k) for s in ints(args.control_seeds) for k in args.controls.split(",") if k]
    by_seed = {}
    for seed, kind in runs:
        t0 = time.perf_counter()
        if seed not in by_seed:
            by_seed.clear()
            gc.collect()
            torch.cuda.empty_cache()
            ctx = harness.Ctx(cell, seed, device)
            prog = driver.setup(ctx)
            for i in range(judged_calls(cell.traffic)):
                prog.call(i)
            by_seed[seed] = (ctx, prog.finish())
            del prog
        ctx, judged = by_seed[seed]
        report = {} if "report" in inspect.signature(driver.check).parameters else None
        extra = {} if report is None else {"report": report}
        readings = (driver.check(ctx, judged, **extra) if kind == "program"
                    else driver.control(ctx, judged, kind, **extra))
        line = dict(workload=args.workload, seed=seed, kind=kind, readings=readings,
                    seconds=time.perf_counter() - t0)
        if report and "leaves" in report:
            leaves = report.pop("leaves")
            line["worst_leaves"] = {
                k: [list(r) for r in sorted((r for r in leaves if r[1] == k), reverse=True)[:3]]
                for k in ("grad_gap", "change_gap")}
            line["median_leaf"] = {k: statistics.median(r[0] for r in leaves if r[1] == k)
                                   for k in ("grad_gap", "change_gap")}
        if report:
            line["report"] = report
        bad = harness.forbidden_modules()
        if bad:
            print("the run loaded JAX or the JAX package: " + ", ".join(bad), file=sys.stderr)
            return 3
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
