"""One run of one benchmark cell on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and each compared number beside its limit as the last lines of standard
error; with ``--trace 1`` the program's span table (``spans.format_table``)
comes before them. Exits non-zero, printing no result, without a card (or
with fewer cards than the cell asks for), without the port, or when JAX or
the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()  # set-up counts from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache the run may fill lives at a fixed path inside the checkout
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tables: dict = {}
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, STARTED,
                              tables=tables)
    bad = harness.forbidden_modules()
    if bad:
        print("the run loaded JAX or the JAX package: " + ", ".join(bad), file=sys.stderr)
        return 3
    if "spans" in tables:
        from portbench import spans

        print("\n".join(spans.format_table(tables["spans"])), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
