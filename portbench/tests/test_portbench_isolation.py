"""What the benchmark may load: nothing of JAX or the JAX package anywhere,
nothing of the port in the reference, and none of the repo's other
measurement files."""

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PROBE = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from portbench import harness
which = sys.argv[2]
files = sorted(p for p in harness.BENCH.rglob("*.py")
               if "tests" not in p.parts and (which == "all" or "reference" in p.parts))
for path in files:
    harness.load_module(path)
print(json.dumps({"files": len(files), "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def probe(which: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE, str(ROOT), which], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_benchmark_loads_nothing_of_jax():
    report = probe("all")
    assert report["files"] > 20
    assert not {"jax", "jaxlib", "flax", "s2p_tpu"} & set(report["top"])


def test_reference_loads_nothing_of_the_port():
    report = probe("reference")
    assert report["files"] >= 3
    assert not {"jax", "jaxlib", "flax", "s2p_tpu", "s2p_tpu_torch"} & set(report["top"])


def test_no_module_opens_the_repos_other_measurements():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "chip_smoke", "BENCH_", "BASELINE.json"):
            assert name not in text, (path, name)
