import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

TINY_GEN = dict(ngf=8, state_embed_dim=16, mat_hidden=8)
TINY_TRAFFIC = dict(batch=4, pool=3, pool_rows=32, rows_per_call=16, judged_rows=8,
                    judged_calls=2, trace_calls=2, warmup_calls=1, check_chunk=4)


# cells whose files are here but which BENCHMARK.json leaves out for their
# run-to-run spread (PERF.md, Open questions): their drivers are tested alike
PARKED = {
    "walker100-train-b16": {"name": "walker100-train-b16", "config": "s2p-walker-100",
                            "traffic": "train-b16", "chips": 1},
    "cheetah64-rollout-b1": {"name": "cheetah64-rollout-b1", "config": "s2p-cheetah-64-f32",
                             "traffic": "rollout-b1", "chips": 1},
    "slac-iql-100-b128": {"name": "slac-iql-100-b128", "config": "slac-iql-cheetah-100",
                          "traffic": "iql-b128", "chips": 1,
                          "why": "offline IQL + SLAC steps: batch 128 windows of 9 100px frames "
                                 "from 1,000 real + 1,000 generated rows on the card, f32 (TF32 "
                                 "convs), joint ELBO step on 32 windows a call"},
}


def tiny_cell(name: str, precision: str = None) -> harness.Cell:
    """The cell with its widths and traffic cut to what a CPU test holds:
    64px → 32px and 100px → 25px (chains 32…2 and 25…2), ngf 8."""
    cell = harness.load_cell(name, entry=PARKED.get(name))
    cfg = dict(cell.config, **TINY_GEN)
    cfg["image_size"] = 25 if cfg["image_size"] == 100 else 32
    if "discriminator" in cfg:
        cfg["discriminator"] = dict(cfg["discriminator"], ndf=8)
    if precision:
        cfg["precision"] = precision
    cell.config = cfg
    cell.traffic = {k: TINY_TRAFFIC.get(k, v) for k, v in cell.traffic.items()}
    return cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
