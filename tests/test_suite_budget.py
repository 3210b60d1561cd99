"""The suite's CPU-thread budget (the repo's root ``conftest.py``): under
pytest-xdist each worker runs its OpenMP pools at ``max(1, ncpu // workers)``
threads, unless the caller exported a count, and hands that count to the
processes its tests start. Outside xdist nothing is set, so the test skips."""

import os
import subprocess
import sys

import pytest
import torch

WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")


def exported_by_caller():
    """The names in the process's environment as it started."""
    with open("/proc/self/environ", "rb") as f:
        return {kv.split(b"=", 1)[0].decode() for kv in f.read().split(b"\0") if kv}


@pytest.mark.skipif(not WORKERS, reason="the budget is set only under pytest-xdist")
def test_each_worker_runs_within_its_share_of_the_cores():
    assert os.environ.get("OMP_NUM_THREADS")
    threads = torch.get_num_threads()
    # torch sizes its pool from MKL_NUM_THREADS over OMP_NUM_THREADS.
    if not {"OMP_NUM_THREADS", "MKL_NUM_THREADS"} & exported_by_caller():
        ncpu = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                else os.cpu_count() or 1)
        assert threads == max(1, ncpu // int(WORKERS))
    res = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(threads)]
