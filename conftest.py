"""Each pytest-xdist worker's share of the CPU cores.

The workers share the box's cores. Left at one thread per core, every
worker's OpenMP pools (torch's among them) contend for the same cores, and the
suite's time goes to that contention. So under xdist each worker's
``OMP_NUM_THREADS`` is ``max(1, ncpu // workers)``, unless the caller exported
one. pytest loads this file before ``tests/conftest.py``, so the variable is
set before torch or jax load, and the ranks and CLIs that tests spawn inherit
it. Outside xdist nothing is set.
"""

import os

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    ncpu = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1)
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, ncpu // workers)))
