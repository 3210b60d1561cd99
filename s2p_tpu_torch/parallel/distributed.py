"""Multi-process bootstrap on ``torch.distributed``.

The port of ``s2p_tpu/parallel/distributed.py``. JAX runs one process over
all of a host's devices; the port runs one process per card, as
``torchrun`` starts them, and every collective is explicit. These helpers
keep the bootstrap one call, and are no-ops in a single process, so the
same entry point runs everywhere.
"""

from __future__ import annotations

import os
import socket
import time
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def ranks_backend(devices: Sequence[torch.device]) -> str:
    """``nccl`` when every local rank has a CUDA card of its own, else
    ``gloo`` (the CPU, or ranks sharing a card, which NCCL refuses)."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len({d.index for d in devices}) == len(devices):
        return "nccl"
    return "gloo"


def local_rank() -> int:
    return _int_env("LOCAL_RANK") or 0


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None,
                           device: Optional[torch.device] = None) -> bool:
    """Create the default process group when running multi-process; returns
    True if one was created. Explicit arguments come first, then torchrun's
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``); with neither, this is a single process and nothing is
    done.

    ``backend`` defaults to ``ranks_backend`` of local rank i on ``cuda:i``
    (when CUDA is there), so the caller that places ranks otherwise passes
    it. ``device`` is this rank's card: an NCCL group binds to it at once,
    so a failed NCCL init raises here; it never falls back to gloo.
    """
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if init_method is None and world_size is None:
        return False  # single process: nothing to do
    if backend is None:
        n_local = _int_env("LOCAL_WORLD_SIZE") or world_size
        cuda = torch.cuda.is_available() and n_local <= torch.cuda.device_count()
        backend = ranks_backend([torch.device("cuda", i) if cuda else torch.device("cpu")
                                 for i in range(n_local)])
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device(device if device is not None
                                           else torch.device("cuda", local_rank()))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    print(f"torch.distributed: rank {dist.get_rank()} of {dist.get_world_size()}, "
          f"backend {backend}", flush=True)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_batch_slice(global_batch: int) -> slice:
    """The rows of the global batch this process loads."""
    per_process = global_batch // process_count()
    start = process_index() * per_process
    return slice(start, start + per_process)


def global_mesh(data: int = -1, model: int = 1):
    """A mesh over every process of the group."""
    from s2p_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data=data, model=model))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(target: Callable, world: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``target(rank, world, init_method, *args)`` in ``world`` processes
    of torch.multiprocessing's ``spawn`` context (CUDA does not survive a
    fork), with ``init_method`` a TCP store on a free localhost port. Raises
    if a rank exits non-zero or the ranks outlive ``timeout`` seconds; the
    others are then killed, so a dead or hung rank never stalls the caller."""
    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(rank, world, init_method, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            # a second at most: a rank's sentinel has been seen to stay
            # unready until the timeout after the rank had exited, so its
            # exit status is read every second as well
            wait([p.sentinel for p in procs if p.is_alive()],
                 timeout=min(1.0, max(deadline - time.monotonic(), 0)))
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = {rank: p.exitcode for rank, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed or timed out after {timeout:.0f} s "
                           f"(rank: exit code): {failed}")
