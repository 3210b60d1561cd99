"""Profiling hooks: the port of ``s2p_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace (host and, on the card, CUDA
activity) and writes it as a Chrome trace; ``annotate`` names a region in
it (and, on the card, an NVTX range); ``time_compiled_fn`` times the first
call of a function apart from its steady state. The phase table of
``utils.timer`` stays beside them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """A ``torch.profiler`` scope; on exit its Chrome trace is written to
    ``{log_dir}/trace.json`` (readable in Perfetto or chrome://tracing)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def time_compiled_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                     device: str | torch.device = "cuda", **kwargs) -> Dict[str, float]:
    """The first call of ``fn(*args, **kwargs)`` (where PyTorch initialises
    lazily and cuDNN picks its algorithms; JAX's compile) apart from its
    steady state: {'compile_s', 'steady_s_per_call', 'calls_per_s'}. On
    the card (``device``, the default) the steady state is timed with CUDA
    events over ``iters`` calls and every timed region ends in a
    synchronize; on the CPU with the host clock."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("time_compiled_fn on the card, which is not available; "
                           "pass device='cpu' to time on the CPU")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    sync()
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        fn(*args, **kwargs)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync()
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        sync()
        steady = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        steady = (time.perf_counter() - t0) / iters
    return {
        "compile_s": compile_s,
        "steady_s_per_call": steady,
        "calls_per_s": 1.0 / steady if steady > 0 else float("inf"),
    }
