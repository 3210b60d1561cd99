"""Profiling hooks: the port of ``s2p_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace (host and, on the card, CUDA
activity) and writes it as a Chrome trace; ``annotate`` names a region in
it; ``time_compiled_fn`` times the first call of a function apart from its
steady state. The phase table of ``utils.timer`` stays beside them.

The port's spans (``annotate`` at its layer boundaries, every name starting
with ``s2p.``) are recorded by whatever profiler is on: ``trace`` writes
them with the CUDA activity they launched, on one clock; under
``torch.autograd.profiler.emit_nvtx`` they are NVTX ranges. With no
profiler on, a span costs a flag test.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, ContextManager, Dict, Iterator

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()


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


def annotate(name: str) -> ContextManager:
    """A named region: a ``record_function`` range while a profiler records
    (``torch.profiler.profile``, ``trace``, ``emit_nvtx``), else one shared
    null context: a span in the hot path then costs a flag test, not a
    profiler op that nothing reads."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)


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
