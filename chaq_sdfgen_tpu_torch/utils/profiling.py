"""Timing and tracing (chaq_sdfgen_tpu/utils/profiling.py): the
counterpart of the reference's only instrumentation, the OpenCL --time
flag reading CL event profiling (opencl/main.cpp:333-356).

On the card the device's own clock times a call (CUDA events), as
chip_smoke.cuda_ms does; on the CPU the host's clock. A trace is a
torch.profiler Chrome trace, with the card's kernels where one is present.

``span(name)`` marks a piece of the port's host work (an entry, an op, a
launch, a training step and its parts) as a ``record_function`` range,
which a running torch.profiler records as a ``user_annotation`` event on
the clock of the card's kernels; with no profiler running it is one C
check and a shared null context. The hard path's per-call sites test
``recording()`` and skip the ``with`` altogether when it is false: the
null context's ``__enter__`` and ``__exit__`` are Python calls, and the
host sets the pace of a one-image call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Optional

import torch

recording = torch._C._autograd._profiler_enabled  # whether a torch profiler is recording
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a profiler range while a torch
    profiler is recording (``device_trace``, or any other), on the thread
    that enters it; else the shared null context, at the cost of one
    check."""
    if not recording():
        return _NULL
    return torch.profiler.record_function(name)


def _on_card(x: Any) -> bool:
    """Whether ``x`` (a tensor, or a tuple, list or dict of them) holds a
    CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    return isinstance(x, (list, tuple)) and any(_on_card(v) for v in x)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def kernel_timer(label: str = "Kernel", emit: Optional[Callable[[str], None]] = None):
    """Wall-clock the body, waiting on the current CUDA device at its end
    when CUDA is in use. Prints ``Kernel timing: N sec`` like the
    reference's event callback (opencl/main.cpp:352-355), or passes the
    line to ``emit``."""
    emit = emit or print
    t0 = time.perf_counter()
    yield
    _sync()
    emit(f"{label} timing: {time.perf_counter() - t0:.3f} sec")


def time_compiled(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Best-of-``iters`` seconds of one call ``fn(*args)``, after
    ``warmup`` calls (at least one: it shows where the call runs). Where
    the arguments or the result hold a CUDA tensor, CUDA events around
    each call; else the host's clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if not (_on_card(args) or _on_card(out)):
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


@contextlib.contextmanager
def device_trace(path: str):
    """A torch.profiler trace of the body (host ops, and the card's
    kernels where CUDA is available), written on exit as one Chrome trace
    JSON into the directory ``path`` (as jax.profiler.start_trace takes a
    directory): ``path/trace_<ns>.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(path, f"trace_{time.time_ns()}.json"))
