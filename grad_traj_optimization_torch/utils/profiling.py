"""Tracing / profiling helpers (port of
``grad_traj_optimization_tpu.utils.profiling``).

Replaces the reference's manual ``ros::Time`` stopwatches scattered
through the optimizer and search code (grad_traj_optimizer.cpp:283-285,
434-447; SURVEY.md section 5): structured timings on the host side plus
``torch.profiler`` traces of the device.

The solve already returns its own device-side metrics (cost trace,
accepted iterations, status); these helpers cover host-visible wall time
and kernel-level traces.
"""

from __future__ import annotations

import contextlib
import time

import torch

from grad_traj_optimization_torch.checkpoint import _flatten


class Stopwatch:
    """Accumulating named timers (host wall time).

    >>> sw = Stopwatch()
    >>> with sw.section("edt"):
    ...     build_field()
    >>> sw.report()
    {'edt': {'total_s': ..., 'count': 1}}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            k: {"total_s": round(v, 6), "count": self.counts[k]}
            for k, v in self.totals.items()
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace around a block, CPU and (where a card is
    visible) CUDA activities; on exit a Chrome trace
    (``<worker>.<time>.pt.trace.json``) is written into ``log_dir``.

    Device-side replacement for the reference's per-iteration stopwatch:
    shows the actual kernel timeline instead of host-observed wall time.
    """
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def sync_time(fn, *args, host_read=None, n: int = 1):
    """Device timing: run ``fn`` n times, force completion with a host
    read, return (result, best_s).

    ``host_read(result) -> float`` is the barrier (default: the first
    leaf's first element); when the result holds CUDA tensors the stream
    is synchronised before it, so the time covers the device's work.
    """
    def default_read(r):
        leaf = _flatten(r)[0]
        return float(torch.as_tensor(leaf).reshape(-1)[0])

    read = host_read or default_read

    def barrier(r):
        if any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in _flatten(r)):
            torch.cuda.synchronize()
        read(r)

    result = fn(*args)
    barrier(result)  # warm + sync
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        result = fn(*args)
        barrier(result)
        best = min(best, time.perf_counter() - t0)
    return result, best
