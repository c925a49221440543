"""Spans around the program's public calls, and the device trace.

A span is a named interval on the host clock.  In a traced run each span
also opens a ``torch.profiler.record_function`` range and synchronises
the device at both ends, so the kernels that run inside it are the ones
the span's call launched; an untraced run only reads the clock, so the
end-to-end numbers carry no synchronisation of the benchmark's own.

:class:`DeviceTrace` profiles the first ``seconds`` of the window with
``torch.profiler`` and reduces it to the device's busy seconds (the union
of kernel, copy and set intervals), the device milliseconds inside each
span, the operations that took the most time and the longest idle gaps
by the span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "gtop."
#: the span that marks the traced window: operations outside it are not read
WINDOW = "window"


class Spans:
    def __init__(self, traced: bool, device: torch.device):
        self.traced = traced
        self.device = device
        self.times: dict[str, list[float]] = defaultdict(list)  # seconds

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.traced:
            t0 = time.perf_counter()
            yield
            self.times[name].append(time.perf_counter() - t0)
            return
        with torch.profiler.record_function(PREFIX + name):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.times[name].append(time.perf_counter() - t0)


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(e, what + "_us")() * 1000


def _is_device_op(e) -> bool:
    if "cuda" not in str(e.device_type()).lower():
        return False
    name = e.name()
    if name.startswith(PREFIX):
        return False
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    if kind:
        return any(k in kind for k in ("kernel", "memcpy", "memset"))
    return "sync" not in name.lower()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """Profile the first ``seconds`` of a window, then reduce it."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.prof = None
        self.t0 = self.window_s = None
        self.result = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if torch.cuda.is_available():  # the tracer's own first-launch cost
            x = torch.ones(1 << 20, device="cuda")
            for _ in range(8):
                x = x * 1.0
            torch.cuda.synchronize()
        self.mark = torch.profiler.record_function(PREFIX + WINDOW)
        self.mark.__enter__()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.result is None

    def due(self) -> bool:
        return (self.running and self.window_s is None
                and time.perf_counter() - self.t0 >= self.seconds)

    def stop(self):
        """End the traced window; :meth:`finish` reduces it later, so a
        window that goes on is not held up."""
        if not self.running or self.window_s is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def finish(self) -> dict:
        self.stop()
        if self.result is None:
            self.result = reduce_events(
                self.prof.profiler.kineto_results.events(), self.window_s)
            self.prof = None
        return self.result


def reduce_events(events, window_s: float) -> dict:
    ops, spans = [], defaultdict(list)
    for e in events:
        if _is_device_op(e):
            s = _ns(e, "start")
            ops.append((s, s + _ns(e, "duration"), e.name()))
        elif e.name().startswith(PREFIX) and "cpu" in str(e.device_type()).lower():
            s = _ns(e, "start")
            spans[e.name()[len(PREFIX):]].append((s, s + _ns(e, "duration")))
    w = spans.pop(WINDOW, None)
    if w:
        a, b = w[0]
        ops = [(max(s, a), min(e, b), n) for s, e, n in ops if e > a and s < b]
    busy = _union([(s, e) for s, e, _ in ops])
    by_name = defaultdict(float)
    for s, e, n in ops:
        by_name[n] += (e - s) * 1e-9
    # device ms of each call of a span: its ops' busy time inside it
    starts = [s for s, _ in busy]
    span_ms = {}
    for name, ivs in spans.items():
        per = []
        for a, b in ivs:
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            t = 0
            while i < len(busy) and busy[i][0] < b:
                s, e = busy[i]
                t += max(0, min(e, b) - max(s, a))
                i += 1
            per.append(t * 1e-6)
        span_ms[name] = per
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in
                   zip(busy, busy[1:])), reverse=True)[:10]

    def host_in(t):
        return next((n for n, ivs in spans.items() for a, b in ivs
                     if a <= t <= b), "outside any span")

    gaps = [[host_in((e0 + s1) / 2), g * 1e-9] for g, e0, s1 in gaps]
    busy_s = sum(e - s for s, e in busy) * 1e-9
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "span_device_ms": span_ms,
        "device_ops": sorted(([n, t] for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": gaps,
    }
