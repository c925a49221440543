"""Tracing: the port's spans and counters, and the Chrome-trace exporter
(port of ``grad_traj_optimization_tpu.utils.profiling``).

Replaces the reference's manual ``ros::Time`` stopwatches scattered
through the optimizer and search code (grad_traj_optimizer.cpp:283-285,
434-447; SURVEY.md section 5).

**Spans.** ``with span("pipeline.search") as s:`` times a layer boundary
on the host (``s.seconds`` after the block, always).  While a
``torch.profiler`` records, the span also opens the profiler range
``"gtop." + name`` and, if the profiler still records when the block
ends, keeps a :class:`Span` in memory: its name, start and end on the
profiler's clock, its id, its parent's id, the id of the outermost span
open around it (one ``plan_batch`` call, one replan tick) and the
counts added while it was open, its children's included.  A span never
synchronises the device: its interval is the host's, and the device
work inside it is what ran on the card while the host was there.  With
no profiler recording, a span costs one ``_profiler_enabled()`` check
and two clock reads.

**One clock.** The profiler stamps its events in Unix-epoch
nanoseconds; a span reads ``time.perf_counter_ns()`` plus one offset
fixed against ``time.time_ns()`` when a span first finds the profiler
recording, so a record and its range agree.  The range is opened with
the profiler's fast record-function (a few microseconds, against tens
for ``torch.profiler.record_function``), so its ends lie within
microseconds of the record's.

**Counters.** ``add(name, n)`` counts whether or not anything records:
kernel launches (``launch.*``), calls of a kernel's plain version
(``plain.*``), the search's lanes, and by site each place where the
program makes the card's stream synchronise (``sync.*``): a blocking
device-to-host read (:func:`to_host`), a copy of host memory to the card
(:func:`to_device`, ``sync.h2d.*``) and a boolean-mask gather on the card
(:func:`masked`, ``sync.nonzero.*``).  ``counter``/``counters`` read them
and ``reset_counters`` sets them to 0.  The counters are process-wide; a
span's ``counts`` are those its own thread added while it was open.
Records are cleared when a span first finds a profiler recording after
one found none, so they hold one profiler session's spans.

:func:`device_trace` writes a Chrome trace of a block, the program's
spans among its events.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import Counter
from typing import NamedTuple

import torch

PREFIX = "gtop."


class Span(NamedTuple):
    """One finished span: ``start_ns``/``end_ns`` on the profiler's clock
    (Unix-epoch ns); ``parent`` None for a root; ``counts`` the counters
    added while it was open."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    counts: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _clock_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of
    a few bracketed reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class Tracer:
    """Span records and counters; the module's functions use
    :data:`TRACER`."""

    def __init__(self):
        self.records: list[Span] = []
        self.counts: Counter = Counter()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open = threading.local()  # this thread's stack of open spans
        self._offset = None

    def span(self, name: str) -> "_Open":
        return _Open(self, name)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n
        for s in getattr(self._open, "stack", ()):  # this thread's spans
            s.counts[name] += n

    def counter(self, name: str) -> int:
        return self.counts[name]

    def counters(self, prefix: str = "") -> dict:
        with self._lock:
            return {k: v for k, v in self.counts.items()
                    if k.startswith(prefix)}

    def reset_counters(self, prefix: str = "") -> None:
        with self._lock:
            for k in [k for k in self.counts if k.startswith(prefix)]:
                del self.counts[k]

    def spans(self, name: str | None = None) -> list[Span]:
        return [s for s in self.records if name is None or s.name == name]

    def reset_spans(self) -> None:
        self.records = []


class _Open:
    """A span while its block runs (see the module's docstring)."""

    __slots__ = ("tracer", "name", "t0", "t1", "rec", "counts", "_range",
                 "_id", "_parent", "_root")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name, self.rec = tracer, name, None

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            tr = self.tracer
            if tr._offset is None:  # recording has started
                tr._offset = _clock_offset()
                tr.records = []
            stack = tr._open.__dict__.setdefault("stack", [])
            self._id = next(tr._ids)
            self._parent = stack[-1]._id if stack else None
            self._root = stack[0]._id if stack else self._id
            self.counts = Counter()
            stack.append(self)
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._range.__enter__()
        else:
            self.tracer._offset = None  # fixed anew when recording starts
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self._range is None:
            return False
        self._range.__exit__(*exc)
        tr = self.tracer
        tr._open.stack.remove(self)
        # kept only where the profiler recorded the whole span, so that
        # records and the profiler's ranges are one set
        if torch.autograd._profiler_enabled() and tr._offset is not None:
            self.rec = Span(self.name, self.t0 + tr._offset,
                            self.t1 + tr._offset, self._id, self._parent,
                            self._root, dict(self.counts))
            tr.records.append(self.rec)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


TRACER = Tracer()
span = TRACER.span
add = TRACER.add
counter = TRACER.counter
counters = TRACER.counters
reset_counters = TRACER.reset_counters
spans = TRACER.spans
reset_spans = TRACER.reset_spans


def traced(name: str):
    """Decorator: the function's call in a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            with TRACER.span(name):
                return fn(*a, **kw)
        return call
    return wrap


def waits(device) -> bool:
    """Whether a copy between the host and ``device`` waits for the
    device's queue (any device but the CPU)."""
    return torch.device(device).type != "cpu"


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t.cpu()``, counted under ``"sync." + site`` where ``t`` is on a
    card: a read that waits for the device's queue to reach ``t``."""
    if waits(t.device):
        TRACER.add("sync." + site)
    return t.cpu()


def to_device(x, site: str, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, counted under
    ``"sync.h2d." + site`` where it copies host data onto a card: a copy
    of pageable host memory, which waits for the device's queue."""
    if waits(device) and not (isinstance(x, torch.Tensor)
                              and waits(x.device)):
        TRACER.add("sync.h2d." + site)
    return torch.as_tensor(x, dtype=dtype, device=device)


def masked(x: torch.Tensor, mask: torch.Tensor, site: str) -> torch.Tensor:
    """``x[mask]`` for a boolean ``mask``, counted under
    ``"sync.nonzero." + site`` where the mask is on a card: the gather's
    size is read back, which waits for the device's queue."""
    if waits(mask.device):
        TRACER.add("sync.nonzero." + site)
    return x[mask]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace around a block, CPU and (where a card is
    visible) CUDA activities; on exit a Chrome trace
    (``<worker>.<time>.pt.trace.json``) is written into ``log_dir``.  The
    program's spans inside the block appear in it as ``gtop.*`` ranges.
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
