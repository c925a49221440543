#!/usr/bin/env python3
"""Checks of the port's tracer (``utils.profiling``) on the card, through
the benchmark's own cells (no JAX):

1. **One clock.** A traced run of ``forest40.plan`` (``gtop_bench/run.py``'s
   ``run_cell``, ``--trace 1``): every ``pipeline.search`` record against
   its ``gtop.pipeline.search`` range in the profiler's events (start and
   end differences, in microseconds), and the cell's per-layer metrics.
2. **Stream synchronisations.** One plan batch of that cell and the
   ticks of one ``opti_node.replan`` mission under
   ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising calls
   the CUDA runtime reports, by source line, beside the ``sync.*`` counts
   the tracer kept for the same call.

Run from the repository root on a machine with a card:

    python3 scripts/trace_check_torch.py [seed] [out.json]

Prints one JSON line; the whole report goes to ``out.json`` (default
``build/trace_check.json``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import traceback
import warnings
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gtop_bench import run as bench_run  # noqa: E402
from gtop_bench import spec, trace  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402


def clock_check(seed: int) -> dict:
    """The plan cell traced, its program ranges kept beside the records."""
    kept = {}
    reduce = trace.reduce_events

    def keep(events, window_s):
        events = list(events)
        for e in events:
            if (e.name() == profiling.PREFIX + "pipeline.search"
                    and "cpu" in str(e.device_type()).lower()):
                s = e.start_ns()
                kept.setdefault("ranges", []).append((s, s + e.duration_ns()))
        return reduce(events, window_s)

    trace.reduce_events = keep
    profiling.reset_spans()
    try:
        out = bench_run.run_cell(spec.cell("forest40.plan"), seed, 8.0, True,
                                 "cuda")
    finally:
        trace.reduce_events = reduce
    recs = sorted(profiling.spans("pipeline.search"), key=lambda r: r.start_ns)
    ranges = sorted(kept.get("ranges", []))
    d_start = [(a - r.start_ns) * 1e-3 for r, (a, _) in zip(recs, ranges)]
    d_end = [(b - r.end_ns) * 1e-3 for r, (_, b) in zip(recs, ranges)]
    profiling.reset_spans()
    return {"records": len(recs), "ranges": len(ranges),
            "start_diff_us": d_start, "end_diff_us": d_end,
            "max_abs_diff_us": max(map(abs, d_start + d_end), default=None),
            "metrics": out["metrics"], "correct": out["correct"]}


PORT = os.path.join(ROOT, "grad_traj_optimization_torch")


@contextlib.contextmanager
def _caught():
    """The warnings raised inside the block, each as ``(message, line)``:
    ``line`` the source line in the port that made the call, which for a
    warning raised inside torch is the innermost frame of the port on
    the stack, marked ``(via torch)``."""
    caught = []

    def show(message, category, filename, lineno, file=None, line=None):
        where = f"{os.path.relpath(filename, ROOT)}:{lineno}"
        if not filename.startswith(PORT):
            port = [f for f in traceback.extract_stack()
                    if f.filename.startswith(PORT)]
            if port:
                where = (f"{os.path.relpath(port[-1].filename, ROOT)}:"
                         f"{port[-1].lineno} (via torch)")
        caught.append((str(message), where))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        yield caught


def _by_line(caught):
    """The synchronisations by line; ``set_sync_debug_mode`` itself warns
    once that it is a prototype, which is none."""
    return dict(Counter(w for m, w in caught
                        if "synchroniz" in m and "prototype" not in m))


def _syncs(fn):
    """fn() with the runtime's synchronisation warnings on: (result, the
    warnings by source line, the tracer's ``sync.*`` counts)."""
    before = profiling.counters("sync.")
    with _caught() as caught:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = profiling.counters("sync.")
    lines = _by_line(caught)
    counted = {k: v - before.get(k, 0) for k, v in after.items()
               if v != before.get(k, 0)}
    return out, lines, counted


def sync_check(seed: int) -> dict:
    dev = torch.device("cuda")
    rep = {}
    # one plan batch, after the cell's warm batches
    cell = spec.cell("forest40.plan")
    spans = trace.Spans(False, dev)
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, dev, spans,
                                                     1.0)
    drv.setup()
    occ, wps = drv._draw(drv.gen)
    z = torch.zeros_like(wps[:, 0])
    starts = torch.cat([wps[:, 0], z], -1)
    goals = torch.cat([wps[:, -1], z], -1)
    dist = drv.sdf.edt_batch(occ, drv.res)
    torch.cuda.synchronize()
    t = drv.t
    _, lines, counted = _syncs(lambda: drv.pipeline.plan_batch(
        dist, drv.origin, drv.res, starts, goals, cfg=drv.cfg,
        n_waypoints=t["n_knots"], beam=t["beam"], max_iters=t["max_iters"],
        retries=t["retries"], stretches=tuple(t["stretches"]),
        host_fallback=t["host_fallback"], margin=t["margin"],
        check_num=t["check_num"]))
    rep["plan_batch"] = {"runtime_syncs": sum(lines.values()),
                         "by_line": lines, "counted": sum(counted.values()),
                         "counted_by_site": counted}
    drv.release()
    del drv, occ, dist
    torch.cuda.empty_cache()

    # the ticks of one mission: what the runtime reports and what the
    # tracer counts between two tick starts (the loop's map_update call)
    cell = spec.cell("opti_node.replan")
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, dev, spans,
                                                     1.0)
    drv.setup()
    ends = np.asarray(cell.config["waypoints"], np.float64)
    start = np.concatenate([ends[0], np.zeros(3)])
    goal = np.concatenate([ends[-1], np.zeros(3)])
    marks = []  # (warnings so far, sync counts) at each tick start
    with _caught() as caught:

        def tick_start(t_now, grid):
            marks.append((len(caught), profiling.counters("sync.")))
            return None

        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = drv.replan.replan_loop(
                drv.field, drv.map["origin"], drv.res, start, goal,
                obstacle_update=drv._boxes, map_update=tick_start,
                rcfg=drv.rcfg, ocfg=drv.ocfg, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        marks.append((len(caught), profiling.counters("sync.")))
    drv.release()
    out = []
    for i, r in enumerate(res):
        (w0, c0), (w1, c1) = marks[i], marks[i + 1]
        lines = _by_line(caught[w0:w1])
        counted = {k: v - c0.get(k, 0) for k, v in c1.items()
                   if v != c0.get(k, 0)}
        out.append({"via_fallback": bool(r.via_fallback),
                    "search_ok": bool(r.search_ok),
                    "runtime_syncs": sum(lines.values()),
                    "by_line": lines,
                    "counted": sum(counted.values()),
                    "counted_by_site": counted})
    rep["ticks"] = out
    return rep


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seed = int(argv[0]) if argv else 2718281801
    path = argv[1] if len(argv) > 1 else os.path.join(
        ROOT, "build", "trace_check.json")
    if not torch.cuda.is_available():
        print("no CUDA device: these checks read the card", file=sys.stderr)
        return 2
    rep = {"device": torch.cuda.get_device_name(0),
           "clock": clock_check(seed), "syncs": sync_check(seed + 1)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    c = rep["clock"]
    pb = rep["syncs"]["plan_batch"]
    print(json.dumps({
        "device": rep["device"], "records": c["records"],
        "ranges": c["ranges"], "max_abs_diff_us": c["max_abs_diff_us"],
        "metrics": c["metrics"], "correct": c["correct"],
        "plan_batch_syncs": [pb["runtime_syncs"], pb["counted"]],
        "tick_syncs": [[t["runtime_syncs"], t["counted"]]
                       for t in rep["syncs"]["ticks"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
