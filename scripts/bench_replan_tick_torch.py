#!/usr/bin/env python3
"""Online replanning tick latency of the PyTorch port (the counterpart of
``scripts/bench_replan_tick.py``; no JAX).

The reference's deployment mode is the receding-horizon loop
(path_finder.cpp:302-363, resetRoot); this script measures warm per-tick
wall times of both loops on the reference's demo map (opti_node,
200 x 200 x 25 at 0.2 m, flown from its first waypoint to its last):

* ``replan_loop``: beam kino search -> Hermite seed -> penalty refine a
  tick (the compare22 flow), horizon 8 m, beam 64, up to 40 ticks;
* ``replan_loop_rrt(backend="native")``: one persistent C++ RRT* tree:
  grow -> corridor -> bounded refine -> root commit a tick.

Both refine with ``OptimizerConfig(iters_step2=60)``.  Tick boundaries
are observed through the ``map_update`` callback (called at the start of
every tick), so the loops run unmodified.  The first two ticks of a run
are reported apart (``*_first_tick_s``: the mean of each run's first
tick); the percentiles are over the later ticks of every run.

Run from the repository root:

    python scripts/bench_replan_tick_torch.py [n_runs] [kino_beam] [device]

Defaults: 2 runs, beam 64, the card.  Prints the slowest warm ticks of
each kino run by stage, and one JSON line a loop (the last with both).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import _bench_common_torch as common  # noqa: E402

#: the JAX script's loops: 40 ticks at most, the kino search's horizon
MAX_TICKS = 40
HORIZON = 8.0
REFINE_ITERS = 60


def run_loop(loop_fn, **kw):
    """(tick results, per-tick wall s, total s) of one loop run; ticks
    are timed between successive ``map_update`` calls and the loop's
    return."""
    stamps = []

    def marker(t, grid):
        stamps.append(time.perf_counter())
        return None

    t0 = time.perf_counter()
    results = loop_fn(map_update=marker, **kw)
    t_total = time.perf_counter() - t0
    stamps.append(time.perf_counter())
    return results, np.diff(np.asarray(stamps)), t_total


def _ms(x, q):
    return round(float(np.percentile(x, q)) * 1e3, 1)


def _log(line: str) -> None:
    print(line, flush=True)


def measure(n_runs: int = 2, kino_beam: int = 64, device="cuda",
            log=_log) -> dict:
    """Both loops ``n_runs`` times each on ``device``; returns the JAX
    script's report (warm tick p50/p99 in ms, the first tick in s, warm
    ticks counted, runs that reached the goal; the kino loop's ticks via
    the exact A*; beyond the JAX keys, ``*_refined_ticks``, the ticks
    that refined a seed, one K3 launch each) and logs each run and the
    kino runs' three slowest warm ticks by stage."""
    from grad_traj_optimization_torch import fixtures, replan, solver
    from grad_traj_optimization_torch.config import OptimizerConfig

    dev = common.require(device)
    map_cfg, obss, wp = fixtures.opti_node_scenario()
    scn = solver.make_scenario(wp, obss, map_cfg, device=dev)
    res = float(map_cfg.resolution)
    start = np.concatenate([np.asarray(wp[0], np.float64), np.zeros(3)])
    goal = np.concatenate([np.asarray(wp[-1], np.float64), np.zeros(3)])
    ocfg = OptimizerConfig(iters_step2=REFINE_ITERS)
    out = {}
    for name in ("kino", "rrt"):
        warm, first, reached, fallbacks, refined = [], [], 0, 0, 0
        for r in range(n_runs):
            if name == "kino":
                results, ticks, t_total = run_loop(
                    replan.replan_loop, dist_grid=scn.dist,
                    origin=map_cfg.origin, resolution=res,
                    start_state=start, goal=goal,
                    rcfg=replan.ReplanConfig(max_ticks=MAX_TICKS,
                                             horizon=HORIZON,
                                             kino_beam=kino_beam),
                    ocfg=ocfg, device=dev)
                fallbacks += sum(t.via_fallback for t in results)
            else:
                results, ticks, t_total = run_loop(
                    replan.replan_loop_rrt, dist_grid=scn.dist,
                    origin=map_cfg.origin, resolution=res, start=start[:3],
                    goal=goal[:3],
                    rcfg=replan.RRTReplanConfig(max_ticks=MAX_TICKS,
                                                backend="native", seed=r),
                    ocfg=ocfg, device=dev)
            reached += any(t.reached_goal for t in results)
            refined += sum(t.search_ok for t in results)
            first.append(ticks[0])
            warm.extend(ticks[2:])
            log(f"{name} run {r}: {len(results)} ticks, reached="
                f"{results[-1].reached_goal}, total {t_total:.2f}s")
            if name == "kino":
                # where the slowest warm ticks go, by stage
                w = results[2:]
                for j in np.argsort([-(t.t_search + t.t_fallback
                                       + t.t_refine) for t in w])[:3]:
                    t = w[j]
                    log(json.dumps({
                        "slow_tick": int(j), "run": r,
                        "search_ms": round(t.t_search * 1e3, 1),
                        "fallback_ms": round(t.t_fallback * 1e3, 1),
                        "refine_ms": round(t.t_refine * 1e3, 1),
                        "search_ok": t.search_ok,
                        "via_fallback": t.via_fallback,
                    }))
        at = np.asarray(warm)
        out.update({
            f"{name}_warm_tick_p50_ms": _ms(at, 50),
            f"{name}_warm_tick_p99_ms": _ms(at, 99),
            f"{name}_first_tick_s": round(float(np.mean(first)), 2),
            f"{name}_n_warm_ticks": len(at),
            f"{name}_runs_reached": reached,
            f"{name}_refined_ticks": refined,
        })
        if name == "kino":
            out["kino_fallback_ticks"] = fallbacks
            log(json.dumps(out))
    out["device"] = common.card(dev)
    return out


def main(argv) -> None:
    n_runs = int(argv[0]) if len(argv) > 0 else 2
    kino_beam = int(argv[1]) if len(argv) > 1 else 64
    device = argv[2] if len(argv) > 2 else "cuda"
    print(json.dumps(measure(n_runs, kino_beam, device)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
