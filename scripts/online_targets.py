#!/usr/bin/env python3
"""The JAX package's counts on the CPU that ``chip_smoke.py`` phases 11,
13 and 14 hold the port to.

Run from the repository root (on a host with JAX; it imports nothing of
the port, and from ``chip_smoke.py`` only its numpy scenario helpers):

    python scripts/online_targets.py [ladder] [replan] [rrt]

* ``ladder``: ``pipeline.plan_batch(host_fallback=True)`` on the 1024
  bench missions (beam 64, 16 iterations, ``retries=1``, the JAX bench's
  call, bench.py:283-287) with ``lookup="gather"``, in chunks of 128
  lanes (every lane's search, rung and refine are its own): reached, ok
  and the lanes the rung recovered.
* ``replan``: ``replan.replan_loop`` on the opti_node map with
  ``ReplanConfig()`` and ``OptimizerConfig()``: static; with phase 13's
  boxes and wall (``sdf.edt_update(mode="add")`` at the third tick); and
  the exact-A* fallback run (``kino_iters=1, kino_beam=8``).  Ticks,
  reached flag and fallback ticks.
* ``rrt``: ``replan.replan_loop_rrt`` with the native tree on the same
  map.

Prints one JSON object a part.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from grad_traj_optimization_tpu import fixtures, pipeline, replan  # noqa: E402
from grad_traj_optimization_tpu.config import OptimizerConfig  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf  # noqa: E402

CHUNK = 128


def ladder():
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        cs.BATCH, n_waypoints=cs.N_WP, seed=cs.SEED,
        max_obstacle_points=4096)
    res = map_cfg.resolution
    origin = np.asarray(map_cfg.origin, np.float32)
    z = np.zeros((cs.BATCH, 3))
    starts = np.concatenate([wps[:, 0], z], 1).astype(np.float32)
    goals = np.concatenate([wps[:, -1], z], 1).astype(np.float32)
    out = dict(reached=0, ok=0, host_recovered=0)
    t0 = time.perf_counter()
    for c0 in range(0, cs.BATCH, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        occ = jax.vmap(lambda p, v: sdf.rasterize(
            p, jnp.asarray(origin), res, map_cfg.grid_shape,
            valid_mask=v))(jnp.asarray(pts[sl], jnp.float32),
                           jnp.asarray(valid[sl]))
        dist = sdf.edt_batch(occ, res, backend="jnp")
        r = pipeline.plan_batch(
            dist, np.broadcast_to(origin, (CHUNK, 3)), res, starts[sl],
            goals[sl], cfg=OptimizerConfig(), beam=64, max_iters=16,
            retries=1, host_fallback=True, lookup="gather")
        out["reached"] += int(r.reached.sum())
        out["ok"] += int(r.ok.sum())
        out["host_recovered"] += int(r.n_host_fallback)
        print(f"# lanes {c0}..{c0 + CHUNK}: {out} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return out


def opti_node():
    mc, obss, wp = fixtures.opti_node_scenario()
    occ = np.asarray(sdf.rasterize(
        jnp.asarray(obss, jnp.float32), jnp.asarray(mc.origin, jnp.float32),
        mc.resolution, mc.grid_shape))
    dist = np.asarray(sdf.edt(jnp.asarray(occ), mc.resolution,
                              backend="jnp"))
    return mc, occ, dist, wp


def summary(results):
    return dict(ticks=len(results), reached=bool(results[-1].reached_goal),
                fallback_ticks=sum(r.via_fallback for r in results),
                hover_ticks=sum(not r.search_ok for r in results),
                min_clearance=min(r.min_clearance for r in results))


def replan_runs():
    mc, occ, dist, wp = opti_node()
    res = mc.resolution
    start = np.concatenate([wp[0], np.zeros(3)])
    goal = np.concatenate([wp[-1], np.zeros(3)])
    occ1 = jnp.asarray(cs.wall_occupancy(occ))
    out = {}
    for name, kw in cs.REPLAN_RUNS.items():
        extra = {}
        if name == "dynamic":
            calls = []

            def map_update(t, grid):
                calls.append(t)
                if len(calls) - 1 != cs.WALL_TICK:
                    return None
                return sdf.edt_update(grid, occ1, res, cs.WALL_LO,
                                      cs.WALL_HI, mode="add")

            extra = dict(obstacle_update=cs.replan_boxes,
                         map_update=map_update)
        t0 = time.perf_counter()
        results = replan.replan_loop(
            dist, mc.origin, res, start, goal,
            rcfg=replan.ReplanConfig(**kw), ocfg=OptimizerConfig(), **extra)
        out[name] = summary(results)
        print(f"# {name}: {out[name]} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    return out


def rrt_run():
    mc, _, dist, wp = opti_node()
    results = replan.replan_loop_rrt(
        dist, mc.origin, mc.resolution, wp[0], wp[-1],
        rcfg=replan.RRTReplanConfig(backend="native"),
        ocfg=OptimizerConfig())
    return summary(results)


def main():
    parts = sys.argv[1:] or ["ladder", "replan", "rrt"]
    fns = {"ladder": ladder, "replan": replan_runs, "rrt": rrt_run}
    for p in parts:
        print(json.dumps({p: fns[p]()}), flush=True)


if __name__ == "__main__":
    main()
