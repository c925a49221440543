#!/usr/bin/env python3
"""MissionServer benchmark of the PyTorch port: Poisson full-mission
arrivals (the counterpart of ``scripts/mission_serve_bench.py``; no JAX).

Like ``serve_bench_torch.py``, but every request is a whole mission
(retry-ladder beam search and raced refine through
``pipeline.plan_batch``) on one shared bench map: the reference's
compare2 per-request flow (compare2.cpp:129-321) as a fleet service.  The
JAX script's setup: the 512 bench missions (``random_scenarios(512,
seed=42)``, each map's first and last waypoint at rest) against the first
bench field, ``MissionServer(dist[:1], max_batch=256, max_wait_ms=5.0)``,
every pow2 bucket warmed twice (once with reachable goals, once with an
unreachable one, so the retry rung runs once at each shape), arrivals
from ``default_rng(5)`` for 4 s a load.

Run from the repository root:

    python scripts/mission_serve_bench_torch.py [loads ...] [--max_batch=N] [--device=cpu]

Loads default to 100, 200 and 400 missions/s; the device to the card.
Prints one JSON line a load with the JAX script's keys, and
``generator_missions_per_s`` (the rate the generator managed to submit).
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

LOADS = (100.0, 200.0, 400.0)
DURATION = 4.0
MAX_BATCH = 256
N_MISSIONS = 512
#: a goal outside the map: every lane fails, so the retry rung runs
GOAL_BAD = np.array([60.0, 60.0, 60.0, 0.0, 0.0, 0.0], np.float32)


def setup(device="cuda", max_batch: int = MAX_BATCH, warm: bool = True,
          n_missions: int = N_MISSIONS):
    """(server, submit, missions): a ``MissionServer`` on ``device``,
    ``submit(i)`` (mission ``i % n_missions``; returns its Future) and
    the missions (dist (1, ...), origin, res, starts, goals; host
    starts and goals).  ``warm`` runs the two bursts a pow2 bucket."""
    from grad_traj_optimization_torch import serving
    from grad_traj_optimization_torch.config import OptimizerConfig

    dist, origins, res, starts, goals, _ = common.build_bench_batch(
        n_missions, device=device)
    starts, goals = starts.cpu().numpy(), goals.cpu().numpy()
    missions = (dist[:1], origins[0].cpu().numpy(), res, starts, goals)
    server = serving.MissionServer(
        missions[0], missions[1], res, cfg=OptimizerConfig(),
        max_batch=max_batch, max_wait_ms=5.0, device=dist.device)

    def submit(i, goal=None):
        k = i % n_missions
        return server.submit(starts[k], goals[k] if goal is None else goal)

    if warm:
        warm_buckets(submit, max_batch)
    return server, submit, missions


def warm_buckets(submit, max_batch: int = MAX_BATCH) -> None:
    """Two bursts of each pow2 size up to ``max_batch``: reachable goals,
    then the unreachable one (every lane retried).  Each burst is awaited
    before the next: back-to-back bursts would coalesce into one mixed
    batch of twice the bucket."""
    b = 1
    while b <= max_batch:
        for goal in (None, GOAL_BAD):
            for f in [submit(i, goal) for i in range(b)]:
                f.result(timeout=1800)
        b *= 2


def direct_ok(missions, n_req: int) -> int:
    """Missions ok among requests 0..n_req-1 by one direct
    ``plan_batch`` of every mission (the server's defaults)."""
    from grad_traj_optimization_torch import pipeline
    from grad_traj_optimization_torch.config import OptimizerConfig

    dist1, origin, res, starts, goals = missions
    ok = pipeline.plan_batch(dist1, origin, res, starts, goals,
                             cfg=OptimizerConfig()).ok
    return int(ok[np.arange(n_req) % len(ok)].sum())


def sweep(server, submit, loads, duration: float = DURATION):
    """One open-loop Poisson run a load (the server's stats reset before
    each); returns the JAX script's records, one a load."""
    from grad_traj_optimization_torch import serving

    rows = []
    for load in loads:
        server.stats = serving.ServerStats()
        outs, wall, t_sub = common.poisson_load(submit, load, duration)
        n_req = len(outs)
        s = server.stats.summary()
        rows.append({
            "offered_missions_per_s": load,
            "achieved_missions_per_s": round(n_req / wall, 1),
            "n_requests": n_req,
            "n_ok": sum(o["ok"] for o in outs),
            "mean_batch": round(s["mean_batch"], 1),
            "latency_ms_p50": round(s["total_ms_p50"], 1),
            "latency_ms_p99": round(s["total_ms_p99"], 1),
            "device_ms_p50": round(s["device_ms_p50"], 1),
            "generator_missions_per_s": round(n_req / t_sub, 1),
        })
    return rows


def main(argv) -> None:
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    loads = [float(a) for a in args] or list(LOADS)
    device = opts.get("device", "cuda")
    t0 = time.perf_counter()
    server, submit, _ = setup(device, int(opts.get("max_batch", MAX_BATCH)))
    print(f"# warmed buckets in {time.perf_counter() - t0:.1f}s on "
          f"{common.card(device)}", flush=True)
    try:
        for load in loads:
            print(json.dumps(sweep(server, submit, [load])[0]), flush=True)
    finally:
        server.shutdown()
    print("# done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
