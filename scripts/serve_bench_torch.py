#!/usr/bin/env python3
"""Serving benchmark of the PyTorch port: Poisson request arrivals
through ``serving.SolveServer`` (the counterpart of
``scripts/serve_bench.py``; no JAX).

Measures achieved throughput and end-to-end request latency (p50/p99) at
several offered loads, on the JAX script's setup: one shared bench-shaped
map (``random_scenarios(512, seed=11)``, scenario 0's field, 100 x 100 x
25 at 0.2 m) and the 512 draws' 7-waypoint sets as host (numpy) leaves,
so the server stacks them and uploads once a batch;
``SolveServer(max_batch=256, max_wait_ms=5.0)`` with every pow2 bucket
warmed; arrivals from ``default_rng(5)`` for 4 s a load.  The dispatch
loop self-regulates: while one batch is on the card the queue fills the
next, so batches grow with the load until ``max_batch`` caps them.

Run from the repository root:

    python scripts/serve_bench_torch.py [loads_req_per_s ...] [--max_batch=N] [--device=cpu]

Loads default to 100, 500, 1000, 1400 and 2000 requests/s; the device to
the card.  Prints one JSON line a load with the JAX script's keys, and
``generator_req_per_s``: the rate at which the generator (which shares
the interpreter with the server's dispatch thread) managed to submit.
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

import torch  # noqa: E402

import _bench_common_torch as common  # noqa: E402

LOADS = (100.0, 500.0, 1000.0, 1400.0, 2000.0)
DURATION = 4.0
MAX_BATCH = 256


def setup(device="cuda", max_batch: int = MAX_BATCH, warm: bool = True):
    """(server, submit): a ``SolveServer`` on ``device`` and ``submit(i)``,
    which submits request i (waypoint set ``i % 512`` on the shared map)
    and returns its Future.  ``warm`` fills every pow2 bucket once."""
    from grad_traj_optimization_torch import fixtures, serving, solver
    from grad_traj_optimization_torch.config import OptimizerConfig
    from grad_traj_optimization_torch.fields import sdf

    dev = common.require(device)
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        512, n_waypoints=7, seed=11, max_obstacle_points=4096)
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(map_cfg.origin, **f32)
    res = map_cfg.resolution
    occ = sdf.rasterize(torch.as_tensor(pts[0], **f32), origin, res,
                        map_cfg.grid_shape,
                        valid_mask=torch.as_tensor(valid[0], device=dev))
    dist = sdf.edt(occ, res)
    resolution = torch.as_tensor(res, **f32)
    wps_host = np.asarray(wps, np.float32)
    server = serving.SolveServer(cfg=OptimizerConfig(), max_batch=max_batch,
                                 max_wait_ms=5.0, device=dev)

    def submit(i):
        # the same field tensor in every request: shared-map batches
        return server.submit(solver.Scenario(
            dist=dist, origin=origin, resolution=resolution,
            waypoints=wps_host[i % len(wps_host)]))

    if warm:
        warm_buckets(submit, max_batch)
    return server, submit


def warm_buckets(submit, max_batch: int = MAX_BATCH) -> None:
    """One burst of each pow2 size up to ``max_batch``, each awaited, so
    that every bucket has been solved before a sweep."""
    b = 1
    while b <= max_batch:
        for f in [submit(i) for i in range(b)]:
            f.result(timeout=900)
        b *= 2


def sweep(server, submit, loads, duration: float = DURATION):
    """One open-loop Poisson run a load (``default_rng(5)`` gaps, the
    server's stats reset before each); returns a list of the JAX script's
    records, one a load, each with every request's result checked for
    status ok in ``n_status_ok``."""
    from grad_traj_optimization_torch import serving, solver

    rows = []
    for load in loads:
        server.stats = serving.ServerStats()
        outs, wall, t_sub = common.poisson_load(submit, load, duration)
        n_req = len(outs)
        s = server.stats.summary()
        rows.append({
            "offered_req_per_s": load,
            "achieved_req_per_s": round(n_req / wall, 1),
            "n_requests": n_req,
            "mean_batch": round(s["mean_batch"], 1),
            "latency_ms_p50": round(s["total_ms_p50"], 1),
            "latency_ms_p99": round(s["total_ms_p99"], 1),
            "queue_wait_ms_p50": round(s["wait_ms_p50"], 1),
            "assemble_ms_p50": round(s["assemble_ms_p50"], 1),
            "device_ms_p50": round(s["device_ms_p50"], 1),
            "solve_ms_p50": round(s["solve_ms_p50"], 1),
            "download_ms_p50": round(s["download_ms_p50"], 1),
            "pad_fraction": round(s["pad_fraction"], 3),
            "generator_req_per_s": round(n_req / t_sub, 1),
            "n_status_ok": sum(int(o.status) == solver.STATUS_OK
                               for o in outs),
        })
    return rows


def main(argv) -> None:
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    loads = [float(a) for a in args] or list(LOADS)
    t0 = time.perf_counter()
    server, submit = setup(opts.get("device", "cuda"),
                           int(opts.get("max_batch", MAX_BATCH)))
    print(f"# warmed pow2 buckets in {time.perf_counter() - t0:.1f}s on "
          f"{common.card(opts.get('device', 'cuda'))}", flush=True)
    try:
        for load in loads:
            print(json.dumps(sweep(server, submit, [load])[0]), flush=True)
    finally:
        server.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
