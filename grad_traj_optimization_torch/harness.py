"""Benchmark/evaluation harness (port of
``grad_traj_optimization_tpu.harness``).

Rebuild of the reference's compare2/compare22 measurement flow
(src/compare2.cpp:85-342): front-end search and back-end optimization
over a stream of (map, start, goal) cases, logging per case
``solve_time, traj_time, acc_cost`` plus jerk and the monotone
cost-vs-iteration curve (reference getCostCurve,
grad_traj_optimizer.cpp:438-447).  Results are structured records
(optionally JSON lines) and, with :func:`write_compare2_logs`, the
reference's own front2.txt/back2.txt lines.

Each case runs on the device of its field (``_device``: a numpy field
goes to the card).  The front end is ``search.grid_search.plan``; the
back end is one K3 launch per solve (``solver.solve``), or one for a
whole suite (:func:`run_suite_batched`).  Every clock read is preceded by
a stream synchronise, so the times cover the device's work, not its
enqueue.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from grad_traj_optimization_torch import _device
from grad_traj_optimization_torch import solver as solve_mod
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.core import poly
from grad_traj_optimization_torch.search import grid_search, rdp


@dataclasses.dataclass
class CaseRecord:
    """One benchmark case (compare2.cpp logs :219-231, 296-321)."""

    case_id: int
    frontend_time_s: float      # search wall time ('time in search')
    backend_time_s: float       # optimization wall time
    traj_time_s: float          # trajectory duration sum(T)
    traj_length_m: float
    acc_cost: float             # front-end metric (polynomial_traj:94-106)
    jerk: float                 # back-end metric (polynomial_traj:108-138)
    cost_curve: list            # monotone best-cost envelope
    status: int
    frontend_ok: bool = True    # a search connected start to goal
    via_fallback: bool = False  # grid search failed; exact host A* used

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["cost_curve"] = [round(float(x), 6) for x in self.cost_curve]
        return json.dumps(d)


def _clock(dev: torch.device) -> float:
    """Host seconds, after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _search_front(dist_grid, origin, resolution, start, goal, clearance):
    """Front-end search with exact-host-A* fallback.

    Runs the wavefront search (grid_search.plan); when it reports no
    connection (e.g. the clearance threshold seals a gap the kinodynamic
    expansion could thread), retries with the exact host kinodynamic A*
    (native.kino_search, the faithful reference algorithm,
    kinodynamic_astar.cpp:17-315) instead of optimizing a garbage
    polyline.  The retry builds the native engine (``native.load``) and
    raises without a compiler; it runs only when the grid search fails.
    Returns (path (N,3), t_front_s, ok, via_fallback).
    """
    dev = dist_grid.device
    t0 = _clock(dev)
    plan = grid_search.plan(dist_grid, origin, resolution, np.asarray(start),
                            np.asarray(goal), clearance=clearance)
    ok = bool(plan.reached)
    via_fallback = False
    path = plan.path[: max(int(plan.length), 2)].cpu().numpy()
    if not ok:
        from grad_traj_optimization_torch import native

        native.load()
        s6 = np.concatenate([np.asarray(start, np.float64), np.zeros(3)])
        g6 = np.concatenate([np.asarray(goal, np.float64), np.zeros(3)])
        fpos, _, _, _, freached = native.kino_search(
            dist_grid.cpu().numpy(), origin.cpu().numpy(),
            float(resolution), s6, g6, margin=clearance / 2.0,
        )
        if freached and len(fpos) >= 2:
            ok = via_fallback = True
            path = np.asarray(fpos, np.float64)
    t_front = _clock(dev) - t0
    if not ok:
        # both searches failed: degrade to the straight chord so the
        # record still carries a solve (status reports the truth)
        path = np.stack(
            [np.asarray(start, np.float64), np.asarray(goal, np.float64)]
        )
    return path, t_front, ok, via_fallback


def _resample_polyline(pts, n):
    """Arc-length resample a polyline to exactly n points (ends kept)."""
    pts = np.asarray(pts, np.float64)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    si = np.linspace(0.0, s[-1], n)
    return np.stack(
        [np.interp(si, s, pts[:, k]) for k in range(3)], axis=-1
    )


def _waypoints(path, rdp_epsilon, n_waypoints):
    """RDP waypoints of a front-end path (at least 3), arc-length
    resampled to ``n_waypoints`` unless it is None."""
    waypoints = rdp.simplify(path, rdp_epsilon)
    if len(waypoints) < 3:
        waypoints = np.stack(
            [path[0], 0.5 * (path[0] + path[-1]), path[-1]]
        )
    if n_waypoints is not None:
        waypoints = _resample_polyline(waypoints, n_waypoints)
    return waypoints


def _case(dist_grid, origin):
    """A case's field and origin as float32 tensors on the field's
    device."""
    dist_grid, dev = _device.field_device(dist_grid)
    return dist_grid.to(torch.float32), _device.on(origin, dev, "origin")


def _records(sols: solve_mod.Solution, ids, t_fronts, t_back, front_oks,
             fallbacks):
    """CaseRecords of a Solution with a leading lane axis: the metrics
    are computed batched on the device and downloaded once a field."""
    metrics = torch.stack([
        sols.T.sum(dim=-1), poly.length(sols.coeff, sols.T),
        poly.acc_cost(sols.coeff, sols.T), poly.jerk_cost(sols.coeff, sols.T),
    ], dim=-1).cpu().numpy()
    traces = sols.cost_trace.cpu().numpy()
    status = sols.status.cpu().numpy()
    return [
        CaseRecord(
            case_id=ids[i], frontend_time_s=t_fronts[i],
            backend_time_s=t_back, traj_time_s=float(metrics[i, 0]),
            traj_length_m=float(metrics[i, 1]),
            acc_cost=float(metrics[i, 2]), jerk=float(metrics[i, 3]),
            cost_curve=list(traces[i]), status=int(status[i]),
            frontend_ok=front_oks[i], via_fallback=fallbacks[i],
        )
        for i in range(len(ids))
    ]


def run_case(
    case_id,
    dist_grid,
    origin,
    resolution,
    start,
    goal,
    cfg: OptimizerConfig = OptimizerConfig(),
    rdp_epsilon: float = 0.4,
    clearance: float = 0.4,
    steps=(2,),
    n_waypoints: int | None = None,
    warm_compile: bool = False,
) -> CaseRecord:
    """Front-end (wavefront search + RDP waypoints) then back-end solve.

    ``n_waypoints``: resample the RDP polyline to a fixed waypoint count
    (the JAX package's way to reuse one compiled solve; here every solve
    is one K3 launch whatever the count).

    ``warm_compile``: run the solve once untimed first, so
    ``backend_time_s`` is warm execution only.  On the card the first
    solve of a process pays the kernels' first-use build (``_build``);
    use this when the cost curve's wall-time axis matters
    (write_compare2_logs).
    """
    dist_grid, origin = _case(dist_grid, origin)
    dev = dist_grid.device
    path, t_front, front_ok, via_fallback = _search_front(
        dist_grid, origin, resolution, start, goal, clearance
    )
    waypoints = _waypoints(path, rdp_epsilon, n_waypoints)
    f32 = dict(dtype=torch.float32, device=dev)
    scn = solve_mod.Scenario(
        dist=dist_grid, origin=origin,
        resolution=torch.as_tensor(resolution, **f32),
        waypoints=torch.as_tensor(waypoints, **f32),
    )
    if warm_compile:
        solve_mod.solve(scn, cfg=cfg, steps=steps)
    t0 = _clock(dev)
    sol = solve_mod.solve(scn, cfg=cfg, steps=steps)
    t_back = _clock(dev) - t0
    return _records(solve_mod.Solution(*(x[None] for x in sol)), [case_id],
                    [t_front], t_back, [front_ok], [via_fallback])[0]


def run_case_rrt(
    case_id,
    dist_grid,
    origin,
    resolution,
    start,
    goal,
    cfg: OptimizerConfig = OptimizerConfig(),
    rdp_epsilon: float = 0.4,
    rrt_iters: int = 2000,
    seed: int = 0,
    steps=(2,),
    min_bos: float = 0.3,
) -> CaseRecord:
    """RRT* front-end with corridor-bounded back-end refinement.

    The reference pipeline this rebuilds: rrtPathFinder produces
    waypoints + per-node safe-ball radii (path_finder.cpp:806-887);
    the corridor drives the optimizer's per-waypoint position bounds
    (penalty.bounds ``bos``) instead of the scalar ``cfg.bos``, so the
    refined trajectory's interior waypoints stay in the safe tube the
    search certified.  The tree grows on the host from the field's host
    copy; the solve runs on the field's device.  Raises if the RRT*
    cannot reach the goal (sampling search has no meaningful partial
    result to refine).
    """
    from grad_traj_optimization_torch.search import rrt

    dist_grid, origin = _case(dist_grid, origin)
    dev = dist_grid.device
    t0 = _clock(dev)
    res_rrt = rrt.plan(
        dist_grid.cpu().numpy(), origin.cpu().numpy(), float(resolution),
        np.asarray(start, np.float64), np.asarray(goal, np.float64),
        max_iters=rrt_iters, seed=seed,
    )
    if not res_rrt.reached:
        raise RuntimeError(
            f"RRT* failed to reach the goal in {rrt_iters} iterations"
        )
    waypoints, bos_wp = rrt.corridor_waypoints(
        res_rrt, rdp_epsilon, min_bos=min_bos
    )
    t_front = _clock(dev) - t0

    f32 = dict(dtype=torch.float32, device=dev)
    scn = solve_mod.Scenario(
        dist=dist_grid, origin=origin,
        resolution=torch.as_tensor(resolution, **f32),
        waypoints=torch.as_tensor(waypoints, **f32),
    )
    t0 = _clock(dev)
    sol = solve_mod.solve(scn, cfg=cfg, steps=steps,
                          bos_wp=torch.as_tensor(bos_wp, **f32))
    t_back = _clock(dev) - t0
    return _records(solve_mod.Solution(*(x[None] for x in sol)), [case_id],
                    [t_front], t_back, [True], [False])[0]


def run_suite_batched(
    cases,
    cfg: OptimizerConfig = OptimizerConfig(),
    rdp_epsilon: float = 0.4,
    clearance: float = 0.4,
    steps=(2,),
    n_waypoints: int = 6,
    out_path: str | None = None,
):
    """Run a suite with ONE batched back-end solve.

    The per-case front-end (wavefront + RDP) stays a host loop, but all
    back-end refinements stack into a single ``solve_batch``, one K3
    launch.  Cases must share one grid shape and device; RDP waypoints
    are arc-length resampled to ``n_waypoints`` so the batch is
    rectangular.  ``backend_time_s`` in each record is the batch wall
    time amortized per case (the honest per-case number for a
    throughput-oriented deployment; use :func:`run_case` for isolated
    latencies).
    """
    t_fronts, wps, dists, origins, ress = [], [], [], [], []
    front_oks, fallbacks = [], []
    for dist_grid, origin, resolution, start, goal in cases:
        dist_grid, origin = _case(dist_grid, origin)
        path, t_front, front_ok, via_fallback = _search_front(
            dist_grid, origin, resolution, start, goal, clearance
        )
        t_fronts.append(t_front)
        front_oks.append(front_ok)
        fallbacks.append(via_fallback)
        wps.append(_waypoints(path, rdp_epsilon, n_waypoints))
        dists.append(dist_grid)
        origins.append(origin)
        ress.append(float(resolution))

    dev = dists[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    batch = solve_mod.Scenario(
        dist=torch.stack(dists), origin=torch.stack(origins),
        resolution=torch.as_tensor(np.asarray(ress), **f32),
        waypoints=torch.as_tensor(np.stack(wps), **f32),
    )
    t0 = _clock(dev)
    sols = solve_mod.solve_batch(batch, cfg=cfg, steps=steps)
    t_back = (_clock(dev) - t0) / max(len(cases), 1)

    records = _records(sols, list(range(len(cases))), t_fronts, t_back,
                       front_oks, fallbacks)
    if out_path:
        for rec in records:
            with open(out_path, "a") as f:
                f.write(rec.to_json() + "\n")
    return records


def run_suite(cases, out_path: str | None = None, **kwargs):
    """Run a list of (dist, origin, resolution, start, goal) cases.

    Returns the records; optionally appends JSON lines to ``out_path``
    (the structured replacement for compare2's front2.txt/back2.txt).
    """
    records = []
    for i, (dist, origin, res, start, goal) in enumerate(cases):
        rec = run_case(i, dist, origin, res, start, goal, **kwargs)
        records.append(rec)
        if out_path:
            with open(out_path, "a") as f:
                f.write(rec.to_json() + "\n")
    return records


def summarize(records):
    """Aggregate statistics across a suite."""
    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    fe = [r.frontend_time_s for r in records]
    be = [r.backend_time_s for r in records]
    return {
        "n_cases": len(records),
        "n_ok": sum(1 for r in records if r.status == 0),
        "n_frontend_ok": sum(1 for r in records if r.frontend_ok),
        "n_via_fallback": sum(1 for r in records if r.via_fallback),
        "frontend_p50_ms": pct(fe, 50) * 1e3,
        "frontend_p95_ms": pct(fe, 95) * 1e3,
        "backend_p50_ms": pct(be, 50) * 1e3,
        "backend_p95_ms": pct(be, 95) * 1e3,
        "mean_jerk": float(np.mean([r.jerk for r in records])),
        "mean_acc_cost": float(np.mean([r.acc_cost for r in records])),
        "mean_traj_time_s": float(
            np.mean([r.traj_time_s for r in records])
        ),
    }


def write_compare2_logs(records, front_path: str, back_path: str):
    """Emit reference-format benchmark logs for drop-in comparison.

    Replicates the exact line formats of compare2.cpp:
      front2.txt (:215-231):
        ``test2:<n>solve_time:<s>,traj_time:<s>,acc_cost:<c>``
      back2.txt (:296-321):
        ``test2:<n>,jerk:<j>,time:<t0>;<t1>;...,cost:<c0>;<c1>;...``
    where the cost curve is the monotone best-cost envelope per iteration.
    The reference records per-NLopt-callback wall times; here every
    iteration of the fixed-budget descent executes identical work (one
    fused cost+gradient evaluation), so the wall axis is the measured
    solve wall time divided uniformly per iteration.  For time-to-quality
    comparisons against C++ logs, run the cases with
    ``run_case(..., warm_compile=True)`` so the measured time excludes
    the kernels' first-use build.
    """
    with open(front_path, "a") as f:
        for r in records:
            f.write(
                f"test2:{r.case_id + 1}solve_time:{r.frontend_time_s}"
                f",traj_time:{r.traj_time_s},acc_cost:{r.acc_cost}\n"
            )
    with open(back_path, "a") as f:
        for r in records:
            n = max(len(r.cost_curve), 1)
            dt = r.backend_time_s / n
            times = ";".join(str((i + 1) * dt) for i in range(n))
            costs = ";".join(str(float(c)) for c in r.cost_curve)
            f.write(
                f"test2:{r.case_id + 1},jerk:{r.jerk}"
                f",time:{times},cost:{costs}\n"
            )
