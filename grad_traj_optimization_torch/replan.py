"""Receding-horizon replanning with moving obstacles (port of
``grad_traj_optimization_tpu.replan``).

Rebuild of the reference's dynamic-planning flow (src/compare22.cpp:
90-247): at each tick,

1. moving-obstacle predictions are refreshed from pose histories
   (search.predictor, reference obj_predictor.cpp);
2. a kinodynamic beam search runs from the current state toward the goal
   against the space-time distance oracle (search.kinodynamic, reference
   kinodynamic_astar.cpp:17-315), and on NO_PATH the exact host A*
   (``native.kino_search``) retries;
3. the knot states seed a Hermite trajectory refined by the penalty
   optimizer: ``solver.solve_kino_batch`` at B = 1, one K3 launch on
   CUDA tensors (reference setKinoPath + optimizeTrajectory,
   grad_traj_optimizer.cpp:35-65, 128-243);
4. the vehicle flies the refined trajectory for ``replan_dt`` seconds and
   the loop repeats from the reached state.

Host-side state (the vehicle state, flown times) stays numpy; tensors
live on the device of ``dist_grid`` (``device`` for numpy input, the
card unless the caller asks for the CPU).  :func:`replan_loop_rrt` flies
one persistent RRT* tree instead (path_finder.cpp).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from grad_traj_optimization_torch import native, solver
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.core import poly, qp
from grad_traj_optimization_torch.fields import dynamic, sdf
from grad_traj_optimization_torch.search import (
    kinodynamic, predictor, rdp, rrt,
)
from grad_traj_optimization_torch.utils import profiling


@dataclasses.dataclass
class ReplanConfig:
    replan_dt: float = 0.5        # seconds flown per tick
    horizon: float = 7.0          # kino search horizon [m]
    margin: float = 0.3           # collision margin for search
    max_vel: float = 3.0
    max_acc: float = 2.0
    goal_tol: float = 0.5
    max_ticks: int = 40
    kino_iters: int = 16
    kino_beam: int = 64
    n_waypoints: int = 6          # knots passed to the back-end
    # On beam NO_PATH, retry with the exact host kinodynamic A*
    # (native.kino_search, kinodynamic_astar.cpp:17-315) before hovering.
    # It validates against the static field only; ticks with moving
    # obstacles re-check dynamic clearance after refinement.
    fallback_exact: bool = True


@dataclasses.dataclass
class TickResult:
    state: np.ndarray             # (6,) state after flying replan_dt
    coeff: np.ndarray             # refined segment coefficients
    times: np.ndarray
    reached_goal: bool
    search_ok: bool
    min_clearance: float
    via_fallback: bool = False    # beam failed; exact host A* seeded
    # per-stage host seconds, each including its device work; in
    # replan_loop the durations of its spans replan.search/fallback/refine
    t_search: float = 0.0         # beam search or RRT* tree work
    t_fallback: float = 0.0       # exact host A* when the beam failed
    t_refine: float = 0.0         # resample + penalty refine + fly


def _f32(x, dev):
    return profiling.to_device(np.array(x, np.float32), "replan.inputs", dev)


def _refine(dist_grid, origin, resolution, pos, vel, acc, times,
            cfg: OptimizerConfig, bos_wp=None, steps=(2,)):
    """setKinoPath + optimizeTrajectory at B = 1: one K3 launch on CUDA
    tensors, the plain loop on CPU tensors.  Unlike the JAX package's
    plain ``_refine_kino``, ``solve_kino_batch`` falls back to the seed if
    the descent diverges.  Returns (coeff (m, 3, 6), T (m,))."""
    res = resolution.reshape(1)
    sol = solver.solve_kino_batch(
        dist_grid[None], origin[None], res, pos[None], vel[None], acc[None],
        times[None], cfg=cfg, steps=steps,
        bos_wp=None if bos_wp is None else bos_wp[None],
    )
    return sol.coeff[0], sol.T[0]


def _fly_tick(coeff, T, t_fly: float, dist_grid, origin, resolution):
    """State after flying ``t_fly`` and the static nearest-cell clearance
    of the whole refined trajectory (100 uniform samples)."""
    t = torch.full((1,), t_fly, dtype=T.dtype, device=T.device)
    p, v, a = (poly.evaluate(coeff, T, t, deriv=k)[0] for k in range(3))
    samples, sample_ts = poly.sample_uniform(coeff, T, 100)
    dmin = torch.amin(sdf.distance_at(dist_grid, origin, resolution,
                                      samples))
    return p, v, a, samples, sample_ts, dmin


def _clearance_dynamic(dist_grid, origin, resolution, samples, ts, pred):
    """Space-time clearance: sample i at ITS planned flight time ts[i]
    (absolute), so a box crossing the path between ticks is caught at the
    sample it threatens."""
    return torch.amin(dynamic.evaluate_coarse(dist_grid, origin, resolution,
                                              samples, ts, pred))


def _resample_knots(pos, vel, acc, times, n: int):
    """Downsample a search branch's knots to n (keeping ends).

    Zero-duration segments are the beam's masked post-termination tail
    (see kinodynamic.search early-termination tracking) — dropped here
    along with their duplicate knots.
    """
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    acc = np.asarray(acc, np.float64)
    times = np.asarray(times, np.float64)
    # the masked dupes are rotated to the FRONT (kinodynamic.search), so
    # the real branch starts at the first kept segment's start knot
    seg_keep = times > 1e-6
    j0 = int(np.argmax(seg_keep)) if seg_keep.any() else 0
    knot_keep = np.zeros(len(pos), bool)
    knot_keep[j0] = True
    knot_keep[1:][seg_keep] = True
    pos, vel, acc = pos[knot_keep], vel[knot_keep], acc[knot_keep]
    times = times[seg_keep]
    k = len(pos)
    if k <= n:
        return pos, vel, acc, np.maximum(times, 1e-2)
    idx = np.unique(np.round(np.linspace(0, k - 1, n)).astype(int))
    seg_times = []
    for a, b in zip(idx[:-1], idx[1:]):
        seg_times.append(max(times[a:b].sum(), 1e-2))
    return pos[idx], vel[idx], acc[idx], np.array(seg_times)


def _pad_knots_fixed(pos, vel, acc, times, k_to: int = 48):
    """Normalize a variable-length knot branch to EXACTLY ``k_to``
    knots: downsample via :func:`_resample_knots` when longer, then
    front-pad with zero-duration duplicates of the first knot (the
    masked-dupe convention ``resample_knots_batch`` already drops)."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    acc = np.asarray(acc, np.float64)
    times = np.asarray(times, np.float64)
    if len(pos) > k_to:
        pos, vel, acc, times = _resample_knots(pos, vel, acc, times, k_to)
    m = k_to - len(pos)
    if m > 0:
        pos = np.concatenate([np.repeat(pos[:1], m, axis=0), pos])
        vel = np.concatenate([np.repeat(vel[:1], m, axis=0), vel])
        acc = np.concatenate([np.repeat(acc[:1], m, axis=0), acc])
        times = np.concatenate([np.zeros(m), times])
    return pos, vel, acc, times


def _grid_on(dist_grid, device):
    """The field as a float32 tensor: a tensor keeps its device, numpy
    input goes to ``device``."""
    if isinstance(dist_grid, torch.Tensor):
        return dist_grid.to(torch.float32)
    return torch.as_tensor(np.array(dist_grid, np.float32), device=device)


def _hold(state, dist_grid, origin, res):
    """The hover tick's coefficients and clearance at ``state``."""
    hold = np.zeros((1, 3, 6), np.float32)
    hold[0, :, 0] = state[:3]
    d = sdf.distance_at(dist_grid, origin, res,
                        _f32(state[None, :3], origin.device))[0]
    return hold, float(profiling.to_host(d, "replan.hold_clearance"))


def _new_grid(map_update, t_now, dist_grid):
    """Apply ``map_update(t, grid)``: the new field on the old one's
    device, or None for no change."""
    new_grid = map_update(t_now, dist_grid)
    if new_grid is None:
        return None
    if tuple(new_grid.shape) != tuple(dist_grid.shape):
        raise ValueError(
            "map_update must keep the grid shape "
            f"({tuple(new_grid.shape)} != {tuple(dist_grid.shape)})"
        )
    return _grid_on(new_grid, dist_grid.device)


def replan_loop(
    dist_grid,
    origin,
    resolution,
    start_state,
    goal,
    obstacle_histories=None,
    obstacle_times=None,
    obstacle_scales=None,
    obstacle_update: Callable | None = None,
    map_update: Callable | None = None,
    rcfg: ReplanConfig = ReplanConfig(),
    ocfg: OptimizerConfig = OptimizerConfig(),
    device="cuda",
):
    """Run the receding-horizon loop until the goal (or max_ticks).

    Args:
      dist_grid: (nx, ny, nz) field; a tensor keeps its device, numpy
        input goes to ``device``.
      start_state, goal: (6,) = [position, velocity].
      obstacle_update: optional ``f(t) -> (histories, times, scales)``
        refreshing pose histories each tick.
      map_update: optional ``f(t, dist_grid) -> dist_grid | None``
        applying static map changes each tick (same shape), e.g.
        ``sdf.edt_update(old, new_occ, res, lo, hi, mode="add")`` for
        appearing obstacles (exact for additions).
    Returns:
      list of TickResult.

    ``fallback_exact`` needs the native engine: the loop builds it before
    the first tick and raises if it cannot.

    Spans (``utils.profiling``): ``replan.tick`` around each pass of the
    loop, ``replan.search``, ``replan.fallback`` (the host A*) and
    ``replan.refine`` inside it.  ``TickResult.t_search``, ``t_fallback``
    and ``t_refine`` are those spans' durations; ``t_fallback`` is 0 on a
    tick where the host A* did not run.
    """
    start_state = np.asarray(start_state, np.float64)
    goal = np.asarray(goal, np.float64)
    if start_state.shape != (6,) or goal.shape != (6,):
        raise ValueError(
            "replan_loop expects start_state and goal as (6,) [p, v] "
            f"vectors; got {start_state.shape} and {goal.shape}"
        )
    if rcfg.fallback_exact:
        native.load()
    dist_grid = _grid_on(dist_grid, device)
    dev = dist_grid.device
    origin_t = _f32(origin, dev)
    res_t = torch.tensor(float(resolution), dtype=torch.float32, device=dev)
    origin_np = np.asarray(origin, np.float32)
    host_grid = (None, None)  # (tensor, its host copy) for the exact A*
    state = start_state.copy()
    t_now = 0.0
    results: list[TickResult] = []

    for _tick in range(rcfg.max_ticks):
        with profiling.span("replan.tick"):
            # 0. static map changes (walls appearing/vanishing mid-flight)
            if map_update is not None:
                new_grid = _new_grid(map_update, t_now, dist_grid)
                if new_grid is not None:
                    dist_grid = new_grid

            # 1. refresh predictions
            pred = None
            if obstacle_update is not None:
                oh, ot, osc = obstacle_update(t_now)
                pred = predictor.fit_const_vel(_f32(oh, dev), _f32(ot, dev),
                                               _f32(osc, dev))
            elif obstacle_histories is not None:
                pred = predictor.fit_const_vel(_f32(obstacle_histories, dev),
                                               _f32(obstacle_times, dev),
                                               _f32(obstacle_scales, dev))

            # horizon-clipped goal (reference horizon termination)
            to_goal = goal[:3] - state[:3]
            dist_goal = np.linalg.norm(to_goal)
            if dist_goal <= rcfg.goal_tol:
                break
            tgt = goal.copy()
            if dist_goal > rcfg.horizon:
                tgt[:3] = state[:3] + to_goal / dist_goal * rcfg.horizon
                tgt[3:] = 0.0

            # 2. kinodynamic search against the space-time oracle
            with profiling.span("replan.search") as sp_search:
                kres = kinodynamic.search(
                    dist_grid, origin_t, float(resolution), _f32(state, dev),
                    _f32(tgt, dev), obstacle_pred=pred, start_time=t_now,
                    max_acc=rcfg.max_acc, max_vel=rcfg.max_vel,
                    margin=rcfg.margin, max_iters=rcfg.kino_iters,
                    beam=rcfg.kino_beam,
                )
                search_ok = bool(profiling.to_host(kres.reached,
                                                   "replan.reached"))
            t_search, t_fallback = sp_search.seconds, 0.0
            via_fallback = False
            knots = (kres.pos, kres.vel, kres.acc, kres.times)

            if not search_ok and rcfg.fallback_exact:
                # the beam is a fixed-iteration approximation and can miss
                # narrow passages the exact search threads
                with profiling.span("replan.fallback") as sp_fallback:
                    if host_grid[0] is not dist_grid:
                        host_grid = (dist_grid, profiling.to_host(
                            dist_grid, "replan.fallback_field").numpy())
                    fpos, fvel, facc, ftimes, freached = native.kino_search(
                        host_grid[1], origin_np, float(resolution), state,
                        tgt, max_acc=rcfg.max_acc, max_vel=rcfg.max_vel,
                        margin=rcfg.margin,
                    )
                    if freached and len(ftimes) >= 1:
                        search_ok = True
                        via_fallback = True
                        knots = tuple(_f32(k, dev) for k in _pad_knots_fixed(
                            fpos, fvel, facc, ftimes, k_to=48))
                t_fallback = sp_fallback.seconds

            if not search_ok:
                # NO_PATH this tick (kinodynamic_astar.cpp:278-313): hold
                # position (quadrotors hover) and retry next tick
                state = np.concatenate([state[:3], np.zeros(3)])
                t_now += rcfg.replan_dt
                hold, dmin = _hold(state, dist_grid, origin_t, res_t)
                results.append(TickResult(
                    state=state.copy(), coeff=hold,
                    times=np.array([rcfg.replan_dt]), reached_goal=False,
                    search_ok=False, min_clearance=dmin, t_search=t_search,
                    t_fallback=t_fallback,
                ))
                continue

            with profiling.span("replan.refine") as sp_refine:
                # 3. refine: resample to n_waypoints knots, then one K3
                p6, v6, a6, t6 = kinodynamic.resample_knots_batch(
                    *(k.to(torch.float32)[None] for k in knots),
                    rcfg.n_waypoints)
                coeff, T = _refine(dist_grid, origin_t, res_t, p6[0], v6[0],
                                   a6[0], t6[0], ocfg)

                # 4. fly replan_dt along the refined trajectory
                t_fly = min(rcfg.replan_dt, float(profiling.to_host(
                    torch.sum(T), "replan.duration")))
                p, v, _a, samples, sample_ts, dmin_static = _fly_tick(
                    coeff, T, t_fly, dist_grid, origin_t, res_t)
                t_start = t_now  # trajectory local time 0 == tick's start
                t_now += t_fly
                if pred is not None:
                    dmin = _clearance_dynamic(
                        dist_grid, origin_t, res_t, samples,
                        t_start + sample_ts, pred)
                else:
                    dmin = dmin_static
                dmin = float(profiling.to_host(dmin, "replan.clearance"))
                state = profiling.to_host(torch.cat([p, v]).double(),
                                          "replan.state").numpy()

            results.append(TickResult(
                state=state.copy(),
                coeff=profiling.to_host(coeff, "replan.coeff").numpy(),
                times=profiling.to_host(T, "replan.times").numpy(),
                reached_goal=bool(
                    np.linalg.norm(goal[:3] - state[:3]) <= rcfg.goal_tol),
                search_ok=search_ok, min_clearance=dmin,
                via_fallback=via_fallback, t_search=t_search,
                t_fallback=t_fallback, t_refine=sp_refine.seconds,
            ))
            if results[-1].reached_goal:
                break
    return results


@dataclasses.dataclass
class RRTReplanConfig:
    replan_dt: float = 0.5        # seconds flown per tick
    goal_tol: float = 0.5
    max_ticks: int = 40
    init_iters: int = 2000        # first RRTpathFind budget
    grow_iters: int = 400         # per-tick refine budget (RRTpathRefine)
    repair_iters: int = 200       # treeRepair budget after a map change
    rdp_epsilon: float = 0.4
    min_bos: float = 0.3
    seed: int = 0
    backend: str = "python"       # "python" | "native" tree engine
    # Resample every tick's corridor to this fixed waypoint count; None
    # keeps the variable-count RDP corridor.
    n_waypoints: int | None = 6


def _resample_corridor(path, radii, n: int, min_bos: float):
    """Arc-length resample a safe-ball corridor to exactly n waypoints.

    Resampled points lie ON the corridor polyline, i.e. on chords
    between overlapping safe balls, so each is inside at least one of
    its bracketing balls; its bound half-width is the larger in-ball
    slack max_j (r_j - |p - c_j|) over the bracketing nodes, clamped
    at ``min_bos`` (the same floor the RDP corridor uses).
    """
    path = np.asarray(path, np.float64)
    radii = np.asarray(radii, np.float64)
    if len(path) < 2:
        path = np.concatenate([path, path[-1:] + 1e-6], axis=0)
        radii = np.concatenate([radii, radii[-1:]])
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    si = np.linspace(0.0, s[-1], n)
    pts = np.stack(
        [np.interp(si, s, path[:, k]) for k in range(3)], axis=-1
    )
    j = np.clip(np.searchsorted(s, si, side="right") - 1, 0,
                len(path) - 2)
    slack_a = radii[j] - np.linalg.norm(pts - path[j], axis=1)
    slack_b = radii[j + 1] - np.linalg.norm(pts - path[j + 1], axis=1)
    bos = np.maximum(np.maximum(slack_a, slack_b), min_bos)
    return pts, bos


def _corridor(res_rrt, state, rcfg: RRTReplanConfig):
    """The tick's refine corridor: the traced path minus what was flown
    past, from the vehicle's state, as waypoints and bound half-widths
    (at least three waypoints: a straight shot has no free derivatives)."""
    path_f, radii_f = rrt.trim_passed(res_rrt.path, res_rrt.radii,
                                      state[:3])
    path_c = np.concatenate([state[None, :3], path_f], axis=0)
    radii_c = np.concatenate([radii_f[:1], radii_f])
    if rcfg.n_waypoints:
        wps, bos_wp = _resample_corridor(path_c, radii_c, rcfg.n_waypoints,
                                         rcfg.min_bos)
    else:
        wps, idx = rdp.simplify(path_c, rcfg.rdp_epsilon, return_index=True)
        bos_wp = np.maximum(radii_c[idx], rcfg.min_bos)
        wps = np.asarray(wps, np.float64)
    if len(wps) == 2:
        # insert a certified interior point: the corridor node nearest
        # the chord midpoint (the midpoint itself may lie up to
        # rdp_epsilon off the certified path, possibly in an obstacle)
        mid = 0.5 * (wps[0] + wps[1])
        if len(path_c) > 2:
            j = 1 + int(np.argmin(
                np.linalg.norm(path_c[1:-1] - mid, axis=1)))
            wps = np.insert(wps, 1, path_c[j], axis=0)
            bos_wp = np.insert(bos_wp, 1,
                               max(float(radii_c[j]), rcfg.min_bos))
        else:
            # [state, end node]: the chord is not a certified tree edge,
            # so clamp the midpoint into the end node's safe ball
            r_end = float(radii_c[-1])
            dvec = mid - wps[1]
            dn = float(np.linalg.norm(dvec))
            if dn > 0.9 * r_end:
                mid = wps[1] + dvec * (0.9 * r_end / max(dn, 1e-12))
            wps = np.insert(wps, 1, mid, axis=0)
            bos_wp = np.insert(bos_wp, 1, min(bos_wp[0], bos_wp[1]))
    return wps, bos_wp


def replan_loop_rrt(
    dist_grid,
    origin,
    resolution,
    start,
    goal,
    map_update: Callable | None = None,
    rcfg: RRTReplanConfig = RRTReplanConfig(),
    ocfg: OptimizerConfig = OptimizerConfig(),
    steps=(2,),
    device="cuda",
):
    """Receding-horizon flight on ONE persistent RRT* tree.

    The reference's RRT flight loop (path_finder.cpp): per tick the tree
    is refined (RRTpathFind :713-804), map changes repair it in place
    (RRTpathReEvaluate/ReConnect/treeRepair :1065-1554), the traced
    corridor (tracePath/getPath :806-887) is refined with per-waypoint
    safe-ball bounds (one K3 launch, ``bos_wp``), the vehicle flies
    ``replan_dt`` and the flown-past part of the tree is committed away
    (resetRoot/costRecast :302-375).

    ``start``/``goal`` are (3,) positions; ``map_update`` has
    :func:`replan_loop`'s contract.  ``rcfg.backend`` picks the tree:
    ``"python"`` (search.rrt.RRTPlanner) or ``"native"``
    (native.NativeRRTPlanner).  A tick whose tree has no path after
    repair and regrowth hovers (search_ok=False).  ``ocfg.auto_crop`` is
    ignored: the port has no crop.
    """
    start = np.asarray(start, np.float64).reshape(3)
    goal = np.asarray(goal, np.float64).reshape(3)
    if rcfg.backend == "native":
        planner_cls = native.NativeRRTPlanner
    elif rcfg.backend == "python":
        planner_cls = rrt.RRTPlanner
    else:
        raise ValueError(f"unknown rrt backend {rcfg.backend!r}")
    dist_grid = _grid_on(dist_grid, device)
    dev = dist_grid.device
    origin_t = _f32(origin, dev)
    res_t = torch.tensor(float(resolution), dtype=torch.float32, device=dev)
    planner = planner_cls(
        dist_grid.cpu().numpy(), np.asarray(origin, np.float32),
        float(resolution), start=start, goal=goal, seed=rcfg.seed,
    )
    planner.grow(rcfg.init_iters)

    state = np.concatenate([start, np.zeros(3)])
    state_acc = np.zeros(3)
    t_now = 0.0
    results: list[TickResult] = []

    for _tick in range(rcfg.max_ticks):
        if np.linalg.norm(goal - state[:3]) <= rcfg.goal_tol:
            break

        # 0. map changes repair the tree in place (rcvAddMap/rcvDelMap)
        if map_update is not None:
            new_grid = _new_grid(map_update, t_now, dist_grid)
            if new_grid is not None:
                dist_grid = new_grid
                planner.update_map(dist_grid.cpu().numpy(),
                                   repair_iters=rcfg.repair_iters)

        # 1. refine the tree; hover if the path was lost
        t_s0 = time.perf_counter()
        planner.grow(rcfg.grow_iters)
        if not np.isfinite(planner.best_cost):
            state[3:] = 0.0  # reference NO_PATH semantics
            state_acc[:] = 0.0
            t_now += rcfg.replan_dt
            hold, dmin = _hold(state, dist_grid, origin_t, res_t)
            results.append(TickResult(
                state=state.copy(), coeff=hold,
                times=np.array([rcfg.replan_dt]), reached_goal=False,
                search_ok=False, min_clearance=dmin,
                t_search=time.perf_counter() - t_s0,
            ))
            continue

        # 2. the corridor, refined under safe-ball bounds; the start knot
        #    carries the flown velocity and acceleration (the reference's
        #    startVel/startAcc, qp_generator.cpp:12-16, 425-431), interior
        #    and goal knots are at rest
        wps, bos_wp = _corridor(planner.result(), state, rcfg)
        t_search = time.perf_counter() - t_s0
        t_r0 = time.perf_counter()
        n_k = len(wps)
        kvel = np.zeros((n_k, 3))
        kacc = np.zeros((n_k, 3))
        kvel[0] = state[3:]
        kacc[0] = state_acc
        wps_t = _f32(wps, dev)
        T_alloc = qp.allocate_times(wps_t, ocfg.mean_v, ocfg.init_time)
        coeff, T = _refine(dist_grid, origin_t, res_t, wps_t,
                           _f32(kvel, dev), _f32(kacc, dev), T_alloc, ocfg,
                           bos_wp=_f32(bos_wp, dev), steps=tuple(steps))

        # 3. fly replan_dt along the refined trajectory
        t_fly = min(rcfg.replan_dt, float(torch.sum(T)))
        p, v, a, _, _, dmin = _fly_tick(coeff, T, t_fly, dist_grid,
                                        origin_t, res_t)
        t_now += t_fly
        state = torch.cat([p, v]).double().cpu().numpy()
        state_acc = a.double().cpu().numpy()

        # 4. commit the flown-past tree (resetRoot); a failed commit only
        #    leaves the tree uncommitted.  Inside the end node's ball the
        #    reference flags commit_end and stops committing.
        if not planner.commit_end:
            planner.reset_root(state[:3])

        results.append(TickResult(
            state=state.copy(), coeff=coeff.cpu().numpy(),
            times=T.cpu().numpy(),
            reached_goal=bool(
                np.linalg.norm(goal - state[:3]) <= rcfg.goal_tol),
            search_ok=True, min_clearance=float(dmin), t_search=t_search,
            t_refine=time.perf_counter() - t_r0,
        ))
        if results[-1].reached_goal:
            break
    return results
