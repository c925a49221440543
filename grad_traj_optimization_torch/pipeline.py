"""One-call batched planning pipeline: search -> seed -> raced refine
(port of ``grad_traj_optimization_tpu.pipeline``).

The composition of the framework's stages (the reference's compare2
two-stage flow, compare2.cpp:168-321, at batch scale):

1. :func:`search.kinodynamic.search_batch_adaptive`: batched beam search
   with the wider/deeper retry ladder over unreached lanes (optionally a
   second search arm with the hybrid A*'s 1 s primitives);
2. :func:`search.kinodynamic.resample_knots_batch`: exact cubic-Hermite
   resample to one fixed knot shape;
3. :func:`solver.solve_kino_batch_race`: the seed-duration race (refine
   under each stretch, keep the per-lane winner), one K3 launch per arm;
4. with ``host_fallback=True``, the exact host A* rung
   (:func:`_host_rung`) over the lanes the beam did not reach.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from grad_traj_optimization_torch import _device, native, replan
from grad_traj_optimization_torch import solver as solve_mod
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.search import kinodynamic
from grad_traj_optimization_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class PlanBatchResult:
    solution: solve_mod.Solution    # per-lane winner of the race
    search: kinodynamic.KinoResult  # merged (retry-included) search
    reached: np.ndarray             # (B,) search reached the goal
    ok: np.ndarray                  # (B,) reached AND refine converged
    n_retried: int                  # lanes re-searched by the ladder
    arm: np.ndarray | None          # (B,) 0 = base beam, 1 = long-tau
    n_host_fallback: int = 0        # lanes recovered by the exact A*
    #: the rung's host times in ms: the field's download, the host
    #: searches, and resample + race + scatter (empty without the rung)
    rung_ms: dict = dataclasses.field(default_factory=dict)


@profiling.traced("pipeline.plan_batch")
def plan_batch(
    dists,
    origins,
    resolution: float,
    starts,
    goals,
    obstacle_pred=None,
    start_times=None,
    cfg: OptimizerConfig = OptimizerConfig(),
    n_waypoints: int = 6,
    beam: int = 64,
    max_iters: int = 16,
    retries: int = 1,
    stretches: tuple[float, ...] = (1.0, 1.2),
    long_tau_arm: bool = False,
    max_tau: float = 0.5,
    host_fallback: bool = False,
    device=None,
    **search_kw,
) -> PlanBatchResult:
    """Plan a batch of missions end to end on the device of a tensor
    ``dists``; a numpy ``dists`` goes to ``device`` (the card unless asked
    otherwise), and a tensor argument on another device raises ValueError
    (``_device``).

    Arguments mirror :func:`kinodynamic.search_batch_adaptive` plus the
    refine knobs; ``stretches`` races seed durations per lane (``(1.0,)``
    disables the race); ``long_tau_arm`` adds a second search with 1 s
    primitives and keeps, per lane, the lower-cost refined arm (reached
    arms preferred).  ``host_fallback`` runs :func:`_host_rung` on the
    lanes still unreached; it needs the native engine (built here, or
    raising) and is skipped with ``obstacle_pred``, as in the JAX package:
    the exact A* sees the static field only.

    Spans (``utils.profiling``): ``pipeline.plan_batch`` around the call,
    ``pipeline.search`` (the search with its ladder), ``pipeline.refine``
    (resample and race) an arm, and ``pipeline.host_rung``.
    """
    if host_fallback:
        native.load()
    dists, dev = _device.field_device(dists, device)
    _device.check_on(dev, starts=starts, goals=goals,
                     obstacle_pred=obstacle_pred, start_times=start_times)
    B = np.shape(starts)[0]
    origins_b = _device.on(origins, dev, "origins").expand(B, 3)
    ress = torch.full((B,), float(resolution), dtype=torch.float32,
                      device=dev)

    def run_arm(mt):
        with profiling.span("pipeline.search"):
            r, n_re, _ = kinodynamic.search_batch_adaptive(
                dists, origins_b, resolution, starts, goals,
                obstacle_pred=obstacle_pred, start_times=start_times,
                beam=beam, max_iters=max_iters, retries=retries,
                max_tau=mt, **search_kw,
            )
        with profiling.span("pipeline.refine"):
            p, v, a, t = kinodynamic.resample_knots_batch(
                r.pos, r.vel, r.acc, r.times, n_waypoints
            )
            sol = solve_mod.solve_kino_batch_race(
                dists, origins_b, ress, p, v, a, t, stretches=stretches,
                cfg=cfg,
            )
        return r, sol, n_re

    r0, s0, n_re = run_arm(max_tau)
    arm = None
    if long_tau_arm and abs(max_tau - 1.0) > 1e-6:
        r1, s1, _ = run_arm(1.0)
        # per-lane winner: reached and finite-cost arms first, then lower
        # cost.  The keys stay NaN-free: an additive penalty (1e9 + NaN)
        # would make every comparison False and silently keep a broken
        # base arm over a good long-tau one
        big = torch.tensor(1e18, dtype=s0.cost.dtype, device=dev)
        b_key = torch.where(r0.reached & torch.isfinite(s0.cost), s0.cost,
                            big)
        l_key = torch.where(r1.reached & torch.isfinite(s1.cost), s1.cost,
                            big)
        take = l_key < b_key
        s0 = solve_mod._lane_select(take, s0, s1)
        # the arms' searches may differ in knot count: align first
        r0 = solve_mod._lane_select(
            take, *kinodynamic._align_knot_counts(r0, r1))
        arm = profiling.to_host(take, "pipeline.arm").numpy().astype(np.int32)

    reached = profiling.to_host(r0.reached, "pipeline.reached").numpy()
    n_host, rung_ms = 0, {}
    if host_fallback and obstacle_pred is None and not reached.all():
        with profiling.span("pipeline.host_rung"):
            s0, r0, n_host, rung_ms = _host_rung(
                dists, origins_b, ress, resolution, starts, goals, s0, r0,
                reached, cfg=cfg, n_waypoints=n_waypoints,
                stretches=stretches, max_tau=max_tau, search_kw=search_kw)
        reached = profiling.to_host(r0.reached, "pipeline.reached").numpy()
    status = profiling.to_host(s0.status, "pipeline.status").numpy()
    ok = reached & (status == solve_mod.STATUS_OK)
    return PlanBatchResult(
        solution=s0, search=r0, reached=reached, ok=ok,
        n_retried=int(n_re), arm=arm, n_host_fallback=n_host,
        rung_ms=rung_ms,
    )


def _host_rung(dists, origins_b, ress, resolution, starts, goals, s0, r0,
               reached, *, cfg, n_waypoints, stretches, max_tau, search_kw):
    """The ladder's last rung (kinodynamic_astar.cpp:17-315, exact): the
    native A* on each unreached lane, the recovered branches resampled and
    raced as one batch (one K3 launch per stretch), scattered back with
    the search cost set to inf (the failed beam's g-score does not
    describe the native branch).

    Only the unreached lanes' float32 fields come to the host, as they
    are: the engine thresholds them in double (``dist <= margin``,
    gtop_core.cpp:939), as on the JAX package's own f32 path, so no mask
    boundary arises.  Identical missions (a server's pad lanes) search
    once; the unique ones run on up to 8 threads (the ctypes call
    releases the GIL).  Returns (solution, search, n_recovered, ms).
    """
    dev = dists.device
    idx = np.where(~reached)[0]
    shared = dists.shape[0] == 1
    margin = float(search_kw.get("margin", 0.2))
    kino_kw = {k: v for k, v in search_kw.items()
               if k in ("max_acc", "max_vel", "w_time", "lambda_heu")}
    t0 = time.perf_counter()
    sel_d = dists if shared else dists[profiling.to_device(
        idx, "pipeline.rung_index", dev)]
    dist_host = profiling.to_host(sel_d.to(torch.float32),
                                  "pipeline.rung_field").numpy()
    ob = profiling.to_host(origins_b, "pipeline.rung_origins").numpy()
    s_host = profiling.to_host(torch.as_tensor(starts),
                               "pipeline.rung_starts").numpy()
    g_host = profiling.to_host(torch.as_tensor(goals),
                               "pipeline.rung_goals").numpy()
    K = int(r0.pos.shape[1])
    t1 = time.perf_counter()

    def host_search(j, i):
        fpos, fvel, facc, ftimes, f_ok = native.kino_search(
            dist_host[0] if shared else dist_host[j], ob[i],
            float(resolution), s_host[i].astype(np.float64),
            g_host[i].astype(np.float64), max_tau=max_tau, margin=margin,
            **kino_kw,
        )
        if f_ok and len(ftimes) >= 1:
            return replan._pad_knots_fixed(fpos, fvel, facc, ftimes, k_to=K)
        return None

    lane_key, uniq = {}, {}
    for j, i in enumerate(idx):
        mkey = (s_host[i].tobytes(), g_host[i].tobytes(),
                None if shared else int(i))
        lane_key[int(i)] = mkey
        uniq.setdefault(mkey, (j, i))
    n_workers = min(8, len(uniq), os.cpu_count() or 1)
    with ThreadPoolExecutor(n_workers) as ex:
        futs = {mk: ex.submit(host_search, j, i)
                for mk, (j, i) in uniq.items()}
        seen = {mk: f.result() for mk, f in futs.items()}
    rec_i = [i for i in idx if seen[lane_key[int(i)]] is not None]
    t2 = time.perf_counter()
    if rec_i:
        rec = [seen[lane_key[int(i)]] for i in rec_i]
        kp, kv, ka, kt = (
            profiling.to_device(
                np.stack([k[f] for k in rec]).astype(np.float32),
                "pipeline.rung_knots", dev)
            for f in range(4))
        sel = profiling.to_device(np.asarray(rec_i), "pipeline.rung_index",
                                  dev)
        p, v, a, t = kinodynamic.resample_knots_batch(kp, kv, ka, kt,
                                                      n_waypoints)
        s_f = solve_mod.solve_kino_batch_race(
            dists if shared else dists[sel], origins_b[sel], ress[sel],
            p, v, a, t, stretches=stretches, cfg=cfg,
        )

        def scatter(o, n):
            o = o.clone()
            o[sel] = n.to(o.dtype)
            return o

        s0 = solve_mod.Solution(*(scatter(o, n) for o, n in zip(s0, s_f)))
        r0 = kinodynamic.KinoResult(
            pos=scatter(r0.pos, kp), vel=scatter(r0.vel, kv),
            acc=scatter(r0.acc, ka), times=scatter(r0.times, kt),
            reached=scatter(r0.reached, torch.ones_like(sel, dtype=bool)),
            cost=scatter(r0.cost, torch.full(sel.shape, torch.inf,
                                             device=dev)),
        )
        # the refine's end, for its time
        profiling.to_host(s0.status, "pipeline.rung_status")
    t3 = time.perf_counter()
    ms = {"download": (t1 - t0) * 1e3, "search": (t2 - t1) * 1e3,
          "refine": (t3 - t2) * 1e3}
    return s0, r0, len(rec_i), ms
