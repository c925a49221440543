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
   under each stretch, keep the per-lane winner), one K3 launch per arm.

Not ported: the exact host A* fallback rung (``host_fallback=True``
raises NotImplementedError; see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from grad_traj_optimization_torch import solver as solve_mod
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.search import kinodynamic


@dataclasses.dataclass(frozen=True)
class PlanBatchResult:
    solution: solve_mod.Solution    # per-lane winner of the race
    search: kinodynamic.KinoResult  # merged (retry-included) search
    reached: np.ndarray             # (B,) search reached the goal
    ok: np.ndarray                  # (B,) reached AND refine converged
    n_retried: int                  # lanes re-searched by the ladder
    arm: np.ndarray | None          # (B,) 0 = base beam, 1 = long-tau
    n_host_fallback: int = 0        # lanes recovered by the exact A*


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
    **search_kw,
) -> PlanBatchResult:
    """Plan a batch of missions end to end on the device of ``dists``.

    Arguments mirror :func:`kinodynamic.search_batch_adaptive` plus the
    refine knobs; ``stretches`` races seed durations per lane (``(1.0,)``
    disables the race); ``long_tau_arm`` adds a second search with 1 s
    primitives and keeps, per lane, the lower-cost refined arm (reached
    arms preferred).
    """
    if host_fallback:
        raise NotImplementedError(
            "host_fallback (the exact host A* rung: native.kino_search, "
            "replan._pad_knots_fixed) is not ported yet; see ROADMAP.md"
        )
    dists = torch.as_tensor(dists)
    dev = dists.device
    B = np.shape(starts)[0]
    origins_b = torch.as_tensor(origins, dtype=torch.float32,
                                device=dev).expand(B, 3)
    ress = torch.full((B,), float(resolution), dtype=torch.float32,
                      device=dev)

    def run_arm(mt):
        r, n_re, _ = kinodynamic.search_batch_adaptive(
            dists, origins_b, resolution, starts, goals,
            obstacle_pred=obstacle_pred, start_times=start_times,
            beam=beam, max_iters=max_iters, retries=retries,
            max_tau=mt, **search_kw,
        )
        p, v, a, t = kinodynamic.resample_knots_batch(
            r.pos, r.vel, r.acc, r.times, n_waypoints
        )
        sol = solve_mod.solve_kino_batch_race(
            dists, origins_b, ress, p, v, a, t, stretches=stretches, cfg=cfg,
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
        arm = take.cpu().numpy().astype(np.int32)

    reached = r0.reached.cpu().numpy()
    ok = reached & (s0.status.cpu().numpy() == solve_mod.STATUS_OK)
    return PlanBatchResult(
        solution=s0, search=r0, reached=reached, ok=ok,
        n_retried=int(n_re), arm=arm,
    )
