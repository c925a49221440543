#!/usr/bin/env python3
"""Beam-vs-exact front-end quality suite of the PyTorch port (the
counterpart of ``scripts/beam_vs_exact.py``; no JAX).

The batched beam search (``search/kinodynamic.py``) stands in for the
reference's sequential kinodynamic A* (kinodynamic_astar.cpp:17-315) and
hybrid A* (hybrid_astar.cpp:219-446).  The parity gate (SURVEY.md section
7) is on the final optimized trajectory: on random pillar + gap-wall
maps, the success rate of the exact host search (``native.kino_search``
or ``native.hybrid_search``, the port's copy of the JAX package's host
engine) against the beam's, and, where both succeed, the ratios (beam /
exact) of the back-end-refined penalty objective, the trajectory time and
its jerk.

It differs from the JAX script in how the work is batched, not in what is
measured: the cases are drawn on ``device`` (``fixtures.random_search_case``
with the JAX script's rng), the beam runs once over all of them
(``search_batch_ladder``: ``search_batch_adaptive``'s batched retry
ladder, with each lane's rounds), and each refine arm is batched: the JAX
script's own seed (``replan._resample_knots``: at most 6 of the search's
knots) -> ``retime_knots`` -> ``solve_kino_batch`` over the lanes of one
knot count (one K3 launch a count and arm on the card), where the JAX
script refines case by case with ``descent.minimize``.
(``resample_knots_batch``, the pipeline's Hermite resample, gives each
knot the interpolant's acceleration, not the search's, and moves the
ratios away from the JAX script's: not used here.)

Run from the repository root:

    python scripts/beam_vs_exact_torch.py [n_cases] [device] [--md=PATH]

Defaults: 100 cases, the card.  Runs the JAX script's three suites (the
kino arm; the hybrid arm; the hybrid arm with ``shot_mode=1``), each with
``retime="race:search,stretch:1.2"`` and ``retries=2``, prints one JSON
line a suite, and writes a markdown table only to the ``--md`` path.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import _bench_common_torch as common  # noqa: E402

#: the JAX script's main: the three suites, as (exact arm, shot_mode)
SUITES = (("kino", 0), ("hybrid", 0), ("hybrid", 1))
SUITE_KW = dict(retime="race:search,stretch:1.2", retries=2)
REFINE_ITERS = 40


def draw_cases(n_cases: int, seed: int, device):
    """The JAX script's case draws: ``n_cases`` attempts of
    ``random_search_case`` from ``default_rng(seed)``, degenerate maps
    skipped.  Returns (case indices, fields (B, nx, ny, nz) on ``device``,
    origins (B, 3), resolution, starts (B, 6), goals (B, 6)); states
    float64 numpy."""
    from grad_traj_optimization_torch import fixtures

    rng = np.random.default_rng(seed)
    idx, cases = [], []
    for case in range(n_cases):
        c = fixtures.random_search_case(rng, device=device)
        if c is not None:
            idx.append(case)
            cases.append(c)
    z = np.zeros(3)
    return (idx, torch.stack([c[0] for c in cases]),
            np.stack([c[1] for c in cases]), cases[0][2],
            np.stack([np.concatenate([c[3], z]) for c in cases]),
            np.stack([np.concatenate([c[4], z]) for c in cases]))


def exact_paths(dists_host, origins, res, starts, goals, exact, margin,
                shot_mode):
    """The exact host oracle on every case: a list of (pos, vel, acc,
    times, ok), the JAX script's calls."""
    from grad_traj_optimization_torch import native

    out = []
    for d, o, s6, g6 in zip(dists_host, origins, starts, goals):
        if exact == "hybrid":
            ph = native.hybrid_search(d, o, res, s6, g6, margin=margin,
                                      max_vel=3.0, max_acc=2.0,
                                      shot_mode=shot_mode)
            ok = ph[4] == native.HYBRID_REACH_END and len(ph[3]) >= 1
            out.append((*ph[:4], ok))
        else:
            out.append(native.kino_search(d, o, res, s6, g6, margin=margin,
                                          max_vel=3.0, max_acc=2.0,
                                          max_tau=0.5, goal_r=1e9))
    return out


def seed_knots(paths):
    """Each (pos, vel, acc, times) path's refine seed: the JAX
    ``refine_cost``'s own resample (``replan._resample_knots``: the
    masked zero-duration knots dropped, then at most 6 of the search's
    knots kept, with their velocities and accelerations)."""
    from grad_traj_optimization_torch import replan

    return [replan._resample_knots(*(np.asarray(x, np.float64)
                                     for x in p[:4]), 6) for p in paths]


def refine(dists, origins, res, knots, cfg, arm="search"):
    """Seed -> one retime arm -> penalty refinement of every lane:
    (final step-2 cost, trajectory time, jerk), each (B,) float64 numpy,
    and the (K3, K2) launches it made.  ``knots`` holds each lane's
    :func:`seed_knots`; lanes of one knot count are refined together by
    one ``solve_kino_batch`` (one K3 launch on the card).  A seed of two
    knots has no free derivative to refine (``descent.minimize`` leaves
    it as it is, and K3 takes none): its cost is the penalty at the
    seed, ``penalty.cost_and_grad_batch`` (one K2 lookup).  ``arm`` is a
    ``retime`` mode, ``"stretch:1.2"`` with its argument."""
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.core import poly, qp
    from grad_traj_optimization_torch.opt import penalty
    from grad_traj_optimization_torch.search import kinodynamic as kd

    dev = dists.device
    f32 = dict(dtype=torch.float32, device=dev)
    mode, _, sarg = arm.partition(":")
    kw = {"stretch": float(sarg)} if sarg else {}
    out = np.zeros((3, len(knots)))
    launches = [0, 0]
    groups = {}
    for i, k in enumerate(knots):
        groups.setdefault(len(k[0]), []).append(i)
    for n_knots, ids in groups.items():
        p, v, a = (torch.as_tensor(np.stack([knots[i][j] for i in ids]),
                                   **f32) for j in range(3))
        T = torch.as_tensor(np.stack([
            kd.retime_knots(knots[i][0], knots[i][1], knots[i][3],
                            mode=mode, **kw) for i in ids]), **f32)
        grids = dists[torch.as_tensor(ids, device=dev)]
        org = torch.as_tensor(origins[ids], **f32)
        ress = torch.full((len(ids),), float(res), **f32)
        if n_knots == 2:
            Df, dp = qp.kino_d(p, v, a)
            cost, _ = penalty.cost_and_grad_batch(
                dp, penalty.build_ctx_batch(T, Df, cfg), grids, org, ress,
                cfg, step=2)
            coeff = qp.coeff_from_d(Df, dp, T)
            launches[1] += 1
        else:
            sol = solver.solve_kino_batch(grids, org, ress, p, v, a, T,
                                          cfg=cfg, steps=(2,))
            cost, coeff = sol.cost, sol.coeff
            launches[0] += 1
        out[:, ids] = torch.stack([cost, T.sum(1), poly.jerk_cost(coeff, T)]
                                  ).double().cpu().numpy()
    return out[0], out[1], out[2], launches


def run_suite(n_cases: int, seed: int = 0, kino_iters: int = 30,
              beam: int = 64, margin: float = 0.2, verbose: bool = True,
              exact: str = "kino", beam_max_tau: float = 0.5,
              retime: str = "search", retries: int = 0,
              shot_mode: int = 0, search_kw: dict | None = None,
              device="cuda") -> dict:
    """The JAX ``run_suite``'s stats dict on ``device`` (its arguments
    but ``long_tau_arm``, which the JAX script's suites do not use).

    ``exact`` picks the host oracle: ``"kino"`` (compare22's front end)
    or ``"hybrid"`` (compare2's, setParameterAuto params; ``shot_mode=1``
    its free-end-vel one-shot).  ``retime`` is one arm or
    ``"race:a,b,..."`` (every arm refined, the lower cost kept a case);
    ``retries`` the beam's widening rounds.  ``n_retried`` is the JAX
    script's: each case's retry rounds, summed.  ``refine_launches`` (not
    in the JAX dict) counts :func:`refine`'s kernel launches on the card.
    """
    from grad_traj_optimization_torch.config import OptimizerConfig
    from grad_traj_optimization_torch.search import kinodynamic as kd

    dev = common.require(device)
    cfg = OptimizerConfig(iters_step2=REFINE_ITERS)
    idx, dists, origins, res, starts, goals = draw_cases(n_cases, seed, dev)
    pe = exact_paths(dists.cpu().numpy(), origins, res, starts, goals,
                     exact, margin, shot_mode)
    ok_e = np.array([bool(p[4]) for p in pe])
    f32 = dict(dtype=torch.float32, device=dev)
    kb, _, _, rounds = kd.search_batch_ladder(
        dists, torch.as_tensor(origins, **f32), res,
        torch.as_tensor(starts, **f32), torch.as_tensor(goals, **f32),
        margin=margin, max_vel=3.0, max_acc=2.0, max_iters=kino_iters,
        beam=beam, max_tau=beam_max_tau, retries=retries,
        **(search_kw or {}))
    ok_b = kb.reached.cpu().numpy()
    both = np.flatnonzero(ok_e & ok_b)
    ratios = {"cost": [], "time": [], "jerk": []}
    launches = np.zeros(2, int)
    if len(both):
        d_both = dists[torch.as_tensor(both, device=dev)]
        ce, te, je, n = refine(d_both, origins[both], res,
                               seed_knots([pe[i] for i in both]), cfg)
        launches += n
        beam_paths = zip(*(x.cpu().numpy()[both]
                           for x in (kb.pos, kb.vel, kb.acc, kb.times)))
        knots = seed_knots(list(beam_paths))
        arms = (retime[5:].split(",") if retime.startswith("race:")
                else [retime])
        cb = tb = jb = None
        for arm in arms:
            ca, ta, ja, n = refine(d_both, origins[both], res, knots, cfg,
                                   arm=arm)
            launches += n
            if cb is None:
                cb, tb, jb = ca, ta, ja
                continue
            take = ca < cb  # the JAX script's rule: a lower cost wins
            cb, tb, jb = (np.where(take, ca, cb), np.where(take, ta, tb),
                          np.where(take, ja, jb))
        ratios["cost"] = cb / np.maximum(ce, 1e-9)
        ratios["time"] = tb / np.maximum(te, 1e-9)
        ratios["jerk"] = jb / np.maximum(je, 1e-9)
    if verbose:
        pos_of = {int(b): j for j, b in enumerate(both)}
        for j, case in enumerate(idx):
            line = f"case {case}: exact={bool(ok_e[j])} beam={bool(ok_b[j])}"
            if j in pos_of:
                line += (f" cost_ratio={ratios['cost'][pos_of[j]]:.3f}"
                         f" time_ratio={ratios['time'][pos_of[j]]:.3f}")
            print(line, flush=True)

    def gm(xs):
        return (float(np.exp(np.mean(np.log(np.maximum(xs, 1e-9)))))
                if len(xs) else float("nan"))

    def p90(xs):
        return float(np.percentile(xs, 90)) if len(xs) else float("nan")

    return {
        "n_cases": len(idx),
        "exact_success": int(ok_e.sum()),
        "beam_success": int(ok_b.sum()),
        "both_success": len(both),
        "cost_ratio_geomean": gm(ratios["cost"]),
        "cost_ratio_p90": p90(ratios["cost"]),
        "time_ratio_geomean": gm(ratios["time"]),
        "jerk_ratio_geomean": gm(ratios["jerk"]),
        "kino_iters": kino_iters,
        "beam": beam,
        "beam_max_tau": beam_max_tau,
        "exact_arm": exact,
        "retime": retime,
        "retries": retries,
        "n_retried": int(rounds.sum()),
        "time_ratio_p90": p90(ratios["time"]),
        "refine_launches": {"K3": int(launches[0]), "K2": int(launches[1])},
    }


def markdown(suites, card: str) -> str:
    """The three stats dicts as markdown tables."""
    lines = ["# Beam-vs-exact front-end quality, PyTorch port", "",
             f"`scripts/beam_vs_exact_torch.py` on [{card}].", ""]
    for (exact, shot_mode), stats in suites:
        lines += [f"## vs {exact} A*" + (f" (shot_mode={shot_mode})"
                                         if shot_mode else ""), "",
                  "| metric | value |", "|---|---|"]
        lines += [f"| {k} | {v} |" for k, v in stats.items()] + [""]
    return "\n".join(lines)


def main(argv) -> None:
    args = [a for a in argv if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    n = int(args[0]) if args else 100
    device = args[1] if len(args) > 1 else "cuda"
    suites = []
    for exact, shot_mode in SUITES:
        stats = run_suite(n, exact=exact, shot_mode=shot_mode, verbose=False,
                          device=device, **SUITE_KW)
        suites.append(((exact, shot_mode), stats))
        print(json.dumps({"exact": exact, "shot_mode": shot_mode,
                          "stats": stats}), flush=True)
    if "md" in opts:
        with open(opts["md"], "w") as f:
            f.write(markdown(suites, common.card(device)) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
