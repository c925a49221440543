#!/usr/bin/env python3
"""The JAX package's compare2 results on the CPU that ``chip_smoke.py``
phase 15 holds the port to.

Run from the repository root, on a host with JAX (it imports nothing of
the port):

    python scripts/compare2_targets.py

* ``suite``: ``scripts/run_compare2_suite.py``'s 20 cases
  (``default_rng(11)``, ``random_search_case(n_pillars=(5, 10),
  gap_walls=None)``, 64x64x20 at 0.25 m) through ``harness.run_suite``
  and ``harness.run_suite_batched`` with ``COMPARE2_CONFIG`` and
  ``n_waypoints=6``: the summary counts and means, and each case's
  status, front-end flags and final cost (the last cost-curve value).
* ``fallback``: ``run_case`` on the tests' gap-wall map
  (tests/conftest.py:26, gap |x| < 0.8 m) at ``clearance=1.2``, where the
  grid search fails and the exact host A* retries
  (tests/test_replan_harness.py:324-354).
* ``rrt``: ``run_case_rrt`` on the off-centre gap map
  (tests/test_misc.py:221, :265).

Prints one JSON object a part.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from conftest import gap_wall_map  # noqa: E402
from grad_traj_optimization_tpu import fixtures, harness  # noqa: E402
from grad_traj_optimization_tpu.config import (  # noqa: E402
    COMPARE2_CONFIG, OptimizerConfig,
)

N_CASES = 20


def compare2_cases(n=N_CASES):
    rng = np.random.default_rng(11)
    cases = []
    while len(cases) < n:
        c = fixtures.random_search_case(rng, n_pillars=(5, 10),
                                        gap_walls=None)
        if c is not None:
            cases.append(c)
    return cases


def suite():
    cases = compare2_cases()
    out = {}
    for name, fn in (("run_suite", harness.run_suite),
                     ("run_suite_batched", harness.run_suite_batched)):
        recs = fn(cases, cfg=COMPARE2_CONFIG, n_waypoints=6)
        s = harness.summarize(recs)
        out[name] = {
            **{k: s[k] for k in ("n_ok", "n_frontend_ok", "n_via_fallback",
                                 "mean_jerk", "mean_acc_cost",
                                 "mean_traj_time_s")},
            "status": [r.status for r in recs],
            "frontend_ok": [r.frontend_ok for r in recs],
            "final_cost": [float(r.cost_curve[-1]) for r in recs],
        }
    return out


def fallback():
    dist, origin, res = gap_wall_map(-0.8, 0.8)
    rec = harness.run_case(
        0, dist, origin, res, np.array([0.0, -3.0, 2.0]),
        np.array([0.0, 3.0, 2.0]),
        cfg=OptimizerConfig(iters_step1=4, iters_step2=12), clearance=1.2)
    return dict(via_fallback=rec.via_fallback, frontend_ok=rec.frontend_ok,
                status=rec.status, final_cost=float(rec.cost_curve[-1]))


def rrt():
    dist, origin, res = gap_wall_map(0.8, 2.4, thickness_cells=2)
    rec = harness.run_case_rrt(
        0, dist, origin, res, np.array([0.0, -3.0, 2.0]),
        np.array([0.0, 3.0, 2.0]),
        cfg=OptimizerConfig(iters_step1=10, iters_step2=40), steps=(1, 2),
        rrt_iters=1500, seed=1)
    return dict(status=rec.status, traj_length_m=rec.traj_length_m,
                final_cost=float(rec.cost_curve[-1]))


if __name__ == "__main__":
    for part in (suite, fallback, rrt):
        print(json.dumps({part.__name__: part()}), flush=True)
