"""PyTorch port, the beam-vs-exact quality suite
(``scripts/beam_vs_exact_torch.py``) against the JAX package's
(``scripts/beam_vs_exact.py``), on the CPU:

* both scripts' ``run_suite`` on the same 6 cases, live, for each of the
  JAX script's suites and a starved beam that retries;
* the stats dict's keys;
* the batched beam against the port's per-case ``search_adaptive``.
"""

import ast
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path[:0] = [REPO, SCRIPTS]

import beam_vs_exact_torch as bve  # noqa: E402
from test_torch_benches import share_of_the_cores  # noqa: E402,F401

#: the beam-vs-exact suites held to the JAX script's ``run_suite`` on the
#: same 6 cases (seed 0, retime "race:search,stretch:1.2", retries 2):
#: (exact arm, shot_mode, extra run_suite arguments); "starved" gives the
#: beam 8 wide and 10 deep, so the retry ladder runs on 4 of the cases
N_BEAM_CASES = 6
BEAM_SUITES = {"kino": ("kino", 0, {}), "hybrid": ("hybrid", 0, {}),
               "hybrid_shot1": ("hybrid", 1, {}),
               "kino_starved": ("kino", 0, dict(beam=8, kino_iters=10))}
#: the geometric means' tolerance, in |log| of the JAX script's (the
#: port refines in float32 with K3's plain loop, the JAX script with
#: ``descent.minimize``; at 40 iterations a few lanes part slightly)
RATIO_LOG_TOL = 0.05


@functools.lru_cache(maxsize=None)
def jax_suite(name):
    """The JAX script's ``run_suite`` on the CPU (once a suite)."""
    from beam_vs_exact import run_suite

    exact, shot_mode, kw = BEAM_SUITES[name]
    return run_suite(N_BEAM_CASES, exact=exact, shot_mode=shot_mode,
                     verbose=False, **bve.SUITE_KW, **kw)


@pytest.mark.parametrize("name", list(BEAM_SUITES))
def test_beam_vs_exact_matches_jax(name):
    """The port's suite and the JAX script's on the same 6 cases: the
    counts equal (the exact oracle is bitwise, the beam the JAX
    package's; ``n_retried`` sums each case's retry rounds on both
    sides), the ratios' geometric means within RATIO_LOG_TOL in |log|."""
    exact, shot_mode, kw = BEAM_SUITES[name]
    st = bve.run_suite(N_BEAM_CASES, exact=exact, shot_mode=shot_mode,
                       verbose=False, device="cpu", **bve.SUITE_KW, **kw)
    want = jax_suite(name)
    for k in ("n_cases", "exact_success", "beam_success", "both_success",
              "n_retried"):
        assert st[k] == want[k], (k, st[k], want[k])
    for k in ("cost_ratio_geomean", "time_ratio_geomean",
              "jerk_ratio_geomean"):
        assert abs(np.log(st[k] / want[k])) <= RATIO_LOG_TOL, (k, st[k],
                                                                want[k])
    assert st["refine_launches"]["K3"] >= 3
    if kw:
        assert st["n_retried"] > st["n_cases"] - st["beam_success"]


def test_beam_vs_exact_stats_keys():
    """The port's stats dict has the JAX ``run_suite``'s keys (read from
    its return statement's dict) and one more, ``refine_launches``."""
    with open(os.path.join(SCRIPTS, "beam_vs_exact.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_suite")
    stats = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "stats")
    jax_keys = {k.value for k in stats.keys}
    st = bve.run_suite(2, verbose=False, device="cpu", **bve.SUITE_KW)
    assert set(st) == jax_keys | {"refine_launches"}


@pytest.mark.parametrize("kw", [
    dict(beam=64, max_iters=30),          # the suite's beam
    dict(beam=4, max_iters=6),            # starved: the ladder retries
], ids=["suite", "starved"])
def test_batched_beam_matches_per_case(kw):
    """``search_batch_ladder`` over the suite's cases (as the suite runs
    it) against the port's per-case ``search_adaptive`` (as the JAX
    script runs it): reached and retry rounds equal on every case, knots
    within 1e-5 (the batch front-pads a lane's knots to its deepest
    round's count)."""
    from grad_traj_optimization_torch.search import kinodynamic as kd

    _, dists, origins, res, starts, goals = bve.draw_cases(6, 0, "cpu")
    f32 = dict(dtype=torch.float32)
    skw = dict(margin=0.2, max_vel=3.0, max_acc=2.0, max_tau=0.5,
               retries=2, **kw)
    kb, n_retried, _, rounds = kd.search_batch_ladder(
        dists, torch.as_tensor(origins, **f32), res,
        torch.as_tensor(starts, **f32), torch.as_tensor(goals, **f32),
        **skw)
    used = []
    for j in range(dists.shape[0]):
        r, u = kd.search_adaptive(
            dists[j], torch.as_tensor(origins[j], **f32), res,
            torch.as_tensor(starts[j], **f32),
            torch.as_tensor(goals[j], **f32), **skw)
        used.append(u)
        assert bool(r.reached) == bool(kb.reached[j])
        assert rounds[j] == u
        # a lane the batch's deeper rounds did not reach keeps its own
        # knots behind zero-duration copies of its first knot
        for a, b in zip((kb.pos, kb.vel, kb.acc, kb.times),
                        (r.pos, r.vel, r.acc, r.times)):
            n = b.shape[0]
            assert float((a[j, -n:] - b).abs().max()) <= 1e-5
            pad = a[j, :-n]
            assert torch.equal(pad, torch.zeros_like(pad) if a is kb.times
                               else a[j, -n:][:1].expand_as(pad))
    # the ladder's first round takes every case the base beam missed
    assert n_retried == sum(u > 0 for u in used)
    if kw["beam"] == 4:
        assert n_retried > 0
