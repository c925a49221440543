"""PyTorch port, mission pipeline and dual presets: kino-seeded kernel
inputs, ``solve_kino_batch`` and its seed-duration race, the dual seed
race with its polish through ``solve_batch``, ``plan_batch`` and the
pinned beam quality gate, against the JAX package on identical
numpy-seeded inputs (the JAX side on its off-TPU path).

Parity rules (the repo's own, ROADMAP.md North star): at short budgets
equal n_accept, cost rtol 5e-3 and sampled positions within 1e-3 m per
lane; at the full 100 iterations, where lanes split chaotically into
equal-quality basins, the cost distribution: |log cost ratio| p50 < 0.02,
p90 < 0.25, mean < 0.10.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import config as jconfig  # noqa: E402
from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu import pipeline as jpipe  # noqa: E402
from grad_traj_optimization_tpu import solver as jsolver  # noqa: E402
from grad_traj_optimization_tpu.config import (  # noqa: E402
    OptimizerConfig as JConfig,
)
from grad_traj_optimization_tpu.core import poly as jpoly  # noqa: E402
from grad_traj_optimization_tpu.core import qp as jqp  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402
from grad_traj_optimization_tpu.search import kinodynamic as jkd  # noqa: E402

from grad_traj_optimization_torch import config as tconfig  # noqa: E402
from grad_traj_optimization_torch import convert  # noqa: E402
from grad_traj_optimization_torch import fixtures as tfix  # noqa: E402
from grad_traj_optimization_torch import pipeline as tpipe  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch.config import MapConfig  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.core import qp as tqp  # noqa: E402
from grad_traj_optimization_torch.search import kinodynamic as tkd  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


def _tcfg(cfg):
    return convert.config_from_jax(dataclasses.asdict(cfg))


def _lane_agreement(tsol, jsol):
    """Per lane: equal n_accept, cost rtol 5e-3, positions < 1e-3 m.
    Returns (agree, n_accept equal, cost and positions agree)."""
    tp, _ = tpoly.sample_uniform(tsol.coeff, tsol.T, 100)
    jp = jax.vmap(lambda c, T: jpoly.sample_uniform(c, T, 100)[0])(
        jsol.coeff, jsol.T)
    perr = np.abs(_np(tp) - np.asarray(jp)).max(axis=(1, 2))
    tc, jc = _np(tsol.cost), np.asarray(jsol.cost)
    same_n = _np(tsol.n_accept) == np.asarray(jsol.n_accept)
    close = (np.abs(tc - jc) <= 5e-3 * np.abs(jc)) & (perr < 1e-3)
    return same_n & close, same_n, close


def _port_agreement(a, b):
    """The per-lane rule between two of the port's own solutions."""
    pa, _ = tpoly.sample_uniform(a.coeff.double(), a.T.double(), 100)
    pb, _ = tpoly.sample_uniform(b.coeff.double(), b.T.double(), 100)
    perr = _np((pa - pb).abs().amax(dim=(1, 2)))
    ca, cb = _np(a.cost.double()), _np(b.cost.double())
    return ((_np(a.n_accept) == _np(b.n_accept))
            & (np.abs(ca - cb) <= 5e-3 * np.abs(cb)) & (perr < 1e-3))


def _hold_lanes(tsol, jsol, referee, max_refereed: int):
    """The per-lane rule against the JAX package on every lane, except at
    most ``max_refereed`` lanes where the two f32 runs part on a near tie
    (an accept decision or a BB step on a gradient change at rounding
    level): there the port must keep to its own float64 run, ``referee()``
    (the referee of chip_smoke.py's phase 5)."""
    ok, _, _ = _lane_agreement(tsol, jsol)
    if ok.all():
        return ok
    bad = np.nonzero(~ok)[0]
    assert len(bad) <= max_refereed, bad
    ref_ok = _port_agreement(tsol, referee())
    assert ref_ok[bad].all(), (bad, ref_ok)
    return ok


def _double(scn):
    return scn.map(lambda x: x.double())


def _distribution_ok(tc, jc):
    r = np.sort(np.abs(np.log(np.asarray(tc) / np.asarray(jc))))
    p50 = float(r[len(r) // 2])
    p90 = float(r[int(np.ceil(0.9 * (len(r) - 1)))])
    return p50 < 0.02 and p90 < 0.25 and float(np.mean(r)) < 0.10, (
        p50, p90, float(np.mean(r)))


def _cases(n, seed=17):
    """n random_search_case problems as numpy batches (dists, origins,
    res, starts, goals), starts and goals at rest."""
    rng = np.random.default_rng(seed)
    cases = []
    while len(cases) < n:
        c = jfix.random_search_case(rng)
        if c is not None:
            cases.append(c)
    z = np.zeros(3)
    return (
        np.stack([np.asarray(c[0]) for c in cases]),
        np.stack([c[1] for c in cases]).astype(np.float32), cases[0][2],
        np.stack([np.concatenate([c[3], z]) for c in cases]).astype(
            np.float32),
        np.stack([np.concatenate([c[4], z]) for c in cases]).astype(
            np.float32),
    )


@pytest.fixture(scope="module")
def seeds():
    """8 missions searched and resampled by the JAX package: the knot
    states both refines start from."""
    dists, origins, res, starts, goals = _cases(8)
    r = jkd.search_batch(dists, origins, res, starts, goals, lookup="gather",
                         beam=32, max_iters=12)
    knots = [np.asarray(x) for x in jkd.resample_knots_batch(
        r.pos, r.vel, r.acc, r.times, 6)]
    ress = np.full(len(starts), res, np.float32)
    return dict(dists=dists, origins=origins, ress=ress, knots=knots)


# ------------------------------------------------------------- kino solves


def test_kino_kernel_inputs_match_jax(seeds):
    """kernel_inputs with the T / Df / dp0 overrides of the setKinoPath
    seeding, leaf by leaf (rtol 1e-4, atol 1e-5 of each leaf's scale)."""
    p, v, a, t = seeds["knots"]
    jDf, jdp0 = jax.vmap(jqp.kino_d)(jnp.asarray(p), jnp.asarray(v),
                                     jnp.asarray(a))
    jscn = jsolver.Scenario(jnp.asarray(seeds["dists"]),
                            jnp.asarray(seeds["origins"]),
                            jnp.asarray(seeds["ress"]), jnp.asarray(p))
    jk, jx = jsolver.kernel_inputs(jscn, JConfig(), dp0=jdp0,
                                   T=jnp.asarray(t), Df=jDf)
    tDf, tdp0 = tqp.kino_d(*(torch.as_tensor(x) for x in (p, v, a)))
    tscn = convert.scenario_from_numpy(seeds["dists"], seeds["origins"],
                                       seeds["ress"], p, device="cpu")
    tk, tx = tsolver.kernel_inputs(tscn, _tcfg(JConfig()), dp0=tdp0,
                                   T=torch.as_tensor(t), Df=tDf)
    # tk ends with K3's compact chains, which the JAX package lacks
    for a_, b in zip(tk[2:-1] + tx, jk[2:] + jx):
        if b is None:
            assert a_ is None
            continue
        b = np.asarray(b)
        np.testing.assert_allclose(
            _np(a_), b, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(b).max())))


def _kino_pair(seeds, cfg, race=False):
    args = (seeds["dists"], seeds["origins"], seeds["ress"], *seeds["knots"])
    if race:
        j = jsolver.solve_kino_batch_race(*(jnp.asarray(x) for x in args),
                                          stretches=(1.0, 1.2), cfg=cfg)
        t = tsolver.solve_kino_batch_race(
            torch.as_tensor(args[0]), *args[1:], stretches=(1.0, 1.2),
            cfg=_tcfg(cfg))
    else:
        j = jsolver.solve_kino_batch(*(jnp.asarray(x) for x in args),
                                     cfg=cfg)
        t = tsolver.solve_kino_batch(torch.as_tensor(args[0]), *args[1:],
                                     cfg=_tcfg(cfg))
    return t, j


@pytest.mark.parametrize("race", [False, True], ids=["single", "race"])
def test_solve_kino_batch_short_budget_matches_jax(seeds, race):
    """10 iterations, per-lane rule.  The kino seeds' accept decisions sit
    on near ties (a lane accepts 1-5 of 10 steps, and its own float64 run
    parts from the f32 runs on 3 of these 8 lanes): one lane takes one
    more accept at an equal cost in the port than in the JAX package (see
    PERF.md).  Every other lane holds the full rule, and that lane still
    holds cost and positions."""
    cfg = JConfig(iters_step2=10)
    calls = profiling.counter("plain.descend")
    t, j = _kino_pair(seeds, cfg, race)
    assert profiling.counter("plain.descend") == calls + (2 if race else 1)
    np.testing.assert_array_equal(_np(t.status), np.asarray(j.status))
    ok, _, close = _lane_agreement(t, j)
    assert close.all(), np.nonzero(~close)
    assert int((~ok).sum()) <= 1, np.nonzero(~ok)
    dn = np.abs(_np(t.n_accept) - np.asarray(j.n_accept))
    assert dn.max() <= 1, dn


def test_solve_kino_batch_full_budget_distribution(seeds):
    t, j = _kino_pair(seeds, JConfig())
    ok, stats = _distribution_ok(_np(t.cost), np.asarray(j.cost))
    assert ok, stats
    assert np.all(_np(t.status) == tsolver.STATUS_OK)
    tr = _np(t.cost_trace)
    assert tr.shape == (8, 100) and np.all(np.diff(tr, axis=1) <= 0)


def test_kino_race_keeps_the_better_arm(seeds):
    """The race's per-lane winner: converged first, then the lower cost."""
    cfg = _tcfg(JConfig(iters_step2=10))
    args = (torch.as_tensor(seeds["dists"]), seeds["origins"], seeds["ress"],
            *seeds["knots"])
    arms = [tsolver.solve_kino_batch(*args[:6], torch.as_tensor(args[6]) * s,
                                     cfg=cfg) for s in (1.0, 1.3)]
    win = tsolver.solve_kino_batch_race(*args, stretches=(1.0, 1.3), cfg=cfg)
    assert bool((arms[0].status == 0).all() & (arms[1].status == 0).all())
    np.testing.assert_array_equal(
        _np(win.cost), np.minimum(_np(arms[0].cost), _np(arms[1].cost)))
    # a diverged arm never wins, whatever its cost
    bad = arms[1]._replace(cost=torch.zeros_like(arms[1].cost),
                           status=torch.ones_like(arms[1].status))
    take = torch.where(arms[0].status == bad.status, bad.cost < arms[0].cost,
                       bad.status == tsolver.STATUS_OK)
    assert not bool(take.any())


# ------------------------------------------------------- dual presets


MAP = MapConfig(origin=(-10.0, -10.0, 0.0), resolution=0.5,
                map_size=(20.0, 20.0, 8.0))


@pytest.fixture(scope="module")
def bench_like():
    """12 random bench-style scenarios (the EDT from the JAX package)."""
    B = 12
    _, pts, valid, wps = jfix.random_scenarios(
        B, n_waypoints=7, seed=4, map_cfg=MAP, max_obstacle_points=2048)
    origin = np.asarray(MAP.origin, np.float32)
    occ = jax.vmap(
        lambda p, v: jsdf.rasterize(p, jnp.asarray(origin), MAP.resolution,
                                    MAP.grid_shape, valid_mask=v)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    dist = np.asarray(jsdf.edt_batch(occ, MAP.resolution, backend="jnp"))
    leaves = (dist, np.broadcast_to(origin, (B, 3)).copy(),
              np.full((B,), MAP.resolution, np.float32),
              wps.astype(np.float32))
    return (jsolver.Scenario(*(jnp.asarray(x) for x in leaves)),
            convert.scenario_from_numpy(*leaves, device="cpu"))


DUAL_PRESETS = ["TURBO_CONFIG", "TURBO_POLISH_CONFIG", "TURBO_SAFE_CONFIG"]


def _short(cfg):
    """A preset at a short budget, its race structure kept."""
    return dataclasses.replace(
        cfg, iters_step2=8, dual_ms_iters=6,
        polish_iters=4 if cfg.polish_iters else 0)


@pytest.fixture
def jax_min_snap_seed(bench_like, monkeypatch):
    """The min-snap arm's seed is an f32 solve with condition ~1e4: the two
    packages' seeds differ by up to ~3e-4 of their scale (each as far from
    the float64 seed), and the first BB steps carry that apart within two
    iterations on some lanes.  test_torch_solver's kernel-input test holds
    the seed itself; here every run (the float64 referee too) starts the
    race from the JAX package's seed, found by each lane's fixed
    derivatives, so the rule tests the race, the arms and the polish."""
    jscn, _ = bench_like
    _, (jDf, jdp0, _) = jsolver.kernel_inputs(
        jscn, JConfig(seed_mode="min_snap"))
    jDf, jdp0 = np.asarray(jDf), np.asarray(jdp0)

    def seed(Df, Rpp, Rfp):
        rows = [int(np.nonzero((jDf == d).all(axis=(1, 2)))[0][0])
                for d in _np(Df.float())]
        return torch.as_tensor(jdp0[rows], dtype=Df.dtype, device=Df.device)

    monkeypatch.setattr(tqp, "min_snap_dp", seed)


@pytest.mark.parametrize("name", DUAL_PRESETS)
def test_dual_presets_short_budget_match_jax(bench_like, name,
                                             jax_min_snap_seed):
    """Each dual preset through solve_batch at a short budget, per-lane
    rule against the JAX solve_batch; the plain loop runs once per arm
    (and once more for the polish)."""
    jscn, tscn = bench_like
    jcfg = _short(getattr(jconfig, name))
    jsol = jsolver.solve_batch(jscn, cfg=jcfg, record_trace=True)
    calls = profiling.counter("plain.descend")
    tsol = tsolver.solve_batch(tscn, cfg=_tcfg(jcfg))
    assert profiling.counter("plain.descend") == calls + (
        3 if jcfg.polish_iters else 2)
    _hold_lanes(tsol, jsol, lambda: tsolver.solve_batch(
        _double(tscn), cfg=_tcfg(jcfg)), max_refereed=2)
    np.testing.assert_array_equal(_np(tsol.status), np.asarray(jsol.status))
    L = max(jcfg.iters_step2, jcfg.dual_ms_iters) + jcfg.polish_iters
    tr = _np(tsol.cost_trace)
    assert tr.shape == (12, L) and np.all(np.diff(tr, axis=1) <= 0)
    np.testing.assert_allclose(tr[:, -1], _np(tsol.cost), rtol=0)


def test_dual_safe_never_worse_than_reference(bench_like):
    """TURBO_SAFE's reference arm runs OptimizerConfig()'s own program, so
    per lane its cost is <= the reference schedule's, bitwise."""
    _, tscn = bench_like
    cfg = dataclasses.replace(tconfig.TURBO_SAFE_CONFIG, iters_step2=12,
                              dual_ms_iters=6)
    ref = tsolver.solve_batch(tscn, cfg=tconfig.OptimizerConfig(
        iters_step2=12))
    safe = tsolver.solve_batch(tscn, cfg=cfg)
    assert np.all(_np(safe.cost) <= _np(ref.cost))


def test_dual_single_solve_matches_jax(bench_like, jax_min_snap_seed):
    """solve at B = 1 composes the race and the polish as solve_batch
    does, and as the JAX package's solve."""
    jscn, tscn = bench_like
    jcfg = _short(jconfig.TURBO_POLISH_CONFIG)
    jsol = jsolver.solve(jsolver.Scenario(*(x[3] for x in jscn[:4])),
                         cfg=jcfg)
    one = tscn.map(lambda x: x[3])
    tsol = tsolver.solve(one, cfg=_tcfg(jcfg))
    _hold_lanes(tsolver.Solution(*(x[None] for x in tsol)),
                jsolver.Solution(*(x[None] for x in jsol)),
                lambda: tsolver.Solution(*(x[None] for x in tsolver.solve(
                    one.map(lambda x: x.double()),
                    cfg=_tcfg(jcfg)))), max_refereed=1)


def test_dual_kernel_entry_rejects_polish(bench_like):
    _, tscn = bench_like
    with pytest.raises(ValueError):
        tsolver.solve_batch_kernel(tscn, cfg=tconfig.TURBO_POLISH_CONFIG)
    cfg = _tcfg(_short(jconfig.TURBO_CONFIG))
    a = tsolver.solve_batch_kernel(tscn, cfg=cfg)
    b = tsolver.solve_batch(tscn, cfg=cfg)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def missions():
    return _cases(4)


@pytest.mark.parametrize("long_tau", [False, True], ids=["base", "long_tau"])
def test_plan_batch_matches_jax(missions, long_tau):
    """plan_batch with the arguments of tests/test_search.py:912-925:
    reached, ok and arm equal; each lane's cost within rtol 5e-3."""
    dists, origins, res, starts, goals = missions
    cfg = JConfig(iters_step2=15)
    kw = dict(beam=32, max_iters=12, retries=1, lookup="gather",
              long_tau_arm=long_tau)
    j = jpipe.plan_batch(dists, origins, res, starts, goals, cfg=cfg, **kw)
    t = tpipe.plan_batch(torch.as_tensor(dists), origins, res, starts, goals,
                         cfg=_tcfg(cfg), **kw)
    np.testing.assert_array_equal(t.reached, j.reached)
    np.testing.assert_array_equal(t.ok, j.ok)
    assert t.ok.sum() >= 3 and t.n_retried == j.n_retried
    if long_tau:
        np.testing.assert_array_equal(t.arm, j.arm)
    else:
        assert t.arm is None and j.arm is None
    np.testing.assert_allclose(_np(t.solution.cost),
                               np.asarray(j.solution.cost), rtol=5e-3)
    np.testing.assert_array_equal(t.ok, t.reached & (
        _np(t.solution.status) == 0))
    out = convert.plan_result_to_numpy(t)
    assert isinstance(out.search.pos, np.ndarray)
    np.testing.assert_array_equal(out.solution.cost, _np(t.solution.cost))


def test_plan_batch_dynamic_and_degenerate(missions):
    """A shared two-box prediction, and B = 1 with the start at the goal:
    reached and ok equal to the JAX package's."""
    dists, origins, res, starts, goals = missions
    cfg = JConfig(iters_step2=8)
    hist = np.array([[[-3.0, -1.0, 2.0], [-2.5, -1.0, 2.0]],
                     [[3.0, 1.0, 2.0], [2.5, 1.5, 2.0]]], np.float32)
    ht = np.array([[-0.5, 0.0]] * 2, np.float32)
    scale = np.full((2, 3), 0.8, np.float32)
    from grad_traj_optimization_tpu.search import predictor as jpred

    jp = jpred.fit_const_vel(jnp.asarray(hist), jnp.asarray(ht),
                             jnp.asarray(scale))
    tp = convert.prediction_from_numpy(*(np.asarray(x) for x in jp),
                                       device="cpu")
    kw = dict(beam=16, max_iters=10, retries=1, lookup="gather")
    j = jpipe.plan_batch(dists, origins, res, starts, goals, cfg=cfg,
                         obstacle_pred=jp, **kw)
    t = tpipe.plan_batch(torch.as_tensor(dists), origins, res, starts, goals,
                         cfg=_tcfg(cfg), obstacle_pred=tp, **kw)
    np.testing.assert_array_equal(t.reached, j.reached)
    np.testing.assert_array_equal(t.ok, j.ok)
    # start == goal: the shot's heuristic is 0/0, as in the JAX package
    one = tpipe.plan_batch(torch.as_tensor(dists[:1]), origins[:1], res,
                           starts[:1], starts[:1], cfg=_tcfg(cfg), **kw)
    j1 = jpipe.plan_batch(dists[:1], origins[:1], res, starts[:1],
                          starts[:1], cfg=cfg, **kw)
    assert one.reached.shape == (1,)
    np.testing.assert_array_equal(one.reached, j1.reached)
    np.testing.assert_array_equal(one.ok, j1.ok)


def test_beam_quality_pinned_gate():
    """The port against the pinned oracle suite with the bounds of
    tests/test_search.py:806-884: 25/25 reached with retries, refined cost
    gm <= 0.97 against the exact kino A* and <= 1.12 against the hybrid
    A*."""
    cache = np.load(os.path.join(os.path.dirname(__file__), "data",
                                 "beam_gate_oracle.npz"))
    n_cases = int(cache["n_cases"])
    rng = np.random.default_rng(int(cache["seed"]))
    cases = []
    while len(cases) < n_cases:
        c = tfix.random_search_case(rng, device="cpu")
        if c is not None:
            cases.append(c)
    dists = torch.stack([c[0] for c in cases])
    origins = np.stack([c[1] for c in cases]).astype(np.float32)
    res = cases[0][2]
    z = np.zeros(3)
    starts = np.stack([np.concatenate([c[3], z]) for c in cases]).astype(
        np.float32)
    goals = np.stack([np.concatenate([c[4], z]) for c in cases]).astype(
        np.float32)
    merged, _, _ = tkd.search_batch_adaptive(
        dists, origins, res, starts, goals, retries=2,
        margin=float(cache["margin"]), max_vel=3.0, max_acc=2.0, beam=64,
        max_iters=30)
    assert bool(merged.reached.all()), int(merged.reached.sum())
    cfg = tconfig.OptimizerConfig(iters_step2=int(cache["refine_iters"]))
    p6, v6, a6, t6 = tkd.resample_knots_batch(merged.pos, merged.vel,
                                              merged.acc, merged.times, 6)
    ress = np.full(n_cases, res, np.float32)
    cb = np.minimum(*(
        _np(tsolver.solve_kino_batch(dists, origins, ress, p6, v6, a6, t_arm,
                                     cfg=cfg).cost)
        for t_arm in (t6, t6 * 1.2)))

    def gm_ratio(oracle_ok, oracle_cost):
        ok = np.asarray(oracle_ok) & np.isfinite(cb)
        r = cb[ok] / np.maximum(np.asarray(oracle_cost)[ok], 1e-9)
        return float(np.exp(np.mean(np.log(np.maximum(r, 1e-9))))), ok.sum()

    gm_k, n_k = gm_ratio(cache["ok_kino"], cache["cost_kino"])
    gm_h, n_h = gm_ratio(cache["ok_hybrid"], cache["cost_hybrid"])
    assert n_k >= n_cases - 2 and n_h >= n_cases - 2
    assert gm_k <= 0.97, f"vs-kino refined-cost gm {gm_k:.3f} > 0.97"
    assert gm_h <= 1.12, f"vs-hybrid refined-cost gm {gm_h:.3f} > 1.12"
