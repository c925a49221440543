"""PyTorch port, optimizer and solver: penalty, descent, kernel_inputs,
the whole-descent kernel's plain version (K3) and solve / solve_batch
end to end, against the JAX package on identical inputs.

Parity rules (the repo's own, tests/test_solve.py and
__graft_entry__.py:109-117): at short budgets equal n_accept, cost rtol
5e-3 and sampled positions within 1e-3 m; at the full 100-iteration
budget, where lanes split chaotically into equal-quality basins, the cost
distribution: |log cost ratio| p50 < 0.02, p90 < 0.25, mean < 0.10.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu import solver as jsolver  # noqa: E402
from grad_traj_optimization_tpu.config import (  # noqa: E402
    OptimizerConfig as JConfig,
)
from grad_traj_optimization_tpu.core import poly as jpoly  # noqa: E402
from grad_traj_optimization_tpu.core import qp as jqp  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402
from grad_traj_optimization_tpu.ops import solve_pallas  # noqa: E402
from grad_traj_optimization_tpu.opt import descent as jdescent  # noqa: E402
from grad_traj_optimization_tpu.opt import penalty as jpenalty  # noqa: E402

from grad_traj_optimization_torch import convert  # noqa: E402
from grad_traj_optimization_torch import fixtures as tfix  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch.config import MapConfig  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.core import qp as tqp  # noqa: E402
from grad_traj_optimization_torch.ops import solve_cuda  # noqa: E402
from grad_traj_optimization_torch.opt import descent as tdescent  # noqa: E402
from grad_traj_optimization_torch.opt import penalty as tpenalty  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

#: the bench map's 20 x 20 m footprint at 0.5 m: a 40 x 40 x 16 grid;
#: 7 waypoints as in the bench (m = 6, S = 180, P = 15)
MAP = MapConfig(origin=(-10.0, -10.0, 0.0), resolution=0.5,
                map_size=(20.0, 20.0, 8.0))
B = 16


def _np(t):
    return t.detach().cpu().numpy()


def _tcfg(**kw):
    return convert.config_from_jax(dataclasses.asdict(JConfig(**kw)))


@pytest.fixture(scope="module")
def batch():
    """B random bench-style scenarios as numpy leaves (the EDT from the
    JAX package) and both packages' Scenario batches built from them."""
    _, pts, valid, wps = jfix.random_scenarios(
        B, n_waypoints=7, seed=4, map_cfg=MAP, max_obstacle_points=2048
    )
    origin = np.asarray(MAP.origin, np.float32)
    occ = jax.vmap(
        lambda p, v: jsdf.rasterize(p, jnp.asarray(origin), MAP.resolution,
                                    MAP.grid_shape, valid_mask=v)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    dist = np.asarray(jsdf.edt_batch(occ, MAP.resolution, backend="jnp"))
    leaves = dict(
        dist=dist, origin=np.broadcast_to(origin, (B, 3)).copy(),
        resolution=np.full((B,), MAP.resolution, np.float32),
        waypoints=wps.astype(np.float32),
    )
    jscn = jsolver.Scenario(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tscn = convert.scenario_from_numpy(**leaves, device="cpu")
    return dict(leaves=leaves, jscn=jscn, tscn=tscn)


def _lane_agreement(tsol, jsol):
    """Per-lane: equal n_accept, cost rtol 5e-3, positions < 1e-3 m."""
    tp, _ = tpoly.sample_uniform(tsol.coeff, tsol.T, 100)
    jp = jax.vmap(lambda c, T: jpoly.sample_uniform(c, T, 100)[0])(
        jsol.coeff, jsol.T)
    perr = np.abs(_np(tp) - np.asarray(jp)).max(axis=(1, 2))
    tc, jc = _np(tsol.cost), np.asarray(jsol.cost)
    return (
        (_np(tsol.n_accept) == np.asarray(jsol.n_accept))
        & (np.abs(tc - jc) <= 5e-3 * np.abs(jc))
        & (perr < 1e-3)
    )


def _distribution_ok(tc, jc):
    r = np.sort(np.abs(np.log(np.asarray(tc) / np.asarray(jc))))
    p50 = float(r[len(r) // 2])
    p90 = float(r[int(np.ceil(0.9 * (len(r) - 1)))])
    return p50 < 0.02 and p90 < 0.25 and float(np.mean(r)) < 0.10, (
        p50, p90, float(np.mean(r)))


# ------------------------------------------------------------- penalty


def _one(batch, i=0):
    lv = batch["leaves"]
    wp = lv["waypoints"][i]
    jT = jqp.allocate_times(jnp.asarray(wp), 1.8, 0.3)
    jDf, jdp = jqp.straight_line_d(jnp.asarray(wp))
    rng = np.random.default_rng(30 + i)
    dp = np.asarray(jdp) + rng.normal(scale=0.2, size=jdp.shape).astype(
        np.float32)
    return wp, np.asarray(jT), np.asarray(jDf), dp


def test_build_ctx_matches_jax(batch):
    wp, T, Df, _ = _one(batch)
    cfg = JConfig(alpha_a=0.1)
    jctx = jpenalty.build_ctx(jnp.asarray(T), jnp.asarray(Df), cfg)
    tctx = tpenalty.build_ctx(torch.tensor(T), torch.tensor(Df),
                              _tcfg(alpha_a=0.1))
    for k in ("T", "Df", "Tmat", "TVmat", "TL", "TVL", "dt", "TAmat", "TAL"):
        ref = np.asarray(getattr(jctx, k))
        np.testing.assert_allclose(
            _np(getattr(tctx, k)), ref, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=k)


@pytest.mark.parametrize("per_wp", [False, True])
def test_bounds_match_jax(batch, per_wp):
    wp = batch["leaves"]["waypoints"][1]
    bos = np.linspace(0.5, 2.0, wp.shape[0] - 2).astype(np.float32) \
        if per_wp else None
    jlb, jub = jpenalty.bounds(jnp.asarray(wp), 15, JConfig(),
                               bos=None if bos is None else jnp.asarray(bos))
    tlb, tub = tpenalty.bounds(torch.as_tensor(wp), 15, _tcfg(),
                               bos=None if bos is None
                               else torch.as_tensor(bos))
    np.testing.assert_array_equal(_np(tlb), np.asarray(jlb))
    np.testing.assert_array_equal(_np(tub), np.asarray(jub))


CG_CASES = [
    dict(step=2), dict(step=1), dict(step=2, gradient_mode="exact"),
    dict(step=2, alpha_v=0.1, alpha_a=0.1),
    dict(step=2, alpha_v=0.1, alpha_a=0.1, gradient_mode="exact"),
    dict(step=2, w_collision=0.0),
]


@pytest.mark.parametrize("case", CG_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_cost_and_grad_matches_jax(batch, case):
    """Single-scenario cost (rtol 1e-4) and gradient (atol 1e-4 of its
    scale) against the JAX f32 path, every gradient mode and term."""
    case = dict(case)
    step = case.pop("step")
    wp, T, Df, dp = _one(batch, 2)
    jcfg = JConfig(**case)
    tcfg = _tcfg(**case)
    dist = batch["leaves"]["dist"][2]
    jfield, shape = jpenalty.make_field(jnp.asarray(dist),
                                        jnp.asarray(MAP.origin, jnp.float32),
                                        jnp.float32(MAP.resolution))
    tfield, tshape = tpenalty.make_field(
        torch.as_tensor(dist), torch.tensor(MAP.origin),
        torch.tensor(MAP.resolution))
    assert tshape == tuple(shape)
    jctx = jpenalty.build_ctx(jnp.asarray(T), jnp.asarray(Df), jcfg)
    tctx = tpenalty.build_ctx(torch.as_tensor(T), torch.as_tensor(Df), tcfg)
    jc, jg = jpenalty.cost_and_grad(jnp.asarray(dp), jctx, jfield, shape,
                                    jcfg, step)
    tc, tg = tpenalty.cost_and_grad(torch.as_tensor(dp), tctx, tfield,
                                    tshape, tcfg, step)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)
    jg = np.asarray(jg)
    np.testing.assert_allclose(_np(tg), jg, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jg).max()))
    co = tpenalty.cost_only(torch.as_tensor(dp), tctx, tfield, tshape, tcfg,
                            step)
    np.testing.assert_allclose(float(co), float(tc), rtol=1e-6)


@pytest.mark.parametrize("shared", [False, True])
def test_cost_and_grad_batch_matches_jax(batch, shared):
    lv = batch["leaves"]
    n = 5
    wps = lv["waypoints"][:n]
    jcfg, tcfg = JConfig(), _tcfg()
    jT = jax.vmap(lambda w: jqp.allocate_times(w, 1.8, 0.3))(jnp.asarray(wps))
    jDf, jdp = jax.vmap(jqp.straight_line_d)(jnp.asarray(wps))
    dp = np.asarray(jdp) + np.random.default_rng(40).normal(
        scale=0.2, size=jdp.shape).astype(np.float32)
    grids = lv["dist"][:1] if shared else lv["dist"][:n]
    jbctx = jpenalty.build_ctx_batch(jT, jDf, jcfg)
    jc, jg = jpenalty.cost_and_grad_batch(
        jnp.asarray(dp), jbctx, jnp.asarray(np.broadcast_to(
            grids, (n,) + grids.shape[1:])), jnp.asarray(lv["origin"][:n]),
        jnp.asarray(lv["resolution"][:n]), jcfg, 2)
    tbctx = tpenalty.build_ctx_batch(torch.as_tensor(np.asarray(jT)),
                                     torch.as_tensor(np.asarray(jDf)), tcfg)
    tc, tg = tpenalty.cost_and_grad_batch(
        torch.as_tensor(dp), tbctx, torch.as_tensor(grids),
        torch.as_tensor(lv["origin"][:n]),
        torch.as_tensor(lv["resolution"][:n]), tcfg, 2)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-4)
    jg = np.asarray(jg)
    np.testing.assert_allclose(_np(tg), jg, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jg).max()))


# ------------------------------------------------------------- descent


@pytest.mark.parametrize("kw", [
    dict(), dict(accept_window=4), dict(step_rule="adaptive"),
])
def test_minimize_batch_matches_jax(batch, kw):
    """The BB / adaptive descent over the batched penalty, 8 iterations:
    equal accept counts, cost and trace rtol 5e-3."""
    lv = batch["leaves"]
    n = 6
    wps = lv["waypoints"][:n]
    jcfg, tcfg = JConfig(**kw), _tcfg(**kw)
    jT = jax.vmap(lambda w: jqp.allocate_times(w, 1.8, 0.3))(jnp.asarray(wps))
    jDf, jdp = jax.vmap(jqp.straight_line_d)(jnp.asarray(wps))
    jlb, jub = jax.vmap(lambda w: jpenalty.bounds(w, 15, jcfg))(
        jnp.asarray(wps))
    jbctx = jpenalty.build_ctx_batch(jT, jDf, jcfg)
    args = (jnp.asarray(lv["dist"][:n]), jnp.asarray(lv["origin"][:n]),
            jnp.asarray(lv["resolution"][:n]))
    jres = jdescent.minimize_batch(
        lambda d: jpenalty.cost_and_grad_batch(d, jbctx, *args, jcfg, 2),
        jdp, jlb, jub, 8, jcfg, record_trace=True)
    tbctx = tpenalty.build_ctx_batch(torch.as_tensor(np.asarray(jT)),
                                     torch.as_tensor(np.asarray(jDf)), tcfg)
    targs = tuple(torch.as_tensor(np.asarray(a)) for a in args)
    tres = tdescent.minimize_batch(
        lambda d: tpenalty.cost_and_grad_batch(d, tbctx, *targs, tcfg, 2),
        torch.as_tensor(np.asarray(jdp)), torch.as_tensor(np.asarray(jlb)),
        torch.as_tensor(np.asarray(jub)), 8, tcfg, record_trace=True)
    np.testing.assert_array_equal(_np(tres.n_accept),
                                  np.asarray(jres.n_accept))
    np.testing.assert_allclose(_np(tres.cost), np.asarray(jres.cost),
                               rtol=5e-3)
    np.testing.assert_allclose(_np(tres.cost_trace),
                               np.asarray(jres.cost_trace), rtol=5e-3)
    np.testing.assert_allclose(_np(tres.dp), np.asarray(jres.dp), atol=1e-3)


def test_minimize_single_matches_jax(batch):
    wp, T, Df, _ = _one(batch, 3)
    jcfg, tcfg = JConfig(), _tcfg()
    dist = batch["leaves"]["dist"][3]
    jfield, shape = jpenalty.make_field(jnp.asarray(dist),
                                        jnp.asarray(MAP.origin, jnp.float32),
                                        jnp.float32(MAP.resolution))
    tfield, _ = tpenalty.make_field(torch.as_tensor(dist),
                                    torch.tensor(MAP.origin),
                                    torch.tensor(MAP.resolution))
    jctx = jpenalty.build_ctx(jnp.asarray(T), jnp.asarray(Df), jcfg)
    tctx = tpenalty.build_ctx(torch.as_tensor(T), torch.as_tensor(Df), tcfg)
    _, jdp0 = jqp.straight_line_d(jnp.asarray(wp))
    jlb, jub = jpenalty.bounds(jnp.asarray(wp), 15, jcfg)
    jres = jdescent.minimize(
        lambda d: jpenalty.cost_and_grad(d, jctx, jfield, shape, jcfg, 2),
        None, jdp0, jlb, jub, 8, jcfg)
    tres = tdescent.minimize(
        lambda d: tpenalty.cost_and_grad(d, tctx, tfield, shape, tcfg, 2),
        None, torch.as_tensor(np.asarray(jdp0)),
        torch.as_tensor(np.asarray(jlb)), torch.as_tensor(np.asarray(jub)),
        8, tcfg)
    assert int(tres.n_accept) == int(jres.n_accept)
    np.testing.assert_allclose(_np(tres.cost_trace),
                               np.asarray(jres.cost_trace), rtol=5e-3)


# ------------------------------------------------ kernel_inputs and K3


KIN_NAMES = ["apos", "avel", "tltv", "rpp", "cgt", "lbT", "ubT", "dp0T",
             "dts", "dfT", "misc", "aacc"]


@pytest.mark.parametrize("kw", [
    dict(), dict(seed_mode="min_snap"), dict(alpha_a=0.1, alpha_v=0.1),
])
def test_kernel_inputs_match_jax(batch, kw):
    """Every kernel input but the grid slot (bf16 planes in the JAX
    package, f32 grids here), leaf by leaf: rtol 1e-4 / atol 1e-5 of
    each leaf's scale.  The min-snap seed is an f32 solve of an
    equilibrated system with condition ~1e4, so it gets atol 1e-3 of its
    scale (~1e4 ulp)."""
    jk, jx = jsolver.kernel_inputs(batch["jscn"], JConfig(**kw))
    tk, tx = tsolver.kernel_inputs(batch["tscn"], _tcfg(**kw))
    assert tk[1] == tuple(jk[1])
    np.testing.assert_array_equal(_np(tk[0]), batch["leaves"]["dist"])
    for name, a, b in zip(KIN_NAMES, tk[2:], jk[2:]):
        if b is None:
            assert a is None, name
            continue
        b = np.asarray(b)
        seed = name == "dp0T" and kw.get("seed_mode") == "min_snap"
        np.testing.assert_allclose(
            _np(a), b, rtol=1e-4,
            atol=(1e-3 if seed else 1e-5) * max(1.0, float(np.abs(b).max())),
            err_msg=name)
    for name, a, b in zip(("Df", "dp0", "T"), tx, jx):
        seed = name == "dp0" and kw.get("seed_mode") == "min_snap"
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-2 if seed else 1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("m", [6, 10], ids=["bench", "opti_node"])
def test_compact_chains_scatter_to_dense(m):
    """K3's compact chains, scattered back through the structural column
    table, equal kernel_inputs' dense apos/avel/aacc bitwise, padded rows
    included (bench-like m = 6 and opti_node-like m = 10, K = n_samples,
    with the acceleration chain)."""
    rng = np.random.default_rng(m)
    B = 3
    wps = np.cumsum(rng.uniform(0.5, 2.0, (B, m + 1, 3)), axis=1)
    scn = convert.scenario_from_numpy(
        np.zeros((B, 4, 4, 4), np.float32), np.zeros((B, 3), np.float32),
        np.full((B,), 0.5, np.float32), wps.astype(np.float32), device="cpu")
    cfg = _tcfg(alpha_a=0.1, alpha_v=0.1)
    kargs, _ = tsolver.kernel_inputs(scn, cfg)
    apos, avel, aacc, chains = kargs[2], kargs[3], kargs[13], kargs[14]
    K, ndim = cfg.n_samples, 3 * m + 3
    SP = apos.shape[1]
    assert SP == max(8, -(-m * K // 8) * 8)
    cols = _np(chains.cols)
    assert cols.dtype == np.int32 and cols.shape == (m, 6)
    np.testing.assert_array_equal(cols, tqp.segment_columns(m))
    # segment s's columns: its two knots' (p, v, a), ascending
    knot = [[0, 1, 2]] + [[6 + 3 * (w - 1) + i for i in range(3)]
                          for w in range(1, m)] + [[3, 4, 5]]
    for s_ in range(m):
        assert list(cols[s_]) == sorted(knot[s_] + knot[s_ + 1])
    seg = np.minimum(np.arange(SP) // K, m - 1)
    for dense, compact in ((apos, chains.pos), (avel, chains.vel),
                           (aacc, chains.acc)):
        c = _np(compact)
        assert c.shape == (B, SP, 6)
        back = np.zeros((B, SP, ndim), np.float32)
        for s_ in range(SP):
            back[:, s_, cols[seg[s_]]] = c[:, s_]
        assert not back[:, m * K:].any()  # padded rows stay zero
        np.testing.assert_array_equal(back, _np(dense))


def test_k3_launch_shape_and_supports():
    """The wrapper's mirror of the kernel's block shape and shared memory,
    and what supports() lets through to the kernel."""
    # bench: m = 6, K = 30: a segment on 32 lanes (spt 1) or 16 (spt 2)
    assert solve_cuda.spt_choices(30) == [1, 2, 4, 8, 16, 32]
    assert solve_cuda.spt_choices(100) == [4, 8, 16, 32, 64, 128]
    nt, smem = solve_cuda.launch_shape(6, 30, 1, False, 1)
    assert (nt, smem) == (192, 4 * (13 * 192 + 225 + 18 + 45 + 108 + 1
                                    + 96 + 64 + 36))
    assert solve_cuda.launch_shape(6, 30, 1, False, 2)[0] == 96
    assert solve_cuda.launch_shape(6, 30, 1, False, 4)[0] == 64  # 3P = 45
    assert solve_cuda.launch_shape(6, 30, 1, True, 2)[1] \
        > solve_cuda.launch_shape(6, 30, 1, False, 2)[1]
    assert solve_cuda.launch_shape(10, 30, 1, False, 1)[0] == 320
    tcfg = _tcfg()
    assert solve_cuda.supports((100, 100, 25), 184, 15, tcfg)
    assert solve_cuda.supports((200, 200, 25), 304, 27, tcfg)
    assert not solve_cuda.supports((100, 100, 25), 176, 15, tcfg)  # S > SP
    assert not solve_cuda.supports((100, 100, 25), 184, 15,
                                   _tcfg(accept_window=200))
    assert not solve_cuda.supports((100, 100, 25), 184, 15,
                                   _tcfg(step_rule="adaptive"))


@pytest.mark.parametrize("fn", [
    "solver.make_scenario", "convert.scenario_from_numpy",
    "convert.prediction_from_numpy", "predictor.stack_histories",
])
def test_constructors_default_to_the_card(fn):
    """The port's tensor constructors build on the card unless the caller
    asks for the CPU: their ``device`` keyword defaults to "cuda"."""
    import inspect

    from grad_traj_optimization_torch.search import predictor

    mods = dict(solver=tsolver, convert=convert, predictor=predictor)
    mod, name = fn.split(".")
    sig = inspect.signature(getattr(mods[mod], name))
    assert sig.parameters["device"].default == "cuda"


def test_plain_descent_matches_pallas_interpret(batch):
    """K3's plain version against the TPU kernel in interpret mode, on
    each package's own kernel inputs: equal n_accept, cost rtol 5e-3."""
    n = 6
    sub = jsolver.Scenario(*(x[:n] for x in batch["jscn"][:4]))
    tsub = batch["tscn"].map(lambda x: x[:n])
    jcfg, tcfg = JConfig(iters_step2=8), _tcfg(iters_step2=8)
    jk, _ = jsolver.kernel_inputs(sub, jcfg)
    _, jc, jn, jtr = solve_pallas.descend_fused(*jk, ((2, 8),), jcfg,
                                                interpret=True)
    tk, _ = tsolver.kernel_inputs(tsub, tcfg)
    calls = profiling.counter("plain.descend")
    _, tc, tn, ttr = solve_cuda.descend(*tk, ((2, 8),), tcfg)
    assert profiling.counter("plain.descend") == calls + 1
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=5e-3)
    np.testing.assert_allclose(_np(ttr), np.asarray(jtr), rtol=5e-3)


# ------------------------------------------------------ solve, end to end


@pytest.mark.parametrize("steps,iters", [((2,), 10), ((1, 2), 8)])
def test_solve_batch_short_budget_matches_jax(batch, steps, iters):
    """Short budgets before the f32 chaos horizon: after a collision-only
    step 1 (no smoothness term) sampled positions drift apart sooner, so
    the two-step schedule is held at 4 + 8 iterations."""
    kw = dict(iters_step1=4, iters_step2=iters)
    jsol = jsolver.solve_batch(batch["jscn"], cfg=JConfig(**kw), steps=steps,
                               record_trace=True)
    tsol = tsolver.solve_batch(batch["tscn"], cfg=_tcfg(**kw), steps=steps)
    ok = _lane_agreement(tsol, jsol)
    assert ok.all(), np.nonzero(~ok)
    np.testing.assert_allclose(_np(tsol.cost_trace),
                               np.asarray(jsol.cost_trace), rtol=5e-3)
    assert np.all(_np(tsol.status) == tsolver.STATUS_OK)


def test_solve_batch_full_budget_distribution(batch):
    jsol = jsolver.solve_batch(batch["jscn"], cfg=JConfig(), steps=(2,))
    tsol = tsolver.solve_batch(batch["tscn"], cfg=_tcfg(), steps=(2,))
    ok, stats = _distribution_ok(_np(tsol.cost), np.asarray(jsol.cost))
    assert ok, stats
    tr = _np(tsol.cost_trace)
    assert tr.shape == (B, 100) and np.all(np.diff(tr, axis=1) <= 0)


def test_solve_batch_shared_map(batch):
    """One map shared by the batch (dist leading dim 1) solves exactly as
    the same map copied per lane, and matches the JAX kernel's own
    shared-map path (interpret mode, the same chain formulation; lanes
    that cross obstacles on the shared map drift from the JAX vmap path's
    coefficient formulation within a few iterations)."""
    n = 6
    lv = batch["leaves"]
    tscn = convert.scenario_from_numpy(lv["dist"][:1], lv["origin"][:n],
                                       lv["resolution"][:n],
                                       lv["waypoints"][:n], device="cpu")
    tcfg = _tcfg(iters_step2=6)
    tsol = tsolver.solve_batch(tscn, cfg=tcfg)
    copied = tscn._replace(dist=tscn.dist.expand(n, *tscn.dist.shape[1:]))
    for a, b in zip(tsol, tsolver.solve_batch(copied, cfg=tcfg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jscn = jsolver.Scenario(dist=jnp.asarray(lv["dist"][:1]),
                            origin=jnp.asarray(lv["origin"][:n]),
                            resolution=jnp.asarray(lv["resolution"][:n]),
                            waypoints=jnp.asarray(lv["waypoints"][:n]))
    jsol = jsolver.solve_batch_kernel(jscn, cfg=JConfig(iters_step2=6),
                                      interpret=True)
    ok = _lane_agreement(tsol, jsol)
    assert ok.all(), np.nonzero(~ok)


def test_solve_single_matches_jax(batch):
    lv = batch["leaves"]
    i = 5
    jscn = jsolver.Scenario(*(jnp.asarray(lv[k][i]) for k in
                              ("dist", "origin", "resolution", "waypoints")))
    tscn = convert.scenario_from_numpy(*(lv[k][i] for k in (
        "dist", "origin", "resolution", "waypoints")), device="cpu")
    jsol = jsolver.solve(jscn, cfg=JConfig(iters_step2=10))
    tsol = tsolver.solve(tscn, cfg=_tcfg(iters_step2=10))
    assert int(tsol.n_accept) == int(jsol.n_accept)
    np.testing.assert_allclose(float(tsol.cost), float(jsol.cost), rtol=5e-3)
    np.testing.assert_allclose(_np(tsol.cost_trace),
                               np.asarray(jsol.cost_trace), rtol=5e-3)
    np.testing.assert_allclose(_np(tsol.coeff), np.asarray(jsol.coeff),
                               atol=2e-3)
    tm = tsolver.evaluate_solution(tsol)
    jm = jsolver.evaluate_solution(jsol)
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3,
                                   err_msg=k)


def test_make_scenario_matches_jax():
    mc, obs, wp = jfix.text_input_scenario()
    mc = MapConfig(origin=mc.origin, resolution=0.25, map_size=(10.0, 10.0,
                                                                4.0))
    mc_j = jfix.MapConfig(**dataclasses.asdict(mc))
    jscn = jsolver.make_scenario(wp, obs, mc_j)
    tscn = tsolver.make_scenario(wp, obs, mc, device="cpu")
    for a, b in zip(tscn, jscn[:4]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_min_clearance_matches_jax_lookup(batch):
    tsol = tsolver.solve_batch(batch["tscn"], cfg=_tcfg(iters_step2=10))
    clear = _np(tsolver.min_clearance(tsol, batch["tscn"], n=64))
    lv = batch["leaves"]
    for b in range(3):
        pts, _ = jpoly.sample_uniform(jnp.asarray(_np(tsol.coeff[b])),
                                      jnp.asarray(_np(tsol.T[b])), 64)
        d, _ = jsdf.distance_and_gradient(jnp.asarray(lv["dist"][b]),
                                          jnp.asarray(lv["origin"][b]),
                                          MAP.resolution, pts)
        np.testing.assert_allclose(clear[b], float(jnp.min(d)), atol=1e-4)


def test_divergence_falls_back_to_seed(batch):
    """A NaN field makes the cost NaN: status DIVERGED and dp = the seed,
    as in the JAX package."""
    lv = batch["leaves"]
    dist = lv["dist"][:2].copy()
    dist[1] = np.nan
    tscn = convert.scenario_from_numpy(dist, lv["origin"][:2],
                                       lv["resolution"][:2],
                                       lv["waypoints"][:2], device="cpu")
    jscn = jsolver.Scenario(*(jnp.asarray(np.asarray(x)) for x in (
        dist, lv["origin"][:2], lv["resolution"][:2], lv["waypoints"][:2])))
    tsol = tsolver.solve_batch(tscn, cfg=_tcfg(iters_step2=5))
    jsol = jsolver.solve_batch(jscn, cfg=JConfig(iters_step2=5))
    np.testing.assert_array_equal(_np(tsol.status), np.asarray(jsol.status))
    assert list(_np(tsol.status)) == [0, 1]
    _, dp0 = jqp.straight_line_d(jnp.asarray(lv["waypoints"][1]))
    np.testing.assert_allclose(_np(tsol.dp[1]), np.asarray(dp0), atol=1e-6)


def test_solution_to_numpy_roundtrip(batch):
    tsol = tsolver.solve_batch(
        batch["tscn"].map(lambda x: x[:2]),
        cfg=_tcfg(iters_step2=3))
    npsol = convert.solution_to_numpy(tsol)
    assert isinstance(npsol, tsolver.Solution)
    for a, b in zip(npsol, tsol):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, _np(b))


# ------------------------------------------- K3's launch limits, dispatch

#: shapes K3 cannot launch (blocks over MAX_THREADS or MAX_SMEM for every
#: samples-per-thread plan): (waypoints, n_samples, config keywords)
K3_REFUSED = tfix.K3_REFUSED_SHAPES


def _shape_scene(n_wp, n_samples, kw, cfg_kw=None):
    """Port and JAX configs and a 4-lane CPU batch of ``n_wp`` waypoints."""
    _, pts, valid, wps = jfix.random_scenarios(
        4, n_waypoints=n_wp, seed=9, map_cfg=MAP, max_obstacle_points=1024)
    origin = np.asarray(MAP.origin, np.float32)
    occ = jax.vmap(
        lambda p, v: jsdf.rasterize(p, jnp.asarray(origin), MAP.resolution,
                                    MAP.grid_shape, valid_mask=v)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    leaves = dict(
        dist=np.asarray(jsdf.edt_batch(occ, MAP.resolution, backend="jnp")),
        origin=np.broadcast_to(origin, (4, 3)).copy(),
        resolution=np.full((4,), MAP.resolution, np.float32),
        waypoints=wps.astype(np.float32))
    ckw = dict(n_samples=n_samples, **kw, **(cfg_kw or {}))
    return leaves, JConfig(**ckw), _tcfg(**ckw)


@pytest.mark.parametrize("case", list(K3_REFUSED))
def test_takes_k3_refuses_unlaunchable_shapes(case):
    """Each shape's plans all exceed a limit: the rule sends it to the
    per-iteration descent on both devices."""
    n_wp, n_samples, kw = K3_REFUSED[case]
    tcfg = _tcfg(n_samples=n_samples, **kw)
    m = n_wp - 1
    assert all(nt > solve_cuda.MAX_THREADS or smem > solve_cuda.MAX_SMEM
               for nt, smem in (solve_cuda.launch_shape(
                   m, n_samples, 1, tcfg.alpha_a != 0.0, s)
                   for s in solve_cuda.spt_choices(n_samples)))
    scn = convert.scenario_from_numpy(
        np.zeros((1, 4, 4, 4), np.float32), np.zeros((1, 3), np.float32),
        np.full((1,), 0.5, np.float32),
        np.zeros((1, n_wp, 3), np.float32), device="cpu")
    assert not tsolver.takes_k3(scn, tcfg)


@pytest.mark.parametrize("alpha_a", [0.0, 0.5], ids=["alpha_a0", "alpha_a"])
@pytest.mark.parametrize("window", [1, 128])
def test_supports_holds_the_launch_limits(alpha_a, window):
    """supports() is true exactly when some samples-per-thread plan fits
    MAX_THREADS and MAX_SMEM, over m = 2..43 segments and the documented
    sample counts; the bench shape and the 46-waypoint cap hold as before."""
    for K in (8, 30, 40, 64, 80, 128):
        cfg = _tcfg(n_samples=K, alpha_a=alpha_a, accept_window=window)
        for m in range(2, 44):
            fits = any(
                nt <= solve_cuda.MAX_THREADS and smem <= solve_cuda.MAX_SMEM
                for nt, smem in (solve_cuda.launch_shape(
                    m, K, window, alpha_a != 0.0, s)
                    for s in solve_cuda.spt_choices(K)))
            assert solve_cuda.supports((40, 40, 16), m * K, 3 * m - 3,
                                       cfg) == fits, (m, K)
    cfg = _tcfg(alpha_a=alpha_a, accept_window=window)
    assert solve_cuda.supports((100, 100, 25), 180, 15, cfg)
    assert not solve_cuda.supports((100, 100, 25), 45 * 30, 132, cfg)


def test_solve_batch_long_mission_many_samples_matches_jax():
    """31 waypoints at n_samples = 80, which K3 cannot launch, through
    the port's solve_batch (the per-iteration descent: no K3 call, one
    lookup an evaluation) against the JAX package's CPU solve at a
    10-iteration budget, by the short-budget rule on every lane."""
    leaves, jcfg, tcfg = _shape_scene(31, 80, {},
                                      dict(iters_step2=10))
    tscn = convert.scenario_from_numpy(**leaves, device="cpu")
    jscn = jsolver.Scenario(**{k: jnp.asarray(v) for k, v in leaves.items()})
    k3 = profiling.counter("plain.descend")
    tsol = tsolver.solve_batch(tscn, cfg=tcfg)
    assert profiling.counter("plain.descend") == k3
    jsol = jsolver.solve_batch(jscn, cfg=jcfg, record_trace=True)
    ok = _lane_agreement(tsol, jsol)
    assert ok.all(), np.nonzero(~ok)
    assert np.all(_np(tsol.status) == tsolver.STATUS_OK)


def test_cropped_batch_k3_refuses_raises():
    """A cropped batch of a shape K3 cannot launch raises the crop rule's
    ValueError on the CPU as on the card (never a CUDA error)."""
    leaves, _, tcfg = _shape_scene(31, 80, {})
    tscn = convert.scenario_from_numpy(**leaves, device="cpu")
    cropped = tsolver.crop_scenarios(tscn, tcfg)
    assert cropped.grid_offset is not None
    with pytest.raises(ValueError, match="grid_offset"):
        tsolver.solve_batch(cropped, cfg=tcfg)
