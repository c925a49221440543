"""PyTorch port, the per-iteration descent and the solver's dispatch:
``solver.solve_batch_fused``, the rule that sends a batch to K3 or to it,
``record_trace`` and ``parallel.mesh.sharded_solve_fused``, against the
JAX package on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it here: ``solve_batch_fused``
with the Pallas lookup in interpret mode, ``solve_batch`` and
``solve_kino_batch`` on their vmapped gather path.  Parity is the repo's
short-budget rule (tests/test_solve.py:383-420): equal ``n_accept``, cost
rtol 5e-3 and sampled positions within 1e-3 m.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu import solver as jsolver  # noqa: E402
from grad_traj_optimization_tpu.config import (  # noqa: E402
    MapConfig, OptimizerConfig as JConfig,
)
from grad_traj_optimization_tpu.core import poly as jpoly  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402

from grad_traj_optimization_torch import convert  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

#: the bench map's footprint at 0.5 m (a 40 x 40 x 16 grid)
MAP = MapConfig(origin=(-10.0, -10.0, 0.0), resolution=0.5,
                map_size=(20.0, 20.0, 8.0))
SHORT = dict(iters_step1=4, iters_step2=10)


def _np(t):
    return t.detach().cpu().numpy()


def _tcfg(**kw):
    return convert.config_from_jax(dataclasses.asdict(JConfig(**kw)))


def _agreement(tsol, jsol):
    """Per lane: (n_accept equal, cost rtol 5e-3, positions < 1e-3 m)."""
    tp, _ = tpoly.sample_uniform(tsol.coeff, tsol.T, 100)
    jp = jax.vmap(lambda c, T: jpoly.sample_uniform(c, T, 100)[0])(
        jsol.coeff, jsol.T)
    perr = np.abs(_np(tp) - np.asarray(jp)).max(axis=(1, 2))
    tc, jc = _np(tsol.cost), np.asarray(jsol.cost)
    return (_np(tsol.n_accept) == np.asarray(jsol.n_accept),
            np.abs(tc - jc) <= 5e-3 * np.abs(jc), perr < 1e-3)


def _scenes(leaves):
    """Both packages' Scenario batches from the same numpy leaves."""
    jscn = jsolver.Scenario(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jscn, convert.scenario_from_numpy(**leaves, device="cpu")


@pytest.fixture(scope="module")
def small():
    """tests/test_solve.py's two-lane small scene (``_small_scene``: a wall
    across y = 0 with a gap at |x| < 0.6 m, five waypoints through it; the
    second lane shifted by (0.15, 0, 0.1) m), the field by the JAX
    package's EDT."""
    map_cfg = MapConfig(origin=(-5.0, -5.0, 0.0), resolution=0.25,
                        map_size=(10.0, 10.0, 4.0))
    obss = np.array([(x, 0.0, z)
                     for x in np.arange(-2.0, 2.0, map_cfg.resolution)
                     for z in np.arange(0.1, 4.0, map_cfg.resolution)
                     if abs(x) > 0.6])
    wp = np.array([[0.0, -3.0, 2.0], [0.3, -1.5, 2.0], [0.0, 0.0, 2.0],
                   [-0.3, 1.5, 2.0], [0.0, 3.0, 2.0]])
    scn = jsolver.make_scenario(wp, obss, map_cfg)
    leaves = dict(
        dist=np.stack([np.asarray(scn.dist)] * 2),
        origin=np.tile(np.asarray(scn.origin), (2, 1)),
        resolution=np.full((2,), map_cfg.resolution, np.float32),
        waypoints=np.stack([wp, wp + np.array([0.15, 0.0, 0.1])]).astype(
            np.float32),
    )
    return (*_scenes(leaves), leaves)


def _random_leaves(n, n_waypoints, seed):
    _, pts, valid, wps = jfix.random_scenarios(
        n, n_waypoints=n_waypoints, seed=seed, map_cfg=MAP,
        max_obstacle_points=2048)
    origin = np.asarray(MAP.origin, np.float32)
    occ = jax.vmap(
        lambda p, v: jsdf.rasterize(p, jnp.asarray(origin), MAP.resolution,
                                    MAP.grid_shape, valid_mask=v)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    return dict(
        dist=np.array(jsdf.edt_batch(occ, MAP.resolution, backend="jnp")),
        origin=np.tile(origin, (n, 1)),
        resolution=np.full((n,), MAP.resolution, np.float32),
        waypoints=wps.astype(np.float32))


@pytest.fixture(scope="module")
def bench():
    """Four bench-style scenarios (seven waypoints) and four with 46
    waypoints (num_dp 135, which K3 does not take)."""
    return dict(short=_random_leaves(4, 7, seed=4),
                long=_random_leaves(4, 46, seed=9))


# ------------------------------------------------ the per-iteration solve


@pytest.mark.parametrize("ref", ["fused-interpret", "gather"])
def test_solve_batch_fused_matches_jax(small, ref):
    """On the small scene, steps (1, 2) at 4 + 10 iterations: against the
    JAX package's solve_batch_fused (Pallas lookup in interpret mode,
    cost rtol 5e-3 and positions 1e-3 m, tests/test_solve.py's own rule
    for it), and against its gather path (solve_batch at the default
    lookup) by the short-budget rule, n_accept included.  The port's run
    looks up once an evaluation by K2's plain version."""
    jscn, tscn, _ = small
    calls = profiling.counter("plain.trilinear_batch")
    k3 = profiling.counter("plain.descend")
    tsol = tsolver.solve_batch_fused(
        tscn, cfg=_tcfg(lookup_mode="fused", **SHORT), steps=(1, 2))
    assert profiling.counter("plain.trilinear_batch") == calls + 5 + 11
    assert profiling.counter("plain.descend") == k3
    if ref == "gather":
        jsol = jsolver.solve_batch(jscn, cfg=JConfig(**SHORT), steps=(1, 2))
    else:
        jsol = jsolver.solve_batch_fused(
            jscn, cfg=JConfig(lookup_mode="fused", **SHORT), steps=(1, 2),
            interpret=True)
    same_n, cost_ok, pos_ok = _agreement(tsol, jsol)
    assert (cost_ok & pos_ok).all(), (_np(tsol.cost), np.asarray(jsol.cost))
    if ref == "gather":
        assert same_n.all()
    np.testing.assert_array_equal(_np(tsol.status), np.asarray(jsol.status))


@pytest.mark.parametrize("case", [
    "adaptive", "accept_window=200", "46 waypoints", "shared map"])
def test_solve_batch_takes_what_k3_does_not(bench, small, case):
    """Batches that K3 rejects, and a shared map with lookup_mode="fused",
    through the port's solve_batch (the per-iteration descent: no K3
    call, one lookup an evaluation) against the JAX package's solve_batch
    on the CPU, by the short-budget rule on every lane.  The shared map is
    the small scene's, which both its lanes were made for (on one bench
    map the other bench lanes start inside obstacles, and there two of
    four part within 6 iterations between any two runs: the port's
    float32, its own float64 and the JAX package's float32)."""
    leaves = bench["long" if case == "46 waypoints" else "short"]
    kw = {"adaptive": dict(step_rule="adaptive"),
          "accept_window=200": dict(accept_window=200),
          "46 waypoints": {},
          "shared map": dict(lookup_mode="fused")}[case]
    if case == "shared map":
        leaves = dict(small[2], dist=small[2]["dist"][:1])
    jscn, tscn = _scenes(leaves)
    tcfg = _tcfg(iters_step2=10, **kw)
    assert not tsolver.takes_k3(tscn, tcfg)
    calls = profiling.counter("plain.trilinear_batch")
    k3 = profiling.counter("plain.descend")
    tsol = tsolver.solve_batch(tscn, cfg=tcfg)
    assert profiling.counter("plain.trilinear_batch") == calls + 11
    assert profiling.counter("plain.descend") == k3
    jsol = jsolver.solve_batch(jscn, cfg=JConfig(iters_step2=10, **kw))
    same_n, cost_ok, pos_ok = _agreement(tsol, jsol)
    assert (same_n & cost_ok & pos_ok).all(), (
        same_n, cost_ok, pos_ok, _np(tsol.cost), np.asarray(jsol.cost))
    assert np.all(_np(tsol.status) == tsolver.STATUS_OK)


def _knots(leaves):
    """Knot states from the waypoints: positions, seeded velocities and
    accelerations (numpy, from a seed), the waypoints' segment times."""
    wps = leaves["waypoints"]
    rng = np.random.default_rng(12)
    vel = rng.uniform(-0.5, 0.5, wps.shape).astype(np.float32)
    acc = rng.uniform(-0.2, 0.2, wps.shape).astype(np.float32)
    vel[:, [0, -1]] = 0.0
    acc[:, [0, -1]] = 0.0
    seg = np.linalg.norm(np.diff(wps, axis=1), axis=-1)
    times = (seg / 1.8 + 0.3).astype(np.float32)
    return wps, vel, acc, times


def test_solve_kino_batch_adaptive_matches_jax(bench):
    """solve_kino_batch with step_rule="adaptive" (which K3 does not take)
    through the per-iteration descent with the Hermite seed, against the
    JAX package's kino fallback, by the short-budget rule."""
    leaves = bench["short"]
    args = (leaves["dist"], leaves["origin"], leaves["resolution"],
            *_knots(leaves))
    calls = profiling.counter("plain.descend")
    t = tsolver.solve_kino_batch(
        torch.as_tensor(args[0]), *args[1:],
        cfg=_tcfg(iters_step2=10, step_rule="adaptive"))
    assert profiling.counter("plain.descend") == calls
    j = jsolver.solve_kino_batch(
        *(jnp.asarray(x) for x in args),
        cfg=JConfig(iters_step2=10, step_rule="adaptive"))
    same_n, cost_ok, pos_ok = _agreement(t, j)
    assert (same_n & cost_ok & pos_ok).all(), (same_n, cost_ok, pos_ok)
    np.testing.assert_array_equal(_np(t.status), np.asarray(j.status))


def test_dual_race_on_the_per_iteration_path(bench):
    """seed_mode="dual" races its arms on the per-iteration descent as on
    K3: the per-lane better of the two single-seed runs."""
    _, tscn = _scenes(bench["short"])
    kw = dict(lookup_mode="fused", iters_step2=8, dual_ms_iters=6)
    dual = tsolver.solve_batch_fused(tscn, cfg=_tcfg(seed_mode="dual", **kw))
    arms = [tsolver.solve_batch_fused(tscn, cfg=c) for c in
            tsolver._dual_arm_cfgs(_tcfg(seed_mode="dual", **kw))]
    want = torch.minimum(arms[0].cost, arms[1].cost)
    torch.testing.assert_close(dual.cost, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="polish"):
        tsolver.solve_batch_fused(
            tscn, cfg=_tcfg(seed_mode="dual", polish_iters=2, **kw))


# ------------------------------------------------------------- dispatch


class _Routed(Exception):
    pass


def _stub(name):
    def stub(*a, **k):
        raise _Routed(name)
    return stub


@pytest.mark.parametrize("kw,route", [
    ({}, "solve_batch_kernel"),
    (dict(lookup_mode="fused"), "solve_batch_fused"),
    (dict(lookup_mode="mxu"), "solve_batch_fused"),
    (dict(step_rule="adaptive"), "solve_batch_fused"),
    (dict(accept_window=200), "solve_batch_fused"),
    (dict(n_waypoints=46), "solve_batch_fused"),
], ids=["auto", "fused", "mxu", "adaptive", "window200", "46wp"])
def test_solve_batch_dispatch(monkeypatch, bench, kw, route):
    """The JAX package's test_solve_batch_dispatches_to_fused for the
    port: a supported "auto" batch goes to K3, lookup_mode "fused" (or
    any other mode) and each config K3 rejects to solve_batch_fused; solve
    and solve_kino_batch follow the same rule (the kino descent's
    per-iteration function stands for solve_batch_fused there)."""
    kw = dict(kw)
    long = kw.pop("n_waypoints", None) is not None
    leaves = bench["long" if long else "short"]
    _, tscn = _scenes(leaves)
    cfg = _tcfg(**kw)
    monkeypatch.setattr(tsolver, "solve_batch_kernel",
                        _stub("solve_batch_kernel"))
    monkeypatch.setattr(tsolver, "solve_batch_fused",
                        _stub("solve_batch_fused"))
    monkeypatch.setattr(tsolver, "_solve_per_iteration",
                        _stub("solve_batch_fused"))
    for call in (lambda: tsolver.solve_batch(tscn, cfg=cfg),
                 lambda: tsolver.solve(tscn.map(lambda x: x[0]), cfg=cfg),
                 lambda: tsolver.solve_kino_batch(
                     tscn.dist, tscn.origin, tscn.resolution,
                     *(torch.as_tensor(x) for x in _knots(leaves)),
                     cfg=cfg)):
        with pytest.raises(_Routed) as e:
            call()
        assert str(e.value) == route


def test_cropped_batch_never_takes_the_per_iteration_path(monkeypatch,
                                                          small):
    """A cropped batch goes to K3 under a supported "auto" config and
    raises ValueError under any other, before the per-iteration path;
    solve_batch_fused itself refuses it."""
    _, tscn, _ = small
    cropped = tsolver.crop_scenarios(tscn, _tcfg(), margin=0.0)
    assert cropped.grid_offset is not None
    monkeypatch.setattr(tsolver, "solve_batch_kernel",
                        _stub("solve_batch_kernel"))
    monkeypatch.setattr(tsolver, "_solve_per_iteration",
                        _stub("solve_batch_fused"))
    with pytest.raises(_Routed, match="solve_batch_kernel"):
        tsolver.solve_batch(cropped, cfg=_tcfg())
    for kw in (dict(lookup_mode="fused"), dict(step_rule="adaptive")):
        with pytest.raises(ValueError, match="exact-cropped"):
            tsolver.solve_batch(cropped, cfg=_tcfg(**kw))
    with pytest.raises(ValueError, match="exact-cropped"):
        tsolver.solve_batch_fused(cropped, cfg=_tcfg(lookup_mode="fused"))


# ---------------------------------------------------------- record_trace


def test_record_trace_per_iteration_path(small):
    """The JAX package's record_trace on the per-iteration path: False
    gives a NaN trace of shape (B, total iterations), True the monotone
    envelope, within 5e-3 of the JAX package's recorded trace; the same
    iterates either way.  solve records by default, solve_batch not."""
    jscn, tscn, _ = small
    tcfg = _tcfg(lookup_mode="fused", **SHORT)
    off = tsolver.solve_batch(tscn, cfg=tcfg, steps=(1, 2))
    on = tsolver.solve_batch(tscn, cfg=tcfg, steps=(1, 2),
                             record_trace=True)
    joff = jsolver.solve_batch_fused(
        jscn, cfg=JConfig(lookup_mode="fused", **SHORT), steps=(1, 2),
        interpret=True)
    jon = jsolver.solve_batch_fused(
        jscn, cfg=JConfig(lookup_mode="fused", **SHORT), steps=(1, 2),
        record_trace=True, interpret=True)
    assert off.cost_trace.shape == tuple(joff.cost_trace.shape) == (2, 14)
    assert np.isnan(_np(off.cost_trace)).all()
    assert np.isnan(np.asarray(joff.cost_trace)).all()
    np.testing.assert_allclose(_np(on.cost_trace), np.asarray(jon.cost_trace),
                               rtol=5e-3)
    for a, b in zip(on._replace(cost_trace=on.cost), off._replace(
            cost_trace=off.cost)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    one = tsolver.solve(tscn.map(lambda x: x[0]), cfg=tcfg, steps=(1, 2))
    assert one.cost_trace.shape == (14,)
    assert np.isfinite(_np(one.cost_trace)).all()


def test_record_trace_k3_path(small):
    """On the K3 path the kernel records its trace whatever record_trace
    says, as the JAX package's kernel path (its solve_batch_kernel takes
    no record_trace)."""
    _, tscn, _ = small
    tcfg = _tcfg(**SHORT)
    assert tsolver.takes_k3(tscn, tcfg)
    off = tsolver.solve_batch(tscn, cfg=tcfg, steps=(1, 2))
    on = tsolver.solve_batch(tscn, cfg=tcfg, steps=(1, 2),
                             record_trace=True)
    assert off.cost_trace.shape == (2, 14)
    assert np.isfinite(_np(off.cost_trace)).all()
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------- the mesh


def test_sharded_solve_fused_two_ranks(tmp_path):
    """sharded_solve_fused on two gloo CPU ranks
    (scripts/multihost_worker_torch.py's ``fused`` case): each rank's
    lanes bitwise its own solve_batch_fused, for a whole batch and for
    one placed by shard_scenarios, and the gathered lanes bitwise
    solve_batch_fused of each rank's rows here."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "multihost_worker_torch.py")
    spec = importlib.util.spec_from_file_location("multihost_worker_torch",
                                                  path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    result = worker.run_ranks(2, "fused", tmp_path, "cpu")
    assert result["world"] == 2
    for c in result["checks"]:
        assert c == {"fused_rows_bitwise": True,
                     "fused_shard_scenarios_bitwise": True}, c
    z = worker.solve_inputs()
    with np.load(tmp_path / "outputs.npz") as out:
        got = tsolver.Solution(*(torch.as_tensor(out[k])
                                 for k in tsolver.Solution._fields))
    assert np.isfinite(_np(got.cost_trace)).all()
    for r in range(2):
        sl = slice(8 * r, 8 * (r + 1))
        want = tsolver.solve_batch_fused(
            convert.scenario_from_numpy(
                z["solve_dist"][sl], z["solve_origin"][sl],
                z["solve_res"][sl], z["solve_wps"][sl], device="cpu"),
            cfg=worker.FUSED_CFG, record_trace=True)
        for a, w in zip(got, want):
            torch.testing.assert_close(a[sl], w, rtol=0, atol=0)
