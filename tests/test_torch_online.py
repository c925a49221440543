"""PyTorch port, online surface on the CPU: the exact host A* rung of
``plan_batch``, ``sdf.edt_update``, ``SolveServer`` and ``MissionServer``,
each against the JAX package on the same numpy-seeded inputs.

Every ``Future.result`` has a timeout and every server is shut down in a
``finally``, so a hang fails the test instead of holding the run.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu import native as jnative  # noqa: E402
from grad_traj_optimization_tpu import pipeline as jpipe  # noqa: E402
from grad_traj_optimization_tpu import serving as jserving  # noqa: E402
from grad_traj_optimization_tpu import solver as jsolver  # noqa: E402
from grad_traj_optimization_tpu.config import OptimizerConfig  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402

from grad_traj_optimization_torch import convert, native  # noqa: E402
from grad_traj_optimization_torch import pipeline as tpipe  # noqa: E402
from grad_traj_optimization_torch import serving as tserving  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.fields import sdf as tsdf  # noqa: E402

TIMEOUT = 120  # seconds a future may take before the test fails


def _np(t):
    return t.detach().cpu().numpy()


def _tcfg(cfg):
    return convert.config_from_jax(dataclasses.asdict(cfg))


def _cases(n, seed):
    """n random_search_case missions as numpy batches, at rest."""
    rng = np.random.default_rng(seed)
    cases = []
    while len(cases) < n:
        c = jfix.random_search_case(rng)
        if c is not None:
            cases.append(c)
    z = np.zeros(3)
    return (np.stack([np.asarray(c[0]) for c in cases]),
            np.stack([c[1] for c in cases]).astype(np.float32), cases[0][2],
            np.stack([np.concatenate([c[3], z]) for c in cases]
                     ).astype(np.float32),
            np.stack([np.concatenate([c[4], z]) for c in cases]
                     ).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    if not jnative.available():
        pytest.skip("the JAX package's native engine does not build here")
    native.load()


# ------------------------------------------------------------ host rung


@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_host_rung_matches_jax(engine, shared):
    """plan_batch(host_fallback=True) on the cases of
    tests/test_search.py:962 (a starved beam): equal n_host_fallback,
    recovered lanes, reached and ok, knots equal to float32 rounding of
    the same float64 branch (the recovered lanes' knots bitwise), and the
    refined costs to the short-budget rule (rtol 5e-3)."""
    dists, origins, res, starts, goals = _cases(4, seed=5)
    if shared:  # every mission on the first field
        dists = dists[:1]
    cfg = OptimizerConfig(iters_step2=10)
    kw = dict(beam=2, max_iters=3, retries=0, lookup="gather",
              stretches=(1.0,))
    base = jpipe.plan_batch(dists, origins, res, starts, goals, cfg=cfg,
                            **kw)
    j = jpipe.plan_batch(dists, origins, res, starts, goals, cfg=cfg,
                         host_fallback=True, **kw)
    t = tpipe.plan_batch(torch.as_tensor(dists), origins, res, starts, goals,
                         cfg=_tcfg(cfg), host_fallback=True, **kw)
    assert j.n_host_fallback >= 1
    assert t.n_host_fallback == j.n_host_fallback
    np.testing.assert_array_equal(t.reached, j.reached)
    np.testing.assert_array_equal(t.ok, j.ok)
    rec = np.where(j.reached & ~base.reached)[0]
    assert len(rec) == j.n_host_fallback
    for a, b in zip(t.search[:4], j.search[:4]):
        np.testing.assert_array_equal(_np(a)[rec], np.asarray(b)[rec])
    assert np.isinf(_np(t.search.cost)[rec]).all()
    np.testing.assert_allclose(_np(t.solution.cost),
                               np.asarray(j.solution.cost), rtol=5e-3)
    assert set(t.rung_ms) == {"download", "search", "refine"}


def test_host_rung_decides_on_the_float32_field(engine):
    """The boundary the JAX package's bit-packed mask gets wrong
    (ADVICE.md): res 0.1, walls two cells either side of a corridor, so
    its only safe cells hold exactly float32(0.2) > 0.2 with margin 0.2.
    The engine thresholds in double and finds the corridor on the f32
    field (the two-level mask finds nothing); the port's rung, which
    passes the f32 field, recovers the lane with that very branch."""
    res = 0.1
    occ = torch.zeros((25, 60, 12))
    occ[10] = 1.0
    occ[14] = 1.0
    dist = tsdf.edt(occ, res)
    assert float(dist[12, 30, 6]) == float(np.float32(0.2)) > 0.2
    origin = np.zeros(3, np.float32)
    s = np.array([1.25, 0.55, 0.65, 0, 0, 0], np.float32)
    g = np.array([1.25, 5.45, 0.65, 0, 0, 0], np.float32)
    f32 = native.kino_search(dist.numpy(), origin, res, s, g, margin=0.2)
    two = np.where(dist.numpy() > np.float32(0.2), np.float32(1e4),
                   np.float32(0.0))
    assert f32[4] and not native.kino_search(two, origin, res, s, g,
                                             margin=0.2)[4]
    cfg = _tcfg(OptimizerConfig(iters_step2=5))
    r = tpipe.plan_batch(dist[None], origin, res, s[None], g[None], cfg=cfg,
                         beam=4, max_iters=4, retries=0, stretches=(1.0,),
                         host_fallback=True, margin=0.2)
    assert r.n_host_fallback == 1 and r.reached[0]
    from grad_traj_optimization_torch import replan

    K = r.search.pos.shape[1]
    want = replan._pad_knots_fixed(*f32[:4], k_to=K)
    for a, b in zip(r.search[:4], want):
        np.testing.assert_array_equal(_np(a[0]), b.astype(np.float32))


def test_host_rung_needs_the_engine(monkeypatch):
    """host_fallback=True with no buildable engine raises; it never skips
    the rung."""
    def broken():
        raise RuntimeError("no engine")

    monkeypatch.setattr(native, "load", broken)
    dists, origins, res, starts, goals = _cases(2, seed=5)
    with pytest.raises(RuntimeError, match="no engine"):
        tpipe.plan_batch(torch.as_tensor(dists), origins, res, starts, goals,
                         host_fallback=True, beam=2, max_iters=2)
    with pytest.raises(RuntimeError, match="no engine"):
        tserving.MissionServer(dists[0], origins[0], res, host_fallback=True,
                               device="cpu")


def test_host_rung_skipped_with_prediction(engine):
    """With obstacle_pred the rung is skipped, as in the JAX package (the
    exact A* sees the static field only)."""
    dists, origins, res, starts, goals = _cases(2, seed=5)
    from grad_traj_optimization_torch.search import predictor

    pred = predictor.fit_const_vel(
        torch.tensor([[[-30.0, -30.0, 1.0], [-30.0, -30.0, 1.0]]]),
        torch.tensor([[-0.5, 0.0]]), torch.tensor([[0.5, 0.5, 0.5]]))
    kw = dict(beam=2, max_iters=3, retries=0, stretches=(1.0,),
              cfg=_tcfg(OptimizerConfig(iters_step2=3)))
    t = tpipe.plan_batch(torch.as_tensor(dists), origins, res, starts, goals,
                         obstacle_pred=pred, host_fallback=True, **kw)
    assert t.n_host_fallback == 0 and t.rung_ms == {}


# ------------------------------------------------------------ edt_update


@pytest.mark.parametrize("mode,out_margin", [
    ("add", None), ("add", "max"), ("add", 4), ("reset", None)])
def test_edt_update_matches_jax_bitwise(mode, out_margin):
    """Both modes bitwise the JAX package's; "add" with whole-grid or
    max-distance influence bitwise a full edt of the new occupancy."""
    rng = np.random.default_rng(3)
    res = 0.2
    for _ in range(2):
        occ0 = (rng.random((32, 28, 16)) < 0.012).astype(np.float32)
        d0 = np.asarray(jsdf.edt(jnp.asarray(occ0), res, backend="jnp"))
        lo, hi = (8, 6, 3), (20, 18, 12)
        occ1 = occ0.copy()
        for a in rng.integers(lo, hi, size=(5, 3)):
            occ1[tuple(a)] = 1.0
        if mode == "reset":
            occ1[10:14, 8:12, 4:8] = 0.0
        m = out_margin
        if m == "max":
            m = int(np.ceil(float(d0.max()) / res)) + 1
        j = np.asarray(jsdf.edt_update(d0, jnp.asarray(occ1), res, lo, hi,
                                       mode=mode, out_margin=m))
        t = tsdf.edt_update(torch.tensor(d0), torch.tensor(occ1), res, lo,
                            hi, mode=mode, out_margin=m)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(_np(t), j)
        if mode == "add" and out_margin != 4:
            full = tsdf.edt(torch.tensor(occ1), res)
            assert torch.equal(t, full)


def test_edt_update_edges():
    """An empty box returns the field; an unknown mode raises."""
    d0 = torch.rand((8, 8, 4)) * 3
    occ = torch.zeros((8, 8, 4))
    out = tsdf.edt_update(d0, occ, 0.2, (3, 3, 2), (3, 5, 4))
    assert torch.equal(out, d0) and out.data_ptr() != d0.data_ptr()
    with pytest.raises(ValueError, match="mode"):
        tsdf.edt_update(d0, occ, 0.2, (0, 0, 0), (2, 2, 2), mode="bogus")


# ------------------------------------------------------------ SolveServer


@pytest.mark.parametrize("max_batch,floor", [(256, 128), (1024, 128),
                                             (8, 2), (1024, 1)])
def test_bucket_groups_match_jax(max_batch, floor):
    """The pow2 decomposition (the K3 launches a batch costs and its pad
    lanes) equals the JAX package's for every n in 1..1024."""
    j = jserving.SolveServer(max_batch=max_batch, bucket_floor=floor)
    t = tserving.SolveServer(max_batch=max_batch, bucket_floor=floor,
                             device="cpu")
    try:
        for n in range(1, 1025):
            assert t._bucket_groups(n) == j._bucket_groups(n), n
            assert t._bucket(n) == j._bucket(n)
    finally:
        j.shutdown()
        t.shutdown()


def test_server_stats_summary_matches_jax():
    rng = np.random.default_rng(0)
    st = dict(n_requests=9, n_batches=3, n_padded_lanes=4,
              batch_sizes=[4, 3, 2], wait_ms=list(rng.random(9)),
              total_ms=list(rng.random(9) * 5),
              assemble_ms=list(rng.random(3)),
              device_ms=list(rng.random(3)), solve_ms=list(rng.random(3)),
              download_ms=list(rng.random(3)))
    js = jserving.ServerStats(**st).summary()
    ts = tserving.ServerStats(**st).summary()
    for k, v in js.items():
        assert ts[k] == v, k
    assert tserving.ServerStats().summary()["mean_batch"] == 0.0


def _small_scene():
    from grad_traj_optimization_torch.config import MapConfig

    mc = MapConfig(origin=(-5.0, -5.0, 0.0), resolution=0.25,
                   map_size=(10.0, 10.0, 4.0))
    obss = np.array([[0.0, 0.1 * k, z] for k in range(-5, 6)
                     for z in np.arange(0.1, 4.0, 0.25)])
    wp = np.array([[-3.0, -3.0, 2.0], [-1.0, -1.5, 2.0], [1.0, 1.5, 2.0],
                   [3.0, 3.0, 2.0]])
    return mc, obss, wp


def _served(server, scns):
    futs = [server.submit(s) for s in scns]
    return [f.result(timeout=TIMEOUT) for f in futs]


@pytest.mark.parametrize("floor", [128, 2], ids=["one_group", "groups"])
def test_solve_server_matches_direct_solve_and_jax(floor):
    """Six requests that share one field tensor, served in one batch:
    statistics and groups as the JAX package's server, each Solution
    (numpy, batch axis stripped) equal to the port's direct solve of its
    padded group, and its coefficients within 2e-4 of the JAX package's
    served lane.  A mismatching scenario is rejected at submit."""
    mc, obss, wp = _small_scene()
    cfg = OptimizerConfig(iters_step1=2, iters_step2=6)
    tscn = tsolver.make_scenario(wp, obss, mc, device="cpu")
    jscn = jsolver.make_scenario(wp, obss, mc)
    rng = np.random.default_rng(1)
    wps = []
    for _ in range(6):
        w = wp.copy()
        w[1:-1, :2] += rng.uniform(-0.1, 0.1, (len(wp) - 2, 2))
        wps.append(w.astype(np.float32))
    tscns = [tscn._replace(waypoints=torch.as_tensor(w)) for w in wps]
    jscns = [jscn._replace(waypoints=jnp.asarray(w)) for w in wps]
    kw = dict(max_batch=8, max_wait_ms=200.0, bucket_floor=floor)
    t_srv = tserving.SolveServer(cfg=_tcfg(cfg), device="cpu", **kw)
    j_srv = jserving.SolveServer(cfg=cfg, **kw)
    try:
        tsols = _served(t_srv, tscns)
        jsols = _served(j_srv, jscns)
        with pytest.raises(ValueError, match="contract"):
            t_srv.submit(tscn._replace(waypoints=torch.as_tensor(
                np.vstack([wp, wp[-1] + 0.5]), dtype=torch.float32)))
    finally:
        t_srv.shutdown()
        j_srv.shutdown()
    ts, js = t_srv.stats, j_srv.stats
    assert ts.n_batches == js.n_batches == 1
    assert (ts.n_requests, ts.n_padded_lanes, ts.batch_sizes) == (
        js.n_requests, js.n_padded_lanes, js.batch_sizes)
    groups = t_srv._bucket_groups(6)
    assert len(groups) == (2 if floor == 2 else 1)
    lanes = tscns + [tscns[-1]] * (sum(groups) - 6)
    ofs = 0
    for g in groups:
        sub = lanes[ofs:ofs + g]
        direct = tsolver.solve_batch(
            tsolver.Scenario(
                dist=tscn.dist[None],
                origin=tscn.origin.expand(g, 3),
                resolution=tscn.resolution.expand(g),
                waypoints=torch.stack([s.waypoints for s in sub])),
            cfg=_tcfg(cfg))
        for i in range(min(g, 6 - ofs)):
            sol = tsols[ofs + i]
            assert isinstance(sol.coeff, np.ndarray)
            assert sol.coeff.shape == (len(wp) - 1, 3, 6)
            for a, b in zip(sol, direct):
                np.testing.assert_array_equal(a, _np(b[i]))
        ofs += g
    # against the JAX package's served lanes: the short-budget rule
    # (equal n_accept, cost rtol 5e-3, sampled positions within 1e-3 m)
    for ts_, js_ in zip(tsols, jsols):
        assert int(ts_.status) == int(js_.status) == 0
        assert int(ts_.n_accept) == int(js_.n_accept)
        np.testing.assert_allclose(ts_.cost, np.asarray(js_.cost),
                                   rtol=5e-3)
        tp, _ = tpoly.sample_uniform(torch.as_tensor(ts_.coeff),
                                     torch.as_tensor(ts_.T), 100)
        jp, _ = tpoly.sample_uniform(torch.as_tensor(np.asarray(js_.coeff)),
                                     torch.as_tensor(np.asarray(js_.T)), 100)
        assert float((tp - jp).abs().max()) < 1e-3


def test_solve_server_own_fields_and_errors():
    """Requests holding distinct field tensors stack per lane; a batch
    that fails resolves every future with the error and the server goes
    on serving."""
    mc, obss, wp = _small_scene()
    cfg = _tcfg(OptimizerConfig(iters_step2=4))
    scn = tsolver.make_scenario(wp, obss, mc, device="cpu")
    scns = [scn._replace(dist=scn.dist.clone()) for _ in range(3)]
    srv = tserving.SolveServer(cfg=cfg, max_batch=4, max_wait_ms=100.0,
                               device="cpu")
    try:
        sols = _served(srv, scns)
        direct = tsolver.solve(scn, cfg=cfg)
        for s in sols:
            np.testing.assert_allclose(s.coeff, _np(direct.coeff),
                                       atol=1e-5)
        bad = scn._replace(waypoints=torch.full_like(scn.waypoints,
                                                     float("nan")),
                           origin=torch.zeros(2))
        with pytest.raises(Exception):
            srv.submit(bad).result(timeout=TIMEOUT)
        assert int(srv.solve(scn, timeout=TIMEOUT).status) == 0
    finally:
        srv.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit(scn)


# ---------------------------------------------------------- MissionServer


def test_mission_server_end_to_end(engine):
    """As tests/test_solve.py:1058, with the host rung on: concurrent
    missions batch through plan_batch; each future resolves to its own
    numpy solution and flags, equal to the port's direct plan_batch of
    the same padded bucket, with reached flags equal to the JAX package's
    server."""
    dists, origins, res, starts, goals = _cases(1, seed=23)
    dist, origin = dists[0], origins[0]
    cfg = OptimizerConfig(iters_step2=8)
    kw = dict(max_batch=4, max_wait_ms=200.0, beam=16, max_iters=10,
              retries=0, lookup="gather", stretches=(1.0,))
    s6 = [starts[0] + np.array([0, 0.1 * i, 0, 0, 0, 0], np.float32)
          for i in range(3)]
    t_srv = tserving.MissionServer(dist, origin, res, cfg=_tcfg(cfg),
                                   host_fallback=True, device="cpu", **kw)
    j_srv = jserving.MissionServer(dist, origin, res, cfg=cfg,
                                   host_fallback=True, **kw)
    try:
        tout = [f.result(timeout=TIMEOUT)
                for f in [t_srv.submit(s, goals[0]) for s in s6]]
        jout = [f.result(timeout=TIMEOUT)
                for f in [j_srv.submit(s, goals[0]) for s in s6]]
    finally:
        t_srv.shutdown()
        j_srv.shutdown()
    assert t_srv.stats.n_requests == 3 and t_srv.stats.n_batches == 1
    assert t_srv.stats.n_padded_lanes == 1
    assert sum(o["reached"] for o in tout) >= 2
    assert [o["reached"] for o in tout] == [o["reached"] for o in jout]
    plan_kw = {k: v for k, v in kw.items()
               if k not in ("max_batch", "max_wait_ms")}
    direct = tpipe.plan_batch(
        torch.as_tensor(dist)[None], origin, res,
        np.stack(s6 + [s6[-1]]), np.stack([goals[0]] * 4), cfg=_tcfg(cfg),
        host_fallback=True, **plan_kw)
    for i, o in enumerate(tout):
        assert o["solution"].coeff.ndim == 3  # batch axis stripped
        assert o["reached"] == bool(direct.reached[i])
        assert o["ok"] == bool(direct.ok[i])
        np.testing.assert_array_equal(o["solution"].coeff,
                                      _np(direct.solution.coeff[i]))


def test_solve_server_under_thread_stress():
    """16 client threads (more than this host's cores) submit 8 requests
    each while the interpreter switches threads every microsecond: every
    future resolves to its own lane (its waypoints' endpoints), the stats
    count each request once, and the dispatch thread ends on shutdown."""
    import sys
    import threading

    mc, obss, wp = _small_scene()
    cfg = _tcfg(OptimizerConfig(iters_step2=1))
    scn = tsolver.make_scenario(wp, obss, mc, device="cpu")
    srv = tserving.SolveServer(cfg=cfg, max_batch=32, max_wait_ms=2.0,
                               device="cpu")
    results, errors = {}, []
    old = sys.getswitchinterval()

    def client(k):
        try:
            for i in range(8):
                w = scn.waypoints.clone()
                w[-1, 2] = 1.0 + 0.01 * (8 * k + i)
                fut = srv.submit(scn._replace(waypoints=w))
                results[(k, i)] = (float(w[-1, 2]), fut)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        got = {key: (z, f.result(timeout=TIMEOUT))
               for key, (z, f) in results.items()}
    finally:
        sys.setswitchinterval(old)
        srv.shutdown(wait=False)
        srv._worker.join(timeout=TIMEOUT)
    assert not srv._worker.is_alive()
    assert not errors and len(got) == 128
    for z, sol in got.values():
        end = tpoly.evaluate(torch.as_tensor(sol.coeff),
                             torch.as_tensor(sol.T),
                             torch.as_tensor(sol.T).sum().reshape(1))[0]
        assert abs(float(end[2]) - z) < 1e-4
    assert srv.stats.n_requests == 128 == sum(srv.stats.batch_sizes)
    assert len(srv.stats.total_ms) == 128
