"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: each test skips with a reason on a host without a
visible GPU (the decision is made inside the test, never at import).  On
a machine with a card, run them from the repository root with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax; this file needs
only torch, numpy and the port).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grad_traj_optimization_torch import fixtures, solver  # noqa: E402
from grad_traj_optimization_torch.config import (  # noqa: E402
    CLICK_CONFIG, MapConfig, OptimizerConfig,
)
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.ops import (  # noqa: E402
    edt_cuda, solve_cuda, trilinear_cuda,
)

pytestmark = pytest.mark.cuda

#: CLICK_CONFIG's weights, velocity/acceleration penalties included, with
#: each test's own iteration budget
CLICK = {k: v for k, v in dataclasses.asdict(CLICK_CONFIG).items()
         if k not in ("iters_step1", "iters_step2")}

MAP = MapConfig(origin=(-10.0, -10.0, 0.0), resolution=0.5,
                map_size=(20.0, 20.0, 8.0))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; none is visible")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def scenes(dev):
    _, pts, valid, wps = fixtures.random_scenarios(
        32, seed=8, map_cfg=MAP, max_obstacle_points=2048)
    origin = torch.tensor(MAP.origin, device=dev)
    occ = sdf.rasterize(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                        origin, MAP.resolution, MAP.grid_shape,
                        valid_mask=torch.as_tensor(valid, device=dev))
    dist = sdf.edt_batch(occ, MAP.resolution)
    return solver.Scenario(
        dist=dist, origin=origin.expand(32, 3).contiguous(),
        resolution=torch.full((32,), MAP.resolution, device=dev),
        waypoints=torch.as_tensor(wps, dtype=torch.float32, device=dev))


def test_minplus_kernel_bitwise(dev):
    rng = np.random.default_rng(0)
    for n in (7, 100, 200, 4096):
        f = rng.integers(0, 60, size=(301, n)).astype(np.float32) ** 2
        f[rng.random(f.shape) < 0.4] = sdf.BIG_CELLS ** 2
        f = torch.as_tensor(f, device=dev)
        launches = edt_cuda.minplus_lines.launches
        out = edt_cuda.minplus_lines(f)
        assert edt_cuda.minplus_lines.launches == launches + 1
        assert torch.equal(out, edt_cuda.minplus_lines_plain(f))


@pytest.mark.parametrize("dim", [-2, -3], ids=["y", "x"])
@pytest.mark.parametrize("shape", [(2, 100, 100, 25), (3, 37, 41, 25),
                                   (2, 9, 13, 5), (4, 33, 70, 40)])
def test_minplus_along_in_place_bitwise(dev, shape, dim):
    """K1 along y and x of a grid as it lies, one launch, in place: the
    bench shape and odd ones (I < 32 on y; I not a multiple of the 32
    lines a block stages)."""
    rng = np.random.default_rng(sum(shape))
    f = rng.integers(0, 60, size=shape).astype(np.float32) ** 2
    f[rng.random(shape) < 0.4] = sdf.BIG_CELLS ** 2
    x = torch.as_tensor(f, device=dev)
    want = edt_cuda.minplus_along_plain(x, dim)
    launches = edt_cuda.minplus_along.launches
    got = edt_cuda.minplus_along(x, dim)
    assert edt_cuda.minplus_along.launches == launches + 1
    assert got.data_ptr() == x.data_ptr()
    assert torch.equal(got, want)


def test_edt_on_gpu_equals_cpu(dev, scenes):
    occ = (scenes.dist == 0).float()
    gpu = sdf.edt_batch(occ, MAP.resolution)
    cpu = sdf.edt_batch(occ.cpu(), MAP.resolution)
    assert torch.equal(gpu.cpu(), cpu)


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ["own grids", "shared grid", "margins",
                                  "opti_node", "tiny values"])
def test_trilinear_kernel_matches_plain(dev, scenes, case):
    """K2 bitwise its plain version: random points around the tests' maps
    (each scenario its own grid, or one grid for all), the margin,
    face-straddling and grid-edge points of ``fixtures.lookup_queries``,
    those in the opti_node map (200 x 200 x 25 at 0.2 m), and a grid of
    values below 1e-36 at 0.1 m, whose gradient dividends fall under the
    fast division's range, so that each lookup runs again with IEEE
    division (without that, some gradients are an ulp off)."""
    grids, origin, res = scenes.dist, scenes.origin, scenes.resolution
    if case in ("own grids", "shared grid"):
        g = torch.Generator().manual_seed(1)
        pos = (torch.rand((32, 180, 3), generator=g) * 24.0 - 12.0).to(dev)
        pos[..., 2] = pos[..., 2].abs() * 0.7
        if case == "shared grid":
            grids = grids[:1]
    elif case == "margins":
        pos = torch.as_tensor(fixtures.lookup_queries(MAP, 32, 3), device=dev)
    elif case == "tiny values":
        mc = MapConfig(origin=(-1.0, -1.0, 0.0), resolution=0.1,
                       map_size=(2.0, 2.0, 1.0))
        rng = np.random.default_rng(5)
        grids = torch.as_tensor(
            (rng.random((8,) + mc.grid_shape) * 1e-36).astype(np.float32),
            device=dev)
        origin = torch.tensor(mc.origin, device=dev).expand(8, 3).contiguous()
        res = torch.full((8,), mc.resolution, device=dev)
        pos = torch.as_tensor(fixtures.lookup_queries(mc, 8, 6), device=dev)
    else:
        mc, obss, wp = fixtures.opti_node_scenario()
        scn = solver.make_scenario(wp, obss, mc, device=dev)
        grids = scn.dist[None]
        origin = scn.origin.expand(16, 3).contiguous()
        res = scn.resolution.expand(16).contiguous()
        pos = torch.as_tensor(fixtures.lookup_queries(mc, 16, 4), device=dev)
    launches = trilinear_cuda.trilinear_batch.launches
    d, gr = trilinear_cuda.trilinear_batch(grids, origin, res, pos)
    assert trilinear_cuda.trilinear_batch.launches == launches + 1
    dp, gp = trilinear_cuda.trilinear_batch_plain(grids, origin, res, pos)
    assert _bitwise(d, dp) and _bitwise(gr, gp)
    if case in ("margins", "opti_node", "tiny values"):
        assert bool((d[:, -32 + 25:-32 + 27] == -1.0).all())  # on the margin
        assert bool((d[:, -32 + 27:] != -1.0).all())  # one ulp inside, edges


@pytest.mark.parametrize("res", [0.1, 0.2, 0.25, 0.5])
def test_lookup_division_on_the_card(dev, res):
    """gto_div, the lookup's division by res, gives __fdiv_rn's bits for
    every finite float32 dividend (2^32 - 2^24 of them)."""
    out = trilinear_cuda.division_check(res, device=dev)
    assert out["checked"] == 2**32 - 2**24
    assert out["differ"] == 0, out["differ_by_exponent"]


@pytest.mark.parametrize("kw", [
    dict(), dict(gradient_mode="exact"), dict(accept_window=8),
    dict(seed_mode="min_snap"), CLICK,
])
def test_descend_kernel_matches_plain(dev, scenes, kw):
    """Short budget, steps (1, 2): equal n_accept and cost rtol 5e-3.

    Two f32 runs of the descent that differ only in summation order part
    on a few lanes within 12 iterations (an accept decision on a near
    tie, then a different path): on the card the f32 plain loop leaves
    its own float64 run on ~5% of bench lanes.  So the kernel must agree
    with the f32 plain loop on 28 of 32 lanes, and stay on the float64
    path on as many lanes as the f32 plain loop does, give or take 2.
    """
    cfg = OptimizerConfig(iters_step1=4, iters_step2=8, **kw)
    kargs, _ = solver.kernel_inputs(scenes, cfg)
    phases = ((1, 4), (2, 8))
    _, ck, nk, tk = solve_cuda.descend(*kargs, phases, cfg)
    _, cp, np_, _ = solve_cuda.descend_plain(*kargs, phases, cfg)
    k64 = tuple(a.double() if isinstance(a, torch.Tensor) else a
                for a in kargs)
    _, c64, n64, _ = solve_cuda.descend_plain(*k64, phases, cfg)

    def agree(n1, c1, n2, c2):
        c1, c2 = c1.double(), c2.double()
        return (n1 == n2) & ((c1 - c2).abs() <= 5e-3 * c2.abs())

    ok = agree(nk, ck, np_, cp)
    assert int(ok.sum()) >= 28, torch.nonzero(~ok)
    k_vs_64 = int(agree(nk, ck, n64, c64).sum())
    p_vs_64 = int(agree(np_, cp, n64, c64).sum())
    assert k_vs_64 >= p_vs_64 - 2, (k_vs_64, p_vs_64)
    # the trace is monotone within each phase (each has its own cost)
    for t in (tk[:, :4], tk[:, 4:]):
        assert bool(torch.all(t[:, 1:] <= t[:, :-1]))


@pytest.mark.parametrize("kw", [
    dict(), dict(gradient_mode="exact"), dict(accept_window=8), CLICK,
    dict(CLICK, gradient_mode="exact"),
])
def test_descend_kernel_one_iteration_to_rounding(dev, scenes, kw):
    """One iteration per step, before any rounding is amplified: every
    lane agrees with the plain loop to f32 sum-order rounding (~1e-6
    relative over 180 samples; the tolerance is ten times that)."""
    cfg = OptimizerConfig(iters_step1=1, iters_step2=1, **kw)
    kargs, _ = solver.kernel_inputs(scenes, cfg)
    phases = ((1, 1), (2, 1))
    dk, ck, nk, _ = solve_cuda.descend(*kargs, phases, cfg)
    dp, cp, np_, _ = solve_cuda.descend_plain(*kargs, phases, cfg)
    assert torch.equal(nk, np_)
    torch.testing.assert_close(ck, cp, rtol=1e-5, atol=0)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-5)


def _one_iteration_to_rounding(scns, cfg):
    """One step-2 iteration, every lane: equal n_accept, cost within 1e-5
    relative and sampled positions within 1e-5 m of the plain loop (as
    chip_smoke.py phase 5 holds it)."""
    from grad_traj_optimization_torch.core import poly, qp

    c1 = dataclasses.replace(cfg, iters_step2=1)
    kargs, (Df, _, T) = solver.kernel_inputs(scns, c1)
    dk, ck, nk, _ = solve_cuda.descend(*kargs, ((2, 1),), c1)
    dp, cp, np_, _ = solve_cuda.descend_plain(*kargs, ((2, 1),), c1)

    def positions(dpT):
        coeff = qp.coeff_from_d(Df.double(), dpT.double().transpose(1, 2),
                                T.double())
        return poly.sample_uniform(coeff, T.double(), 100)[0]

    assert torch.equal(nk, np_)
    torch.testing.assert_close(ck, cp, rtol=1e-5, atol=0)
    assert float((positions(dk) - positions(dp)).abs().max()) <= 1e-5


@pytest.mark.parametrize("case", ["opti_node", "ragged", "ragged-click"])
def test_descend_kernel_one_iteration_other_batches(dev, case):
    """K3 at B = 1 on the reference opti_node map (300 samples, P = 27, one
    block) and at a ragged bench-shaped B = 1000 (the launch plan keeps
    it in one wave), with and without CLICK_CONFIG's penalties."""
    if case == "opti_node":
        mc, obss, wp = fixtures.opti_node_scenario()
        scn = solver.make_scenario(wp, obss, mc, device=dev)
        scns = solver.Scenario(*(x[None] for x in scn))
    else:
        B = 1000
        mc, pts, valid, wps = fixtures.random_scenarios(
            B, n_waypoints=7, seed=11, max_obstacle_points=1024)
        origin = torch.tensor(mc.origin, device=dev)
        occ = sdf.rasterize(
            torch.as_tensor(pts, dtype=torch.float32, device=dev), origin,
            mc.resolution, mc.grid_shape,
            valid_mask=torch.as_tensor(valid, device=dev))
        scns = solver.Scenario(
            dist=sdf.edt_batch(occ, mc.resolution),
            origin=origin.expand(B, 3).contiguous(),
            resolution=torch.full((B,), mc.resolution, device=dev),
            waypoints=torch.as_tensor(wps, dtype=torch.float32, device=dev))
    cfg = CLICK_CONFIG if case.endswith("click") else OptimizerConfig()
    B, m = scns.waypoints.shape[0], scns.waypoints.shape[1] - 1
    pl = solve_cuda.plan(m, cfg.n_samples, cfg.accept_window,
                         cfg.alpha_a != 0.0, B)
    assert pl["blocks_per_sm"] * pl["sms"] >= B, pl
    _one_iteration_to_rounding(scns, cfg)


def test_cuda_solve_rejects_unsupported(dev, scenes):
    with pytest.raises(ValueError):
        solver.solve_batch(scenes, cfg=OptimizerConfig(accept_window=200))
    with pytest.raises(ValueError):
        solver.solve_batch(scenes, cfg=OptimizerConfig(step_rule="adaptive"))


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_search_batch_on_gpu_equals_cpu(dev, scenes, dynamic):
    """The beam search on cuda:0 lands on the CPU run's beams: its stable
    sorts, argmins and gathers keep the CPU semantics (8 lanes)."""
    from grad_traj_optimization_torch.search import kinodynamic, predictor

    wps = scenes.waypoints[:8]
    z = torch.zeros((8, 3), device=dev)
    starts = torch.cat([wps[:, 0], z], 1)
    goals = torch.cat([wps[:, -1], z], 1)
    pred = None
    if dynamic:
        hist = torch.tensor([[[-3.0, 0.0, 2.0], [-2.6, 0.2, 2.0]],
                             [[3.0, 1.0, 1.5], [2.7, 0.8, 1.5]]], device=dev)
        pred = predictor.fit_const_vel(
            hist, torch.tensor([[-0.5, 0.0]] * 2, device=dev),
            torch.full((2, 3), 0.8, device=dev))
    kw = dict(beam=32, max_iters=10)
    g = kinodynamic.search_batch(scenes.dist[:8], scenes.origin[:8],
                                 MAP.resolution, starts, goals,
                                 obstacle_pred=pred, **kw)
    c = kinodynamic.search_batch(
        scenes.dist[:8].cpu(), scenes.origin[:8].cpu(), MAP.resolution,
        starts.cpu(), goals.cpu(), obstacle_pred=None if pred is None else
        predictor.ObjPrediction(*(x.cpu() for x in pred)), **kw)
    assert int(c.reached.sum()) >= 4
    assert torch.equal(g.reached.cpu(), c.reached)
    for a, b in zip(g[:4], c[:4]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    torch.testing.assert_close(g.cost.cpu(), c.cost, rtol=1e-5, atol=0)


# ---------------------------------------------------------- online use


def _missions(scenes, n):
    z = torch.zeros((n, 3), device=scenes.dist.device)
    wps = scenes.waypoints[:n]
    return torch.cat([wps[:, 0], z], 1), torch.cat([wps[:, -1], z], 1)


def test_host_rung_on_the_card(dev, scenes):
    """plan_batch(host_fallback=True) with a starved beam on the card: the
    same recovered lanes and knots as on the CPU, the field of the
    unreached lanes downloaded as float32, and exactly one K3 launch for
    the base race and one for the rung's (one stretch each)."""
    from grad_traj_optimization_torch import pipeline

    starts, goals = _missions(scenes, 16)
    kw = dict(beam=2, max_iters=3, retries=0, stretches=(1.0,),
              cfg=OptimizerConfig(iters_step2=10), host_fallback=True)
    before = solve_cuda.descend.launches
    g = pipeline.plan_batch(scenes.dist[:16], scenes.origin[:16],
                            MAP.resolution, starts, goals, **kw)
    assert solve_cuda.descend.launches == before + (2 if g.n_host_fallback
                                                    else 1)
    c = pipeline.plan_batch(scenes.dist[:16].cpu(), scenes.origin[:16].cpu(),
                            MAP.resolution, starts.cpu(), goals.cpu(), **kw)
    assert g.n_host_fallback == c.n_host_fallback >= 1
    np.testing.assert_array_equal(g.reached, c.reached)
    for a, b in zip(g.search[:4], c.search[:4]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


def test_solve_server_on_the_card(dev, scenes):
    """SolveServer on cuda:0: 40 requests sharing one field tensor; each
    served lane equal to a direct solve_batch of its padded group, and
    one K3 launch a group."""
    from grad_traj_optimization_torch import serving

    cfg = OptimizerConfig(iters_step2=20)
    field = scenes.dist[0]
    scns = [solver.Scenario(field, scenes.origin[i], scenes.resolution[i],
                            scenes.waypoints[i]) for i in range(32)]
    scns += scns[:8]
    srv = serving.SolveServer(cfg=cfg, max_batch=64, max_wait_ms=500.0,
                              bucket_floor=8)
    before = solve_cuda.descend.launches
    try:
        futs = [srv.submit(s) for s in scns]
        sols = [f.result(timeout=300) for f in futs]
    finally:
        srv.shutdown()
    groups = [g for n in srv.stats.batch_sizes
              for g in srv._bucket_groups(n)]
    assert solve_cuda.descend.launches == before + len(groups)
    assert srv.stats.batch_sizes == [40] and groups == [32, 8]
    lanes = scns
    ofs = 0
    for g in groups:
        sub = lanes[ofs:ofs + g]
        direct = solver.solve_batch(solver.Scenario(
            field[None], torch.stack([s.origin for s in sub]),
            torch.stack([s.resolution for s in sub]),
            torch.stack([s.waypoints for s in sub])), cfg=cfg)
        for i in range(g):
            for a, b in zip(sols[ofs + i], direct):
                np.testing.assert_array_equal(a, b[i].cpu().numpy())
        ofs += g


def test_first_launch_on_the_dispatch_thread(dev):
    """A fresh process whose first K3 launch comes from SolveServer's
    dispatch thread (the library loads there)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import numpy as np, torch\n"
        "from grad_traj_optimization_torch import fixtures, serving, solver\n"
        "from grad_traj_optimization_torch.ops import solve_cuda\n"
        "mc, obs, wp = fixtures.opti_node_scenario()\n"
        "scn = solver.make_scenario(wp, obs, mc)\n"
        "srv = serving.SolveServer(max_batch=4)\n"
        "try:\n"
        "    sol = srv.solve(scn, timeout=300)\n"
        "finally:\n"
        "    srv.shutdown()\n"
        "assert solve_cuda.descend.launches == 1 and int(sol.status) == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_edt_update_on_the_card(dev):
    """edt_update("add") on the card: bitwise a full edt (K1) of the new
    occupancy, and bitwise the CPU's update."""
    rng = np.random.default_rng(3)
    occ0 = torch.as_tensor((rng.random((40, 36, 20)) < 0.01).astype(
        np.float32), device=dev)
    d0 = sdf.edt(occ0, 0.2)
    occ1 = occ0.clone()
    occ1[10:22, 8:10, 0:15] = 1.0
    got = sdf.edt_update(d0, occ1, 0.2, (10, 8, 0), (22, 10, 15))
    assert torch.equal(got, sdf.edt(occ1, 0.2))
    assert torch.equal(got.cpu(), sdf.edt_update(
        d0.cpu(), occ1.cpu(), 0.2, (10, 8, 0), (22, 10, 15)))


def test_replan_loop_on_the_card(dev):
    """replan_loop on cuda:0 through a gap: one K3 launch for each
    refined tick, reaching the goal."""
    from grad_traj_optimization_torch import replan

    shape = (40, 40, 16)
    occ = torch.zeros(shape, device=dev)
    occ[:, 20, :] = 1.0
    occ[18:23, 20, :] = 0.0  # a gap at x in [-0.5, 0.75)
    dist = sdf.edt(occ, 0.25)
    before = solve_cuda.descend.launches
    res = replan.replan_loop(
        dist, (-5.0, -5.0, 0.0), 0.25, np.array([0, -3, 2, 0, 0, 0.0]),
        np.array([0, 3, 2, 0, 0, 0.0]),
        rcfg=replan.ReplanConfig(replan_dt=0.8, max_ticks=15, kino_iters=10,
                                 kino_beam=32, margin=0.2),
        ocfg=OptimizerConfig(iters_step2=15))
    assert solve_cuda.descend.launches == before + sum(
        r.search_ok for r in res)
    assert res[-1].reached_goal


# ------------------------------------------------------- compare2 harness


def test_numpy_knots_with_a_cuda_field(dev, scenes):
    """solve_kino_batch with a CUDA field and numpy knots, origins and
    resolutions: the numpy arguments go to the field's device, one K3
    launch, no plain loop; a CPU knot tensor raises."""
    B = 4
    wps = scenes.waypoints[:B].cpu().numpy()
    pos = wps[:, ::2]
    zero = np.zeros_like(pos)
    times = np.full((B, pos.shape[1] - 1), 2.0, np.float32)
    args = (scenes.dist[:B], scenes.origin[:B].cpu().numpy(),
            np.full(B, MAP.resolution, np.float32), pos, zero, zero, times)
    before = solve_cuda.descend.launches
    calls = solve_cuda.descend_plain.calls
    sol = solver.solve_kino_batch(*args, cfg=OptimizerConfig(iters_step2=10))
    assert solve_cuda.descend.launches == before + 1
    assert solve_cuda.descend_plain.calls == calls
    assert sol.cost.is_cuda and bool(torch.isfinite(sol.cost).all())
    with pytest.raises(ValueError):
        solver.solve_kino_batch(*args[:3], torch.as_tensor(pos), *args[4:])


def test_run_suite_batched_one_launch(dev):
    """run_suite_batched on three gap-wall cases built on the card: one K3
    launch for the suite, every record equal to run_suite's under the
    per-case rule, each grid plan the CPU's."""
    from grad_traj_optimization_torch import harness
    from grad_traj_optimization_torch.search import grid_search

    occ = torch.zeros((40, 40, 16), device=dev)
    occ[:, 20, :] = 1.0
    occ[17:23, 20, :] = 0.0
    dist = sdf.edt(occ, 0.25)
    origin = np.array([-5.0, -5.0, 0.0])
    cases = [(dist, origin, 0.25, np.array([dx, -3.0, 2.0]),
              np.array([dx, 3.0, 2.0])) for dx in (0.0, 0.25, -0.25)]
    for c in cases:
        for a, b in zip(grid_search.plan(*c), grid_search.plan(
                c[0].cpu(), *c[1:])):
            assert torch.equal(a.cpu(), b)
    cfg = OptimizerConfig(iters_step2=12)
    before = solve_cuda.descend.launches
    calls = solve_cuda.descend_plain.calls
    rb = harness.run_suite_batched(cases, cfg=cfg, n_waypoints=5)
    assert solve_cuda.descend.launches == before + 1
    rs = harness.run_suite(cases, cfg=cfg, n_waypoints=5)
    assert solve_cuda.descend.launches == before + 1 + len(cases)
    assert solve_cuda.descend_plain.calls == calls
    for b, s in zip(rb, rs):
        assert b.status == s.status == 0 and b.frontend_ok
        np.testing.assert_allclose(b.jerk, s.jerk, rtol=1e-3)
        np.testing.assert_allclose(b.traj_time_s, s.traj_time_s, rtol=1e-5)
        np.testing.assert_allclose(b.cost_curve[-1], s.cost_curve[-1],
                                   rtol=1e-3)
