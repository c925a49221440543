"""PyTorch port, exact cropping: ``solver.crop_scenarios``, the crop frame
of the lookup (``sdf.trilinear_flat``) and of K3's plain version, the
guards of the functions without one, and the entry points that crop or
run chunks (``scripts/stress_pipeline_512_torch.py``,
``scripts/monte_carlo_torch.py``), against the JAX package on identical
inputs.

The fixtures are tests/test_solve.py's: a per-lane batch
(``random_scenarios(6, n_waypoints=5, seed=7)``, :266) and a shared map
with clustered waypoints (``random_scenarios(4, seed=11)``, :345), at
``OptimizerConfig(iters_step1=10, iters_step2=25)``.  The short-budget
rule against the JAX kernel (equal n_accept, cost and trace within rtol
5e-3, positions within 1e-3 m) is held at 10 iterations: at 25 the JAX
kernel's bf16-plane lookup and the f32 port part on half the per-lane
lanes, cropped or not.
"""

import dataclasses
import json
import os
import subprocess
import sys

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
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402
from grad_traj_optimization_tpu.ops import solve_pallas  # noqa: E402
from grad_traj_optimization_tpu.ops import trilinear_pallas  # noqa: E402

from grad_traj_optimization_torch import convert, viz  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.fields import sdf as tsdf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import monte_carlo_torch as mc  # noqa: E402
import stress_pipeline_512_torch as stress  # noqa: E402

CROP_KW = dict(iters_step1=10, iters_step2=25)
CASES = ["per-lane", "shared"]


def _np(t):
    return t.detach().cpu().numpy()


def _tcfg(**kw):
    return convert.config_from_jax(dataclasses.asdict(JConfig(**kw)))


def _build(case):
    """A fixture's numpy leaves (the JAX package's EDT) and both
    packages' Scenario batches."""
    if case == "per-lane":
        map_cfg, pts, valid, wps = jfix.random_scenarios(
            6, n_waypoints=5, seed=7, max_obstacle_points=1024)
        origin = jnp.asarray(map_cfg.origin, jnp.float32)
        occ = jax.vmap(lambda p, v: jsdf.rasterize(
            p, origin, map_cfg.resolution, map_cfg.grid_shape,
            valid_mask=v))(jnp.asarray(pts, jnp.float32),
                           jnp.asarray(valid))
        dist = jsdf.edt_batch(occ, map_cfg.resolution, backend="jnp")
    else:
        map_cfg, pts, valid, wps = jfix.random_scenarios(
            4, n_waypoints=5, seed=11, max_obstacle_points=1024)
        occ = jsdf.rasterize(
            jnp.asarray(pts[0], jnp.float32),
            jnp.asarray(map_cfg.origin, jnp.float32), map_cfg.resolution,
            map_cfg.grid_shape, valid_mask=jnp.asarray(valid[0]))
        dist = jsdf.edt(occ, map_cfg.resolution, backend="jnp")[None]
        wps = np.asarray(wps) * 0.4  # a union window smaller than the map
    B = wps.shape[0]
    leaves = dict(
        dist=np.asarray(dist),
        origin=np.broadcast_to(np.asarray(map_cfg.origin, np.float32),
                               (B, 3)).copy(),
        resolution=np.full((B,), map_cfg.resolution, np.float32),
        waypoints=np.asarray(wps, np.float32))
    jscn = jsolver.Scenario(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tscn = convert.scenario_from_numpy(**leaves, device="cpu")
    return dict(map_cfg=map_cfg, leaves=leaves, jscn=jscn, tscn=tscn)


@pytest.fixture(scope="module", params=CASES)
def fx(request):
    """Each fixture, full and cropped by both packages."""
    out = _build(request.param)
    out["case"] = request.param
    out["jcrop"] = jsolver.crop_scenarios(out["jscn"], JConfig(**CROP_KW))
    out["tcrop"] = tsolver.crop_scenarios(out["tscn"], _tcfg(**CROP_KW))
    return out


# ------------------------------------------------------------ (a) windows


def test_crop_windows_bitwise_jax(fx):
    """Offsets, shapes, full extents and the cropped grids are the JAX
    package's, bit for bit; the origin is kept."""
    j, t = fx["jcrop"], fx["tcrop"]
    assert t.grid_offset.dtype == t.grid_full.dtype == torch.int32
    np.testing.assert_array_equal(_np(t.grid_offset),
                                  np.asarray(j.grid_offset))
    np.testing.assert_array_equal(_np(t.grid_full), np.asarray(j.grid_full))
    assert tuple(t.dist.shape) == tuple(j.dist.shape)
    assert np.prod(t.dist.shape[1:]) < np.prod(fx["tscn"].dist.shape[1:])
    np.testing.assert_array_equal(_np(t.dist), np.asarray(j.dist))
    assert t.origin is fx["tscn"].origin
    off = _np(t.grid_offset)
    if fx["case"] == "shared":
        assert t.dist.shape[0] == 1 and np.all(off == off[0])
    else:
        assert len({tuple(o) for o in off}) > 1


def test_crop_whole_window_returns_input():
    """A window that covers the whole grid leaves the batch unchanged, as
    in the JAX package."""
    b = _build("per-lane")
    cfg = JConfig(**CROP_KW)
    tcfg = _tcfg(**CROP_KW)
    assert jsolver.crop_scenarios(b["jscn"], cfg, margin=50.0) is b["jscn"]
    assert tsolver.crop_scenarios(b["tscn"], tcfg, margin=50.0) is b["tscn"]


@pytest.mark.parametrize("fault", ["resolution", "origin", "cropped"])
def test_crop_raises_as_jax(fault):
    """Mixed resolutions or origins, and cropping twice, raise the JAX
    package's ValueError."""
    b = _build("per-lane")
    lv = dict(b["leaves"])
    if fault == "resolution":
        lv["resolution"] = lv["resolution"].copy()
        lv["resolution"][1] = 0.25
    elif fault == "origin":
        lv["origin"] = lv["origin"].copy()
        lv["origin"][2, 0] += 0.5
    jscn = jsolver.Scenario(**{k: jnp.asarray(v) for k, v in lv.items()})
    tscn = convert.scenario_from_numpy(**lv, device="cpu")
    cfg = JConfig(**CROP_KW)
    if fault == "cropped":
        jscn = jsolver.crop_scenarios(jscn, cfg)
        tscn = tsolver.crop_scenarios(tscn, _tcfg(**CROP_KW))
    with pytest.raises(ValueError) as jerr:
        jsolver.crop_scenarios(jscn, cfg)
    with pytest.raises(ValueError) as terr:
        tsolver.crop_scenarios(tscn, _tcfg(**CROP_KW))
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------- (b) windowed lookup


def _window_points(rng, origin, res, off, n, full):
    """SP query points about a window [off, off + n) of a ``full`` map:
    inside it, within res/2 of its interior faces (on both sides), within
    1e-4 of the map's true faces, and beyond."""
    lo = origin + off * res
    hi = origin + (off + n) * res
    pts = [rng.uniform(lo - res, hi + res, (64, 3))]
    for axis in range(3):
        for face, true_face in ((lo[axis], off[axis] == 0),
                                (hi[axis], off[axis] + n[axis] == full[axis])):
            band = 2e-4 if true_face else res
            p = rng.uniform(lo + res, hi - res, (20, 3))
            p[:, axis] = face + rng.uniform(-band, band, 20)
            pts.append(p)
    pts = np.concatenate(pts).astype(np.float32)
    return pts[:trilinear_pallas.SP]


@pytest.mark.parametrize("window", [
    ((20, 30, 0), (40, 32, 16)), ((0, 60, 9), (48, 40, 16)),
], ids=["z-true-face", "x-true-face"])
def test_windowed_lookup_matches_pallas(window):
    """``trilinear_flat`` in the crop frame against the TPU kernel's lookup
    (``solve_pallas._lookup``, functional, with a crop ``misc``): the same
    in/out decision on every point, d and g within the bf16-plane
    tolerance (trilinear_pallas.py:48-55: <= 6e-5 m for d < 16 m, so
    2 x 6e-5 / res for g), and every in-window value bitwise the port's
    full-grid lookup."""
    b = _build("per-lane")
    map_cfg = b["map_cfg"]
    grid = b["leaves"]["dist"][0]
    full = np.asarray(grid.shape)
    off, n = np.asarray(window[0]), np.asarray(window[1])
    crop = grid[off[0]:off[0] + n[0], off[1]:off[1] + n[1],
                off[2]:off[2] + n[2]]
    origin = np.asarray(map_cfg.origin, np.float32)
    res = np.float32(map_cfg.resolution)
    rng = np.random.default_rng(5)
    pos = _window_points(rng, origin.astype(np.float64), float(res), off, n,
                         full)
    tpos = torch.as_tensor(pos)
    d_w, g_w = tsdf.trilinear_flat(
        torch.as_tensor(crop.copy()).reshape(-1), 0, tuple(n),
        torch.as_tensor(origin), res, tpos,
        offset=torch.as_tensor(off), full_shape=torch.as_tensor(full))
    d_f, g_f = tsdf.distance_and_gradient(torch.as_tensor(grid.copy()),
                                          torch.as_tensor(origin), res, tpos)

    misc = np.zeros((1, 16), np.float32)
    misc[0, :3] = origin
    misc[0, 3] = res
    misc[0, 5:8] = off
    misc[0, 8:11] = full
    zc = trilinear_pallas._pick_zc(int(n[2]))
    nzp = trilinear_pallas._round_up(int(n[2]), zc)
    gp = trilinear_pallas.prep_grids(jnp.asarray(crop)[None])
    d_j, g_j = solve_pallas._lookup(gp, jnp.asarray(pos), jnp.asarray(misc),
                                    tuple(int(x) for x in n), nzp, zc,
                                    functional=True)
    d_j, g_j = np.asarray(d_j)[:, 0], np.asarray(g_j)

    inside = _np(d_w) != -1.0
    np.testing.assert_array_equal(inside, d_j != -1.0)
    assert 0 < inside.sum() < len(pos)
    # the half-cell margin: points within res/2 of an interior face are out
    assert np.any(~inside & (_np(d_f) != -1.0))
    np.testing.assert_allclose(_np(d_w)[inside], d_j[inside], rtol=0,
                               atol=6e-5)
    np.testing.assert_allclose(_np(g_w)[inside], g_j[inside], rtol=0,
                               atol=2 * 6e-5 / float(res))
    assert np.all(_np(g_w)[~inside] == 0)
    np.testing.assert_array_equal(_np(d_w)[inside].view(np.int32),
                                  _np(d_f)[inside].view(np.int32))
    np.testing.assert_array_equal(_np(g_w)[inside].view(np.int32),
                                  _np(g_f)[inside].view(np.int32))


def test_window_test_at_offset_zero_is_in_map():
    """The window test with offset 0 and full = the grid (every lookup of
    a whole map, K2's own launch included) decides as ``sdf.in_map``
    does, on points within a few ulps of each face's 1e-4 margin: its
    bounds round as o + 1e-4 and o + n res - 1e-4 do."""
    b = _build("per-lane")
    map_cfg = b["map_cfg"]
    shape = np.asarray(map_cfg.grid_shape)
    origin = torch.tensor(map_cfg.origin)
    res = torch.tensor(map_cfg.resolution)
    lo = (origin + 1e-4).numpy()
    hi = (origin + torch.tensor(map_cfg.grid_shape) * res - 1e-4).numpy()
    rng = np.random.default_rng(9)
    pts = rng.uniform(lo, hi, (600, 3)).astype(np.float32)
    for i in range(600):  # one coordinate a few ulps from a margin
        axis, face = i % 3, (lo, hi)[(i // 3) % 2][i % 3]
        pts[i, axis] = face + np.float32(rng.integers(-3, 4)) * np.spacing(
            np.float32(face))
    pos = torch.as_tensor(pts)
    want = tsdf.in_map(pos, origin, res, map_cfg.grid_shape)
    got = tsdf.in_window(pos, origin, res, map_cfg.grid_shape,
                         torch.zeros(3, dtype=torch.int64),
                         torch.as_tensor(shape))
    assert 0 < int(want.sum()) < 600
    assert torch.equal(got, want)


# ------------------------------------------ (c) the port's loop, cropped


def test_plain_crop_bitwise_full(fx):
    """The port's solve (K3's plain version on the CPU) of the cropped
    batch is bitwise its full-grid solve: dp and cost on every lane
    (mirrors tests/test_solve.py:320-336 and :375-380)."""
    cfg = _tcfg(**CROP_KW)
    full = tsolver.solve_batch(fx["tscn"], cfg=cfg)
    crop = tsolver.solve_batch(fx["tcrop"], cfg=cfg)
    assert torch.equal(crop.dp, full.dp)
    assert torch.equal(crop.cost, full.cost)
    assert bool((crop.status == tsolver.STATUS_OK).all())


def test_solve_single_cropped_scenario(fx):
    """``solve`` takes one cropped scenario (its frame gains the batch
    axis) and gives that lane of the batch solve."""
    cfg = _tcfg(iters_step2=10)
    i = 1

    def row(x):  # lane i; a shared grid is every lane's
        return x[i] if x.shape[0] > 1 else x[0]

    sol = tsolver.solve(fx["tcrop"].map(row), cfg=cfg)
    full = tsolver.solve_batch(fx["tscn"].map(lambda x: row(x)[None]),
                               cfg=cfg)
    assert torch.equal(sol.dp, full.dp[0])
    assert torch.equal(sol.cost, full.cost[0])


# ------------------------------------------- (d) against the JAX kernel


def test_crop_solve_matches_jax_kernel(fx):
    """The port's cropped solve against the JAX package's
    ``solve_batch_kernel(cropped, interpret=True)``, short-budget rule:
    equal n_accept, cost and trace within rtol 5e-3, sampled positions
    within 1e-3 m."""
    kw = dict(iters_step1=10, iters_step2=10)
    jsol = jsolver.solve_batch_kernel(fx["jcrop"], cfg=JConfig(**kw),
                                      steps=(2,), interpret=True)
    tsol = tsolver.solve_batch(fx["tcrop"], cfg=_tcfg(**kw))
    np.testing.assert_array_equal(_np(tsol.n_accept),
                                  np.asarray(jsol.n_accept))
    np.testing.assert_allclose(_np(tsol.cost), np.asarray(jsol.cost),
                               rtol=5e-3)
    np.testing.assert_allclose(_np(tsol.cost_trace),
                               np.asarray(jsol.cost_trace), rtol=5e-3)
    tp, _ = tpoly.sample_uniform(tsol.coeff, tsol.T, 100)
    jp = jax.vmap(lambda c, T: jpoly.sample_uniform(c, T, 100)[0])(
        jsol.coeff, jsol.T)
    assert np.abs(_np(tp) - np.asarray(jp)).max() < 1e-3


# ------------------------------------------------ (e) the kernel inputs


def test_kernel_inputs_crop_frame_matches_jax(fx):
    """``kernel_inputs``' misc[:, 0, 5:11] (crop offset, full extents) is
    the JAX package's for a cropped batch, and its origin/res lanes too."""
    cfg = JConfig(**CROP_KW)
    jk, _ = jsolver.kernel_inputs(fx["jcrop"], cfg)
    tk, _ = tsolver.kernel_inputs(fx["tcrop"], _tcfg(**CROP_KW))
    jmisc, tmisc = np.asarray(jk[12]), _np(tk[12])
    np.testing.assert_array_equal(tmisc[:, 0, 5:11], jmisc[:, 0, 5:11])
    np.testing.assert_array_equal(tmisc[:, 0, :4], jmisc[:, 0, :4])
    full = np.asarray(fx["tscn"].dist.shape[1:], np.float32)
    np.testing.assert_array_equal(tmisc[:, 0, 8:11],
                                  np.broadcast_to(full, tmisc[:, 0, 8:11].shape))


# ------------------------------------------------------------ (f) guards


@pytest.mark.parametrize("fn", ["SolveServer.submit", "min_clearance",
                                "viz.scene_arrays"])
def test_uncropped_only_paths_raise(fn):
    """Functions that read a grid as the whole map (no crop frame) raise
    ValueError for a cropped Scenario; none reads it as a map."""
    b = _build("per-lane")
    cfg = _tcfg(iters_step2=3)
    cropped = tsolver.crop_scenarios(b["tscn"], cfg)
    sol = tsolver.solve_batch(cropped, cfg=cfg)
    if fn == "SolveServer.submit":
        from grad_traj_optimization_torch import serving

        server = serving.SolveServer(cfg=cfg, device="cpu")
        try:
            with pytest.raises(ValueError, match="uncropped"):
                server.submit(cropped.map(lambda x: x[0]))
        finally:
            server.shutdown()
    elif fn == "min_clearance":
        with pytest.raises(ValueError, match="uncropped"):
            tsolver.min_clearance(sol, cropped)
        assert tsolver.min_clearance(sol, b["tscn"]).shape == (6,)
    else:
        one = tsolver.Solution(*(x[0] for x in sol))
        with pytest.raises(ValueError, match="uncropped"):
            viz.scene_arrays(one, cropped.map(lambda x: x[0]))


def test_scenario_from_numpy_carries_crop_frame():
    """``convert.scenario_from_numpy`` carries a JAX cropped Scenario's
    offset and extents (int32), and the port solves it as its own crop."""
    b = _build("per-lane")
    jc = jsolver.crop_scenarios(b["jscn"], JConfig(**CROP_KW))
    tc = convert.scenario_from_numpy(*(np.asarray(x) for x in jc),
                                     device="cpu")
    own = tsolver.crop_scenarios(b["tscn"], _tcfg(**CROP_KW))
    for a, c in zip(tc, own):
        assert a.dtype == c.dtype and torch.equal(a, c)
    cfg = _tcfg(iters_step2=5)
    assert torch.equal(tsolver.solve_batch(tc, cfg=cfg).dp,
                       tsolver.solve_batch(own, cfg=cfg).dp)


def test_scenario_map_skips_none(tmp_path):
    """``Scenario.map`` maps the tensor fields and keeps None ones, as
    ``jax.tree.map`` does; ``checkpoint`` round-trips either."""
    from grad_traj_optimization_torch import checkpoint

    b = _build("shared")
    full = b["tscn"].map(lambda x: x[:2] if x.shape[0] > 1 else x)
    assert full.grid_offset is None and full.waypoints.shape[0] == 2
    cropped = tsolver.crop_scenarios(b["tscn"], _tcfg(**CROP_KW))
    two = cropped.map(lambda x: x[:2] if x.shape[0] > 1 else x)
    assert two.grid_offset.shape == (2, 3)
    for i, scn in enumerate((full, two)):
        back = checkpoint.restore(checkpoint.save(str(tmp_path / str(i)),
                                                  scn), scn)
        assert (back.grid_offset is None) == (scn.grid_offset is None)
        for a, c in zip(back, scn):
            assert a is c is None or torch.equal(a, c)


# ------------------------------------------------------ (g) Monte-Carlo


def test_monte_carlo_resume_equals_unbroken(tmp_path):
    """``monte_carlo_torch.run`` at 64 scenarios in chunks of 16: two
    chunks, a checkpoint, a restore and two more give the aggregates of
    an unbroken run, bit for bit."""
    cfg = _tcfg(iters_step2=20)
    lines = []
    whole = mc.run(64, 16, str(tmp_path / "whole"), device="cpu", cfg=cfg,
                   log=lines.append)
    half = str(tmp_path / "half")
    first = mc.run(32, 16, half, device="cpu", cfg=cfg, log=lines.append)
    resumed = mc.run(64, 16, half, device="cpu", cfg=cfg, log=lines.append)
    assert int(first["state"]["done"]) == 32
    assert {"resumed_at": 32} in lines
    for k, v in whole["state"].items():
        assert np.array_equal(v, resumed["state"][k]), k
    assert whole["n_scenarios"] == 64 and whole["n_ok"] == 64
    assert np.isfinite(whole["mean_cost"]) and whole["max_cost"] > 0


def test_monte_carlo_chunks_reproduce(tmp_path):
    """A chunk's draws depend only on its index (a ``torch.Generator``
    seeded 1000 + chunk): the same chunk twice gives the same costs."""
    cfg = _tcfg(iters_step2=5)
    a = mc.solve_chunk(3, 8, cfg, torch.device("cpu"))
    b = mc.solve_chunk(3, 8, cfg, torch.device("cpu"))
    c = mc.solve_chunk(4, 8, cfg, torch.device("cpu"))
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])


def test_monte_carlo_on_a_mesh(tmp_path):
    """The script under ``torchrun`` with two CPU processes (gloo):
    ``sharded_solve`` a chunk, rank 0 prints; the counts are the
    one-process run's and the costs agree to float32 rounding."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2",
           os.path.join(ROOT, "scripts", "monte_carlo_torch.py"), "32", "16",
           str(tmp_path / "mesh"), "cpu"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = [json.loads(ln) for ln in p.stdout.splitlines()
           if ln.startswith("{")]
    summary = out[-1]
    assert summary["n_devices"] == 2 and summary["n_scenarios"] == 32
    one = mc.run(32, 16, str(tmp_path / "one"), device="cpu",
                 log=lambda _: None)
    assert summary["n_ok"] == one["n_ok"] == 32
    np.testing.assert_allclose(summary["mean_cost"], one["mean_cost"],
                               rtol=1e-5)


# --------------------------------------------------- (h) stress pipeline


@pytest.fixture(scope="module")
def stress_out():
    """The stress pipeline's stages at 64^3 (1.6 m cells over the same
    102 m cube), 16 lanes, on the CPU."""
    return stress.stages(n=64, res=1.6, batch=16, device="cpu")


def test_stress_stages_small(stress_out):
    """Every lane ok, cropped bitwise uncropped, and the window the JAX
    package's ``crop_scenarios`` gives for the same lanes and grid."""
    out = stress_out
    sc, sf = out["sol_crop"], out["sol_full"]
    assert int((sc.status == 0).sum()) == 16
    assert int((sf.status == 0).sum()) == 16
    assert int(stress.bitwise_lanes(sc, sf).sum()) == 16
    _, wps = stress.draws(16)
    jb = jsolver.Scenario(
        dist=jnp.zeros((1, 64, 64, 64), jnp.float32),
        origin=jnp.broadcast_to(jnp.asarray(stress.ORIGIN, jnp.float32),
                                (16, 3)),
        resolution=jnp.full((16,), 1.6, jnp.float32),
        waypoints=jnp.asarray(wps))
    jc = jsolver.crop_scenarios(jb, JConfig())
    np.testing.assert_array_equal(_np(out["cropped"].grid_offset),
                                  np.asarray(jc.grid_offset))
    assert tuple(out["cropped"].dist.shape) == tuple(jc.dist.shape)


def test_stress_field_matches_jax(stress_out):
    """The port's field of the stress draws is the JAX package's
    rasterize + EDT of the same points, bitwise."""
    pts, _ = stress.draws(16)
    occ = jsdf.rasterize(jnp.asarray(pts),
                         jnp.asarray(stress.ORIGIN, jnp.float32), 1.6,
                         (64, 64, 64))
    want = np.asarray(jsdf.edt(occ, 1.6, backend="jnp"))
    np.testing.assert_array_equal(_np(stress_out["dist"]), want)


def test_stress_timings_report(stress_out):
    """``time_stages`` reports every stage and the counts of the pass."""
    rep = stress.time_stages(stress_out, reps=1)
    assert rep["grid"] == [64, 64, 64] and rep["batch"] == 16
    assert rep["n_ok"] == rep["n_ok_uncropped"] == rep["bitwise_lanes"] == 16
    for k in ("edt_warm_s", "crop_s", "solve_s", "uncropped_solve_s",
              "kernel_inputs_s", "uncropped_kernel_inputs_s",
              "pipeline_e2e_s"):
        assert rep[k] > 0, k
