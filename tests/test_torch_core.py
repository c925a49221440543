"""PyTorch port, foundations: config, fixtures, the JAX-free import chain,
the no-fallback rule on a host without CUDA, and core/poly + core/qp
against the JAX package (float32) and the float64 golden model.

Inputs are made with numpy from a seed and fed to both packages.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import config as jcfg  # noqa: E402
from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu.core import poly as jpoly  # noqa: E402
from grad_traj_optimization_tpu.core import qp as jqp  # noqa: E402
from grad_traj_optimization_tpu.reference_impl import golden  # noqa: E402

from grad_traj_optimization_torch import _build  # noqa: E402
from grad_traj_optimization_torch import config as tcfg  # noqa: E402
from grad_traj_optimization_torch import fixtures as tfix  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.core import qp as tqp  # noqa: E402
from grad_traj_optimization_torch.ops import edt_cuda  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRESETS = [
    "OPTI_NODE_CONFIG", "TEXT_INPUT_CONFIG", "CLICK_CONFIG",
    "COMPARE2_CONFIG", "TURBO_CONFIG", "TURBO_FAST_CONFIG",
    "TURBO_POLISH_CONFIG", "TURBO_SAFE_CONFIG",
]


# ---------------------------------------------------------------- config


def test_optimizer_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.OptimizerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.OptimizerConfig)]
    assert tf == jf


def test_map_config_matches():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.MapConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.MapConfig)]
    assert tf == jf
    for kw in ({}, dict(resolution=0.25, map_size=(10.0, 7.3, 4.0))):
        assert tcfg.MapConfig(**kw).grid_shape == jcfg.MapConfig(**kw).grid_shape
        assert tcfg.MapConfig(**kw).n_voxels == jcfg.MapConfig(**kw).n_voxels


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match(name):
    assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(
        getattr(jcfg, name)
    )


@pytest.mark.parametrize("kw", [
    dict(gradient_mode="bogus"), dict(accept_window=0),
    dict(seed_mode="bogus"), dict(polish_iters=3),
    dict(lookup_precision="low"), dict(dual_ms_window=-1),
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        jcfg.OptimizerConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.OptimizerConfig(**kw)


# -------------------------------------------------------------- fixtures


@pytest.mark.parametrize("seed,n_wp,P", [(0, 7, 4096), (5, 4, 300)])
def test_random_scenarios_equal(seed, n_wp, P):
    a = jfix.random_scenarios(4, n_waypoints=n_wp, seed=seed,
                              max_obstacle_points=P)
    b = tfix.random_scenarios(4, n_waypoints=n_wp, seed=seed,
                              max_obstacle_points=P)
    assert dataclasses.asdict(a[0]) == dataclasses.asdict(b[0])
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["opti_node_scenario",
                                  "text_input_scenario"])
def test_demo_fixtures_equal(name):
    a = getattr(jfix, name)()
    b = getattr(tfix, name)()
    assert dataclasses.asdict(a[0]) == dataclasses.asdict(b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def test_frange_grid_equal():
    spec = [(0.05, 3.0, 0.2), (2.05, 2.7, 0.2), (-1.0, 1.0, 0.25)]
    np.testing.assert_array_equal(jfix._frange_grid(spec),
                                  tfix._frange_grid(spec))


# ------------------------------------------------- import chain, no CUDA


def test_import_leaves_jax_out():
    """Importing the port (and every module of it), ``chip_smoke.py``,
    ``bench_torch.py`` and the JAX-free scripts and demos pulls in no
    jax."""
    code = (
        "import sys, grad_traj_optimization_torch, "
        "grad_traj_optimization_torch.checkpoint, "
        "grad_traj_optimization_torch.convert, "
        "grad_traj_optimization_torch.fixtures, "
        "grad_traj_optimization_torch.harness, "
        "grad_traj_optimization_torch.pipeline, "
        "grad_traj_optimization_torch.native, "
        "grad_traj_optimization_torch.parallel, "
        "grad_traj_optimization_torch.parallel.edt_sharded, "
        "grad_traj_optimization_torch.parallel.mesh, "
        "grad_traj_optimization_torch.replan, "
        "grad_traj_optimization_torch.serving, "
        "grad_traj_optimization_torch.fields.dynamic, "
        "grad_traj_optimization_torch.search.grid_search, "
        "grad_traj_optimization_torch.search.kinodynamic, "
        "grad_traj_optimization_torch.search.predictor, "
        "grad_traj_optimization_torch.search.rdp, "
        "grad_traj_optimization_torch.search.rrt, "
        "grad_traj_optimization_torch.utils.profiling, "
        "grad_traj_optimization_torch.viz;"
        "sys.path[:0] = ['scripts', 'examples'];"
        "import chip_smoke, stress_pipeline_512_torch, monte_carlo_torch, "
        "demo_torch, mission_demo_torch, bench_torch, _bench_common_torch, "
        "serve_bench_torch, mission_serve_bench_torch, "
        "bench_replan_tick_torch, beam_vs_exact_torch;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('grad_traj_optimization_tpu')];"
        "assert not bad, bad; print('ok')"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_demo_torch_runs_in_process(tmp_path, capsys):
    """``examples/demo_torch.py``'s ``main`` runs in the caller's process
    (as ``chip_smoke.py`` runs it): status 0 on the opti_node scenario,
    printed, and the scene exported with the JAX fixture's waypoints, the
    trajectory starting and ending on the first and last."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import demo_torch
    finally:
        sys.path.pop(0)
    assert demo_torch.main([str(tmp_path), "cpu"]) == 0
    assert "status 0" in capsys.readouterr().out
    scene = np.load(tmp_path / "scene.npz")
    wp = np.asarray(jfix.opti_node_scenario()[2], np.float32)
    np.testing.assert_array_equal(scene["waypoints"], wp)
    np.testing.assert_allclose(scene["traj"][[0, -1]], wp[[0, -1]],
                               atol=1e-3)


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "grad_traj_optimization_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith((
                            "import jax", "from jax",
                            "import grad_traj_optimization_tpu",
                            "from grad_traj_optimization_tpu",
                        )), (f, s)


def test_cuda_request_raises_without_gpu():
    """Without a GPU, asking for the kernels raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError):
        _build.load()
    from grad_traj_optimization_torch import solver
    mc, obs, wp = tfix.opti_node_scenario()
    with pytest.raises((RuntimeError, AssertionError)):
        solver.make_scenario(wp, obs, mc, device="cuda")


def test_wrapper_rejects_non_cpu_non_cuda_tensor():
    f = torch.zeros((4, 8), device="meta")
    calls = profiling.counter("plain.minplus_lines")
    with pytest.raises(ValueError):
        edt_cuda.minplus_lines(f)
    assert profiling.counter("plain.minplus_lines") == calls


def test_kernel_build_key_covers_sources():
    h = _build.source_hash()
    assert len(h) == 16 and _build.library_path().endswith(f"-{h}.so")
    assert {os.path.basename(p) for p in _build._sources()} >= {
        "minplus.cu", "trilinear.cuh", "trilinear.cu", "solve.cu",
    }


# ------------------------------------------------------------ core/poly


def _times(m, seed):
    return np.random.default_rng(seed).uniform(0.5, 3.0, size=m)


def _f32(a):
    return torch.as_tensor(np.array(a, np.float32))


def _np(t):
    return t.detach().cpu().numpy()


def _close(a, b, rtol=2e-5, atol_scale=2e-6):
    b = np.asarray(b)
    np.testing.assert_allclose(
        _np(a) if isinstance(a, torch.Tensor) else a, b, rtol=rtol,
        atol=atol_scale * max(1.0, float(np.abs(b).max())),
    )


@pytest.mark.parametrize("fn", ["segment_ainv", "segment_snap_form"])
def test_segment_kernels_match_jax(fn):
    T = _times(6, 1)
    _close(getattr(tpoly, fn)(_f32(T)),
           getattr(jpoly, fn)(jnp.asarray(T, jnp.float32)))


@pytest.mark.parametrize("fn", ["time_powers", "vel_powers", "acc_powers"])
def test_basis_rows_match_jax(fn):
    t = np.random.default_rng(2).uniform(0, 3.0, size=(4, 7))
    _close(getattr(tpoly, fn)(_f32(t)),
           getattr(jpoly, fn)(jnp.asarray(t, jnp.float32)))


def _poly_case(seed=3, m=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, 3, 6)), _times(m, seed)


@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_evaluate_matches_jax(deriv):
    coeff, T = _poly_case()
    t = np.random.default_rng(4).uniform(0, T.sum(), size=50)
    t[:3] = [0.0, T[0], T.sum()]  # segment edges and the end
    a = tpoly.evaluate(_f32(coeff), _f32(T), _f32(t), deriv)
    b = jpoly.evaluate(jnp.asarray(coeff, jnp.float32),
                       jnp.asarray(T, jnp.float32),
                       jnp.asarray(t, jnp.float32), deriv)
    _close(a, b, rtol=1e-4, atol_scale=1e-5)


def test_evaluate_batched_equals_unbatched():
    cs, Ts = zip(*[_poly_case(seed) for seed in (5, 6, 7)])
    coeff, T = _f32(np.stack(cs)), _f32(np.stack(Ts))
    pb, tb = tpoly.sample_uniform(coeff, T, 33)
    for i in range(3):
        p, t = tpoly.sample_uniform(coeff[i], T[i], 33)
        torch.testing.assert_close(pb[i], p, rtol=0, atol=0)
        torch.testing.assert_close(tb[i], t, rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["length", "jerk_cost", "acc_cost",
                                "mean_max_speed", "mean_max_acc"])
def test_metrics_match_jax(fn):
    coeff, T = _poly_case(8)
    a = getattr(tpoly, fn)(_f32(coeff), _f32(T))
    b = getattr(jpoly, fn)(jnp.asarray(coeff, jnp.float32),
                           jnp.asarray(T, jnp.float32))
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        _close(x, y, rtol=1e-4, atol_scale=1e-6)


def test_segment_ainv_float64_matches_golden_dense_inverse():
    T = _times(5, 9)
    ainv = _np(tpoly.segment_ainv(torch.as_tensor(T)))
    dense = np.linalg.inv(golden.mapping_matrix(T))
    for s in range(5):
        np.testing.assert_allclose(
            ainv[s], dense[6 * s:6 * s + 6, 6 * s:6 * s + 6], rtol=1e-9,
            atol=1e-12,
        )


# -------------------------------------------------------------- core/qp


@pytest.mark.parametrize("m", [2, 3, 6, 10])
def test_selection_maps_equal(m):
    np.testing.assert_array_equal(tqp.opt_dmap(m), jqp.opt_dmap(m))
    np.testing.assert_array_equal(tqp.opt_selection(m), golden.opt_ct(m))


def test_build_dep_matches_jax_and_golden():
    T = _times(6, 10)
    dep = tqp.build_dep(_f32(T))
    jdep = jqp.build_dep(jnp.asarray(T, jnp.float32))
    for k in ("L", "Ldp", "R", "Rfp", "Rpp"):
        _close(getattr(dep, k), getattr(jdep, k), rtol=1e-4, atol_scale=1e-5)
    g = golden.GoldenDeps(T)
    dep64 = tqp.build_dep(torch.as_tensor(T))
    for k in ("L", "R", "Rfp", "Rpp"):
        np.testing.assert_allclose(
            _np(getattr(dep64, k)), getattr(g, k), rtol=1e-8,
            atol=1e-10 * np.abs(getattr(g, k)).max(),
        )


def test_build_dep_batched_equals_unbatched():
    Ts = np.stack([_times(4, s) for s in (11, 12)])
    dep = tqp.build_dep(_f32(Ts))
    for i in range(2):
        one = tqp.build_dep(_f32(Ts[i]))
        for k in ("L", "Ldp", "R", "Rfp", "Rpp"):
            torch.testing.assert_close(getattr(dep, k)[i], getattr(one, k))


def _wps(seed, n=7, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, 3) if batch is None else (batch, n, 3)
    return rng.uniform(-5.0, 5.0, size=shape)


def test_straight_line_and_times_match_golden_float64():
    wp = _wps(13)
    times, Df, Dp = golden.straight_line_init(wp, 1.8, 0.3)
    tw = torch.as_tensor(wp)
    np.testing.assert_allclose(_np(tqp.allocate_times(tw, 1.8, 0.3)), times,
                               rtol=1e-12)
    Df_t, Dp_t = tqp.straight_line_d(tw)
    np.testing.assert_array_equal(_np(Df_t), Df)
    np.testing.assert_array_equal(_np(Dp_t), Dp)


def test_straight_line_batched_matches_jax():
    wp = _wps(14, batch=3)
    Df, Dp = tqp.straight_line_d(_f32(wp))
    for i in range(3):
        jDf, jDp = jqp.straight_line_d(jnp.asarray(wp[i], jnp.float32))
        np.testing.assert_array_equal(_np(Df[i]), np.asarray(jDf))
        np.testing.assert_array_equal(_np(Dp[i]), np.asarray(jDp))
        _close(tqp.allocate_times(_f32(wp), 1.8, 0.3)[i],
               jqp.allocate_times(jnp.asarray(wp[i], jnp.float32), 1.8, 0.3))


def test_min_snap_dp_matches_jax_and_golden():
    wp = _wps(15)
    T = _np(tqp.allocate_times(torch.as_tensor(wp), 1.8, 0.3))
    g = golden.GoldenDeps(T)
    _, Df, _ = golden.straight_line_init(wp, 1.8, 0.3)
    ref = np.linalg.solve(g.Rpp, -(Df @ g.Rfp).T).T
    dp64 = tqp.min_snap_dp(torch.as_tensor(Df), torch.as_tensor(g.Rpp),
                           torch.as_tensor(g.Rfp))
    np.testing.assert_allclose(_np(dp64), ref, rtol=1e-7, atol=1e-9)
    dep = jqp.build_dep(jnp.asarray(T, jnp.float32))
    jdp = jqp.min_snap_dp(jnp.asarray(Df, jnp.float32), dep.Rpp, dep.Rfp)
    tdp = tqp.min_snap_dp(_f32(Df), _f32(np.asarray(dep.Rpp)),
                          _f32(np.asarray(dep.Rfp)))
    _close(tdp, jdp, rtol=1e-3, atol_scale=1e-4)


def test_coeff_from_d_matches_jax_and_golden():
    wp = _wps(16)
    rng = np.random.default_rng(17)
    times, Df, Dp = golden.straight_line_init(wp, 1.8, 0.3)
    dp = Dp + rng.normal(scale=0.3, size=Dp.shape)
    gopt = golden.GoldenOptimizer(None, tcfg.OptimizerConfig())
    gopt.setup(wp)
    np.testing.assert_allclose(
        _np(tqp.coeff_from_d(torch.as_tensor(Df), torch.as_tensor(dp),
                             torch.as_tensor(times))),
        gopt.coeff_from_d(dp), rtol=1e-9, atol=1e-9,
    )
    _close(tqp.coeff_from_d(_f32(Df), _f32(dp), _f32(times)),
           jqp.coeff_from_d(jnp.asarray(Df, jnp.float32),
                            jnp.asarray(dp, jnp.float32),
                            jnp.asarray(times, jnp.float32)),
           rtol=1e-4, atol_scale=1e-5)
    np.testing.assert_array_equal(
        _np(tqp.stacked_derivatives(_f32(Df), _f32(dp), len(times))),
        np.asarray(jqp.stacked_derivatives(jnp.asarray(Df, jnp.float32),
                                           jnp.asarray(dp, jnp.float32),
                                           len(times))),
    )


def test_kino_d_and_coeff_match_jax():
    rng = np.random.default_rng(18)
    pos, vel, acc = (rng.normal(size=(7, 3)) for _ in range(3))
    T = _times(6, 19)
    for a, b in zip(tqp.kino_d(_f32(pos), _f32(vel), _f32(acc)),
                    jqp.kino_d(*(jnp.asarray(x, jnp.float32)
                                 for x in (pos, vel, acc)))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    _close(tqp.kino_coeff(_f32(pos), _f32(vel), _f32(acc), _f32(T)),
           jqp.kino_coeff(*(jnp.asarray(x, jnp.float32)
                            for x in (pos, vel, acc, T))),
           rtol=1e-4, atol_scale=1e-5)
    # batched == per lane
    Df, Dp = tqp.kino_d(*(_f32(np.stack([x, x[::-1]])) for x in (pos, vel,
                                                                  acc)))
    Df1, Dp1 = tqp.kino_d(_f32(pos[::-1]), _f32(vel[::-1]), _f32(acc[::-1]))
    torch.testing.assert_close(Df[1], Df1, rtol=0, atol=0)
    torch.testing.assert_close(Dp[1], Dp1, rtol=0, atol=0)


def test_straight_line_start_state_matches_jax():
    wp = _wps(20)
    sv, sa = np.array([0.5, -1.0, 0.2]), np.array([0.1, 0.0, -0.3])
    Df, Dp = tqp.straight_line_d(_f32(wp), start_vel=_f32(sv),
                                 start_acc=_f32(sa))
    jDf, jDp = jqp.straight_line_d(jnp.asarray(wp, jnp.float32),
                                   start_vel=jnp.asarray(sv, jnp.float32),
                                   start_acc=jnp.asarray(sa, jnp.float32))
    np.testing.assert_array_equal(_np(Df), np.asarray(jDf))
    np.testing.assert_array_equal(_np(Dp), np.asarray(jDp))
