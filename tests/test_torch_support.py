"""PyTorch port, the support modules and public names: ``viz``,
``checkpoint`` (cross-read with the JAX package both ways),
``utils.profiling``, ``qp.min_snap_coeff`` / ``minsnap_dmap``,
``poly.jerk_powers`` / ``VSHIFT``, ``sdf.edt_brute_force`` /
``max_distance`` and ``fixtures.random_scenarios_device``, against the
JAX package on the same numpy-seeded inputs.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import checkpoint as jckpt  # noqa: E402
from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu import solver as jsolver  # noqa: E402
from grad_traj_optimization_tpu import viz as jviz  # noqa: E402
from grad_traj_optimization_tpu.config import MapConfig  # noqa: E402
from grad_traj_optimization_tpu.config import (  # noqa: E402
    OptimizerConfig as JConfig,
)
from grad_traj_optimization_tpu.core import poly as jpoly  # noqa: E402
from grad_traj_optimization_tpu.core import qp as jqp  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402
from grad_traj_optimization_tpu.reference_impl import golden  # noqa: E402

from grad_traj_optimization_torch import checkpoint as tckpt  # noqa: E402
from grad_traj_optimization_torch import convert  # noqa: E402
from grad_traj_optimization_torch import fixtures as tfix  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch import viz as tviz  # noqa: E402
from grad_traj_optimization_torch.core import poly as tpoly  # noqa: E402
from grad_traj_optimization_torch.core import qp as tqp  # noqa: E402
from grad_traj_optimization_torch.fields import sdf as tsdf  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def solved():
    """The JAX package's small viz/checkpoint scene (tests/test_misc.py:
    156-170), solved by both packages from the same numpy arrays."""
    map_cfg = MapConfig(origin=(-5.0, -5.0, 0.0), resolution=0.5,
                        map_size=(10.0, 10.0, 4.0))
    wp = np.array([[0, -2, 2], [0.5, 0, 2], [0, 2, 2]], np.float32)
    obss = np.array([[1.0, 0.0, z] for z in np.arange(0.25, 4, 0.5)])
    jscn = jsolver.make_scenario(wp, obss, map_cfg)
    cfg = JConfig(iters_step2=5)
    jsol = jsolver.solve(jscn, cfg=cfg, steps=(2,), record_trace=True)
    tscn = convert.scenario_from_numpy(
        *(np.asarray(x) for x in jscn[:4]), device="cpu")
    return jscn, jsol, tscn


# ------------------------------------------------------------------- viz


def test_scene_arrays_match_jax(solved):
    """scene_arrays of the same Solution and Scenario: the copied arrays
    exactly, the sampled trajectory to float32 rounding."""
    jscn, jsol, tscn = solved
    tsol = tsolver.Solution(*(torch.as_tensor(np.asarray(x)) for x in jsol))
    a, b = tviz.scene_arrays(tsol, tscn), jviz.scene_arrays(jsol, jscn)
    assert set(a) == set(b)
    for k in ("segment_times", "coeff", "cost_trace", "waypoints", "origin",
              "resolution", "occupied", "dist_slice_mid_z"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("traj", "vel", "t"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_viz_export_and_plots(solved, tmp_path):
    """export_npz writes the scene; the plot functions draw it (matplotlib
    imported by them only)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, jsol, tscn = solved
    tsol = tsolver.Solution(*(torch.as_tensor(np.asarray(x)) for x in jsol))
    data = np.load(tviz.export_npz(str(tmp_path / "scene.npz"), tsol, tscn))
    assert data["traj"].shape == (400, 3) and data["occupied"].shape[1] == 3
    tviz.plot_topdown(tsol, tscn)
    tviz.plot_cost_curve(tsol)
    ax = tviz.plot_esdf_layers(tscn.dist, tscn.origin, tscn.resolution,
                               n_layers=4)
    assert len(ax.get_images()) == 4
    tviz.animate_trajectory(tsol, tscn, path=str(tmp_path / "frames"),
                            fps=5, speedup=8.0, n_samples=60)
    assert len(os.listdir(tmp_path / "frames")) >= 2
    plt.close("all")


# ------------------------------------------------------------ checkpoint


@pytest.mark.parametrize("direction", ["port to JAX", "JAX to port"])
def test_checkpoint_cross_read(solved, tmp_path, monkeypatch, direction):
    """One npz layout (``leaf_{i}`` in field order): the JAX package's
    restore reads the port's checkpoint through its npz branch, and the
    port reads the JAX package's npz fallback (orbax hidden from it)."""
    _, jsol, _ = solved
    tsol = tsolver.Solution(*(torch.as_tensor(np.asarray(x)) for x in jsol))
    if direction == "port to JAX":
        path = tckpt.save(str(tmp_path / "sol"), tsol)
        assert path.endswith(".npz") and os.path.isfile(path)
        back = jckpt.restore(path, jsol)
        for a, b in zip(back, jsol):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
        path = jckpt.save(str(tmp_path / "sol"), jsol)
        assert os.path.isfile(path)
        back = tckpt.restore(path, tsol)
        for a, b in zip(back, tsol):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
            assert torch.equal(a, b)


def test_checkpoint_round_trip_keeps_structure(tmp_path):
    """Nested tuples, dicts (by sorted key) and None subtrees come back
    with their leaves' dtypes; non-tensor leaves as numpy arrays."""
    tree = {"b": (torch.arange(3, dtype=torch.int32), None),
            "a": [torch.ones(2, 2, dtype=torch.float64), np.float32(2.5)]}
    path = tckpt.save(str(tmp_path / "tree.npz"), tree)
    assert path == str(tmp_path / "tree.npz")
    back = tckpt.restore(path, tree)
    assert list(back) == ["b", "a"] and back["b"][1] is None
    assert torch.equal(back["b"][0], tree["b"][0])
    assert back["a"][0].dtype == torch.float64
    assert float(back["a"][1]) == 2.5
    with np.load(path) as npz:
        assert sorted(npz.files) == ["leaf_0", "leaf_1", "leaf_2"]
        np.testing.assert_array_equal(npz["leaf_2"], [0, 1, 2])


# ------------------------------------------------------------- profiling


def test_profiling_helpers(tmp_path, monkeypatch):
    """The tracer and the exporter: a span times its block whether or not
    a profiler records, keeps a record only while one does, and appears
    as a ``gtop.`` range in the Chrome trace ``device_trace`` writes;
    counters add, read and reset by prefix; ``to_host`` counts its site
    for a tensor on a card (here one taken for it), not a host tensor."""
    profiling.reset_spans()
    profiling.reset_counters("helpers.")
    profiling.reset_counters("sync.helpers.")
    profiling.to_host(torch.ones(2), "helpers.host")
    assert profiling.counters("sync.helpers.") == {}
    monkeypatch.setattr(profiling, "waits", lambda device: True)
    with profiling.span("helpers.off") as s:
        sum(range(1000))
    assert s.seconds > 0 and profiling.spans() == []
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("helpers.outer") as outer:
            profiling.add("helpers.n", 2)
            with profiling.span("helpers.inner"):
                x = profiling.to_host(torch.ones(64).cumsum(0),
                                      "helpers.cumsum")
    assert float(x[-1]) == 64.0
    inner, rec = profiling.spans()
    assert rec is outer.rec and rec.name == "helpers.outer"
    assert rec.seconds == outer.seconds and rec.parent is None
    assert inner.parent == rec.id and inner.root == rec.id
    assert rec.counts == {"helpers.n": 2, "sync.helpers.cumsum": 1}
    assert inner.counts == {"sync.helpers.cumsum": 1}
    assert profiling.counter("helpers.n") == 2
    assert profiling.counters("helpers.") == {"helpers.n": 2}
    profiling.reset_counters("helpers.")
    assert profiling.counter("helpers.n") == 0
    profiling.reset_spans()
    assert profiling.spans() == []
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        text = f.read()
    assert "cumsum" in text and "gtop.helpers.inner" in text


# ----------------------------------------------------------- public names


def test_min_snap_coeff_matches_jax_and_golden():
    """float32 against the JAX package; float64 against the dense
    float64 solve of qp_generator.cpp:242-315 (tests/test_qp.py:121-164)."""
    rng = np.random.default_rng(7)
    m = 5
    wp = rng.uniform(-4, 4, size=(m + 1, 3))
    T = rng.uniform(0.6, 2.0, size=m)
    sv, sa, ev, ea = (rng.normal(size=3) for _ in range(4))
    f32 = [x.astype(np.float32) for x in (wp, sv, sa, ev, ea, T)]
    a = _np(tqp.min_snap_coeff(*(torch.as_tensor(x) for x in f32)))
    b = np.asarray(jqp.min_snap_coeff(*f32))
    np.testing.assert_allclose(a, b, rtol=1e-4,
                               atol=1e-4 * np.abs(b).max())

    num_f = 2 * m + 4
    idx = jqp.minsnap_dmap(m)
    ct = np.zeros((6 * m, 4 * m + 2))
    ct[np.arange(6 * m), idx] = 1.0
    A = golden.mapping_matrix(T)
    Ainv = np.linalg.inv(A)
    R = ct.T @ Ainv.T @ golden.snap_hessian(T) @ Ainv @ ct
    want = np.zeros((m, 3, 6))
    for ax in range(3):
        df = np.concatenate([[wp[0, ax], sv[ax], sa[ax], wp[1, ax]],
                             *[[wp[s, ax], wp[s + 1, ax]]
                               for s in range(1, m)], [ev[ax], ea[ax]]])
        dp = -np.linalg.solve(R[num_f:, num_f:], R[:num_f, num_f:].T @ df)
        P = np.linalg.solve(A, np.concatenate([df, dp])[idx])
        want[:, ax] = P.reshape(m, 6)
    got = _np(tqp.min_snap_coeff(torch.as_tensor(wp), sv, sa, ev, ea, T))
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 2, 3, 6, 10])
def test_minsnap_dmap_equal(m):
    np.testing.assert_array_equal(tqp.minsnap_dmap(m), jqp.minsnap_dmap(m))


def test_jerk_powers_and_vshift_equal():
    t = np.random.default_rng(2).uniform(0, 3.0, size=(4, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(_np(tpoly.jerk_powers(torch.as_tensor(t))),
                                  np.asarray(jpoly.jerk_powers(t)))
    assert tpoly.VSHIFT.dtype == jpoly.VSHIFT.dtype
    np.testing.assert_array_equal(tpoly.VSHIFT, jpoly.VSHIFT)


@pytest.mark.parametrize("shape", [(5, 6, 4), (3, 3, 9)])
def test_edt_brute_force_and_max_distance_equal(shape):
    rng = np.random.default_rng(sum(shape))
    occ = (rng.random(shape) < 0.1).astype(np.float32)
    occ.flat[0] = 1.0
    a = _np(tsdf.edt_brute_force(torch.as_tensor(occ), 0.2))
    b = np.asarray(jsdf.edt_brute_force(jnp.asarray(occ), 0.2))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _np(tsdf.edt(torch.as_tensor(occ),
                                                  0.2)))
    assert float(tsdf.max_distance(torch.as_tensor(a))) == float(
        jsdf.max_distance(jnp.asarray(b)))


@pytest.mark.parametrize("n_wp", [5, 7])
def test_random_scenarios_device_rasterization_equal(n_wp):
    """The rasterization of the JAX package's own draws: occupancy and
    the waypoints' x and z bitwise; the y linspace within 1e-6 m (the
    last bits of jnp.linspace's float32 arithmetic depend on how XLA
    simplifies it)."""
    key = jax.random.PRNGKey(3)
    n = 3
    occ_j, wps_j = jfix.random_scenarios_device(key, n, n_waypoints=n_wp)
    kc, ks, kh, kx, kz = jax.random.split(key, 5)
    draws = (
        jax.random.uniform(kc, (n, 8, 2), minval=-6.0, maxval=6.0),
        jax.random.uniform(ks, (n, 8, 2), minval=0.4, maxval=1.6),
        jax.random.uniform(kh, (n, 8), minval=2.0, maxval=5.0),
        jax.random.uniform(kx, (n, n_wp), minval=-1.5, maxval=1.5),
        jax.random.uniform(kz, (n, n_wp), minval=1.5, maxval=3.0),
    )
    occ, wps = tfix.rasterize_boxes(*(torch.as_tensor(np.asarray(x))
                                      for x in draws))
    np.testing.assert_array_equal(_np(occ), np.asarray(occ_j))
    wj = np.asarray(wps_j)
    np.testing.assert_array_equal(_np(wps)[..., [0, 2]], wj[..., [0, 2]])
    np.testing.assert_allclose(_np(wps)[..., 1], wj[..., 1], rtol=0,
                               atol=1e-6)


def test_random_scenarios_device_draw():
    """The port's draw: shapes, ranges, a plausible obstacle density,
    determinism under one generator seed; the card by default."""
    def draw(seed):
        return tfix.random_scenarios_device(
            4, generator=torch.Generator().manual_seed(seed), device="cpu")

    occ, wps = draw(3)
    assert occ.shape == (4, 100, 100, 25) and wps.shape == (4, 7, 3)
    assert occ.dtype == wps.dtype == torch.float32
    assert 0.001 < float(occ.mean()) < 0.1
    x, z = _np(wps[..., 0]), _np(wps[..., 2])
    assert (-1.5 <= x).all() and (x <= 1.5).all()
    assert (1.5 <= z).all() and (z <= 3.0).all()
    np.testing.assert_allclose(_np(wps[..., 1]),
                               np.broadcast_to(np.linspace(-7, 7, 7), (4, 7)),
                               atol=1e-6)
    occ2, wps2 = draw(3)
    assert torch.equal(occ, occ2) and torch.equal(wps, wps2)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tfix.random_scenarios_device(1)
