"""PyTorch port, host engine: ``native.py`` (built with g++ into
``build/native/``) against the JAX package's bindings of the same
``native/gtop_core.cpp``, and the copies of ``search/rrt.py`` and
``search/rdp.py`` against the originals.

Inputs are made with numpy from a seed and fed to both packages; the
engine is deterministic, so every output is compared bitwise.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu import native as jnative  # noqa: E402
from grad_traj_optimization_tpu.config import OptimizerConfig  # noqa: E402
from grad_traj_optimization_tpu.search import rdp as jrdp  # noqa: E402
from grad_traj_optimization_tpu.search import rrt as jrrt  # noqa: E402

from grad_traj_optimization_torch import native  # noqa: E402
from grad_traj_optimization_torch import config as tconfig  # noqa: E402
from grad_traj_optimization_torch.search import rdp as trdp  # noqa: E402
from grad_traj_optimization_torch.search import rrt as trrt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engines():
    if not jnative.available():
        pytest.skip("the JAX package's native engine does not build here")
    native.load()
    return jnative, native


@pytest.fixture(scope="module")
def cases():
    """Three random search problems (pillars and gap walls), numpy."""
    rng = np.random.default_rng(3)
    out = []
    while len(out) < 3:
        c = jfix.random_search_case(rng)
        if c is not None:
            dist, origin, res, s, g = c
            out.append((np.asarray(dist, np.float32), np.asarray(origin),
                        float(res), np.concatenate([s, np.zeros(3)]),
                        np.concatenate([g, np.zeros(3)])))
    return out


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_library_builds_into_build_native(tmp_path, monkeypatch):
    """A fresh build lands in the given build directory, named by the
    source/flags/CPU hash, with its compiler log; ``native/`` is left
    as it was (its sources; the JAX package's own loader may build its
    library there meanwhile)."""
    src_dir = os.path.join(REPO, "native")

    def sources():
        return {f: os.path.getmtime(os.path.join(src_dir, f))
                for f in os.listdir(src_dir) if not f.endswith(".so")}

    before = sources()
    assert native.BUILD_DIR == os.path.join(REPO, "build", "native")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    lib = native.load()
    assert lib.gtop_abi_version() == native._ABI_VERSION
    path = native.library_path()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.exists(path) and os.path.exists(path + ".log")
    assert sources() == before


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No compiler: the load raises, nothing stale is kept or loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="compiler"):
        native.load()
    assert not native.available()
    assert os.listdir(tmp_path) == []


def test_failed_build_raises_with_log(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "out"))


def test_kino_search_bitwise(engines, cases):
    for dist, origin, res, s6, g6 in cases:
        for kw in ({}, dict(max_tau=1.0, margin=0.3, max_vel=2.5)):
            _equal(native.kino_search(dist, origin, res, s6, g6, **kw),
                   jnative.kino_search(dist, origin, res, s6, g6, **kw))


@pytest.mark.parametrize("kw", [{}, dict(use_init=True, heu_mode=3),
                                dict(shot_mode=1, max_tau=0.8)])
def test_hybrid_search_bitwise(engines, cases, kw):
    for dist, origin, res, s6, g6 in cases[:2]:
        _equal(native.hybrid_search(dist, origin, res, s6, g6,
                                    start_acc=(0.1, 0.0, 0.0), **kw),
               jnative.hybrid_search(dist, origin, res, s6, g6,
                                     start_acc=(0.1, 0.0, 0.0), **kw))


def test_free_shot_bitwise(engines):
    rng = np.random.default_rng(0)
    for _ in range(20):
        p0, p1, v0 = rng.normal(size=(3, 3)) * 3
        _equal(native.free_shot(p0, p1, v0), jnative.free_shot(p0, p1, v0))


def test_edt_and_trilinear_bitwise(engines, cases):
    rng = np.random.default_rng(1)
    occ = (rng.random((24, 20, 12)) < 0.02).astype(np.float32)
    _equal(native.edt(occ, 0.2), jnative.edt(occ, 0.2))
    dist, origin, res = cases[0][:3]
    q = rng.uniform(-9, 9, size=(500, 3)).astype(np.float32)
    q[:, 2] = np.abs(q[:, 2]) * 0.6
    _equal(native.trilinear(dist, origin, res, q),
           jnative.trilinear(dist, origin, res, q))


def test_solve_and_solve_batch_bitwise(engines, cases):
    dist, origin, res, s6, g6 = cases[0]
    jcfg = OptimizerConfig(iters_step2=20)
    tcfg = tconfig.OptimizerConfig(iters_step2=20)
    wp = np.linspace(s6[:3], g6[:3], 5)
    _equal(native.solve(dist, origin, res, wp, tcfg),
           jnative.solve(dist, origin, res, wp, jcfg))
    np.testing.assert_array_equal(native._cfg_arr(tcfg, (2,)),
                                  jnative._cfg_arr(jcfg, (2,)))
    wps = np.stack([wp, wp + [0.1, 0.0, 0.0]])
    _equal(native.solve_batch(dist[None], origin, res, wps, tcfg),
           jnative.solve_batch(dist[None], origin, res, wps, jcfg))


def test_native_rrt_planner_bitwise(engines):
    """The same tree from the same seed through grow, a map change with
    repair, a root commit and the traced result."""
    from conftest import gap_wall_map

    dist_a, origin, res = gap_wall_map(-0.9, 0.9, thickness_cells=2)
    dist_b = gap_wall_map(2.1, 3.9, thickness_cells=2)[0]
    start, goal = np.array([0.0, -3.0, 2.0]), np.array([0.0, 3.0, 2.0])
    out = []
    for mod in (native, jnative):
        p = mod.NativeRRTPlanner(dist_a, origin, res, start, goal, seed=1)
        trace = [p.grow(800), p.best_cost]
        r0 = p.result()
        trace += [p.update_map(dist_b, repair_iters=150), p.grow(300),
                  p.reset_root(r0.path[1]), p.commit_end, p.best_cost]
        r = p.result()
        out.append((trace, r.path, r.radii, r.reached, r.cost, r.n_nodes))
    _equal(out[0][1:], out[1][1:])
    assert out[0][0] == out[1][0]
    assert isinstance(native.NativeRRTPlanner(
        dist_a, origin, res, start, goal).result(), trrt.RRTResult)


def test_rrt_copy_matches():
    """The numpy RRT* copy: the same tree from the same seed (grow, map
    update with repair, commit, trim, corridor)."""
    from conftest import gap_wall_map

    dist_a, origin, res = gap_wall_map(-0.9, 0.9)
    dist_b = gap_wall_map(2.1, 3.9)[0]
    start, goal = np.array([0.0, -3.0, 2.0]), np.array([0.0, 3.0, 2.0])
    out = []
    for mod in (trrt, jrrt):
        p = mod.RRTPlanner(dist_a, origin, res, start, goal, seed=4)
        p.grow(400)
        r0 = p.result()
        p.update_map(dist_b, repair_iters=60)
        p.grow(200)
        p.reset_root(r0.path[min(2, len(r0.path) - 1)])
        r = p.result()
        trimmed = mod.trim_passed(r.path, r.radii, r.path[0] + 0.3)
        corr = mod.corridor_waypoints(r) if r.reached else None
        one = mod.plan(dist_a, origin, res, start, goal, max_iters=300,
                       seed=2)
        out.append((r.path, r.radii, r.reached, r.cost, r.n_nodes, trimmed,
                    corr, one.path, one.radii))
    _equal(out[0], out[1])


def test_rdp_simplify_copy_matches():
    rng = np.random.default_rng(5)
    for n in (2, 3, 17, 60):
        curve = np.cumsum(rng.normal(size=(n, 3)), axis=0)
        for eps in (0.1, 0.5, 2.0):
            _equal(trdp.simplify(curve, eps, return_index=True),
                   jrdp.simplify(curve, eps, return_index=True))


@pytest.mark.parametrize("n_valid", [2, 9, 40])
def test_rdp_simplify_masked_matches_jax(n_valid):
    """The tensor form against the JAX scan: equal keep masks on padded
    random polylines (padding repeats the last valid point)."""
    rng = np.random.default_rng(n_valid)
    n = 48
    curve = np.cumsum(rng.normal(size=(n, 3)), axis=0).astype(np.float32)
    curve[n_valid:] = curve[n_valid - 1]
    valid = np.arange(n) < n_valid
    for eps in (0.2, 1.0):
        for depth in (2, 10):
            j = np.asarray(jrdp.simplify_masked(jnp.asarray(curve),
                                                jnp.asarray(valid), eps,
                                                max_depth=depth))
            t = trdp.simplify_masked(torch.as_tensor(curve),
                                     torch.as_tensor(valid), eps,
                                     max_depth=depth)
            np.testing.assert_array_equal(t.numpy(), j)
