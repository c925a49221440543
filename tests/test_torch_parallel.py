"""The port's ``parallel`` package on gloo CPU ranks against the JAX
package's ``parallel`` package and the port's one-process calls.

The ranks are processes of ``scripts/multihost_worker_torch.py`` (torch
and the port only) on a free localhost port.  The inputs are the worker's
``suite_inputs()``, made with numpy from seeds (the fields by the port's
CPU EDT, bitwise the JAX package's) and passed by ``.npz`` in a temporary
directory; the JAX side runs in this process on conftest's 8 virtual CPU
devices.  One 4-rank run serves every case of the suite.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grad_traj_optimization_tpu import solver as jsolver
from grad_traj_optimization_tpu.config import OptimizerConfig as JConfig
from grad_traj_optimization_tpu.core import poly as jpoly
from grad_traj_optimization_tpu.parallel import edt_sharded as jedt
from grad_traj_optimization_tpu.parallel import mesh as jmesh

from grad_traj_optimization_torch import convert, fixtures as tfix
from grad_traj_optimization_torch import solver as tsolver
from grad_traj_optimization_torch.core import poly as tpoly
from grad_traj_optimization_torch.fields import sdf as tsdf
from grad_traj_optimization_torch.search import kinodynamic as tkd
from grad_traj_optimization_torch.search import predictor as tpred

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker_torch.py")
_spec = importlib.util.spec_from_file_location("multihost_worker_torch",
                                               WORKER)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)
WORLD = 4
MESHES = ("data", "space", "2x2")
EDT_RES = worker.EDT_RES
#: the worker's budgets (the JAX package's tests/test_parallel.py)
SOLVE_CFG = dict(iters_step1=3, iters_step2=5)
GLOBAL_CFG = dict(iters_step1=5, iters_step2=15)
SEARCH_KW = worker.SEARCH_KW


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_suite")
    inputs = worker.suite_inputs()
    np.savez(d / "inputs.npz", **inputs)
    result = worker.run_ranks(WORLD, "suite", d, "cpu")
    with np.load(d / "outputs.npz") as z:
        outputs = dict(z)
    return dict(inputs=inputs, outputs=outputs, result=result)


def _solution(out, tag):
    return tsolver.Solution(*(torch.as_tensor(out[f"solve_{tag}_{k}"])
                              for k in tsolver.Solution._fields))


def _tscn(inputs, sl=slice(None)):
    return convert.scenario_from_numpy(
        inputs["solve_dist"][sl], inputs["solve_origin"][sl],
        inputs["solve_res"][sl], inputs["solve_wps"][sl], device="cpu")


@pytest.fixture(scope="module")
def jax_solve(suite):
    """The JAX package's sharded_solve of the same batch over 4 devices."""
    inp = suite["inputs"]
    scn = jsolver.Scenario(*(jnp.asarray(inp[k]) for k in (
        "solve_dist", "solve_origin", "solve_res", "solve_wps")))
    return jmesh.sharded_solve(scn, jmesh.make_mesh(n_data=4, n_space=1),
                               cfg=JConfig(**SOLVE_CFG), steps=(2,),
                               record_trace=True)


@pytest.fixture(scope="module")
def f64_costs(suite):
    """The port's own float64 run of the batch: the referee of a lane on
    which the float32 runs part."""
    scn = _tscn(suite["inputs"]).map(lambda x: x.double())
    return tsolver.solve_batch(
        scn, cfg=tsolver.OptimizerConfig(**SOLVE_CFG)).cost.numpy()


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_solve_matches_jax(suite, jax_solve, f64_costs, tag):
    """The repo's short-budget rule, equal n_accept, cost rtol 5e-3 and
    sampled positions within 1e-3 m, on every lane but at most one
    chaotic lane: one on which the port's own float64 run parts (beyond
    5e-3) from both float32 runs, so that rounding alone decides where
    either lands.  There n_accept must still be equal and the cost trace
    within 5e-3 up to the last iteration.  (Lane 9 of this batch starts
    inside obstacles, cost 6.6e5; at its fifth iteration the port's
    float32, float64 and the JAX package's float32 runs land at 3339,
    3491 and 4863.)"""
    tsol = _solution(suite["outputs"], tag)
    tp, _ = tpoly.sample_uniform(tsol.coeff, tsol.T, 100)
    jp = jax.vmap(lambda c, T: jpoly.sample_uniform(c, T, 100)[0])(
        jax_solve.coeff, jax_solve.T)
    tc, jc = tsol.cost.numpy(), np.asarray(jax_solve.cost)
    perr = np.abs(tp.numpy() - np.asarray(jp)).max(axis=(1, 2))
    np.testing.assert_array_equal(tsol.n_accept.numpy(),
                                  np.asarray(jax_solve.n_accept))
    ok = (np.abs(tc - jc) <= 5e-3 * np.abs(jc)) & (perr < 1e-3)
    chaotic = (np.abs(f64_costs - tc) > 5e-3 * np.abs(f64_costs)) \
        & (np.abs(f64_costs - jc) > 5e-3 * np.abs(f64_costs))
    assert (ok | chaotic).all() and (~ok).sum() <= 1, np.nonzero(~ok)
    np.testing.assert_allclose(tsol.cost_trace.numpy()[:, :-1],
                               np.asarray(jax_solve.cost_trace)[:, :-1],
                               rtol=5e-3)
    assert (tsol.status.numpy() == 0).all()


@pytest.mark.parametrize("tag", MESHES)
def test_sharded_solve_bitwise_one_process(suite, tag):
    """Each rank's lanes bitwise the port's solve_batch of the same rows,
    on the rank (its own check, for a whole batch and for one placed by
    shard_scenarios) and here, row block by row block."""
    checks = suite["result"]["checks"]
    assert all(c[f"solve_rows_bitwise_{tag}"] for c in checks)
    assert all(c[f"shard_scenarios_bitwise_{tag}"] for c in checks)
    n_data = {"data": 4, "space": 1, "2x2": 2}[tag]
    got = _solution(suite["outputs"], tag)
    b = 16 // n_data
    cfg = tsolver.OptimizerConfig(**SOLVE_CFG)
    for r in range(n_data):
        sl = slice(r * b, (r + 1) * b)
        want = tsolver.solve_batch(_tscn(suite["inputs"], sl), cfg=cfg)
        for a, w in zip(got, want):
            torch.testing.assert_close(a[sl], w, rtol=0, atol=0)


@pytest.mark.parametrize("tag", MESHES)
def test_convergence_stats_world_wide(suite, tag):
    """n_ok, mean_cost and mean_accept over the whole batch, the same on
    every mesh shape and equal to the gathered solution's."""
    stats = suite["result"]["checks"][0][f"stats_{tag}"]
    sol = _solution(suite["outputs"], tag)
    assert stats["n_ok"] == 16.0
    np.testing.assert_allclose(stats["mean_cost"],
                               sol.cost.double().mean().item(), rtol=1e-12)
    np.testing.assert_allclose(stats["mean_accept"],
                               sol.n_accept.double().mean().item(),
                               rtol=1e-12)
    base = suite["result"]["checks"][0]["stats_data"]
    for k, v in base.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-12)
    for c in suite["result"]["checks"]:
        assert c[f"stats_{tag}"] == stats


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("grid", ["a", "b", "empty", "full", "long"])
def test_edt_sharded_bitwise_and_against_jax(suite, grid, tag):
    """Bitwise the port's one-process sdf.edt, within 1e-5 of the JAX
    package's edt_sharded over 4 devices ("long": x lines of 4104
    cells, past K1's staged kernel)."""
    occ = suite["inputs"][f"edt_{grid}"]
    got = suite["outputs"][f"edt_{grid}_{tag}"]
    want = tsdf.edt(torch.as_tensor(occ), EDT_RES).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    jgot = jedt.edt_sharded(jnp.asarray(occ), EDT_RES,
                            jmesh.make_mesh(n_data=1, n_space=4))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-5)
    if grid == "empty":
        assert (got == tsdf.FREE_DIST).all()
    if grid == "full":
        assert (got == 0.0).all()


@pytest.mark.parametrize("tag", MESHES)
def test_edt_sharded_prev_dist(suite, tag):
    """With a previous buffer: bitwise the port's sdf.edt with the same
    ``prev_dist`` (the minimum of the two, no cap)."""
    inp = suite["inputs"]
    want = tsdf.edt(torch.as_tensor(inp["edt_b"]), EDT_RES,
                    prev_dist=torch.as_tensor(inp["prev_b"])).numpy()
    got = suite["outputs"][f"prev_b_{tag}"]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got <= inp["prev_b"]).all() and (got < inp["prev_b"]).any()


@pytest.mark.parametrize("mode", ["static", "dynamic", "shared"])
def test_sharded_search_bitwise_one_process(suite, mode):
    """Gathered over 4 ranks (2 lanes each), bitwise the port's
    search_batch of the whole batch here, and on each rank bitwise its
    search_batch of its own rows."""
    assert all(c[f"search_rows_bitwise_{mode}"]
               for c in suite["result"]["checks"])
    inp = suite["inputs"]
    dists = inp["search_dists"][:1] if mode == "shared" \
        else inp["search_dists"]
    kw = {}
    if mode == "dynamic":
        kw = dict(obstacle_pred=tpred.ObjPrediction(
            *(torch.as_tensor(inp[f"pred_{k}"])
              for k in ("poly", "t1", "t2", "scale"))),
            start_times=inp["search_t0s"])
    want = tkd.search_batch(dists, inp["search_origins"],
                            float(inp["search_res"]), inp["search_starts"],
                            inp["search_goals"], device="cpu", **kw,
                            **SEARCH_KW)
    for k, w in want._asdict().items():
        got = torch.as_tensor(suite["outputs"][f"search_{mode}_{k}"])
        torch.testing.assert_close(got, w, rtol=0, atol=0)


@pytest.mark.parametrize("case,want", [
    ("solve_indivisible_data", "ValueError: batch 5 not divisible by data "
                               "axis 4"),
    ("solve_indivisible_2x2", "ValueError: batch 3 not divisible by data "
                              "axis 2"),
    ("edt_indivisible_space", "ValueError: nx 5 not divisible by space "
                              "axis 4"),
    ("edt_indivisible_2x2", "ValueError: nx 3 not divisible by space "
                            "axis 2"),
    ("search_indivisible", "ValueError: batch 5 not divisible by data "
                           "axis 4"),
    ("search_array_kwarg", "TypeError: sharded_search kwarg 'bad_arg' must "
                           "be a static search option"),
    ("sharded_solve_fused", "ValueError: batch 5 not divisible by data "
                            "axis 4"),
])
def test_errors(suite, case, want):
    """The JAX package's errors: a batch the data axis does not divide
    (sharded_solve, sharded_solve_fused, sharded_search), nx the space
    axis does not divide, an array-valued search kwarg."""
    assert suite["result"]["errors"][case].startswith(want)


def test_multiprocess_global_scenarios(tmp_path):
    """tests/test_parallel.py's multi-process solve: 2 ranks each build
    only their rows, global_scenarios + sharded_solve; the world-wide
    stats within 1e-3 relative of one process's solve of the whole batch
    with the port."""
    stats = worker.run_ranks(2, "global", tmp_path, "cpu")
    assert stats["world"] == 2 and stats["n_ok"] == 8.0
    map_cfg, pts, valid, wps = tfix.random_scenarios(
        8, n_waypoints=5, seed=11, max_obstacle_points=1024)
    origin = torch.as_tensor(map_cfg.origin, dtype=torch.float32)
    occ = tsdf.rasterize(torch.as_tensor(pts, dtype=torch.float32), origin,
                         map_cfg.resolution, map_cfg.grid_shape,
                         valid_mask=torch.as_tensor(valid))
    scn = tsolver.Scenario(tsdf.edt_batch(occ, map_cfg.resolution),
                           origin.expand(8, 3).contiguous(),
                           torch.full((8,), map_cfg.resolution),
                           torch.as_tensor(wps, dtype=torch.float32))
    sol = tsolver.solve_batch(scn, cfg=tsolver.OptimizerConfig(**GLOBAL_CFG))
    ref = float(sol.cost.double().mean())
    assert abs(stats["mean_cost"] - ref) < 1e-3 * abs(ref)
    assert stats["mean_accept"] == float(sol.n_accept.double().mean())


def test_worker_defaults_to_the_card():
    """The worker is an entry point: its ranks run on the cards unless the
    caller asks for the CPU (the tests here pass "cpu")."""
    import inspect

    sig = inspect.signature(worker.run_ranks)
    assert sig.parameters["device"].default == "cuda"
    assert worker.parse_args(["1", "4", "2345", "suite", "/d"]) == (
        1, 4, 2345, "suite", "/d", "cuda")
    assert worker.parse_args(["0", "2", "2345", "fused", "/d", "cpu"])[-1] \
        == "cpu"
