"""PyTorch port, the measurement entry points: ``bench_torch.py`` and the
``scripts/*_torch.py`` benches against the JAX package's scripts, on the
CPU at small sizes.

* ``bench_torch.run`` on 16 bench lanes: ``bench.py``'s keys, and the
  counts of the JAX package's functions on the same lanes;
* both Poisson sweeps, short: the JAX scripts' keys, every request
  answered and ok;
* the beam-vs-exact suite: ``tests/test_torch_beam_vs_exact.py``;
* the replan tick bench's report keys;
* every entry point raises on a host without a card when asked for it.
"""

import ast
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path[:0] = [REPO, SCRIPTS]

import _bench_common_torch as common  # noqa: E402
import beam_vs_exact_torch as bve  # noqa: E402
import bench_replan_tick_torch as tick  # noqa: E402
import bench_torch  # noqa: E402
import mission_serve_bench_torch as msb  # noqa: E402
import serve_bench_torch as sb  # noqa: E402

B = 16
@pytest.fixture(autouse=True, scope="module")
def share_of_the_cores():
    """The port's plain versions run thousands of small ops a row.  Under
    pytest-xdist the workers share the cores, and a pool of intra-op
    threads a worker contends for them (several times slower than one
    thread each); so a worker takes its share of the cores, and a run in
    one process keeps torch's default."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, min(n, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(n)


def dict_keys(path: str) -> set:
    """Every string key of a dict literal in a script's source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def jax_bench_counts():
    """The JAX package's functions on the same 16 bench lanes, as
    ``bench.py`` calls them: (status ok, reached static, reached dynamic,
    reached and converged in the pipeline, ladder ok)."""
    from _bench_common import build_bench_batch

    from grad_traj_optimization_tpu import pipeline
    from grad_traj_optimization_tpu import solver
    from grad_traj_optimization_tpu.config import OptimizerConfig
    from grad_traj_optimization_tpu.search import kinodynamic as kd
    from grad_traj_optimization_tpu.search import predictor

    cfg = OptimizerConfig()
    dist, origins, res, starts, goals, wps = build_bench_batch(B)
    ress = jnp.full((B,), res, jnp.float32)
    scns = solver.Scenario(dist=dist, origin=jnp.asarray(origins),
                           resolution=ress,
                           waypoints=jnp.asarray(wps, jnp.float32))
    sols = solver.solve_batch(scns, cfg=cfg, steps=(2,), record_trace=False)
    rb = kd.search_batch(dist, origins, res, starts, goals, max_iters=16,
                         beam=64)
    # bench.py:164-178's two drifting boxes a lane
    n_obj = 2
    hist = np.zeros((B, n_obj, 2, 3), np.float32)
    rng_d = np.random.default_rng(7)
    p0 = rng_d.uniform(-4, 4, (B, n_obj, 3))
    p0[..., 2] = rng_d.uniform(1.0, 3.0, (B, n_obj))
    v0 = rng_d.uniform(-0.6, 0.6, (B, n_obj, 3))
    hist[:, :, 0] = (p0 - 0.5 * v0).astype(np.float32)
    hist[:, :, 1] = p0.astype(np.float32)
    hist_t = np.broadcast_to(np.array([[-0.5, 0.0]], np.float32),
                             (B, n_obj, 2))
    scale = np.full((B, n_obj, 3), 0.8, np.float32)
    pred = jax.vmap(predictor.fit_const_vel)(
        jnp.asarray(hist), jnp.asarray(hist_t), jnp.asarray(scale))
    rd = kd.search_batch(dist, origins, res, starts, goals,
                         obstacle_pred=pred,
                         start_times=np.zeros(B, np.float32), max_iters=16,
                         beam=64)
    ra, _, _ = kd.search_batch_adaptive(dist, origins, res, starts, goals,
                                        max_iters=16, beam=64, retries=1)
    p6, v6, a6, t6 = kd.resample_knots_batch(ra.pos, ra.vel, ra.acc,
                                             ra.times, 6)
    sp = solver.solve_kino_batch(dist, jnp.asarray(origins), ress, p6, v6,
                                 a6, t6, cfg=cfg, steps=(2,))
    rl = pipeline.plan_batch(dist, origins, res, starts, goals, cfg=cfg,
                             beam=64, max_iters=16, retries=1,
                             host_fallback=True)
    return (int(jnp.sum(sols.status == 0)), int(jnp.sum(rb.reached)),
            int(jnp.sum(rd.reached)),
            int(jnp.sum(ra.reached & (sp.status == 0))), int(rl.ok.sum()))


def test_bench_torch_matches_jax(monkeypatch):
    """``bench_torch.run`` on 16 lanes (one warm call a row, 2 B=1 solves
    a sample, 8 opti_node lanes): ``bench.py``'s keys and no others but
    the port's note, and the JAX package's counts on the same lanes."""
    for name, value in (("REPS", 1), ("N_LATENCY", 2), ("N_QUEUED", 2),
                        ("OPTI_LANES", 8)):
        monkeypatch.setattr(bench_torch, name, value)
    out = bench_torch.run(batch=B, device="cpu")
    assert set(out) == (bench_torch.bench_py_keys()
                        | set(bench_torch.PORT_ONLY_KEYS))
    got = (out["n_status_ok"], out["frontend_reached"],
           out["frontend_dynamic_reached"], out["pipeline_ok_reached"],
           out["pipeline_ladder_ok"])
    assert got == jax_bench_counts()
    assert out["safe_cost_p99_ratio"] <= 1 + 1e-6
    assert out["opti_node_map_n_ok"] == 8
    assert out["opti_node_map_crop_bitwise_lanes"] == "8/8"
    assert out["batch"] == B and out["device"] == "cpu"
    assert np.isfinite([out["value"], out["p50_single_solve_ms"],
                        out["pipeline_ladder_plans_per_s"]]).all()


def test_serve_sweep_keys_and_results():
    """A short SolveServer sweep on the CPU: the JAX script's keys, every
    request answered with status ok."""
    server, submit = sb.setup("cpu", max_batch=4)
    try:
        (row,) = sb.sweep(server, submit, [20.0], duration=0.5)
    finally:
        server.shutdown()
    assert dict_keys(os.path.join(SCRIPTS, "serve_bench.py")) <= set(row)
    assert row["n_requests"] == 10 and row["n_status_ok"] == 10
    assert row["mean_batch"] >= 1 and row["achieved_req_per_s"] > 0


def test_mission_sweep_keys_and_results():
    """A short MissionServer sweep on the CPU: the JAX script's keys,
    every request answered, ``n_ok`` that of a direct ``plan_batch`` of
    the same missions."""
    server, submit, missions = msb.setup("cpu", max_batch=2, warm=False,
                                         n_missions=8)
    try:
        (row,) = msb.sweep(server, submit, [8.0], duration=0.5)
    finally:
        server.shutdown()
    assert dict_keys(os.path.join(SCRIPTS, "mission_serve_bench.py")) \
        <= set(row)
    assert row["n_requests"] == 4
    assert row["n_ok"] == msb.direct_ok(missions, 4)


def test_tick_bench_report_keys():
    """One run of each loop on the CPU: the JAX script's report keys, both
    goals reached, a K3 launch counted a refined tick."""
    out = tick.measure(1, device="cpu", log=lambda s: None)
    jax_keys = {k for k in dict_keys(os.path.join(SCRIPTS,
                                                  "bench_replan_tick.py"))
                if k.startswith(("kino_", "rrt_"))}
    assert jax_keys <= set(out)
    assert out["kino_runs_reached"] == 1 and out["rrt_runs_reached"] == 1
    assert out["kino_refined_ticks"] >= out["kino_n_warm_ticks"]
    assert out["device"] == "cpu"


@pytest.mark.parametrize("entry", [
    lambda: bench_torch.run(batch=2),
    lambda: sb.setup(),
    lambda: msb.setup(n_missions=2),
    lambda: bve.run_suite(1),
    lambda: tick.measure(1),
    lambda: common.build_bench_batch(2),
], ids=["bench_torch", "serve_bench", "mission_serve_bench",
        "beam_vs_exact", "bench_replan_tick", "build_bench_batch"])
def test_entry_points_need_a_card(entry):
    """Each entry point runs on the card by default: without one it
    raises, and nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
