"""PyTorch port, the compare2 evaluation harness: the wavefront grid
search held bitwise against the JAX package, the harness records and
compare2 logs against the JAX harness, the exact-A* retry, the RRT*
front end, and the batch entry points' device rule.

Inputs are made with numpy (the tests' gap-wall maps, tests/conftest.py)
and fed to both packages on the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import gap_wall_map  # noqa: E402
from grad_traj_optimization_tpu import harness as jh  # noqa: E402
from grad_traj_optimization_tpu import native as jnative  # noqa: E402
from grad_traj_optimization_tpu.config import (  # noqa: E402
    OptimizerConfig as JConfig,
)
from grad_traj_optimization_tpu.search import (  # noqa: E402
    grid_search as jgs,
)

from grad_traj_optimization_torch import fixtures as tfix  # noqa: E402
from grad_traj_optimization_torch import harness as th  # noqa: E402
from grad_traj_optimization_torch import pipeline as tpipe  # noqa: E402
from grad_traj_optimization_torch import solver as tsolver  # noqa: E402
from grad_traj_optimization_torch.config import (  # noqa: E402
    OptimizerConfig as TConfig,
)
from grad_traj_optimization_torch.search import (  # noqa: E402
    grid_search as tgs,
)
from grad_traj_optimization_torch.search import (  # noqa: E402
    kinodynamic as tkd,
)

START = np.array([0.0, -3.0, 2.0])
GOAL = np.array([0.0, 3.0, 2.0])


def _tcfg(cfg: JConfig) -> TConfig:
    return TConfig(**{f: getattr(cfg, f)
                      for f in TConfig.__dataclass_fields__})


def _serpentine(n=64):
    """tests/test_search.py:65-97: a 64 x 64 x 1 maze whose shortest path
    is ~2000 cells."""
    res = 0.25
    origin = np.zeros(3)
    dist = np.full((n, n, 1), 10.0, np.float32)
    for row, y in enumerate(range(2, n - 2, 2)):
        dist[:, y, 0] = 0.0
        if row % 2 == 0:
            dist[n - 2:, y, 0] = 10.0
        else:
            dist[:2, y, 0] = 10.0
    start = origin + (np.array([1, 1, 0]) + 0.5) * res
    goal = origin + (np.array([1, n - 2, 0]) + 0.5) * res
    return dist, origin, res, start, goal, dict(clearance=0.1, max_len=4096)


def _grid_case(name):
    if name == "serpentine":
        return _serpentine()
    dist, origin, res = gap_wall_map(-0.6, 0.6)
    kw = dict(clearance=10.0) if name == "unreachable" else {}
    return np.asarray(dist), origin, res, START, GOAL, kw


def _assert_plan_equal(t, j):
    for f in jgs.GridPlan._fields:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ----------------------------------------------------------- grid search


@pytest.mark.parametrize("name", ["gap wall", "unreachable", "serpentine"])
def test_grid_plan_bitwise_jax(name):
    """plan's path, length, reached, cost-to-go field and converged flag
    are bitwise the JAX package's: through the gap, from a start sealed
    off by the clearance (the walk leaves the grid, as the JAX scan
    does), and along the ~2000-cell serpentine."""
    dist, origin, res, start, goal, kw = _grid_case(name)
    t = tgs.plan(torch.as_tensor(dist), origin, res, start, goal, **kw)
    j = jgs.plan(jnp.asarray(dist), origin, res, start, goal, **kw)
    _assert_plan_equal(t, j)
    assert bool(t.converged)
    assert bool(t.reached) == (name != "unreachable")


def test_cost_to_go_unconverged_bitwise_jax():
    """A sweep budget below the fixpoint: the same partial field and
    converged False."""
    dist, *_ = _serpentine()
    blocked = dist < 0.1
    gi = np.array([1, 62, 0], np.int32)
    g, conv = tgs.cost_to_go(torch.as_tensor(blocked), gi, max_sweeps=40)
    jg, jconv = jgs.cost_to_go(jnp.asarray(blocked), jnp.asarray(gi),
                               max_sweeps=40)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert not bool(conv) and not bool(jconv)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_path_bitwise_jax(seed):
    """The pointer-doubled walk on a converged field from random starts,
    reached or not, against the JAX scan."""
    rng = np.random.default_rng(seed)
    blocked = rng.random((12, 10, 6)) < 0.3
    gi = np.array([6, 5, 3], np.int32)
    blocked[tuple(gi)] = False
    jg, _ = jgs.cost_to_go(jnp.asarray(blocked), jnp.asarray(gi))
    g = torch.as_tensor(np.asarray(jg))
    origin = np.array([-1.0, 2.0, 0.5], np.float32)
    for _ in range(6):
        si = rng.integers(0, (12, 10, 6)).astype(np.int32)
        tp, tl = tgs.extract_path(g, si, torch.as_tensor(origin), 0.2,
                                  max_len=100)
        jp, jl = jgs.extract_path(jg, jnp.asarray(si), jnp.asarray(origin),
                                  jnp.float32(0.2), max_len=100)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert int(tl) == int(jl)


def test_sweep_is_the_26_way_relaxation():
    """The separable sweep (faces, edges, corners) is bitwise the 26-way
    relaxation over ``_OFFSETS``."""
    rng = np.random.default_rng(3)
    g = torch.as_tensor((rng.random((9, 7, 5)) * 20).astype(np.float32))
    g[rng.random(g.shape) < 0.2] = tgs._BIG
    blocked = torch.as_tensor(rng.random(g.shape) < 0.2)
    costs = torch.as_tensor(tgs._STEP_COST)
    want = torch.where(blocked, tgs._BIG, torch.minimum(
        g, tgs._neighbour_scores(g, costs).amin(dim=0)))
    assert torch.equal(tgs._sweep(g, blocked), want)


# --------------------------------------------------------------- harness


def _suite_cases():
    """tests/test_replan_harness.py:217-245's three cases."""
    dist, origin, res = gap_wall_map(-0.8, 0.8)
    return [(dist, origin, res, np.array([dx, -3.0, 2.0]),
             np.array([dx, 3.0, 2.0])) for dx in (0.0, 0.25, -0.25)]


def _port_cases(cases):
    return [(torch.as_tensor(np.asarray(c[0])),) + tuple(c[1:])
            for c in cases]


def _assert_records_close(t, j, cost_rtol=5e-3):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert (a.case_id, a.status, a.frontend_ok, a.via_fallback) == (
            b.case_id, b.status, b.frontend_ok, b.via_fallback)
        np.testing.assert_allclose(a.jerk, b.jerk, rtol=1e-3)
        np.testing.assert_allclose(a.traj_time_s, b.traj_time_s, rtol=1e-5)
        np.testing.assert_allclose(a.cost_curve[-1], b.cost_curve[-1],
                                   rtol=cost_rtol)
        assert len(a.cost_curve) == len(b.cost_curve)
        assert all(y <= x for x, y in zip(a.cost_curve, a.cost_curve[1:]))


@pytest.mark.parametrize("runner", ["run_suite", "run_suite_batched"])
def test_suite_matches_jax(runner, tmp_path):
    """run_suite (per case) and run_suite_batched (one solve_batch) on the
    same cases as the JAX harness: flags equal, jerk, duration and final
    cost within tolerance, one JSON line a case."""
    cases = _suite_cases()
    cfg = JConfig(iters_step2=12)
    out = tmp_path / "cases.jsonl"
    t = getattr(th, runner)(_port_cases(cases), cfg=_tcfg(cfg),
                            n_waypoints=5, out_path=str(out))
    j = getattr(jh, runner)(cases, cfg=cfg, n_waypoints=5)
    _assert_records_close(t, j)
    lines = out.read_text().splitlines()
    assert [json.loads(x)["case_id"] for x in lines] == [0, 1, 2]
    s, js = th.summarize(t), jh.summarize(j)
    assert {k: s[k] for k in ("n_cases", "n_ok", "n_frontend_ok",
                              "n_via_fallback")} == {
        k: js[k] for k in ("n_cases", "n_ok", "n_frontend_ok",
                           "n_via_fallback")}


def test_suite_batched_equals_per_case():
    """The port's batched suite against its own per-case suite, under the
    JAX package's rule (tests/test_replan_harness.py:238-245)."""
    cases = _port_cases(_suite_cases())
    cfg = TConfig(iters_step2=12)
    rb = th.run_suite_batched(cases, cfg=cfg, n_waypoints=5)
    rs = th.run_suite(cases, cfg=cfg, n_waypoints=5)
    _assert_records_close(rb, rs, cost_rtol=1e-3)


def _parse_logs(front, back):
    fl, bl = front.read_text().splitlines(), back.read_text().splitlines()
    fr = []
    for line in fl:
        head, rest = line.split("solve_time:")
        st, tt, ac = rest.split(",")
        assert tt.startswith("traj_time:") and ac.startswith("acc_cost:")
        fr.append((head, float(st), float(tt[10:]), float(ac[9:])))
    br = []
    for line in bl:
        head, rest = line.split(",jerk:")
        jerk, rest = rest.split(",time:")
        times, costs = rest.split(",cost:")
        br.append((head, float(jerk), [float(x) for x in times.split(";")],
                   [float(x) for x in costs.split(";")]))
    return fr, br


def test_compare2_logs_match_jax(tmp_path):
    """front2/back2 lines in the JAX package's format, the numbers within
    the records' tolerances and the time axis uniform over the curve."""
    cases = _suite_cases()[:2]
    cfg = JConfig(iters_step2=10)
    logs = {}
    for tag, h, cs, c in (("t", th, _port_cases(cases), _tcfg(cfg)),
                          ("j", jh, cases, cfg)):
        recs = h.run_suite(cs, cfg=c)
        front = tmp_path / f"{tag}front2.txt"
        back = tmp_path / f"{tag}back2.txt"
        h.write_compare2_logs(recs, str(front), str(back))
        logs[tag] = (recs, *_parse_logs(front, back))
    (trec, tf, tb), (_, jf, jb) = logs["t"], logs["j"]
    for a, b, r in zip(tf, jf, trec):
        assert a[0] == b[0] == f"test2:{r.case_id + 1}"
        assert a[1] == r.frontend_time_s
        np.testing.assert_allclose(a[2], b[2], rtol=1e-5)
        np.testing.assert_allclose(a[3], b[3], rtol=1e-3)
    for a, b, r in zip(tb, jb, trec):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1], b[1], rtol=1e-3)
        assert len(a[2]) == len(b[2]) == len(a[3]) == len(b[3])
        np.testing.assert_allclose(a[2][-1], r.backend_time_s, rtol=1e-9)
        np.testing.assert_allclose(np.diff(a[2]), a[2][0], rtol=1e-6)
        np.testing.assert_allclose(a[3][-1], b[3][-1], rtol=5e-3)


@pytest.mark.parametrize("clearance", [1.2, 0.4],
                         ids=["exact A* retry", "grid search"])
def test_run_case_frontend_fallback_matches_jax(clearance):
    """tests/test_replan_harness.py:324-354: at clearance 1.2 the grid
    search seals the gap and the exact host A* (the native engine, built
    here) threads it; at 0.4 the grid search connects alone."""
    if not jnative.available():
        pytest.skip("the JAX package's native engine is unavailable")
    dist, origin, res = gap_wall_map(-0.8, 0.8)
    cfg = JConfig(iters_step1=4, iters_step2=12)
    t = th.run_case(0, torch.as_tensor(np.asarray(dist)), origin, res, START,
                    GOAL, cfg=_tcfg(cfg), clearance=clearance)
    j = jh.run_case(0, dist, origin, res, START, GOAL, cfg=cfg,
                    clearance=clearance)
    _assert_records_close([t], [j])
    assert t.frontend_ok and t.via_fallback == (clearance > 1.0)
    assert t.traj_length_m > 5.0


def test_run_case_rrt_matches_jax():
    """tests/test_misc.py:265: the RRT* corridor (same seed, same tree)
    bounds the refine; status ok, the JAX harness's segment times, and its
    final cost, or, where the two float32 descents part (here at the 7th
    step-1 iteration, by 2e-4), the port's own float64 run's: the
    referee rule of tests/test_torch_pipeline.py:80-94."""
    from grad_traj_optimization_torch.search import rrt as trrt

    dist, origin, res = gap_wall_map(0.8, 2.4, thickness_cells=2)
    cfg = JConfig(iters_step1=10, iters_step2=40)
    kw = dict(steps=(1, 2), rrt_iters=1500, seed=1)
    t = th.run_case_rrt(0, torch.as_tensor(np.asarray(dist)), origin, res,
                        START, GOAL, cfg=_tcfg(cfg), **kw)
    j = jh.run_case_rrt(0, jnp.asarray(dist), origin, res, START, GOAL,
                        cfg=cfg, **kw)
    assert t.status == j.status == 0 and t.frontend_ok
    assert t.traj_length_m > 6.0
    np.testing.assert_allclose(t.traj_time_s, j.traj_time_s, rtol=1e-5)
    final = t.cost_curve[-1]
    if abs(final - j.cost_curve[-1]) > 5e-3 * abs(j.cost_curve[-1]):
        o32 = np.asarray(origin, np.float32)
        tree = trrt.plan(np.asarray(dist), o32, res, START, GOAL,
                         max_iters=1500, seed=1)
        wp, bos = trrt.corridor_waypoints(tree, 0.4, min_bos=0.3)
        f64 = dict(dtype=torch.float64)
        ref = tsolver.solve(
            tsolver.Scenario(torch.as_tensor(np.asarray(dist), **f64),
                             torch.as_tensor(o32, **f64),
                             torch.tensor(res, **f64),
                             torch.as_tensor(wp, **f64)),
            cfg=_tcfg(cfg), steps=(1, 2), bos_wp=torch.as_tensor(bos, **f64))
        np.testing.assert_allclose(final, float(ref.cost), rtol=5e-3)


# ------------------------------------------------------------ device rule


def _entry_args(dist):
    """Arguments of the six batch entry points on a one-lane mission."""
    z = np.zeros((1, 3), np.float32)
    s6 = np.concatenate([START[None], z], 1).astype(np.float32)
    g6 = np.concatenate([GOAL[None], z], 1).astype(np.float32)
    org = np.array([[-5.0, -5.0, 0.0]], np.float32)
    knots = np.linspace(START, GOAL, 4)[None].astype(np.float32)
    zk = np.zeros_like(knots)
    times = np.full((1, 3), 1.5, np.float32)
    res = np.array([0.25], np.float32)
    kino = (dist, org, res, knots, zk, zk, times)
    d0 = dist[0]
    return {
        "solve_kino_batch": (tsolver.solve_kino_batch, kino),
        "solve_kino_batch_race": (tsolver.solve_kino_batch_race, kino),
        "plan_batch": (tpipe.plan_batch, (dist, org, 0.25, s6, g6)),
        "search_batch": (tkd.search_batch, (dist, org, 0.25, s6, g6)),
        "search_batch_adaptive": (tkd.search_batch_adaptive,
                                  (dist, org, 0.25, s6, g6)),
        "search": (tkd.search, (d0, org[0], 0.25, s6[0], g6[0])),
    }


ENTRY_POINTS = ["solve_kino_batch", "solve_kino_batch_race", "plan_batch",
                "search_batch", "search_batch_adaptive", "search"]
FAST = dict(beam=4, max_iters=2)


def _field():
    dist, _, _ = gap_wall_map(-0.8, 0.8)
    return np.asarray(dist)[None]


def _kw(name):
    if name.startswith("solve"):
        return dict(cfg=TConfig(iters_step2=2))
    if name == "plan_batch":
        return dict(cfg=TConfig(iters_step2=2), retries=0, **FAST)
    return dict(FAST)


def _result(name, out):
    """The entry point's tensors: its Solution or KinoResult."""
    if name == "plan_batch":
        return out.solution
    if name == "search_batch_adaptive":
        return out[0]
    return out


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_mixed_devices_raise(name):
    """A tensor argument on another device than the field raises
    ValueError; nothing is copied across."""
    fn, args = _entry_args(torch.as_tensor(_field()))[name]
    args = list(args)
    args[3] = torch.as_tensor(np.asarray(args[3]), device="meta")
    with pytest.raises(ValueError, match="meta"):
        fn(*args, **_kw(name))
    with pytest.raises(ValueError):
        fn(*_entry_args(torch.as_tensor(_field()))[name][1],
           device="meta", **_kw(name))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_numpy_field_goes_to_the_card(name):
    """A numpy field goes to device="cuda" (raising here, without a GPU),
    and runs on the CPU when asked, like a CPU tensor field."""
    fn, args = _entry_args(_field())[name]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args, **_kw(name))
    a = _result(name, fn(*args, device="cpu", **_kw(name)))
    b = _result(name, fn(*_entry_args(torch.as_tensor(_field()))[name][1],
                         **_kw(name)))
    for x, y in zip(a, b):
        assert x.device.type == "cpu"
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_random_search_case_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises((RuntimeError, AssertionError)):
        tfix.random_search_case(np.random.default_rng(0))
