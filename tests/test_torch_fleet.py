"""PyTorch port, the per-iteration descent on the fleet's routes: the
upstream demo's 11 waypoints shifted per lane and each segment cut into 5
(51 waypoints, ``num_dp`` 147, past what K3 takes) on one shared map,
against the benchmark's float64 plain reference
(``gtop_bench/reference/traj.py``), on the CPU; the span
``solver.per_iteration`` and the counters ``descent.evals`` /
``descent.lanes`` it keeps; and the benchmark's readers of them
(``gtop_bench/metrics``) on a synthetic run.

Parity is the repo's short-budget rule: equal ``n_accept``, cost rtol
5e-3 and sampled positions within 1e-3 m.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from grad_traj_optimization_torch import solver  # noqa: E402
from grad_traj_optimization_torch.config import OptimizerConfig  # noqa: E402
from grad_traj_optimization_torch.core import poly  # noqa: E402
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gtop_bench import roofline, spec, traffic  # noqa: E402
from gtop_bench.reference import edt as ref_edt  # noqa: E402
from gtop_bench.reference import traj  # noqa: E402

with open(os.path.join(ROOT, "gtop_bench", "configs", "opti_node51.json")) as f:
    CONF = json.load(f)
#: a window of the demo map around the route (both walls inside it)
MAP = dict(CONF["map"], origin=[-6.0, -7.0, 0.0], map_size=[12.0, 14.0, 3.0])
ITERS = 10
LANES = 4


def _routes(n, seed):
    """(n, 51, 3) float32: the demo's waypoints shifted within +-0.3 m in
    x and y per lane, then each segment cut into 5."""
    demo = np.asarray(CONF["waypoints"], np.float64)
    rng = np.random.default_rng(seed)
    cuts = CONF["route"]["cuts"]
    out = []
    for _ in range(n):
        wp = demo.copy()
        wp[:, :2] += rng.uniform(-0.3, 0.3, (len(demo), 2))
        f = np.arange(cuts)[:, None] / cuts
        inner = [wp[i] + f * (wp[i + 1] - wp[i]) for i in range(len(wp) - 1)]
        out.append(np.concatenate(inner + [wp[-1:]]))
    return torch.as_tensor(np.stack(out), dtype=torch.float32)


@pytest.fixture(scope="module")
def fleet():
    occ = traffic.walls(MAP, CONF["walls"], "cpu")
    wps = _routes(LANES, 21)
    scn = solver.Scenario(
        dist=sdf.edt(occ, MAP["resolution"])[None],
        origin=torch.tensor(MAP["origin"]).expand(LANES, 3),
        resolution=torch.tensor(MAP["resolution"]).expand(LANES),
        waypoints=wps)
    return occ, scn


def _cfg():
    return OptimizerConfig(**dict(CONF["optimizer"], iters_step2=ITERS))


def _traced(fn):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def test_fleet_routes_match_the_float64_reference(fleet):
    """A batch of 4 routes through ``solve_batch`` takes the per-iteration
    descent and agrees with the reference's descent from the same straight
    seed on the reference's field, lane by lane: equal accepted
    iterations (with a window of one, an accepted step is a new best, so
    the reference's count is its envelope's strict decreases), cost rtol
    5e-3, positions within 1e-3 m."""
    occ, scn = fleet
    cfg = _cfg()
    assert scn.waypoints.shape[1] == 51 and not solver.takes_k3(scn, cfg)
    sol = solver.solve_batch(scn, cfg=cfg)
    assert (sol.status == solver.STATUS_OK).all()

    ocfg = dict(CONF["optimizer"], iters_step2=ITERS)
    assert ocfg["accept_window"] == 1
    p = traj.PRECS["f64"]
    wps = scn.waypoints.double()
    T, Df, dp0 = traj.straight_seed(wps, ocfg)
    field = ref_edt.edt(occ.bool(), MAP["resolution"])
    pb = traj.problem(T, Df, dp0, field[None], torch.tensor(MAP["origin"]),
                      MAP["resolution"], ocfg, p)
    dp, cost, trace = traj.descend(pb, dp0, ITERS)
    c0, _ = traj.cost_and_grad(pb, torch.clamp(dp0, pb.lb, pb.ub),
                               with_grad=False)
    n_ref = (trace[:, 0] < c0).int() + (trace[:, 1:] < trace[:, :-1]).sum(1)
    assert sol.n_accept.tolist() == n_ref.tolist()
    torch.testing.assert_close(sol.cost.double(), cost, rtol=5e-3, atol=0)
    coeff = traj.coefficients(pb.Df, dp, pb.T, p)
    mine, _ = poly.sample_uniform(sol.coeff.double(), sol.T.double(), 200)
    ref, _ = poly.sample_uniform(coeff, pb.T, 200)
    assert float((mine - ref).abs().max()) < 1e-3


def test_per_iteration_span_counts_its_evaluations(fleet):
    """Under a recording profiler the batch keeps one
    ``solver.per_iteration`` span, a child of ``solver.solve_batch``; it
    counted ``iters + 1`` evaluations (``descent.evals``), each of the
    batch's lanes (``descent.lanes``), and as many lookups
    (``plain.trilinear_batch``), and no K3."""
    _, scn = fleet
    _, recs = _traced(lambda: solver.solve_batch(scn, cfg=_cfg()))
    (call,) = [s for s in recs if s.name == "solver.solve_batch"]
    (span,) = [s for s in recs if s.name == "solver.per_iteration"]
    assert span.parent == call.id and span.root == call.id
    assert span.counts["descent.evals"] == ITERS + 1
    assert span.counts["descent.lanes"] == LANES * (ITERS + 1)
    assert span.counts["plain.trilinear_batch"] == ITERS + 1
    assert "plain.descend" not in call.counts


def test_a_k3_batch_keeps_no_per_iteration_span(fleet):
    """The demo's own 11 waypoints go to K3 (its plain version here): no
    ``solver.per_iteration`` span is kept."""
    _, scn = fleet
    demo = torch.tensor(CONF["waypoints"], dtype=torch.float32)
    scn = scn._replace(waypoints=demo.expand(LANES, -1, 3).contiguous())
    assert solver.takes_k3(scn, _cfg())
    _, recs = _traced(lambda: solver.solve_batch(scn, cfg=_cfg()))
    (call,) = [s for s in recs if s.name == "solver.solve_batch"]
    assert call.counts["plain.descend"] == 1
    assert not [s for s in recs if s.name == "solver.per_iteration"]


def _span(name, i, root, ms, **counts):
    return profiling.Span(name, 10**12 * i, 10**12 * i + int(ms * 1e6), i,
                          None if i == root else root, root, counts)


#: three fleet batches: a root ``solver.solve_batch`` each, with its
#: per-iteration descent (the third a dual race, one span an arm)
SYNTHETIC = [
    _span("solver.per_iteration", 2, 1, 200.0, **{"sync.h2d.penalty.bos": 1}),
    _span("solver.solve_batch", 1, 1, 210.0),
    _span("solver.per_iteration", 4, 3, 180.0, **{
        "sync.h2d.penalty.bos": 1, "sync.h2d.qp.selection": 2}),
    _span("solver.solve_batch", 3, 3, 190.0),
    _span("solver.per_iteration", 6, 5, 150.0, **{"sync.h2d.penalty.bos": 1}),
    _span("solver.per_iteration", 7, 5, 160.0, **{"sync.h2d.penalty.bos": 1}),
    _span("solver.solve_batch", 5, 5, 320.0),
]
DEVICE_MS = {"solver.per_iteration": [100.0, 90.0, 60.0, 70.0],
             "solve": [190.0, 170.0, 300.0]}
DRIVER = types.SimpleNamespace(B=1024, m=50)
#: the compact form's least time of a batch of 1024 lanes of 50 segments
BOUND_MS = roofline.bound_ms(roofline.k3_bound_ms(1024, 50, 30, 101, False))
EXPECTED = {
    "fleet.descent_ms": 200.0,  # the median of 200, 180 and 150 + 160
    "fleet.descent_idle_share": 100.0 * (1 - 320.0 / 690.0),
    "fleet.host_syncs": 1.0,
    "descent_roofline.fleet": 100.0 * 3 * BOUND_MS / 660.0,
    "device_idle_share.fleet": 100.0 * (1 - 1.0 / 4.0),
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_fleet_readers_on_a_synthetic_run(monkeypatch, metric):
    """Each reader of the fleet cell reads a synthetic run; those of the
    program's spans read None where the program keeps no such span or has
    no tracer (the benchmark's parent commits), and the idle share of the
    descent None where the device list and the records differ in number
    or the run has no device timeline."""
    read = spec.reader(metric, ROOT)
    cell = spec.cell("opti_node51.fleet", ROOT)
    run = types.SimpleNamespace(
        cell=cell, driver=DRIVER,
        trace={"busy_s": 1.0, "window_s": 4.0, "span_device_ms": DEVICE_MS})
    monkeypatch.setattr(profiling.TRACER, "records", list(SYNTHETIC))
    assert read(run) == pytest.approx(EXPECTED[metric], rel=1e-12)
    if metric == "fleet.descent_idle_share":
        short = {k: v[:1] for k, v in DEVICE_MS.items()}
        assert read(types.SimpleNamespace(
            trace={"busy_s": 1.0, "span_device_ms": short})) is None
        assert read(types.SimpleNamespace(
            trace={"busy_s": 0.0, "span_device_ms": DEVICE_MS})) is None
    if metric.startswith("fleet."):
        monkeypatch.setattr(profiling.TRACER, "records", [])
        assert read(run) is None
        monkeypatch.delattr(profiling, "spans")
        assert read(run) is None
    else:  # the device trace's: nothing read without one
        assert read(types.SimpleNamespace(cell=cell, driver=DRIVER,
                                          trace=None)) is None
