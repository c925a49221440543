"""The fleet cell (``opti_node51.fleet``) at its tiny size on the CPU: every
batch takes the per-iteration descent, K3 never called and one lookup an
evaluation; the routes are the demo's waypoints shifted per lane, each
segment then cut into equal ones.  (``test_gtop_bench_cells.py`` runs the
cell, its control and its faults.)

    python -m pytest gtop_bench/tests/test_gtop_bench_fleet.py -q
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, HERE]

import tiny  # noqa: E402

from gtop_bench import spec, trace  # noqa: E402
from gtop_bench import run as bench_run  # noqa: E402

CELL = "opti_node51.fleet"
SEED = 2**31 + 777


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


def test_every_batch_takes_the_per_iteration_descent(root, monkeypatch):
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.ops import solve_cuda
    seen = {"takes_k3": [], "k3": 0}
    takes_k3, descend = solver.takes_k3, solve_cuda.descend

    def watch_takes_k3(*a, **kw):
        seen["takes_k3"].append(takes_k3(*a, **kw))
        return seen["takes_k3"][-1]

    def watch_descend(*a, **kw):
        seen["k3"] += 1
        return descend(*a, **kw)

    monkeypatch.setattr(solver, "takes_k3", watch_takes_k3)
    monkeypatch.setattr(solve_cuda, "descend", watch_descend)
    cell = spec.cell(CELL, root)
    drv = spec.driver(cell.traffic["driver"]).Driver(
        cell, SEED, torch.device("cpu"), trace.Spans(False, torch.device("cpu")),
        0.2)
    drv.setup()
    drv.window(0.2)
    evals = cell.config["optimizer"]["iters_step2"] + 1
    assert seen["takes_k3"] and not any(seen["takes_k3"])
    assert seen["k3"] == 0
    assert drv.diagnostics()["per_batch"] == {
        "launch.descend": 0, "plain.descend": 0, "launch.trilinear_batch": 0,
        "plain.trilinear_batch": evals, "descent.evals": evals}
    out = bench_run.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"], out["checks"]


def test_routes_run_straight_between_shifted_demo_waypoints(root):
    cell = spec.cell(CELL, root)
    drv = spec.driver("fleet").Driver(cell, SEED, torch.device("cpu"),
                                      trace.Spans(False, torch.device("cpu")), 0)
    drv.demo = torch.tensor(cell.config["waypoints"], dtype=torch.float32)
    from gtop_bench import traffic
    wps = drv._routes(traffic.generator(SEED, "cpu"))
    cuts, j = cell.config["route"]["cuts"], cell.config["route"]["jitter_m"]
    n = len(cell.config["waypoints"])
    assert wps.shape == (drv.B, (n - 1) * cuts + 1, 3) == (drv.B, drv.m + 1, 3)
    knots = wps[:, ::cuts]
    shift = knots - drv.demo
    assert float(shift[..., :2].abs().max()) <= j and not shift[..., 2].any()
    assert float(shift[..., :2].abs().max()) > j / 2  # lanes differ
    # each cut lies on its segment, the segments' pieces equal
    piece = torch.diff(wps, dim=1).reshape(drv.B, n - 1, cuts, 3)
    torch.testing.assert_close(piece, piece[:, :, :1].expand_as(piece),
                               rtol=0, atol=1e-5)
