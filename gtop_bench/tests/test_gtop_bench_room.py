"""A cell on the per-iteration descent joins the benchmark as new files and
new entries alone: a configuration whose corridors have 46 waypoints
(``num_dp`` 132, past what K3 takes), a solve traffic file, a limits file,
the two tiny files and ``BENCHMARK.json`` entries, with no file that is
there edited.  Its batches take the per-iteration descent; the program
reads correct, the control and each descent fault planted there do not.

    python -m pytest gtop_bench/tests/test_gtop_bench_room.py -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, HERE]

import tiny  # noqa: E402

from gtop_bench import faults, spec  # noqa: E402
from gtop_bench import run as bench_run  # noqa: E402

CELL = "forest46.solve46"
WAYPOINTS = 46
SEED = 2**31 + 4321


def _json(path):
    with open(path) as f:
        return json.load(f)


def _new(path, d):
    assert not os.path.exists(path), path  # new files only
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark's files as a later PR finds them, the new cell's files
    and entries added, made tiny."""
    src = str(tmp_path_factory.mktemp("src"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), src)
    shutil.copytree(os.path.join(ROOT, "gtop_bench"), os.path.join(src, "gtop_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    g = os.path.join(src, "gtop_bench")
    conf = _json(os.path.join(g, "configs", "forest40.json"))
    conf["name"] = "forest46"
    conf["mission"]["n_waypoints"] = WAYPOINTS
    _new(os.path.join(g, "configs", "forest46.json"), conf)
    _new(os.path.join(g, "traffic", "solve46.json"),
         _json(os.path.join(g, "traffic", "solve.json")))
    # the solve cell's limits; the cost gap's set between what the program
    # (2e-5) and ``altered`` (0.04) read on this cell's dense corridors
    limits = _json(os.path.join(g, "limits", "forest40.solve.json"))
    _new(os.path.join(g, "limits", CELL + ".json"), dict(limits, cost_gap=0.01))
    b = _json(os.path.join(src, "BENCHMARK.json"))
    b["configs"].append({"name": "forest46", "source": "test",
                         "file": "gtop_bench/configs/forest46.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": CELL, "config": "forest46",
                           "traffic": "solve46", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append(CELL)
    with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    # without its tiny files the cell would run at full size: refused
    with pytest.raises(FileNotFoundError) as e:
        tiny.overrides(src)
    for name in ("configs/forest46.json", "traffic/solve46.json"):
        assert name in str(e.value), e.value
    small = _json(os.path.join(g, "tests", "tiny", "configs", "forest40.json"))
    small["mission"]["n_waypoints"] = WAYPOINTS
    # a short descent: a per-iteration evaluation on the CPU is slow
    small["optimizer"] = dict(conf["optimizer"], iters_step2=6)
    _new(os.path.join(g, "tests", "tiny", "configs", "forest46.json"), small)
    _new(os.path.join(g, "tests", "tiny", "traffic", "solve46.json"),
         _json(os.path.join(g, "tests", "tiny", "traffic", "solve.json")))
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")), src)


@pytest.fixture
def paths(monkeypatch):
    """Which descent each solve took: ``takes_k3``'s answers and the calls
    of K3's entry."""
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
    return seen


def _run(root, control=False):
    torch.manual_seed(0)
    return bench_run.run_cell(spec.cell(CELL, root), SEED, 0.2, False, "cpu",
                              control=control)


@pytest.mark.parametrize("what", ["program", "control"] +
                         list(spec.driver("solve").FAULTS))
def test_per_iteration_cell(root, paths, what):
    if what in faults.FAULTS:
        with faults.planted(what):
            out = _run(root)
    else:
        out = _run(root, control=what == "control")
    assert paths["takes_k3"] and not any(paths["takes_k3"]), paths
    assert paths["k3"] == 0
    assert out["correct"] == (what == "program"), (what, out["checks"])
