"""CPU tests of the benchmark harness: every cell end to end at a tiny size
with the kernels' plain versions, the control and the planted faults
coming out not correct, the roofline arithmetic against the chip smoke
script's, cells and metrics found by name, and no run without a card.

    python -m pytest gtop_bench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, HERE]

import tiny  # noqa: E402

from gtop_bench import faults, roofline, spec  # noqa: E402
from gtop_bench import run as bench_run  # noqa: E402

tiny.overrides()  # a cell with no tiny size fails here, at collection
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
#: each fault with the cells whose driver lists it: their timed path
#: holds what it breaks
FAULT_CELLS = [(c, f) for f in sorted(faults.FAULTS) for c in CELLS
               if f in spec.driver(spec.cell(c).traffic["driver"]).FAULTS]
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


def _run(root, name, traced=False, control=False):
    torch.manual_seed(0)
    return bench_run.run_cell(spec.cell(name, root), SEED, 1.0,
                              traced, "cpu", control=control)


def _keys_ok(out, traced):
    assert list(out)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert out["attempted"] > out["failed"] >= 0
    for c in out["checks"].values():
        assert c["value"] is not None


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_tiny(root, name):
    out = _run(root, name)
    _keys_ok(out, False)
    cell = spec.cell(name, root)
    want = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced_tiny(root, name):
    out = _run(root, name, traced=True)
    _keys_ok(out, True)
    assert "busy_s" in out["device"] and "breakdown" in out
    # the CPU has no device timeline: trace-read metrics say nothing
    for k, m in out["metrics"].items():
        assert "roofline" not in k and "idle" not in k
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(root, name):
    out = _run(root, name, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", FAULT_CELLS)
def test_fault_is_not_correct(root, name, fault):
    with faults.planted(fault):
        out = _run(root, name)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("name", ["forest40.plan", "forest40.solve"])
def test_altered_field_is_not_correct(root, name, monkeypatch):
    from grad_traj_optimization_torch.fields import sdf
    real = sdf.edt_batch
    monkeypatch.setattr(sdf, "edt_batch", lambda o, r: real(o, r) * 1.01)
    out = _run(root, name)
    assert not out["correct"], out["checks"]


def test_search_margin_gap_reads_the_guarantee(root):
    """Sound runs keep every checked sample clear of the margin; a search
    blind to the obstacles does not."""
    out = _run(root, "forest40.plan")
    gap = out["readings"]["search_margin_gap_m"]
    assert gap < 0, gap
    with faults.planted("blind"):
        out = _run(root, "forest40.plan")
    gap = out["readings"]["search_margin_gap_m"]
    assert gap > 0 and not out["correct"], out["checks"]


def test_blind_reaches_every_search_entry():
    """``blind`` sits under ``search_batch``, the eager ``search`` and the
    capture of a search graph alike (``_search_impl``), and no search
    graph captured on one side of the fault is replayed on the other."""
    from grad_traj_optimization_torch.search import kinodynamic as kino
    real = kino._search_impl
    kino._GRAPHS["sound"] = None
    with faults.planted("blind"):
        assert kino._search_impl is not real and not kino._GRAPHS
        kino._GRAPHS["blind"] = None
    assert kino._search_impl is real and not kino._GRAPHS


def test_reference_branch_samples():
    """A primitive's samples are its constant-acceleration motion, the
    last segment is the cubic through both end states, and a
    zero-duration segment is not checked."""
    from gtop_bench.reference import search as ref_search
    p0 = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    v0 = torch.tensor([1.0, -0.5, 0.0], dtype=torch.float64)
    u = torch.tensor([2.0, 0.0, -1.0], dtype=torch.float64)
    tau = 0.5
    p1, v1 = p0 + v0 * tau + 0.5 * u * tau**2, v0 + u * tau
    p2, v2 = torch.tensor([3.0, 0.0, 2.5], dtype=torch.float64), torch.zeros(3)
    pos = torch.stack([p0, p0, p1, p2])
    vel = torch.stack([v0, v0, v1, v2.double()])
    times = torch.tensor([0.0, tau, 1.25], dtype=torch.float64)
    pts = ref_search.samples(pos, vel, times, 5)
    assert pts.shape == (5 + ref_search.SHOT_CHECKS, 3)
    t = tau * torch.arange(1, 6, dtype=torch.float64)[:, None] / 5
    torch.testing.assert_close(pts[:5], p0 + v0 * t + 0.5 * u * t * t)
    # the shot in the cubic Hermite basis, from p1, v1 to p2 at rest
    T = 1.25
    sk = torch.arange(1, ref_search.SHOT_CHECKS + 1, dtype=torch.float64)[:, None]
    sk = sk / ref_search.SHOT_CHECKS
    herm = ((2 * sk**3 - 3 * sk**2 + 1) * p1 + (sk**3 - 2 * sk**2 + sk) * T * v1
            + (-2 * sk**3 + 3 * sk**2) * p2)
    torch.testing.assert_close(pts[5:], herm)


def test_bounds_equal_chip_smoke():
    import chip_smoke
    assert roofline.HBM_BPS == chip_smoke.HBM_BPS
    assert roofline.FP32_FLOPS == chip_smoke.FP32_FLOPS
    for args in [(1024, 6, 30, 101, False), (1024, 6, 30, 101, True),
                 (1024, 6, 30, 26, False), (256, 10, 30, 101, False),
                 (1, 10, 30, 101, False)]:
        assert roofline.k3_bound_ms(*args) == chip_smoke.k3_bound_ms(*args)
    n = 1024 * 100 * 100 * 25  # the bench's K1 pass: read once, written once
    k1_bytes = 2 * 4 * n
    assert roofline.edt_bound_ms(n)["bytes_ms"] == \
        k1_bytes / chip_smoke.HBM_BPS * 1e3


def test_new_files_are_found_by_name(tmp_path):
    r = tiny.make_root(str(tmp_path))
    g = os.path.join(r, "gtop_bench")
    with open(os.path.join(g, "configs", "forest40.json")) as f:
        conf = json.load(f)
    conf["name"] = "forest_small"
    with open(os.path.join(g, "configs", "forest_small.json"), "w") as f:
        json.dump(conf, f)
    shutil.copy(os.path.join(g, "traffic", "solve.json"),
                os.path.join(g, "traffic", "solve_small.json"))
    shutil.copy(os.path.join(g, "limits", "forest40.solve.json"),
                os.path.join(g, "limits", "forest_small.solve_small.json"))
    with open(os.path.join(g, "metrics", "draw.host_ms.py"), "w") as f:
        f.write("import numpy as np\n\n\ndef read(run):\n"
                "    t = run.spans.get('draw')\n"
                "    return float(np.median(t)) * 1e3 if t else None\n")
    path = os.path.join(r, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "forest_small", "source": "test",
                         "file": "gtop_bench/configs/forest_small.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "forest_small.solve_small",
                           "config": "forest_small", "traffic": "solve_small",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "draw.host_ms", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "traffic", "moves": "solves_per_s",
                           "workloads": ["forest_small.solve_small"]})
    for m in b["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("forest_small.solve_small")
    with open(path, "w") as f:
        json.dump(b, f)
    cell = spec.cell("forest_small.solve_small", r)
    assert cell.config["name"] == "forest_small"
    out = bench_run.run_cell(cell, 7, 0.5, True, "cpu")
    assert out["metrics"]["draw.host_ms"]["value"] > 0
    assert out["correct"], out["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "gtop_bench", "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
