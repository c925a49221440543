"""A copy of the benchmark's data at a tiny size, for runs on the CPU with
the kernels' plain versions: the same cells, drivers, metrics and checks,
on small maps, small batches and short budgets."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

SMALL_MAP = {"origin": [-6.0, -6.0, 0.0], "resolution": 0.2,
             "map_size": [12.0, 12.0, 2.0]}
CONFIG = {
    "forest40": {"map": SMALL_MAP,
                 "pillars": {"count": 30, "footprint_m": [0.4, 1.6],
                             "height_m": [1.0, 2.0], "clear_m": 0.4},
                 "mission": {"n_waypoints": 4, "length_m": 8.0,
                             "inside_m": 1.0, "lateral_m": 0.5,
                             "z_m": [0.8, 1.2]}},
    "opti_node": {"map": {"origin": [-6.0, -7.0, 0.0], "resolution": 0.2,
                          "map_size": [12.0, 14.0, 3.0]},
                  "replan": {"replan_dt": 0.5, "horizon": 10.5, "margin": 0.3,
                             "max_vel": 3.0, "max_acc": 2.0, "goal_tol": 0.5,
                             "max_ticks": 40, "kino_iters": 16, "kino_beam": 64,
                             "n_waypoints": 6, "fallback_exact": False}},
}
TRAFFIC = {
    "plan": {"batch": 4, "beam": 16, "max_iters": 10, "check_fields": 2,
             "check_lanes": 8, "trace_seconds": 0.5},
    "solve": {"batch": 4, "check_fields": 2, "check_lanes": 4,
              "trace_seconds": 0.5},
    "replan": {"warm_missions": 1, "check_ticks": 16, "trace_seconds": 0.5},
}


def _merge(path, over):
    with open(path) as f:
        d = json.load(f)
    d.update(over)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def make_root(dst: str) -> str:
    """``dst`` holding BENCHMARK.json and gtop_bench's data at tiny size."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(ROOT, "gtop_bench", sub),
                        os.path.join(dst, "gtop_bench", sub))
    for name, over in CONFIG.items():
        _merge(os.path.join(dst, "gtop_bench", "configs", name + ".json"), over)
    for name, over in TRAFFIC.items():
        _merge(os.path.join(dst, "gtop_bench", "traffic", name + ".json"), over)
    return dst
