#!/usr/bin/env python3
"""Run the compare2-style benchmark suite end to end with the PyTorch
port (the counterpart of ``scripts/run_compare2_suite.py``; no JAX).

The reference's compare2 node (src/compare2.cpp:85-342) consumes maps
and start/goal pairs from an external benchmark package and logs
``solve_time, traj_time, acc_cost`` + jerk + cost curves to front2.txt /
back2.txt.  This script reproduces that flow self-contained, with
``scripts/run_compare2_suite.py``'s cases and calls: random pillar maps
built on the device, the wavefront front-end + RDP waypoints, the
penalty back-end (one K3 launch a case), JSONL records, a summary, and
the exact-format front2/back2 logs for drop-in comparison against C++
runs.

Run from the repository root:

    python scripts/run_compare2_suite_torch.py [n_cases] [out_dir] [device]

``device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "build/compare2_torch"
    device = sys.argv[3] if len(sys.argv) > 3 else "cuda"
    os.makedirs(out_dir, exist_ok=True)

    from grad_traj_optimization_torch import fixtures, harness
    from grad_traj_optimization_torch.config import COMPARE2_CONFIG

    rng = np.random.default_rng(11)
    cases = []
    while len(cases) < n_cases:
        c = fixtures.random_search_case(
            rng, n_pillars=(5, 10), gap_walls=None, device=device
        )
        if c is not None:
            cases.append(c)

    records = harness.run_suite(
        cases,
        out_path=os.path.join(out_dir, "cases.jsonl"),
        cfg=COMPARE2_CONFIG,
        n_waypoints=6,          # the JAX script's fixed waypoint count
        warm_compile=True,      # wall-calibrated cost-curve time axes
    )
    summary = harness.summarize(records)
    harness.write_compare2_logs(
        records,
        os.path.join(out_dir, "front2.txt"),
        os.path.join(out_dir, "back2.txt"),
    )
    print(json.dumps(summary, indent=2))
    print(f"wrote {out_dir}/cases.jsonl, front2.txt, back2.txt")


if __name__ == "__main__":
    main()
