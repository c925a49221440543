"""The readings that a cell's limits are set from, on the card; the
benchmark's own runs run none of this.

    python3 gtop_bench/control.py program --workload <cell> --seeds 1,2,3 [--seconds 5]
    python3 gtop_bench/control.py control --workload <cell> --seeds 1,2,3
    python3 gtop_bench/control.py fault --workload <cell> --fault blind --seeds 1,2,3

For each seed the cell's driver runs a window and the kept outputs are
compared as a run compares them, in one process for all the seeds.
``program``: the program as a run drives it (the lower readings).
``control``: the kept inputs are answered by the plain reference in the
control precision (float32 with TF32 rounding), put in the program's
place (a plan cell's search stays the program's); it has to come out not
correct.  ``fault``: the program with one of ``faults.FAULTS`` planted
under its timed path, one that the cell's driver lists (its ``FAULTS``).
One JSON line a seed, with each number and the cell's limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gtop_bench import run as bench_run  # noqa: E402
from gtop_bench import faults, spec  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("program", "control", "fault"))
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")],
                    default=[1, 2, 3])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    cell = spec.cell(a.workload)
    if a.what == "fault":
        holds = spec.driver(cell.traffic["driver"]).FAULTS
        if a.fault not in holds:
            ap.error(f"{a.workload}'s timed path holds the faults {holds}, "
                     f"not {a.fault!r}")
    for s in a.seeds:
        t0 = time.perf_counter()
        if a.what == "fault":
            with faults.planted(a.fault):
                out = bench_run.run_cell(cell, s, a.seconds, False, a.device)
        else:
            out = bench_run.run_cell(cell, s, a.seconds, False, a.device,
                                     control=a.what == "control")
        print(json.dumps({"seed": s, "what": a.what, "fault": a.fault,
                          "correct": out["correct"], "checks": out["checks"],
                          "readings": out["readings"],
                          "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
