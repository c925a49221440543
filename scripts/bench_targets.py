#!/usr/bin/env python3
"""The JAX package's beam-vs-exact numbers on the CPU that
``chip_smoke.py`` phase 18 holds ``scripts/beam_vs_exact_torch.py`` to.

Run from the repository root (on a host with JAX; it imports nothing of
the port):

    python scripts/bench_targets.py [n_cases ...] [--suites=kino:0,hybrid:0,hybrid:1]

For each ``n_cases`` (default 100) it runs the JAX script's
``run_suite`` (``scripts/beam_vs_exact.py``, seed 0) on the kino arm, the
hybrid arm and the hybrid arm with ``shot_mode=1``, each with
``retime="race:search,stretch:1.2"`` and ``retries=2`` as that script's
``main`` runs them, and prints one JSON line a suite: the arm, the
``shot_mode`` and the stats dict.  The exact oracles are the native host
engine, which the port's ``native`` module holds bitwise, so
``n_cases`` and ``exact_success`` carry over exactly.  ``--suites`` runs
a subset (``arm:shot_mode``): one process holding every suite's compiled
programs at 100 cases can run out of memory for LLVM.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from beam_vs_exact import run_suite  # noqa: E402

#: the suites of ``beam_vs_exact.main``: (exact arm, shot_mode)
SUITES = (("kino", 0), ("hybrid", 0), ("hybrid", 1))


def main(argv) -> None:
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    suites = SUITES
    if "suites" in opts:
        suites = [(a, int(m)) for a, m in (x.split(":") for x in
                                           opts["suites"].split(","))]
    ns = [int(a) for a in argv if not a.startswith("--")]
    for n in ns or [100]:
        for exact, shot_mode in suites:
            t0 = time.perf_counter()
            stats = run_suite(n, exact=exact, shot_mode=shot_mode,
                              retime="race:search,stretch:1.2", retries=2,
                              verbose=False)
            print(json.dumps({"exact": exact, "shot_mode": shot_mode,
                              "wall_s": round(time.perf_counter() - t0, 1),
                              "stats": stats}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
