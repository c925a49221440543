"""Median host milliseconds of the per-iteration descent in one batch:
the program's ``solver.per_iteration`` spans under one root span
(``utils.profiling``; the ``solver.solve_batch`` call), summed, over the
traced window's batches.  A span is the host's interval and does not wait
for the card at its end.  None where the program records no such span."""

import numpy as np


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    per_call = {}
    for s in spans("solver.per_iteration"):
        per_call[s.root] = per_call.get(s.root, 0) + s.end_ns - s.start_ns
    if not per_call:
        return None
    return float(np.median(list(per_call.values()))) * 1e-6
