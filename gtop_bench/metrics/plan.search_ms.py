"""Median milliseconds of the beam search with its retry ladder in one
``pipeline.plan_batch`` call: the program's ``pipeline.search`` spans of
a call (``utils.profiling``), summed, over the traced window's calls.
A span is the host's interval and does not wait for the card at its end.
None where the program records no such span."""

import numpy as np


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    per_call = {}
    for s in spans("pipeline.search"):
        per_call[s.root] = per_call.get(s.root, 0) + s.end_ns - s.start_ns
    if not per_call:
        return None
    return float(np.median(list(per_call.values()))) * 1e-6
