"""Median count of the stream synchronisations in one per-iteration
descent: the ``sync.*`` counts each ``solver.per_iteration`` span
(``utils.profiling``) kept (blocking device-to-host reads, host-to-device
copies and mask gathers, by site), over the traced window's spans.  None
where the program records no such span."""

import numpy as np


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    n = [sum(v for k, v in s.counts.items() if k.startswith("sync."))
         for s in spans("solver.per_iteration")]
    return float(np.median(n)) if n else None
