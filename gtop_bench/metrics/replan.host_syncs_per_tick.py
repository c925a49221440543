"""Median count of the stream synchronisations in one replan tick: the
``sync.*`` counts each ``replan.tick`` span (``utils.profiling``) kept
(blocking device-to-host reads, host-to-device copies and mask gathers,
by site), over the traced window's ticks that searched (a loop's last
pass, which finds the goal reached and flies no tick, left out).  None
where the program records no such span."""

import numpy as np


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    searched = {s.parent for s in spans("replan.search")}
    n = [sum(v for k, v in s.counts.items() if k.startswith("sync."))
         for s in spans("replan.tick") if s.id in searched]
    return float(np.median(n)) if n else None
