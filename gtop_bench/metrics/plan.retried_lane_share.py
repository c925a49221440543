"""Percent of the search's lanes that its retry ladder searched again:
100 x ``search.lanes_retried`` / ``search.lanes`` (padding not counted),
summed over the traced window's ``pipeline.plan_batch`` spans
(``utils.profiling``).  None where the program records no such span."""


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    recs = spans("pipeline.plan_batch")
    lanes = sum(s.counts.get("search.lanes", 0) for s in recs)
    if not lanes:
        return None
    return 100.0 * sum(s.counts.get("search.lanes_retried", 0)
                       for s in recs) / lanes
