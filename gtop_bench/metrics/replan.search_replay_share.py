"""Percent of the traced window's one-lane beam searches that replayed a
captured CUDA graph: 100 x the ``search.graph_replays`` counts
(``utils.profiling``) the ``replan.search`` spans kept, summed, over the
number of those spans.  None where the program records no such span, or
where no span counted a graph (``search.graph_replays`` or
``search.graph_captures``): a program whose search has no graph."""

KEYS = ("search.graph_replays", "search.graph_captures")


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    s = spans("replan.search")
    if not any(k in x.counts for x in s for k in KEYS):
        return None
    return 100.0 * sum(x.counts.get(KEYS[0], 0) for x in s) / len(s)
