"""Percent of the window's replan ticks whose beam search failed so that
the host A* ran: the ticks whose ``TickResult.t_fallback`` (the program's
``replan.fallback`` span) is above 0.  None where the program has no
tracer (``utils.profiling.TRACER``), whose ``t_fallback`` is a stopwatch
read on every tick."""


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import TRACER  # noqa: F401
    except ImportError:
        return None
    ticks = getattr(run.driver, "ticks", None)
    if not ticks:
        return None
    return 100.0 * sum(t.t_fallback > 0 for t in ticks) / len(ticks)
