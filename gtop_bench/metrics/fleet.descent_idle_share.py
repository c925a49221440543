"""Percent of the per-iteration descent's host time in which the card ran
nothing: 100 x (1 - the device ms inside the program's
``solver.per_iteration`` ranges (the trace's ``span_device_ms``) / the
spans' summed durations), over the traced window.  The program keeps a
span only where the profiler recorded all of it, so its records and the
trace's ranges are one set; where their numbers differ, where the run has
no device timeline (a CPU run), or where the program records no such
span, None."""


def read(run):
    try:
        from grad_traj_optimization_torch.utils.profiling import spans
    except ImportError:
        return None
    tr = run.trace
    if not tr or tr["busy_s"] <= 0:  # no device timeline (a CPU run)
        return None
    recs = spans("solver.per_iteration")
    dev = tr["span_device_ms"].get("solver.per_iteration")
    if not recs or not dev or len(dev) != len(recs):
        return None
    host_ms = sum(s.end_ns - s.start_ns for s in recs) * 1e-6
    return 100.0 * (1.0 - sum(dev) / host_ms)
