"""Share of the descent's roofline: the whole descent's least time in the
compact form K3 is held to (``roofline.k3_bound_ms``: the batch's lanes,
segments and samples, ``iters_step2`` + 1 evaluations), over the device
time of every kernel inside the span around ``solver.solve_batch``.  The
work is the same whatever does it: the per-iteration descent, a graph of
it, or K3 widened past 128 free derivatives."""

from gtop_bench import roofline


def read(run):
    ms = (run.trace or {}).get("span_device_ms", {}).get("solve")
    if not ms or sum(ms) <= 0:
        return None
    d = run.driver
    cfg = run.cell.config["optimizer"]
    b = roofline.k3_bound_ms(d.B, d.m, cfg["n_samples"], cfg["iters_step2"] + 1,
                             cfg["alpha_a"] != 0.0)
    return roofline.share(roofline.bound_ms(b) * len(ms), sum(ms))
