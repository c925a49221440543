"""Share of the solve's roofline: the whole descent's least time for the
batch's shapes and iterations (``roofline.k3_bound_ms``), over the device
time of every kernel inside the span around ``solver.solve_batch``
(``kernel_inputs`` and K3 with K2's lookup inside)."""

from gtop_bench import roofline


def read(run):
    ms = (run.trace or {}).get("span_device_ms", {}).get("solve")
    if not ms or sum(ms) <= 0:
        return None
    d = run.driver
    cfg = run.cell.config["optimizer"]
    m = run.cell.config["mission"]["n_waypoints"] - 1
    b = roofline.k3_bound_ms(d.B, m, cfg["n_samples"], cfg["iters_step2"] + 1,
                             cfg["alpha_a"] != 0.0)
    return roofline.share(roofline.bound_ms(b) * len(ms), sum(ms))
