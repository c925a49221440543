"""Share of the EDT's roofline: the least time to read every map's
occupancy once and write its field once, over the device time of every
kernel that ran inside the span around ``sdf.edt_batch``."""

from gtop_bench import roofline


def read(run):
    ms = (run.trace or {}).get("span_device_ms", {}).get("edt")
    if not ms or sum(ms) <= 0:
        return None
    bound = roofline.bound_ms(roofline.edt_bound_ms(run.driver.cells))
    return roofline.share(bound * len(ms), sum(ms))
