"""Median milliseconds of a tick's resample, refine (K3 at one lane) and
flight with their device work (``TickResult.t_refine``), over the
window's ticks that refined a path."""

import numpy as np


def read(run):
    t = [r.t_refine for r in getattr(run.driver, "ticks", []) if r.search_ok]
    return float(np.median(t)) * 1e3 if t else None
