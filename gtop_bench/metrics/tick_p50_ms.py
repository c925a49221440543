"""Median milliseconds of the window's replan ticks, each from its start
to the next tick's start or the loop's return."""

import numpy as np


def read(run):
    t = getattr(run.driver, "tick_s", None)
    return float(np.median(t)) * 1e3 if t else None
