"""Median milliseconds of a tick's beam search with its device work
(``TickResult.t_search``), over the window's ticks."""

import numpy as np


def read(run):
    t = [r.t_search for r in getattr(run.driver, "ticks", [])]
    return float(np.median(t)) * 1e3 if t else None
