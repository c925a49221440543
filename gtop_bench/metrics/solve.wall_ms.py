"""Median host milliseconds of one ``solver.solve_batch`` call of a batch
(``kernel_inputs``, the dispatch and K3's launch), the span ending in a
synchronise (traced run)."""

import numpy as np


def read(run):
    t = run.spans.get("solve")
    return float(np.median(t)) * 1e3 if t else None
