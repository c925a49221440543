"""Median host milliseconds of one ``pipeline.plan_batch`` call of a
batch, the span ending in a synchronise (traced run)."""

import numpy as np


def read(run):
    t = run.spans.get("plan")
    return float(np.median(t)) * 1e3 if t else None
