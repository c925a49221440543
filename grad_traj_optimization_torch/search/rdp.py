"""Ramer-Douglas-Peucker polyline simplification (port of
``grad_traj_optimization_tpu.search.rdp``).

Rebuild of the reference ``RDPCurveSimplifier``
(douglas_peucker.hpp:36-157): split each segment at the point with the
largest perpendicular distance to its chord until every point is within
epsilon of its chord.

* :func:`simplify` — host-side NumPy (a copy of the JAX package's);
* :func:`simplify_masked` — the fixed-depth masked form, plain tensor
  ops on the device of its inputs: a keep-mask over the input points.
"""

from __future__ import annotations

import numpy as np
import torch


def _perp_dist(front, back, pts):
    """Perpendicular distance of pts to the line through front->back
    (douglas_peucker.hpp:148-157: cross-product with normalized chord)."""
    d = back - front
    n = np.linalg.norm(d)
    if n < 1e-12:
        return np.linalg.norm(pts - front, axis=-1)
    d = d / n
    v = pts - front
    return np.linalg.norm(np.cross(v, d), axis=-1)


def simplify(curve, epsilon: float, return_index: bool = False):
    """Simplify an (N, 3) polyline; returns (M, 3) with endpoints kept.

    With ``return_index`` also returns the kept indices (M,) into the
    input — used to carry per-point side data (e.g. RRT* safe-ball
    radii) through the simplification.
    """
    curve = np.asarray(curve, dtype=np.float64)
    n = len(curve)
    if n <= 2:
        if return_index:
            return curve.copy(), np.arange(n)
        return curve.copy()
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j - i < 2:
            continue
        seg = curve[i + 1 : j]
        dist = _perp_dist(curve[i], curve[j], seg)
        k = int(np.argmax(dist))
        if dist[k] > epsilon:
            split = i + 1 + k
            keep[split] = True
            stack.append((i, split))
            stack.append((split, j))
    if return_index:
        return curve[keep], np.nonzero(keep)[0]
    return curve[keep]


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def simplify_masked(curve, valid, epsilon: float, max_depth: int = 10):
    """Fixed-depth RDP on tensors: returns a keep mask (bool, same length).

    ``valid`` masks real points of a padded path (padding must repeat the
    last valid point).  Every active chord splits at once per depth level,
    so ``max_depth`` levels bound the recursion (2^max_depth segments).
    """
    curve = torch.as_tensor(curve)
    dev = curve.device
    n = curve.shape[0]
    valid = torch.as_tensor(valid, device=dev)
    last = torch.clamp(valid.to(torch.int64).sum() - 1, min=1)
    idxs = torch.arange(n, device=dev)
    keep = (idxs == 0) | (idxs == last)
    for _ in range(max_depth):
        # chord start per point: the last kept index at or before it; chord
        # end: the next kept index at or after it
        start = torch.cummax(torch.where(keep, idxs, -1), dim=0).values
        rev = torch.where(keep, idxs, 2 * n).flip(0)
        end = torch.cummin(rev, dim=0).values.flip(0)
        fr = curve[start.clamp(0, n - 1)]
        bk = curve[end.clamp(0, n - 1)]
        d = bk - fr
        dhat = d / torch.clamp(_norm(d), min=1e-12)[:, None]
        dist = _norm(torch.linalg.cross(curve - fr, dhat, dim=-1))
        interior = (idxs > start) & (idxs < end) & valid & (idxs <= last)
        dist = torch.where(interior, dist, -1.0)
        # per-chord maximum (chords are contiguous; the start is the id)
        seg_max = torch.full((n,), -torch.inf, dtype=dist.dtype, device=dev)
        seg_max = seg_max.scatter_reduce(0, start, dist, reduce="amax")
        is_max = (dist >= seg_max[start.clamp(0, n - 1)] - 1e-12) & (
            dist > epsilon)
        first_max = is_max & (
            torch.cummax(torch.where(is_max, idxs, -1), dim=0).values == idxs)
        keep = keep | first_max
    return keep & (valid | (idxs == 0))
