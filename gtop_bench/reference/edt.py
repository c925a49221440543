"""Plain reference of the map side: the exact Euclidean distance transform
of an occupancy grid (upstream SDFMap::updateESDF3d, sdf_map.cpp:310-368),
written from its definition.

The squared distance of a cell is the least squared cell offset to an
occupied cell, taken axis by axis as a brute-force min-plus over every
source of a line (no envelope, no scan); the field is ``res * sqrt`` of
it, capped at 10000 m.  ``prec`` as in :mod:`traj`: ``"f64"`` is the
reference, ``"tf32"`` the control (float32, every pass rounded to TF32).
It imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from gtop_bench.reference.traj import PRECS

FREE_DIST = 10000.0


def _minplus(f, dim, prec, chunk=1 << 25):
    """out[q] = min_v f[v] + (q - v)^2 along ``dim``, every pair."""
    g = f.movedim(dim, -1)
    lead, n = g.shape[:-1], g.shape[-1]
    g = g.reshape(-1, n)
    q = torch.arange(n, dtype=g.dtype, device=g.device)
    off = (q[:, None] - q[None, :]) ** 2  # (q, v)
    out = torch.empty_like(g)
    rows = max(1, chunk // (n * n))
    for i in range(0, g.shape[0], rows):
        out[i:i + rows] = torch.amin(g[i:i + rows, None, :] + off, dim=-1)
    return prec.store(out.reshape(*lead, n).movedim(-1, dim))


def edt(occ, res, prec="f64"):
    """Distance field (nx, ny, nz) of one bool occupancy grid, in ``prec``'s
    dtype."""
    p = PRECS[prec]
    inf = torch.tensor(float("inf"), dtype=p.dtype, device=occ.device)
    f = torch.where(occ, torch.zeros((), dtype=p.dtype, device=occ.device), inf)
    for dim in (2, 1, 0):
        f = _minplus(f, dim, p)
    return p.store(torch.clamp(torch.sqrt(f) * res, max=FREE_DIST))
