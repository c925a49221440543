"""Plain reference of the kinodynamic search's stated guarantee: every
sample at which a branch was checked lies in the map, and the distance
of its cell exceeds the search's ``margin`` (upstream
kinodynamic_astar.cpp:157-213 for the primitives, 415-446 for the
one-shot to the goal).

A branch is its knot states (positions, velocities) and its segment
durations.  Each segment of positive duration is the cubic that matches
its two end states (a primitive's constant acceleration is such a
cubic), checked at k / n of its duration, k = 1..n: ``check_num``
samples on a primitive, ``SHOT_CHECKS`` on the last segment, the
one-shot.  Zero-duration segments (the padding in front of a short
branch) move nothing and are not checked.  Where the search plans
against moving boxes, each primitive's samples are checked against the
boxes where they stand at the sample's time (the one-shot against the
map alone, as the search sweeps it; kinodynamic_astar.cpp:199-213).  It
imports nothing of the program under test.
"""

from __future__ import annotations

import torch

#: samples on the one-shot to the goal: the port sweeps it at 32 (the
#: upstream's 10 hold only for its short shots near the goal)
SHOT_CHECKS = 32


def samples(pos, vel, times, check_num: int, with_times: bool = False):
    """(N, 3) float64 check points of one branch: pos, vel (K+1, 3),
    times (K,).  ``with_times`` adds each point's time from the branch's
    start (N,) and whether it lies on the one-shot (N,)."""
    pos, vel, times = (torch.as_tensor(x).double() for x in (pos, vel, times))
    K = times.shape[0]
    out, when, shot = [], [], []
    t0 = torch.zeros((), dtype=times.dtype, device=times.device)
    for i in torch.nonzero(times > 0).flatten().tolist():
        n = SHOT_CHECKS if i == K - 1 else check_num
        T = times[i]
        t = T * torch.arange(1, n + 1, dtype=T.dtype, device=T.device) / n
        d = pos[i + 1] - pos[i] - vel[i] * T
        dv = vel[i + 1] - vel[i]
        a = (dv - 2 * d / T) / (T * T)
        b = 3 * d / (T * T) - dv / T
        tt = t[:, None]
        out.append(pos[i] + vel[i] * tt + b * tt * tt + a * tt * tt * tt)
        when.append(t0 + t)
        shot.append(torch.full((n,), i == K - 1, device=t.device))
        t0 = t0 + T
    pts = torch.cat(out) if out else pos[:0]
    if not with_times:
        return pts
    return pts, torch.cat(when) if when else times[:0], \
        torch.cat(shot) if shot else times[:0].bool()


def box_distance(pts, ts, hist, hist_t, scale):
    """Least distance (N,) from points at times ts (N,) to boxes moving at
    constant velocity through their last two poses (hist (n, H, 3),
    hist_t (n, H)), each of full extents ``scale`` (n, 3): the norm of
    the point's offset beyond the box's faces (edt_environment.cpp:26-73,
    obj_predictor.cpp:185-196)."""
    q1, q2 = hist[:, -2], hist[:, -1]
    t1, t2 = hist_t[:, -2], hist_t[:, -1]
    v = (q2 - q1) / (t2 - t1)[:, None]
    c = q2[None] + v[None] * (ts[:, None, None] - t2[None, :, None])
    out = torch.clamp((pts[:, None] - c).abs() - scale[None] / 2, min=0.0)
    return torch.linalg.norm(out, dim=-1).amin(dim=1)


def clearance(field, origin, res: float, pts, tol: float = 1e-3):
    """The distance a point reads in ``field`` (nx, ny, nz), the cell
    taken as the search takes it (floor of the offset over ``res``), and
    -1 outside the map.  A point within ``tol`` of a cell's side reads
    the larger of the cells there, so a sample that the program's float32
    arithmetic put on the other side of a boundary is never held against
    it."""
    f = field.double()
    o = torch.as_tensor(origin, dtype=f.dtype, device=f.device)
    n = torch.tensor(f.shape, device=f.device)
    pts = pts.to(f.device)
    inside = torch.all((pts > o - tol) & (pts < o + n * res + tol), dim=-1)
    lo = torch.floor((pts - tol - o) / res).long()
    hi = torch.floor((pts + tol - o) / res).long()
    lo = torch.minimum(lo.clamp(min=0), n - 1)
    hi = torch.minimum(hi.clamp(min=0), n - 1)
    best = torch.full(pts.shape[:-1], -torch.inf, dtype=f.dtype, device=f.device)
    for cx in (lo[:, 0], hi[:, 0]):
        for cy in (lo[:, 1], hi[:, 1]):
            for cz in (lo[:, 2], hi[:, 2]):
                best = torch.maximum(best, f[cx, cy, cz])
    return torch.where(inside, best, torch.full_like(best, -1.0))
