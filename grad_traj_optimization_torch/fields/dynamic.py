"""Space-time distance oracle: static EDT + moving-obstacle boxes (port of
``grad_traj_optimization_tpu.fields.dynamic``).

Rebuild of the reference ``EDTEnvironment`` (edt_environment.{h,cpp}):
the distance at (pos, t) is the minimum of the static field and the
distance to every predicted axis-aligned box at time t.

* box distance = || clamp-to-face residual || (edt_environment.cpp:26-60);
* the trilinear variant evaluates min(static, boxes) at the 8 corner cell
  centers and interpolates that blended field (edt_environment.cpp:75-122);
* ``time < 0`` disables the dynamic part (evaluateCoarseEDT,
  edt_environment.cpp:124-136).

Predictions may be shared (``poly`` (n_obj, 6, 3)) or per lane
(``poly`` (B, n_obj, 6, 3), with ``pos`` and ``time`` led by B).
"""

from __future__ import annotations

import torch

from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.search.predictor import (
    ObjPrediction,
    predict_position,
)


def _norm3(r):
    """|r| over the last axis of 3, summed in a fixed order and square
    rooted in float64: the correctly rounded float32 result on every
    device (PyTorch's vectorized CPU float32 sqrt can be one ulp off)."""
    s = r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1] + r[..., 2] * r[..., 2]
    return torch.sqrt(s.double()).to(r.dtype)


def dist_to_boxes(pos, time, pred: ObjPrediction):
    """Distance from query points to each predicted box at ``time``.

    pos (..., 3); time broadcastable to pos[..., 0] -> (..., n_obj).
    """
    centers = predict_position(pred, time)  # (..., n_obj, 3)
    half = 0.5 * pred.scale
    if pred.poly.dim() == 4:  # per lane: align the lane axes
        half = half.reshape((half.shape[0],) + (1,) * (centers.dim() - 3)
                            + half.shape[1:])
    res = pos[..., None, :] - centers  # (..., n_obj, 3); in place below
    res.abs_().sub_(half).clamp_(min=0.0)
    return _norm3(res)


def min_dist_to_boxes(pos, time, pred: ObjPrediction):
    """min over boxes (edt_environment.cpp:62-73; 1e7 when no boxes)."""
    if pred.poly.shape[-3] == 0:
        return torch.full(pos.shape[:-1], 1e7, dtype=pos.dtype,
                          device=pos.device)
    return torch.amin(dist_to_boxes(pos, time, pred), dim=-1)


def evaluate_coarse(dist_grid, origin, resolution, pos, time,
                    pred: ObjPrediction | None = None):
    """Nearest-cell space-time distance (evaluateCoarseEDT); ``time < 0``
    or no prediction -> static only.  One (nx, ny, nz) grid."""
    d1 = sdf.distance_at(dist_grid, origin, resolution, pos)
    if pred is None:
        return d1
    t = torch.as_tensor(time, dtype=pos.dtype, device=pos.device)
    d2 = min_dist_to_boxes(pos, t, pred)
    return torch.where(t < 0.0, d1, torch.minimum(d1, d2))


def evaluate_with_grad(dist_grid, origin, resolution, pos, time,
                       pred: ObjPrediction | None = None):
    """Trilinear space-time distance + gradient (evaluateEDTWithGrad):
    the blended field min(static, boxes) at the 8 surrounding cell
    centers, trilinearly interpolated, as the reference does, so the
    gradient sees moving obstacles through the corner values."""
    origin = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    res = torch.as_tensor(resolution, dtype=pos.dtype, device=pos.device)
    nx, ny, nz = dist_grid.shape
    flat = dist_grid.reshape(-1)

    pos_m = pos - 0.5 * res
    idx = sdf.pos_to_index(pos_m, origin, res)
    idx_pos = (idx.to(pos.dtype) + 0.5) * res + origin
    diff = (pos - idx_pos) / res

    vals = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ci = idx + torch.tensor([dx, dy, dz], dtype=idx.dtype,
                                        device=idx.device)
                corner_pos = (ci.to(pos.dtype) + 0.5) * res + origin
                ix = ci[..., 0].clamp(0, nx - 1)
                iy = ci[..., 1].clamp(0, ny - 1)
                iz = ci[..., 2].clamp(0, nz - 1)
                d1 = flat[(ix * ny + iy) * nz + iz]
                if pred is not None:
                    t = torch.as_tensor(time, dtype=pos.dtype,
                                        device=pos.device)
                    d2 = min_dist_to_boxes(corner_pos, t, pred)
                    d1 = torch.where(t < 0.0, d1, torch.minimum(d1, d2))
                vals.append(d1)
    v = [[[vals[4 * x + 2 * y + z] for z in (0, 1)] for y in (0, 1)]
         for x in (0, 1)]
    dx_, dy_, dz_ = diff[..., 0], diff[..., 1], diff[..., 2]

    v00 = (1 - dx_) * v[0][0][0] + dx_ * v[1][0][0]
    v01 = (1 - dx_) * v[0][0][1] + dx_ * v[1][0][1]
    v10 = (1 - dx_) * v[0][1][0] + dx_ * v[1][1][0]
    v11 = (1 - dx_) * v[0][1][1] + dx_ * v[1][1][1]
    v0 = (1 - dy_) * v00 + dy_ * v10
    v1 = (1 - dy_) * v01 + dy_ * v11
    d = (1 - dz_) * v0 + dz_ * v1

    gz = (v1 - v0) / res
    gy = ((1 - dz_) * (v10 - v00) + dz_ * (v11 - v01)) / res
    gx = (
        (1 - dz_) * (1 - dy_) * (v[1][0][0] - v[0][0][0])
        + (1 - dz_) * dy_ * (v[1][1][0] - v[0][1][0])
        + dz_ * (1 - dy_) * (v[1][0][1] - v[0][0][1])
        + dz_ * dy_ * (v[1][1][1] - v[0][1][1])
    ) / res
    return d, torch.stack([gx, gy, gz], dim=-1)
