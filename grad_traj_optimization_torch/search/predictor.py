"""Moving-obstacle tracking and prediction (port of
``grad_traj_optimization_tpu.search.predictor``).

Rebuild of the reference ``ObjPredictor`` / ``ObjHistory`` /
``PolynomialPrediction`` (obj_predictor.{h,cpp}) without ROS: histories
are plain arrays and the timer-driven refit is an explicit batched call.
Both fit modes are kept:

* :func:`fit_const_vel` — the active mode (obj_predictor.cpp:174-218), a
  line through the last two history points per object;
* :func:`fit_poly` — the implemented-but-disabled degree-5 least-squares
  fit with acceleration regulator lambda (obj_predictor.cpp:85-145).

A prediction's leaves are shared by every lane, ``poly`` (n_obj, 6, 3),
or per lane, ``poly`` (B, n_obj, 6, 3): ascending-power polynomials in
absolute time, evaluated by :func:`predict_position`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ObjHistory:
    """Pose-history ring buffer with sample thinning (host side, as the
    reference ``ObjHistory``, obj_predictor.cpp:12-34): every
    ``skip_num``-th observed pose is recorded and the buffer keeps the
    most recent ``queue_size`` records."""

    def __init__(self, queue_size: int = 20, skip_num: int = 1,
                 obj_idx: int = 0):
        self.queue_size = queue_size
        self.skip_num = skip_num
        self.obj_idx = obj_idx
        self._skip = 0
        self._hist: list[tuple[float, float, float, float]] = []

    def observe(self, pos, t: float) -> bool:
        """Offer one observation; returns True when it was recorded."""
        self._skip += 1
        if self._skip < self.skip_num:
            return False
        p = [float(x) for x in pos]
        self._hist.append((p[0], p[1], p[2], float(t)))
        if len(self._hist) > self.queue_size:
            self._hist.pop(0)
        self._skip = 0
        return True

    def __len__(self) -> int:
        return len(self._hist)

    def arrays(self):
        """(H, 3) positions and (H,) times as float32 numpy, oldest first."""
        h = np.asarray(self._hist, dtype=np.float32).reshape(-1, 4)
        return h[:, :3], h[:, 3]


def stack_histories(histories, scales, device="cuda"):
    """(n_obj, H, 3) positions, (n_obj, H) times and (n_obj, 3) scales as
    float32 tensors on ``device``, the card unless the caller asks for the
    CPU (H = the shortest history, tails kept),
    ready for :func:`fit_const_vel` / :func:`fit_poly`."""
    H = min(len(h) for h in histories)
    if H < 2:
        raise ValueError("need >= 2 recorded poses per object")
    ps, ts = [], []
    for h in histories:
        p, t = h.arrays()
        ps.append(p[-H:])
        ts.append(t[-H:])
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(np.stack(ps), **f32),
            torch.as_tensor(np.stack(ts), **f32),
            torch.as_tensor(np.asarray(scales, np.float32), **f32))


class ObjPrediction(NamedTuple):
    poly: torch.Tensor   # ([B,] n_obj, 6, 3) ascending-power coefficients
    t1: torch.Tensor     # ([B,] n_obj) history start time
    t2: torch.Tensor     # ([B,] n_obj) history end time
    scale: torch.Tensor  # ([B,] n_obj, 3) box dimensions


def fit_const_vel(history_pos, history_t, scale) -> ObjPrediction:
    """Constant-velocity fit through the last two history samples.

    history_pos ([B,] n_obj, H, 3), history_t ([B,] n_obj, H) with
    H >= 2, most recent last (the reference reads the list tail,
    obj_predictor.cpp:185-196); scale ([B,] n_obj, 3).
    """
    q1 = history_pos[..., -2, :]
    q2 = history_pos[..., -1, :]
    t1 = history_t[..., -2]
    t2 = history_t[..., -1]
    dt = t2 - t1
    # [p0; p1] = [[1, t1], [1, t2]]^-1 [q1; q2]
    vel = (q2 - q1) / torch.clamp(dt, min=1e-9)[..., None]
    p0 = q1 - vel * t1[..., None]
    poly = torch.zeros(history_pos.shape[:-2] + (6, 3),
                       dtype=history_pos.dtype, device=history_pos.device)
    poly[..., 0, :] = p0
    poly[..., 1, :] = vel
    return ObjPrediction(poly=poly, t1=history_t[..., 0], t2=t2,
                         scale=torch.as_tensor(scale,
                                               device=history_pos.device))


def _powers(t, n: int = 6):
    """t^0 .. t^(n-1) on a new last axis, as repeated products."""
    out = [torch.ones_like(t), t]
    for _ in range(n - 2):
        out.append(out[-1] * t)
    return torch.stack(out[:n], dim=-1)


def fit_poly(history_pos, history_t, scale, lam: float = 1.0,
             valid=None) -> ObjPrediction:
    """Regularized degree-5 polynomial fit (obj_predictor.cpp:85-137):
    data rows ``A += 2 t^j [1, t, ..., t^5]``, ``b += 2 q t^j``, plus four
    acceleration-regulator rows weighted by lambda on coefficient rows
    2..5; one batched 6x6 solve per object and axis.

    history_pos (n_obj, H, 3), history_t (n_obj, H); ``valid`` an
    optional (n_obj, H) mask for ragged histories.
    """
    pos = history_pos
    t = history_t
    n_obj = t.shape[0]
    w = torch.ones_like(t) if valid is None else valid.to(t.dtype)
    tp = _powers(t)  # (n_obj, H, 6)
    A = 2.0 * torch.einsum("nhj,nhk,nh->njk", tp, tp, w)
    b = 2.0 * torch.einsum("nhx,nhj,nh->njx", pos, tp, w)
    t1 = t[:, 0]
    t2 = t[:, -1]

    def reg_row(tt, coefs, powers):
        out = torch.zeros((n_obj, 6), dtype=t.dtype, device=t.device)
        for j, (c, p) in enumerate(zip(coefs, powers)):
            out[:, j + 2] = c * tt ** p
        return out

    def reg(tt):
        return (reg_row(tt, (2.0, 3.0, 4.0, 5.0), (1, 2, 3, 4)),
                reg_row(tt, (1.0, 2.0, 3.0, 4.0), (2, 3, 4, 5)),
                reg_row(tt, (20.0, 45.0, 72.0, 100.0), (3, 4, 5, 6)),
                reg_row(tt, (35.0, 84.0, 140.0, 200.0), (4, 5, 6, 7)))

    ra, rb = reg(t1), reg(t2)
    A[:, 2, :] += -4.0 * lam * (ra[0] - rb[0])
    A[:, 3, :] += -12.0 * lam * (ra[1] - rb[1])
    A[:, 4, :] += -(4.0 / 5.0) * lam * (ra[2] - rb[2])
    A[:, 5, :] += -(4.0 / 7.0) * lam * (ra[3] - rb[3])
    coef = torch.linalg.solve(A, b)  # (n_obj, 6, 3)
    return ObjPrediction(poly=coef, t1=t1, t2=t2,
                         scale=torch.as_tensor(scale, device=t.device))


def predict_position(pred: ObjPrediction, time):
    """Box centers at absolute ``time`` (the reference evaluates the
    polynomial with no clamp, obj_predictor.h:46-66).

    Shared leaves: time (...) -> (..., n_obj, 3).  Per-lane leaves
    (poly (B, n_obj, 6, 3)): time (B, ...) (or a scalar) -> (B, ...,
    n_obj, 3), lane b read with lane b's polynomials.

    The six terms are summed in a fixed order with no fused
    multiply-add, so a CPU and a CUDA run give the same bits.
    """
    poly = pred.poly
    t = torch.as_tensor(time, dtype=poly.dtype, device=poly.device)
    if poly.dim() == 3:
        tp = _powers(t)[..., None, :, None]   # (..., 1, 6, 1)
        coef = poly                           # (n_obj, 6, 3)
    else:
        B = poly.shape[0]
        if t.dim() == 0:
            t = t.expand(B)
        tp = _powers(t)[..., None, :, None]   # (B, ..., 1, 6, 1)
        coef = poly.reshape((B,) + (1,) * (t.dim() - 1) + poly.shape[1:])
    out = tp[..., 0, :] * coef[..., 0, :]
    for j in range(1, 6):
        out = out + tp[..., j, :] * coef[..., j, :]
    return out
