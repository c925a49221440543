"""Closed-form QP dependencies and seeding (port of
``grad_traj_optimization_tpu.core.qp``).

Terminology of the reference ``TrajectoryGenerator``
(qp_generator.{h,cpp}):

* ``D`` — stacked endpoint derivatives, 6 per segment, slot order
  (p0, p1, v0, v1, a0, a1) (qp_generator.cpp:44-54);
* ``d = (df, dp)`` — the optimizer's fixed/free derivative vector with
  ``D = Ct @ d``; Ct rows are one-hot (qp_generator.cpp:357-390);
  num_f = 6 (start and end p, v, a), num_p = 3m-3 (interior derivatives).

Selection maps are static numpy index arrays per segment count ``m``;
everything that depends on segment times is a small batched product.
Functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from grad_traj_optimization_torch.core import poly


@functools.lru_cache(maxsize=None)
def opt_dmap(m: int) -> np.ndarray:
    """(6m,) index map: slot ``6s + 2i + e`` (segment s, order i, end e)
    -> d slot, d laid out as ``[p0, v0, a0, pm, vm, am, (p, v, a) of
    interior waypoint 1..m-1]`` (closed form of qp_generator.cpp:357-390).
    """
    idx = np.zeros(6 * m, dtype=np.int64)
    for s in range(m):
        for i in range(3):
            for e in range(2):
                w = s + e
                if w == 0:
                    d = i
                elif w == m:
                    d = 3 + i
                else:
                    d = 6 + 3 * (w - 1) + i
                idx[6 * s + 2 * i + e] = d
    return idx


@functools.lru_cache(maxsize=None)
def opt_selection(m: int) -> np.ndarray:
    """Dense one-hot Ct (6m, 3m+3) with D = Ct @ d, float64."""
    idx = opt_dmap(m)
    ct = np.zeros((6 * m, 3 * m + 3), dtype=np.float64)
    ct[np.arange(6 * m), idx] = 1.0
    return ct


@functools.lru_cache(maxsize=None)
def minsnap_dmap(m: int) -> np.ndarray:
    """Index map for the full min-snap partition (PolyQPGeneration type 1).

    d layout (4m+2 slots): fixed block of 2m+4 = [p0, v0, a0, p0_end,
    (p_start_s, p_end_s) for s = 1..m-1, v_end, a_end], free block of
    2m-2 = [(v_w, a_w) for interior waypoints w = 1..m-1].

    Closed form of the Ct built at qp_generator.cpp:242-270.  Interior
    *positions* are duplicated fixed slots (continuity by value); interior
    vel/acc are merged free slots (continuity by sharing).
    """
    idx = np.zeros(6 * m, dtype=np.int64)
    for s in range(m):
        # positions
        idx[6 * s + 0] = 0 if s == 0 else 2 + 2 * s
        idx[6 * s + 1] = 3 + 2 * s
        # velocities and accelerations
        for i, base in ((1, 0), (2, 1)):
            for e in range(2):
                w = s + e
                if w == 0:
                    d = 1 + base  # start vel / acc
                elif w == m:
                    d = 2 * m + 2 + base  # end vel / acc
                else:
                    d = 2 * m + 4 + 2 * (w - 1) + base
                idx[6 * s + 2 * i + e] = d
    return idx


@functools.lru_cache(maxsize=None)
def segment_columns(m: int) -> np.ndarray:
    """(m, 6) int32: the d columns of segment s's two knots (p, v, a),
    ascending.  They are the non-zero columns of Ct's rows 6s..6s+5, so
    the only columns of L = A^-1 Ct's rows 6s..6s+5, and of every sample
    chain built from them, that can be non-zero."""
    ct = opt_selection(m).reshape(m, 6, 3 * m + 3)
    return np.stack([np.flatnonzero(ct[s].any(axis=0)) for s in range(m)]
                    ).astype(np.int32)


@dataclasses.dataclass
class QPDep:
    """What the penalty optimizer needs per scenario (num_dp = 3m-3),
    with any leading batch dimensions:

      L:   (6m, 3m+3)      coeff = L @ d  (reference _L = A^-1 Ct)
      Ldp: (m, 6, num_dp)  per-segment slice L[6s:6s+6, 6:]
      R:   (3m+3, 3m+3)    smoothness quadratic form over d
      Rfp: (6, num_dp)
      Rpp: (num_dp, num_dp)
    """

    L: torch.Tensor
    Ldp: torch.Tensor
    R: torch.Tensor
    Rfp: torch.Tensor
    Rpp: torch.Tensor


def build_dep(T: torch.Tensor) -> QPDep:
    """L and R blocks from segment times (StackOptiDep,
    qp_generator.cpp:357-405), as per-segment 6x6 kernels scattered
    through the static selection map."""
    m = T.shape[-1]
    ndim = 3 * m + 3
    ct_seg = torch.as_tensor(
        opt_selection(m), dtype=T.dtype, device=T.device
    ).reshape(m, 6, ndim)
    ainv = poly.segment_ainv(T)  # (..., m, 6, 6)
    msnap = poly.segment_snap_form(T)
    lead = T.shape[:-1]
    L = torch.einsum("...sjb,sba->...sja", ainv, ct_seg).reshape(
        *lead, 6 * m, ndim
    )
    R = torch.einsum("spa,...spq,sqb->...ab", ct_seg, msnap, ct_seg)
    Ldp = L.reshape(*lead, m, 6, ndim)[..., 6:]
    return QPDep(L=L, Ldp=Ldp, R=R, Rfp=R[..., :6, 6:], Rpp=R[..., 6:, 6:])


def straight_line_d(waypoints: torch.Tensor, start_vel=None,
                    start_acc=None):
    """Initial (Df, Dp) of the reference's straight-line seed
    (qp_generator.cpp:317-345 + getInitialD :407-451): interior guesses
    are (waypoint, 0 vel, 0 acc); Df = [p_start, v_start, a_start, p_end,
    0, 0] with the start velocity/acceleration zero unless given.

    ``waypoints`` (..., m+1, 3) -> Df (..., 3, 6), Dp (..., 3, 3m-3),
    axis-major (rows x, y, z; within a block slot 0/1/2 = p/v/a).
    """
    wp = waypoints
    m = wp.shape[-2] - 1
    z3 = torch.zeros_like(wp[..., 0, :])
    sv = z3 if start_vel is None else torch.as_tensor(
        start_vel, dtype=wp.dtype, device=wp.device).expand_as(z3)
    sa = z3 if start_acc is None else torch.as_tensor(
        start_acc, dtype=wp.dtype, device=wp.device).expand_as(z3)
    Df = torch.stack([wp[..., 0, :], sv, sa, wp[..., m, :], z3, z3], dim=-1)
    interior = wp[..., 1:m, :]  # (..., m-1, 3)
    zi = torch.zeros_like(interior)
    dp = torch.stack([interior, zi, zi], dim=-1)  # (..., m-1, axis, slot)
    Dp = dp.transpose(-3, -2).reshape(*wp.shape[:-2], 3, 3 * (m - 1))
    return Df, Dp


def kino_d(pos, vel, acc):
    """Initial (Df, Dp) from kinodynamic knot states (the reference's
    setKinoPath seeding: PolyKinoGeneration + getInitialD,
    qp_generator.cpp:23-154, 407-451).

    pos/vel/acc (..., m+1, 3) -> Df (..., 3, 6) = [p0, v0, a0, pm, vm, am],
    Dp (..., 3, 3m-3) axis-major.
    """
    m = pos.shape[-2] - 1
    Df = torch.stack([pos[..., 0, :], vel[..., 0, :], acc[..., 0, :],
                      pos[..., m, :], vel[..., m, :], acc[..., m, :]], dim=-1)
    interior = torch.stack([pos[..., 1:m, :], vel[..., 1:m, :],
                            acc[..., 1:m, :]], dim=-1)  # (..., m-1, 3, 3)
    Dp = interior.transpose(-3, -2).reshape(*pos.shape[:-2], 3, 3 * (m - 1))
    return Df, Dp


def kino_coeff(pos, vel, acc, T):
    """Pure Hermite coefficients (..., m, 3, 6) from kino states
    (PolyKinoGeneration, qp_generator.cpp:23-154: P = A^-1 D, no energy
    minimization)."""
    Df, Dp = kino_d(pos, vel, acc)
    return coeff_from_d(Df, Dp, T)


def min_snap_dp(Df, Rpp, Rfp):
    """Closed-form smoothness optimum ``dp* = -Rpp^-1 Rfp^T df`` per axis
    (the "min_snap" seed, qp_generator.cpp:242-315), Jacobi-equilibrated
    so the f32 solve survives Rpp condition numbers ~1e4.

    Df (..., 3, 6), Rpp (..., P, P), Rfp (..., 6, P) -> dp (..., 3, P).
    """
    diag = torch.sqrt(torch.clamp(torch.diagonal(Rpp, dim1=-2, dim2=-1),
                                  min=1e-30))
    si = 1.0 / diag
    rs = Rpp * si[..., :, None] * si[..., None, :]
    rhs = -torch.einsum("...xf,...fp->...xp", Df, Rfp) * si[..., None, :]
    z = torch.linalg.solve(rs, rhs.transpose(-1, -2)).transpose(-1, -2)
    return z * si[..., None, :]


def min_snap_coeff(waypoints, start_vel, start_acc, end_vel, end_acc, T):
    """Minimum-snap trajectory through waypoints, free interior vel/acc.

    Rebuild of PolyQPGeneration type 1 (qp_generator.cpp:242-315): fix all
    waypoint positions + start/end vel/acc, solve the free interior
    vel/acc from the unconstrained QP optimality condition
    ``dp = -Rpp^-1 Rfp^T df`` (:func:`min_snap_dp`, Jacobi-equilibrated).

    Args:
      waypoints: (m+1, 3); T: (m,); the boundary vel/acc (3,).  Any
      float dtype and device (those of ``waypoints``).
    Returns:
      coeff (m, 3, 6) ascending powers.
    """
    wp = torch.as_tensor(waypoints)
    like = dict(dtype=wp.dtype, device=wp.device)
    T = torch.as_tensor(T, **like)
    m = T.shape[0]
    num_f = 2 * m + 4
    idx = minsnap_dmap(m)
    ct = np.zeros((6 * m, 4 * m + 2), dtype=np.float64)
    ct[np.arange(6 * m), idx] = 1.0
    ct_seg = torch.as_tensor(ct, **like).reshape(m, 6, 4 * m + 2)
    R = torch.einsum("spa,spq,sqb->ab", ct_seg, poly.segment_snap_form(T),
                     ct_seg)
    # fixed derivative values df per axis: [p0, v0, a0, p_end_of_seg0,
    # (p_start_s, p_end_s) s=1..m-1, v_end, a_end]
    cols = [wp[0], torch.as_tensor(start_vel, **like),
            torch.as_tensor(start_acc, **like), wp[1]]
    for s in range(1, m):
        cols += [wp[s], wp[s + 1]]
    cols += [torch.as_tensor(end_vel, **like),
             torch.as_tensor(end_acc, **like)]
    df = torch.stack(cols, dim=1)  # (3, 2m+4)
    dp = min_snap_dp(df, R[num_f:, num_f:], R[:num_f, num_f:])
    D = torch.cat([df, dp], dim=1)[:, torch.as_tensor(idx, device=wp.device)]
    return torch.einsum("sjb,xsb->sxj", poly.segment_ainv(T),
                        D.reshape(3, m, 6))


def stacked_derivatives(Df, Dp, m: int):
    """(..., 3, 6m) per-segment derivative stack, D = d[opt_dmap]."""
    d = torch.cat([Df, Dp], dim=-1)
    idx = torch.as_tensor(opt_dmap(m), device=d.device)
    return d[..., idx]


def coeff_from_d(Df, Dp, T):
    """Coefficients (..., m, 3, 6) from the optimizer derivative vector
    (getCoefficientFromDerivative, grad_traj_optimizer.cpp:253-279)."""
    m = T.shape[-1]
    D = stacked_derivatives(Df, Dp, m)
    Dseg = D.reshape(*D.shape[:-1], m, 6)  # (..., 3, m, 6)
    return torch.einsum("...sjb,...xsb->...sxj", poly.segment_ainv(T), Dseg)


def allocate_times(waypoints, mean_v: float, init_time: float):
    """Segment time = length / mean_v, plus init_time on segment 0 only.

    Keeps the reference's quirk (grad_traj_optimizer.cpp:73-81): its tail
    special case ``i == segment_time.size()`` is never true, so only the
    first segment receives init_time.
    """
    wp = waypoints
    t = torch.linalg.norm(wp[..., 1:, :] - wp[..., :-1, :], dim=-1) / mean_v
    t0 = t[..., :1] + init_time
    return torch.cat([t0, t[..., 1:]], dim=-1)
