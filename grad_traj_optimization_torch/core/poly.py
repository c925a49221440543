"""Quintic piecewise-polynomial core (port of
``grad_traj_optimization_tpu.core.poly``).

The 6x6 Hermite blocks are never inverted at run time: every block
inverse is the unit-time matrix ``A1INV`` (inverted once in float64 at
import) scaled by powers of the segment duration,
``Ainv(T)[j, r] = A1INV[j, r] * T^(ord(r) - j)``, and the per-segment
snap form is ``KSNAP[r, c] * T^(ord(r) + ord(c) - 5)`` (reference
qp_generator.cpp:40-54, 99-110, 134).

Derivative-slot order per segment: (p0, p1, v0, v1, a0, a1); coefficients
are ascending powers c0..c5 (grad_traj_optimizer.cpp:451-468).  Every
function takes any float dtype and device, and broadcasts over leading
batch dimensions of ``T``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: derivative order of each of the 6 per-segment derivative slots
DERIV_ORD = np.array([0, 0, 1, 1, 2, 2], dtype=np.int64)


def _unit_hermite() -> np.ndarray:
    """Unit-time quintic Hermite mapping matrix A1 (6x6 float64)."""
    a = np.zeros((6, 6), dtype=np.float64)
    fact = [1, 1, 2, 6, 24, 120]
    for i in range(3):
        a[2 * i, i] = fact[i]
        for j in range(i, 6):
            a[2 * i + 1, j] = fact[j] / fact[j - i]
    return a


def _unit_snap_hessian() -> np.ndarray:
    """Unit-time snap Hessian Q1 (qp_generator.cpp:99-110 with T=1)."""
    q = np.zeros((6, 6), dtype=np.float64)
    for i in range(3, 6):
        for j in range(3, 6):
            q[i, j] = (
                i * (i - 1) * (i - 2) * j * (j - 1) * (j - 2) / (i + j - 5)
            )
    return q


A1 = _unit_hermite()
A1INV = np.linalg.inv(A1)
Q1 = _unit_snap_hessian()
#: KSNAP = A1^-T Q1 A1^-1, the unit-time snap form over derivatives
KSNAP = A1INV.T @ Q1 @ A1INV

#: derivative-shift matrix V: (V c)_i = (i+1) c_{i+1}
#: (reference grad_traj_optimizer.cpp:59-60: V(i, i+1) = i+1)
VSHIFT = np.diag(np.arange(1.0, 6.0), k=1)


_CONSTS = {"DERIV_ORD": DERIV_ORD, "A1INV": A1INV, "KSNAP": KSNAP}


@functools.lru_cache(maxsize=None)
def _const_on(name: str, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_CONSTS[name], dtype=dtype, device=device)


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    """The module constant ``name`` as a tensor of ``like``'s dtype and
    device, made once per dtype and device: a descent evaluates these
    every iteration, and a host copy each time would cost a transfer
    (and could not be captured in a CUDA graph).  Callers do not write
    into the result."""
    return _const_on(name, like.dtype, like.device)


def segment_ainv(T: torch.Tensor) -> torch.Tensor:
    """(..., m) durations -> (..., m, 6, 6) maps ``Ainv @ D6 -> c6``."""
    ordv = _const("DERIV_ORD", T)
    j = torch.arange(6, dtype=T.dtype, device=T.device)
    expo = ordv[None, :] - j[:, None]  # [j, r] = ord(r) - j
    return _const("A1INV", T) * T[..., None, None] ** expo


def segment_snap_form(T: torch.Tensor) -> torch.Tensor:
    """Per-segment snap quadratic form M(T), (..., m, 6, 6)."""
    ordv = _const("DERIV_ORD", T)
    expo = ordv[:, None] + ordv[None, :] - 5.0
    return _const("KSNAP", T) * T[..., None, None] ** expo


def time_powers(t: torch.Tensor) -> torch.Tensor:
    """[1, t, ..., t^5] (getTimeMatrix, grad_traj_optimizer.cpp:544-551)."""
    j = torch.arange(6, dtype=t.dtype, device=t.device)
    return t[..., None] ** j


def vel_powers(t: torch.Tensor) -> torch.Tensor:
    """d/dt of time_powers: [0, 1, 2t, 3t^2, 4t^3, 5t^4]."""
    j = torch.arange(6, dtype=t.dtype, device=t.device)
    tp = torch.cat(
        [torch.zeros_like(t[..., None]), t[..., None] ** j[:5]], dim=-1
    )
    return j * tp


def acc_powers(t: torch.Tensor) -> torch.Tensor:
    """[0, 0, 2, 6t, 12t^2, 20t^3]."""
    j = torch.arange(6, dtype=t.dtype, device=t.device)
    return j * (j - 1) * t[..., None] ** torch.clamp(j - 2, min=0)


def jerk_powers(t: torch.Tensor) -> torch.Tensor:
    """[0, 0, 0, 6, 24t, 60t^2]."""
    j = torch.arange(6, dtype=t.dtype, device=t.device)
    return j * (j - 1) * (j - 2) * t[..., None] ** torch.clamp(j - 3, min=0)


def evaluate(coeff, T, t, deriv: int = 0):
    """Evaluate the piecewise trajectory at global times ``t``.

    ``coeff`` (m, 3, 6) with ``T`` (m,) and any ``t`` shape, or batched
    ``coeff`` (B, m, 3, 6), ``T`` (B, m), ``t`` (B, n).  Returns
    ``t.shape + (3,)``.  The segment of ``t`` is the first s with
    ``cumsum(T)[s] > t``, clipped to the last segment (the reference's
    ``times[idx] <= t`` walk, polynomial_traj.hpp:45-64).
    """
    m = T.shape[-1]
    edges = torch.cumsum(T, dim=-1)
    if T.dim() == 1:
        seg = torch.searchsorted(edges, t, right=True).clamp(0, m - 1)
        prev = torch.where(seg > 0, edges[(seg - 1).clamp(min=0)], 0.0)
        c = coeff[seg]  # (..., 3, 6)
    else:
        seg = torch.searchsorted(edges, t.contiguous(), right=True)
        seg = seg.clamp(0, m - 1)
        prev = torch.where(
            seg > 0, torch.gather(edges, -1, (seg - 1).clamp(min=0)), 0.0
        )
        idx = seg[..., None, None].expand(*seg.shape, 3, 6)
        c = torch.gather(coeff, -3, idx)  # (B, n, 3, 6)
    basis = (time_powers, vel_powers, acc_powers)[deriv](t - prev)
    return torch.einsum("...j,...xj->...x", basis, c)


def sample_uniform(coeff, T, n: int, deriv: int = 0):
    """Sample at n uniformly spaced global times over [0, sum(T)]."""
    total = torch.sum(T, dim=-1, keepdim=True)
    ts = torch.linspace(0.0, 1.0, n, dtype=T.dtype, device=T.device) * total
    if T.dim() == 1:
        ts = ts.reshape(n)
    return evaluate(coeff, T, ts, deriv), ts


def length(coeff, T, n: int = 400):
    """Arc length by an n-point polyline (polynomial_traj.hpp:80-90)."""
    pts, _ = sample_uniform(coeff, T, n)
    return torch.linalg.norm(torch.diff(pts, dim=-2), dim=-1).sum(-1)


def jerk_cost(coeff, T):
    """Integrated squared jerk, the exact quadratic form per segment
    (polynomial_traj.hpp:108-138).  As in the reference, this is the
    same form its "minimum snap" QP minimizes (qp_generator.cpp:99-110)."""
    i = torch.arange(6, dtype=T.dtype, device=T.device)
    ci = i * (i - 1) * (i - 2)
    denom = i[:, None] + i[None, :] - 5.0
    num = ci[:, None] * ci[None, :]
    mask = (i[:, None] >= 3) & (i[None, :] >= 3)
    gram_unit = torch.where(mask, num / torch.where(mask, denom, 1.0), 0.0)
    tp = T[..., None, None] ** torch.where(mask, denom, 0.0)
    gram = gram_unit * tp  # (..., m, 6, 6)
    return torch.einsum("...mxi,...mij,...mxj->...", coeff, gram, coeff)


def acc_cost(coeff, T):
    """Front-end metric sum ||2 c2||^2 T per segment
    (polynomial_traj.hpp:94-106)."""
    um = 2.0 * coeff[..., 2]  # (..., m, 3)
    return torch.sum(torch.sum(um * um, dim=-1) * T, dim=-1)


def mean_max_speed(coeff, T, n: int = 400):
    """Mean and max speed over a dense sampling (getMeanAndMaxVel,
    polynomial_traj.hpp:140-171, without its end-time evaluation bug)."""
    v, _ = sample_uniform(coeff, T, n, deriv=1)
    s = torch.linalg.norm(v, dim=-1)
    return s.mean(-1), s.amax(-1)


def mean_max_acc(coeff, T, n: int = 400):
    a, _ = sample_uniform(coeff, T, n, deriv=2)
    s = torch.linalg.norm(a, dim=-1)
    return s.mean(-1), s.amax(-1)
