"""Kinodynamic trajectory search (port of
``grad_traj_optimization_tpu.search.kinodynamic``).

Rebuild of the reference ``KinodynamicAstar`` (kinodynamic_astar.{h,cpp})
as a fixed-iteration batched beam search:

* every iteration expands the whole beam by the full acceleration-
  primitive set at once (the reference's 5^3 inputs x durations,
  kinodynamic_astar.cpp:133-143);
* feasibility (map bounds, velocity limits, collision along the primitive,
  kinodynamic_astar.cpp:157-213) becomes masks;
* selection keeps the best-f candidate per voxel (a within-parent sort,
  a pre-cut, one small global sort): the batched analogue of the
  reference's NodeHashTable pruning (kinodynamic_astar.cpp:168-175,
  223-259);
* termination is any beam state whose one-shot cubic to the goal is
  collision-free (computeShotTraj, kinodynamic_astar.cpp:386-451).

The output is knot states (pos, vel, acc, times) for the Hermite seeding
of ``solver.solve_kino_batch``.

The JAX package vmaps a one-lane search; here every tensor carries a
leading lane axis B, and :func:`search` is :func:`search_batch` at B = 1.
The collision sweeps read the distance field with gathers.  The JAX
package's ``lookup="box"`` reads a bit-packed clearance window around
each parent with matrix products (a TPU formulation); here it is the
same reads as gathers (:func:`_window_safe_lanes`), with the box path's
one-shot restricted to the ``shot_topk`` best slots.

Every operation is chosen so that a CPU run and a CUDA run of the same
lanes give the same bits: sums over the three axes are written out in a
fixed order, square roots and the transcendental functions are taken in
float64 and rounded to float32 (the correctly rounded result on both
devices), and selection uses only stable sorts and ``argmin`` (first
index on ties).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from grad_traj_optimization_torch import _device
from grad_traj_optimization_torch.fields import dynamic as _dyn
from grad_traj_optimization_torch.utils import profiling

_NAN = float("nan")
_INF = float("inf")

#: dedup arms with an optional pre-cut K, and K's default (None: beam^2)
_DEDUP_K = {"exact": None, "lex": None, "approx": 512, "pp": 8}


# ---------------------------------------------------------------------------
# Closed-form primitive math (exact ports)
# ---------------------------------------------------------------------------


def _f64(fn, x):
    """fn taken in float64 and rounded to x's dtype."""
    return fn(x.double()).to(x.dtype)


def _sqrt(x):
    """Correctly rounded square root on every device (PyTorch's vectorized
    CPU float32 sqrt can be one ulp off)."""
    return _f64(torch.sqrt, x)


def _sum3(a, b):
    """sum over the last axis of 3 of a * b, in a fixed order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def state_transit(state, u, tau):
    """Double-integrator closed form (kinodynamic_astar.cpp:740-751).

    state (..., 6) = [p, v]; u (..., 3); tau (...,).
    """
    p = state[..., :3]
    v = state[..., 3:]
    tau = torch.as_tensor(tau, dtype=state.dtype, device=state.device)
    tau = tau[..., None]
    p1 = p + v * tau + 0.5 * u * (tau * tau)
    v1 = v + u * tau
    p1, v1 = torch.broadcast_tensors(p1, v1)
    return torch.cat([p1, v1], dim=-1)


#: f32 cbrt exponent bit-trick seed (max rel err 3.2e-2 before the two
#: Halley steps, 2.4e-7 after)
_CBRT_MAGIC = 709953000

#: degree-12 coefficients (ascending, in t = 2 s - 1 with
#: s = sqrt((1 + x) / 2)) of cos(arccos(x) / 3) on [-1, 1]
_COSACOS3_COEF = (
    7.66044443e-01, 2.47409066e-01, -1.55091884e-02, 2.46635329e-03,
    -5.04125005e-04, 1.16421674e-04, -2.89180781e-05, 7.55379954e-06,
    -2.04107582e-06, 5.43584535e-07, -1.52150101e-07, 6.13416383e-08,
    -1.83928907e-08,
)


def _cbrt(x):
    """Real cube root as XLA computes it, sign(x) |x|^float32(1/3), with
    the power taken in float64 (PyTorch has no cbrt)."""
    x64 = x.double()
    third = float(np.float32(1.0 / 3.0))
    return torch.copysign(x64.abs().pow(third), x64).to(x.dtype)


def _fast_cbrt(v):
    """Branchless f32 cbrt without transcendentals: exponent bit-trick
    seed and two division-based Halley steps (max rel err 2.4e-7).  Zero
    maps to zero; NaN propagates."""
    a = torch.abs(v).to(torch.float32)
    i = a.view(torch.int32)
    y = (torch.div(i, 3, rounding_mode="floor") + _CBRT_MAGIC).view(
        torch.float32)
    for _ in range(2):
        y3 = y * y * y
        y = y * (y3 + 2.0 * a) / (2.0 * y3 + a)
    out = torch.where(a > 1e-35, y, 0.0)
    # torch.sign(NaN) is 0, jnp.sign(NaN) is NaN: keep NaN in -> NaN out
    return torch.where(torch.isnan(v), v, torch.sign(v) * out)


def _cos_acos3(x):
    """cos(arccos(x)/3) on [-1, 1]: a degree-12 polynomial in
    t = 2 sqrt((1+x)/2) - 1."""
    s = _sqrt(torch.clamp(0.5 * (1.0 + x), min=0.0))
    t = 2.0 * s - 1.0
    acc = torch.full_like(t, _COSACOS3_COEF[-1])
    for c in _COSACOS3_COEF[-2::-1]:
        acc = acc * t + c
    return acc


def cubic_roots(a, b, c, d, fast: bool = False):
    """Real roots of a x^3 + b x^2 + c x + d (up to 3, NaN-padded), the
    trigonometric/Cardano formulas of kinodynamic_astar.cpp:453-486,
    branchless over the discriminant.  ``fast`` takes the bit-trick cbrt
    and the cos(arccos/3) polynomial with the triple-angle factorization.
    """
    a2 = b / a
    a1 = c / a
    a0 = d / a
    Q = (3 * a1 - a2 * a2) / 9.0
    R = (9 * a1 * a2 - 27 * a0 - 2 * (a2 * (a2 * a2))) / 54.0
    D = Q * (Q * Q) + R * R

    sqrtD = _sqrt(torch.clamp(D, min=0.0))
    cbrt = _fast_cbrt if fast else _cbrt
    S = cbrt(R + sqrtD)
    Tt = cbrt(R - sqrtD)
    r_pos = -a2 / 3 + (S + Tt)  # D > 0: single real root

    # D < 0: three real roots (1e-300 rounds to 0 in float32, as in JAX)
    xx = torch.clamp(R / _sqrt(torch.clamp(-(Q * (Q * Q)), min=1e-300)),
                     -1.0, 1.0)
    sq = 2 * _sqrt(torch.clamp(-Q, min=0.0))
    if fast:
        y0 = _cos_acos3(xx)
        sq3 = _sqrt(torch.clamp(3.0 * (1.0 - y0 * y0), min=0.0))
        r0 = sq * y0 - a2 / 3
        r1 = sq * (-y0 - sq3) * 0.5 - a2 / 3
        r2 = sq * (-y0 + sq3) * 0.5 - a2 / 3
    else:
        theta = _f64(torch.arccos, xx)
        r0 = sq * _f64(torch.cos, theta / 3) - a2 / 3
        r1 = sq * _f64(torch.cos, (theta + 2 * math.pi) / 3) - a2 / 3
        r2 = sq * _f64(torch.cos, (theta + 4 * math.pi) / 3) - a2 / 3

    neg = D < 0
    root_a = torch.where(neg, r0, r_pos)
    root_b = torch.where(neg, r1, _NAN)
    root_c = torch.where(neg, r2, _NAN)
    return torch.stack([root_a, root_b, root_c], dim=-1)


def quartic_roots(a, b, c, d, e, fast: bool = False):
    """Real roots of a x^4 + ... + e (up to 4, NaN-padded): the Ferrari
    resolvent of kinodynamic_astar.cpp:488-528, the first cubic root as
    y1 included."""
    a3 = b / a
    a2 = c / a
    a1 = d / a
    a0 = e / a

    ys = cubic_roots(
        torch.ones_like(a3), -a2, a1 * a3 - 4 * a0,
        4 * a2 * a0 - a1 * a1 - a3 * a3 * a0,
        fast=fast,
    )
    y1 = ys[..., 0]
    r = a3 * a3 / 4 - a2 + y1
    bad = r < 0

    R = _sqrt(torch.clamp(r, min=0.0))
    safeR = torch.where(R != 0, R, 1.0)
    a3_3 = a3 * (a3 * a3)
    Dsq_r = (
        0.75 * a3 * a3 - R * R - 2 * a2
        + 0.25 * (4 * a3 * a2 - 8 * a1 - a3_3) / safeR
    )
    Esq_r = (
        0.75 * a3 * a3 - R * R - 2 * a2
        - 0.25 * (4 * a3 * a2 - 8 * a1 - a3_3) / safeR
    )
    inner = _sqrt(torch.clamp(y1 * y1 - 4 * a0, min=0.0))
    Dsq_0 = 0.75 * a3 * a3 - 2 * a2 + 2 * inner
    Esq_0 = 0.75 * a3 * a3 - 2 * a2 - 2 * inner
    Dsq = torch.where(R != 0, Dsq_r, Dsq_0)
    Esq = torch.where(R != 0, Esq_r, Esq_0)

    Dv = _sqrt(Dsq)  # NaN when negative: the reference's isnan() gate
    Ev = _sqrt(Esq)
    roots = torch.stack(
        [
            -a3 / 4 + R / 2 + Dv / 2,
            -a3 / 4 + R / 2 - Dv / 2,
            -a3 / 4 - R / 2 + Ev / 2,
            -a3 / 4 - R / 2 - Ev / 2,
        ],
        dim=-1,
    )
    return torch.where(bad[..., None], _NAN, roots)


def estimate_heuristic(x1, x2, w_time: float, max_vel: float,
                       tie_breaker: float = 1.0 / 10000.0,
                       fast: bool = False):
    """Pontryagin heuristic and optimal connection time
    (kinodynamic_astar.cpp:348-384): minimize
    c(t) = -c1/(3t^3) - c2/(2t^2) - c3/t + w_time * t over the real roots
    of its derivative quartic and the velocity lower bound t_bar.

    x1, x2 (..., 6) -> (cost, t_opt), each (...).
    """
    dp = x2[..., :3] - x1[..., :3]
    v0 = x1[..., 3:]
    v1 = x2[..., 3:]

    c1 = -36.0 * _sum3(dp, dp)
    c2 = 24.0 * _sum3(v0 + v1, dp)
    c3 = -4.0 * (_sum3(v0, v0) + _sum3(v0, v1) + _sum3(v1, v1))
    c4 = torch.zeros_like(c1)
    c5 = torch.full_like(c1, w_time)

    ts = quartic_roots(c5, c4, c3, c2, c1, fast=fast)  # (..., 4)
    t_bar = torch.amax(torch.abs(dp), dim=-1) / max_vel
    cand = torch.cat([ts, t_bar[..., None]], dim=-1)  # (..., 5)

    t = torch.where(torch.isnan(cand) | (cand < t_bar[..., None]), _INF,
                    cand)
    cost = (
        -c1[..., None] / (3 * (t * (t * t)))
        - c2[..., None] / (2 * t * t)
        - c3[..., None] / t
        + w_time * t
    )
    cost = torch.where(torch.isfinite(t), cost, _INF)
    best = torch.amin(cost, dim=-1)
    k = torch.argmin(cost, dim=-1)
    t_opt = torch.gather(
        torch.where(torch.isfinite(t), t, t_bar[..., None]), -1, k[..., None]
    )[..., 0]
    return (1.0 + tie_breaker) * best, t_opt


def shot_coeffs(state1, state2, t_d):
    """Cubic one-shot connection coefficients (ascending powers,
    (..., 3, 4)): computeShotTraj's block (kinodynamic_astar.cpp:393-404),
    p(t) = d + c t + b t^2 + a t^3 with the end state matched exactly."""
    p0 = state1[..., :3]
    dp = state2[..., :3] - p0
    v0 = state1[..., 3:]
    v1 = state2[..., 3:]
    dv = v1 - v0
    td = torch.as_tensor(t_d, dtype=state1.dtype, device=state1.device)
    td = td[..., None]
    a = (1.0 / 6.0) * (
        -12.0 / (td * (td * td)) * (dp - v0 * td) + 6.0 / (td * td) * dv
    )
    b = 0.5 * (6.0 / (td * td) * (dp - v0 * td) - 2.0 / td * dv)
    p0, v0, b, a = torch.broadcast_tensors(p0, v0, b, a)
    return torch.stack([p0, v0, b, a], dim=-1)  # (..., 3, 4)


class _Extent(NamedTuple):
    """A grid's extent on the device, built once for a graph capture, in
    which no copy of host memory may be made: the resolution, the grid's
    size in metres and, for the box lookup, the bounds of a window's start
    cell (``_window_safe_lanes``' ``lo`` and ``hi``)."""

    res: torch.Tensor
    size: torch.Tensor
    lo: torch.Tensor | None = None
    hi: torch.Tensor | None = None


def _lane_cells(dists, origins, resolution, pos, window=None, extent=None):
    """The in-map test (the reference's 1e-4 margins) and each position's
    flat cell index into ``dists``, the cell clamped to the grid and, with
    ``window = (start, bx, by)``, its x and y clamped further into the
    bx x by cells from ``start`` (..., 2).

    dists (G, nx, ny, nz) with G = 1 (one shared map) or B; origins
    (B, 3); pos (B, ..., 3) -> ok, flat, each (B, ...).  ``extent`` (an
    :class:`_Extent` of this grid) gives the resolution and size on the
    device; without it both are copied from the host.
    """
    B = pos.shape[0]
    G, nx, ny, nz = dists.shape
    o = origins.reshape((B,) + (1,) * (pos.dim() - 2) + (3,))
    if extent is None:
        res = profiling.to_device(resolution, "kinodynamic.lane_cells",
                                  pos.device, pos.dtype)
        size = profiling.to_device((nx, ny, nz), "kinodynamic.lane_cells",
                                   pos.device, pos.dtype) * res
    else:
        res, size = extent.res, extent.size
    ok = torch.all((pos > o + 1e-4) & (pos < o + size - 1e-4), dim=-1)
    rel = (pos - o) / res
    ix = torch.floor(rel[..., 0]).to(torch.int32).clamp_(0, nx - 1)
    iy = torch.floor(rel[..., 1]).to(torch.int32).clamp_(0, ny - 1)
    iz = torch.floor(rel[..., 2]).to(torch.int32).clamp_(0, nz - 1)
    del rel
    if window is not None:
        start, bx, by = window
        sx, sy = start[..., 0], start[..., 1]
        ix = sx + (ix - sx).clamp_(0, bx - 1)
        iy = sy + (iy - sy).clamp_(0, by - 1)
    flat = ((ix * ny + iy) * nz + iz).long()
    del ix, iy, iz
    if G > 1:
        base = torch.arange(B, device=pos.device) * (nx * ny * nz)
        flat += base.reshape((B,) + (1,) * (flat.dim() - 1))
    return ok, flat


def _distance_at_lanes(dists, origins, resolution, pos, extent=None):
    """Nearest-cell distance, -1 out of map (sdf_map.cpp:155-164), for
    lane-led positions: dists (G, nx, ny, nz) with G = 1 (one shared map)
    or B; origins (B, 3); pos (B, ..., 3) -> (B, ...).  ``extent`` as in
    :func:`_lane_cells`."""
    ok, flat = _lane_cells(dists, origins, resolution, pos, extent=extent)
    return torch.where(ok, dists.reshape(-1)[flat], -1.0)


def _shot_positions(state1, state2, t_d, n_check: int):
    """(..., n_check, 3) samples at t_d k / n_check, k = 1..n_check, of
    the one-shot cubic."""
    coef = shot_coeffs(state1, state2, t_d)  # (..., 3, 4)
    ks = torch.arange(1, n_check + 1, dtype=coef.dtype,
                      device=coef.device) / n_check
    td = torch.as_tensor(t_d, dtype=coef.dtype, device=coef.device)
    ts = td[..., None] * ks  # (..., n_check)
    pos = coef[..., None, :, 0]
    tk = ts[..., None]
    tp = tk
    for j in range(1, 4):
        pos = pos + tp * coef[..., None, :, j]
        tp = tp * tk
    return pos


def shot_feasible(state1, state2, t_d, dist_grid, origin, resolution,
                  margin: float, n_check: int = 10):
    """Collision/bounds sweep of the one-shot cubic
    (kinodynamic_astar.cpp:415-446: ``n_check`` samples, EDT > margin)
    against one (nx, ny, nz) grid."""
    pos = _shot_positions(state1, state2, t_d, n_check)
    origin = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    d = _distance_at_lanes(dist_grid[None], origin.reshape(1, 3),
                           resolution, pos[None])[0]
    return torch.all(d > margin, dim=-1)


def default_box_cells(max_vel: float, max_acc: float, max_tau: float,
                      resolution: float) -> int:
    """Box half-width (cells) covering one primitive's reach from a
    feasible parent: |v| <= max_vel per axis, so displacement over tau
    is bounded by max_vel * tau + 0.5 * max_acc * tau^2."""
    disp = max_vel * max_tau + 0.5 * max_acc * max_tau**2
    return int(np.ceil(disp / resolution)) + 1


def _window_bounds(half: int, nx: int, ny: int):
    """The box lookup's window in cells (bx, by) and the bounds (lo, hi)
    of its start cell in x and y."""
    bx, by = min(2 * half + 1, nx), min(2 * half + 1, ny)
    return bx, by, ((bx - 1) // 2, (by - 1) // 2), (nx - bx, ny - by)


def _window_safe_lanes(dists, origins, resolution, parent_pos, pos,
                       half: int, margin: float, extent=None):
    """The box lookup's clearance: ``in_map & (dist > margin)`` at each
    sample's cell, its x and y clamped into the (2 half + 1)-cell window
    around its parent's cell (the JAX package's ``_window_safe``, read
    with gathers instead of bit-packed planes and matrix products).  A
    sample within ``half`` cells of its parent reads its own cell, so
    with the default half-width (:func:`default_box_cells`) every feasible
    parent's sweep equals the gather path's; a smaller override clamps
    the farther samples into the window, as the JAX package does.

    dists (G, nx, ny, nz), G = 1 or B; origins (B, 3); parent_pos
    (B, beam, 3); pos (B, beam, ..., 3) -> (B, beam, ...) bool.
    ``extent`` (an :class:`_Extent` with the window's bounds) as in
    :func:`_lane_cells`.
    """
    B, beam = parent_pos.shape[:2]
    nx, ny = dists.shape[1:3]
    bx, by, lo, hi = _window_bounds(half, nx, ny)
    dev = pos.device
    if extent is None:
        res = torch.as_tensor(resolution, dtype=pos.dtype, device=dev)
        lo = torch.tensor(lo, dtype=torch.int32, device=dev)
        hi = torch.tensor(hi, dtype=torch.int32, device=dev)
    else:
        res, lo, hi = extent.res, extent.lo, extent.hi
    ctr = torch.floor((parent_pos[..., :2] - origins[:, None, :2]) / res
                      ).to(torch.int32)
    start = torch.minimum(torch.clamp(ctr - lo, min=0), hi)
    start = start.reshape((B, beam) + (1,) * (pos.dim() - 3) + (2,))
    ok, flat = _lane_cells(dists, origins, res, pos, (start, bx, by), extent)
    return ok & (dists.reshape(-1)[flat] > margin)


# ---------------------------------------------------------------------------
# Batched beam search
# ---------------------------------------------------------------------------


class KinoResult(NamedTuple):
    """Search result; every field carries a leading lane axis when it
    comes from :func:`search_batch`."""

    pos: torch.Tensor      # (n_knots, 3) knot positions
    vel: torch.Tensor      # (n_knots, 3)
    acc: torch.Tensor      # (n_knots, 3)
    times: torch.Tensor    # (n_knots - 1,) segment durations
    reached: torch.Tensor  # () bool: the one-shot to the goal succeeded
    cost: torch.Tensor     # () g-score of the selected leaf


def _primitive_set(max_acc: float, n_acc: int = 5):
    """The reference input set: n_acc^3 accelerations with z halved
    (kinodynamic_astar.cpp:133-139)."""
    lin = np.linspace(-max_acc, max_acc, n_acc)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    g = g.reshape(-1, 3)
    g[:, 2] *= 0.5
    return g.astype(np.float32)


def _dedup_arm(dedup: str, beam: int) -> tuple[str, int]:
    """(arm, pre-cut K) of a dedup name: "exact<K>", "lex<K>",
    "approx<K>", "pp<K>" (K optional) or "parent"."""
    if dedup == "parent":
        return "parent", 0
    for arm, k0 in _DEDUP_K.items():
        rest = dedup[len(arm):]
        if dedup.startswith(arm) and (rest == "" or rest.isdigit()):
            if rest:
                return arm, int(rest)
            return arm, beam * beam if k0 is None else k0
    raise ValueError(f"unknown dedup {dedup!r}")


def _select_beam(arm: str, k: int, f_s1, ks1, gidx1, beam: int, PN: int,
                 big):
    """The next beam's candidate indices (B, beam) from the within-parent
    survivors: f_s1 (B, N) their f (big where a parent's voxel repeats),
    ks1 their voxel keys and gidx1 their candidate indices.

    "exact", "lex" and "approx" cut at the k best f (off the TPU the JAX
    package's lexsort and approx_max_k cuts select as its sort does), "pp"
    at each parent's k best, and "parent" takes the beam best as they
    stand.  The cut survivors are then sorted stably by (voxel, f), the
    first of each voxel kept and the beam best taken, ties to the lower
    index (jax.lax.top_k on -f).  With f sorted first, a stable sort by
    voxel IS the stable (voxel, f) sort."""
    B, N = f_s1.shape
    if arm == "parent":
        return torch.gather(
            gidx1, -1, torch.argsort(f_s1, dim=-1, stable=True)[:, :beam])
    if arm == "pp":
        rows = f_s1.reshape(B, beam, PN)
        pos = torch.argsort(rows, dim=-1, stable=True)[..., :min(PN, k)]
        fK = torch.gather(rows, -1, pos).reshape(B, -1)
        hK = torch.gather(ks1.reshape(B, beam, PN), -1, pos).reshape(B, -1)
        oidx = torch.gather(gidx1.reshape(B, beam, PN), -1, pos
                            ).reshape(B, -1)
        o0 = torch.argsort(fK, dim=-1, stable=True)
        fK = torch.gather(fK, -1, o0)
        hK = torch.gather(hK, -1, o0)
        oidx = torch.gather(oidx, -1, o0)
    else:
        k_pre = min(N, k)
        fK, pK = torch.sort(f_s1, dim=-1, stable=True)
        fK, pK = fK[:, :k_pre], pK[:, :k_pre]
        hK = torch.gather(ks1, -1, pK)
        oidx = torch.gather(gidx1, -1, pK)
    o3 = torch.argsort(hK, dim=-1, stable=True)
    hs2 = torch.gather(hK, -1, o3)
    first2 = torch.ones_like(hs2, dtype=torch.bool)
    first2[:, 1:] = hs2[:, 1:] != hs2[:, :-1]
    f_dd = torch.where(first2, torch.gather(fK, -1, o3), big)
    o4 = torch.argsort(f_dd, dim=-1, stable=True)[:, :beam]
    return torch.gather(torch.gather(oidx, -1, o3), -1, o4)


class _Consts(NamedTuple):
    """:func:`_search_impl`'s constants on the device: the primitive set,
    the infeasible cost ``big``, the last cell index on each axis and the
    grid's :class:`_Extent`."""

    prim: torch.Tensor
    big: torch.Tensor
    gmax: torch.Tensor
    extent: _Extent


def _search_consts(grid_shape, resolution, max_acc: float, n_acc: int,
                   dev, half: int | None = None) -> _Consts:
    """The constants of a search on a (nx, ny, nz) grid, copied from the
    host (each copy counted under ``sync.h2d.kinodynamic.search_consts``);
    with ``half`` the box lookup's window bounds too."""
    site = "kinodynamic.search_consts"
    f32 = torch.float32
    prim = profiling.to_device(_primitive_set(max_acc, n_acc), site, dev)
    res = profiling.to_device(resolution, site, dev, f32)
    big = profiling.to_device(1e18, site, dev, f32)
    size = profiling.to_device(grid_shape, site, dev, f32) * res
    gmax = profiling.to_device(grid_shape, site, dev, torch.int32) - 1
    lo = hi = None
    if half is not None:
        _, _, lo, hi = _window_bounds(half, *grid_shape[:2])
        lo = profiling.to_device(lo, site, dev, torch.int32)
        hi = profiling.to_device(hi, site, dev, torch.int32)
    return _Consts(prim, big, gmax, _Extent(res, size, lo, hi))


def _search_impl(dists, origins, resolution, starts, goals, pred,
                 start_times, *, max_acc: float, max_vel: float,
                 max_tau: float, w_time: float, lambda_heu: float,
                 margin: float, max_iters: int, beam: int, n_acc: int,
                 n_dur: int, check_num: int, max_knots: int, dedup: str,
                 heu: str, lookup: str, shot_topk: int,
                 box_cells: int, consts: _Consts | None = None) -> KinoResult:
    """Beam search of B lanes from starts to goals, (B, 6) each.

    With ``pred`` (a predictor.ObjPrediction, shared or per lane) the
    collision checks use the space-time oracle min(static EDT, predicted
    boxes at the node's absolute time): the reference's dynamic mode
    (kinodynamic_astar.cpp:199-213 via evaluateCoarseEDT(pos, t)).

    Returns up to ``max_knots`` knot states along each lane's best
    branch, the last knot the goal when the one-shot connected.
    Termination is tracked every iteration; primitives after the winning
    iteration come back with zero duration at the FRONT of the branch
    (consumers drop zero-time segments).

    Primitives are swept at ``check_num`` samples, as in the reference
    (compare22.launch:18), so with ``margin`` below the map resolution a
    one-voxel wall can slip between samples there as here.

    ``lookup`` is "gather" or "box" (the sweeps read through
    :func:`_window_safe_lanes` with half-width ``box_cells``); with
    0 < ``shot_topk`` < beam only that many slots, those of least g + h,
    are swept for the one-shot each iteration, the others reading as
    infeasible.

    ``consts`` (:func:`_search_consts` of this grid and these parameters)
    makes the search copy nothing from the host, the lookups' extent
    included, so that it can be captured as a CUDA graph; without it the
    constants and each lookup's extent are copied from the host.
    """
    dev = starts.device
    f32 = torch.float32
    B = starts.shape[0]
    grid_shape = tuple(dists.shape[1:])
    if consts is None:  # the lookups copy their own extent
        consts = _search_consts(grid_shape, resolution, max_acc, n_acc, dev)
        ext = None
    else:
        ext = consts.extent
    prim, big, gmax = consts.prim, consts.big, consts.gmax
    res, size = consts.extent.res, consts.extent.size
    P = prim.shape[0]
    nd = n_dur
    PN = P * nd
    N = beam * PN
    taus = (torch.arange(1, nd + 1, dtype=f32, device=dev) / nd) * max_tau
    lanes = torch.arange(B, device=dev)
    o5 = origins.reshape(B, 1, 1, 1, 3)
    ks = torch.arange(1, check_num + 1, dtype=f32, device=dev) / check_num
    t_sweep = taus[:, None] * ks[None, :]  # (nd, check_num)
    prim_cost = (_sum3(prim, prim)[None, :, None] + w_time) * taus[None, None]
    goal = goals[:, None, :]

    states = starts[:, None, :].expand(B, beam, 6)
    g = torch.full((B, beam), 1e18, dtype=f32, device=dev)
    g[:, 0] = 0.0
    tcur = start_times[:, None].expand(B, beam)
    hist_parent, hist_u, hist_tau = [], [], []

    def shot_total(st, gb):
        """Best-case total (g + shot-feasible h) per slot, and the shot
        time.  The shot is swept at 32 samples (the reference's 10 are
        safe only for its short near-goal shots)."""
        h_b, t_sh = estimate_heuristic(st, goal, w_time, max_vel)
        t_hold = torch.clamp(t_sh, min=1e-2)
        if 0 < shot_topk < st.shape[1]:
            score = gb + torch.where(torch.isfinite(h_b), h_b, 0.0)
            sel = torch.argsort(score, dim=1, stable=True)[:, :shot_topk]
            pos = _shot_positions(
                torch.gather(st, 1, sel[..., None].expand(-1, -1, 6)), goal,
                torch.gather(t_hold, 1, sel), 32)
            feas = torch.zeros(st.shape[:2], dtype=torch.bool, device=dev)
            feas.scatter_(1, sel, torch.all(
                _distance_at_lanes(dists, origins, res, pos, ext) > margin,
                dim=-1))
        else:
            pos = _shot_positions(st, goal, t_hold, 32)
            feas = torch.all(
                _distance_at_lanes(dists, origins, res, pos, ext) > margin,
                dim=-1)
        return gb + torch.where(feas, h_b, 0.5 * big), t_sh

    def vox_key(pos_c):
        vox = torch.floor((pos_c - o5) / res).to(torch.int32)
        vox = torch.minimum(torch.clamp(vox, min=0), gmax)
        return (vox[..., 0] * grid_shape[1] + vox[..., 1]) * grid_shape[2] \
            + vox[..., 2]

    # the direct shot from the start state (zero primitives)
    total0, tsh0 = shot_total(states[:, :1], g[:, :1])
    best_total = total0[:, 0]
    best_it = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_slot = torch.zeros((B,), dtype=torch.int64, device=dev)
    best_tshot = tsh0[:, 0]
    best_g = g[:, 0] * 0.0

    arm, k_cut = _dedup_arm(dedup, beam)
    for it in range(max_iters):
        # expand: (B, beam, P, nd, 6)
        cand = state_transit(states[:, :, None, None, :],
                             prim[None, None, :, None, :],
                             taus[None, None, None, :])
        gc = g[:, :, None, None] + prim_cost

        # feasibility masks (kinodynamic_astar.cpp:157-213)
        p = cand[..., :3]
        v = cand[..., 3:]
        in_map = torch.all((p > o5 + 1e-3) & (p < o5 + size - 1e-3), dim=-1)
        vel_ok = torch.all(torch.abs(v) <= max_vel, dim=-1)

        # collision sweep along each primitive: (B, beam, P, nd, ck, 3)
        ts = t_sweep[:, :, None]
        sweep = (states[:, :, None, None, None, :3]
                 + states[:, :, None, None, None, 3:] * ts
                 + 0.5 * prim[None, None, :, None, None, :] * (ts * ts))
        if lookup == "box":
            safe = _window_safe_lanes(dists, origins, res, states[..., :3],
                                      sweep, box_cells, margin, ext)
        else:
            safe = _distance_at_lanes(dists, origins, res, sweep,
                                      ext) > margin
        if pred is not None:
            t_samp = tcur[:, :, None, None, None] + t_sweep
            d_box = _dyn.min_dist_to_boxes(sweep, t_samp, pred)
            safe &= d_box > margin
            del d_box
        del sweep
        ok = in_map & vel_ok & torch.all(safe, dim=-1)
        del safe
        gc = torch.where(ok, gc, big)

        h, _ = estimate_heuristic(cand, goal[:, :, None, None, :], w_time,
                                  max_vel, fast=(heu == "fast"))
        f = gc + lambda_heu * torch.where(torch.isfinite(h), h, 0.0)
        f = torch.where(ok, f, big)

        # selection with voxel dedup: the best-f candidate per occupied
        # voxel, then the beam best over distinct voxels.  Stage 1 caps
        # per-voxel duplication at `beam` (one survivor per parent per
        # voxel), so every voxel winner that can reach the final beam lies
        # in the top beam^2 by f ("exact"; "exact<K>" cuts at K; the other
        # arms cut otherwise, _select_beam).
        #
        # A stable sort by (voxel, f) is two stable sorts, f first.  f is
        # finite and > 0 (g grows by w_time * tau > 0 per primitive, the
        # heuristic is an optimal-control cost >= 0, infeasible entries
        # carry 1e18), so the JAX comparator's -0.0 < +0.0 and NaN-last
        # orders, which torch.sort does not keep, never come up.
        keys = vox_key(p).reshape(B, beam, PN)
        f_pp = f.reshape(B, beam, PN)
        o1 = torch.argsort(f_pp, dim=-1, stable=True)
        k1 = torch.gather(keys, -1, o1)
        o2 = torch.argsort(k1, dim=-1, stable=True)
        src1 = torch.gather(o1, -1, o2)
        ks1 = torch.gather(k1, -1, o2).reshape(B, N)
        f1s = torch.gather(f_pp, -1, src1)
        first1 = torch.ones_like(ks1, dtype=torch.bool).reshape(B, beam, PN)
        k1r = ks1.reshape(B, beam, PN)
        first1[..., 1:] = k1r[..., 1:] != k1r[..., :-1]
        f_s1 = torch.where(first1, f1s, big).reshape(B, N)
        gidx1 = (src1 + torch.arange(beam, device=dev)[:, None] * PN
                 ).reshape(B, N)
        idx = _select_beam(arm, k_cut, f_s1, ks1, gidx1, beam, PN, big)

        states = torch.gather(cand.reshape(B, N, 6), 1,
                              idx[..., None].expand(B, beam, 6))
        new_g = torch.gather(gc.reshape(B, N), 1, idx)
        parent = idx // PN
        rem = idx % PN
        u_sel = prim[rem // nd]
        tau_sel = taus[rem % nd]
        hist_parent.append(parent)
        hist_u.append(u_sel)
        hist_tau.append(tau_sel)
        tcur = torch.gather(tcur, 1, parent) + tau_sel
        g = new_g
        del cand, gc, p, v, h, f, keys, f_pp, f_s1, gidx1

        # early-termination tracking (the reference stops as soon as the
        # one-shot connects, kinodynamic_astar.cpp:86-117): the best
        # shot-feasible leaf over all iterations
        total_it, t_sh_it = shot_total(states, g)
        slot_it = torch.argmin(total_it, dim=1)
        tot = total_it[lanes, slot_it]
        better = tot < best_total
        best_total = torch.where(better, tot, best_total)
        best_it = torch.where(better, it, best_it)
        best_slot = torch.where(better, slot_it, best_slot)
        best_tshot = torch.where(better, t_sh_it[lanes, slot_it], best_tshot)
        best_g = torch.where(better, g[lanes, slot_it], best_g)

    reached = best_total < 0.25 * big

    # backtrack the branch from the best leaf; iterations after it get
    # u = 0, tau = 0
    slot = best_slot
    us = [None] * max_iters
    tds = [None] * max_iters
    for it in range(max_iters - 1, -1, -1):
        active = it <= best_it
        us[it] = torch.where(active[:, None], hist_u[it][lanes, slot], 0.0)
        tds[it] = torch.where(active, hist_tau[it][lanes, slot], 0.0)
        slot = torch.where(active, hist_parent[it][lanes, slot], slot)

    # forward-integrate the branch to knot states
    st = starts
    knots = []
    for it in range(max_iters):
        st = state_transit(st, us[it], tds[it])
        knots.append(st)
    knots = torch.stack(knots, dim=1)  # (B, max_iters, 6)
    accs = torch.stack(us, dim=1)
    ktaus = torch.stack(tds, dim=1)
    pos = torch.cat([starts[:, None, :3], knots[..., :3]], dim=1)
    vel = torch.cat([starts[:, None, 3:], knots[..., 3:]], dim=1)
    acc = torch.cat([accs, accs[:, -1:]], dim=1)
    # rotate the masked post-termination tail (zero-duration copies of the
    # best leaf) to the FRONT, so the keep-the-LAST trim below discards
    # copies before real knots: a per-lane roll by n_masked
    n_masked = (max_iters - 1 - best_it)[:, None]

    def roll(x):
        L = x.shape[1]
        src = torch.remainder(torch.arange(L, device=dev)[None] - n_masked, L)
        if x.dim() == 3:
            src = src[..., None].expand(-1, -1, x.shape[2])
        return torch.gather(x, 1, src)

    pos, vel, acc, ktaus = roll(pos), roll(vel), roll(acc), roll(ktaus)
    # the one-shot goal knot
    pos = torch.cat([pos, goals[:, None, :3]], dim=1)
    vel = torch.cat([vel, goals[:, None, 3:]], dim=1)
    acc = torch.cat([acc, torch.zeros_like(acc[:, :1])], dim=1)
    times = torch.cat([ktaus, torch.clamp(best_tshot, min=1e-2)[:, None]],
                      dim=1)
    k = pos.shape[1]
    if k > max_knots:  # keep the LAST max_knots knots
        pos, vel, acc = (x[:, k - max_knots:] for x in (pos, vel, acc))
        times = times[:, k - max_knots:]
    return KinoResult(pos=pos, vel=vel, acc=acc, times=times,
                      reached=reached, cost=best_g)


_SEARCH_DEFAULTS = dict(
    max_acc=2.0, max_vel=3.0, max_tau=0.5, w_time=10.0, lambda_heu=5.0,
    margin=0.2, max_iters=30, beam=64, n_acc=5, n_dur=2, check_num=5,
    max_knots=32, dedup="exact512", heu="exact",
)


def search_batch(dists, origins, resolution: float, starts, goals,
                 obstacle_pred=None, start_times=None, lookup: str = "auto",
                 shot_topk: int | None = None, box_cells: int = 0,
                 device=None, **kw) -> KinoResult:
    """Batched beam search of B missions (the reference's compare2 loop,
    compare2.cpp:168-177, as one batched program).

    Args:
      dists: (B, nx, ny, nz) distance fields, or (1, ...) shared by every
        lane.  The lanes run on the device of a tensor ``dists``; a numpy
        ``dists`` goes to ``device`` (the card unless asked otherwise),
        and a tensor argument on another device raises ValueError
        (``_device``).
      origins: (B, 3); resolution: shared float.
      starts, goals: (B, 6) states.
      obstacle_pred: a predictor.ObjPrediction for the reference's dynamic
        mode (compare22's evaluateCoarseEDT oracle), shared
        ((n_obj, ...)) or per lane ((B, n_obj, ...)).
      start_times: (B,) absolute start times (default zeros).
      lookup: "auto" and "gather" read the field with gathers; "box"
        reads each primitive's sweep within a window of ``box_cells``
        cells around its parent (:func:`_window_safe_lanes`; default
        :func:`default_box_cells`, which gives the gather path's values).
      shot_topk: sweep the one-shot from only this many beam slots an
        iteration, those of least g + h (default 0, every slot, or
        min(8, beam) with ``lookup="box"``), as the JAX package does.
      box_cells: the box's half-width in cells (0: the default).
      kw: the search parameters (max_acc, max_vel, max_tau, w_time,
        lambda_heu, margin, max_iters, beam, n_acc, n_dur, check_num,
        max_knots, dedup, heu), defaults as the JAX package's.
    Returns:
      KinoResult with a leading lane axis on every field.
    """
    p = _search_params(resolution, lookup, shot_topk, box_cells, **kw)
    dists, dev = _device.field_device(dists, device)
    dists = dists.to(torch.float32)
    _device.check_on(dev, obstacle_pred=obstacle_pred)
    starts = _device.on(starts, dev, "starts")
    goals = _device.on(goals, dev, "goals")
    B = starts.shape[0]
    origins = _device.on(origins, dev, "origins").expand(B, 3)
    if dists.shape[0] not in (1, B):
        raise ValueError(f"dists leading dim {dists.shape[0]} not 1 or {B}")
    if start_times is None:
        start_times = torch.zeros((B,), dtype=torch.float32, device=dev)
    else:
        start_times = _device.on(start_times, dev, "start_times")
    return _search_impl(dists, origins, resolution, starts, goals,
                        obstacle_pred, start_times, **p)


def _search_params(resolution, lookup: str = "auto",
                   shot_topk: int | None = None, box_cells: int = 0,
                   **kw) -> dict:
    """:func:`_search_impl`'s keyword arguments: the search parameters
    over their defaults, and the lookup, ``shot_topk`` and ``box_cells``
    resolved as :func:`search_batch` states; each checked."""
    unknown = set(kw) - set(_SEARCH_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown search arguments {sorted(unknown)}")
    p = dict(_SEARCH_DEFAULTS, **kw)
    if lookup == "auto":
        lookup = "gather"
    if lookup not in ("gather", "box"):
        raise ValueError(f"unknown lookup {lookup!r}")
    if lookup == "box" and box_cells == 0:
        box_cells = default_box_cells(p["max_vel"], p["max_acc"],
                                      p["max_tau"], float(resolution))
    if shot_topk is None:
        shot_topk = min(8, p["beam"]) if lookup == "box" else 0
    _dedup_arm(p["dedup"], p["beam"])
    if p["heu"] not in ("exact", "fast"):
        raise ValueError(f"unknown heu {p['heu']!r}")
    return dict(p, lookup=lookup, shot_topk=shot_topk, box_cells=box_cells)


#: the most search graphs kept (one a search shape), least recently used
#: first out: a robot's replan loop uses one shape per count of the boxes
#: it predicts, and ``search_adaptive`` one per rung of its retries
GRAPH_CACHE_SIZE = 8

#: :func:`search`'s captured graphs by key, least recently used first
_GRAPHS: OrderedDict = OrderedDict()

#: the keys of the shapes called once and not yet captured, least
#: recently used first; at most ``_SEEN_SIZE`` kept
_SEEN: OrderedDict = OrderedDict()
_SEEN_SIZE = 64


class _SearchGraph:
    """:func:`_search_impl` at one lane captured as a CUDA graph: the
    static inputs a call's tensors are copied into, the constants built
    once, and the static outputs each replay writes anew."""

    def __init__(self, dists, pred, resolution: float, params: dict):
        dev = dists.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.dists = torch.empty(dists.shape, **f32)
        self.origins, self.starts, self.goals = (
            torch.empty((1, n), **f32) for n in (3, 6, 6))
        self.start_times = torch.empty((1,), **f32)
        self.pred = (None if pred is None
                     else type(pred)(*(torch.empty_like(x) for x in pred)))
        self.consts = _search_consts(
            tuple(dists.shape[1:]), resolution, params["max_acc"],
            params["n_acc"], dev,
            params["box_cells"] if params["lookup"] == "box" else None)
        # a stream of the field's card: the search's kernels are captured
        # on it, whichever card is current
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev)):
            self.out = _search_impl(
                self.dists, self.origins, resolution, self.starts,
                self.goals, self.pred, self.start_times, consts=self.consts,
                **params)

    def replay(self, dists, origins, starts, goals, pred,
               start_time: float) -> KinoResult:
        """The search of a call's inputs, copied into the static ones on
        the device and replayed; tensors of its own."""
        for dst, src in ((self.dists, dists), (self.origins, origins),
                         (self.starts, starts), (self.goals, goals)):
            dst.copy_(src)
        self.start_times.fill_(start_time)
        if pred is not None:
            for dst, src in zip(self.pred, pred):
                dst.copy_(src)
        self.graph.replay()
        return KinoResult(*(x.clone() for x in self.out))


def _seen(key) -> None:
    """Mark a shape's key as called once and not captured."""
    _SEEN[key] = True
    while len(_SEEN) > _SEEN_SIZE:
        _SEEN.popitem(last=False)


def _search_graphed(dists, origins, resolution: float, starts, goals, pred,
                    start_time: float, params: dict) -> KinoResult:
    """:func:`search` on a card, with the card current: a shape's first
    call eagerly (:func:`search_batch`'s search, which also loads every
    kernel the capture takes), its second a capture and a replay, every
    later call a replay."""
    key = (dists.device, tuple(dists.shape), resolution,
           None if pred is None else tuple((tuple(x.shape), x.dtype)
                                           for x in pred),
           tuple(sorted(params.items())))
    g = _GRAPHS.pop(key, None)
    if g is None:
        if _SEEN.pop(key, None) is None:
            _seen(key)
            return _search_impl(
                dists.to(torch.float32), origins, resolution, starts, goals,
                pred, torch.full((1,), start_time, device=dists.device),
                **params)
        g = _SearchGraph(dists, pred, resolution, params)
        profiling.add("search.graph_captures")
    _GRAPHS[key] = g
    while len(_GRAPHS) > GRAPH_CACHE_SIZE:
        # a shape evicted has been called twice: its next call captures
        _seen(_GRAPHS.popitem(last=False)[0])
    profiling.add("search.graph_replays")
    return g.replay(dists, origins, starts, goals, pred, start_time)


def search(dist_grid, origin, resolution, start_state, goal_state,
           obstacle_pred=None, start_time: float = 0.0,
           lookup: str = "auto", device=None, **kw) -> KinoResult:
    """Beam search of one mission: :func:`search_batch` at B = 1 (see
    there for the arguments and the device rule).

    On a CUDA device the search is a CUDA graph, replayed, bitwise the
    eager search: one capture for each search shape (device, grid shape,
    resolution, the prediction's shapes and every search parameter), at
    most ``GRAPH_CACHE_SIZE`` kept, least recently used first out.  A
    shape's first call runs eagerly and captures nothing, so a shape
    called once costs no capture; its second captures, as does the next
    call of a shape evicted.  The inputs are
    copied into the graph's own on the device before each replay, and
    each call returns tensors of its own.  Counts (``utils.profiling``):
    ``search.graph_captures`` and ``search.graph_replays``.  On any other
    device the search runs eagerly, through :func:`search_batch`.
    """
    dist_grid, dev = _device.field_device(dist_grid, device)
    if obstacle_pred is not None and obstacle_pred.poly.dim() == 4:
        raise ValueError("search takes a shared (n_obj, ...) prediction")
    origins = _device.on(origin, dev, "origin")[None]
    starts = _device.on(start_state, dev, "start_state")[None]
    goals = _device.on(goal_state, dev, "goal_state")[None]
    if dev.type == "cuda":
        _device.check_on(dev, obstacle_pred=obstacle_pred)
        with torch.cuda.device(dev):
            r = _search_graphed(
                dist_grid[None], origins, float(resolution), starts, goals,
                obstacle_pred, float(start_time),
                _search_params(resolution, lookup, **kw))
    else:
        r = search_batch(
            dist_grid[None], origins, resolution, starts, goals,
            obstacle_pred=obstacle_pred,
            start_times=torch.full((1,), float(start_time), device=dev),
            lookup=lookup, **kw,
        )
    return KinoResult(*(x[0] for x in r))


def search_adaptive(dist_grid, origin, resolution, start_state, goal_state,
                    retries: int = 1, widen: float = 2.0,
                    deepen: float = 1.5, beam: int = 64,
                    max_iters: int = 30, **kw):
    """Beam search with adaptive widening on failure: retry with a
    ``widen`` x beam and ``deepen`` x iterations before falling back to a
    host search.  Returns (KinoResult, n_retries_used)."""
    res = search(dist_grid, origin, resolution, start_state, goal_state,
                 beam=beam, max_iters=max_iters, **kw)
    used = 0
    while not bool(res.reached) and used < retries:
        used += 1
        beam = int(round(beam * widen))
        max_iters = int(round(max_iters * deepen))
        res = search(dist_grid, origin, resolution, start_state, goal_state,
                     beam=beam, max_iters=max_iters, **kw)
    return res, used


def _retry_bucket(n: int, lo: int = 32) -> int:
    """Power-of-two size of a retry sub-batch (the JAX package pads to it
    to bound its compile count; here it keeps the rung's shape, and so its
    device work, the same as the JAX package's)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _take(pred, idx):
    return None if pred is None else type(pred)(*(x[idx] for x in pred))


def search_batch_adaptive(dists, origins, resolution: float, starts, goals,
                          obstacle_pred=None, start_times=None,
                          retries: int = 1, widen: float = 2.0,
                          deepen: float = 1.5, beam: int = 64,
                          max_iters: int = 30, device=None, **kw):
    """Batched beam search + batched retry ladder over unreached lanes:
    after the base batch, the lanes that did not reach the goal are
    searched again together with a ``widen`` x beam and ``deepen`` x
    iterations (padded to a power-of-two sub-batch), and their results
    scattered back.

    Devices as in :func:`search_batch`.  Returns (merged KinoResult,
    n_retried_lanes, retries_used).
    """
    out, n_retried, used, _ = search_batch_ladder(
        dists, origins, resolution, starts, goals,
        obstacle_pred=obstacle_pred, start_times=start_times,
        retries=retries, widen=widen, deepen=deepen, beam=beam,
        max_iters=max_iters, device=device, **kw)
    return out, n_retried, used


def search_batch_ladder(dists, origins, resolution: float, starts, goals,
                        obstacle_pred=None, start_times=None,
                        retries: int = 1, widen: float = 2.0,
                        deepen: float = 1.5, beam: int = 64,
                        max_iters: int = 30, device=None, **kw):
    """:func:`search_batch_adaptive`, and each lane's retry rounds: (merged
    KinoResult, n_retried_lanes, retries_used, rounds (B,) int numpy).  A
    lane's rounds are those a per-lane ``search_adaptive`` with the same
    arguments uses: the rounds it was still unreached at the start of.
    Counts (``utils.profiling``): ``search.lanes`` the B lanes,
    ``search.lanes_retried`` each rung's re-searched lanes (padding not
    counted), and its reads of ``reached`` under ``sync.kinodynamic.*``."""
    dists, dev = _device.field_device(dists, device)
    out = search_batch(dists, origins, resolution, starts, goals,
                       obstacle_pred=obstacle_pred, start_times=start_times,
                       beam=beam, max_iters=max_iters, **kw)
    starts = _device.on(starts, dev, "starts")
    B = starts.shape[0]
    goals = _device.on(goals, dev, "goals")
    origins = _device.on(origins, dev, "origins").expand(B, 3)
    pred_batched = obstacle_pred is not None and obstacle_pred.poly.dim() == 4
    shared = dists.shape[0] == 1 and B > 1
    used = 0
    n_retried = 0
    reached = profiling.to_host(out.reached, "kinodynamic.ladder").numpy()
    rounds = np.zeros(B, np.int64)
    profiling.add("search.lanes", B)
    while used < retries and not reached.all():
        used += 1
        beam = int(round(beam * widen))
        max_iters = int(round(max_iters * deepen))
        idx = np.where(~reached)[0]
        rounds[idx] += 1
        n_retried = max(n_retried, len(idx))
        profiling.add("search.lanes_retried", len(idx))
        nb = min(_retry_bucket(len(idx)), B)
        pidx = profiling.to_device(
            np.concatenate([idx, np.repeat(idx[-1:], nb - len(idx))]),
            "kinodynamic.ladder_index", dev)
        sub = search_batch(
            dists if shared else dists[pidx], origins[pidx], resolution,
            starts[pidx], goals[pidx],
            obstacle_pred=(_take(obstacle_pred, pidx) if pred_batched
                           else obstacle_pred),
            start_times=(None if start_times is None else _device.on(
                start_times, dev, "start_times")[pidx]),
            beam=beam, max_iters=max_iters, **kw,
        )
        ok = profiling.to_host(sub.reached[:len(idx)],
                               "kinodynamic.ladder_rung").numpy()
        sel = profiling.to_device(idx[ok], "kinodynamic.ladder_index", dev)
        if len(sel):
            okd = profiling.to_device(ok, "kinodynamic.ladder_index", dev)
            sub_sel = KinoResult(*(
                profiling.masked(x[:len(idx)], okd, "kinodynamic.ladder")
                for x in sub))
            # a deeper rung returns more knots; front-pad the shallower
            # side with zero-duration copies of its first knot
            out, sub_sel = _align_knot_counts(out, sub_sel)
            merged = []
            for o, s in zip(out, sub_sel):
                o = o.clone()
                o[sel] = s
                merged.append(o)
            out = KinoResult(*merged)
        reached = profiling.to_host(out.reached,
                                    "kinodynamic.ladder").numpy()
    return out, n_retried, used, rounds


def _align_knot_counts(a: KinoResult, b: KinoResult):
    """Front-pad the KinoResult with fewer knots (zero-duration copies of
    its first knot) so both have equal knot-axis shapes."""

    def pad(r: KinoResult, k_to: int) -> KinoResult:
        m = k_to - r.pos.shape[1]
        if m <= 0:
            return r

        def dup(x):
            return torch.cat([x[:, :1].expand(-1, m, -1), x], dim=1)

        return r._replace(
            pos=dup(r.pos), vel=dup(r.vel), acc=dup(r.acc),
            times=torch.cat([torch.zeros_like(r.times[:, :1]).expand(-1, m),
                             r.times], dim=1),
        )

    k = max(a.pos.shape[1], b.pos.shape[1])
    return pad(a, k), pad(b, k)


def _linspace(start, stop, n: int):
    """jnp.linspace's arithmetic: start (1 - s) + stop s with s = i / (n-1)
    in float32 and the last point exactly ``stop``; start/stop (B,) ->
    (B, n)."""
    div = n - 1
    s = (torch.arange(div, dtype=start.dtype, device=start.device)
         / float(div))
    out = start[:, None] * (1 - s) + stop[:, None] * s
    return torch.cat([out, stop[:, None]], dim=1)


def resample_knots_batch(pos, vel, acc, times, n: int):
    """``n`` time-resampled knot states per lane, so every lane of a search
    batch feeds one fixed-shape back-end solve.

    Every branch segment's position path is exactly a cubic matched to its
    end positions and velocities (constant-acceleration primitives are
    quadratics; the one-shot is computeShotTraj's cubic,
    kinodynamic_astar.cpp:393-404), so cubic Hermite interpolation between
    bracketing knots reconstructs the branch exactly.  Long branches
    (>= n real knots) snap to whole search knots; short ones use uniform
    time.  The beam's zero-duration prefix copies collapse onto time 0.

    pos/vel/acc (B, K+1, 3), times (B, K) -> (pos, vel, acc, times) with
    n knots and n-1 segments per lane (acc is the Hermite second
    derivative at each knot).
    """
    p = pos
    v = vel
    t = times
    B, K = t.shape
    # cumulative times, summed in order (a device scan would reassociate)
    cts = [torch.zeros_like(t[:, 0])]
    for i in range(K):
        cts.append(cts[-1] + t[:, i])
    ct = torch.stack(cts, dim=1)  # (B, K+1)
    r = torch.sum(t > 1e-9, dim=1)  # real segments
    n_dup = K - r
    ones = torch.ones_like(ct[:, 0])
    fi = torch.round(_linspace(0 * ones, ones, n) * r.to(ct.dtype)[:, None])
    kidx = torch.clamp(n_dup[:, None] + fi.long(), 0, K)
    t_knots = torch.gather(ct, 1, kidx)
    total = ct[:, -1]
    t_unif = _linspace(0 * total, total, n)
    targets = torch.where((r >= n - 1)[:, None], t_knots, t_unif)
    # bracketing segment: the one whose start knot is the LAST knot with
    # ct <= target (ties pick the highest knot, skipping zero-length
    # segments); the clip keeps t = total in segment K-1
    j = torch.clamp(
        torch.sum(ct[:, None, :] <= targets[:, :, None] + 1e-9, dim=2) - 1,
        0, K - 1)
    Tj = torch.clamp(torch.gather(t, 1, j), min=1e-9)
    s = torch.clamp((targets - torch.gather(ct, 1, j)) / Tj, 0.0, 1.0)
    s = s[..., None]
    Tj = Tj[..., None]
    j3 = j[..., None].expand(-1, -1, 3)
    p0 = torch.gather(p, 1, j3)
    p1 = torch.gather(p, 1, j3 + 1)
    v0 = torch.gather(v, 1, j3) * Tj
    v1 = torch.gather(v, 1, j3 + 1) * Tj
    s2 = s * s
    s3 = s * s2
    # cubic Hermite on [0, 1]
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    pk = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
    d00 = 6 * s2 - 6 * s
    d10 = 3 * s2 - 4 * s + 1
    d01 = -d00
    d11 = 3 * s2 - 2 * s
    vk = (d00 * p0 + d10 * v0 + d01 * p1 + d11 * v1) / Tj
    g00 = 12 * s - 6
    g10 = 6 * s - 4
    g01 = -g00
    g11 = 6 * s - 2
    ak = (g00 * p0 + g10 * v0 + g01 * p1 + g11 * v1) / (Tj * Tj)
    seg = torch.clamp(targets[:, 1:] - targets[:, :-1], min=1e-2)
    return pk, vk, ak, seg


def retime_knots(pos, vel, times, mode: str = "mean_v",
                 mean_v: float = 1.8, stretch: float = 1.0,
                 w_time: float = 10.0, max_vel: float = 3.0,
                 min_time: float = 1e-2):
    """Re-allocate segment durations over search knots before seeding
    (host side, numpy in and out; knot and segment counts unchanged):

    * ``"search"`` keeps the search durations (setKinoPath,
      grad_traj_optimizer.cpp:35-65);
    * ``"mean_v"`` is the reference's waypoint rule T_s = len_s / mean_v
      (setPath, grad_traj_optimizer.cpp:67-81, without init_time);
    * ``"stretch"`` scales the search durations by ``stretch``;
    * ``"pontryagin"`` takes each segment's optimal connection time of
      the search's own cost (kinodynamic_astar.cpp:348-384).
    """
    pos = np.asarray(pos, np.float64)
    times = np.asarray(times, np.float64)
    if mode == "search":
        return times
    if mode == "stretch":
        return np.maximum(times * stretch, min_time)
    if mode == "mean_v":
        seg = np.linalg.norm(np.diff(pos, axis=0), axis=1)
        return np.maximum(seg / mean_v, min_time)
    if mode == "pontryagin":
        vel = np.asarray(vel, np.float64)
        x = torch.as_tensor(np.concatenate([pos, vel], axis=1),
                            dtype=torch.float32)
        _, t_opt = estimate_heuristic(x[:-1], x[1:], w_time, max_vel)
        return np.maximum(t_opt.numpy().astype(np.float64), min_time)
    raise ValueError(f"unknown retime mode {mode!r}")


# ---------------------------------------------------------------------------
# Free-end-velocity one-shot (HybridAStarPathFinder variant)
# ---------------------------------------------------------------------------


def free_end_vel_shot(p0, p1, v0, max_vel: float = 3.0):
    """Minimum-acceleration cubic to a position goal with free end
    velocity (HybridAStarPathFinder::getOptimalTime / getShotTrajectory,
    hybrid_astar.cpp:902-967): the duration minimizes
    3 ||v0 T - dp||^2 / T^3 over the positive roots of its derivative
    quadratic, then is stretched per axis so the implied end velocity
    stays within (2.5/3) max_vel.

    p0, p1, v0 (..., 3) -> (coef (..., 3, 4) ascending powers, T (...,),
    v1 (..., 3)).
    """
    p0 = torch.as_tensor(p0)
    dp = torch.as_tensor(p1, dtype=p0.dtype, device=p0.device) - p0
    v0 = torch.as_tensor(v0, dtype=p0.dtype, device=p0.device)

    a = 3.0 * _sum3(v0, v0)
    b = -12.0 * _sum3(dp, v0)
    c = 9.0 * _sum3(dp, dp)

    # quadratic roots (a can be 0 when starting at rest: the linear root)
    disc = b * b - 4 * a * c
    sq = _sqrt(torch.clamp(disc, min=0.0))
    a_ok = torch.abs(a) > 1e-12
    b_ok = torch.abs(b) > 1e-12
    safe_a = torch.where(a_ok, a, 1.0)
    r1 = (-b + sq) / (2 * safe_a)
    r2 = (-b - sq) / (2 * safe_a)
    r_lin = torch.where(b_ok, -c / torch.where(b_ok, b, 1.0), _INF)
    quad_ok = a_ok & (disc >= 0)
    roots = torch.stack(
        [torch.where(quad_ok, r1, _INF), torch.where(quad_ok, r2, _INF),
         torch.where(a_ok, _INF, r_lin)], dim=-1)
    roots = torch.where(roots > 0, roots, _INF)

    def acc_cost_at(T):
        r = v0 * T[..., None] - dp
        m = torch.clamp(T, min=1e-9)
        return 3.0 * _sum3(r, r) / (m * (m * m))

    costs = torch.stack(
        [torch.where(torch.isfinite(roots[..., i]),
                     acc_cost_at(roots[..., i]), _INF) for i in range(3)],
        dim=-1)
    k = torch.argmin(costs, dim=-1)
    T = torch.gather(roots, -1, k[..., None])[..., 0]
    # fallback duration when no positive root exists (dp = 0)
    T = torch.where(torch.isfinite(T), T, 1.0)

    # per-axis end-velocity stretch (hybrid_astar.cpp:942-948); the
    # reference evaluates ve once, from the pre-stretch T (:942)
    ve = v0 + 3 * (dp - v0 * T[..., None]) / (2 * T[..., None])
    for i in range(3):
        Tp = 3 * dp[..., i] / (2 * (max_vel + 0.5 * v0[..., i]))
        T = torch.where((ve[..., i] > (2.5 / 3) * max_vel) & (Tp > T), Tp, T)

    Te = T[..., None]
    v1 = v0 + 3 * (dp - v0 * Te) / (2 * Te)
    ca = -(dp - v0 * Te) / (2 * (Te * (Te * Te)))
    cb = 3 * (dp - v0 * Te) / (2 * (Te * Te))
    coef = torch.stack([p0.expand_as(ca), v0.expand_as(ca), cb, ca], dim=-1)
    return coef, T, v1
