"""Penalty objective: smoothness + collision line integral (port of
``grad_traj_optimization_tpu.opt.penalty``).

Rebuild of ``GradTrajOptimizer::getCostAndGradient``
(grad_traj_optimizer.cpp:281-448):

* smoothness ``f_s = sum_axis d^T R d`` with gradient
  ``2 Rfp^T df + 2 Rpp dp`` (:326-336);
* collision ``f_c = sum_s sum_k c(d(p(t_k))) ||v(t_k)|| dt_s`` with
  ``c(d) = alpha exp(-(d - d0)/r)``, sampled at ``t = 1e-3 + k T_s/30``
  (:345-409, :351-353).

``gradient_mode="reference"`` keeps the C++ quirks: the distance term's
extra ``c(d)`` factor (:376-381), +1e-5 on every gradient entry
(:428-432) and +1e-3 on the cost (:417-418).  The velocity/acceleration
penalties (:382-407, :517-535, commented out in the reference) are gated
by ``alpha_v``/``alpha_a``, step 2 only, with the reference mode's two
quirks (no sign factor; the last axis's stale cv/ca).  Both gradients are
closed form, not autodiff.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.core import poly, qp
from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.ops import trilinear_cuda
from grad_traj_optimization_torch.utils import profiling


class Field(NamedTuple):
    """Flat distance-field handle: ``flat`` may hold many grids back to
    back, ``base`` selects this scenario's."""

    flat: torch.Tensor     # (total_voxels,)
    base: int | torch.Tensor
    origin: torch.Tensor   # (3,)
    resolution: torch.Tensor  # ()


def make_field(dist_grid, origin, resolution):
    """Field handle + grid shape from one (nx, ny, nz) grid."""
    return (
        Field(flat=dist_grid.reshape(-1), base=0,
              origin=torch.as_tensor(origin, device=dist_grid.device),
              resolution=torch.as_tensor(resolution,
                                         device=dist_grid.device)),
        tuple(dist_grid.shape),
    )


@dataclasses.dataclass
class PenaltyCtx:
    """Per-scenario precomputation shared by every iteration (leaves may
    carry a leading batch axis)."""

    T: torch.Tensor      # (m,) segment times
    dep: qp.QPDep
    Df: torch.Tensor     # (3, 6) fixed derivatives
    Tmat: torch.Tensor   # (m, K, 6) position basis at sample times
    TVmat: torch.Tensor  # (m, K, 6) velocity basis
    # the dense chains T(t) @ Ldp and T'(t) @ Ldp, (m, K, num_dp): read by
    # K3's inputs (solver.kernel_inputs) only; the gradient goes through
    # the Hermite bases below (_back_project)
    TL: torch.Tensor | None
    TVL: torch.Tensor | None
    dt: torch.Tensor     # (m,) integration step per segment
    TAmat: torch.Tensor | None = None  # acceleration basis (alpha_a only)
    TAL: torch.Tensor | None = None
    # T(t) @ Ainv(T), (m, K, 6): each sample's Hermite basis over its
    # segment's 6 endpoint derivatives (D6), for position, velocity and
    # (alpha_a only) acceleration; built on first use by _sample_state,
    # since K3's inputs (solver.kernel_inputs) never read them
    H: torch.Tensor | None = None
    HV: torch.Tensor | None = None
    HA: torch.Tensor | None = None


def build_ctx(T, Df, cfg: OptimizerConfig, dep: qp.QPDep | None = None):
    """Sample bases, and the dense chains K3's inputs read; T (..., m),
    Df (..., 3, 6)."""
    if dep is None:
        dep = qp.build_dep(T)
    K = cfg.n_samples
    k = torch.arange(K, dtype=T.dtype, device=T.device)
    ts = cfg.t_offset + k * (T[..., None] / K)  # (..., m, K)
    Tmat = poly.time_powers(ts)
    TVmat = poly.vel_powers(ts)
    TL = torch.einsum("...mkj,...mjd->...mkd", Tmat, dep.Ldp)
    TVL = torch.einsum("...mkj,...mjd->...mkd", TVmat, dep.Ldp)
    TAmat = TAL = None
    if cfg.alpha_a != 0.0:
        TAmat = poly.acc_powers(ts)
        TAL = torch.einsum("...mkj,...mjd->...mkd", TAmat, dep.Ldp)
    return PenaltyCtx(T=T, dep=dep, Df=Df, Tmat=Tmat, TVmat=TVmat, TL=TL,
                      TVL=TVL, dt=T / K, TAmat=TAmat, TAL=TAL)


def build_ctx_batch(T_b, Df_b, cfg: OptimizerConfig) -> PenaltyCtx:
    """PenaltyCtx with a leading batch axis on every leaf."""
    return build_ctx(T_b, Df_b, cfg)


def _va_weights(vel, acc, vn, cfg: OptimizerConfig):
    """Velocity/acceleration penalty integrands and chain weights.

    vel/acc (..., 3), vn (...,) = ||v|| + vel_eps.  Returns
    (cost_v, cost_a, w_tvl, w_tal): per-sample costs (...,) and (..., 3)
    weights for the TVL / TAL chains, all before dt.
    """
    ref = cfg.gradient_mode == "reference"
    zero = torch.zeros_like(vel[..., 0])
    zero3 = torch.zeros_like(vel)
    cost_v = cost_a = zero
    w_tvl = w_tal = zero3
    if cfg.alpha_v != 0.0:
        cv = cfg.alpha_v * torch.exp((torch.abs(vel) - cfg.v0) / cfg.r_v)
        gv = cv / cfg.r_v  # reference: no sign(v) factor (:521-526)
        cost_v = torch.sum(cv, dim=-1) * vn
        if ref:
            cfac = cv[..., 2:3]  # stale cv of the last axis (:382-407)
        else:
            gv = gv * torch.sign(vel)
            cfac = torch.sum(cv, dim=-1, keepdim=True)
        w_tvl = w_tvl + gv * vn[..., None] + cfac * vel / vn[..., None]
    if cfg.alpha_a != 0.0:
        ca = cfg.alpha_a * torch.exp((torch.abs(acc) - cfg.a0) / cfg.r_a)
        ga = ca / cfg.r_a
        cost_a = torch.sum(ca, dim=-1) * vn
        if ref:
            cafac = ca[..., 2:3]
        else:
            ga = ga * torch.sign(acc)
            cafac = torch.sum(ca, dim=-1, keepdim=True)
        w_tal = ga * vn[..., None]
        w_tvl = w_tvl + cafac * vel / vn[..., None]
    return cost_v, cost_a, w_tvl, w_tal


def _sample_state(dp, ctx: PenaltyCtx):
    """The segments' endpoint derivatives D6 (3, m, 6), and pos (m, K, 3)
    and vel (m, K, 3) at every sample.

    The samples are the Hermite bases applied to D6, not the monomials
    applied to the coefficients (the JAX package's ``coeff_from_d`` then
    ``Tmat``): the same values, without the cancellation between large
    coefficients of opposite sign on long segments, so float32 positions
    carry about half the rounding error (the chains of K3 have this form
    too)."""
    if ctx.H is None:
        ainv = poly.segment_ainv(ctx.T)  # (..., m, 6, 6)

        def hermite(basis):
            return torch.einsum("...mkj,...mjb->...mkb", basis, ainv)

        ctx.H, ctx.HV = hermite(ctx.Tmat), hermite(ctx.TVmat)
        if ctx.TAmat is not None:
            ctx.HA = hermite(ctx.TAmat)
    m = ctx.T.shape[-1]
    d6 = qp.stacked_derivatives(ctx.Df, dp, m)
    d6 = d6.reshape(*d6.shape[:-1], m, 6)
    pos = torch.einsum("...mkb,...xmb->...mkx", ctx.H, d6)
    vel = torch.einsum("...mkb,...xmb->...mkx", ctx.HV, d6)
    return d6, pos, vel


def _smooth(dp, ctx: PenaltyCtx):
    d = torch.cat([ctx.Df, dp], dim=-1)  # (..., 3, 3m+3)
    cost = torch.einsum("...xa,...ab,...xb->...", d, ctx.dep.R, d)
    grad = 2.0 * torch.einsum("...xf,...fd->...xd", ctx.Df, ctx.dep.Rfp) \
        + 2.0 * torch.einsum("...xp,...pd->...xd", dp, ctx.dep.Rpp)
    return cost, grad


def _collision_terms(d, vel, cfg: OptimizerConfig):
    cd = cfg.alpha * torch.exp(-(d - cfg.d0) / cfg.r)
    gd = -cd / cfg.r
    vn = torch.linalg.norm(vel, dim=-1) + cfg.vel_eps
    return cd, gd, vn


def _assemble(ws, cost_s, grad_s, d, g, d6, vel, ctx: PenaltyCtx,
              cfg: OptimizerConfig, step: int, with_grad: bool):
    """Collision (+ v/a) terms on top of the smoothness terms; every ctx
    leaf and sample tensor carries the same leading axes."""
    wc = cfg.w_collision
    cd, gd, vn = _collision_terms(d, vel, cfg)
    cost_c = torch.einsum("...mk,...m->...", cd * vn, ctx.dt)
    cost = ws * cost_s + wc * cost_c + cfg.cost_eps
    va = step == 2 and (cfg.alpha_v != 0.0 or cfg.alpha_a != 0.0)
    if va:
        acc = (torch.einsum("...mkb,...xmb->...mkx", ctx.HA, d6)
               if cfg.alpha_a != 0.0 else None)
        cost_v, cost_a, w_tvl, w_tal = _va_weights(vel, acc, vn, cfg)
        cost = cost + torch.einsum("...mk,...m->...", cost_v + cost_a,
                                   ctx.dt)
    if not with_grad:
        return cost, None
    w_dist = gd * cd * vn if cfg.gradient_mode == "reference" else gd * vn
    w1 = (wc * w_dist)[..., None] * g
    w2 = (wc * cd / vn)[..., None] * vel
    if va:
        w2 = w2 + w_tvl
    chains = [(w1, ctx.H), (w2, ctx.HV)]
    if va and cfg.alpha_a != 0.0:
        chains.append((w_tal, ctx.HA))
    grad = ws * grad_s + _back_project(chains, ctx.dt)
    if cfg.gradient_mode == "reference":
        grad = grad + cfg.grad_eps
    return cost, grad


def _back_project(chains, dt):
    """The gradient over dp (..., 3, 3m-3) of the per-sample weights
    ``w`` (..., m, K, 3) against each sample's Hermite basis ``h``
    (..., m, K, 6), summed over the (w, h) pairs of ``chains``: the
    transpose of the map ``_sample_state`` applies to the segments'
    endpoint derivatives D6.

    A sample depends on its segment's 6 endpoint derivatives only, so
    each segment's gradient over them is one product over its K samples,
    batched over every segment (``bmm``, then ``baddbmm`` for each further
    chain), with nothing permuted; the dense chains ``TL``/``TVL``/``TAL``
    are that basis scattered into 3m-3 mostly-zero columns.  Then the
    adjoint of ``qp.stacked_derivatives``: by ``qp.opt_dmap``, interior
    waypoint w's (p, v, a) sit at the end (e = 1) of segment w-1 and the
    start (e = 0) of segment w, so its gradient is those two slices' sum.
    """
    *lead, m, K, _ = chains[0][0].shape

    def split(w, h):
        return w.reshape(-1, K, 3).transpose(1, 2), h.reshape(-1, K, 6)

    g6 = torch.bmm(*split(*chains[0]))  # (segments, 3, 6)
    for w, h in chains[1:]:
        g6 = torch.baddbmm(g6, *split(w, h))
    # (..., m, axis, order, end), slot 2 * order + end as qp.opt_dmap
    g6 = g6.reshape(*lead, m, 3, 3, 2) * dt[..., None, None, None]
    gp = g6[..., :-1, :, :, 1] + g6[..., 1:, :, :, 0]  # (..., m-1, 3, 3)
    return gp.transpose(-3, -2).reshape(*lead, 3, 3 * m - 3)


def _smooth_only(ws, cost_s, grad_s, cfg: OptimizerConfig):
    """The reference skips the sampling loop when |wc| < 1e-4 (:346)."""
    grad = ws * grad_s
    if cfg.gradient_mode == "reference":
        grad = grad + cfg.grad_eps
    return ws * cost_s + cfg.cost_eps, grad


def cost_and_grad(dp, ctx: PenaltyCtx, field: Field, grid_shape,
                  cfg: OptimizerConfig, step: int):
    """Total cost and gradient w.r.t. dp (3, num_dp) of one scenario.
    Step 1 zeroes the smoothness weight (:413-415); step 2 is the full
    cost."""
    ws = 0.0 if step == 1 else cfg.w_smooth
    cost_s, grad_s = _smooth(dp, ctx)
    if abs(cfg.w_collision) < 1e-4:
        return _smooth_only(ws, cost_s, grad_s, cfg)
    d6, pos, vel = _sample_state(dp, ctx)
    d, g = sdf.trilinear_flat(field.flat, field.base, grid_shape,
                              field.origin, field.resolution, pos)
    return _assemble(ws, cost_s, grad_s, d, g, d6, vel, ctx, cfg, step,
                     with_grad=True)


def cost_only(dp, ctx: PenaltyCtx, field: Field, grid_shape,
              cfg: OptimizerConfig, step: int):
    """Cost without the gradient chain."""
    ws = 0.0 if step == 1 else cfg.w_smooth
    cost_s, grad_s = _smooth(dp, ctx)
    if abs(cfg.w_collision) < 1e-4:
        return _smooth_only(ws, cost_s, grad_s, cfg)[0]
    d6, pos, vel = _sample_state(dp, ctx)
    d, g = sdf.trilinear_flat(field.flat, field.base, grid_shape,
                              field.origin, field.resolution, pos)
    return _assemble(ws, cost_s, grad_s, d, g, d6, vel, ctx, cfg, step,
                     with_grad=False)[0]


def bounds(waypoints, num_dp: int, cfg: OptimizerConfig, bos=None):
    """Box bounds on dp, axis-major (..., 3, num_dp).

    Reference grad_traj_optimizer.cpp:154-177: position slots within
    +-bos of the initial interior waypoint, velocity slots +-vos,
    acceleration slots +-aos.  ``bos`` optionally gives per-interior-
    waypoint half-widths (..., n_int) instead of the scalar ``cfg.bos``.
    """
    wp = waypoints
    n_int = num_dp // 3
    interior = wp[..., 1:1 + n_int, :]  # (..., n_int, 3)
    zi = torch.zeros_like(interior)
    center = torch.stack([interior, zi, zi], dim=-1)  # (..., n, axis, slot)
    center = center.transpose(-3, -2).reshape(*wp.shape[:-2], 3, num_dp)
    bos_arr = profiling.to_device(cfg.bos if bos is None else bos,
                                  "penalty.bos", wp.device, wp.dtype)
    bos_arr = bos_arr.expand(*wp.shape[:-2], n_int)
    half = torch.stack(
        [bos_arr, torch.full_like(bos_arr, cfg.vos),
         torch.full_like(bos_arr, cfg.aos)], dim=-1,
    ).reshape(*wp.shape[:-2], num_dp)
    return center - half[..., None, :], center + half[..., None, :]


def cost_and_grad_batch(dp, bctx: PenaltyCtx, grids, origin, resolution,
                        cfg: OptimizerConfig, step: int):
    """Batch-first cost (B,) and gradient (B, 3, num_dp); grids is
    (B, nx, ny, nz) or (1, ...) for one shared map.  The grids are whole
    maps: the lookup (K2, as the TPU's) has no crop frame, so a cropped
    Scenario (``solver.crop_scenarios``) goes to ``solve_batch``."""
    ws = 0.0 if step == 1 else cfg.w_smooth
    cost_s, grad_s = _smooth(dp, bctx)
    if abs(cfg.w_collision) < 1e-4:
        return _smooth_only(ws, cost_s, grad_s, cfg)
    d6, pos, vel = _sample_state(dp, bctx)
    B, m, K = pos.shape[:3]
    # kernel K2 for CUDA tensors, sdf.trilinear_flat for CPU tensors
    d, g = trilinear_cuda.trilinear_batch(
        grids, origin, resolution, pos.reshape(B, m * K, 3).contiguous()
    )
    return _assemble(ws, cost_s, grad_s, d.reshape(B, m, K),
                     g.reshape(B, m, K, 3), d6, vel, bctx, cfg, step,
                     with_grad=True)
