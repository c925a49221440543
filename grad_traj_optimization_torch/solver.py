"""End-to-end trajectory solve: Scenario batch -> Solution batch (port of
``grad_traj_optimization_tpu.solver``).

The reference pipeline (src/opti_node.cpp:47-147) becomes
``make_scenario`` (rasterize + EDT) and ``solve`` / ``solve_batch``.
``solve``, ``solve_batch`` and ``solve_kino_batch[_race]`` pick one of two
descents by one rule that reads only the config and the shapes, never
the device (the JAX package's ladder, ``solver.py:589-617``, with "on the
TPU" read as "on either device"):

* ``lookup_mode == "auto"`` and ``solve_cuda.supports`` -> the whole
  descent in one K3 launch (:func:`solve_batch_kernel`; the plain K3
  loop on CPU tensors);
* anything else -> the per-iteration descent (:func:`solve_batch_fused`):
  ``descent.minimize_batch`` over ``penalty.cost_and_grad_batch``, one K2
  launch an evaluation on CUDA tensors, ``trilinear_batch_plain`` on CPU
  tensors.  It takes what K3 does not: ``step_rule="adaptive"``,
  ``accept_window > 128``, 45 or more waypoints, any grid.

Either one launches its kernel or raises; nothing is caught and nothing
falls back.  The dual seed race (``seed_mode="dual"``) runs each arm by
the rule, then the post-race polish; ``solve_kino_batch`` seeds from
search knot states (the reference's setKinoPath) and
``solve_kino_batch_race`` races seed durations.

Exact cropping (``crop_scenarios``) cuts each grid to a window around
its waypoints and records the window's frame on the Scenario; K3 and its
plain version do their lookups in that frame.  A cropped batch goes to
K3 only: where the rule does not pick K3 it raises ValueError, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from grad_traj_optimization_torch import _device
from grad_traj_optimization_torch.config import MapConfig, OptimizerConfig
from grad_traj_optimization_torch.core import poly, qp
from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.ops import solve_cuda, trilinear_cuda
from grad_traj_optimization_torch.opt import descent, penalty
from grad_traj_optimization_torch.utils import profiling

STATUS_OK = 0
STATUS_DIVERGED = 1  # NaN/Inf appeared (per-scenario failure detection)


class Scenario(NamedTuple):
    """One trajectory-planning problem, or a batch with a leading axis.

    dist: (nx, ny, nz) distance field in meters (batched: (B, ...), or
      (1, ...) for one map shared by the batch); origin: (3,);
    resolution: (); waypoints: (m+1, 3).  All float32 on one device.
    grid_offset/grid_full: set by :func:`crop_scenarios`: ``dist`` is
      the [offset, offset + shape) cell window of a ``grid_full``-cell
      map whose origin is still ``origin`` (the exact-crop frame), so an
      in-window lookup is bitwise the full map's.  None for a full grid.
    """

    dist: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor
    waypoints: torch.Tensor
    grid_offset: torch.Tensor | None = None  # (3,) / (B, 3) int32 offset
    grid_full: torch.Tensor | None = None    # (3,) / (B, 3) int32 extents

    def map(self, fn) -> "Scenario":
        """``fn`` applied to every tensor field; a None field stays None
        (as ``jax.tree.map`` skips it in the JAX package)."""
        return Scenario(*(None if x is None else fn(x) for x in self))


def require_uncropped(scenarios: Scenario, what: str) -> None:
    """Raise ValueError if ``scenarios`` were cropped: ``what`` reads the
    grid as a whole map and has no crop frame."""
    if scenarios.grid_offset is not None:
        raise ValueError(f"{what} takes uncropped scenarios (it has no "
                         "crop frame); pass the full-grid batch")


class Solution(NamedTuple):
    coeff: torch.Tensor       # (m, 3, 6) ascending-power coefficients
    T: torch.Tensor           # (m,) segment times
    cost: torch.Tensor        # () final cost
    cost_trace: torch.Tensor  # (total iters,) monotone cost envelope
    n_accept: torch.Tensor    # () accepted descent iterations
    dp: torch.Tensor          # (3, 3m-3) optimized free derivatives
    status: torch.Tensor      # () STATUS_*


def make_scenario(waypoints, obstacle_points, map_cfg: MapConfig,
                  valid_mask=None, dist=None, device="cuda") -> Scenario:
    """Build a Scenario on ``device`` (the card unless the caller asks
    for the CPU), rasterizing and EDT-transforming the
    obstacles unless a prebuilt ``dist`` is given (reference
    initSDFMap + updateSDFMap, grad_traj_optimizer.cpp:112-126)."""
    f32 = dict(dtype=torch.float32, device=device)
    origin = torch.as_tensor(map_cfg.origin, **f32)
    if dist is None:
        occ = sdf.rasterize(
            torch.as_tensor(obstacle_points, **f32), origin,
            map_cfg.resolution, map_cfg.grid_shape,
            valid_mask=None if valid_mask is None
            else torch.as_tensor(valid_mask, device=device),
        )
        dist = sdf.edt(occ, map_cfg.resolution)
    return Scenario(
        dist=torch.as_tensor(dist, **f32),
        origin=origin,
        resolution=torch.as_tensor(map_cfg.resolution, **f32),
        waypoints=torch.as_tensor(waypoints, **f32),
    )


def _dual_arm_cfgs(cfg: OptimizerConfig):
    """The two arm configs of seed_mode='dual' (see OptimizerConfig)."""
    cfg_a = dataclasses.replace(cfg, seed_mode="reference", polish_iters=0)
    cfg_b = dataclasses.replace(
        cfg,
        seed_mode="min_snap",
        iters_step2=cfg.dual_ms_iters or cfg.iters_step2,
        accept_window=cfg.dual_ms_window or cfg.accept_window,
        polish_iters=0,
    )
    return cfg_a, cfg_b


def _race(solve_fn, scenarios, cfg: OptimizerConfig, **kw) -> Solution:
    """seed_mode='dual': ``solve_fn(scenarios, arm_cfg, **kw)`` on each of
    the two arms, and per lane the winner (:func:`_combine_dual`)."""
    cfg_a, cfg_b = _dual_arm_cfgs(cfg)
    return _combine_dual(solve_fn(scenarios, cfg_a, **kw),
                         solve_fn(scenarios, cfg_b, **kw))


def _polish_cfg(cfg: OptimizerConfig) -> OptimizerConfig:
    """Config of the post-race polish restart (step 2 only)."""
    return dataclasses.replace(cfg, seed_mode="reference", polish_iters=0,
                               iters_step2=cfg.polish_iters)


def _lane_select(take, a, b):
    """Per lane: b's leaf where ``take`` (B,) holds, else a's (two
    NamedTuples of one type with a leading lane axis on every leaf)."""
    def sel(x, y):
        return torch.where(take.reshape((-1,) + (1,) * (x.dim() - 1)), y, x)

    return type(a)(*(sel(x, y) for x, y in zip(a, b)))


def _combine_dual(sa: Solution, sb: Solution) -> Solution:
    """Per-lane best of two Solution arms (non-finite cost loses).  The
    shorter cost trace is edge-padded, so the winner's monotone envelope
    is kept."""
    inf = torch.tensor(float("inf"), dtype=sa.cost.dtype,
                       device=sa.cost.device)
    ca = torch.where(torch.isfinite(sa.cost), sa.cost, inf)
    cb = torch.where(torch.isfinite(sb.cost), sb.cost, inf)
    L = max(sa.cost_trace.shape[-1], sb.cost_trace.shape[-1])

    def pad_edge(t):
        if t.shape[-1] == L:
            return t
        return torch.cat([t, t[..., -1:].expand(*t.shape[:-1],
                                                L - t.shape[-1])], dim=-1)

    sa = sa._replace(cost_trace=pad_edge(sa.cost_trace))
    sb = sb._replace(cost_trace=pad_edge(sb.cost_trace), T=sa.T)
    return _lane_select(cb < ca, sa, sb)


def _merge_polish(win: Solution, sp: Solution) -> Solution:
    """Fold a post-race polish run into the race winner: per lane the lower
    cost wins; the traces concatenate, the polish part clamped by the
    winner's final envelope value, so the envelope spans the schedule."""
    tw, tp = win.cost_trace, sp.cost_trace
    if tw.shape[-1] and tp.shape[-1]:
        trace = torch.cat([tw, torch.minimum(tp, tw[..., -1:])], dim=-1)
    else:
        trace = tw
    sp = sp._replace(T=win.T, cost_trace=win.cost_trace)
    out = _lane_select(sp.cost < win.cost, win, sp)
    return out._replace(cost=torch.minimum(win.cost, sp.cost),
                        cost_trace=trace,
                        n_accept=win.n_accept + sp.n_accept)


@profiling.traced("solver.kernel_inputs")
def kernel_inputs(scenarios: Scenario, cfg: OptimizerConfig, bos_wp=None,
                  dp0=None, T=None, Df=None):
    """The whole-descent kernel's inputs from a Scenario batch.

    Returns (kargs, (Df, dp0, T)): ``kargs`` is the positional tuple
    ``solve_cuda.descend`` takes before ``phases`` — in the JAX package's
    ``kernel_inputs`` layouts, with the f32 grids in place of its bf16
    grid planes, and last the compact chains K3 reads
    (``solve_cuda.Chains``).  ``bos_wp`` (B, m+1) gives per-waypoint
    position-bound half-widths; ``dp0`` (B, 3, P) overrides the seed.
    ``T`` (B, m) and ``Df`` (B, 3, 6) override the waypoint-derived
    segment times and fixed derivatives (the setKinoPath seeding: pass
    ``dp0`` from ``qp.kino_d`` alongside); the waypoints then carry the
    knot positions, which still center the position bounds.
    """
    wp = scenarios.waypoints  # (B, m+1, 3)
    B = wp.shape[0]
    m = wp.shape[1] - 1
    if T is None:
        T = qp.allocate_times(wp, cfg.mean_v, cfg.init_time)
    Df_wp, dp0_straight = qp.straight_line_d(wp)  # (B, 3, 6), (B, 3, P)
    Df = Df_wp if Df is None else Df
    # bases, sample quadrature and TL/TVL chains come from build_ctx,
    # the single home of the reference's 30-sample/1e-3-offset quirk
    bctx = penalty.build_ctx_batch(T, Df, cfg)
    dep = bctx.dep
    P = dp0_straight.shape[2]
    ndim = 3 * m + 3
    K = cfg.n_samples
    S = m * K

    # apos = Tmat @ L over the full [Df | dp] stack; the dp part is TL
    Lf_seg = dep.L.reshape(B, m, 6, ndim)[..., :6]
    apos_f = torch.einsum("bmkj,bmja->bmka", bctx.Tmat, Lf_seg)
    avel_f = torch.einsum("bmkj,bmja->bmka", bctx.TVmat, Lf_seg)
    apos = torch.cat([apos_f, bctx.TL], dim=-1)  # (B, m, K, ndim)
    avel = torch.cat([avel_f, bctx.TVL], dim=-1)
    sp = max(8, -(-S // 8) * 8)
    pad = (0, 0, 0, sp - S)
    cols, cols_idx = _segment_columns_on(m, wp.device)

    def dense_and_compact(a):
        """(B, m, K, ndim) chain -> dense (B, SP, ndim) and its segment
        columns (B, SP, 6), rows past S zero."""
        c = torch.gather(a, 3, cols_idx.expand(B, m, K, 6))
        return (torch.nn.functional.pad(a.reshape(B, S, ndim), pad),
                torch.nn.functional.pad(c.reshape(B, S, 6), pad))

    apos, cpos = dense_and_compact(apos)
    avel, cvel = dense_and_compact(avel)
    # [TL^T | TVL^T] on the contraction axis (+ TAL^T for alpha_a)
    tltv_blocks = [apos[:, :, 6:].transpose(1, 2),
                   avel[:, :, 6:].transpose(1, 2)]
    aacc = cacc = None
    if cfg.alpha_a != 0.0:
        aacc_f = torch.einsum("bmkj,bmja->bmka", bctx.TAmat, Lf_seg)
        aacc, cacc = dense_and_compact(torch.cat([aacc_f, bctx.TAL], dim=-1))
        tltv_blocks.append(aacc[:, :, 6:].transpose(1, 2))
    tltv = torch.cat(tltv_blocks, dim=2).contiguous()
    dts = bctx.dt[:, :, None].expand(B, m, K).reshape(B, S, 1)
    dts = torch.nn.functional.pad(dts, pad)  # zero dt masks padded rows

    cgt = 2.0 * torch.einsum("bxf,bfp->bpx", Df, dep.Rfp)
    c_ff = torch.einsum("bxf,bfg,bxg->b", Df, dep.R[:, :6, :6], Df)
    lb, ub = penalty.bounds(
        wp, P, cfg, bos=None if bos_wp is None else bos_wp[:, 1:m]
    )
    if dp0 is None:
        if cfg.seed_mode == "min_snap":
            dp0 = torch.clamp(qp.min_snap_dp(Df, dep.Rpp, dep.Rfp), lb, ub)
        else:
            dp0 = dp0_straight

    grids = scenarios.dist
    misc = torch.zeros((B, 1, 16), dtype=wp.dtype, device=wp.device)
    misc[:, 0, 0:3] = scenarios.origin
    misc[:, 0, 3] = scenarios.resolution
    misc[:, 0, 4] = c_ff
    # the exact-crop frame: cell offset and full-map extents (defaults:
    # offset 0, full = this grid, the uncropped arithmetic bitwise)
    if scenarios.grid_offset is not None:
        misc[:, 0, 5:8] = scenarios.grid_offset.to(wp.dtype)
        misc[:, 0, 8:11] = scenarios.grid_full.to(wp.dtype)
    else:
        misc[:, 0, 8:11] = profiling.to_device(
            grids.shape[1:], "solver.grid_full", wp.device, wp.dtype)

    def c(t):
        return t.contiguous()

    kargs = (
        c(grids), tuple(grids.shape[1:]), c(apos), c(avel), tltv,
        c(dep.Rpp), c(cgt), c(lb.transpose(1, 2)), c(ub.transpose(1, 2)),
        c(dp0.transpose(1, 2)), c(dts), c(Df.transpose(1, 2)), misc,
        None if aacc is None else c(aacc),
        solve_cuda.Chains(cpos, cvel, cacc, cols),
    )
    return kargs, (Df, dp0, T)


@functools.lru_cache(maxsize=None)
def _segment_columns_on(m: int, device: torch.device):
    """qp.segment_columns(m) on ``device``: (m, 6) int32 for K3 and the
    (1, m, 1, 6) int64 gather index, made once per device."""
    cols = torch.as_tensor(qp.segment_columns(m), device=device)
    return cols, cols.long().reshape(1, m, 1, 6)


def solve_batch_kernel(scenarios: Scenario,
                       cfg: OptimizerConfig = OptimizerConfig(),
                       steps: tuple[int, ...] = (2,), bos_wp=None,
                       dp0=None, T=None, Df=None) -> Solution:
    """Batch solve with the whole descent in one K3 launch (plain loop on
    CPU tensors).  The monotone cost envelope is always recorded.

    ``seed_mode="dual"`` races its two arms, one launch each; the
    post-race polish is composed by :func:`solve_batch`, so
    ``polish_iters > 0`` raises ValueError here."""
    if cfg.seed_mode == "dual":
        if cfg.polish_iters > 0:
            raise ValueError(
                "post-race polish lives in solve_batch (it composes the"
                " race and the restart); call solve_batch instead of"
                " solve_batch_kernel for polish_iters > 0"
            )
        return _race(solve_batch_kernel, scenarios, cfg, steps=steps,
                     bos_wp=bos_wp, dp0=dp0, T=T, Df=Df)
    kargs, (Df, dp0, T) = kernel_inputs(scenarios, cfg, bos_wp=bos_wp,
                                        dp0=dp0, T=T, Df=Df)
    phases = tuple(
        (s, cfg.iters_step1 if s == 1 else cfg.iters_step2) for s in steps
    )
    dpT, cost, n_acc, trace = solve_cuda.descend(*kargs, phases, cfg)
    dp = dpT.transpose(1, 2)  # (B, 3, P)

    bad = ~(torch.isfinite(cost) & torch.isfinite(dp).all(dim=(1, 2)))
    status = torch.where(bad, STATUS_DIVERGED, STATUS_OK).to(torch.int32)
    # failure recovery: fall back to the (always finite) seed
    dp_safe = torch.where(bad[:, None, None], dp0, dp)
    coeff = qp.coeff_from_d(Df, dp_safe, T)
    return Solution(coeff=coeff, T=T, cost=cost, cost_trace=trace,
                    n_accept=n_acc, dp=dp_safe, status=status)


def takes_k3(scenarios: Scenario, cfg: OptimizerConfig) -> bool:
    """The dispatch rule: whether a batch goes to the whole-descent kernel
    K3 (``lookup_mode == "auto"`` and ``solve_cuda.supports``) or to the
    per-iteration descent.  It reads the config and the shapes only."""
    m = scenarios.waypoints.shape[-2] - 1
    return cfg.lookup_mode == "auto" and solve_cuda.supports(
        tuple(scenarios.dist.shape[-3:]), m * cfg.n_samples, 3 * m - 3, cfg)


def _require_k3_for_crop(scenarios: Scenario) -> None:
    if scenarios.grid_offset is not None:
        raise ValueError(
            "exact-cropped scenarios (grid_offset set) require the "
            "whole-descent kernel path: lookup_mode='auto' with shapes and "
            "a config that K3 supports (solve_cuda.supports)"
        )


@profiling.traced("solver.solve_batch")
def solve_batch(scenarios: Scenario,
                cfg: OptimizerConfig = OptimizerConfig(),
                steps: tuple[int, ...] = (2,), record_trace: bool = False,
                bos_wp=None, dp0=None) -> Solution:
    """Solve a batch: every leaf has a leading batch axis; ``dist`` with
    leading dim 1 shares one map across the batch (no copies).

    ``steps`` follows the reference two-step schedule
    (grad_traj_optimizer.cpp:128-148, 413-415): step 1 optimizes
    collision only, step 2 the full cost; the active demo runs (2,).

    The batch goes to K3 (:func:`solve_batch_kernel`) where
    :func:`takes_k3` holds, else to :func:`solve_batch_fused`.  K3 records
    its cost trace whatever ``record_trace`` says (as the JAX package's
    kernel path); the per-iteration path returns a NaN trace unless
    ``record_trace``.

    ``seed_mode="dual"`` races the reference seed against the min-snap
    seed per lane, each arm dispatched by the rule, then, with
    ``polish_iters > 0``, restarts every lane's descent from its winner
    (a fresh BB state) and keeps the better.

    Cropped batches (:func:`crop_scenarios`) solve on both devices through
    K3, whose plain version also reads the crop frame; where the rule does
    not pick K3 they raise ValueError.  (The JAX package raises for them
    off the TPU, where its solve is not the kernel.)  Nothing crops
    automatically: the JAX package does so only on a TPU
    (``_maybe_autocrop``), and solves uncropped elsewhere.
    """
    if cfg.seed_mode == "dual":
        win = _race(solve_batch, scenarios, cfg, steps=steps,
                    record_trace=record_trace, bos_wp=bos_wp, dp0=dp0)
        if cfg.polish_iters > 0:
            sp = solve_batch(scenarios, _polish_cfg(cfg), steps=(2,),
                             record_trace=record_trace, bos_wp=bos_wp,
                             dp0=win.dp)
            win = _merge_polish(win, sp)
        return win
    if takes_k3(scenarios, cfg):
        return solve_batch_kernel(scenarios, cfg=cfg, steps=steps,
                                  bos_wp=bos_wp, dp0=dp0)
    return solve_batch_fused(scenarios, cfg=cfg, steps=steps,
                             record_trace=record_trace, bos_wp=bos_wp,
                             dp0=dp0)


def solve(scenario: Scenario, cfg: OptimizerConfig = OptimizerConfig(),
          steps: tuple[int, ...] = (2,), record_trace: bool = True,
          bos_wp=None) -> Solution:
    """Solve one scenario: :func:`solve_batch` at B = 1 (a cropped one
    too), so the same rule picks K3 or the per-iteration descent."""
    batch = scenario.map(lambda x: x[None])
    sol = solve_batch(
        batch, cfg=cfg, steps=steps, record_trace=record_trace,
        bos_wp=None if bos_wp is None else bos_wp[None],
    )
    return Solution(*(x[0] for x in sol))


def crop_scenarios(scenarios: Scenario,
                   cfg: OptimizerConfig = OptimizerConfig(),
                   margin: float = 2.0, multiple: int = 8) -> Scenario:
    """Crop each scenario's grid to a window around its waypoints.

    The descent's positions are boxed within ``cfg.bos`` of the interior
    waypoints (grad_traj_optimizer.cpp:154-177), so a trajectory stays
    near the waypoints' bounding box.  The window covers every waypoint
    +- (bos + margin), snapped to whole cells; one shape (the batch's
    largest, rounded up to ``multiple``) serves the batch.  A shared map
    (``dist`` leading dim 1) takes one union window over every
    scenario's waypoints and stays one grid.  The window arithmetic is
    the JAX package's (``crop_scenarios``), in float64 numpy, so the
    offsets and shapes are its own.

    The crop is exact for in-window queries: the result keeps the global
    ``origin`` and records the cell offset and the full extents
    (``grid_offset``/``grid_full``); the lookup does its coordinate
    arithmetic in the global frame and only the corner cells subtract
    the offset, so an in-window lookup is bitwise the full grid's.  A
    query outside the window, or within half a cell of an interior crop
    face, reads as out of map (-1, the reference's deep-collision
    sentinel, sdf_map.cpp:187).

    :func:`solve_batch` and :func:`solve` take the result on the card
    (K3) and on the CPU (K3's plain version); the JAX package takes it
    only through its TPU kernel.  One host read brings waypoints, origin
    and resolution over; the slice stays on the grids' device (one copy
    of a shared map's window, one gather of B windows otherwise).
    Returns the input unchanged when the window is the whole grid.
    Raises ValueError for mixed resolutions or origins and for a batch
    that is already cropped.
    """
    wp, org, rs = scenarios.waypoints, scenarios.origin, \
        scenarios.resolution
    host = torch.cat([x.reshape(-1).to(torch.float64)
                      for x in (wp, org, rs)]).cpu().numpy()
    n_wp, n_org = wp.numel(), org.numel()
    wps = host[:n_wp].reshape(wp.shape)  # (B, n_wp, 3)
    origins = host[n_wp:n_wp + n_org].reshape(org.shape)  # (B, 3)
    res_all = host[n_wp + n_org:]
    res = float(res_all[0])
    if not np.allclose(res_all, res):
        raise ValueError("crop_scenarios needs a uniform resolution batch")
    if not np.allclose(origins, origins[0]):
        raise ValueError("crop_scenarios needs a shared-origin batch")
    if scenarios.grid_offset is not None:
        raise ValueError("scenarios are already cropped")
    grid = np.asarray(scenarios.dist.shape[1:])  # (3,)
    B = wps.shape[0]
    shared = scenarios.dist.shape[0] == 1

    half = cfg.bos + margin
    lo = wps.min(axis=1) - half  # (B, 3)
    hi = wps.max(axis=1) + half
    if shared:  # one union window -> one shared cropped grid
        lo = np.broadcast_to(lo.min(axis=0), lo.shape)
        hi = np.broadcast_to(hi.max(axis=0), hi.shape)
    i_lo = np.floor((lo - origins) / res).astype(np.int64)
    i_hi = np.ceil((hi - origins) / res).astype(np.int64) + 1
    i_lo = np.clip(i_lo, 0, grid[None, :])
    i_hi = np.clip(i_hi, 0, grid[None, :])

    ext = (i_hi - i_lo).max(axis=0)  # (3,)
    shape = tuple(
        int(min(g, -(-e // multiple) * multiple))
        for e, g in zip(ext, grid)
    )
    if shape == tuple(grid):
        return scenarios
    offset = np.clip(i_lo, 0, grid[None, :] - np.asarray(shape)[None, :])

    dist = scenarios.dist
    frame = torch.as_tensor(
        np.stack([offset, np.broadcast_to(grid, (B, 3))]).astype(np.int32),
        device=dist.device)
    (sx, sy, sz), (ox, oy, oz) = shape, offset[0]
    if shared:
        new_dist = dist[:, ox:ox + sx, oy:oy + sy, oz:oz + sz].contiguous()
    else:
        off = frame[0].long()

        def cells(a, n):  # (B, n) cell indices along axis a
            return off[:, a, None] + torch.arange(n, device=dist.device)

        rows = torch.arange(B, device=dist.device)
        new_dist = dist[rows[:, None, None, None],
                        cells(0, sx)[:, :, None, None],
                        cells(1, sy)[:, None, :, None],
                        cells(2, sz)[:, None, None, :]]
    return scenarios._replace(dist=new_dist, grid_offset=frame[0],
                              grid_full=frame[1])


def solve_batch_fused(scenarios: Scenario,
                      cfg: OptimizerConfig = OptimizerConfig(),
                      steps: tuple[int, ...] = (2,),
                      record_trace: bool = False, interpret: bool = False,
                      bos_wp=None, dp0=None) -> Solution:
    """Batch solve by the per-iteration descent (port of the JAX package's
    ``solve_batch_fused``): ``descent.minimize_batch`` over
    ``penalty.cost_and_grad_batch`` for each step, so every evaluation of
    the penalty looks its samples up once, one K2 launch
    (``trilinear_cuda.trilinear_batch``) on CUDA tensors and
    ``trilinear_batch_plain`` on CPU tensors.  It takes every config and
    shape: the BB and adaptive step rules, any ``accept_window``, any
    number of waypoints, per-scenario or shared grids (``dist`` with
    leading dim 1 is read with stride 0, no copies).

    The seed and bounds are the JAX function's: waypoint times, the
    straight-line or min-snap seed, ``bos_wp`` bounds; a ``dp0`` is
    clipped to the bounds.  ``seed_mode="dual"`` races its two arms;
    ``polish_iters > 0`` raises ValueError (the polish composes in
    :func:`solve_batch`).  A diverged lane falls back to its seed, with
    status ``STATUS_DIVERGED``.  ``record_trace=False`` returns a NaN
    trace of shape (B, total iterations), as the JAX package does.

    ``interpret`` is the JAX package's Pallas interpret switch: it is
    taken and ignored.  The TPU's grid prep (bf16 planes) is not carried
    over, so ``lookup_precision="high"`` answers in float32 too.  A cropped
    batch raises ValueError: K2 has no crop frame.
    """
    del interpret  # the JAX package's Pallas switch; nothing to switch here
    _require_k3_for_crop(scenarios)
    return _solve_per_iteration(scenarios, cfg, steps, record_trace,
                                bos_wp=bos_wp, dp0=dp0)


def _solve_per_iteration(scenarios: Scenario, cfg: OptimizerConfig,
                         steps: tuple[int, ...], record_trace: bool,
                         bos_wp=None, dp0=None, T=None, Df=None) -> Solution:
    """The per-iteration descent of :func:`solve_batch_fused` and of the
    kino solves (the JAX package's ``_solve_kino_fallback``): ``T`` (B, m)
    and ``Df`` (B, 3, 6) override the waypoint-derived segment times and
    fixed derivatives, with ``dp0`` from ``qp.kino_d`` alongside."""
    if cfg.seed_mode == "dual":
        if cfg.polish_iters > 0:
            raise ValueError(
                "post-race polish lives in solve_batch (it composes the"
                " race and the restart); call solve_batch instead of"
                " solve_batch_fused for polish_iters > 0"
            )
        return _race(_solve_per_iteration, scenarios, cfg, steps=steps,
                     record_trace=record_trace, bos_wp=bos_wp, dp0=dp0, T=T,
                     Df=Df)
    return _per_iteration(scenarios, cfg, steps, record_trace, bos_wp, dp0,
                          T, Df)


@profiling.traced("solver.per_iteration")
def _per_iteration(scenarios: Scenario, cfg: OptimizerConfig,
                   steps: tuple[int, ...], record_trace: bool, bos_wp, dp0,
                   T, Df) -> Solution:
    """One arm of :func:`_solve_per_iteration`: the seed, the bounds and
    ``descent.minimize_batch`` for each step, in the span
    ``solver.per_iteration`` (a race keeps one an arm)."""
    wp = scenarios.waypoints  # (B, m+1, 3)
    B, m = wp.shape[0], wp.shape[1] - 1
    if T is None:
        T = qp.allocate_times(wp, cfg.mean_v, cfg.init_time)
    Df_wp, seed = qp.straight_line_d(wp)
    Df = Df_wp if Df is None else Df
    bctx = penalty.build_ctx_batch(T, Df, cfg)
    lb, ub = penalty.bounds(wp, seed.shape[2], cfg,
                            bos=None if bos_wp is None else bos_wp[:, 1:m])
    if cfg.seed_mode == "min_snap":
        seed = torch.clamp(qp.min_snap_dp(Df, bctx.dep.Rpp, bctx.dep.Rfp),
                           lb, ub)
    if dp0 is not None:
        seed = torch.clamp(dp0, lb, ub)

    origin = scenarios.origin.contiguous()
    resolution = scenarios.resolution.contiguous()
    grids = scenarios.dist.contiguous()
    dp = seed
    n_acc = torch.zeros((B,), dtype=torch.int32, device=wp.device)
    cost = torch.zeros((B,), dtype=wp.dtype, device=wp.device)
    traces = []
    for step in steps:
        def cag(x, step=step):
            return penalty.cost_and_grad_batch(x, bctx, grids, origin,
                                               resolution, cfg, step)

        iters = cfg.iters_step1 if step == 1 else cfg.iters_step2
        res = descent.minimize_batch(cag, dp, lb, ub, iters, cfg,
                                     record_trace=record_trace)
        dp, cost = res.dp, res.cost
        n_acc = n_acc + res.n_accept
        traces.append(res.cost_trace)

    bad = ~(torch.isfinite(cost) & torch.isfinite(dp).all(dim=(1, 2)))
    status = torch.where(bad, STATUS_DIVERGED, STATUS_OK).to(torch.int32)
    # failure recovery: fall back to the (always finite) seed
    dp_safe = torch.where(bad[:, None, None], seed, dp)
    trace = (torch.cat(traces, dim=1) if traces
             else torch.zeros((B, 0), dtype=wp.dtype, device=wp.device))
    return Solution(coeff=qp.coeff_from_d(Df, dp_safe, T), T=T, cost=cost,
                    cost_trace=trace, n_accept=n_acc, dp=dp_safe,
                    status=status)


def solve_kino_batch(dists, origins, resolutions, pos, vel, acc, times,
                     cfg: OptimizerConfig = OptimizerConfig(),
                     steps: tuple[int, ...] = (2,),
                     record_trace: bool = False,
                     bos_wp=None, device=None) -> Solution:
    """Batched setKinoPath + optimizeTrajectory (the reference's
    search-seeded back-end, grad_traj_optimizer.cpp:35-65 + compare2's
    refinement stage :233-321): Hermite-seed from search knot states and
    refine under bounds centered on the knot positions.  The rule of
    :func:`solve_batch` picks the descent: one K3 launch where
    :func:`takes_k3` holds, else the per-iteration descent (the JAX
    package's ``_solve_kino_fallback``), one K2 launch an evaluation;
    their plain versions on CPU tensors.  ``record_trace`` as in
    :func:`solve_batch`.

    Args:
      dists: (B, nx, ny, nz) or (1, ...) shared; origins (B, 3);
      resolutions (B,); pos/vel/acc (B, m+1, 3) knot states; times
      (B, m) segment durations.  The solve runs on the device of a tensor
      ``dists``, and a numpy ``dists`` goes to ``device`` (the card
      unless asked otherwise); a tensor argument on another device raises
      ValueError (``_device``).
    """
    dists, dev = _device.field_device(dists, device)
    pos = _device.on(pos, dev, "pos")
    scn = Scenario(
        dist=dists.to(torch.float32),
        origin=_device.on(origins, dev, "origins"),
        resolution=_device.on(resolutions, dev, "resolutions"),
        waypoints=pos,
    )
    Df, dp0 = qp.kino_d(pos, _device.on(vel, dev, "vel"),
                        _device.on(acc, dev, "acc"))
    _device.check_on(dev, bos_wp=bos_wp)
    T = _device.on(times, dev, "times")
    if takes_k3(scn, cfg):
        return solve_batch_kernel(scn, cfg=cfg, steps=steps, bos_wp=bos_wp,
                                  dp0=dp0, T=T, Df=Df)
    return _solve_per_iteration(scn, cfg, steps, record_trace,
                                bos_wp=bos_wp, dp0=dp0, T=T, Df=Df)


def solve_kino_batch_race(dists, origins, resolutions, pos, vel, acc,
                          times, stretches: tuple[float, ...] = (1.0, 1.2),
                          cfg: OptimizerConfig = OptimizerConfig(),
                          steps: tuple[int, ...] = (2,),
                          record_trace: bool = False,
                          bos_wp=None, device=None) -> Solution:
    """Seed-duration race: refine the same knot states under each
    duration ``stretch`` (one :func:`solve_kino_batch` each) and keep the
    per-lane winner: a converged arm beats a diverged one, then the lower
    final cost wins.  Devices and ``record_trace`` as in
    :func:`solve_kino_batch` (the JAX package's race records none)."""
    dists, dev = _device.field_device(dists, device)
    times = _device.on(times, dev, "times")
    best: Solution | None = None
    for s in stretches:
        sol = solve_kino_batch(dists, origins, resolutions, pos, vel, acc,
                               times * s, cfg=cfg, steps=steps,
                               record_trace=record_trace, bos_wp=bos_wp)
        if best is None:
            best = sol
            continue
        b_ok = best.status == STATUS_OK
        s_ok = sol.status == STATUS_OK
        take = torch.where(b_ok == s_ok, sol.cost < best.cost, s_ok)
        best = _lane_select(take, best, sol)
    return best


def evaluate_solution(sol: Solution, n: int = 400):
    """Reference-style metrics of one solution (opti_node.cpp:136-142)."""
    mean_v, max_v = poly.mean_max_speed(sol.coeff, sol.T, n)
    mean_a, max_a = poly.mean_max_acc(sol.coeff, sol.T, n)
    return {
        "time_sum": torch.sum(sol.T),
        "length": poly.length(sol.coeff, sol.T, n),
        "jerk": poly.jerk_cost(sol.coeff, sol.T),
        "mean_v": mean_v,
        "max_v": max_v,
        "mean_a": mean_a,
        "max_a": max_a,
        "cost": sol.cost,
    }


def min_clearance(sols: Solution, scenarios: Scenario, n: int = 400):
    """(B,) smallest trilinear distance to an obstacle along each solved
    trajectory, sampled at n uniform times (batched Solution and
    Scenario).  The lookup is kernel K2 on CUDA tensors; an out-of-map
    sample reads -1.  The demo's healthy value is ~1 m.  K2 has no crop
    frame (nor has the TPU's), so a cropped batch raises ValueError."""
    require_uncropped(scenarios, "min_clearance")
    pos, _ = poly.sample_uniform(sols.coeff, sols.T, n)  # (B, n, 3)
    B = pos.shape[0]
    d, _ = trilinear_cuda.trilinear_batch(
        scenarios.dist.contiguous(),
        scenarios.origin.expand(B, 3).contiguous(),
        scenarios.resolution.expand(B).contiguous(),
        pos.contiguous(),
    )
    return d.amin(dim=1)
