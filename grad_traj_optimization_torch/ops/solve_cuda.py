"""K3: the whole multi-phase projected-BB descent, one launch per batch.

Replaces ``grad_traj_optimization_tpu/ops/solve_pallas.py::_solve_kernel``
(launched by ``descend_fused``).  The CUDA kernel is ``csrc/solve.cu``
(one thread block per scenario; its note says what bounds it); the plain
version :func:`descend_plain` runs ``opt.descent.minimize_batch`` over
the same inputs.  Inputs come from ``solver.kernel_inputs`` in the JAX
package's layouts:

  grids (B or 1, nx, ny, nz) f32 — the f32 distance grids (the JAX
    kernel's slot holds bf16 planes instead);
  apos/avel (B, SP, ndim) sampling chains, rows past S zero;
  tltv (B, P, 2*SP) = [TL^T | TVL^T] (+ TAL^T when alpha_a != 0);
  rpp (B, P, P); cgt/lbT/ubT/dp0T (B, P, 3); dts (B, SP, 1);
  dfT (B, 6, 3); misc (B, 1, 16) = [origin, res, c_ff, 0 (3),
    grid extents (3), 0 ...]; aacc (B, SP, ndim) or None.

Not carried over: the TPU kernel's z-window, y-reduction and QP-fusion
variants, its profiling ablations and the exact-crop frame (misc[5:11]
is read as offset 0, full extent = grid shape).
"""

from __future__ import annotations

import ctypes

import torch

from grad_traj_optimization_torch import _build
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.ops import trilinear_cuda
from grad_traj_optimization_torch.opt import descent, penalty

#: phases the kernel's parameter block holds (steps=(1, 2) uses two)
MAX_PHASES = 4
#: shared memory a block may use on sm_90 (227 KB)
MAX_SMEM = 232448


def smem_bytes(n_samples_padded: int, num_dp: int, window: int,
               use_a: bool = False) -> int:
    """The kernel's dynamic shared memory (mirrors gto_descend): the
    position and velocity chains, with ``use_a`` (alpha_a != 0) the
    acceleration chain and its three weight rows too."""
    ndim = num_dp + 6
    p3 = 3 * num_dp
    nt = -(-max(n_samples_padded, p3, 32) // 32) * 32
    n_chain, n_w = (3, 9) if use_a else (2, 6)
    floats = (n_chain * ndim + n_w) * nt + num_dp * num_dp + 9 * p3 + 18 \
        + window + 96
    return 4 * floats


def supports(grid_shape, n_samples: int, num_dp: int,
             cfg: OptimizerConfig) -> bool:
    """What the kernel runs: the JAX kernel's limits (BB step rule,
    1 <= num_dp <= 128, 1 <= accept_window <= 128) plus this card's
    1024 threads and 227 KB of shared memory per block."""
    sp = max(8, -(-n_samples // 8) * 8)
    return (
        1 <= num_dp <= 128
        and cfg.step_rule == "bb"
        and 1 <= cfg.accept_window <= 128
        and max(sp, 3 * num_dp) <= 1024
        and smem_bytes(sp, num_dp, cfg.accept_window,
                       cfg.alpha_a != 0.0) <= MAX_SMEM
        and all(n >= 1 for n in grid_shape)
    )


def _cost_and_grad_fn(grids, apos, avel, tltv, rpp, cgt, dts, dfT, misc,
                      aacc, cfg: OptimizerConfig, step: int):
    """cost (B,), grad (B, P, 3) at dpT over the kernel's inputs."""
    B, SP = apos.shape[:2]
    grid_shape = tuple(grids.shape[1:])
    flat = grids.reshape(-1)
    bases = trilinear_cuda._bases(grids, B)
    origin = misc[:, :, 0:3]   # (B, 1, 3)
    res = misc[:, :, 3]        # (B, 1)
    c_ff = misc[:, 0, 4]
    ws = 0.0 if step == 1 else cfg.w_smooth
    wc = cfg.w_collision
    ref = cfg.gradient_mode == "reference"
    va = step == 2 and (cfg.alpha_v != 0.0 or cfg.alpha_a != 0.0)

    def cost_and_grad(dpT):
        z = torch.bmm(rpp, dpT)
        cost_s = c_ff + torch.sum(cgt * dpT, dim=(1, 2)) \
            + torch.sum(dpT * z, dim=(1, 2))
        grad_s = cgt + 2.0 * z
        if abs(wc) < 1e-4:
            return penalty._smooth_only(ws, cost_s, grad_s, cfg)
        d_full = torch.cat([dfT, dpT], dim=1)  # (B, ndim, 3)
        pos = torch.bmm(apos, d_full)          # (B, SP, 3)
        vel = torch.bmm(avel, d_full)
        d, g = sdf.trilinear_flat(flat, bases, grid_shape, origin, res, pos)
        d = d[..., None]
        cd = cfg.alpha * torch.exp(-(d - cfg.d0) / cfg.r)
        gd = -cd / cfg.r
        vn = torch.sqrt(torch.sum(vel * vel, dim=2, keepdim=True)) \
            + cfg.vel_eps
        cost_c = torch.sum(cd * vn * dts, dim=(1, 2))
        w_dist = gd * cd * vn if ref else gd * vn
        w1 = (w_dist * dts) * g
        w2 = ((cd / vn) * dts) * vel
        blocks = [wc * w1, wc * w2]
        cost = ws * cost_s + wc * cost_c + cfg.cost_eps
        if va:
            acc = torch.bmm(aacc, d_full) if cfg.alpha_a != 0.0 else None
            cost_v, cost_a, w_tvl, w_tal = penalty._va_weights(
                vel, acc, vn[..., 0], cfg
            )
            cost = cost + torch.sum((cost_v + cost_a) * dts[..., 0], dim=1)
            blocks[1] = blocks[1] + w_tvl * dts
            if cfg.alpha_a != 0.0:
                blocks.append(w_tal * dts)
        Bk = torch.cat(blocks, dim=1)  # (B, k*SP, 3)
        grad = ws * grad_s + torch.bmm(tltv[:, :, :Bk.shape[1]], Bk)
        if ref:
            grad = grad + cfg.grad_eps
        return cost, grad

    return cost_and_grad


def descend_plain(grids, grid_shape, apos, avel, tltv, rpp, cgt, lbT, ubT,
                  dp0T, dts, dfT, misc, aacc, phases, cfg: OptimizerConfig):
    """Plain PyTorch version: ``descent.minimize_batch`` per phase over the
    kernel's inputs, the next phase starting from the best iterate.

    Returns dpT (B, P, 3), cost (B,), n_accept (B,) int32 and the
    monotone cost trace (B, total iters).
    """
    descend_plain.calls += 1
    dpT = torch.clamp(dp0T, lbT, ubT)
    B = dpT.shape[0]
    n_acc = torch.zeros((B,), dtype=torch.int32, device=dpT.device)
    cost = torch.zeros((B,), dtype=dpT.dtype, device=dpT.device)
    traces = []
    for step, iters in phases:
        cag = _cost_and_grad_fn(grids, apos, avel, tltv, rpp, cgt, dts, dfT,
                                misc, aacc, cfg, step)
        res = descent.minimize_batch(cag, dpT, lbT, ubT, iters, cfg,
                                     record_trace=True)
        dpT, cost = res.dp, res.cost
        n_acc = n_acc + res.n_accept
        traces.append(res.cost_trace)
    return dpT, cost, n_acc, torch.cat(traces, dim=1)


descend_plain.calls = 0


def descend(grids, grid_shape, apos, avel, tltv, rpp, cgt, lbT, ubT, dp0T,
            dts, dfT, misc, aacc, phases, cfg: OptimizerConfig):
    """Run the whole multi-phase descent: one kernel launch on CUDA
    tensors, :func:`descend_plain` on CPU tensors.

    ``phases`` is a tuple of (step, iters), e.g. ((2, 100),).  On CUDA,
    anything :func:`supports` rejects raises ValueError.  ``aacc`` must be
    given when ``cfg.alpha_a != 0``.
    """
    if apos.device.type == "cpu":
        return descend_plain(grids, grid_shape, apos, avel, tltv, rpp, cgt,
                             lbT, ubT, dp0T, dts, dfT, misc, aacc, phases,
                             cfg)
    dev = apos.device
    B, SP, ndim = apos.shape
    P = ndim - 6
    if grid_shape is not None and tuple(grid_shape) != tuple(grids.shape[1:]):
        raise ValueError(f"grid_shape {grid_shape} != {grids.shape[1:]}")
    if not supports(grids.shape[1:], SP, P, cfg):
        raise ValueError(
            f"descent kernel does not support SP={SP}, num_dp={P}, "
            f"step_rule={cfg.step_rule!r}, "
            f"accept_window={cfg.accept_window}"
        )
    if not 1 <= len(phases) <= MAX_PHASES:
        raise ValueError(f"{len(phases)} phases, kernel takes 1..{MAX_PHASES}")
    req = _build.require_cuda_f32
    req("apos", apos, shape=(B, SP, ndim))
    req("avel", avel, shape=(B, SP, ndim), device=dev)
    req("grids", grids, shape=(None, None, None, None), device=dev)
    if grids.shape[0] not in (1, B):
        raise ValueError(f"grids leading dim {grids.shape[0]} not 1 or {B}")
    req("rpp", rpp, shape=(B, P, P), device=dev)
    for name, t in (("cgt", cgt), ("lbT", lbT), ("ubT", ubT),
                    ("dp0T", dp0T)):
        req(name, t, shape=(B, P, 3), device=dev)
    req("dts", dts, shape=(B, SP, 1), device=dev)
    req("dfT", dfT, shape=(B, 6, 3), device=dev)
    req("misc", misc, shape=(B, 1, 16), device=dev)
    if cfg.alpha_a != 0.0:
        if aacc is None:
            raise ValueError("alpha_a != 0 needs the acceleration chain aacc")
        req("aacc", aacc, shape=(B, SP, ndim), device=dev)

    total = sum(it for _, it in phases)
    odp = torch.empty((B, P, 3), dtype=torch.float32, device=dev)
    ocost = torch.empty((B,), dtype=torch.float32, device=dev)
    onacc = torch.empty((B,), dtype=torch.int32, device=dev)
    otrace = torch.empty((B, total), dtype=torch.float32, device=dev)
    if B == 0:
        return odp, ocost, onacc, otrace
    fparams = (ctypes.c_float * 18)(
        cfg.w_smooth, cfg.w_collision, cfg.alpha, cfg.d0, cfg.r,
        cfg.vel_eps, cfg.cost_eps, cfg.grad_eps, cfg.lr0, cfg.lr_shrink,
        cfg.lr_min, cfg.lr_max, cfg.alpha_v, cfg.v0, cfg.r_v, cfg.alpha_a,
        cfg.a0, cfg.r_a,
    )
    ivals = [int(cfg.gradient_mode == "reference"), cfg.accept_window,
             len(phases), total]
    for step, iters in phases:
        ivals += [int(step), int(iters)]
    iparams = (ctypes.c_int * len(ivals))(*ivals)
    nx, ny, nz = grids.shape[1:]
    stride = 0 if grids.shape[0] == 1 else nx * ny * nz
    lib = _build.load()
    p = _build.ptr
    rc = lib.gto_descend(
        p(grids), stride, nx, ny, nz, p(apos), p(avel), p(rpp), p(cgt),
        p(lbT), p(ubT), p(dp0T), p(dts), p(dfT), p(misc),
        p(aacc) if cfg.alpha_a != 0.0 else None, B, SP, ndim,
        ctypes.cast(fparams, ctypes.c_void_p),
        ctypes.cast(iparams, ctypes.c_void_p),
        p(odp), p(ocost), p(onacc), p(otrace), _build.stream(apos),
    )
    _build.check(lib, rc, "gto_descend")
    descend.launches += 1
    return odp, ocost, onacc, otrace


descend.launches = 0
