"""K3: the whole multi-phase projected-BB descent, one launch per batch.

Replaces ``grad_traj_optimization_tpu/ops/solve_pallas.py::_solve_kernel``
(launched by ``descend_fused``).  The CUDA kernel is ``csrc/solve.cu``
(one thread block per scenario; its note says what bounds it); the plain
version :func:`descend_plain` runs ``opt.descent.minimize_batch`` over
the same inputs.  Inputs come from ``solver.kernel_inputs`` in the JAX
package's layouts, plus the compact chains the kernel reads:

  grids (B or 1, nx, ny, nz) f32 — the f32 distance grids (the JAX
    kernel's slot holds bf16 planes instead);
  apos/avel (B, SP, ndim) sampling chains, rows past S zero;
  tltv (B, P, 2*SP) = [TL^T | TVL^T] (+ TAL^T when alpha_a != 0);
  rpp (B, P, P); cgt/lbT/ubT/dp0T (B, P, 3); dts (B, SP, 1);
  dfT (B, 6, 3); misc (B, 1, 16) = [origin, res, c_ff, crop offset (3),
    full-map extents (3), 0 ...] (the exact-crop frame of
    ``solver.crop_scenarios``; offset 0 and the grid's own extents for an
    uncropped grid); aacc (B, SP, ndim) or None;
  chains: :class:`Chains`, the structural non-zero columns of the
    apos/avel/aacc rows (what the kernel reads in their place).

Not carried over: the TPU kernel's z-window, y-reduction and QP-fusion
variants and its profiling ablations.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from grad_traj_optimization_torch import _build
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.ops import trilinear_cuda
from grad_traj_optimization_torch.opt import descent, penalty
from grad_traj_optimization_torch.utils import profiling

#: phases the kernel's parameter block holds (steps=(1, 2) uses two)
MAX_PHASES = 4

#: shared memory a block may use on sm_90 (232 448 bytes) less K3's static
#: lookup frame (sizeof(GtoFrame) = 76): ``kMaxSmem`` in csrc/solve.cu
MAX_SMEM = 232448 - 76

#: the largest block descend_kernel keeps resident: under
#: ``__maxnreg__(128)`` ptxas gives it 127 registers a thread, allocated
#: as 128, so one SM's 65 536 registers hold 512 threads (its
#: maxThreadsPerBlock).  Both read back by :func:`limits` on an NVIDIA
#: H100 80GB HBM3 (700 W power limit), CUDA 12.8
MAX_THREADS = 512


class Chains(NamedTuple):
    """The sample chains in compact form: sample s of segment
    c = s // K keeps only the columns ``cols[c]`` of its apos/avel/aacc
    row (``core.qp.segment_columns``), so ``apos[b, s, cols[c, q]] ==
    pos[b, s, q]`` and every other entry of the row is zero."""

    pos: torch.Tensor            # (B, SP, 6), rows past S zero
    vel: torch.Tensor            # (B, SP, 6)
    acc: Optional[torch.Tensor]  # (B, SP, 6) when alpha_a != 0, else None
    cols: torch.Tensor           # (m, 6) int32


def _pow2ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def spt_choices(K: int) -> list[int]:
    """Samples per thread the kernel may take for K samples a segment:
    powers of two from the one that fits a segment in one warp to K."""
    kp = _pow2ceil(K)
    spt, out = max(1, kp // 32), []
    while spt <= kp:
        out.append(spt)
        spt *= 2
    return out


def launch_shape(m: int, K: int, window: int, use_a: bool,
                 spt: int) -> tuple[int, int]:
    """(threads, dynamic shared bytes) of one block with ``spt`` samples
    per thread (mirrors make_plan in csrc/solve.cu): a segment's K
    samples on pow2ceil(K) / spt lanes, at least one thread per gradient
    entry, whole warps; compact chains (13 rows of slots, 19 with the
    acceleration chain), Rpp, [Df; x], the segment sums, the accept ring,
    the reduction slots and the column table."""
    P = 3 * m - 3
    p3 = 3 * P
    nt = max(m * (_pow2ceil(K) // spt), p3, 32)
    nt = -(-nt // 32) * 32
    slots = spt * nt
    floats = (19 if use_a else 13) * slots + P * P + 18 + p3 + 18 * m \
        + window + 96 + 64 + 6 * m
    return nt, 4 * floats


def supports(grid_shape, n_samples: int, num_dp: int,
             cfg: OptimizerConfig) -> bool:
    """What the kernel runs: the JAX kernel's limits (BB step rule,
    1 <= num_dp <= 128, 1 <= accept_window <= 128), ``cfg.n_samples``
    samples a segment within the ``n_samples`` padded rows, and some
    samples-per-thread plan whose block the card can launch: at most
    :data:`MAX_THREADS` threads and :data:`MAX_SMEM` bytes of shared
    memory (``choose_plan`` in csrc/solve.cu takes such a plan, and only
    such).  It reads the config and the shapes only, so the CPU and the
    card route a batch alike."""
    m, K = num_dp // 3 + 1, cfg.n_samples
    return (
        1 <= num_dp <= 128
        and num_dp % 3 == 0
        and cfg.step_rule == "bb"
        and 1 <= cfg.accept_window <= 128
        and 1 <= K and m * K <= n_samples
        and any(nt <= MAX_THREADS and smem <= MAX_SMEM
                for nt, smem in (
                    launch_shape(m, K, cfg.accept_window,
                                 cfg.alpha_a != 0.0, s)
                    for s in spt_choices(K)))
        and all(n >= 1 for n in grid_shape)
    )


def plan(m: int, K: int, window: int, use_a: bool, B: int,
         device="cuda") -> dict:
    """The launch plan the kernel takes for B scenarios on ``device``
    (default: the current card; gto_descend_plan): samples per thread,
    threads and shared bytes a block, resident blocks per SM and the
    card's SM count."""
    out = (ctypes.c_int * 5)()
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.gto_descend_plan(m, K, window, int(use_a), B,
                                  ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, rc, "gto_descend_plan")
    return dict(zip(("spt", "threads", "smem", "blocks_per_sm", "sms"), out))


def limits(device="cuda") -> dict:
    """K3's launch limits as the card reports them (gto_descend_limits):
    ``max_smem`` (kMaxSmem), ``frame`` (sizeof(GtoFrame)), ``regs`` and
    ``max_threads_per_block`` (cudaFuncAttributes) and ``resident`` (the
    largest block one SM holds), to hold :data:`MAX_SMEM` and
    :data:`MAX_THREADS` against."""
    out = (ctypes.c_int * 5)()
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.gto_descend_limits(ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, rc, "gto_descend_limits")
    return dict(zip(("max_smem", "frame", "regs", "max_threads_per_block",
                     "resident"), out))


def _cost_and_grad_fn(grids, apos, avel, tltv, rpp, cgt, dts, dfT, misc,
                      aacc, cfg: OptimizerConfig, step: int):
    """cost (B,), grad (B, P, 3) at dpT over the kernel's inputs."""
    B, SP = apos.shape[:2]
    grid_shape = tuple(grids.shape[1:])
    flat = grids.reshape(-1)
    bases = trilinear_cuda._bases(grids, B)
    origin = misc[:, :, 0:3]   # (B, 1, 3)
    res = misc[:, :, 3]        # (B, 1)
    offset = misc[:, :, 5:8].to(torch.int64)   # crop frame, (B, 1, 3)
    full = misc[:, :, 8:11].to(torch.int64)
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
        d, g = sdf.trilinear_flat(flat, bases, grid_shape, origin, res, pos,
                                  offset=offset, full_shape=full)
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
                  dp0T, dts, dfT, misc, aacc, chains, phases,
                  cfg: OptimizerConfig):
    """Plain PyTorch version: ``descent.minimize_batch`` per phase over the
    kernel's inputs, the next phase starting from the best iterate.  It
    reads the dense chains; ``chains`` is taken and not read.

    Returns dpT (B, P, 3), cost (B,), n_accept (B,) int32 and the
    monotone cost trace (B, total iters).
    """
    profiling.add("plain.descend")
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


def descend(grids, grid_shape, apos, avel, tltv, rpp, cgt, lbT, ubT, dp0T,
            dts, dfT, misc, aacc, chains: Chains, phases,
            cfg: OptimizerConfig):
    """Run the whole multi-phase descent: one kernel launch on CUDA
    tensors, :func:`descend_plain` on CPU tensors.

    ``phases`` is a tuple of (step, iters), e.g. ((2, 100),).  On CUDA,
    anything :func:`supports` rejects raises ValueError.  The kernel reads
    ``chains`` in place of the dense apos/avel/aacc/tltv; ``chains.acc``
    must be given when ``cfg.alpha_a != 0``.
    """
    if apos.device.type == "cpu":
        return descend_plain(grids, grid_shape, apos, avel, tltv, rpp, cgt,
                             lbT, ubT, dp0T, dts, dfT, misc, aacc, chains,
                             phases, cfg)
    dev = apos.device
    B, SP, ndim = apos.shape
    P = ndim - 6
    m, K = ndim // 3 - 1, cfg.n_samples
    if grid_shape is not None and tuple(grid_shape) != tuple(grids.shape[1:]):
        raise ValueError(f"grid_shape {grid_shape} != {grids.shape[1:]}")
    if not supports(grids.shape[1:], SP, P, cfg):
        raise ValueError(
            f"descent kernel does not support SP={SP}, num_dp={P}, "
            f"n_samples={K}, step_rule={cfg.step_rule!r}, "
            f"accept_window={cfg.accept_window}"
        )
    if not 1 <= len(phases) <= MAX_PHASES:
        raise ValueError(f"{len(phases)} phases, kernel takes 1..{MAX_PHASES}")
    req = _build.require_cuda_f32
    req("chains.pos", chains.pos, shape=(B, SP, 6), device=dev)
    req("chains.vel", chains.vel, shape=(B, SP, 6), device=dev)
    cols = chains.cols
    if (cols.device != dev or cols.dtype != torch.int32
            or tuple(cols.shape) != (m, 6) or not cols.is_contiguous()):
        raise ValueError(f"chains.cols: expected contiguous int32 ({m}, 6) "
                         f"on {dev}")
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
        if chains.acc is None:
            raise ValueError("alpha_a != 0 needs the acceleration chain")
        req("chains.acc", chains.acc, shape=(B, SP, 6), device=dev)

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
    # the launch, its plan (SM count, shared-memory attribute) and the
    # stream all belong to the tensors' card, whichever card is current
    with torch.cuda.device(dev):
        rc = lib.gto_descend(
            p(grids), stride, nx, ny, nz, p(chains.pos), p(chains.vel),
            p(chains.acc) if cfg.alpha_a != 0.0 else None, p(cols), p(rpp),
            p(cgt), p(lbT), p(ubT), p(dp0T), p(dts), p(dfT), p(misc), B, SP,
            m, K, ctypes.cast(fparams, ctypes.c_void_p),
            ctypes.cast(iparams, ctypes.c_void_p),
            p(odp), p(ocost), p(onacc), p(otrace), _build.stream(apos),
        )
    _build.check(lib, rc, "gto_descend")
    profiling.add("launch.descend")
    return odp, ocost, onacc, otrace
