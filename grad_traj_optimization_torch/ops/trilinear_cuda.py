"""K2: batched trilinear distance + gradient lookup on the GPU.

For a (B, S, 3) batch of positions, the trilinear distance d (B, S) and
its analytic gradient g (B, S, 3) from each scenario's grid, with the
sdf_map quirks; out of map gives (-1, 0).

Replaces ``grad_traj_optimization_tpu/ops/trilinear_pallas.py::_kernel``
(launched by ``trilinear_fused_prepped``).  The CUDA sources are
``csrc/trilinear.cuh`` (the per-point lookup, which the whole-descent
kernel K3 includes) and ``csrc/trilinear.cu`` (this batched launch); the
note there says what bounds it.  The TPU kernel's bf16 hi/mid grid planes
(``prep_grids``, accurate to ~2^-17 relative) are not carried over: the
kernel reads the f32 grid and matches the f32 ``sdf.trilinear_flat``.
"""

from __future__ import annotations

import numpy as np
import torch

from grad_traj_optimization_torch import _build
from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.utils import profiling


def _bases(grids: torch.Tensor, B: int) -> torch.Tensor | int:
    """Per-scenario offsets into the flat grid buffer (0 when one grid
    serves the whole batch)."""
    if grids.shape[0] == 1:
        return 0
    nvox = grids[0].numel()
    return nvox * torch.arange(B, device=grids.device)[:, None]


def trilinear_batch_plain(grids, origin, resolution, pos):
    """Plain PyTorch version: ``sdf.trilinear_flat`` over the batch."""
    profiling.add("plain.trilinear_batch")
    B = pos.shape[0]
    return sdf.trilinear_flat(
        grids.reshape(-1), _bases(grids, B), tuple(grids.shape[1:]),
        origin[:, None, :], resolution[:, None], pos,
    )


def trilinear_batch(grids, origin, resolution, pos):
    """grids (B or 1, nx, ny, nz), origin (B, 3), resolution (B,),
    pos (B, S, 3), all float32 -> d (B, S), g (B, S, 3).

    CPU tensors take :func:`trilinear_batch_plain`; CUDA tensors launch
    the kernel or raise.
    """
    if pos.device.type == "cpu":
        return trilinear_batch_plain(grids, origin, resolution, pos)
    dev = pos.device
    _build.require_cuda_f32("pos", pos, shape=(None, None, 3))
    B, S = pos.shape[:2]
    _build.require_cuda_f32("grids", grids, shape=(None, None, None, None),
                            device=dev)
    if grids.shape[0] not in (1, B):
        raise ValueError(f"grids leading dim {grids.shape[0]} not 1 or {B}")
    _build.require_cuda_f32("origin", origin, shape=(B, 3), device=dev)
    _build.require_cuda_f32("resolution", resolution, shape=(B,), device=dev)
    nx, ny, nz = grids.shape[1:]
    d = torch.empty((B, S), dtype=torch.float32, device=dev)
    g = torch.empty((B, S, 3), dtype=torch.float32, device=dev)
    if d.numel() == 0:
        return d, g
    lib = _build.load()
    stride = 0 if grids.shape[0] == 1 else nx * ny * nz
    with torch.cuda.device(dev):
        rc = lib.gto_trilinear_batch(
            _build.ptr(grids), stride, nx, ny, nz, _build.ptr(origin),
            _build.ptr(resolution), _build.ptr(pos), B, S, _build.ptr(d),
            _build.ptr(g), _build.stream(pos),
        )
    _build.check(lib, rc, "gto_trilinear_batch")
    profiling.add("launch.trilinear_batch")
    return d, g


#: gto_div's fast path: |a| zero or in [DIV_LO, DIV_HI]
DIV_LO, DIV_HI = 2.0 ** -100, 2.0 ** 100


def div_res_plain(a: np.ndarray, res: float) -> np.ndarray:
    """The lookup's division by res (``gto_div`` in ``csrc/trilinear.cuh``)
    on float32 ``a``, in numpy: where |a| is 0 or in [DIV_LO, DIV_HI],
    q0 = RN(a r) with r = RN(1/res), e = RN(a - q0 res) (one FMA), q =
    -RN(-e r - q0); elsewhere float32 division.

    Float64 holds each product of two float32 values exactly, and a - q0 res
    too (q0 is within about an ulp of a / res, so the difference needs at
    most 50 bits).  The last sum is kept exactly as a float64 pair
    (TwoSum) and rounded to float32 once: the pair's high part rounds as
    the sum does unless it lies on a float32 midpoint, where the low part
    breaks the tie.
    """
    f32, f64 = np.float32, np.float64
    a = np.asarray(a, f32)
    res = f32(res)
    r = f32(1.0) / res
    m = np.abs(a)
    fast = ((m >= DIV_LO) & (m <= DIV_HI)) | (m == 0)
    with np.errstate(all="ignore"):
        q0 = a * r
        e = (a.astype(f64) - q0.astype(f64) * f64(res)).astype(f32)
        x = -(e.astype(f64) * f64(r))
        y = -q0.astype(f64)
        hi = x + y
        bb = hi - x
        lo = (x - (hi - bb)) + (y - bb)
        s = hi.astype(f32)
        sd = s.astype(f64)
        other = np.nextafter(s, np.where(hi > sd, f32(np.inf), f32(-np.inf)))
        tie = np.isfinite(hi) & (hi == (sd + other.astype(f64)) * 0.5)
        s = np.where(tie & (lo != 0) & ((lo > 0) == (other > s)), other, s)
        return np.where(fast, -s, a / res)


def _div_check_plain(res: float, start: int, count: int,
                     chunk: int = 1 << 22) -> np.ndarray:
    out = np.zeros(257, np.int64)
    for lo in range(start, start + count, chunk):
        bits = np.arange(lo, min(lo + chunk, start + count),
                         dtype=np.uint64).astype(np.uint32)
        ex = (bits >> np.uint32(23)) & np.uint32(0xFF)
        fin = ex != 0xFF
        a = bits[fin].view(np.float32)
        with np.errstate(all="ignore"):
            want = (a / np.float32(res)).view(np.uint32)
        differ = div_res_plain(a, res).view(np.uint32) != want
        out[:256] += np.bincount(ex[fin][differ], minlength=256)
        out[256] += int(fin.sum())
    return out


def division_check(res: float, start: int = 0, count: int = 1 << 32,
                   device="cuda") -> dict:
    """Hold the lookup's division by ``res`` against IEEE float32 division
    on the float32 bit patterns ``start .. start + count - 1`` (default:
    all 2^32), infinities and NaNs skipped.

    On ``device`` "cpu" the plain version runs (:func:`div_res_plain`
    against numpy's division); on a CUDA device the check kernel
    ``gto_div_check`` runs ``gto_div`` itself against ``__fdiv_rn``.
    Returns ``checked`` (finite dividends), ``differ`` and
    ``differ_by_exponent`` ({biased exponent field of the dividend:
    count}).
    """
    if start < 0 or count < 0 or start + count > 1 << 32:
        raise ValueError(f"bit patterns {start}..{start + count} outside "
                         "0..2^32")
    device = torch.device(device)
    if device.type == "cpu":
        out = _div_check_plain(res, start, count)
    else:
        counts = torch.zeros(257, dtype=torch.int64, device=device)
        lib = _build.load()
        with torch.cuda.device(device):
            rc = lib.gto_div_check(float(res), start, count,
                                   _build.ptr(counts), _build.stream(counts))
        _build.check(lib, rc, "gto_div_check")
        out = counts.cpu().numpy()
    by_exp = {int(e): int(out[e]) for e in np.flatnonzero(out[:256])}
    return {"checked": int(out[256]), "differ": int(out[:256].sum()),
            "differ_by_exponent": by_exp}
