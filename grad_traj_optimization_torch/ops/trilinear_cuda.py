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

import torch

from grad_traj_optimization_torch import _build
from grad_traj_optimization_torch.fields import sdf


def _bases(grids: torch.Tensor, B: int) -> torch.Tensor | int:
    """Per-scenario offsets into the flat grid buffer (0 when one grid
    serves the whole batch)."""
    if grids.shape[0] == 1:
        return 0
    nvox = grids[0].numel()
    return nvox * torch.arange(B, device=grids.device)[:, None]


def trilinear_batch_plain(grids, origin, resolution, pos):
    """Plain PyTorch version: ``sdf.trilinear_flat`` over the batch."""
    trilinear_batch_plain.calls += 1
    B = pos.shape[0]
    return sdf.trilinear_flat(
        grids.reshape(-1), _bases(grids, B), tuple(grids.shape[1:]),
        origin[:, None, :], resolution[:, None], pos,
    )


trilinear_batch_plain.calls = 0


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
    rc = lib.gto_trilinear_batch(
        _build.ptr(grids), stride, nx, ny, nz, _build.ptr(origin),
        _build.ptr(resolution), _build.ptr(pos), B, S, _build.ptr(d),
        _build.ptr(g), _build.stream(pos),
    )
    _build.check(lib, rc, "gto_trilinear_batch")
    trilinear_batch.launches += 1
    return d, g


trilinear_batch.launches = 0
