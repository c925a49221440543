"""K1: the EDT min-plus parabola pass on the GPU.

``out[b, q] = min_v f[b, v] + (q - v)^2`` for every line b: the exact 1-D
parabola lower envelope (reference sdf_map.cpp:266-308) that
``fields.sdf.edt`` / ``edt_batch`` run along y and then x.

Replaces ``grad_traj_optimization_tpu/ops/edt_pallas.py::_minplus_kernel``
(launched by ``minplus_lines``).  The CUDA kernel is ``csrc/minplus.cu``;
its design note says what bounds it and why it is bitwise equal to
:func:`minplus_lines_plain`.  The TPU kernel's TB/TQ tiles and 3e18
padding were VMEM tiling and are not carried over.
"""

from __future__ import annotations

import torch

from grad_traj_optimization_torch import _build

#: longest line the kernel takes: (q - v)^2 stays an exact f32 below 2^24
MAX_LINE = 4096


def minplus_lines_plain(f: torch.Tensor, chunk_bytes: int = 1 << 28):
    """Plain PyTorch version: dense broadcast-add-min over v, chunked so
    that a block of lines times the (n, n) parabola stays under
    ``chunk_bytes``."""
    minplus_lines_plain.calls += 1
    B, n = f.shape
    q = torch.arange(n, dtype=f.dtype, device=f.device)
    sq = (q[:, None] - q[None, :]) ** 2  # (q, v)
    tb = max(1, min(B, chunk_bytes // (4 * n * n)))
    out = torch.empty_like(f)
    for i in range(0, B, tb):
        out[i:i + tb] = torch.amin(f[i:i + tb, None, :] + sq, dim=-1)
    return out


minplus_lines_plain.calls = 0


def minplus_lines(f: torch.Tensor) -> torch.Tensor:
    """(L, n) float32 lines -> (L, n) min-plus transform.

    CPU tensors take :func:`minplus_lines_plain`; CUDA tensors launch the
    kernel (building it at first use) or raise.
    """
    if f.device.type == "cpu":
        return minplus_lines_plain(f)
    _build.require_cuda_f32("f", f, shape=(None, None))
    n_lines, n = f.shape
    if n > MAX_LINE:
        raise ValueError(f"line length {n} > {MAX_LINE}")
    out = torch.empty_like(f)
    if f.numel() == 0:
        return out
    lib = _build.load()
    rc = lib.gto_minplus_lines(
        _build.ptr(f), _build.ptr(out), n_lines, n, _build.stream(f)
    )
    _build.check(lib, rc, "gto_minplus_lines")
    minplus_lines.launches += 1
    return out


minplus_lines.launches = 0
