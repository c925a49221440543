"""K1: the EDT min-plus parabola pass on the GPU.

``out[l, q] = min_v f[l, v] + (q - v)^2`` for every line l: the exact 1-D
parabola lower envelope (reference sdf_map.cpp:266-308) that
``fields.sdf.edt`` / ``edt_batch`` run along y and then x.

Replaces ``grad_traj_optimization_tpu/ops/edt_pallas.py::_minplus_kernel``
(launched by ``minplus_lines`` and ``minplus_axis``).  The CUDA kernel is
``csrc/minplus.cu``; its design note says what bounds it and why it is
bitwise equal to the plain versions.  It reads the lines where they lie,
as a contiguous (O, n, I) view with the line on the middle axis, so
:func:`minplus_along` transforms an axis of a grid in place with no
transposing copy.  Lines of up to :data:`MAX_LINE` cells take the
staged kernel (``gto_minplus_axis``); longer ones the long-line kernel
(``gto_minplus_long``): one block a line, the exact O(n) lower envelope
in integer arithmetic wherever the plain result lies below 2^24 on a line
of integers (every EDT line), and the two-rounding evaluation of the plain
version elsewhere, both in place with no scratch copy of the tensor
(:func:`long_path_counts` says how many lines and outputs took each).
The TPU kernel's TB/TQ tiles and 3e18 padding were VMEM tiling and are
not carried over.
"""

from __future__ import annotations

import math

import torch

from grad_traj_optimization_torch import _build
from grad_traj_optimization_torch.utils import profiling

#: longest line the staged kernel takes, where (q - v)^2 is an exact f32
#: (below 2^24) and one fmaf rounds as the plain f + (q - v)^2 does;
#: longer lines go to the long-line kernel
MAX_LINE = 4096
#: lines of 2^24 cells or more leave q - v inexact in float32
LONG_LINE_LIMIT = 1 << 24


def minplus_lines_plain(f: torch.Tensor, chunk_bytes: int = 1 << 28):
    """Plain PyTorch version: dense broadcast-add-min over v, chunked so
    that a block of lines times the (n, n) parabola stays under
    ``chunk_bytes``."""
    profiling.add("plain.minplus_lines")
    B, n = f.shape
    q = torch.arange(n, dtype=f.dtype, device=f.device)
    sq = (q[:, None] - q[None, :]) ** 2  # (q, v)
    tb = max(1, min(B, chunk_bytes // (4 * n * n)))
    out = torch.empty_like(f)
    for i in range(0, B, tb):
        out[i:i + tb] = torch.amin(f[i:i + tb, None, :] + sq, dim=-1)
    return out


def minplus_along_plain(sq: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`minplus_along`, out of place: move
    ``dim`` last, run :func:`minplus_lines_plain` over the lines, move it
    back."""
    moved = sq.movedim(dim, -1).contiguous()
    shape = moved.shape
    out = minplus_lines_plain(moved.reshape(-1, shape[-1]))
    return out.reshape(shape).movedim(-1, dim)


def minplus_long(src: torch.Tensor, dst: torch.Tensor, O: int, n: int,
                 I: int) -> None:
    """Launch the long-line kernel (``gto_minplus_long``) on a contiguous
    (O, n, I) CUDA view; ``dst`` may be ``src`` (in place).
    :func:`minplus_lines` and :func:`minplus_along` call it for lines
    longer than :data:`MAX_LINE`; the counter ``launch.minplus_long``
    (``utils.profiling``) says how often.

    A block stages its line in shared memory, so no scratch is allocated
    while a line fits there (27 904 cells); a longer line takes one global
    slot of 10 bytes a cell for each resident block."""
    if n >= LONG_LINE_LIMIT:
        raise ValueError(f"line length {n} >= {LONG_LINE_LIMIT}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("minplus_long: src and dst must be contiguous")
    lib = _build.load()
    with torch.cuda.device(src.device):
        nbytes = lib.gto_minplus_long_scratch(n, O * I)
        scratch = (torch.empty(nbytes, dtype=torch.uint8, device=src.device)
                   if nbytes else None)
        rc = lib.gto_minplus_long(
            _build.ptr(src), _build.ptr(dst),
            None if scratch is None else _build.ptr(scratch),
            _build.ptr(_path_counts(src.device)), O, n, I,
            _build.stream(src))
    _build.check(lib, rc, "gto_minplus_long")
    profiling.add("launch.minplus_long")


#: the long-line kernel's own counters, one int64 tensor of 4 a card:
#: lines and outputs on the integer path, then on the two-rounding path
_COUNTS: dict = {}
_PATH_KEYS = ("lines_integer", "outputs_integer", "lines_dense",
             "outputs_dense")


def _path_counts(device: torch.device) -> torch.Tensor:
    if device not in _COUNTS:
        _COUNTS[device] = torch.zeros(4, dtype=torch.int64, device=device)
    return _COUNTS[device]


def long_path_counts(device=None) -> dict:
    """The lines and outputs the long-line kernel has sent down each path
    on ``device`` (default: the current card) since the last
    :func:`reset_long_path_counts`; reading them synchronises."""
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counts = _path_counts(device).tolist()
    return dict(zip(_PATH_KEYS, counts))


def reset_long_path_counts() -> None:
    """Zero the long-line kernel's path counters on every card."""
    for counts in _COUNTS.values():
        counts.zero_()


def _launch(src: torch.Tensor, dst: torch.Tensor, O: int, n: int, I: int):
    if n > MAX_LINE:
        return minplus_long(src, dst, O, n, I)
    lib = _build.load()
    with torch.cuda.device(src.device):
        rc = lib.gto_minplus_axis(_build.ptr(src), _build.ptr(dst), O, n, I,
                                  _build.stream(src))
    _build.check(lib, rc, "gto_minplus_axis")


def minplus_lines(f: torch.Tensor) -> torch.Tensor:
    """(L, n) float32 lines -> a new (L, n) min-plus transform.

    CPU tensors take :func:`minplus_lines_plain`; CUDA tensors launch the
    kernel (building it at first use) or raise.
    """
    if f.device.type == "cpu":
        return minplus_lines_plain(f)
    _build.require_cuda_f32("f", f, shape=(None, None))
    out = torch.empty_like(f)
    if f.numel() == 0:
        return out
    _launch(f, out, f.shape[0], f.shape[1], 1)
    profiling.add("launch.minplus_lines")
    return out


def minplus_along(sq: torch.Tensor, dim: int) -> torch.Tensor:
    """Min-plus transform of ``sq`` along ``dim``, in place; returns
    ``sq``.

    A CUDA tensor must be contiguous float32: one kernel launch reads it
    as (prod(shape[:dim]), shape[dim], prod(shape[dim+1:])).  A CPU
    tensor takes :func:`minplus_along_plain` and is overwritten with its
    result.
    """
    if sq.device.type == "cpu":
        return sq.copy_(minplus_along_plain(sq, dim))
    _build.require_cuda_f32("sq", sq)
    dim = dim % sq.dim()
    if sq.numel() == 0:
        return sq
    _launch(sq, sq, math.prod(sq.shape[:dim]), sq.shape[dim],
            math.prod(sq.shape[dim + 1:]))
    profiling.add("launch.minplus_along")
    return sq
