"""Occupancy grid, exact Euclidean distance transform, trilinear lookup
(port of ``grad_traj_optimization_tpu.fields.sdf``).

Rebuild of the reference ``SDFMap`` (src/sdf_map.cpp):

* distances are unsigned; occupied cells get 0 (sdf_map.cpp:313-319);
* the separable passes run z, then y, then x; z is the binary
  nearest-occupied pass (two ``cummin`` scans), y and x are the min-plus
  parabola pass, kernel K1 (``ops/edt_cuda.py``) on the GPU;
* metric distance is ``min(resolution * sqrt(sq), 10000)``
  (sdf_map.cpp:22, 358-360);
* out-of-map queries give -1, with a 1e-4 in-map margin on every face
  (sdf_map.cpp:55-69, 187);
* trilinear sampling shifts the query by -resolution/2 and clamps corner
  indices to the grid (sdf_map.cpp:185-242).

Grid layout is (nx, ny, nz), x-major, with optional leading batch axes.
"""

from __future__ import annotations

import torch

from grad_traj_optimization_torch.ops import edt_cuda

#: "no obstacle" distance in cells: resolution * BIG_CELLS far exceeds
#: the 10000 m cap while BIG_CELLS^2 stays well inside f32
BIG_CELLS = 1.0e6
#: reference distance-buffer initialization (sdf_map.cpp:22)
FREE_DIST = 10000.0


def _res_tensor(resolution, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(resolution, dtype=like.dtype, device=like.device)


def pos_to_index(pos, origin, resolution):
    """floor((pos - origin) / resolution) as int64 (reference posToIndex,
    sdf_map.cpp:71-74).  ``resolution`` broadcasts against ``pos``."""
    return torch.floor((pos - origin) / resolution).to(torch.int64)


def in_map(pos, origin, resolution, grid_shape):
    """Reference isInMap with its 1e-4 margins (sdf_map.cpp:55-69).

    pos (..., 3); origin broadcastable to pos; resolution a scalar or a
    tensor broadcastable to pos.shape[:-1].
    """
    res = _res_tensor(resolution, pos)
    size = torch.tensor(grid_shape, dtype=pos.dtype, device=pos.device)
    size = size * (res[..., None] if res.dim() else res)
    lo = origin + 1e-4
    hi = origin + size - 1e-4
    return torch.all((pos > lo) & (pos < hi), dim=-1)


def rasterize(points, origin, resolution, grid_shape, valid_mask=None):
    """Scatter obstacle points into dense occupancy grids.

    Replaces the reference's per-point setOccupancy loop
    (sdf_map.cpp:80-99) with one ``scatter_reduce`` (amax).  Out-of-map
    points and points with ``valid_mask`` False are dropped.

    Args:
      points: (..., N, 3) positions; leading axes are scenarios.
      origin: (3,) or broadcastable to points.
      valid_mask: optional (..., N) bool.
    Returns:
      (..., nx, ny, nz) float32 occupancy in {0, 1}.
    """
    origin = torch.as_tensor(origin, dtype=points.dtype, device=points.device)
    nx, ny, nz = grid_shape
    nvox = nx * ny * nz
    lead = points.shape[:-2]
    idx = pos_to_index(points, origin, resolution)
    ok = in_map(points, origin, resolution, grid_shape)
    if valid_mask is not None:
        ok = ok & valid_mask
    flat = (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]
    flat = torch.where(ok, flat, 0)  # a dropped point adds max(., 0)
    n_grids = 1
    for s in lead:
        n_grids *= s
    flat = flat.reshape(n_grids, -1) + nvox * torch.arange(
        n_grids, device=points.device
    )[:, None]
    occ = torch.zeros(n_grids * nvox, dtype=torch.float32,
                      device=points.device)
    occ.scatter_reduce_(
        0, flat.reshape(-1), ok.reshape(-1).to(torch.float32), reduce="amax"
    )
    return occ.reshape(*lead, nx, ny, nz)


def _nearest_sq_1d(occ, dim: int):
    """Squared cell distance to the nearest occupied cell along ``dim``,
    exact, from a forward and a backward ``cummin`` scan.

    For binary input the parabola transform is the plain nearest
    distance: min_v (q - v)^2 over occupied v is (nearest occupied)^2.

    The scans run with ``dim`` moved to the front. PyTorch's CUDA cummin
    along the innermost axis of short lines is slow. For the bench's
    1024 x 100 x 100 x 25 z pass on an NVIDIA H100 (700 W), the pass took
    205.7 ms that way and 16.3 ms this way, with bitwise equal results.
    The last square writes straight into a contiguous tensor in the
    input's layout, so the min-plus passes read it in place.
    """
    pen = torch.where(occ > 0.5, 0.0, BIG_CELLS).to(torch.float32)
    pen = pen.movedim(dim, 0).contiguous()
    n = pen.shape[0]
    i = torch.arange(n, dtype=pen.dtype, device=pen.device).reshape(
        (n,) + (1,) * (pen.dim() - 1)
    )
    fwd = i + torch.cummin(pen - i, dim=0).values
    bwd = -i + torch.flip(
        torch.cummin(torch.flip(pen + i, (0,)), dim=0).values, (0,)
    )
    d = torch.minimum(fwd, bwd)
    out = torch.empty(occ.shape, dtype=pen.dtype, device=pen.device)
    torch.mul(d, d, out=out.movedim(dim, 0))
    return out


#: the plain version of K1 (kept under the JAX package's name)
_minplus_parabola_lines = edt_cuda.minplus_lines_plain


def _squared_edt(occ):
    """Squared cell EDT of (..., nx, ny, nz) occupancy: the z pass, then
    K1 along y and along x, in place on the z pass's contiguous result."""
    sq = _nearest_sq_1d(occ, dim=-1)
    edt_cuda.minplus_along(sq, dim=-2)
    return edt_cuda.minplus_along(sq, dim=-3)


def _metric(sq, resolution: float):
    """resolution * sqrt(sq) in float32 with a correctly rounded sqrt.

    PyTorch's vectorized CPU float32 sqrt can land one ulp off; a float64
    sqrt rounded to float32 is exactly the correctly rounded result (53
    bits exceed twice 24 plus 2), so the field is bitwise the JAX
    package's on every device."""
    return resolution * torch.sqrt(sq.double()).float()


def edt(occ, resolution: float, prev_dist=None):
    """Exact unsigned EDT of one (nx, ny, nz) grid, in meters.

    Reference SDFMap::updateESDF3d (sdf_map.cpp:310-368): the final
    distance is ``min(resolution * sqrt(sq), prev)``, prev = 10000 unless
    a previous buffer is given.
    """
    dist = _metric(_squared_edt(occ), resolution)
    if prev_dist is None:
        return torch.clamp(dist, max=FREE_DIST)
    return torch.minimum(dist, prev_dist)


def edt_batch(occ, resolution: float):
    """EDT of (B, nx, ny, nz) grids: the batch folds into the line axis
    of each pass, so each pass is one K1 launch for the whole batch."""
    return torch.clamp(_metric(_squared_edt(occ), resolution),
                       max=FREE_DIST)


def _minplus_lines_vs(f, sq, chunk_bytes: int = 1 << 28):
    """out[b, q] = min_v (f[b, v] + sq[q, v]): the min-plus of line
    sources against an (n_out, n_src) squared-offset matrix, so sources
    and outputs may lie on different index ranges; chunked over lines to
    bound memory.  Plain PyTorch (not K1: K1's sources and outputs share
    one index range)."""
    B, w = f.shape
    n_out = sq.shape[0]
    tb = max(1, min(B, chunk_bytes // (4 * n_out * max(w, 1))))
    out = torch.empty((B, n_out), dtype=f.dtype, device=f.device)
    for b0 in range(0, B, tb):
        out[b0:b0 + tb] = torch.amin(f[b0:b0 + tb, None, :] + sq[None],
                                     dim=-1)
    return out


def _sq_offsets(out_lo, out_hi, src_lo, src_hi, device=None):
    """(q - v)^2 in float32 between the output range [out_lo, out_hi) and
    the source range [src_lo, src_hi) (integers, so exact)."""
    q = torch.arange(out_lo, out_hi, dtype=torch.float32, device=device)
    v = torch.arange(src_lo, src_hi, dtype=torch.float32, device=device)
    return (q[:, None] - v[None, :]) ** 2


def edt_update(prev_dist, occ, resolution, lo: tuple, hi: tuple,
               mode: str = "add", out_margin: int | None = None,
               chunk_bytes: int = 1 << 28):
    """Region-limited incremental ESDF update (the reference's windowed
    map update: setUpdateRange sdf_map.cpp:244-262, resetBuffer :26-53,
    the sweep bounds of updateESDF3d :311-364).  Each separable pass is a
    windowed min-plus, sources in the box ``[lo, hi)`` along the scanned
    axis and outputs over the influence range.

    * ``"add"`` returns ``min(prev_dist, distance to the box's
      occupancy)`` over the output window (the reference's min with the
      old buffer, sdf_map.cpp:358-360).  The squared offsets are integers
      in float32 and the metric is :func:`_metric`'s, so with edits that
      only ADD occupied cells inside the box and ``out_margin`` None (or
      at least max(prev_dist) / resolution cells) the result is bitwise
      a full :func:`edt` of ``occ``.
    * ``"reset"`` recomputes the box from in-box occupancy only (the
      reference's literal windowed rebuild); cells outside the box are
      untouched.

    ``prev_dist`` and ``occ`` are (nx, ny, nz) on one device; returns a
    new float32 field there.
    """
    grid = tuple(prev_dist.shape)
    prev = prev_dist.to(torch.float32)
    lo = tuple(int(max(0, v)) for v in lo)
    hi = tuple(int(min(g, v)) for v, g in zip(hi, grid))
    if mode not in ("add", "reset"):
        raise ValueError(f"unknown edt_update mode {mode!r}")
    if any(h <= lo_ for lo_, h in zip(lo, hi)):
        return prev.clone()
    if mode == "reset":
        o_lo, o_hi = lo, hi
    elif out_margin is None:
        o_lo, o_hi = (0, 0, 0), grid
    else:
        m = int(out_margin)
        o_lo = tuple(max(0, v - m) for v in lo)
        o_hi = tuple(min(g, v + m) for v, g in zip(hi, grid))

    dev = prev.device
    box = occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    f = torch.where(box > 0.5, 0.0, BIG_CELLS ** 2).to(torch.float32)
    wx, wy, wz = f.shape
    onx, ony, onz = (h - lo_ for lo_, h in zip(o_lo, o_hi))
    # pass 1 (z): lines over the box's (x, y) footprint
    g = _minplus_lines_vs(f.reshape(wx * wy, wz),
                          _sq_offsets(o_lo[2], o_hi[2], lo[2], hi[2], dev),
                          chunk_bytes).reshape(wx, wy, onz)
    # pass 2 (y)
    g = g.transpose(1, 2).reshape(wx * onz, wy)
    g = _minplus_lines_vs(g, _sq_offsets(o_lo[1], o_hi[1], lo[1], hi[1],
                                         dev), chunk_bytes)
    g = g.reshape(wx, onz, ony).transpose(1, 2)  # (wx, ony, onz)
    # pass 3 (x)
    g = g.permute(1, 2, 0).reshape(ony * onz, wx)
    g = _minplus_lines_vs(g, _sq_offsets(o_lo[0], o_hi[0], lo[0], hi[0],
                                         dev), chunk_bytes)
    g = g.reshape(ony, onz, onx).permute(2, 0, 1)  # (onx, ony, onz)

    d_box = torch.clamp(_metric(g, resolution), max=FREE_DIST)
    out = prev.clone()
    region = out[o_lo[0]:o_hi[0], o_lo[1]:o_hi[1], o_lo[2]:o_hi[2]]
    if mode == "add":
        d_box = torch.minimum(d_box, region)
    region.copy_(d_box)
    return out


def edt_brute_force(occ, resolution: float):
    """O(N^2) all-pairs EDT for testing tiny grids only."""
    grid_shape = occ.shape
    coords = torch.stack(torch.meshgrid(
        *(torch.arange(s, device=occ.device) for s in grid_shape),
        indexing="ij"), dim=-1).reshape(-1, 3)
    occf = occ.reshape(-1) > 0.5
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1).to(
        torch.float32)
    d2 = torch.where(occf[None, :], d2, BIG_CELLS**2)
    # float64 sqrt rounded once to float32: the correctly rounded root
    dist = resolution * torch.sqrt(d2.amin(dim=1).double()).float()
    return torch.clamp(dist, max=FREE_DIST).reshape(grid_shape)


def max_distance(dist):
    """Reference getMaxDistance (sdf_map.cpp:423-431)."""
    return dist.max()


def distance_at(dist, origin, resolution, pos):
    """Nearest-cell distance; -1 out of map (sdf_map.cpp:155-164)."""
    origin = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    nx, ny, nz = dist.shape
    ok = in_map(pos, origin, resolution, dist.shape)
    idx = pos_to_index(pos, origin, resolution)
    ix = idx[..., 0].clamp(0, nx - 1)
    iy = idx[..., 1].clamp(0, ny - 1)
    iz = idx[..., 2].clamp(0, nz - 1)
    d = dist.reshape(-1)[(ix * ny + iy) * nz + iz]
    return torch.where(ok, d, -1.0)


def trilinear_flat(flat, base, grid_shape, origin, resolution, pos):
    """Trilinear distance + gradient against a flat field buffer.

    ``flat`` may hold many grids back to back; ``base`` (an int, or an
    int tensor broadcastable to ``pos.shape[:-1]``) is each query's grid
    offset.  ``origin`` broadcasts against ``pos`` (..., 3) and
    ``resolution`` against ``pos.shape[:-1]``.  Returns d (...,) and g
    (..., 3); out of map gives (-1, 0).

    This is the plain version of kernel K2 (``ops/trilinear_cuda.py``):
    the kernel runs the same operations in the same order.
    """
    origin = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    res = _res_tensor(resolution, pos)
    res3 = res[..., None] if res.dim() else res
    ok = in_map(pos, origin, res, grid_shape)

    pos_m = pos - 0.5 * res3
    idx = pos_to_index(pos_m, origin, res3)
    idx_pos = (idx.to(pos.dtype) + 0.5) * res3 + origin
    diff = (pos - idx_pos) / res3  # in [0, 1)

    nx, ny, nz = grid_shape
    cx = [idx[..., 0].clamp(0, nx - 1), (idx[..., 0] + 1).clamp(0, nx - 1)]
    cy = [idx[..., 1].clamp(0, ny - 1), (idx[..., 1] + 1).clamp(0, ny - 1)]
    cz = [idx[..., 2].clamp(0, nz - 1), (idx[..., 2] + 1).clamp(0, nz - 1)]
    v = [
        [[flat[base + (cx[a] * ny + cy[b]) * nz + cz[c]] for c in (0, 1)]
         for b in (0, 1)]
        for a in (0, 1)
    ]
    dx_, dy_, dz_ = diff[..., 0], diff[..., 1], diff[..., 2]

    # x-interpolation first, then y, then z (reference order, :221-229)
    v00 = (1 - dx_) * v[0][0][0] + dx_ * v[1][0][0]
    v01 = (1 - dx_) * v[0][0][1] + dx_ * v[1][0][1]
    v10 = (1 - dx_) * v[0][1][0] + dx_ * v[1][1][0]
    v11 = (1 - dx_) * v[0][1][1] + dx_ * v[1][1][1]
    v0 = (1 - dy_) * v00 + dy_ * v10
    v1 = (1 - dy_) * v01 + dy_ * v11
    d = (1 - dz_) * v0 + dz_ * v1

    gz = (v1 - v0) / res
    gy = ((1 - dz_) * (v10 - v00) + dz_ * (v11 - v01)) / res
    gx = (
        (1 - dz_) * (1 - dy_) * (v[1][0][0] - v[0][0][0])
        + (1 - dz_) * dy_ * (v[1][1][0] - v[0][1][0])
        + dz_ * (1 - dy_) * (v[1][0][1] - v[0][0][1])
        + dz_ * dy_ * (v[1][1][1] - v[0][1][1])
    ) / res

    g = torch.stack([gx, gy, gz], dim=-1)
    d = torch.where(ok, d, -1.0)
    g = torch.where(ok[..., None], g, 0.0)
    return d, g


def distance_and_gradient(dist, origin, resolution, pos):
    """Trilinear distance + gradient against one (nx, ny, nz) grid."""
    return trilinear_flat(
        dist.reshape(-1), 0, dist.shape, origin, resolution, pos
    )
