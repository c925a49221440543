"""Spatially sharded Euclidean distance transform (port of
``grad_traj_optimization_tpu.parallel.edt_sharded``).

For large grids (the stress configuration, 512^3 = 537 MB float32) the
voxel grid is split along x over the mesh's "space" axis, one x-slab a
process.  The three separable EDT passes then split into:

* the z pass and the y pass (K1): every line lies inside one slab, so
  both are local;
* the x pass: the scanned axis is the split one.  The JAX package rotates
  the slabs around a ring (``_ring_minplus_x``) and folds a dense
  (nxl, nxl) parabola block at each hop; eager, that block is
  nxl * nxl * ny * nz elements (17 GB at 512^3 on 4 cards).  Here an
  all-to-all transposes the slabs into whole x lines over a share of the
  y columns, K1 runs along x in place, and a second all-to-all
  transposes back (:func:`_alltoall_minplus_x`).

The squared distances are integers below 2^24 and every min-plus
candidate is computed as in the one-device pass, so the result is
bitwise the port's ``sdf.edt`` of the whole grid.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from grad_traj_optimization_torch.fields import sdf
from grad_traj_optimization_torch.ops import edt_cuda
from grad_traj_optimization_torch.parallel.mesh import local_device

#: P("space", None, None): x-slabs split over "space", replicated over
#: "data"
SLABS = (Replicate(), Shard(0))


def _local_passes(occ_local):
    """z then y squared-distance passes (local to the slab); the y pass
    is one K1 launch, in place."""
    sq = sdf._nearest_sq_1d(occ_local, dim=-1)
    return edt_cuda.minplus_along(sq, dim=-2)


def _alltoall_minplus_x(sq_local, group, p: int):
    """Min-plus along the split x axis, exact; the counterpart of the JAX
    package's ring rotation ``_ring_minplus_x``.

    ``sq_local`` (nxl, ny, nz) is this process's x-slab.  The first
    all-to-all sends process j the slab's y columns of share j, so each
    process holds whole x lines (p * nxl, ny_j, nz), sources in rank order
    along x; K1 transforms them along x in place (one launch); the second
    all-to-all sends each block back to the slab it came from.  Each
    process moves 2 (p - 1) / p of its slab, against the ring's p - 1
    slabs.  Returns the transformed slab (a new tensor for p > 1).
    """
    if p == 1:
        return edt_cuda.minplus_along(sq_local, dim=0)
    nxl, ny, nz = sq_local.shape
    me = dist.get_rank(group)
    # y columns of each share: as even as it goes, the first ny % p one more
    cols = [ny // p + (j < ny % p) for j in range(p)]
    out_sizes = [nxl * c * nz for c in cols]      # this slab, by share
    in_sizes = [nxl * cols[me] * nz] * p          # share me, by slab
    send = torch.cat([blk.reshape(-1)
                      for blk in sq_local.split(cols, dim=1)])
    lines = torch.empty(sum(in_sizes), dtype=send.dtype, device=send.device)
    dist.all_to_all_single(lines, send, output_split_sizes=in_sizes,
                           input_split_sizes=out_sizes, group=group)
    if lines.numel():
        edt_cuda.minplus_along(lines.view(p * nxl, cols[me], nz), dim=0)
    back = torch.empty_like(send)
    dist.all_to_all_single(back, lines, output_split_sizes=out_sizes,
                           input_split_sizes=in_sizes, group=group)
    return torch.cat([blk.view(nxl, c, nz)
                      for blk, c in zip(back.split(out_sizes), cols)],
                     dim=1)


def _slab(x, mesh: DeviceMesh, sl: slice, dev: torch.device):
    if isinstance(x, DTensor):
        return x.redistribute(mesh, SLABS).to_local()
    if isinstance(x, torch.Tensor):
        return x[sl]
    return torch.as_tensor(x[sl], device=dev)


def edt_sharded(occ, resolution: float, mesh: DeviceMesh, prev_dist=None):
    """EDT of an (nx, ny, nz) occupancy grid split along x over the mesh's
    "space" axis.

    Args:
      occ: the whole grid (numpy or a tensor, the same on every process)
        or a DTensor; each process transforms its x-slab.
      prev_dist: optional previous distance buffer, placed as ``occ``;
        the result is then its minimum with the new distance, as
        ``sdf.edt``.
    Returns:
      a DTensor of the distance in meters, x-slabs over "space"
      (``SLABS``), bitwise ``sdf.edt`` of the whole grid.  Two K1
      launches a process.
    """
    n_space = mesh["space"].size()
    nx = occ.shape[0]
    if nx % n_space:
        raise ValueError(f"nx {nx} not divisible by space axis {n_space}")
    nxl = nx // n_space
    r = mesh.get_local_rank("space")
    sl = slice(r * nxl, (r + 1) * nxl)
    dev = local_device(mesh)
    sq = _local_passes(_slab(occ, mesh, sl, dev))
    sq = _alltoall_minplus_x(sq, mesh.get_group("space"), n_space)
    prev = None if prev_dist is None else _slab(prev_dist, mesh, sl, dev)
    return DTensor.from_local(sdf._distance(sq, resolution, prev), mesh,
                              SLABS)
