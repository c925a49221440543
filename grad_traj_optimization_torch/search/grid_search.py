"""Grid path search by wavefront value iteration (port of
``grad_traj_optimization_tpu.search.grid_search``).

The reference's 26-connected grid A* (a_star.{h,cpp}) as a parallel
Bellman relaxation: each sweep relaxes every voxel against its 26
neighbours at once, until the fixpoint, where the cost-to-go field holds
the Dijkstra distances and the greedy descent is a shortest grid path.
The output contract is the reference's:

* clearance gating: voxels with EDT distance < 0.4 m are obstacles
  (a_star.cpp:233);
* 26-connectivity with Euclidean step costs (a_star.cpp:241-243);
* the path is cell-centre coordinates from start to goal
  (a_star.cpp:276-283).

Plain PyTorch on the device of the field (the JAX package computes this
with ``jax.lax`` loops outside any Pallas kernel).  The results are
bitwise the JAX package's: at the fixpoint each cell holds the minimum
over paths of float32 step sums, which no sweep order changes, and the
walk breaks ties at the first minimal neighbour, as ``jnp.argmin`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grad_traj_optimization_torch import _device

#: float32 infinity, the JAX package's public constant (its module, like
#: this one, marks unreachable cells with 1e18, not with INF)
INF = float("inf")

#: the 26 neighbour offsets and their Euclidean step costs (in cells)
_OFFSETS = np.array(
    [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) != (0, 0, 0)
    ],
    dtype=np.int32,
)
_STEP_COST = np.linalg.norm(_OFFSETS, axis=1).astype(np.float32)
#: the float32 step costs of a face, edge and corner neighbour
_FACE, _EDGE, _CORNER = (float(_STEP_COST[k]) for k in (4, 1, 0))
#: the unreached/blocked sentinel, a float32 value
_BIG = float(np.float32(1e18))


class GridPlan(NamedTuple):
    path: torch.Tensor        # (max_len, 3) world coordinates, padded
    length: torch.Tensor      # () int32 number of valid path points
    reached: torch.Tensor     # () bool: start connected to goal
    cost_to_go: torch.Tensor  # (nx, ny, nz) converged Dijkstra field
    converged: torch.Tensor   # () bool: value iteration hit its fixpoint


def _neighbour_scores(g: torch.Tensor, costs: torch.Tensor) -> torch.Tensor:
    """(26, nx, ny, nz): each cell's neighbour value plus the step cost,
    in ``_OFFSETS`` order, ``_BIG`` (+ cost) outside the grid.  ``g`` is
    padded once and the 26 neighbours are slices of the padded buffer."""
    nx, ny, nz = g.shape
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1, 1, 1), value=_BIG)
    nbrs = torch.stack([gp[1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny,
                           1 + dz:1 + dz + nz]
                        for dx, dy, dz in _OFFSETS.tolist()])
    return nbrs + costs[:, None, None, None]


def _sweep(g, blocked):
    """One Jacobi relaxation of every cell against its 26 neighbours.

    The neighbours split by step cost into 6 faces (1), 12 edges (sqrt 2)
    and 8 corners (sqrt 3); each class's minimum comes from separable
    pairwise minima of the padded field, and its cost is added once.
    Float32 rounding is monotone, so min(x_k) + c rounds to min(x_k + c):
    the result is bitwise the 26-way relaxation's."""
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1, 1, 1), value=_BIG)
    mn = torch.minimum
    ax = mn(gp[:-2], gp[2:])                      # x +-1
    ay = mn(gp[1:-1, :-2], gp[1:-1, 2:])          # y +-1, x centre
    axy = mn(ax[:, :-2], ax[:, 2:])               # x +-1 and y +-1
    faces = mn(mn(ax[:, 1:-1, 1:-1], ay[:, :, 1:-1]),
               mn(gp[1:-1, 1:-1, :-2], gp[1:-1, 1:-1, 2:]))
    edges = mn(mn(axy[:, :, 1:-1], mn(ax[:, 1:-1, :-2], ax[:, 1:-1, 2:])),
               mn(ay[:, :, :-2], ay[:, :, 2:]))
    corners = mn(axy[:, :, :-2], axy[:, :, 2:])
    best = mn(mn(g, faces + _FACE), mn(edges + _EDGE, corners + _CORNER))
    return torch.where(blocked, _BIG, best)


def cost_to_go(blocked, goal_idx, max_sweeps: int | None = None):
    """Dijkstra cost-to-go field (in cell units) by value iteration.

    Sweeps run 8 at a time, with one host read after each 8 to test the
    fixpoint (no cell dropped by more than 1e-6).  ``max_sweeps`` is only
    a runaway bound; its default is the cell count + 8, the true worst
    case for a shortest path (a maze path can visit nearly every cell).
    Returns (field, converged); an unconverged field underestimates
    nothing but may leave reachable cells at the sentinel value.

    Args:
      blocked: (nx, ny, nz) bool tensor.
      goal_idx: (3,) int goal cell.
    """
    if max_sweeps is None:
        max_sweeps = blocked.numel() + 8
    dev = blocked.device
    g = torch.full(blocked.shape, _BIG, dtype=torch.float32, device=dev)
    g[tuple(int(i) for i in goal_idx)] = 0.0
    g = torch.where(blocked, _BIG, g)
    changed, it = True, 0
    while changed and it < max_sweeps:
        g2 = g
        for _ in range(8):
            g2 = _sweep(g2, blocked)
        changed = bool((g2 < g - 1e-6).any())
        g, it = g2, it + 8
    return g, torch.tensor(not changed, device=dev)


def _wrap_clamp(cells: torch.Tensor, shape) -> torch.Tensor:
    """The cell a JAX gather reads at integer index ``cells``: negative
    indices wrap once, then every index clamps into the grid."""
    n = torch.as_tensor(shape, device=cells.device)
    return torch.minimum(torch.where(cells < 0, cells + n, cells).clamp(
        min=0), n - 1)


def _walk_tail(g_host: np.ndarray, idx: np.ndarray, steps: int):
    """The JAX package's walk step by step on the host, from a cell that
    may lie outside the grid (a walk leaves it only from an unreached
    start, where every score is the sentinel).  Returns (steps, 3)."""
    shape = np.asarray(g_host.shape)
    out = np.empty((steps, 3), np.int64)
    for t in range(steps):
        nbr = idx[None, :] + _OFFSETS
        ok = np.all((nbr >= 0) & (nbr < shape), axis=1)
        c = np.clip(nbr, 0, shape - 1)
        gn = np.where(ok, g_host[c[:, 0], c[:, 1], c[:, 2]],
                      np.float32(_BIG))
        h = np.minimum(np.where(idx < 0, idx + shape, idx).clip(0), shape - 1)
        if g_host[h[0], h[1], h[2]] > 0.0:
            idx = nbr[int(np.argmin(gn + _STEP_COST))].astype(np.int64)
        out[t] = idx
    return out


def extract_path(g, start_idx, origin, resolution, max_len: int = 512):
    """Greedy steepest-descent walk on the cost-to-go field.

    Every cell's successor (the first of its 26 neighbours minimising
    neighbour value + step cost; itself where ``g <= 0``) is computed
    once, and the walk from ``start_idx`` is filled by pointer doubling,
    ceil(log2(max_len)) rounds.  A walk that steps out of the grid (only
    from an unreached start) is finished on the host, as the JAX package
    walks it.

    Returns world-coordinate cell centres from start to goal, padded by
    repeating the final point, and the number of valid points.
    """
    dev = g.device
    nx, ny, nz = g.shape
    n = g.numel()
    costs = torch.as_tensor(_STEP_COST, device=dev)
    k = _neighbour_scores(g, costs).argmin(dim=0)  # first minimal index
    offs = torch.as_tensor(_OFFSETS, dtype=torch.int64, device=dev)
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(s, device=dev) for s in g.shape), indexing="ij"),
        dim=-1)
    nxt = cell + offs[k]
    inside = ((nxt >= 0) & (nxt < torch.as_tensor(g.shape, device=dev))
              ).all(dim=-1)
    flat = (nxt[..., 0] * ny + nxt[..., 1]) * nz + nxt[..., 2]
    self_idx = torch.arange(n, device=dev).reshape(g.shape)
    # n: the node "outside the grid", its own successor
    succ = torch.where(g <= 0.0, self_idx, torch.where(inside, flat, n))
    succ = torch.cat([succ.reshape(-1), torch.tensor([n], device=dev)])
    si = [int(i) for i in start_idx]
    seq = torch.tensor([(si[0] * ny + si[1]) * nz + si[2]], device=dev)
    jump = succ
    while seq.shape[0] < max_len:
        seq = torch.cat([seq, jump[seq]])
        if seq.shape[0] < max_len:
            jump = jump[jump]
    seq = seq[:max_len]
    cells = torch.stack([seq // (ny * nz), seq // nz % ny, seq % nz], dim=-1)
    out = seq == n
    if bool(out.any()):
        t = int(out.to(torch.int8).argmax())
        tail = _walk_tail(g.cpu().numpy(), cells[t - 1].cpu().numpy(),
                          max_len - t)
        cells = torch.cat([cells[:t], torch.as_tensor(tail, device=dev)])
    res = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    origin = _device.on(origin, dev, "origin")
    coords = (cells.to(torch.float32) + 0.5) * res + origin
    w = _wrap_clamp(cells, g.shape)
    gv = g[w[:, 0], w[:, 1], w[:, 2]]
    valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       gv[:-1] > 0.0])
    return coords, valid.to(torch.int32).sum(dtype=torch.int32)


def plan(
    dist_grid,
    origin,
    resolution,
    start,
    goal,
    clearance: float = 0.4,
    max_len: int = 512,
    device=None,
) -> GridPlan:
    """Plan a shortest clearance-respecting grid path from start to goal,
    on the device of a tensor ``dist_grid`` (a numpy field goes to
    ``device``, the card unless asked otherwise; ``_device``).

    Args:
      dist_grid: (nx, ny, nz) EDT distance field [m].
      start, goal: (3,) world positions.
    """
    dist_grid, dev = _device.field_device(dist_grid, device)
    origin = _device.on(origin, dev, "origin")
    shape = np.asarray(dist_grid.shape)
    org = origin.cpu().numpy()
    res32 = np.float32(resolution)

    def to_idx(p):
        p = np.asarray(torch.as_tensor(p).cpu(), np.float32)
        i = np.floor((p - org) / res32)
        return np.clip(i.astype(np.int32), 0, shape - 1)

    si, gi = (tuple(int(i) for i in to_idx(p)) for p in (start, goal))
    blocked = dist_grid < clearance
    # never block the endpoints themselves (the reference implicitly seeds
    # the start regardless of clearance)
    blocked[si] = False
    blocked[gi] = False
    g, converged = cost_to_go(blocked, gi)
    path, length = extract_path(g, si, origin, resolution, max_len)
    reached = g[si] < 1e17
    return GridPlan(path=path, length=length, reached=reached,
                    cost_to_go=g, converged=converged)
