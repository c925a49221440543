"""The one traffic generator: maps, missions and moving boxes, all drawn
from the run's seed.  A traffic file's numbers and a
configuration's numbers are its only parameters; it imports nothing of
the program under test, so the program and the reference receive the
same inputs."""

from __future__ import annotations

import math

import numpy as np
import torch


def grid_shape(map_cfg: dict) -> tuple[int, int, int]:
    return tuple(int(math.ceil(s / map_cfg["resolution"] - 1e-9))
                 for s in map_cfg["map_size"])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def corridors(gen, B: int, map_cfg: dict, mission: dict, device):
    """(B, n, 3) float32 waypoints: a straight corridor of ``length_m`` at a
    uniform heading and a uniform position whose ends keep ``inside_m``
    from the map's sides, each waypoint shifted up to ``lateral_m`` across
    the corridor, at a uniform height in ``z_m``."""
    n = mission["n_waypoints"]
    half = mission["length_m"] / 2
    lat = mission["lateral_m"]
    o = torch.tensor(map_cfg["origin"], device=device)
    size = torch.tensor(map_cfg["map_size"], device=device)
    th = _u(gen, (B,), 0.0, 2 * math.pi, device)
    d = torch.stack([torch.cos(th), torch.sin(th)], -1)
    perp = torch.stack([-d[:, 1], d[:, 0]], -1)
    reach = half * d.abs() + lat * perp.abs() + mission["inside_m"]
    lo, hi = o[:2] + reach, o[:2] + size[:2] - reach
    c = lo + (hi - lo) * torch.rand((B, 2), generator=gen, device=device)
    s = torch.linspace(-half, half, n, device=device)
    off = _u(gen, (B, n), -lat, lat, device)
    xy = c[:, None] + s[None, :, None] * d[:, None] + off[..., None] * perp[:, None]
    z = _u(gen, (B, n), *mission["z_m"], device)
    return torch.cat([xy, z[..., None]], -1)


def forest(gen, wps, map_cfg: dict, pillars: dict, device):
    """(B, nx, ny, nz) float32 occupancy of ``count`` ground-based box
    pillars a map, centres uniform over the map, footprints uniform in
    ``footprint_m`` on each side, heights in ``height_m``; a pillar whose
    footprint widened by ``clear_m`` holds a waypoint is left out, so every
    mission starts and ends in free space.  A cell is occupied where its
    centre lies in a pillar's footprint and at or below its height."""
    B = wps.shape[0]
    P = pillars["count"]
    res = map_cfg["resolution"]
    nx, ny, nz = grid_shape(map_cfg)
    o = torch.tensor(map_cfg["origin"], device=device)
    size = torch.tensor(map_cfg["map_size"], device=device)
    ctr = o[:2] + size[:2] * torch.rand((B, P, 2), generator=gen, device=device)
    half = _u(gen, (B, P, 2), *pillars["footprint_m"], device) / 2
    h = _u(gen, (B, P), *pillars["height_m"], device)
    near = (wps[:, None, :, :2] - ctr[:, :, None]).abs() \
        <= (half + pillars["clear_m"])[:, :, None]
    h = torch.where(near.all(-1).any(-1), torch.zeros_like(h), h)
    lo, hi = ctr - half, ctr + half
    w = int(math.ceil(2 * pillars["footprint_m"][1] / 2 / res)) + 2
    first = torch.floor((lo - o[:2]) / res - 0.5).long()  # (B, P, 2)
    k = torch.arange(w, device=device)
    ix = first[..., 0:1] + k  # (B, P, w)
    iy = first[..., 1:2] + k
    cx = o[0] + (ix.float() + 0.5) * res
    cy = o[1] + (iy.float() + 0.5) * res
    okx = (cx >= lo[..., 0:1]) & (cx <= hi[..., 0:1]) & (ix >= 0) & (ix < nx)
    oky = (cy >= lo[..., 1:2]) & (cy <= hi[..., 1:2]) & (iy >= 0) & (iy < ny)
    ok = okx[..., :, None] & oky[..., None, :]  # (B, P, w, w)
    cell = ix.clamp(0, nx - 1)[..., :, None] * ny + iy.clamp(0, ny - 1)[..., None, :]
    val = torch.where(ok, h[..., None, None], torch.zeros_like(h)[..., None, None])
    cell = cell + (torch.arange(B, device=device) * (nx * ny))[:, None, None, None]
    col = torch.zeros(B * nx * ny, device=device)
    col.scatter_reduce_(0, cell.reshape(-1), val.reshape(-1), reduce="amax")
    cz = o[2] + (torch.arange(nz, device=device, dtype=torch.float32) + 0.5) * res
    return (cz <= col.reshape(B, nx, ny, 1)).to(torch.float32)


def walls(map_cfg: dict, walls: list, device):
    """(nx, ny, nz) float32 occupancy of lattice walls, each axis (start,
    step, count) of obstacle points, as the upstream demo builds its map:
    a point marks the cell of floor((p - origin) / res), points outside
    the map (1e-4 margin) dropped."""
    res = map_cfg["resolution"]
    shape = grid_shape(map_cfg)
    o = torch.tensor(map_cfg["origin"], dtype=torch.float64, device=device)
    n = torch.tensor(shape, dtype=torch.float64, device=device)
    occ = torch.zeros(shape, dtype=torch.float32, device=device)
    for w in walls:
        axes = [s + d * torch.arange(k, dtype=torch.float64, device=device)
                for s, d, k in (w["x"], w["y"], w["z"])]
        p = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        p = p[torch.all((p > o + 1e-4) & (p < o + n * res - 1e-4), dim=-1)]
        i = torch.floor((p - o) / res).long()
        occ[i[:, 0], i[:, 1], i[:, 2]] = 1.0
    return occ


def box_poses(boxes: list, t: float):
    """Pose histories of boxes moving at constant velocity, seen at time
    ``t``: the last ``len(ago_s)`` poses, ``ago_s`` seconds before t, each
    box from ``at`` (its position at time 0) along ``vel``.  Returns
    (n, H, 3) positions, (n, H) times and (n, 3) full extents."""
    hist, ht = [], []
    for b in boxes:
        ts = t - np.asarray(b["ago_s"], np.float64)
        hist.append(np.asarray(b["at"])[None] + np.asarray(b["vel"])[None] * ts[:, None])
        ht.append(ts)
    return (np.stack(hist), np.stack(ht),
            np.asarray([b["size"] for b in boxes], np.float64))


def mission_ends(rng: np.random.Generator, waypoints, n: int, jitter_m: float):
    """(n, 2, 6) starts and goals at rest: the first and last waypoint,
    each shifted uniformly within +-jitter_m in x and y."""
    ends = np.asarray([waypoints[0], waypoints[-1]], np.float64)
    out = np.zeros((n, 2, 6))
    out[..., :3] = ends
    out[..., :2] += rng.uniform(-jitter_m, jitter_m, (n, 2, 2))
    return out
