"""Golden scenario fixtures from the reference demos, numpy-seeded.

The same generators as ``grad_traj_optimization_tpu.fixtures`` (repeated
because the JAX package cannot be imported without ``jax``): for one
seed they return the same arrays, which
``tests/test_torch_core.py`` checks.

* :func:`opti_node_scenario` — src/opti_node.cpp:60-97.
* :func:`text_input_scenario` — launch/text_input.launch:4-79 +
  src/example_text_input.cpp:28-70.
* :func:`random_scenarios` — the random-map benchmark configuration;
  :func:`random_scenarios_device` draws it on the device
  (:func:`rasterize_boxes` rasterizes the draws).
* :func:`random_search_case` — one random search problem (pillars, gap
  walls, free start and goal) for the front-end suites.
* :func:`lookup_queries` — query points for the trilinear lookup's
  checks, the port's own.
* :func:`long_line_cases` — adversarial lines past 4096 cells for K1's
  long-line kernel, the port's own.
"""

from __future__ import annotations

import numpy as np

from grad_traj_optimization_torch.config import MapConfig


def _frange_grid(starts_stops_steps):
    """Cartesian product of float ranges (start, stop_inclusive, step)."""
    axes = []
    for start, stop, step in starts_stops_steps:
        n = int(np.floor((stop - start) / step + 1e-9)) + 1
        axes.append(start + step * np.arange(n))
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=-1)


def opti_node_scenario():
    """Returns (map_cfg, obstacle_points (N,3), waypoints (11,3))."""
    map_cfg = MapConfig(
        origin=(-20.0, -20.0, 0.0), resolution=0.2, map_size=(40.0, 40.0, 5.0)
    )
    # wall 1 (opti_node.cpp:66-71)
    wall1 = _frange_grid([(0.05, 3.0, 0.2), (2.05, 2.7, 0.2), (0.05, 5.0, 0.2)])
    # wall 2: x from 0.05 down to -2.95 (opti_node.cpp:73-78)
    x2 = 0.05 - 0.2 * np.arange(16)
    y2 = -2.05 - 0.2 * np.arange(4)
    z2 = 0.05 + 0.2 * np.arange(25)
    g2 = np.meshgrid(x2, y2, z2, indexing="ij")
    wall2 = np.stack([a.ravel() for a in g2], axis=-1)
    obss = np.concatenate([wall1, wall2], axis=0)

    waypoints = np.array(
        [
            [0, -5, 2],
            [1, -4, 2],
            [1, -3, 2],
            [1, -2, 2],
            [1, -1, 2],
            [0, 0, 2],
            [-1, 1, 2],
            [-1, 2, 2],
            [-1, 3, 2],
            [-1, 4, 2],
            [0, 5, 2],
        ],
        dtype=np.float64,
    )
    return map_cfg, obss, waypoints


def text_input_scenario():
    """Returns (map_cfg, obstacle_points, waypoints (8,3))."""
    map_cfg = MapConfig(
        origin=(-10.0, -10.0, 0.0), resolution=0.1, map_size=(20.0, 20.0, 5.0)
    )
    res = map_cfg.resolution
    pillars_xy = np.array(
        [
            [-2.0, 2.0], [0.0, 2.0], [2.0, 2.0],
            [-2.0, 0.0], [0.0, 0.0], [2.0, 0.0],
            [-2.0, -2.0], [0.0, -2.0], [2.0, -2.0],
        ]
    )
    th = 2  # example_text_input.cpp:60-70
    pts = []
    zs = np.arange(0.0, 3.5, res)
    for cx, cy in pillars_xy:
        for mm in range(-th, th + 1):
            for nn in range(-th, th + 1):
                for z in zs:
                    pts.append((cx + mm * res, cy + nn * res, z))
    obss = np.array(pts)

    waypoints = np.array(
        [
            [1.0, 3.0, 2.0],
            [-0.7, 2.6, 2.0],
            [-0.7, 1.4, 2.0],
            [0.7, 0.6, 2.0],
            [0.7, -0.6, 2.0],
            [-0.7, -1.4, 2.0],
            [-0.7, -2.6, 2.0],
            [0.7, -3.0, 3.0],
        ]
    )
    return map_cfg, obss, waypoints


def random_search_case(rng, map_cfg=None, n_pillars=(4, 9),
                       gap_walls=(1, 3), clearance: float = 0.6,
                       device="cuda"):
    """One random SEARCH problem: pillar map (+ optional gap walls across
    y=0), EDT field, and free-space start/goal on opposite sides.

    Returns ``(dist, origin, resolution, start, goal)`` with ``dist`` a
    float32 tensor on ``device`` (the card unless the caller asks for the
    CPU), rasterized and EDT-transformed there by the port's ``sdf``, or
    None when no free start/goal was found (degenerate map: the caller
    retries).  The field is downloaded once, for the free-point draws.
    """
    import torch

    from grad_traj_optimization_torch.fields import sdf

    if map_cfg is None:
        map_cfg = MapConfig(
            origin=(-8.0, -8.0, 0.0), resolution=0.25,
            map_size=(16.0, 16.0, 5.0),
        )
    res = map_cfg.resolution
    zmax = map_cfg.map_size[2]
    ext = min(-map_cfg.origin[0], -map_cfg.origin[1]) - 2.0
    pts = []
    for _ in range(rng.integers(*n_pillars)):
        cx, cy = rng.uniform(-ext, ext, size=2)
        sx, sy = rng.uniform(0.4, 1.4, size=2)
        for x in np.arange(cx - sx / 2, cx + sx / 2 + 1e-9, res):
            for y in np.arange(cy - sy / 2, cy + sy / 2 + 1e-9, res):
                for z in np.arange(0.05, zmax, res):
                    pts.append((x, y, z))
    if gap_walls is not None:
        gaps = []
        for _ in range(rng.integers(*gap_walls)):
            gx = rng.uniform(-ext, ext)
            gw = rng.uniform(1.2, 2.0)
            gaps.append((gx - gw / 2, gx + gw / 2))
        x0 = map_cfg.origin[0]
        for x in np.arange(x0, x0 + map_cfg.map_size[0], res):
            if any(lo < x < hi for lo, hi in gaps):
                continue
            for z in np.arange(0.05, zmax, res):
                pts.append((x, 0.0, z))

    f32 = dict(dtype=torch.float32, device=device)
    origin = torch.as_tensor(map_cfg.origin, **f32)
    occ = sdf.rasterize(
        torch.as_tensor(np.asarray(pts), **f32), origin, res,
        map_cfg.grid_shape,
    )
    dist = sdf.edt(occ, res)
    dist_np = dist.cpu().numpy()

    def free_point(ylo, yhi):
        for _ in range(100):
            p = np.array([
                rng.uniform(-ext - 1, ext + 1), rng.uniform(ylo, yhi),
                rng.uniform(1.0, min(3.5, zmax - 0.5)),
            ])
            i = np.floor(
                (p - np.asarray(map_cfg.origin)) / res
            ).astype(int)
            shape = map_cfg.grid_shape
            i = np.clip(i, 0, np.asarray(shape) - 1)
            if dist_np[i[0], i[1], i[2]] > clearance:
                return p
        return None

    start = free_point(-ext - 0.5, -2.0)
    goal = free_point(2.0, ext + 0.5)
    if start is None or goal is None:
        return None
    return dist, np.asarray(map_cfg.origin), res, start, goal


def random_scenarios(
    n: int,
    n_waypoints: int = 7,
    n_boxes: int = 8,
    seed: int = 0,
    map_cfg: MapConfig | None = None,
    max_obstacle_points: int = 4096,
):
    """Batch of random box-obstacle maps + corridor waypoints.

    Returns (map_cfg, obstacle_points (n, P, 3), valid (n, P),
    waypoints (n, n_waypoints, 3)), all numpy float64/bool.  Obstacle
    point lists are padded to a fixed P with out-of-map sentinels.
    """
    if map_cfg is None:
        map_cfg = MapConfig(
            origin=(-10.0, -10.0, 0.0),
            resolution=0.2,
            map_size=(20.0, 20.0, 5.0),
        )
    rng = np.random.default_rng(seed)
    res = map_cfg.resolution
    P = max_obstacle_points
    all_pts = np.full((n, P, 3), 1e6, dtype=np.float64)  # out-of-map pad
    valid = np.zeros((n, P), dtype=bool)
    all_wps = np.zeros((n, n_waypoints, 3))

    for i in range(n):
        pts = []
        for _ in range(n_boxes):
            cx, cy = rng.uniform(-6, 6, size=2)
            sx, sy = rng.uniform(0.4, 1.6, size=2)
            h = rng.uniform(2.0, 5.0)
            xs = np.arange(cx - sx / 2, cx + sx / 2 + 1e-9, res)
            ys = np.arange(cy - sy / 2, cy + sy / 2 + 1e-9, res)
            zs = np.arange(0.05, h, res)
            g = np.stack(
                np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1
            ).reshape(-1, 3)
            pts.append(g)
        pts = np.concatenate(pts, axis=0)
        if len(pts) > P:
            pts = pts[rng.choice(len(pts), P, replace=False)]
        all_pts[i, : len(pts)] = pts
        valid[i, : len(pts)] = True

        # a straight-ish corridor with lateral jitter, off floor/ceiling
        y = np.linspace(-7.0, 7.0, n_waypoints)
        x = rng.uniform(-1.5, 1.5, size=n_waypoints)
        z = rng.uniform(1.5, 3.0, size=n_waypoints)
        all_wps[i] = np.stack([x, y, z], axis=-1)

    return map_cfg, all_pts, valid, all_wps


def random_scenarios_device(n: int, n_waypoints: int = 7, n_boxes: int = 8,
                            map_cfg: MapConfig | None = None,
                            generator=None, device="cuda"):
    """Device-side random scenario batch: occupancy + waypoints drawn
    with a ``torch.Generator`` on ``device`` (the card unless the caller
    asks for the CPU), with no host generation or obstacle-point
    transfer.

    The box distribution mirrors :func:`random_scenarios` (random-map
    benchmark config): ``n_boxes`` axis-aligned pillars of 0.4-1.6 m
    footprint and 2-5 m height in the central 12x12 m, plus a jittered
    straight corridor of waypoints.  The draws cannot match the JAX
    package's PRNG; the rasterization is :func:`rasterize_boxes`, which
    gives the JAX package's arrays for the same draws.  ``generator``
    must live on ``device`` (default: the device's global generator).

    Returns (occupancy (n, nx, ny, nz) f32, waypoints (n, n_wp, 3) f32).
    Build distances with ``sdf.edt_batch(occ, map_cfg.resolution)``.
    """
    import torch

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    centers = uniform((n, n_boxes, 2), -6.0, 6.0)
    sizes = uniform((n, n_boxes, 2), 0.4, 1.6)
    heights = uniform((n, n_boxes), 2.0, 5.0)
    wx = uniform((n, n_waypoints), -1.5, 1.5)
    wz = uniform((n, n_waypoints), 1.5, 3.0)
    return rasterize_boxes(centers, sizes, heights, wx, wz, map_cfg)


def rasterize_boxes(centers, sizes, heights, wx, wz,
                    map_cfg: MapConfig | None = None):
    """Occupancy and waypoints of :func:`random_scenarios_device` from its
    draws, on their device: ``centers``/``sizes`` (n, n_boxes, 2) box
    centres and footprints, ``heights`` (n, n_boxes), ``wx``/``wz``
    (n, n_waypoints) waypoint x and z; the waypoints' y is a linspace
    from -7 m to 7 m.  Boxes rasterize by voxel-centre comparison: every
    box is a ground-based pillar, so their union is a per-(x, y)
    max-height field and one full-volume comparison.  Float32, in the JAX
    package's order of operations (fixtures.py:267-309), so the
    occupancy and the waypoints' x and z are bitwise its own; the y
    linspace may differ from ``jnp.linspace``'s, whose float32 rounding
    depends on how XLA simplifies it, in the last bit."""
    import torch

    if map_cfg is None:
        map_cfg = MapConfig(
            origin=(-10.0, -10.0, 0.0),
            resolution=0.2,
            map_size=(20.0, 20.0, 5.0),
        )
    dev = centers.device
    f32 = dict(dtype=torch.float32, device=dev)
    res = map_cfg.resolution
    origin = torch.as_tensor(map_cfg.origin, **f32)
    cx, cy, cz = (origin[a] + (torch.arange(s, **f32) + 0.5) * res
                  for a, s in enumerate(map_cfg.grid_shape))
    lo = (centers - sizes / 2)[..., None]  # (n, n_boxes, 2, 1)
    hi = (centers + sizes / 2)[..., None]
    inx = (cx >= lo[:, :, 0]) & (cx <= hi[:, :, 0])  # (n, n_boxes, nx)
    iny = (cy >= lo[:, :, 1]) & (cy <= hi[:, :, 1])  # (n, n_boxes, ny)
    cover_h = ((inx[:, :, :, None] & iny[:, :, None, :]).to(torch.float32)
               * heights[:, :, None, None])  # (n, n_boxes, nx, ny)
    H = cover_h.amax(dim=1)  # pillar height per column
    occ = (cz[None, None, None, :] <= H[..., None]).to(torch.float32)

    n, n_wp = wx.shape
    y = torch.linspace(-7.0, 7.0, n_wp, **f32)
    wps = torch.stack([wx, y[None].expand(n, n_wp), wz], dim=-1)
    return occ, wps


def lookup_queries(map_cfg: MapConfig, batch: int, seed: int, n: int = 180):
    """(batch, n, 3) float32 query points for the trilinear lookup (K2) in
    one map: interior points, then, in the last 32, 15 straddling the
    faces (clamped corners), 10 beyond the far faces, and on every face
    the in-map margin (out of map), one float32 ulp inside it, the
    grid-edge cell centres and the map's centre.  The margins are
    ``sdf.in_map``'s float32 bounds.  The port's own fixture, with no
    counterpart in the JAX package."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    lo = np.asarray(map_cfg.origin, f32)
    res = f32(map_cfg.resolution)
    size = np.asarray(map_cfg.grid_shape, f32) * res
    lo_m = lo + f32(1e-4)  # in map iff lo_m < p < hi_m on every axis
    hi_m = lo + size - f32(1e-4)
    u = rng.random((batch, n, 3), dtype=f32)
    q = lo + u * size
    e = n - 32
    q[:, e:e + 15] = lo - f32(0.5) + u[:, e:e + 15] * (size + f32(1.0))
    q[:, e + 15:e + 25] = lo + size + f32(0.3) + u[:, e + 15:e + 25]
    for k, p in enumerate((lo_m, hi_m, np.nextafter(lo_m, hi_m),
                           np.nextafter(hi_m, lo_m), lo + f32(0.5) * res,
                           lo + size - f32(0.5) * res,
                           lo + f32(0.5) * size)):
        q[:, e + 25 + k] = p
    return q


#: mission shapes K3 cannot launch on an H100 (every samples-per-thread
#: plan exceeds ``solve_cuda.MAX_THREADS`` or ``MAX_SMEM``), which the
#: solver's rule sends to the per-iteration descent: (waypoints,
#: n_samples, OptimizerConfig keywords)
K3_REFUSED_SHAPES = {
    "31 waypoints, 80 samples": (31, 80, {}),
    "38 waypoints, alpha_a, 40 samples": (38, 40, dict(alpha_a=0.5)),
    "30 waypoints, 80 samples": (30, 80, {}),
}


def _crossing_pairs(n: int, rng, half: int, big) -> np.ndarray:
    """Pairs of sources every 40 cells whose parabolas cross exactly at a
    cell (``half`` 0) or half a cell from one (``half`` 1): for u < v,
    f_v + v^2 - f_u - u^2 = (2 q + half) (v - u); big between."""
    f = np.full(n, big, np.float32)
    for u in range(0, n - 40, 40):
        gap = int(rng.integers(1, 25))
        v = u + gap
        a = int(rng.integers(0, 200))
        qx = (u + v + 1) // 2 + int(rng.integers(0, 30))
        f[u], f[v] = a, a + (2 * qx + half) * gap - (v * v - u * u)
    return f


def long_line_cases(n: int, seed: int | None = None):
    """Adversarial lines of ``n`` cells for K1's long-line kernel, as
    float32 (L, n), and for each the path it should take: ``"int"``, an
    integer line (the exact envelope; outputs at or past 2^24 take the
    two-rounding evaluation), or ``"dense"`` (every output two-rounding).

    Lines: integer near-ties crossing at a cell and half a cell from one;
    runs of BIG_CELLS^2; every cell BIG_CELLS^2; a lone source of 0 at
    one end (outputs past 4096 cells reach 2^24) and of 7 at the other;
    x lines of a random occupancy grid (n x 4 x 3, occupancy 0.01) after
    the z and y passes, as the x pass sees them, from the whole grid and
    from one with its first 4200 cells free; and three dense lines: a lone
    0.5, random reals, a negative value."""
    import torch

    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.ops import edt_cuda

    rng = np.random.default_rng(n if seed is None else seed)
    big = np.float32(sdf.BIG_CELLS) ** 2
    lines, kinds = [], []

    def add(f, kind):
        lines.append(np.asarray(f, np.float32))
        kinds.append(kind)

    add(_crossing_pairs(n, rng, 0, big), "int")
    add(_crossing_pairs(n, rng, 1, big), "int")
    runs = rng.integers(0, 40, n).astype(np.float32) ** 2
    runs[(np.arange(n) // 700) % 2 == 1] = big
    add(runs, "int")
    add(np.full(n, big, np.float32), "int")
    lone = np.full(n, big, np.float32)
    lone[0] = 0.0
    add(lone, "int")
    lone = np.full(n, big, np.float32)
    lone[n - 1] = 7.0
    add(lone, "int")
    for free, count in ((0, 4), (min(4200, n), 2)):
        occ = (rng.random((n, 4, 3)) < 0.01).astype(np.float32)
        occ[:free] = 0.0
        sq = sdf._nearest_sq_1d(torch.as_tensor(occ), dim=-1)
        edt_cuda.minplus_along(sq, dim=-2)
        for f in sq.numpy().reshape(n, -1).T[:count]:
            add(f, "int")
    half = np.full(n, big, np.float32)
    half[0] = 0.5
    add(half, "dense")
    add(rng.random(n).astype(np.float32) * 3e7, "dense")
    neg = rng.integers(0, 3000, n).astype(np.float32) ** 2
    neg[n // 2] = -1.0
    add(neg, "dense")
    return np.stack(lines), kinds
