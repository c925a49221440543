"""Shared scaffolding of the PyTorch port's bench scripts (the
counterpart of ``scripts/_bench_common.py``; no JAX).

One place for the measurement protocol: the bench scenario batch
(``random_scenarios`` seed 42, the EDT built on the device), its missions
and moving boxes, the card's name, and the timing rule (a barrier after
every timed call: a host read of a result scalar, which waits for the
device's queue as ``float()`` does in the JAX scripts).
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def require(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a host without one
    raises RuntimeError (the scripts never carry on on the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass 'cpu' to run the "
                           "kernels' plain versions on the host")
    return dev


def card(device) -> str:
    """The device as ``nvidia-smi --query-gpu=name,power.limit`` names it
    (``torch.cuda.get_device_name`` where that tool is missing), or
    ``cpu``."""
    dev = require(device)
    if dev.type != "cuda":
        return "cpu"
    idx = torch.device(dev).index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(idx)


def bench_missions(wps, map_cfg, dev):
    """The JAX bench's missions (bench.py:133-139): start and goal are
    each map's first and last waypoint at rest.  Returns (starts, goals,
    origins) as float32 tensors on ``dev``."""
    B = wps.shape[0]
    z = np.zeros((B, 3))
    f32 = dict(dtype=torch.float32, device=dev)
    starts = torch.as_tensor(np.concatenate([wps[:, 0], z], 1), **f32)
    goals = torch.as_tensor(np.concatenate([wps[:, -1], z], 1), **f32)
    origins = torch.as_tensor(map_cfg.origin, **f32).expand(B, 3)
    return starts, goals, origins


def bench_prediction(B, dev):
    """Two drifting boxes per lane, fitted as the JAX bench does
    (bench.py:164-178)."""
    from grad_traj_optimization_torch.search import predictor

    n_obj = 2
    hist = np.zeros((B, n_obj, 2, 3), np.float32)
    rng_d = np.random.default_rng(7)
    p0 = rng_d.uniform(-4, 4, (B, n_obj, 3))
    p0[..., 2] = rng_d.uniform(1.0, 3.0, (B, n_obj))
    v0 = rng_d.uniform(-0.6, 0.6, (B, n_obj, 3))
    hist[:, :, 0] = (p0 - 0.5 * v0).astype(np.float32)
    hist[:, :, 1] = p0.astype(np.float32)
    hist_t = np.broadcast_to(np.array([[-0.5, 0.0]], np.float32),
                             (B, n_obj, 2))
    scale = np.full((B, n_obj, 3), 0.8, np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    return predictor.fit_const_vel(torch.as_tensor(hist, **f32),
                                   torch.as_tensor(hist_t.copy(), **f32),
                                   torch.as_tensor(scale, **f32))


def opti_node_lanes(wp: np.ndarray, n: int = 256) -> np.ndarray:
    """bench.py:374-384: ``n`` copies of the opti_node waypoints, x and y
    jittered by +-0.3 m (``default_rng(3)``), float32."""
    rng = np.random.default_rng(3)
    return np.stack([
        wp + np.concatenate([rng.uniform(-0.3, 0.3, (len(wp), 2)),
                             np.zeros((len(wp), 1))], 1)
        for _ in range(n)
    ]).astype(np.float32)


def bench_draws(B: int, seed: int = 42, n_waypoints: int = 7):
    """The JAX bench's fixture call (bench.py:29-31): (map_cfg, obstacle
    points, valid mask, waypoints), numpy."""
    from grad_traj_optimization_torch import fixtures

    return fixtures.random_scenarios(B, n_waypoints=n_waypoints, seed=seed,
                                     max_obstacle_points=4096)


def build_fields(pts, valid, map_cfg):
    """Obstacle points and their mask (tensors on one device) -> the
    (B, nx, ny, nz) distance fields: ``sdf.rasterize`` then
    ``sdf.edt_batch`` (two K1 launches on the card)."""
    from grad_traj_optimization_torch.fields import sdf

    origin = torch.as_tensor(map_cfg.origin, dtype=torch.float32,
                             device=pts.device)
    occ = sdf.rasterize(pts, origin, map_cfg.resolution, map_cfg.grid_shape,
                        valid_mask=valid)
    return sdf.edt_batch(occ, map_cfg.resolution)


def build_bench_batch(B: int, seed: int = 42, n_waypoints: int = 7,
                      device="cuda"):
    """Bench-shaped batch on ``device``: (dist, origins_b, res, starts,
    goals, wps), the JAX version's tuple; dist, origins, starts and goals
    are float32 tensors on the device, wps the numpy waypoints."""
    dev = require(device)
    map_cfg, pts, valid, wps = bench_draws(B, seed, n_waypoints)
    dist = build_fields(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                        torch.as_tensor(valid, device=dev), map_cfg)
    starts, goals, origins = bench_missions(wps, map_cfg, dev)
    return dist, origins, map_cfg.resolution, starts, goals, wps


def host_read(x) -> float:
    """The timing barrier: a host read of a result scalar (the sum of
    ``x``), which waits for every queued launch that ``x`` depends on."""
    return float(torch.as_tensor(x).sum())


def poisson_load(submit, load: float, duration: float, seed: int = 5):
    """Open-loop Poisson arrivals at ``load`` requests/s for ``duration``
    s (``default_rng(seed)`` exponential gaps, as the JAX sweeps draw
    them): ``submit(i)`` returns request i's Future.  Returns (results in
    submission order, wall s from the start to the last result, wall s
    from the start to the last submit): the generator kept pace when the
    last is close to the last arrival time, ``duration``."""
    n_req = int(load * duration)
    arrivals = np.cumsum(
        np.random.default_rng(seed).exponential(1.0 / load, n_req))
    futs = []
    t_start = time.perf_counter()
    for i in range(n_req):
        dt = t_start + arrivals[i] - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
        futs.append(submit(i))
    t_submitted = time.perf_counter() - t_start
    outs = [f.result(timeout=600) for f in futs]
    return outs, time.perf_counter() - t_start, t_submitted
