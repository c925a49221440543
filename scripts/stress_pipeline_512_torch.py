#!/usr/bin/env python3
"""512^3 stress pipeline with the PyTorch port: EDT -> exact crop ->
batched solve (the counterpart of ``scripts/stress_pipeline_512.py``; no
JAX).

BASELINE.md's stress shape as one pipeline, with the JAX script's draws
and stages:

1. 200 000 obstacle points over a 102 m cube (``default_rng(0)``), a
   20 m mission pocket kept passable, rasterized into 512^3 cells at
   0.2 m (537 MB float32);
2. the exact EDT (``sdf.edt``: two K1 launches);
3. 256 lanes of 7 waypoints in the pocket sharing the one map, cut by
   ``solver.crop_scenarios`` to one union window;
4. ``solver.solve_batch`` of the cropped batch (one K3 launch), and of
   the same 256 lanes on the whole 512^3 map (one K3 launch).

Run from the repository root:

    python scripts/stress_pipeline_512_torch.py [device]

``device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain versions
(far too slow at 512^3: the tests run :func:`stages` on a 64^3 grid).
Prints one JSON line: grid, crop window, the first pass's time (every
stage once, the kernels' first build included), each stage's warm time
(host clock around synchronised calls, min of 3: the EDT, the crop, the
cropped and the uncropped solve, and EDT + crop + cropped solve end to
end; the two solves, and the host's ``kernel_inputs`` of each, timed in
turns so that neither always runs first), status-ok lanes and the lanes
whose cropped solve is bitwise the uncropped one (dp and cost).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import torch  # noqa: E402

N = 512
RES = 0.2
BATCH = 256
N_POINTS = 200_000
#: the cube's origin: x and y centred, z from the ground
ORIGIN = (-51.2, -51.2, 0.0)


def draws(batch: int = BATCH, n_points: int = N_POINTS):
    """The JAX script's draws in its order (``default_rng(0)``): obstacle
    points over the cube, those in the pocket (|x|, |y| < 10 m, |z - 10|
    < 6 m) dropped but for 2%, then ``batch`` lanes of 7 waypoints in
    the pocket.  Returns (points (n, 3) f32, waypoints (batch, 7, 3) f32)."""
    rng = np.random.default_rng(0)
    pts = np.stack([
        rng.uniform(-51.0, 51.0, n_points),
        rng.uniform(-51.0, 51.0, n_points),
        rng.uniform(0.2, 102.0, n_points),
    ], axis=1).astype(np.float32)
    keep = ~(
        (np.abs(pts[:, 0]) < 10.0)
        & (np.abs(pts[:, 1]) < 10.0)
        & (np.abs(pts[:, 2] - 10.0) < 6.0)
    ) | (rng.random(n_points) < 0.02)
    pts = pts[keep]
    wps = np.stack([
        np.stack([
            np.linspace(-7, 7, 7) + rng.uniform(-0.5, 0.5, 7),
            rng.uniform(-7, 7, 7),
            10.0 + rng.uniform(-2, 2, 7),
        ], axis=1)
        for _ in range(batch)
    ]).astype(np.float32)
    return pts, wps


def build_field(pts, n: int = N, res: float = RES):
    """Obstacle points (a tensor on the field's device) -> the (n, n, n)
    distance field: ``sdf.rasterize`` then ``sdf.edt``."""
    from grad_traj_optimization_torch.fields import sdf

    origin = torch.tensor(ORIGIN, dtype=torch.float32, device=pts.device)
    return sdf.edt(sdf.rasterize(pts, origin, res, (n, n, n)), res)


def bitwise_lanes(a, b) -> torch.Tensor:
    """(B,) lanes whose dp and cost are bitwise equal in two Solutions."""
    same_dp = (a.dp.view(torch.int32) == b.dp.view(torch.int32)).all((1, 2))
    return same_dp & (a.cost.view(torch.int32) == b.cost.view(torch.int32))


def stages(n: int = N, res: float = RES, batch: int = BATCH,
           n_points: int = N_POINTS, cfg=None, device="cuda") -> dict:
    """One pass of every stage at (n, n, n) cells of ``res`` m on
    ``device``: the field, the batch, the cropped batch and both
    solutions."""
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.config import OptimizerConfig

    cfg = OptimizerConfig() if cfg is None else cfg
    pts, wps = draws(batch, n_points)
    pts_d = torch.as_tensor(pts, device=device)
    dist = build_field(pts_d, n, res)
    scns = solver.Scenario(  # the lanes share the one map
        dist=dist[None],
        origin=torch.tensor(ORIGIN, device=device).expand(batch, 3),
        resolution=torch.full((batch,), res, device=device),
        waypoints=torch.as_tensor(wps, device=device))
    cropped = solver.crop_scenarios(scns, cfg)
    return dict(pts=pts_d, dist=dist, scns=scns, cropped=cropped,
                sol_crop=solver.solve_batch(cropped, cfg=cfg, steps=(2,)),
                sol_full=solver.solve_batch(scns, cfg=cfg, steps=(2,)))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _wall(fn, device, reps: int = 3) -> float:
    """Min over ``reps`` of the host seconds around a synchronised call,
    after one warm call."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _walls_in_turns(fns: dict, device, reps: int = 3) -> dict:
    """:func:`_wall` of each named call in turns (a, b, b, a), each
    name's minimum over its two turns kept."""
    order = list(fns)
    best = {}
    for tag in order + order[::-1]:
        best[tag] = min(best.get(tag, float("inf")),
                        _wall(fns[tag], device, reps))
    return best


def time_stages(out: dict, cfg=None, reps: int = 3) -> dict:
    """Each stage of :func:`stages`' pass ``out`` again, warm: the host
    seconds around a synchronised call, min of ``reps`` after one warm
    call; and the JSON line's counts from ``out``."""
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.config import OptimizerConfig

    cfg = OptimizerConfig() if cfg is None else cfg
    pts, scns, cropped = out["pts"], out["scns"], out["cropped"]
    n = scns.dist.shape[1]
    res = float(scns.resolution[0])
    device = pts.device

    def solve(s):
        return solver.solve_batch(s, cfg=cfg, steps=(2,))

    def e2e():
        s = scns._replace(dist=build_field(pts, n, res)[None])
        return solve(solver.crop_scenarios(s, cfg))

    t_edt = _wall(lambda: build_field(pts, n, res), device, reps)
    t_crop = _wall(lambda: solver.crop_scenarios(scns, cfg), device, reps)
    t_solve = _walls_in_turns({"cropped": lambda: solve(cropped),
                               "full": lambda: solve(scns)}, device, reps)
    t_inputs = _walls_in_turns(
        {"cropped": lambda: solver.kernel_inputs(cropped, cfg),
         "full": lambda: solver.kernel_inputs(scns, cfg)}, device, reps)
    t_e2e = _wall(e2e, device, reps)
    sc, sf = out["sol_crop"], out["sol_full"]
    batch = scns.waypoints.shape[0]
    return dict(
        grid=list(scns.dist.shape[1:]), batch=batch, device=str(device),
        crop_grid=list(cropped.dist.shape[1:]),
        crop_offset=cropped.grid_offset[0].tolist(),
        edt_warm_s=t_edt, crop_s=t_crop,
        solve_s=t_solve["cropped"],
        solves_per_s=batch / t_solve["cropped"],
        uncropped_solve_s=t_solve["full"],
        uncropped_solves_per_s=batch / t_solve["full"],
        kernel_inputs_s=t_inputs["cropped"],
        uncropped_kernel_inputs_s=t_inputs["full"],
        pipeline_e2e_s=t_e2e,
        n_ok=int((sc.status == solver.STATUS_OK).sum()),
        n_ok_uncropped=int((sf.status == solver.STATUS_OK).sum()),
        bitwise_lanes=int(bitwise_lanes(sc, sf).sum()),
    )


def main() -> int:
    device = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    t0 = time.perf_counter()
    out = stages(device=device)
    _sync(device)
    t_first = time.perf_counter() - t0
    rep = {**time_stages(out), "first_pass_s": t_first}
    if torch.device(device).type == "cuda":
        rep["card"] = torch.cuda.get_device_name(torch.device(device))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
