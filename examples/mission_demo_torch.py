"""Full-mission demo with the PyTorch port: batched search -> seed ->
raced refine on the GPU (the counterpart of ``examples/mission_demo.py``;
no JAX).

Reproduces the reference's compare2 two-stage flow (compare2.cpp:
168-321: kinodynamic front-end search, then gradient refinement) as one
batched ``plan_batch`` call — the planning ladder (adaptive beam search
with retries, exact Hermite reseeding, the seed-duration race, and the
exact host-A* fallback rung when the native engine builds) — and exports
the first mission as the time-swept animation (display.h:57-158
analogue).

Run: python examples/mission_demo_torch.py [out_dir] [batch] [device]

``device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain
versions.
"""

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "build/mission_demo_torch"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    device = sys.argv[3] if len(sys.argv) > 3 else "cuda"
    os.makedirs(out_dir, exist_ok=True)

    import torch

    from grad_traj_optimization_torch import (
        OptimizerConfig, fixtures, native, plan_batch, viz,
    )
    from grad_traj_optimization_torch import solver as solve_mod
    from grad_traj_optimization_torch.fields import sdf

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # random box-obstacle missions (the bench scenario family): start at
    # the first corridor waypoint, goal at the last, zero end velocities
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        batch, n_waypoints=7, seed=7, max_obstacle_points=2048
    )
    origin = torch.tensor(map_cfg.origin, dtype=torch.float32, device=dev)
    res = map_cfg.resolution

    t0 = time.perf_counter()
    occ = sdf.rasterize(torch.as_tensor(pts, dtype=torch.float32,
                                        device=dev),
                        origin, res, map_cfg.grid_shape,
                        valid_mask=torch.as_tensor(valid, device=dev))
    dists = sdf.edt_batch(occ, res)
    sync()
    print(f"{batch} distance fields {map_cfg.grid_shape}: "
          f"{time.perf_counter() - t0:.1f}s (incl. kernel build)")

    z = np.zeros((batch, 3))
    starts = np.concatenate([wps[:, 0], z], axis=1).astype(np.float32)
    goals = np.concatenate([wps[:, -1], z], axis=1).astype(np.float32)

    t0 = time.perf_counter()
    result = plan_batch(
        dists, origin.expand(batch, 3), res, starts, goals,
        cfg=OptimizerConfig(), host_fallback=native.available(),
    )
    sync()
    wall = time.perf_counter() - t0
    ok, reached = result.ok, result.reached
    costs = result.solution.cost.cpu().numpy()
    print(
        f"plan_batch: {wall:.1f}s — "
        f"reached {int(reached.sum())}/{batch}, "
        f"ok {int(ok.sum())}/{batch}, "
        f"retried {result.n_retried}, "
        f"host-recovered {result.n_host_fallback}"
    )
    print("refined costs:", np.round(costs, 1))

    # animate the first successful mission (search knots as the marker
    # waypoints; obstacles from that lane's distance field)
    lane = int(np.argmax(ok)) if ok.any() else 0
    sol = solve_mod.Solution(*(x[lane] for x in result.solution))
    scn = solve_mod.Scenario(
        dist=dists[lane], origin=origin,
        resolution=torch.tensor(res, dtype=torch.float32, device=dev),
        waypoints=result.search.pos[lane],
    )
    gif = os.path.join(out_dir, "mission.gif")
    try:
        viz.animate_trajectory(sol, scn, path=gif, fps=10, speedup=2.0)
        print("animation:", gif)
    except ImportError as e:  # matplotlib/pillow optional
        print("animation skipped:", e)


if __name__ == "__main__":
    main()
