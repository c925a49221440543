"""End-to-end demo with the PyTorch port: the reference opti_node
scenario on the GPU (the counterpart of ``examples/demo.py``; no JAX).

Reproduces the workflow of the reference demo (src/opti_node.cpp:47-147):
build the two-wall map, EDT-transform it, seed 11 waypoints, refine with
the penalty optimizer, print the evaluation metrics, and export the scene
(npz + optional PNG) in place of the rviz markers.

Run: python examples/demo_torch.py [out_dir] [device]

``device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain
versions.
"""

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main(argv=None) -> int:
    """Run the demo with ``argv`` (default ``sys.argv[1:]``: out_dir,
    device); returns the solve's status (0: ok)."""
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "build/demo_torch"
    device = argv[1] if len(argv) > 1 else "cuda"
    os.makedirs(out_dir, exist_ok=True)

    import torch

    from grad_traj_optimization_torch import (
        OptimizerConfig, fixtures, make_scenario, solve, viz,
    )
    from grad_traj_optimization_torch import solver as solve_mod

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    map_cfg, obstacles, waypoints = fixtures.opti_node_scenario()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    scn = make_scenario(waypoints, obstacles, map_cfg, device=dev)
    sync()
    print(f"distance field ({map_cfg.grid_shape}): "
          f"{time.perf_counter() - t0:.1f}s (incl. kernel build)")

    cfg = OptimizerConfig()
    t0 = time.perf_counter()
    sol = solve(scn, cfg=cfg, steps=(2,))
    cost = float(sol.cost)
    print(f"solve: {time.perf_counter() - t0:.1f}s, status "
          f"{int(sol.status)}, final cost {cost:.1f}, accepted iters "
          f"{int(sol.n_accept)}")

    metrics = {
        k: round(float(v), 3)
        for k, v in solve_mod.evaluate_solution(sol).items()
    }
    print("metrics:", metrics)

    npz = viz.export_npz(os.path.join(out_dir, "scene.npz"), sol, scn)
    print("scene exported:", npz)
    try:
        import matplotlib

        matplotlib.use("Agg")

        ax = viz.plot_topdown(sol, scn)
        ax.figure.savefig(os.path.join(out_dir, "topdown.png"), dpi=130)
        ax2 = viz.plot_cost_curve(sol)
        ax2.figure.savefig(os.path.join(out_dir, "cost_curve.png"), dpi=130)
        print("plots:", os.path.join(out_dir, "topdown.png"))
    except ImportError as e:  # matplotlib optional
        print("plots skipped:", e)
    return int(sol.status)


if __name__ == "__main__":
    main()
