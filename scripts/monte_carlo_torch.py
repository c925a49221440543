#!/usr/bin/env python3
"""Monte-Carlo run with the PyTorch port: N random scenarios in
chunks (the counterpart of ``scripts/monte_carlo.py``; no JAX).

BASELINE.md's stress configuration, "100k-scenario Monte-Carlo": each
chunk's scenarios are drawn on the device
(``fixtures.random_scenarios_device``, with a ``torch.Generator`` seeded
1000 + the chunk's index, so a run can resume), EDT-transformed
(``sdf.edt_batch``) and solved (``solver.solve_batch``, one K3 launch a
chunk).  Five aggregates accumulate on the host (scenarios done, status
ok, cost sum and maximum, accepted iterations) and are checkpointed
(``checkpoint.save``) every 8 chunks and at the end; a run that finds a
checkpoint resumes from it.  The draws cannot reproduce the JAX
package's PRNG.

Under ``torchrun`` with several processes (one card each), each chunk is
solved by ``parallel.mesh.sharded_solve`` over a (world, 1) mesh; rank 0
prints and checkpoints.

Run from the repository root:

    python scripts/monte_carlo_torch.py [n_total] [chunk] [ckpt_path] [device]

Defaults: 100 000 scenarios in chunks of 1024, the checkpoint
``build/monte_carlo_torch_ckpt.npz``, the card.  Prints one JSON line a
checkpoint and a summary line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

#: the JAX script's map: 20 x 20 x 5 m at 0.2 m (100 x 100 x 25 cells)
MAP = dict(origin=(-10.0, -10.0, 0.0), resolution=0.2,
           map_size=(20.0, 20.0, 5.0))
N_WAYPOINTS = 7
#: chunks between checkpoints
CKPT_EVERY = 8


def solve_chunk(ck: int, chunk: int, cfg, device, mesh=None):
    """Chunk ``ck``'s scenarios drawn, transformed and solved on
    ``device``; returns (status, cost, n_accept) of the whole chunk."""
    from grad_traj_optimization_torch import fixtures, solver
    from grad_traj_optimization_torch.config import MapConfig
    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.parallel import mesh as pmesh

    map_cfg = MapConfig(**MAP)
    gen = torch.Generator(device=device).manual_seed(1000 + ck)
    occ, wps = fixtures.random_scenarios_device(
        chunk, n_waypoints=N_WAYPOINTS, map_cfg=map_cfg, generator=gen,
        device=device)
    res = map_cfg.resolution
    scns = solver.Scenario(
        dist=sdf.edt_batch(occ, res),
        origin=torch.tensor(map_cfg.origin, dtype=torch.float32,
                            device=device).expand(chunk, 3),
        resolution=torch.full((chunk,), res, dtype=torch.float32,
                              device=device),
        waypoints=wps,
    )
    if mesh is None:
        sols = solver.solve_batch(scns, cfg=cfg, steps=(2,))
        return sols.status, sols.cost, sols.n_accept
    sols = pmesh.sharded_solve(scns, mesh, cfg=cfg, steps=(2,))
    return tuple(x.full_tensor() for x in (sols.status, sols.cost,
                                           sols.n_accept))


def run(n_total: int = 100_000, chunk: int = 1024, ckpt_path: str = "",
        device="cuda", cfg=None, mesh=None, log=print) -> dict:
    """Solve chunks until ``n_total`` scenarios are done, resuming from
    ``ckpt_path`` if it holds a checkpoint; ``log`` gets each line's
    dict (rank 0 only under a mesh).  Returns the summary line's dict
    and, under ``state``, the aggregates."""
    from grad_traj_optimization_torch import checkpoint, solver
    from grad_traj_optimization_torch.config import OptimizerConfig

    cfg = OptimizerConfig() if cfg is None else cfg
    device = torch.device(device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    if not lead:
        log = lambda _: None  # noqa: E731
    ckpt_path = ckpt_path or os.path.join(ROOT, "build",
                                          "monte_carlo_torch_ckpt")
    state = {
        "done": np.zeros((), np.int64),
        "n_ok": np.zeros((), np.int64),
        "cost_sum": np.zeros((), np.float64),
        "cost_max": np.zeros((), np.float64),
        "accept_sum": np.zeros((), np.float64),
    }
    if os.path.exists(ckpt_path) or os.path.exists(ckpt_path + ".npz"):
        state = checkpoint.restore(ckpt_path, state)
        log({"resumed_at": int(state["done"])})

    t0 = time.perf_counter()
    t_solve = 0.0
    ck = int(state["done"]) // chunk
    while int(state["done"]) < n_total:
        ts = time.perf_counter()
        status, cost, n_acc = solve_chunk(ck, chunk, cfg, device, mesh)
        n_ok = int((status == solver.STATUS_OK).sum())
        cost = cost.double().cpu().numpy()
        acc = float(n_acc.sum())
        t_solve += time.perf_counter() - ts

        state["done"] = state["done"] + chunk
        state["n_ok"] = state["n_ok"] + n_ok
        state["cost_sum"] = state["cost_sum"] + cost.sum()
        state["cost_max"] = np.maximum(state["cost_max"], cost.max())
        state["accept_sum"] = state["accept_sum"] + acc
        ck += 1
        if ck % CKPT_EVERY == 0 or int(state["done"]) >= n_total:
            if lead:
                checkpoint.save(ckpt_path, state)
            done = int(state["done"])
            log({"done": done, "n_ok": int(state["n_ok"]),
                 "mean_cost": float(state["cost_sum"]) / done,
                 "device_solves_per_s": done / max(t_solve, 1e-9)})

    done = int(state["done"])
    wall = time.perf_counter() - t0
    summary = {
        "metric": "monte_carlo",
        "n_scenarios": done,
        "n_ok": int(state["n_ok"]),
        "mean_cost": float(state["cost_sum"]) / done,
        "max_cost": float(state["cost_max"]),
        "mean_accept": float(state["accept_sum"]) / done,
        "wall_s": wall,
        "end_to_end_solves_per_s": done / wall,
        "device_solves_per_s": done / max(t_solve, 1e-9),
        "n_devices": 1 if mesh is None else torch.distributed.get_world_size(),
        "device": str(device),
    }
    log(summary)
    return {**summary, "state": state}


def main() -> int:
    n_total = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    ckpt_path = sys.argv[3] if len(sys.argv) > 3 else ""
    device = sys.argv[4] if len(sys.argv) > 4 else "cuda"
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from grad_traj_optimization_torch.parallel import mesh as pmesh

        pmesh.init_distributed(device_type=torch.device(device).type)
        mesh = pmesh.make_mesh(device_type=torch.device(device).type)
        device = pmesh.local_device(mesh)
    run(n_total, chunk, ckpt_path, device, mesh=mesh,
        log=lambda line: print(json.dumps(line), flush=True))
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
