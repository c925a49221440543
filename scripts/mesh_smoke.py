#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: the port's ``parallel`` package on
every visible card, and the kernels on a second card.

Run from the repository root on a machine with one or more NVIDIA GPUs:

    python3 scripts/mesh_smoke.py

It builds the kernels and the native engine (the EDT oracle), makes the
bench batch of ``chip_smoke.py`` on cuda:0 (for the check of the kernels
on cuda:1 when there are two or more cards), then runs
``chip_smoke.phase_mesh``: one spawned process a card, NCCL, with the same
checks and times.  The last lines are the launches per path, summed over
the ranks, as JSON, and ``{"ok": true, ...}``.
"""

import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    import subprocess

    from grad_traj_optimization_torch import _build, fixtures, native, solver
    from grad_traj_optimization_torch.fields import sdf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        cs.log(line)
    card = f"[{smi[0]}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    native.load()
    dev = torch.device("cuda:0")
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        cs.BATCH, n_waypoints=cs.N_WP, seed=cs.SEED, max_obstacle_points=4096)
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(map_cfg.origin, **f32)
    occ = sdf.rasterize(torch.as_tensor(pts, **f32), origin,
                        map_cfg.resolution, map_cfg.grid_shape,
                        valid_mask=torch.as_tensor(valid, device=dev))
    scns = solver.Scenario(
        sdf.edt_batch(occ, map_cfg.resolution),
        origin.expand(cs.BATCH, 3).contiguous(),
        torch.full((cs.BATCH,), map_cfg.resolution, **f32),
        torch.as_tensor(wps, **f32))
    per_path, totals = {}, {"K1": 0, "K1 long": 0, "K2": 0, "K3": 0}
    cs.phase_mesh(occ, scns, map_cfg, card, per_path, totals)
    print(json.dumps({"launches_per_path": per_path, "launches": totals}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
