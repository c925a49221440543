#!/usr/bin/env python3
"""One process of a multi-process run of the port's ``parallel`` package.

Usage:
    python scripts/multihost_worker_torch.py RANK WORLD PORT CASE DIR [DEVICE]

Start WORLD of them, RANK 0 .. WORLD-1, with one free localhost PORT
(:func:`run_ranks` does that and waits for them).
DEVICE is ``cuda`` (NCCL, card RANK; the default) or ``cpu`` (gloo).
Imports only torch, numpy and the port.

CASE ``suite`` reads ``DIR/inputs.npz`` (written from
:func:`suite_inputs`) and runs, over the meshes
(WORLD, 1), (1, WORLD) and, at WORLD 4, (2, 2):
``sharded_solve`` (+ ``convergence_stats``), ``sharded_search`` (static,
per-lane predictions, shared map), ``edt_sharded`` on every ``edt_*``
grid and on ``edt_b`` with ``prev_b``, and the error cases.  Each rank holds its own rows against the
port's one-process call on the same rows; rank 0 writes the gathered
results to ``DIR/outputs.npz`` and the checks and errors to
``DIR/result.json``.

CASE ``fused`` runs ``sharded_solve_fused`` on the solve scenarios of
:func:`solve_inputs` (made on every rank) over the mesh (WORLD, 1), whole
and placed by ``shard_scenarios``: each rank holds its rows against
``solve_batch_fused`` of the same rows; rank 0 writes the gathered
Solution to ``DIR/outputs.npz`` and the checks to ``DIR/result.json``.

CASE ``global`` is the multi-process solve: each rank builds only its own
rows of a random batch (``fixtures.random_scenarios(4 * WORLD, ...)``,
rasterize + ``edt_batch`` on its device), assembles the global batch with
``global_scenarios`` and solves it with ``sharded_solve``; rank 0 writes
the world-wide ``convergence_stats`` to ``DIR/result.json``.
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from grad_traj_optimization_torch import fixtures, solver  # noqa: E402
from grad_traj_optimization_torch.config import (  # noqa: E402
    MapConfig, OptimizerConfig,
)
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.parallel import (  # noqa: E402
    edt_sharded as pedt, mesh as pmesh,
)
from grad_traj_optimization_torch.search import (  # noqa: E402
    kinodynamic as kd, predictor,
)

#: the JAX package's tests/test_parallel.py budgets
SOLVE_CFG = OptimizerConfig(iters_step1=3, iters_step2=5)
FUSED_CFG = OptimizerConfig(iters_step1=3, iters_step2=5, lookup_mode="fused")
GLOBAL_CFG = OptimizerConfig(iters_step1=5, iters_step2=15)
SEARCH_KW = dict(max_iters=10, beam=16)
ROWS_PER_RANK = 4
EDT_RES = 0.2


def solve_inputs() -> dict:
    """16 tiny scenarios as numpy arrays (``solve_dist``, ``solve_origin``,
    ``solve_res``, ``solve_wps``), made on the CPU from a seed (the JAX
    package's tests/test_parallel.py batch)."""
    map_cfg = MapConfig(origin=(-2.0, -2.0, 0.0), resolution=0.25,
                        map_size=(4.0, 4.0, 2.0))
    rng = np.random.default_rng(0)
    occ = (rng.random((16,) + map_cfg.grid_shape) < 0.05).astype(np.float32)
    wps = rng.uniform(-1.2, 1.2, size=(16, 5, 3)).astype(np.float32)
    wps[..., 2] = rng.uniform(0.5, 1.5, size=(16, 5))
    return dict(
        solve_dist=sdf.edt_batch(torch.as_tensor(occ),
                                 map_cfg.resolution).numpy(),
        solve_origin=np.tile(np.asarray(map_cfg.origin, np.float32), (16, 1)),
        solve_res=np.full((16,), map_cfg.resolution, np.float32),
        solve_wps=wps,
    )


def suite_inputs() -> dict:
    """The suite's inputs as numpy arrays, made on the CPU from seeds
    (the JAX package's tests/test_parallel.py cases): the 16 scenarios of
    :func:`solve_inputs`, 8 search cases with one predicted drifting box
    a lane (``search_*``, ``pred_*``), and the grids ``edt_a``
    (40, 12, 6), ``edt_b`` (16, 7, 4; ny = 7 splits unevenly over 4
    ranks), ``edt_empty``, ``edt_full`` and ``edt_long`` (4104, 3, 2;
    x lines longer than 4096 cells, obstacles only in the last four
    cells), and ``prev_b``, a previous distance buffer for ``edt_b``."""
    cpu = torch.device("cpu")
    out = solve_inputs()
    rng = np.random.default_rng(5)
    cases = []
    while len(cases) < 8:
        c = fixtures.random_search_case(rng, device=cpu)
        if c is not None:
            cases.append(c)
    z3 = np.zeros(3)
    hist = np.tile(np.array([[[0.0, 0.0, 1.5], [0.2, 0.0, 1.5]]],
                            np.float32), (8, 1, 1, 1))
    hist_t = np.tile(np.array([[-0.5, 0.0]], np.float32), (8, 1, 1))
    pred = predictor.fit_const_vel(
        torch.as_tensor(hist), torch.as_tensor(hist_t),
        torch.full((8, 1, 3), 0.8))
    out.update(
        search_dists=torch.stack([c[0] for c in cases]).numpy(),
        search_origins=np.stack([c[1] for c in cases]).astype(np.float32),
        search_res=np.float32(cases[0][2]),
        search_starts=np.stack([np.concatenate([c[3], z3])
                                for c in cases]).astype(np.float32),
        search_goals=np.stack([np.concatenate([c[4], z3])
                               for c in cases]).astype(np.float32),
        search_t0s=np.linspace(0.0, 0.7, 8).astype(np.float32),
        **{f"pred_{k}": v.numpy() for k, v in pred._asdict().items()},
    )
    rng = np.random.default_rng(1)
    out.update(
        edt_a=(rng.random((40, 12, 6)) < 0.07).astype(np.float32),
        edt_b=(rng.random((16, 7, 4)) < 0.1).astype(np.float32),
        edt_empty=np.zeros((16, 8, 4), np.float32),
        edt_full=np.ones((16, 8, 4), np.float32),
        edt_res=np.float32(EDT_RES),
    )
    out["prev_b"] = rng.uniform(0.0, 1.5, out["edt_b"].shape).astype(
        np.float32)
    long = np.zeros((4104, 3, 2), np.float32)
    long[4100:] = rng.random((4, 3, 2)) < 0.3
    out["edt_long"] = long
    return out


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def suite(rank: int, world: int, d: str, dev: torch.device) -> None:
    z = np.load(os.path.join(d, "inputs.npz"))
    meshes = {"data": (world, 1), "space": (1, world)}
    if world == 4:
        meshes["2x2"] = (2, 2)
    out, checks, errors = {}, {}, {}
    scns = solver.Scenario(z["solve_dist"], z["solve_origin"],
                           z["solve_res"], z["solve_wps"])
    s_args = (z["search_dists"], z["search_origins"],
              float(z["search_res"]), z["search_starts"], z["search_goals"])
    pred = predictor.ObjPrediction(
        *(torch.as_tensor(z[f"pred_{k}"], device=dev)
          for k in ("poly", "t1", "t2", "scale")))
    t0s = z["search_t0s"]
    for tag, shape in meshes.items():
        m = pmesh.make_mesh(*shape, device_type=dev.type)
        sol = pmesh.sharded_solve(scns, m, cfg=SOLVE_CFG)
        stats = pmesh.convergence_stats(sol)
        out.update({f"solve_{tag}_{k}": v.full_tensor().cpu().numpy()
                    for k, v in sol._asdict().items()})
        checks[f"stats_{tag}"] = {k: float(v) for k, v in stats.items()}
        # this rank's lanes against solve_batch of the same rows
        b = scns.waypoints.shape[0] // shape[0]
        sl = slice(m.get_local_rank("data") * b,
                   (m.get_local_rank("data") + 1) * b)
        own = solver.solve_batch(
            scns.map(lambda x: torch.as_tensor(x[sl], device=dev)),
            cfg=SOLVE_CFG)
        checks[f"solve_rows_bitwise_{tag}"] = _equal(
            (x.to_local() for x in sol), own)
        placed = pmesh.sharded_solve(pmesh.shard_scenarios(scns, m), m,
                                     cfg=SOLVE_CFG)
        checks[f"shard_scenarios_bitwise_{tag}"] = _equal(
            (x.to_local() for x in placed), own)
        for name in z.files:
            if name.startswith("edt_") and name != "edt_res":
                got = pedt.edt_sharded(z[name], float(z["edt_res"]), m)
                out[f"{name}_{tag}"] = got.full_tensor().cpu().numpy()
        got = pedt.edt_sharded(z["edt_b"], float(z["edt_res"]), m,
                               prev_dist=z["prev_b"])
        out[f"prev_b_{tag}"] = got.full_tensor().cpu().numpy()
        if shape[0] > 1:
            errors[f"solve_indivisible_{tag}"] = _error(
                lambda: pmesh.sharded_solve(scns.map(
                    lambda x: x[:shape[0] + 1]), m, cfg=SOLVE_CFG))
        if shape[1] > 1:
            errors[f"edt_indivisible_{tag}"] = _error(
                lambda: pedt.edt_sharded(np.zeros((shape[1] + 1, 3, 2),
                                                  np.float32), 0.5, m))
    m = pmesh.make_mesh(world, 1, device_type=dev.type)
    dists, origins, res, starts, goals = s_args
    b = starts.shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    dyn = dict(obstacle_pred=pred, start_times=t0s)
    dyn_rows = dict(obstacle_pred=predictor.ObjPrediction(
        *(x[sl] for x in pred)), start_times=t0s[sl])
    modes = {"static": (dists, {}, {}), "dynamic": (dists, dyn, dyn_rows),
             "shared": (dists[:1], {}, {})}
    for mode, (dd, kw, kw_rows) in modes.items():
        got = pmesh.sharded_search(dd, origins, res, starts, goals, m, **kw,
                                   **SEARCH_KW)
        out.update({f"search_{mode}_{k}": v.full_tensor().cpu().numpy()
                    for k, v in got._asdict().items()})
        own = kd.search_batch(dd if dd.shape[0] == 1 else dd[sl],
                              origins[sl], res, starts[sl], goals[sl],
                              device=dev, **kw_rows, **SEARCH_KW)
        checks[f"search_rows_bitwise_{mode}"] = _equal(
            (x.to_local() for x in got), own)
    n = world + 1
    errors["search_indivisible"] = _error(
        lambda: pmesh.sharded_search(dists[:n], origins[:n], res, starts[:n],
                                     goals[:n], m, **SEARCH_KW))
    errors["search_array_kwarg"] = _error(
        lambda: pmesh.sharded_search(*s_args, m, bad_arg=np.zeros(8),
                                     **SEARCH_KW))
    errors["sharded_solve_fused"] = _error(
        lambda: pmesh.sharded_solve_fused(scns.map(lambda x: x[:world + 1]),
                                          m, cfg=FUSED_CFG))
    gathered = [None] * world
    dist.all_gather_object(gathered, checks)
    if rank == 0:
        np.savez(os.path.join(d, "outputs.npz"), **out)
        with open(os.path.join(d, "result.json"), "w") as fh:
            json.dump({"world": world, "checks": gathered,
                       "errors": errors}, fh)


def fused_case(rank: int, world: int, d: str, dev: torch.device) -> None:
    z = solve_inputs()
    scns = solver.Scenario(z["solve_dist"], z["solve_origin"],
                           z["solve_res"], z["solve_wps"])
    m = pmesh.make_mesh(world, 1, device_type=dev.type)
    sol = pmesh.sharded_solve_fused(scns, m, cfg=FUSED_CFG,
                                    record_trace=True)
    b = scns.waypoints.shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    own = solver.solve_batch_fused(
        scns.map(lambda x: torch.as_tensor(x[sl], device=dev)),
        cfg=FUSED_CFG, record_trace=True)
    placed = pmesh.sharded_solve_fused(pmesh.shard_scenarios(scns, m), m,
                                       cfg=FUSED_CFG, record_trace=True)
    checks = {"fused_rows_bitwise": _equal((x.to_local() for x in sol), own),
              "fused_shard_scenarios_bitwise": _equal(
                  (x.to_local() for x in placed), own)}
    out = {k: v.full_tensor().cpu().numpy() for k, v in sol._asdict().items()}
    gathered = [None] * world
    dist.all_gather_object(gathered, checks)
    if rank == 0:
        np.savez(os.path.join(d, "outputs.npz"), **out)
        with open(os.path.join(d, "result.json"), "w") as fh:
            json.dump({"world": world, "checks": gathered}, fh)


def global_case(rank: int, world: int, d: str, dev: torch.device) -> None:
    B = ROWS_PER_RANK * world
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        B, n_waypoints=5, seed=11, max_obstacle_points=1024)
    sl = slice(rank * ROWS_PER_RANK, (rank + 1) * ROWS_PER_RANK)
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(map_cfg.origin, **f32)
    occ = sdf.rasterize(torch.as_tensor(pts[sl], **f32), origin,
                        map_cfg.resolution, map_cfg.grid_shape,
                        valid_mask=torch.as_tensor(valid[sl], device=dev))
    local = solver.Scenario(
        dist=sdf.edt_batch(occ, map_cfg.resolution),
        origin=origin.expand(ROWS_PER_RANK, 3),
        resolution=torch.full((ROWS_PER_RANK,), map_cfg.resolution, **f32),
        waypoints=torch.as_tensor(wps[sl], **f32))
    m = pmesh.make_mesh(device_type=dev.type)
    sols = pmesh.sharded_solve(pmesh.global_scenarios(local, m), m,
                               cfg=GLOBAL_CFG)
    stats = pmesh.convergence_stats(sols)
    if rank == 0:
        with open(os.path.join(d, "result.json"), "w") as fh:
            json.dump({"world": world, "n_ok": float(stats["n_ok"]),
                       "mean_cost": float(stats["mean_cost"]),
                       "mean_accept": float(stats["mean_accept"])}, fh)


def run_ranks(world: int, case: str, d, device: str = "cuda",
              timeout: float = 300) -> dict:
    """Start ``world`` ranks of this script on ``case`` and ``d`` with a
    free localhost port, on ``device`` (the cards unless the caller asks
    for ``"cpu"``), and wait for them; every rank must exit 0.
    Returns rank 0's ``result.json``."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), case, str(d), device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        # drain every pipe at once: a rank blocked on a full pipe would
        # stall the collective the others wait in
        with concurrent.futures.ThreadPoolExecutor(world) as ex:
            outs = [f.result()[0] for f in
                    [ex.submit(p.communicate, timeout=timeout)
                     for p in procs]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{o[-3000:]}")
    with open(os.path.join(d, "result.json")) as fh:
        return json.load(fh)


def parse_args(argv: list[str]) -> tuple[int, int, int, str, str, str]:
    """RANK WORLD PORT CASE DIR [DEVICE] -> (rank, world, port, case, dir,
    device type); the device type defaults to ``"cuda"``."""
    rank, world, port = (int(a) for a in argv[:3])
    return rank, world, port, argv[3], argv[4], \
        argv[5] if len(argv) > 5 else "cuda"


def main() -> None:
    rank, world, port, case, d, device_type = parse_args(sys.argv[1:])
    pmesh.init_distributed(f"localhost:{port}", world, rank,
                           device_type=device_type)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    try:
        {"suite": suite, "fused": fused_case,
         "global": global_case}[case](rank, world, d, dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
