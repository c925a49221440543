"""Device-mesh scaling of the batched solve and search (port of
``grad_traj_optimization_tpu.parallel.mesh``).

A (data, space) ``DeviceMesh`` over the processes of a
``torch.distributed`` group, one process a device:

* axis ``"data"`` — scenarios.  The batched solve and the beam search
  are embarrassingly parallel over scenarios, so each process runs the
  port's whole ``solve_batch`` (one K3 launch), ``solve_batch_fused``
  (one K2 launch an evaluation) or ``search_batch`` on its rows; only
  the reductions the caller asks for (:func:`convergence_stats`)
  communicate;
* axis ``"space"`` — the distance grid's x axis for large EDT builds
  (:mod:`grad_traj_optimization_torch.parallel.edt_sharded`).

The JAX package's ``jax.Array`` under ``NamedSharding(mesh, P("data"))``
becomes a ``DTensor`` with placements ``(Shard(0), Replicate())``;
its ``shard_map`` becomes ``.to_local()``, the local call and
``DTensor.from_local``.  The kernels see only local tensors.

Bring-up: :func:`init_distributed` (NCCL on the cards, gloo on the CPU),
then :func:`make_mesh`.  Under ``torchrun`` the rank, world size and
rendezvous come from its environment; otherwise pass them.  On the
cards, one process drives one card, made current before the process
group exists, so the port's ``"cuda"`` default (``_device.py``) means
that process's card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (
    DTensor, Replicate, Shard, distribute_tensor,
)

from grad_traj_optimization_torch import solver
from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.search import kinodynamic as kd

#: P("data"): rows split over "data", replicated over "space"
ROWS = (Shard(0), Replicate())
#: P(): every process holds the whole tensor
WHOLE = (Replicate(), Replicate())


def init_distributed(coordinator: str | None = None, num_processes=None,
                     process_id=None, device_type: str = "cuda") -> None:
    """Join the process group (no-op if this process already has).

    ``coordinator`` is ``"host:port"``; without it the torchrun
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) is read.  ``device_type="cuda"`` takes NCCL and
    first makes this process's card current: ``LOCAL_RANK`` under
    torchrun, else the rank (one host); without a card it raises.
    ``"cpu"`` takes gloo.
    """
    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device_type='cuda') needs "
                               "an NVIDIA GPU; none is visible")
        rank = process_id if process_id is not None \
            else os.environ.get("RANK", 0)
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(card)
        kw = dict(backend="nccl", device_id=card)
    elif device_type == "cpu":
        kw = dict(backend="gloo")
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if coordinator is not None:
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group(**kw)


def make_mesh(n_data: int | None = None, n_space: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, space) mesh over every process of the group; ``n_data``
    defaults to the world size over ``n_space``.  CPU tests pass
    ``device_type="cpu"`` (gloo)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise ValueError(f"mesh ({n_data}, {n_space}) does not cover the "
                         f"{world} processes")
    return init_device_mesh(device_type, (n_data, n_space),
                            mesh_dim_names=("data", "space"))


def local_device(mesh: DeviceMesh) -> torch.device:
    """This process's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placements(x, batch: int):
    """ROWS, or WHOLE for a leading-dim-1 leaf of a larger batch (a map
    shared by every scenario)."""
    return WHOLE if x.shape[0] == 1 and batch > 1 else ROWS


def shard_scenarios(scenarios: solver.Scenario,
                    mesh: DeviceMesh) -> solver.Scenario:
    """Place a Scenario batch, the same whole batch on every process,
    with the leading axis split over "data" (no communication: each
    process keeps its rows).  A ``dist`` of leading dim 1 is replicated."""
    dev = local_device(mesh)
    B = scenarios.waypoints.shape[0]
    return scenarios.map(lambda x: distribute_tensor(
        torch.as_tensor(x, device=dev), mesh, _placements(x, B),
        src_data_rank=None))


def global_scenarios(local_scenarios: solver.Scenario,
                     mesh: DeviceMesh) -> solver.Scenario:
    """Assemble a global Scenario batch from per-process rows.

    Each process passes the rows it owns (numpy or tensors, the same
    number on every process), in rank order along "data"; processes that
    differ only along "space" pass the same rows.  A ``dist`` of leading
    dim 1 is a map shared by every row, and every process passes it."""
    dev = local_device(mesh)
    B = local_scenarios.waypoints.shape[0]
    return local_scenarios.map(lambda x: DTensor.from_local(
        torch.as_tensor(x, device=dev), mesh, _placements(x, B)))


def _my_rows(B: int, mesh: DeviceMesh) -> slice:
    """This process's rows of a batch of B; B must divide by the
    data-axis size."""
    n_data = mesh["data"].size()
    if B % n_data:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}")
    b = B // n_data
    r = mesh.get_local_rank("data")
    return slice(r * b, (r + 1) * b)


def _local(x, sl: slice, dev: torch.device, whole: bool = False,
           dtype=None) -> torch.Tensor:
    """This process's part of an input on ``dev``: rows ``sl`` of a
    whole batch (numpy or a tensor), all of it when ``whole`` (a leaf
    shared by every row), or a DTensor's local part (its rows when it is
    split over "data")."""
    if isinstance(x, DTensor):
        split = x.placements[0] == Shard(0)
        x = x.to_local()
        if split:
            return x
    return torch.as_tensor(x if whole else x[sl], dtype=dtype, device=dev)


def sharded_solve(scenarios: solver.Scenario, mesh: DeviceMesh, cfg=None,
                  steps=(2,), record_trace: bool = False) -> solver.Solution:
    """Data-parallel batched solve over the mesh.

    ``scenarios``: a whole batch (the same on every process) or a batch
    of DTensors from :func:`shard_scenarios` / :func:`global_scenarios`;
    the batch must divide by the data-axis size.  Each process runs
    ``solver.solve_batch`` on its rows (one K3 launch on a card where the
    solver's rule picks K3, else the per-iteration descent).
    Returns a Solution of DTensors split the same way.
    """
    if cfg is None:
        cfg = OptimizerConfig()
    return _on_rows(solver.solve_batch, scenarios, mesh, cfg=cfg,
                    steps=tuple(steps), record_trace=record_trace)


def sharded_solve_fused(scenarios: solver.Scenario, mesh: DeviceMesh,
                        cfg=None, steps=(2,), record_trace: bool = False,
                        interpret: bool = False) -> solver.Solution:
    """Data-parallel per-iteration solve over the mesh (port of the JAX
    package's ``sharded_solve_fused``): each process runs
    ``solver.solve_batch_fused`` on its rows, one K2 launch an evaluation
    on a card.  ``cfg`` defaults to ``OptimizerConfig(lookup_mode=
    "fused")``; ``interpret`` is the JAX package's Pallas switch, taken
    and ignored.  Inputs and result as in :func:`sharded_solve`."""
    del interpret
    if cfg is None:
        cfg = OptimizerConfig(lookup_mode="fused")
    return _on_rows(solver.solve_batch_fused, scenarios, mesh, cfg=cfg,
                    steps=tuple(steps), record_trace=record_trace)


def _on_rows(solve, scenarios: solver.Scenario, mesh: DeviceMesh,
             **kw) -> solver.Solution:
    """``solve(rows, **kw)`` on this process's rows, wrapped as a Solution
    of DTensors split over "data"."""
    B = scenarios.waypoints.shape[0]
    sl = _my_rows(B, mesh)
    dev = local_device(mesh)
    # a whole batch is cut here, not through shard_scenarios: the same
    # rows without building DTensors that are unwrapped at once
    local = scenarios.map(
        lambda x: _local(x, sl, dev, x.shape[0] == 1 and B > 1))
    sol = solve(local, **kw)
    return solver.Solution(*(DTensor.from_local(x, mesh, ROWS)
                             for x in sol))


def convergence_stats(solution: solver.Solution) -> dict:
    """Fleet-wide convergence reductions: ``n_ok``, ``mean_cost`` and
    ``mean_accept`` as 0-d float64 tensors.  The local sums are taken in
    float64 and all-reduced over "data" in one call, so the numbers do
    not depend on the world size beyond float64 rounding.  A Solution of
    plain tensors is reduced locally."""
    status, cost, n_acc = solution.status, solution.cost, solution.n_accept
    n = status.shape[0]
    group = None
    if isinstance(status, DTensor):
        group = status.device_mesh.get_group("data")
        status, cost, n_acc = (x.to_local() for x in (status, cost, n_acc))
    sums = torch.stack([(status == solver.STATUS_OK).sum().double(),
                        cost.double().sum(), n_acc.double().sum()])
    if group is not None:
        dist.all_reduce(sums, group=group)
    return {"n_ok": sums[0], "mean_cost": sums[1] / n,
            "mean_accept": sums[2] / n}


def sharded_search(dists, origins, resolution, starts, goals,
                   mesh: DeviceMesh, obstacle_pred=None, start_times=None,
                   **kw) -> kd.KinoResult:
    """Data-parallel batched beam search over the mesh's "data" axis.

    Each process runs ``search_batch`` on its rows.  A leading-dim-1
    ``dists`` is a shared map, given whole to every process (each then
    takes search_batch's shared path).  ``obstacle_pred`` with per-lane
    leaves (``poly`` of 4 dims) is split over "data", a shared one given
    whole; ``start_times`` is split.  The batch must divide by the
    data-axis size; the remaining ``kw`` must be static search options.
    Returns a KinoResult of DTensors split over "data".
    """
    for k, v in kw.items():
        if not isinstance(v, (int, float, str, bool, type(None))):
            raise TypeError(
                f"sharded_search kwarg {k!r} must be a static search "
                "option; array-valued inputs go through the named "
                "obstacle_pred/start_times parameters"
            )
    B = starts.shape[0]
    sl = _my_rows(B, mesh)
    dev = local_device(mesh)

    def rows(x, whole=False):
        return _local(x, sl, dev, whole, torch.float32)

    pred = obstacle_pred
    if pred is not None:
        pred = type(pred)(*(rows(x, whole=pred.poly.ndim != 4)
                            for x in pred))
    res = kd.search_batch(
        rows(dists, whole=dists.shape[0] == 1 and B > 1), rows(origins),
        resolution, rows(starts), rows(goals), obstacle_pred=pred,
        start_times=None if start_times is None else rows(start_times),
        **kw,
    )
    return kd.KinoResult(*(DTensor.from_local(x, mesh, ROWS) for x in res))
