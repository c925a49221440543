"""Carry state across from the JAX package, so both compute on identical
inputs.  Everything crosses as numpy arrays or plain dictionaries: this
module imports neither package's arrays library beyond torch.

* :func:`scenario_from_numpy` — a JAX ``Scenario``'s leaves (as numpy)
  -> the port's :class:`~grad_traj_optimization_torch.solver.Scenario`;
* :func:`config_from_jax` — ``dataclasses.asdict`` of a JAX
  ``OptimizerConfig`` -> the port's config;
* :func:`solution_to_numpy` — the port's Solution -> numpy leaves;
* :func:`prediction_from_numpy` — a JAX ``ObjPrediction``'s leaves -> the
  port's :class:`~grad_traj_optimization_torch.search.predictor.ObjPrediction`;
* :func:`kino_result_to_numpy` / :func:`plan_result_to_numpy` — the
  port's search and pipeline results -> numpy leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.pipeline import PlanBatchResult
from grad_traj_optimization_torch.search.kinodynamic import KinoResult
from grad_traj_optimization_torch.search.predictor import ObjPrediction
from grad_traj_optimization_torch.solver import Scenario, Solution


def scenario_from_numpy(dist, origin, resolution, waypoints,
                        grid_offset=None, grid_full=None,
                        device="cuda") -> Scenario:
    """Scenario of float32 tensors on ``device``, the card unless the
    caller asks for the CPU (batched or not, as the arrays are); a
    cropped Scenario's ``grid_offset``/``grid_full`` come as int32."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def i32(a):
        return None if a is None else torch.as_tensor(
            np.array(a, np.int32), device=device)

    return Scenario(dist=f32(dist), origin=f32(origin),
                    resolution=f32(resolution), waypoints=f32(waypoints),
                    grid_offset=i32(grid_offset), grid_full=i32(grid_full))


def config_from_jax(cfg_dict: dict) -> OptimizerConfig:
    """The port's OptimizerConfig from the JAX config's field dict; an
    unknown field raises TypeError."""
    return OptimizerConfig(**cfg_dict)


def solution_to_numpy(sol: Solution) -> Solution:
    """A Solution whose leaves are numpy arrays on the host."""
    return Solution(*(x.detach().cpu().numpy() for x in sol))


def prediction_from_numpy(poly, t1, t2, scale,
                          device="cuda") -> ObjPrediction:
    """ObjPrediction of float32 tensors on ``device``, the card unless the
    caller asks for the CPU (shared or per-lane leaves, as the arrays
    are)."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return ObjPrediction(poly=f32(poly), t1=f32(t1), t2=f32(t2),
                         scale=f32(scale))


def kino_result_to_numpy(r: KinoResult) -> KinoResult:
    """A KinoResult whose leaves are numpy arrays on the host."""
    return KinoResult(*(x.detach().cpu().numpy() for x in r))


def plan_result_to_numpy(r: PlanBatchResult) -> PlanBatchResult:
    """A PlanBatchResult whose solution and search leaves are numpy."""
    return dataclasses.replace(
        r, solution=solution_to_numpy(r.solution),
        search=kino_result_to_numpy(r.search))
