"""Carry state across from the JAX package, so both compute on identical
inputs.  Everything crosses as numpy arrays or plain dictionaries: this
module imports neither package's arrays library beyond torch.

* :func:`scenario_from_numpy` — a JAX ``Scenario``'s leaves (as numpy)
  -> the port's :class:`~grad_traj_optimization_torch.solver.Scenario`;
* :func:`config_from_jax` — ``dataclasses.asdict`` of a JAX
  ``OptimizerConfig`` -> the port's config;
* :func:`solution_to_numpy` — the port's Solution -> numpy leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.solver import Scenario, Solution


def scenario_from_numpy(dist, origin, resolution, waypoints,
                        device=None) -> Scenario:
    """Scenario of float32 tensors on ``device`` (batched or not, as the
    arrays are)."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return Scenario(dist=f32(dist), origin=f32(origin),
                    resolution=f32(resolution), waypoints=f32(waypoints))


def config_from_jax(cfg_dict: dict) -> OptimizerConfig:
    """The port's OptimizerConfig from the JAX config's field dict; an
    unknown field raises TypeError."""
    return OptimizerConfig(**cfg_dict)


def solution_to_numpy(sol: Solution) -> Solution:
    """A Solution whose leaves are numpy arrays on the host."""
    return Solution(*(x.detach().cpu().numpy() for x in sol))
