"""PyTorch/CUDA port of the gradient-based trajectory optimizer.

The main path of ``grad_traj_optimization_tpu`` (obstacle points ->
occupancy -> exact EDT -> whole-descent projected-BB solve -> Solution)
and its mission pipeline (kinodynamic beam search -> Hermite resample ->
kino-seeded refine, ``plan_batch``), in plain PyTorch around three
hand-written CUDA kernels for Hopper (``sm_90a``):

* K1 ``ops/edt_cuda`` — the EDT min-plus parabola pass;
* K2 ``ops/trilinear_cuda`` — the trilinear distance + gradient lookup;
* K3 ``ops/solve_cuda`` — the whole descent, one thread block per
  scenario, with K2's lookup inside.

The online surface runs on the same kernels: ``serving`` (``SolveServer``,
``MissionServer``), ``replan`` (``replan_loop``, ``replan_loop_rrt``) and
the exact host A* rung of ``plan_batch``, whose C++ engine (``native``,
built with g++ at first use) runs on the host.  The compare2 evaluation
harness (``harness``: ``search.grid_search`` -> RDP -> one K3 solve a
case, or one for a suite) and the support modules (``viz``,
``checkpoint``, ``utils.profiling``) complete the surface.

The module layout mirrors the JAX package.  Importing this package
imports neither ``jax`` nor the JAX package, and builds or loads no
kernel: the kernels compile at the first CUDA tensor that reaches them
(``_build.py``).  CPU tensors take each kernel's plain PyTorch version.
"""

from grad_traj_optimization_torch.config import (
    MapConfig,
    OptimizerConfig,
    OPTI_NODE_CONFIG,
    TEXT_INPUT_CONFIG,
)
from grad_traj_optimization_torch.solver import (
    STATUS_DIVERGED,
    STATUS_OK,
    Scenario,
    Solution,
    evaluate_solution,
    kernel_inputs,
    make_scenario,
    min_clearance,
    solve,
    solve_batch,
    solve_batch_kernel,
    solve_kino_batch,
    solve_kino_batch_race,
)
from grad_traj_optimization_torch.pipeline import PlanBatchResult, plan_batch
from grad_traj_optimization_torch.search import (  # noqa: F401
    kinodynamic,
    predictor,
)

__version__ = "0.1.0"

__all__ = [
    "MapConfig",
    "PlanBatchResult",
    "plan_batch",
    "OptimizerConfig",
    "OPTI_NODE_CONFIG",
    "TEXT_INPUT_CONFIG",
    "STATUS_DIVERGED",
    "STATUS_OK",
    "Scenario",
    "Solution",
    "evaluate_solution",
    "kernel_inputs",
    "make_scenario",
    "min_clearance",
    "solve",
    "solve_batch",
    "solve_batch_kernel",
    "solve_kino_batch",
    "solve_kino_batch_race",
]
