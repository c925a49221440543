"""Typed configuration for the trajectory optimizer.

The same dataclasses, fields, defaults and presets as
``grad_traj_optimization_tpu.config``.  They are repeated here rather
than imported because importing anything under the JAX package runs its
``__init__``, which imports ``jax``; the port must run where JAX is not
installed.  ``tests/test_torch_core.py`` holds the two copies
equal field by field.

Reference: the ROS parameters read at grad_traj_optimizer.cpp:3-33 with
the values of launch/opti_node.launch:3-28.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Penalty-optimizer parameters (names follow the reference).

    Iteration budgets replace the reference's NLopt wall-clock limits
    (grad_traj_optimizer.cpp:135-148).  ``lookup_mode`` picks the
    descent in the solver's dispatch: ``"auto"`` takes the whole-descent
    kernel K3 where it supports the batch, any other mode the
    per-iteration descent (``solver.solve_batch_fused``).  Fields that
    only select a TPU code path in the JAX package (``auto_crop``,
    ``crop_margin``, ``lookup_precision``) are kept so a JAX config
    converts one to one; the port reads none of them.
    """

    # penalty weights (launch/opti_node.launch:9-21)
    w_smooth: float = 1.0
    w_collision: float = 5.0
    alpha: float = 10.0
    d0: float = 0.8
    r: float = 0.5
    alpha_v: float = 0.0
    v0: float = 2.5
    r_v: float = 1.5
    alpha_a: float = 0.0
    a0: float = 3.5
    r_a: float = 1.5

    # box bounds on the free derivatives (grad_traj_optimizer.cpp:154-177)
    bos: float = 3.0
    vos: float = 8.0
    aos: float = 10.0

    # time allocation (grad_traj_optimizer.cpp:73-81)
    mean_v: float = 1.8
    init_time: float = 0.3

    # collision line-integral samples (grad_traj_optimizer.cpp:351-353)
    n_samples: int = 30
    t_offset: float = 1e-3

    # iteration budgets
    iters_step1: int = 40
    iters_step2: int = 100

    # descent controls
    lr0: float = 1e-2
    lr_grow: float = 1.6
    lr_shrink: float = 0.35
    lr_min: float = 1e-8
    lr_max: float = 10.0
    step_rule: str = "bb"
    accept_window: int = 1
    seed_mode: str = "reference"
    dual_ms_iters: int = 0
    dual_ms_window: int = 0
    polish_iters: int = 0

    # "auto": K3 where it supports the batch, else the per-iteration
    # descent; any other mode: the per-iteration descent (solver.takes_k3)
    lookup_mode: str = "auto"
    # JAX-package crop and precision selectors (not read by the port)
    auto_crop: bool = True
    crop_margin: float = 2.0
    lookup_precision: str = "highest"

    # "reference" keeps the C++ gradient quirks (extra cd factor, +1e-5
    # per entry, grad_traj_optimizer.cpp:376-381, 428-432); "exact" is
    # the true gradient of the sampled cost
    gradient_mode: str = "reference"

    # numeric floors from the reference (:417-418, :428-432, :358)
    cost_eps: float = 1e-3
    grad_eps: float = 1e-5
    vel_eps: float = 1e-5

    def __post_init__(self):
        if self.gradient_mode not in ("reference", "exact"):
            raise ValueError(f"bad gradient_mode: {self.gradient_mode}")
        if self.lookup_precision not in ("highest", "high"):
            raise ValueError(
                f"bad lookup_precision: {self.lookup_precision}"
            )
        if self.accept_window < 1:
            raise ValueError(f"bad accept_window: {self.accept_window}")
        if self.seed_mode not in ("reference", "min_snap", "dual"):
            raise ValueError(f"bad seed_mode: {self.seed_mode}")
        if self.dual_ms_window < 0:
            raise ValueError(f"bad dual_ms_window: {self.dual_ms_window}")
        if self.polish_iters < 0:
            raise ValueError(f"bad polish_iters: {self.polish_iters}")
        if self.polish_iters > 0 and self.seed_mode != "dual":
            raise ValueError(
                "polish_iters is the dual race's post-race polish; "
                "single-seed schedules should raise iters_step2 instead"
            )


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Static geometry of the voxel map (reference SDFMap ctor,
    src/sdf_map.cpp:3-24)."""

    origin: tuple[float, float, float] = (-20.0, -20.0, 0.0)
    resolution: float = 0.2
    map_size: tuple[float, float, float] = (40.0, 40.0, 5.0)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(
            int(math.ceil(s / self.resolution)) for s in self.map_size
        )

    @property
    def n_voxels(self) -> int:
        nx, ny, nz = self.grid_shape
        return nx * ny * nz


# launch/opti_node.launch:3-28
OPTI_NODE_CONFIG = OptimizerConfig()

# launch/text_input.launch:84-117
TEXT_INPUT_CONFIG = OptimizerConfig(
    w_smooth=200.0,
    w_collision=0.1,
    alpha=5.0,
    d0=0.7,
    r=1.0,
    mean_v=1.0,
    init_time=0.0,
)

# launch/click.launch:3-37 (the legacy click node; its nonzero
# velocity/acceleration penalty scales are honoured)
CLICK_CONFIG = OptimizerConfig(
    w_smooth=20.0,
    w_collision=0.1,
    alpha=10.0,
    d0=0.7,
    r=0.5,
    alpha_v=0.1,
    alpha_a=0.1,
    mean_v=1.0,
    init_time=0.3,
)

# launch/compare2.launch:3-28, with its tight step-2 budget as 25 iterations
COMPARE2_CONFIG = OptimizerConfig(
    w_smooth=20.0,
    w_collision=1.0,
    alpha=10.0,
    d0=0.8,
    r=0.5,
    mean_v=1.8,
    init_time=0.3,
    iters_step2=25,
)

# The JAX package's dual-seed presets: solver.solve_batch races the two
# seeds, one K3 launch per arm (and one more for the post-race polish).
TURBO_CONFIG = OptimizerConfig(
    accept_window=8,
    seed_mode="dual",
    iters_step2=70,
    dual_ms_iters=30,
)

TURBO_FAST_CONFIG = OptimizerConfig(
    accept_window=8,
    seed_mode="dual",
    iters_step2=30,
    dual_ms_iters=30,
)

TURBO_POLISH_CONFIG = OptimizerConfig(
    accept_window=8,
    seed_mode="dual",
    iters_step2=30,
    dual_ms_iters=30,
    polish_iters=20,
)

TURBO_SAFE_CONFIG = OptimizerConfig(
    seed_mode="dual",
    iters_step2=100,
    dual_ms_iters=30,
    dual_ms_window=8,
)
