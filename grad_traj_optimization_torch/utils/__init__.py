"""Host-side helpers (port of ``grad_traj_optimization_tpu.utils``)."""

from grad_traj_optimization_torch.utils import profiling  # noqa: F401
