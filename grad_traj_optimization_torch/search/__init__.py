"""Front-end searches (port of ``grad_traj_optimization_tpu.search``)."""
