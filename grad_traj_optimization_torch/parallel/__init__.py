from grad_traj_optimization_torch.parallel import mesh, edt_sharded  # noqa: F401
