#!/usr/bin/env python3
"""The JAX package's numbers on the CPU that ``chip_smoke.py`` phase 17
holds the port's cropping to.

Run from the repository root (on a host with JAX; it imports nothing of
the port, and from ``chip_smoke.py`` and
``scripts/stress_pipeline_512_torch.py`` only their numpy draws):

    python scripts/crop_targets.py [opti_node] [windows]

* ``opti_node``: ``solver.solve_batch`` (the gather path, full grid,
  ``OptimizerConfig()``) of the 256 jittered waypoint sets sharing the
  opti_node map (bench.py:370-384): lanes with status ok.
* ``windows``: ``solver.crop_scenarios`` on that row and on the 256
  lanes of the 512^3 stress pipeline (``scripts/stress_pipeline_512.py``'s
  draws): the window's cell offset and shape.  The window depends only on
  the waypoints, origin, resolution and grid shape, so a zero grid
  stands in for the 512^3 field.

Prints one JSON object a part.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import stress_pipeline_512_torch as stress  # noqa: E402
from grad_traj_optimization_tpu import fixtures  # noqa: E402
from grad_traj_optimization_tpu import solver  # noqa: E402
from grad_traj_optimization_tpu.config import OptimizerConfig  # noqa: E402


def opti_node_batch(dist):
    """The 256-lane shared-map row on ``dist`` (1, nx, ny, nz)."""
    mc, _, wp = fixtures.opti_node_scenario()
    wps = cs.opti_node_lanes(wp)
    n = wps.shape[0]
    return solver.Scenario(
        dist=dist,
        origin=jnp.broadcast_to(jnp.asarray(mc.origin, jnp.float32), (n, 3)),
        resolution=jnp.full((n,), mc.resolution, jnp.float32),
        waypoints=jnp.asarray(wps, jnp.float32))


def window(batch):
    c = solver.crop_scenarios(batch, OptimizerConfig())
    return dict(offset=np.asarray(c.grid_offset)[0].tolist(),
                shape=list(c.dist.shape[1:]))


def opti_node():
    mc, obss, wp = fixtures.opti_node_scenario()
    scn = solver.make_scenario(wp, obss, mc)
    t0 = time.perf_counter()
    sol = solver.solve_batch(opti_node_batch(scn.dist[None]),
                             cfg=OptimizerConfig(), steps=(2,))
    n_ok = int(jnp.sum(sol.status == solver.STATUS_OK))
    print(f"# opti_node row: {time.perf_counter() - t0:.0f} s", flush=True)
    return dict(n_ok=n_ok, lanes=int(sol.status.shape[0]))


def windows():
    mc, _, _ = fixtures.opti_node_scenario()
    out = {"opti_node": window(opti_node_batch(
        jnp.zeros((1,) + mc.grid_shape, jnp.float32)))}
    _, wps = stress.draws()
    n = wps.shape[0]
    out["stress"] = window(solver.Scenario(
        dist=jnp.zeros((1, stress.N, stress.N, stress.N), jnp.float32),
        origin=jnp.broadcast_to(jnp.asarray(stress.ORIGIN, jnp.float32),
                                (n, 3)),
        resolution=jnp.full((n,), stress.RES, jnp.float32),
        waypoints=jnp.asarray(wps)))
    return out


def main():
    parts = sys.argv[1:] or ["opti_node", "windows"]
    fns = {"opti_node": opti_node, "windows": windows}
    for p in parts:
        print(json.dumps({p: fns[p]()}), flush=True)


if __name__ == "__main__":
    main()
