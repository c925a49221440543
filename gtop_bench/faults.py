"""Faults planted under the timed path, to show that the comparison
catches them.  The first three replace the whole-descent kernel's entry
(``ops.solve_cuda.descend``) by a broken one; ``blind`` hands the beam
search a map with no obstacles, so its branches run through them;
``drift`` moves the state a replan tick hands on off its trajectory.

    python3 gtop_bench/control.py fault --workload <cell> --fault unchanged --seeds 1,2,3
"""

from __future__ import annotations

import contextlib
import functools
import importlib


def unchanged(real):
    """Return the seed and the seed's cost: a step that leaves its state."""
    @functools.wraps(real)
    def descend(*a):
        *rest, phases, cfg = a
        total = sum(i for _, i in phases)
        dp, c, n, _ = real(*rest, ((2, 0),), cfg)
        return dp, c, n, c[:, None].expand(-1, total).contiguous()
    return descend


def half(real):
    """Answer the first half of a batch and leave the rest at zero."""
    @functools.wraps(real)
    def descend(*a):
        dp, c, n, tr = real(*a)
        h = (dp.shape[0] + 1) // 2
        dp, c, tr = dp.clone(), c.clone(), tr.clone()
        dp[h:], c[h:], tr[h:] = 0.0, 0.0, 0.0
        return dp, c, n, tr
    return descend


def altered(real):
    """Move every answer by 5 cm after it was produced."""
    @functools.wraps(real)
    def descend(*a):
        dp, c, n, tr = real(*a)
        return dp + 0.05, c, n, tr
    return descend


def blind(real):
    """Search as if the map held no obstacle (every cell 1 km clear)."""
    @functools.wraps(real)
    def search(dists, *a, **kw):
        return real(dists.new_full((1,) + dists.shape[1:], 1000.0), *a, **kw)
    return search


def drift(real):
    """Hand on a state 5 cm off the trajectory the tick flew."""
    @functools.wraps(real)
    def fly(*a, **kw):
        p, *rest = real(*a, **kw)
        return (p + 0.05, *rest)
    return fly


DESCEND = "grad_traj_optimization_torch.ops.solve_cuda", "descend"
SEARCH = "grad_traj_optimization_torch.search.kinodynamic", "search_batch"
FLIGHT = "grad_traj_optimization_torch.replan", "_fly_tick"

#: name -> (module, attribute, wrapper)
FAULTS = {"unchanged": (*DESCEND, unchanged), "half": (*DESCEND, half),
          "altered": (*DESCEND, altered), "blind": (*SEARCH, blind),
          "drift": (*FLIGHT, drift)}

#: the kinds of traffic (drivers) whose timed path holds what a fault
#: breaks, where not every kind: the solve cell runs no search, a replan
#: tick refines a batch of one, and only a replan tick flies
DRIVERS = {"half": ("plan", "solve"), "blind": ("plan", "replan"),
           "drift": ("replan",)}


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` in place of its module's attribute; callers
    that reach it through the module (``solve_cuda.descend``, and
    ``kinodynamic.search_batch`` under every search entry) take the
    broken one."""
    modname, attr, wrap = FAULTS[name]
    mod = importlib.import_module(modname)
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
