"""Faults planted under the timed path, to show that the comparison
catches them.  The first three break the descent on both of its paths:
the whole-descent kernel's entry (``ops.solve_cuda.descend``) and the
per-iteration descent that ``solver._solve_per_iteration`` runs where K3
refuses a batch; ``blind`` hands the beam search a map with no
obstacles, so its branches run through them; ``drift`` moves the state a
replan tick hands on off its trajectory.  A cell's driver lists the
faults its timed path holds (``drivers/<driver>.py``, ``FAULTS``).

    python3 gtop_bench/control.py fault --workload <cell> --fault unchanged --seeds 1,2,3
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import types

# Both descents return (dp, cost, n_accept, cost trace): K3's entry a
# tuple, ``descent.minimize_batch`` a ``DescentResult``.  ``half`` and
# ``altered`` serve both; ``unchanged`` runs each for no iteration.


def _like(out, *fields):
    """``fields`` in the type of the descent's result ``out``."""
    return out._make(fields) if hasattr(out, "_make") else fields


def unchanged(real):
    """K3: return the seed and the seed's cost: a step that leaves its state."""
    @functools.wraps(real)
    def descend(*a):
        *rest, phases, cfg = a
        total = sum(i for _, i in phases)
        dp, c, n, _ = real(*rest, ((2, 0),), cfg)
        return dp, c, n, c[:, None].expand(-1, total).contiguous()
    return descend


def unchanged_per_iteration(real):
    """The per-iteration descent: return the clamped seed, its cost, and
    that cost as the whole trace."""
    @functools.wraps(real)
    def minimize_batch(cag, dp0, lb, ub, iters, cfg, **kw):
        res = real(cag, dp0, lb, ub, 0, cfg, **kw)
        return res._replace(
            cost_trace=res.cost[:, None].expand(-1, iters).contiguous())
    return minimize_batch


def half(real):
    """Answer the first half of a batch and leave the rest at zero."""
    @functools.wraps(real)
    def descend(*a, **kw):
        out = real(*a, **kw)
        dp, c, n, tr = out
        h = (dp.shape[0] + 1) // 2
        dp, c, tr = dp.clone(), c.clone(), tr.clone()
        dp[h:], c[h:], tr[h:] = 0.0, 0.0, 0.0
        return _like(out, dp, c, n, tr)
    return descend


def altered(real):
    """Move every answer by 5 cm after it was produced, before the
    coefficients are built from it."""
    @functools.wraps(real)
    def descend(*a, **kw):
        out = real(*a, **kw)
        dp, c, n, tr = out
        return _like(out, dp + 0.05, c, n, tr)
    return descend


def per_iteration(wrap):
    """``wrap`` planted on the descent that ``solver._solve_per_iteration``
    calls: the solver's handle on ``opt.descent`` becomes a copy whose
    ``minimize_batch`` is wrapped.  K3's plain version runs
    ``minimize_batch`` through a handle of its own and keeps the real
    one, so no fault applies twice on a K3 lane."""
    def plant(descent):
        return types.SimpleNamespace(**{
            **vars(descent), "minimize_batch": wrap(descent.minimize_batch)})
    return plant


def blind(real):
    """Search as if the map held no obstacle (every cell 1 km clear)."""
    @functools.wraps(real)
    def search(dists, *a, **kw):
        return real(dists.new_full((1,) + dists.shape[1:], 1000.0), *a, **kw)
    return search


def emptied(graphs):
    """An empty graph cache in place of ``graphs``, which is emptied too:
    no search graph captured on one side of a fault is replayed on the
    other."""
    graphs.clear()
    return type(graphs)()


def drift(real):
    """Hand on a state 5 cm off the trajectory the tick flew."""
    @functools.wraps(real)
    def fly(*a, **kw):
        p, *rest = real(*a, **kw)
        return (p + 0.05, *rest)
    return fly


K3 = "grad_traj_optimization_torch.ops.solve_cuda", "descend"
PER_ITERATION = "grad_traj_optimization_torch.solver", "descent"
KINO = "grad_traj_optimization_torch.search.kinodynamic"
FLIGHT = "grad_traj_optimization_torch.replan", "_fly_tick"

#: name -> [(module, attribute, wrapper)]: each attribute is replaced by
#: ``wrapper(attribute)`` while the fault is planted.  ``blind`` sits under
#: every search entry (``search_batch``, the eager ``search`` and the
#: capture of its graph all run ``_search_impl``).
FAULTS = {
    "unchanged": [(*K3, unchanged),
                  (*PER_ITERATION, per_iteration(unchanged_per_iteration))],
    "half": [(*K3, half), (*PER_ITERATION, per_iteration(half))],
    "altered": [(*K3, altered), (*PER_ITERATION, per_iteration(altered))],
    "blind": [(KINO, "_search_impl", blind), (KINO, "_GRAPHS", emptied)],
    "drift": [(*FLIGHT, drift)],
}


@contextlib.contextmanager
def planted(name: str):
    """Plant every part of fault ``name`` in place of its module's
    attribute, and restore them all when the block ends; callers that
    reach an attribute through its module take the broken one."""
    real = []
    try:
        for modname, attr, wrap in FAULTS[name]:
            mod = importlib.import_module(modname)
            real.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(real[-1][2]))
        yield
    finally:
        for mod, attr, was in reversed(real):
            setattr(mod, attr, was)
