"""Closed-loop replanning of one robot in flight: missions from the
configuration's first waypoint to its last, each end shifted in x and y
from the seed, flown back to back through ``replan.replan_loop`` on the
shared map while boxes cross the route.  A tick runs from its start (the
loop's ``map_update`` call) to the next tick's start or the loop's return.

The check judges a seeded sample of the window's ticks whose beam search
reached its target: the search's branch against its margin in the
reference's field and boxes, then the refine that follows from that
branch (the reference resamples it and descends again), and the flown
state against the refined trajectory.  A tick exposes neither its branch
nor its refine's solution, so both are read where the loop receives them,
at its calls of ``kinodynamic.search`` and ``solver.solve_kino_batch``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gtop_bench import check, traffic
from gtop_bench.drivers.common import Reservoir, optimizer, sync
from gtop_bench.reference import traj

SOL_KEYS = ("coeff", "T", "cost", "cost_trace", "dp")

#: the planted faults (``faults.FAULTS``) this path holds: the descent,
#: the search and the flight; a tick refines a batch of one, which has
#: no half to leave out
FAULTS = ("unchanged", "altered", "blind", "drift")


class Driver:
    def __init__(self, cell, seed, device, spans, seconds):
        self.cell, self.seed, self.dev, self.spans = cell, seed, device, spans
        c = cell.config
        self.map, self.t, self.rc = c["map"], cell.traffic, c["replan"]
        self.res = self.map["resolution"]
        self.keep = Reservoir(self.t["check_ticks"], np.random.default_rng(seed))
        self.missions = np.random.default_rng([seed, 1])
        self.calls, self.unwrap = None, []

    def setup(self):
        from grad_traj_optimization_torch import native, replan, solver
        from grad_traj_optimization_torch.fields import sdf
        from grad_traj_optimization_torch.search import kinodynamic
        self.replan = replan
        c = self.cell.config
        self.occ = traffic.walls(self.map, c["walls"], self.dev)
        self.field = sdf.edt(self.occ, self.res)
        self.rcfg = replan.ReplanConfig(**self.rc)
        self.ocfg = optimizer(c)
        if self.rcfg.fallback_exact:
            native.load()  # the host engine's build, on a checkout's first run
        self._wrap(kinodynamic, "search", "search")
        self._wrap(solver, "solve_kino_batch", "refine")
        warm = traffic.mission_ends(np.random.default_rng([self.seed, 2]),
                                    c["waypoints"], self.t["warm_missions"],
                                    self.t["jitter_m"])
        for ends in warm:
            self._fly(ends)
        sync(self.dev)
        self.spans.times.clear()

    # -- the loop's calls, read as it makes them --------------------------

    def _wrap(self, mod, attr, what):
        real = getattr(mod, attr)
        self.unwrap.append((mod, attr, real))

        def call(*a, **kw):
            out = real(*a, **kw)
            if self.calls is not None:
                self.calls.append((what, a, kw, out))
            return out
        setattr(mod, attr, call)

    def _fly(self, ends, tracer=None):
        """One mission: its tick results, tick seconds and the loop's
        search and refine calls."""
        stamps, self.calls = [], []

        def tick_start(t, grid):
            if tracer is not None and tracer.due():
                tracer.stop()
            stamps.append(time.perf_counter())
            return None

        with self.spans("mission"):
            res = self.replan.replan_loop(
                self.field, self.map["origin"], self.res, ends[0], ends[1],
                obstacle_update=self._boxes, map_update=tick_start,
                rcfg=self.rcfg, ocfg=self.ocfg, device=self.dev)
        stamps.append(time.perf_counter())
        calls, self.calls = self.calls, None
        return res, np.diff(stamps)[:len(res)], calls

    def _boxes(self, t):
        return traffic.box_poses(self.t["boxes"], t)

    def window(self, seconds: float, tracer=None):
        self.ticks, self.tick_s, self.bad_refines = [], [], 0
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ends = traffic.mission_ends(self.missions, self.cell.config["waypoints"],
                                        1, self.t["jitter_m"])[0]
            res, secs, calls = self._fly(ends, tracer)
            self._offer(ends, res, calls)
            self.ticks += res
            self.tick_s += list(secs)
        self.elapsed = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()

    def _offer(self, ends, res, calls):
        """Pair each tick with its search call (one a tick) and its refine
        call (one a tick that found a path), and offer the ticks whose beam
        search reached its target and whose refine came back ok."""
        searches = [c for c in calls if c[0] == "search"]
        refines = iter(c for c in calls if c[0] == "refine")
        due = []
        for tick, s in zip(res, searches):
            r = next(refines)[3] if tick.search_ok else None
            if r is not None and int(r.status[0]) != 0:
                self.bad_refines += 1
            elif r is not None and not tick.via_fallback:
                due.append((tick, s, r))
        self.keep.offer(np.arange(len(due)), lambda i: self._item(ends, *due[i]))

    def _item(self, ends, tick, s, r):
        _, a, kw, kres = s
        return {"state": a[3].detach().double().cpu(), "goal": ends[1],
                "start_time": float(kw["start_time"]),
                "flown": torch.as_tensor(tick.state[:3]),
                "s_pos": kres.pos.clone(), "s_vel": kres.vel.clone(),
                "s_times": kres.times.clone(),
                **{k: getattr(r, k)[0].clone() for k in SOL_KEYS}}

    def counts(self):
        hover = sum(not t.search_ok for t in self.ticks)
        return len(self.ticks), hover + self.bad_refines

    def end_to_end(self) -> dict:
        return {"tick_p95_ms": float(np.percentile(self.tick_s, 95)) * 1e3}

    def diagnostics(self) -> dict:
        s = np.asarray(self.tick_s) * 1e3
        return {"ticks": len(s), "p50_ms": float(np.median(s)),
                "p99_ms": float(np.percentile(s, 99)), "max_ms": float(s.max()),
                "via_fallback": int(sum(t.via_fallback for t in self.ticks)),
                "hover": int(sum(not t.search_ok for t in self.ticks)),
                "refine_not_ok": self.bad_refines,
                "checked_of": self.keep.seen}

    def release(self):
        for mod, attr, real in self.unwrap:
            setattr(mod, attr, real)
        self.unwrap = []

    # -- correctness ------------------------------------------------------

    def _target(self, state, goal):
        """The loop's target at a tick: the goal, or the point ``horizon``
        toward it at rest."""
        to = goal[:3] - state[:3]
        d = float(np.linalg.norm(to))
        if d <= self.rc["horizon"]:
            return goal[:3]
        return state[:3] + to / d * self.rc["horizon"]

    def _problem(self, items, field, prec):
        p = traj.PRECS[prec]
        knots = [traj.resample_knots(*(it["s_" + k][None].to(self.dev, p.dtype)
                                       for k in ("pos", "vel", "times")),
                                     self.rc["n_waypoints"]) for it in items]
        pk, vk, ak, seg = (torch.cat(x) for x in zip(*knots))
        Df, dp0 = traj.knot_seed(pk, vk, ak)
        origin = torch.tensor(self.map["origin"], device=self.dev)
        return traj.problem(seg, Df, dp0, field[None], origin, self.res,
                            self.cell.config["optimizer"], p), dp0

    def numbers(self, control=False):
        items = self.keep.items
        field = check.fields([self.occ.bool()], self.res)[0]
        got = (check.fields([self.occ.bool()], self.res, "tf32")[0] if control
               else self.field)
        origin = torch.tensor(self.map["origin"], device=self.dev)
        out = {"field_gap_m": check.field_gap([got], [field]),
               "search_margin_gap_m": check.search_margin_gap(
                   items, [field] * len(items), origin, self.res,
                   self.rc["margin"], self.t["check_num"], self.t["boxes"])}
        pb, dp0 = self._problem(items, field, "f64")
        iters = pb.cfg["iters_step2"]
        if control:
            cpb, cdp0 = self._problem(items, got, "tf32")
            ans = check.control_answers(cpb, cdp0, iters)
        else:
            ans = {k: check.stack(items, k).to(self.dev) for k in SOL_KEYS}
        dt = pb.T.dtype
        starts = torch.stack([it["state"][:3] for it in items]).to(self.dev, dt)
        goals = torch.as_tensor(np.stack([self._target(it["state"].numpy(), it["goal"])
                                          for it in items]), device=self.dev).to(dt)
        out.update(check.compare(ans, pb, dp0, starts, goals))
        # the flight: the state a tick hands on, against its trajectory
        coeff = torch.as_tensor(ans["coeff"]).to(self.dev, dt)
        T = torch.as_tensor(ans["T"]).to(self.dev, dt)
        t_fly = torch.clamp(T.sum(1), max=self.rc["replan_dt"])
        at = traj.position_at(coeff, T, t_fly)
        flown = at if control else torch.stack([it["flown"] for it in items]).to(self.dev, dt)
        out["fly_gap_m"] = float(torch.linalg.norm(flown - at, dim=-1).max())
        return out
