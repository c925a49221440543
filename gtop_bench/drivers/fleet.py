"""Closed-loop fleet refining on one static map: the upstream demo's map,
whose field is built once in set-up; each batch is ``batch`` routes, the
demo's waypoints shifted in x and y per lane on the card and each segment
then cut into ``cuts`` equal ones -> ``solver.solve_batch`` on the shared
field (leading dim 1); the batch returns when its statuses are on the
host.

A route of 51 waypoints has ``num_dp`` 147, past what K3 takes, so every
batch runs the per-iteration descent (``descent.minimize_batch`` over
``penalty.cost_and_grad_batch``, one K2 launch an evaluation).  The
window's launch counts a batch are logged with its diagnostics.

The check compares the one field with the reference's EDT and a seeded
sample of the window's ok lanes with the reference's descent from the
same straight seed on the reference's field."""

from __future__ import annotations

import numpy as np
import torch

from gtop_bench import check, traffic
from gtop_bench.drivers.common import ClosedLoop, Reservoir, optimizer, take
from gtop_bench.reference import traj

SOL_KEYS = ("coeff", "T", "cost", "cost_trace", "dp")

#: the planted faults (``faults.FAULTS``) this path holds: the descent;
#: it runs no search and flies nothing
FAULTS = ("unchanged", "half", "altered")

#: the program's counters (``utils.profiling``) read over the window: which
#: descent ran and how often it looked its samples up
COUNTED = ("launch.descend", "plain.descend", "launch.trilinear_batch",
           "plain.trilinear_batch", "descent.evals")


class Driver(ClosedLoop):
    def __init__(self, cell, seed, device, spans, seconds):
        self.cell, self.seed, self.dev, self.spans = cell, seed, device, spans
        c = cell.config
        self.map, self.t, self.route = c["map"], cell.traffic, c["route"]
        self.res = self.map["resolution"]
        self.B = self.t["batch"]
        #: segments a route
        self.m = (len(c["waypoints"]) - 1) * self.route["cuts"]
        self.keep_l = Reservoir(self.t["check_lanes"],
                                np.random.default_rng(seed))

    def setup(self):
        from grad_traj_optimization_torch import solver
        from grad_traj_optimization_torch.fields import sdf
        from grad_traj_optimization_torch.utils import profiling
        self.solver, self.profiling = solver, profiling
        c = self.cell.config
        self.cfg = optimizer(c)
        self.occ = traffic.walls(self.map, c["walls"], self.dev)
        self.dist = sdf.edt(self.occ, self.res)[None]
        self.demo = torch.tensor(c["waypoints"], dtype=torch.float32,
                                 device=self.dev)
        self.origin = torch.tensor(self.map["origin"], device=self.dev)
        self.res_t = torch.tensor(self.res, device=self.dev)
        warm = traffic.generator(self.seed + 1, self.dev)
        self.gen = traffic.generator(self.seed, self.dev)
        for _ in range(2):
            self._batch(warm)
        self.spans.times.clear()

    def _routes(self, gen):
        """(B, n, 3) float32: the demo's waypoints, each shifted uniformly
        within +-jitter_m in x and y per lane, then each segment cut into
        ``cuts`` equal ones, so a route runs straight between its shifted
        demo waypoints."""
        B, cuts, j = self.B, self.route["cuts"], self.route["jitter_m"]
        n = self.demo.shape[0]
        shift = torch.zeros((B, n, 3), device=self.dev)
        shift[..., :2] = -j + 2 * j * torch.rand((B, n, 2), generator=gen,
                                                 device=self.dev)
        wp = self.demo + shift
        f = torch.arange(cuts, dtype=torch.float32, device=self.dev) / cuts
        a, b = wp[:, :-1, None], wp[:, 1:, None]
        inner = a + f[:, None] * (b - a)  # (B, n-1, cuts, 3)
        return torch.cat([inner.reshape(B, -1, 3), wp[:, -1:]], 1)

    def _batch(self, gen):
        with self.spans("draw"):
            wps = self._routes(gen)
        with self.spans("solve"):
            scn = self.solver.Scenario(
                dist=self.dist, origin=self.origin.expand(self.B, 3),
                resolution=self.res_t.expand(self.B), waypoints=wps)
            sol = self.solver.solve_batch(scn, cfg=self.cfg,
                                          record_trace=True)
        return wps, sol, sol.status.cpu().numpy()

    def step(self):
        wps, sol, status = self._batch(self.gen)
        ok = np.flatnonzero(status == 0)
        if len(ok):
            self.keep_l.offer(ok, lambda i: {
                "wps": take(wps, i),
                **{k: take(getattr(sol, k), i) for k in SOL_KEYS}})
        return len(ok), self.B - len(ok)

    def _counts(self):
        return {k: self.profiling.counter(k) for k in COUNTED}

    def window(self, seconds: float, tracer=None):
        before = self._counts()
        super().window(seconds, tracer)
        after = self._counts()
        self.per_batch = {k: (after[k] - before[k]) / self.batches
                          for k in COUNTED}

    def diagnostics(self) -> dict:
        return dict(super().diagnostics(), per_batch=self.per_batch)

    def release(self):
        self.gen = None

    # -- correctness ------------------------------------------------------

    def _problem(self, items, field, prec):
        p = traj.PRECS[prec]
        cfg = self.cell.config["optimizer"]
        wps = check.stack(items, "wps").to(p.dtype)
        T, Df, dp0 = traj.straight_seed(wps, cfg)
        pb = traj.problem(T, Df, dp0, field[None], self.origin, self.res,
                          cfg, p)
        return pb, dp0.to(p.dtype), wps

    def numbers(self, control=False):
        li = self.keep_l.items
        (ref,) = check.fields([self.occ], self.res)
        if control:
            (got,) = check.fields([self.occ], self.res, "tf32")
        else:
            got = self.dist[0]
        out = {"field_gap_m": check.field_gap([got], [ref])}
        pb, dp0, wps = self._problem(li, ref, "f64")
        if control:
            cpb, cdp0, _ = self._problem(li, got, "tf32")
            ans = check.control_answers(cpb, cdp0, pb.cfg["iters_step2"])
        else:
            ans = {k: check.stack(li, k) for k in SOL_KEYS}
        out.update(check.compare(ans, pb, dp0, wps[:, 0], wps[:, -1]))
        return out
