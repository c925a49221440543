"""Closed-loop batch solving: each batch is ``batch`` fresh maps drawn on
the card -> ``sdf.edt_batch`` -> ``solver.solve_batch`` of one corridor
of waypoints a map; the batch returns when its statuses are on the host."""

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


class Driver(ClosedLoop):
    def __init__(self, cell, seed, device, spans, seconds):
        self.cell, self.seed, self.dev, self.spans = cell, seed, device, spans
        c = cell.config
        self.map, self.t = c["map"], cell.traffic
        self.res = self.map["resolution"]
        self.B = self.t["batch"]
        self.cells = self.B * int(np.prod(traffic.grid_shape(self.map)))
        rng = np.random.default_rng(seed)
        self.keep_f = Reservoir(self.t["check_fields"], rng)
        self.keep_l = Reservoir(self.t["check_lanes"], rng)

    def setup(self):
        from grad_traj_optimization_torch import solver
        from grad_traj_optimization_torch.fields import sdf
        self.solver, self.sdf = solver, sdf
        self.cfg = optimizer(self.cell.config)
        self.origin = torch.tensor(self.map["origin"], device=self.dev)
        self.res_t = torch.tensor(self.res, device=self.dev)
        warm = traffic.generator(self.seed + 1, self.dev)
        self.gen = traffic.generator(self.seed, self.dev)
        for _ in range(2):
            self._batch(warm)
        self.spans.times.clear()

    def _draw(self, gen):
        c = self.cell.config
        wps = traffic.corridors(gen, self.B, self.map, c["mission"], self.dev)
        occ = traffic.forest(gen, wps, self.map, c["pillars"], self.dev)
        return occ, wps

    def _batch(self, gen):
        with self.spans("draw"):
            occ, wps = self._draw(gen)
        with self.spans("edt"):
            dist = self.sdf.edt_batch(occ, self.res)
        with self.spans("solve"):
            scn = self.solver.Scenario(
                dist=dist, origin=self.origin.expand(self.B, 3),
                resolution=self.res_t.expand(self.B), waypoints=wps)
            # K3 records its cost envelope whatever the flag says; the
            # per-iteration descent (a batch K3 refuses) only when asked
            sol = self.solver.solve_batch(scn, cfg=self.cfg, record_trace=True)
        status = sol.status.cpu().numpy()
        return occ, wps, dist, sol, status

    def step(self):
        occ, wps, dist, sol, status = self._batch(self.gen)
        self.keep_f.offer(np.arange(self.B), lambda i: {
            "occ": take(occ, i).bool(), "dist": take(dist, i)})
        ok = np.flatnonzero(status == 0)
        if len(ok):
            self.keep_l.offer(ok, lambda i: {
                "occ": take(occ, i).bool(), "wps": take(wps, i),
                **{k: take(getattr(sol, k), i) for k in SOL_KEYS}})
        return len(ok), self.B - len(ok)

    def release(self):
        self.gen = None

    # -- correctness ------------------------------------------------------

    def _problem(self, items, prec):
        p = traj.PRECS[prec]
        wps = check.stack(items, "wps").to(p.dtype)
        T, Df, dp0 = traj.straight_seed(wps, self.cell.config["optimizer"])
        field = torch.stack(check.fields([it["occ"] for it in items], self.res,
                                         prec))
        pb = traj.problem(T, Df, dp0, field, self.origin, self.res,
                          self.cell.config["optimizer"], p)
        return pb, dp0.to(p.dtype), wps

    def numbers(self, control=False):
        fi, li = self.keep_f.items, self.keep_l.items
        ref = check.fields([it["occ"] for it in fi], self.res)
        if control:
            got = check.fields([it["occ"] for it in fi], self.res, "tf32")
        else:
            got = [it["dist"] for it in fi]
        out = {"field_gap_m": check.field_gap(got, ref)}
        pb, dp0, wps = self._problem(li, "f64")
        if control:
            cpb, cdp0, _ = self._problem(li, "tf32")
            ans = check.control_answers(cpb, cdp0, pb.cfg["iters_step2"])
        else:
            ans = {k: check.stack(li, k) for k in SOL_KEYS}
        out.update(check.compare(ans, pb, dp0, wps[:, 0], wps[:, -1]))
        return out
