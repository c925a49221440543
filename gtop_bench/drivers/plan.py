"""Closed-loop mission planning: each batch is ``batch`` fresh maps drawn
on the card -> ``sdf.edt_batch`` -> ``pipeline.plan_batch`` (beam search
with its retry ladder, Hermite resample, the seed-duration race) from
each corridor's first waypoint to its last, at rest at both ends.

The check judges the search by itself (each kept branch against the
search's margin in the reference's field) and then follows from it: the
reference resamples the kept branches and refines every stretch of the
race, as the program's refine starts from the program's search."""

from __future__ import annotations

import numpy as np
import torch

from gtop_bench import check
from gtop_bench.drivers import solve
from gtop_bench.drivers.common import take
from gtop_bench.reference import traj

SEARCH_KEYS = ("pos", "vel", "times")

#: the planted faults (``faults.FAULTS``) this path holds: the descent
#: and the search; it flies nothing
FAULTS = ("unchanged", "half", "altered", "blind")


class Driver(solve.Driver):
    def setup(self):
        from grad_traj_optimization_torch import pipeline
        self.pipeline = pipeline
        super().setup()

    def _batch(self, gen):
        t = self.t
        with self.spans("draw"):
            occ, wps = self._draw(gen)
            z = torch.zeros_like(wps[:, 0])
            starts = torch.cat([wps[:, 0], z], -1)
            goals = torch.cat([wps[:, -1], z], -1)
        with self.spans("edt"):
            dist = self.sdf.edt_batch(occ, self.res)
        with self.spans("plan"):
            r = self.pipeline.plan_batch(
                dist, self.origin, self.res, starts, goals, cfg=self.cfg,
                n_waypoints=t["n_knots"], beam=t["beam"],
                max_iters=t["max_iters"], retries=t["retries"],
                stretches=tuple(t["stretches"]),
                host_fallback=t["host_fallback"], margin=t["margin"],
                check_num=t["check_num"])
        return occ, wps, dist, r, r.ok

    def step(self):
        occ, wps, dist, r, ok_mask = self._batch(self.gen)
        self.keep_f.offer(np.arange(self.B), lambda i: {
            "occ": take(occ, i).bool(), "dist": take(dist, i)})
        ok = np.flatnonzero(ok_mask)
        if len(ok):
            sol, se = r.solution, r.search
            self.keep_l.offer(ok, lambda i: {
                "occ": take(occ, i).bool(), "wps": take(wps, i),
                **{"s_" + k: take(getattr(se, k), i) for k in SEARCH_KEYS},
                **{k: take(getattr(sol, k), i) for k in solve.SOL_KEYS}})
        return len(ok), self.B - len(ok)

    # -- correctness: the reference follows from the program's search ------

    def _arms(self, items, field, prec):
        """One reference problem a stretch of the race, from the kept
        search branches resampled by the reference, on ``field``."""
        p = traj.PRECS[prec]
        cfg = self.cell.config["optimizer"]
        # branches differ in length from batch to batch: resample each
        knots = [traj.resample_knots(*(it["s_" + k][None].to(p.dtype)
                                       for k in SEARCH_KEYS), self.t["n_knots"])
                 for it in items]
        pk, vk, ak, seg = (torch.cat(x) for x in zip(*knots))
        Df, dp0 = traj.knot_seed(pk, vk, ak)
        return [traj.problem(seg * s, Df, dp0, field, self.origin, self.res,
                             cfg, p) for s in self.t["stretches"]], dp0

    def numbers(self, control=False):
        fi, li = self.keep_f.items, self.keep_l.items
        ref = check.fields([it["occ"] for it in fi], self.res)
        got = (check.fields([it["occ"] for it in fi], self.res, "tf32")
               if control else [it["dist"] for it in fi])
        out = {"field_gap_m": check.field_gap(got, ref)}
        occs = [it["occ"] for it in li]
        field = torch.stack(check.fields(occs, self.res))
        out["search_margin_gap_m"] = check.search_margin_gap(
            li, field, self.origin, self.res, self.t["margin"],
            self.t["check_num"])
        arms, dp0 = self._arms(li, field, "f64")
        iters = arms[0].cfg["iters_step2"]
        if control:
            cfield = torch.stack(check.fields(occs, self.res, "tf32"))
            carms, cdp0 = self._arms(li, cfield, "tf32")
            tries = [check.control_answers(pb, cdp0, iters) for pb in carms]
            ans = tries[0]
            for a in tries[1:]:  # the race: the lower cost wins a lane
                take_b = a["cost"] < ans["cost"]
                ans = {k: torch.where(take_b.reshape(-1, *[1] * (v.dim() - 1)),
                                      a[k], v) for k, v in ans.items()}
        else:
            ans = {k: check.stack(li, k) for k in solve.SOL_KEYS}
        T = torch.as_tensor(ans["T"]).to(arms[0].T.dtype)
        # the arm each lane's answer took: the stretch nearest its durations
        err = torch.stack([(T - pb.T).abs().amax(1) for pb in arms])
        arm = err.argmin(0)
        best = torch.stack([traj.descend(pb, dp0, iters)[1] for pb in arms])
        pb = _select(arms, arm)
        wps = check.stack(li, "wps").to(pb.T.dtype)
        out.update(check.compare(ans, pb, dp0, wps[:, 0], wps[:, -1],
                                 ref_best=best.amin(0)))
        return out


def _select(arms, arm):
    """One problem whose lane i is arms[arm[i]]'s."""
    pb = arms[0]
    out = {}
    for k, v in vars(pb).items():
        if k not in ("origin", "field") and isinstance(v, torch.Tensor):
            stacked = torch.stack([getattr(a, k) for a in arms])
            out[k] = stacked[arm, torch.arange(len(arm))]
        else:
            out[k] = v
    return traj.Problem(**out)
