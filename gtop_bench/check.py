"""The comparisons that decide ``correct``.

Each takes the answers a run kept (the program's, or in the control the
reference's own in a lower precision put in the program's place) and the
inputs the benchmark made, works the reference out again from the inputs,
and returns named numbers:

* ``field_gap_m``: the largest gap between a kept distance field and the
  reference's exact EDT of the same occupancy;
* ``search_margin_gap_m``: over the kept search branches, the search's
  ``margin`` less the least distance that a checked sample of the branch
  reads in the reference's EDT, or from a predicted box
  (``reference.search``): above 0 where a branch passes closer to an
  obstacle than the search guarantees, or leaves the map;
* ``end_gap_m``: the largest distance between a trajectory's ends and the
  mission's start and goal;
* ``cost_gap``: the largest relative gap between the cost an answer
  reports and the reference's cost of that answer's trajectory;
* ``cost_gap_p75``, ``cost_gap_p50``: the same gap, its 75th percentile
  and its median over the lanes: the lanes of short segments, on which a
  float32 cost loses its digits to cancellation (the reference in float32
  loses them too), set neither while they are fewer than a quarter (a
  half) of the lanes, and a fault that reaches half (all) of the lanes
  sets it;
* ``trace_gap``: over lanes, the median of the largest relative gap of the
  first three entries of the answer's cost envelope against the
  reference's descent from the same seed;
* ``descent_gap``: |log| of the answers' final costs summed over the lanes
  over the reference descents' summed (lanes that part by round-off part
  both ways; a descent that did not run, or lanes left out, move the sum);
* ``gain_gap``: the share of its seed's cost that a lane's descent took
  off, averaged over the lanes, for the answers (their trajectories
  costed by the reference) against the reference descent's: the relative
  gap of the two means.  A descent that left its seed reads 1, however
  little the descent gains on most lanes; each lane weighs the same, so
  the few lanes whose long descents part by round-off do not swamp it.

A cell's limits file names the numbers it compares; the others are
logged as readings and not compared.
"""

from __future__ import annotations

import torch

from gtop_bench import traffic
from gtop_bench.reference import edt as ref_edt
from gtop_bench.reference import search as ref_search
from gtop_bench.reference import traj

TRACE_ITERS = 3


def fields(occs, res, prec="f64"):
    return [ref_edt.edt(o.bool(), res, prec) for o in occs]


def field_gap(prog, ref) -> float:
    return max(float((p.double() - r.double()).abs().max()) for p, r in zip(prog, ref))


def search_margin_gap(items, fields, origin, res, margin, check_num,
                      boxes=None) -> float:
    """Kept branches (``s_pos``, ``s_vel``, ``s_times`` each) against the
    search's guarantee, each in its map's reference ``fields`` [i]; with
    ``boxes`` (a traffic file's moving boxes) each primitive's samples
    also against the boxes predicted from the poses seen at the branch's
    ``start_time``."""
    gap = -float("inf")
    for it, f in zip(items, fields):
        pts, ts, shot = ref_search.samples(it["s_pos"], it["s_vel"],
                                           it["s_times"], check_num, True)
        pts = pts.to(f.device)
        d = ref_search.clearance(f, origin.double(), res, pts).min()
        prim = ~shot.to(f.device)
        if boxes is not None and prim.any():
            hist, ht, size = (torch.as_tensor(x, device=f.device) for x in
                              traffic.box_poses(boxes, it["start_time"]))
            t = it["start_time"] + ts.to(f.device)[prim]
            d = torch.minimum(d, ref_search.box_distance(pts[prim], t, hist,
                                                         ht, size).min())
        gap = max(gap, margin - float(d))
    return gap


def _f(x, dt):
    return torch.as_tensor(x).to(dt)


def compare(ans: dict, pb: traj.Problem, dp0, starts, goals, ref_best=None):
    """Numbers of the answers ``ans`` (coeff, T, cost, cost_trace, dp;
    batched) against the reference problem ``pb`` (f64) seeded at dp0.
    ``ref_best`` overrides the reference descent's final costs (the race's
    winner over several problems)."""
    dt = pb.prec.dtype
    dp = _f(ans["dp"], dt)
    c_at, _ = traj.cost_and_grad(pb, dp, with_grad=False)
    cost = _f(ans["cost"], dt)
    _, best_c, trace = traj.descend(pb, dp0, pb.cfg["iters_step2"])
    c_seed, _ = traj.cost_and_grad(pb, torch.clamp(dp0.to(dt), pb.lb, pb.ub),
                                   with_grad=False)
    gain_ref = (1 - best_c / c_seed).mean()
    gain = (1 - c_at / c_seed).mean()
    if ref_best is not None:
        best_c = ref_best
    s, e = traj.endpoints(_f(ans["coeff"], dt), _f(ans["T"], dt))
    end = torch.maximum(torch.linalg.norm(s - starts.to(dt), dim=-1),
                        torch.linalg.norm(e - goals.to(dt), dim=-1))
    tr = _f(ans["cost_trace"], dt)[:, :TRACE_ITERS]
    tgap = ((tr - trace[:, :TRACE_ITERS]).abs() / trace[:, :TRACE_ITERS]).amax(1)
    cgap = (cost - c_at).abs() / c_at
    return {
        "end_gap_m": float(end.max()),
        "cost_gap": float(cgap.max()),
        "cost_gap_p75": float(torch.quantile(cgap, 0.75)),
        "cost_gap_p50": float(torch.quantile(cgap, 0.5)),
        "trace_gap": float(tgap.median()),
        "descent_gap": float(torch.log(cost.sum() / best_c.sum()).abs()),
        "gain_gap": float((gain - gain_ref).abs() / gain_ref.clamp(min=1e-12)),
    }


def control_answers(pb: traj.Problem, dp0, iters: int):
    """The reference in the program's place, in ``pb``'s precision."""
    dp, cost, trace = traj.descend(pb, dp0, iters)
    coeff = traj.coefficients(pb.Df, dp, pb.T, pb.prec)
    return {"coeff": coeff, "T": pb.T, "cost": cost, "cost_trace": trace,
            "dp": dp}


def stack(items, key):
    return torch.stack([torch.as_tensor(it[key]) for it in items])

