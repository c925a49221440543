#!/usr/bin/env python3
"""One evaluation of the per-iteration descent's penalty on the card, at
the fleet's shape: ``penalty.cost_and_grad_batch`` for 1024 routes of 51
waypoints (the upstream demo's 11, shifted within 0.3 m in x and y per
lane, then each segment cut into 5; num_dp 147) on the demo map, from
the straight seed, at step 2 of ``OPTI_NODE_CONFIG``.  Prints JSON lines:

- ``eval``: the device time of one evaluation (CUDA events around it,
  with the card held busy while the host enqueues it, so host gaps are
  not counted; median, min and max of 30), the host's time to enqueue
  it (median of the same 30), and the wall time of one synchronised
  call (median of 30);
- ``kernels``: the evaluation's kernels by name, from ``torch.profiler``
  over 10 calls: launches and device ms an evaluation, largest first;
- ``back_project``: the gradient's per-segment product alone (the
  weights against each segment's Hermite bases) in three forms, device
  ms each as above: ``bmm`` (a batched product over segments for each
  chain, as ``penalty._back_project`` makes it), ``stacked`` (the chains
  stacked along the samples, one product) and ``broadcast`` (a multiply
  and a sum over the samples); and ``program``, the whole
  ``_back_project``.  Only where the program has ``_back_project``.

Run from the repository root on a machine with a card:

    python3 scripts/descent_eval_probe_torch.py [out.jsonl]
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from grad_traj_optimization_torch import fixtures  # noqa: E402
from grad_traj_optimization_torch.config import OPTI_NODE_CONFIG  # noqa: E402
from grad_traj_optimization_torch.core import qp  # noqa: E402
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.opt import penalty  # noqa: E402

LANES, CUTS, JITTER, SEED = 1024, 5, 0.3, 20261018
REPS = 30
#: GPU cycles to spin before each timed call (~30 ms at H100 clocks), so
#: the host has enqueued the whole call before the card reaches it
HOLD_CYCLES = 50_000_000


def routes(wp: np.ndarray, dev) -> torch.Tensor:
    """(LANES, (len(wp) - 1) * CUTS + 1, 3) float32 on ``dev``."""
    rng = np.random.default_rng(SEED)
    shift = np.zeros((LANES,) + wp.shape)
    shift[..., :2] = rng.uniform(-JITTER, JITTER, (LANES, len(wp), 2))
    w = wp + shift
    f = np.arange(CUTS)[:, None] / CUTS
    inner = w[:, :-1, None] + f * (w[:, 1:, None] - w[:, :-1, None])
    out = np.concatenate([inner.reshape(LANES, -1, 3), w[:, -1:]], 1)
    return torch.as_tensor(out, dtype=torch.float32, device=dev)


def device_ms(fn) -> tuple[list[float], list[float]]:
    """Device ms of ``fn()`` between two events with the card held busy
    while the host enqueues it, and the host's enqueue ms; REPS each."""
    dev_ms, host_ms = [], []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        t = time.perf_counter()
        fn()
        host_ms.append(1e3 * (time.perf_counter() - t))
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    return dev_ms, host_ms


def wall_ms(fn) -> list[float]:
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return out


def summary(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def kernels(fn, n: int = 10) -> list[dict]:
    """Device kernels, copies and sets of ``fn()`` by name: launches and
    device ms a call, from the profiler's events over n calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ns, count = defaultdict(int), defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if "cuda" not in str(e.device_type()).lower():
            continue
        kind = str(getattr(e, "activity_type", lambda: "")()).lower()
        if kind and not any(k in kind for k in ("kernel", "memcpy",
                                                "memset")):
            continue
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else 1000 * e.duration_us())
        ns[e.name()] += dur
        count[e.name()] += 1
    rows = [{"name": k, "launches": count[k] / n, "ms": ns[k] / n / 1e6}
            for k in ns]
    return sorted(rows, key=lambda r: -r["ms"])


def back_project_forms(dp, bctx, grids, origin, res, cfg):
    """The back-projection's per-segment product in three forms, on this
    evaluation's own weights (w1 against H, w2 against HV), and the
    program's whole ``_back_project`` (the product, dt and the adjoint of
    the derivative stack); device ms each."""
    from grad_traj_optimization_torch.ops import trilinear_cuda

    d6, pos, vel = penalty._sample_state(dp, bctx)
    B, m, K = pos.shape[:3]
    d, g = trilinear_cuda.trilinear_batch(
        grids, origin, res, pos.reshape(B, m * K, 3).contiguous())
    d, g = d.reshape(B, m, K), g.reshape(B, m, K, 3)
    cd, gd, vn = penalty._collision_terms(d, vel, cfg)
    w1 = (cfg.w_collision * gd * cd * vn)[..., None] * g
    w2 = (cfg.w_collision * cd / vn)[..., None] * vel
    H, HV = bctx.H, bctx.HV
    # the stacked bases, built once a batch as a context would hold them
    Hs = torch.cat([H, HV], dim=-2).reshape(-1, 2 * K, 6)

    def split(w):
        return w.reshape(-1, K, 3).transpose(1, 2)

    def bmm():
        g6 = torch.bmm(split(w1), H.reshape(-1, K, 6))
        return torch.baddbmm(g6, split(w2), HV.reshape(-1, K, 6))

    def stacked():
        w = torch.cat([w1, w2], dim=-2).reshape(-1, 2 * K, 3)
        return torch.bmm(w.transpose(1, 2), Hs)

    def broadcast():
        return ((w1[..., :, None] * H[..., None, :]).sum(-3)
                + (w2[..., :, None] * HV[..., None, :]).sum(-3))

    def program():
        return penalty._back_project([(w1, H), (w2, HV)], bctx.dt)

    out = {}
    for name, fn in (("bmm", bmm), ("stacked", stacked),
                     ("broadcast", broadcast), ("program", program)):
        fn()
        out[name] = summary(device_ms(fn)[0])
    return out


def card() -> dict:
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0),
            "power_limit": q.stdout.strip(), "torch": torch.__version__}


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a card: this probe times the device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = OPTI_NODE_CONFIG
    mc, obss, wp = fixtures.opti_node_scenario()
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(mc.origin, **f32)
    field = sdf.edt(sdf.rasterize(torch.as_tensor(obss, **f32), origin,
                                  mc.resolution, mc.grid_shape),
                    mc.resolution)
    wps = routes(np.asarray(wp), dev)
    T = qp.allocate_times(wps, cfg.mean_v, cfg.init_time)
    Df, dp = qp.straight_line_d(wps)
    bctx = penalty.build_ctx_batch(T, Df, cfg)
    grids = field[None]
    orgs = origin.expand(LANES, 3).contiguous()
    res = torch.full((LANES,), mc.resolution, **f32)

    def evaluate():
        return penalty.cost_and_grad_batch(dp, bctx, grids, orgs, res, cfg, 2)

    for _ in range(3):
        evaluate()
    torch.cuda.synchronize()
    dev_ms, host_ms = device_ms(evaluate)
    lines = [dict(
        probe="eval", lanes=LANES, waypoints=int(wps.shape[1]),
        num_dp=int(dp.shape[-1]), device_ms=summary(dev_ms),
        host_enqueue_ms=summary(host_ms), wall_ms=summary(wall_ms(evaluate)),
        peak_bytes=torch.cuda.max_memory_allocated(), **card())]
    rows = kernels(evaluate)
    lines.append(dict(probe="kernels", launches=sum(r["launches"]
                                                    for r in rows),
                      device_ms=sum(r["ms"] for r in rows), rows=rows))
    if hasattr(penalty, "_back_project"):
        lines.append(dict(probe="back_project", forms=back_project_forms(
            dp, bctx, grids, orgs, res, cfg)))
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
