#!/usr/bin/env python3
"""What a shape of the one-mission beam search costs on the card as a
CUDA graph (``kinodynamic.search``): for the replan tick's shape on the
opti_node map (beam 64, 16 iterations, two predicted boxes), the same
shape at other box counts, and the rungs of ``search_adaptive``'s retries
from it (2x the beam, 1.5x the iterations a rung) up to beam 512, one
JSON line each (past 512 the default dedup's pre-cut, ``exact512``, is
narrower than the beam, and the search raises, eager or not):

- ``first_ms``: the shape's first call, eager;
- ``second_ms``: its second call, the capture and one replay;
- ``replay_ms``: the median of five later calls, each a replay;
- ``capture_s``: ``second_ms`` less ``replay_ms``, in seconds;
- ``reserved_bytes``: the card memory the caching allocator holds more
  after the second call than before it (the graph's pool, its static
  inputs and the call's outputs), after emptying the cache.

Run from the repository root on a machine with a card:

    python3 scripts/search_graph_cost_torch.py [out.jsonl]
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from grad_traj_optimization_torch import fixtures  # noqa: E402
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.search import kinodynamic as kd  # noqa: E402
from grad_traj_optimization_torch.search import predictor  # noqa: E402


def _boxes(n: int, dev):
    """n boxes crossing the route along +x at 0.8 m/s, 0.5 s apart."""
    ys = np.linspace(-1.5, 3.5, max(n, 1))[:n]
    hist = np.zeros((n, 2, 3), np.float32)
    hist[:, :, 0] = [-4.0, -3.6]
    hist[:, :, 1] = ys[:, None]
    hist[:, :, 2] = 2.0
    times = np.tile(np.array([0.5, 1.0], np.float32), (n, 1))
    scales = np.tile(np.array([0.8, 0.8, 1.5], np.float32), (n, 1))
    f32 = dict(dtype=torch.float32, device=dev)
    return predictor.fit_const_vel(*(torch.as_tensor(x, **f32)
                                     for x in (hist, times, scales)))


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else None
    dev = torch.device("cuda:0")
    mc, obss, wp = fixtures.opti_node_scenario()
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(mc.origin, **f32)
    field = sdf.edt(sdf.rasterize(torch.as_tensor(obss, **f32), origin,
                                  mc.resolution, mc.grid_shape),
                    mc.resolution)
    start = torch.as_tensor(np.r_[wp[0], np.zeros(3)], **f32)
    goal = torch.as_tensor(np.r_[wp[-1], np.zeros(3)], **f32)
    base = dict(margin=0.3, max_vel=3.0, max_acc=2.0)
    shapes = [(2, 64, 16), (0, 64, 16), (1, 64, 16), (4, 64, 16)]
    beam, iters = 64, 16
    for _ in range(3):  # search_adaptive's rungs, widen 2, deepen 1.5
        beam, iters = 2 * beam, int(round(1.5 * iters))
        shapes.append((2, beam, iters))
    gpu = torch.cuda.get_device_name(dev)
    lines = []
    for n_box, beam, iters in shapes:
        pred = _boxes(n_box, dev) if n_box else None

        def call():
            return kd.search(field, origin, mc.resolution, start, goal,
                             obstacle_pred=pred, start_time=1.0, beam=beam,
                             max_iters=iters, **base)

        kd._GRAPHS.clear()
        kd._SEEN.clear()
        first = _ms(call)
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(dev)
        second = _ms(call)
        r1 = torch.cuda.memory_reserved(dev)
        replay = statistics.median(_ms(call) for _ in range(5))
        line = dict(boxes=n_box, beam=beam, max_iters=iters,
                    first_ms=first, second_ms=second, replay_ms=replay,
                    capture_s=(second - replay) / 1e3,
                    reserved_bytes=r1 - r0,
                    reached=bool(call().reached), gpu=gpu)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if out:
        with open(out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
