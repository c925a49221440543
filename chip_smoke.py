#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing a line; any failure raises (non-zero exit):

1. device: require CUDA, print the card and its power limit;
2. build: time the first-use nvcc build of the three kernels, print
   ptxas's registers and spills;
3. K1 (EDT min-plus, in place along an axis) vs its plain version on the
   bench field's y and x passes and on an odd shape: bitwise equal; the
   card's ``edt_batch`` bitwise the CPU field on 8 maps;
4. K2 (trilinear lookup): its division by res against IEEE division on
   every float32 dividend at 0.1, 0.2, 0.25 and 0.5 m; bitwise equal to
   its plain version on 1024 x 180 positions in the bench fields, on
   64 x 180 in the opti_node map and on grids of tiny values (the lookup
   run again with IEEE division), out-of-map, margin, face-straddling and
   grid-edge points included; its device time, one wrapper call's time
   and the host's enqueue, and ``F.grid_sample``'s time for d alone;
5. K3 (whole descent) vs its plain version on the same kernel inputs:
   every lane to rounding after one iteration, per-lane agreement at a
   10-iteration budget, the repo's cost distribution rule at 100
   iterations; the launch plan (blocks per SM), which must hold the
   bench batch in one wave with and without ``CLICK_CONFIG``; 5b. the
   same two short checks with ``CLICK_CONFIG``'s velocity/acceleration
   penalties;
6. the main path at bench shape: 1024 random maps -> rasterize ->
   edt_batch -> solve_batch -> min_clearance, with every kernel counted
   and no plain version called; each layer's device time;
7. the reference's opti_node map at B = 1 through ``solve``, and K3
   alone there;
8. the front-end on the phase-6 fields: ``search_batch`` static and
   with two predicted moving boxes per lane, reached counts against the
   JAX package's gather path, and the first 32 lanes against the same
   code on the CPU (the front end's and phases 6-11's end-to-end rates
   are ``bench_torch.py``'s line, phase 18);
9. the mission pipeline: ``search_batch_adaptive`` ->
   ``resample_knots_batch`` -> ``solve_kino_batch`` (then ``_race``),
   and ``plan_batch``, with K3 and K2 counted and no plain version
   called;
10. the dual-seed presets ``TURBO_POLISH_CONFIG`` and
   ``TURBO_SAFE_CONFIG`` through ``solve_batch``, K3 counted per arm;
11. the ladder: ``plan_batch(host_fallback=True)`` on the 1024 bench
   missions (the JAX bench's call), ok within ±10 of the JAX gather
   path's CPU count, with the exact host A* rung's recovered lanes and
   host times;
12. ``SolveServer()`` at its defaults: 1024 bench scenarios from 8
   threads, then 256 sharing one field tensor; every lane status ok and
   agreeing with a direct ``solve_batch`` of its bucket group, one K3
   launch a group; the server's wait/total/device percentiles;
13. ``replan_loop`` on the opti_node map (static; two moving boxes and a
   wall added by ``edt_update(mode="add")`` at the third tick, held
   bitwise against a full ``sdf.edt``; the exact-A* fallback run): the
   goal reached wherever the JAX package reaches it on the CPU, every
   flown window clear, one K3 launch a refined tick, tick-stage times;
14. ``replan_loop_rrt`` with the native tree on the opti_node map, and
   ``MissionServer`` with the host rung on 256 bench missions, each
   served lane's flags equal to a direct ``plan_batch`` of its bucket;
   then 64 missions under a starved beam, where the rung must recover a
   lane and every lane end ok;
15. the compare2 suite (``scripts/run_compare2_suite.py``'s 20 cases,
   built on the card): ``harness.run_suite`` with ``warm_compile`` (the
   counts equal to the JAX package's on the CPU, the final costs by the
   repo's distribution rule, each grid plan equal to the CPU's) and
   ``run_suite_batched`` (one K3 launch, under ``profiling.device_trace``),
   the exact-A* retry, ``run_case_rrt``, the compare2 logs parsed back and
   a checkpoint round trip on the card; front-end, back-end and grid
   search times;
16. the ``parallel`` package on every visible card, one spawned process a
   card (NCCL), and first, with two or more cards, K1, K2 and K3 on
   cuda:1 tensors while cuda:0 is current, bitwise the same calls on
   cuda:0: ``sharded_solve`` of the bench batch (each rank bitwise its own
   ``solve_batch``, ``convergence_stats`` n_ok 1024, the distribution rule
   against one card's solve, one K3 launch a rank), ``global_scenarios``
   from per-rank rows, ``sharded_search`` static, dynamic and on a shared
   map (bitwise per rank, reached within ±10 of 962), and ``edt_sharded``
   at 512^3 (bitwise one card's ``sdf.edt``, 2 K1 launches a rank; a
   512 x 96 x 48 grid against the native oracle) and at 8192 x 256 x 32
   (x lines past 4096 cells: K1's long-line kernel, bitwise one card's
   ``sdf.edt``); the world size, and the sharded solve's and EDT's times;
17. exact cropping (``solver.crop_scenarios``, K3's crop frame): the
   256-lane opti_node shared map (bench.py:370-435) solved full and
   cropped, one K3 launch each (n_ok and the window equal to the JAX
   package's, ``scripts/crop_targets.py``; cropped dp and cost bitwise
   the full solve on every lane; K3 against its plain version on the
   cropped inputs; K3 device ms full and cropped, the crop's ms); the
   per-lane crop of tests/test_solve.py's fixture (bitwise); the 512^3
   stress pipeline (``scripts/stress_pipeline_512_torch.py``: 256/256 ok,
   bitwise, the JAX window; each stage's time); the Monte-Carlo run
   (``scripts/monte_carlo_torch.py``) at 8 chunks of 1024, and 4 + 4
   across a checkpoint with equal aggregates; ``examples/demo_torch.py``
   in this process (status 0, the scene exported);
18. the JAX-free measurement entry points, in this process:
   ``bench_torch.run`` at B = 1024 (every key of ``bench.py``'s line, the
   counts of phases 6-11 and 17, its JSON on a line of its own: the one
   timing of the rows that phases 6-11 and 17 check), the
   ``SolveServer`` sweep (``scripts/serve_bench_torch.py``) at 500 and 2000
   requests/s and the ``MissionServer`` sweep
   (``scripts/mission_serve_bench_torch.py``) at 100 and 400 missions/s, 4 s
   each (every request answered and ok as a direct ``plan_batch``), the
   beam-vs-exact suite (``scripts/beam_vs_exact_torch.py``) on the kino and
   hybrid arms against the JAX script's CPU numbers
   (``scripts/bench_targets.py``), and one run of the replan tick bench
   (``scripts/bench_replan_tick_torch.py``; both loops reach the goal);
19. the per-iteration descent (``solve_batch_fused``, one K2 launch an
   evaluation), wherever the solver's rule does not pick K3: the bench
   batch with ``lookup_mode="fused"`` through ``solve_batch`` (K3 0, K2
   101; every lane ok; bitwise the same loop with K2's plain version;
   against K3 by the lane rule at 10 iterations and the distribution rule
   at 100), ``step_rule="adaptive"`` and ``accept_window=200`` through
   ``solve_batch``, ``solve_kino_batch`` adaptive on phase 9's knots, and
   the opti_node waypoints cut into a 51-waypoint mission on 256 jittered
   lanes of the shared map (every lane ok, the clearance); its solves/s
   beside K3's, the device time of the descent (a CUDA graph) against
   its host time, ATen operations an evaluation and K2's time at its
   shape.  Phase 16 runs ``sharded_solve_fused`` on every rank too;
20. shapes and options the JAX package answers: ``solve_cuda.supports``
   against K3's own plan (``solve_cuda.plan``) on 1008 shapes, 0
   mismatches, and the Python limits against the card's
   (``solve_cuda.limits``); 256 lanes of each shape K3 cannot launch
   (``fixtures.K3_REFUSED_SHAPES``) through ``solve_batch``, K3 0 and
   every lane ok; K1 on lines of 4097, 6000 and 20 000 cells bitwise its
   plain version; the 8192-cell x pass over 512 x 48 columns of random
   reals (every line on the two-rounding path) and of an occupancy
   grid's z and y passes (every line on the exact integer path, by the
   kernel's own counters), each bitwise its plain version out of place
   and in place and timed against its bound; the long-line kernel on the
   bench's 100-cell y and x passes, bitwise, beside the staged kernel;
   ``sdf.edt`` of a 6000 x 16 x 8 grid bitwise the CPU field; the beam
   search's ``lex512``, ``approx512``, ``pp64``, ``pp8``, ``parent`` and
   box arms on 32 bench missions, each equal to the same call on the CPU.

The line before the last is a JSON object with, for each kernel, its
launches on the counted paths (phases 6, 9-19; in all and per path,
phase 16's summed over its ranks),
its error against its plain version, its time and the plain version's
(K1 with a ``long_line`` entry for its long-line kernel, K3 with the
``dispatch_sweep`` of phase 20),
its bound (``bound_ms``: the larger of its bytes at 3.35 TB/s and its
operations at 67 TFLOP/s, ``bound_by``/``bound_of`` saying which) and
``library_ms`` (null: no single PyTorch call computes any of the three);
the last line is ``{"ok": true, "device": {...}}``.
Needs one GPU (phase 16 takes every visible one), ``nvcc`` and no
network; every time printed is labelled
with the card and its power limit.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts"))

from _bench_common_torch import (  # noqa: E402
    bench_missions, bench_prediction, opti_node_lanes,
)

from grad_traj_optimization_torch.utils import profiling  # noqa: E402

#: each kernel's launch counter (``utils.profiling``) by its name here
KERNEL_COUNTERS = {"K1": "launch.minplus_along",
                   "K1 long": "launch.minplus_long",
                   "K2": "launch.trilinear_batch", "K3": "launch.descend"}
BATCH = 1024
N_WP = 7
SEED = 42
SHORT_ITERS = 10
# Short-budget lane agreement.  Two f32 runs of one algorithm that differ
# only in summation order do not agree on every lane after 10 iterations:
# a near-tie accept decision or a BB step on a tiny gradient change sends
# a lane down another path.  On the H100 the f32 plain loop matches its
# own float64 run on 974 of the 1024 bench lanes (95.1%).  So the kernel
# must agree with the f32 plain loop on 95% of lanes, and be no further
# from the float64 loop than the f32 plain loop is, give or take 1% of
# lanes.
MIN_AGREE = 973
MAX_EXTRA_DRIFT = 10
# Phase 8 targets: lanes of the 1024 bench missions that the JAX package's
# gather path reaches (search_batch with lookup="gather", beam=64,
# max_iters=16; search_batch_adaptive with retries=1 for "retry"), run on
# the CPU.  The port must land within REACHED_SLACK lanes of each.
TARGET_REACHED = {"static": 962, "dynamic": 962, "retry": 1000}
REACHED_SLACK = 10
N_CPU_LANES = 32
# Phase 11 target: the JAX package's plan_batch(host_fallback=True) on the
# same 1024 bench missions (beam 64, 16 iterations, retries=1, the JAX
# bench's call) with lookup="gather", run on the CPU by
# scripts/online_targets.py: 1024 reached, 1024 ok, 24 lanes recovered
# by the host rung.  The port's ok count must land within REACHED_SLACK.
TARGET_LADDER_OK = 1024
# Phases 13 and 14 targets: the JAX package's replan loops on the CPU with
# the same inputs (scripts/online_targets.py): (ticks, reached goal).
TARGET_REPLAN = {"static": (9, True), "dynamic": (13, True),
                 "fallback": (10, True), "rrt": (14, True)}
# Phase 15 targets: the JAX package's harness on the CPU with the same
# inputs (scripts/compare2_targets.py): scripts/run_compare2_suite.py's 20
# cases through run_suite with COMPARE2_CONFIG and n_waypoints=6.
TARGET_COMPARE2 = {"n_ok": 20, "n_frontend_ok": 20, "n_via_fallback": 0}
TARGET_COMPARE2_COST = (
    1043.3472900390625, 239.42965698242188, 116.84107971191406,
    4321.85693359375, 636.9586791992188, 467.6376953125, 3831.76416015625,
    395.1547546386719, 2888.877197265625, 480.5300598144531,
    4981.40576171875, 748.1168823242188, 1479.499267578125,
    336.2311706542969, 3948.7919921875, 825.5534057617188,
    1788.6759033203125, 280.5648498535156, 1149.8519287109375,
    3543.00244140625)
# At compare2's 25-iteration budget the descent is still falling fast, and
# two float32 runs that differ only in summation order part by up to 5%
# on a few cases (on the CPU the port's plain loop is within 5e-3 of the
# JAX package on 16 of the 20, and its own float64 run parts from its
# float32 run by 3.8% and 5.2% on two of the others).  So the final costs
# are held by the repo's full-budget distribution rule
# (__graft_entry__.py:109-117): |log cost ratio| p50 < 0.02, p90 < 0.25,
# mean < 0.10; the count within 5e-3 is printed.
COMPARE2_RTOL = 5e-3
#: phase 14's rung case: bench missions under a starved beam
#: (tests/test_torch_cuda.py:315), one race stretch
RUNG_MISSIONS = 64
STARVED_BEAM = dict(beam=2, max_iters=3, retries=0, stretches=(1.0,))
#: phase 12's burst: requests from this many threads
N_SUBMIT_THREADS = 8
#: futures' and phases' time limits, seconds
FUTURE_TIMEOUT = 300
SEARCH_KW = dict(beam=64, max_iters=16)
#: an odd grid for K1: I < 32 on the y pass, I not a multiple of 32 on x
ODD_SHAPE = (3, 37, 41, 25)
#: map resolutions of fixtures.text_input_scenario, the bench and
#: opti_node maps, fixtures.random_search_case and the tests' MAP: K2's
#: division by res is checked at each
DIV_RESOLUTIONS = (0.1, 0.2, 0.25, 0.5)
#: the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 bytes
#: a second and float32 operations a second outside the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
#: phase 13: the wall that appears at the third replan tick on the
#: opti_node map (200 x 200 x 25 at 0.2 m), cells [lo, hi): x -4..4 m,
#: y 0.4..0.8 m, full height, with a gap at x 1.0..2.6 m
WALL_LO, WALL_HI, WALL_GAP = (80, 102, 0), (120, 104, 25), (105, 113)
WALL_TICK = 2


def wall_occupancy(occ0: np.ndarray) -> np.ndarray:
    """The opti_node occupancy with phase 13's wall added (numpy)."""
    occ = occ0.copy()
    (x0, y0, z0), (x1, y1, z1) = WALL_LO, WALL_HI
    occ[x0:x1, y0:y1, z0:z1] = 1.0
    occ[WALL_GAP[0]:WALL_GAP[1], y0:y1, z0:z1] = 0.0
    return occ


def replan_boxes(t: float):
    """Phase 13's two predicted boxes at time t, as pose histories (the
    last two samples, 0.5 s apart): both cross the route along +x at
    0.8 m/s, at y = -1.5 m from x = -4 m and at y = 3.5 m from x = -6 m,
    each after the vehicle has passed."""
    ht = np.array([[t - 0.5, t]] * 2)
    xa = -4.0 + 0.8 * ht[0]
    xb = -6.0 + 0.8 * ht[1]
    hist = np.stack([
        np.stack([xa, np.full(2, -1.5), np.full(2, 2.0)], -1),
        np.stack([xb, np.full(2, 3.5), np.full(2, 2.0)], -1),
    ])
    return hist, ht, np.array([[0.8, 0.8, 1.5]] * 2)


#: phase 13's three replan_loop runs, opti_node's first waypoint to its
#: last at rest: ReplanConfig fields over its defaults.  The horizon is
#: 10.5 m, past the 10 m mission, so every search aims at the goal
#: itself: at the default 7 m the first clipped target (0, 2, 2) lies
#: inside the map's first wall, so every search fails and the vehicle
#: hovers for all 40 ticks, in the JAX package as in the port; at 8 m
#: the fallback run's exact A* finds no path to its clipped target
REPLAN_HORIZON = 10.5
REPLAN_RUNS = {"static": dict(horizon=REPLAN_HORIZON),
               "dynamic": dict(horizon=REPLAN_HORIZON),
               "fallback": dict(horizon=REPLAN_HORIZON, kino_iters=1,
                                kino_beam=8)}


# ---- 17: crop and stress (constants; numpy helpers) -------------------

#: the opti_node shared-map row (bench.py:370-384): 256 jittered copies
#: of the 11 waypoints on one 200 x 200 x 25 map
OPTI_LANES = 256
#: phase 17 targets, the JAX package's on the CPU (scripts/crop_targets.py):
#: status-ok lanes of its gather path on the opti_node row (full grid), and
#: its crop_scenarios windows (cell offset, shape) for that row and for the
#: 512^3 stress lanes
TARGET_OPTI_N_OK = 256
TARGET_WINDOWS = {"opti_node": ((68, 48, 0), (72, 112, 25)),
                  "stress": ((193, 196, 15), (128, 128, 72))}


def min_agree_of(B: int) -> int:
    """Phase 5's 10-iteration lane rule (973 of 1024) scaled to B lanes."""
    return MIN_AGREE * B // BATCH


#: the per-lane crop case: tests/test_solve.py:266-343's fixture and
#: budget
CROP_FIXTURE = dict(n=6, n_waypoints=5, seed=7, max_obstacle_points=1024)
CROP_ITERS = dict(iters_step1=10, iters_step2=25)
#: the Monte-Carlo check: chunks of 1024, 8 in one run, and 4 + 4 across a
#: checkpoint
MC_CHUNK = 1024
MC_CHUNKS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def gpu_ms(fn, reps: int = 3) -> float:
    """Min over reps of one call's device time (CUDA events), warm."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def stream_ms(fn, n: int = 3, reps: int = 5) -> float:
    """Device time of one ``fn()`` run n times back to back, so that the
    host enqueues ahead of the device: events around the n calls, over n;
    min over reps, warm."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def _graph_of(fn, n: int):
    """A CUDA graph of n calls of ``fn`` (warmed on a side stream first),
    replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, n: int = 100, reps: int = 5) -> float:
    """Device time of one ``fn()`` without the host: a CUDA graph of n
    calls, replayed between two events, over n; min over reps, warm."""
    graph = _graph_of(fn, n)
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def cold_ms(fn, reps: int = 30) -> tuple[float, float]:
    """Device time of one ``fn()`` on a cold L2, (median, min) over reps:
    1 GiB is written before each call (the H100's L2 holds 50 MB), and
    the call is a CUDA graph of it, so that the host has enqueued it long
    before the device reaches it; events around the call alone."""
    flush = torch.empty(256 << 20, dtype=torch.float32, device="cuda")
    graph = _graph_of(fn, 1)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in pairs]
    return float(np.median(times)), min(times)


def k2_corner_cells(grids, origin, resolution, pos, d) -> int:
    """The distinct grid cells that K2's lookups at ``pos`` must read: the
    eight corners of every in-map point (``d != -1``), over the batch,
    each lane in its own grid or all in the one shared grid (leading dim
    1).  Neighbouring samples of a trajectory share corners."""
    from grad_traj_optimization_torch.fields import sdf

    B, S = pos.shape[:2]
    nx, ny, nz = grids.shape[1:]
    res3 = resolution[:, None, None]
    inside = d != -1.0
    idx = sdf.pos_to_index(pos - 0.5 * res3, origin[:, None, :],
                           res3)[inside]  # (n_in, 3)
    lane = (torch.arange(B, device=pos.device)[:, None].expand(B, S)[inside]
            if grids.shape[0] == B else 0)
    cells = []
    for a in (0, 1):
        cx = (idx[:, 0] + a).clamp(0, nx - 1)
        for b in (0, 1):
            cy = (idx[:, 1] + b).clamp(0, ny - 1)
            for c in (0, 1):
                cz = (idx[:, 2] + c).clamp(0, nz - 1)
                cells.append(((lane * nx + cx) * ny + cy) * nz + cz)
    return int(torch.unique(torch.cat(cells)).numel())


def host_ms(fn, n: int = 100) -> float:
    """Host time of one ``fn()`` (the enqueue, not the device work): n
    calls on the host clock, over n, warm."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e3


def wall_s(fn, reps: int = 3) -> float:
    """Min over reps of host wall time around a synchronized call, warm."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def lane_agree(n1, c1, p1, n2, c2, p2):
    """Per lane: equal n_accept, cost rtol 5e-3, positions < 1e-3 m."""
    perr = (p1 - p2).abs().amax((1, 2))
    c1, c2 = c1.double(), c2.double()
    return (n1 == n2) & ((c1 - c2).abs() <= 5e-3 * c2.abs()) \
        & (perr < 1e-3), perr


def k3_bound_ms(B, m, K, evals, use_a):
    """The least time the card could take for K3's work at these shapes,
    the larger of (operations, bytes): float32 operations of the compact
    form per sample and evaluation (position and velocity chains 6 x 3 x 2
    FMAs = 72, the gradient partials 72, the trilinear lookup ~70, the
    collision terms ~20; with the acceleration chain and the penalties 112
    more), Rpp @ x and the BB update per scenario, at 67 TFLOP/s; bytes of
    the inputs read once (the compact chains, dt, Rpp, the bounds, the
    seed, Df, misc and the eight grid corners of every sample), and of
    the outputs written once, at 3.35 TB/s."""
    S, P = m * K, 3 * m - 3
    per_sample = 72 + 72 + 70 + 20 + (112 if use_a else 0)
    flops = B * evals * (S * per_sample + 2 * 3 * P * P + 8 * 3 * P)
    chains = 3 if use_a else 2
    nbytes = B * (4 * (S * (6 * chains + 1) + P * P + 4 * 3 * P + 18 + 16)
                  + 32 * S + 4 * (3 * P + 2 + evals))
    return {"ops_ms": flops / FP32_FLOPS * 1e3,
            "bytes_ms": nbytes / HBM_BPS * 1e3}


def bound_entry(b):
    """bound_ms / bound_by / bound_of from a {ops_ms, bytes_ms} pair."""
    ops = b["ops_ms"] >= b["bytes_ms"]
    return dict(bound_ms=max(b["ops_ms"], b["bytes_ms"]),
                bound_by="operations" if ops else "bytes",
                bound_of="compute" if ops else "memory")


def k3_short_checks(tag, scns, cfg, positions, min_agree=MIN_AGREE):
    """Phase 5's two short-budget checks of K3 against its plain version
    for ``cfg``: every lane to rounding after one iteration; the lane
    agreement rule at SHORT_ITERS (at least ``min_agree`` lanes), the
    float64 plain loop as referee.  Returns (max position error after one
    iteration, agreeing lanes)."""
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.ops import solve_cuda

    B = scns.waypoints.shape[0]
    c1 = dataclasses.replace(cfg, iters_step2=1)
    kargs, (Df, _, T) = solver.kernel_inputs(scns, c1)
    Df64, T64 = Df.double(), T.double()
    before = profiling.counter("launch.descend")
    dk, ck, nk, _ = solve_cuda.descend(*kargs, ((2, 1),), c1)
    check(profiling.counter("launch.descend") == before + 1,
          f"{tag}: K3 not launched")
    dpl, cpl, npl, _ = solve_cuda.descend_plain(*kargs, ((2, 1),), c1)
    n1 = int((nk == npl).sum())
    c1_err = float(((ck.double() - cpl.double()).abs()
                    / cpl.double().abs()).max())
    p_err = float((positions(dk.double(), Df64, T64)
                   - positions(dpl.double(), Df64, T64)).abs().max())
    log(f"[{tag}] 1 iteration: n_accept equal on {n1}/{B} lanes, max "
        f"cost rel err {c1_err:.3g}, max |dpos| {p_err:.3g} m "
        f"(tolerance 1e-5 each)")
    check(n1 == B and c1_err <= 1e-5 and p_err <= 1e-5,
          f"{tag}: K3 differs from its plain version after one iteration")

    cs = dataclasses.replace(cfg, iters_step2=SHORT_ITERS)
    kargs, _ = solver.kernel_inputs(scns, cs)
    ph = ((2, SHORT_ITERS),)
    dk, ck, nk, _ = solve_cuda.descend(*kargs, ph, cs)
    dpl, cpl, npl, _ = solve_cuda.descend_plain(*kargs, ph, cs)
    # the same plain loop in float64: how far f32 rounding alone carries
    # an iterate in SHORT_ITERS steps on these lanes
    k64 = tuple(a.double() if isinstance(a, torch.Tensor) else a
                for a in kargs)
    d64, c64, n64, _ = solve_cuda.descend_plain(*k64, ph, cs)
    pos_k = positions(dk.double(), Df64, T64)
    pos_p = positions(dpl.double(), Df64, T64)
    pos_64 = positions(d64, Df64, T64)
    lane_ok, perr = lane_agree(nk, ck, pos_k, npl, cpl, pos_p)
    k_vs_64 = int(lane_agree(nk, ck, pos_k, n64, c64, pos_64)[0].sum())
    p_vs_64 = int(lane_agree(npl, cpl, pos_p, n64, c64, pos_64)[0].sum())
    n_agree = int(lane_ok.sum())
    for b in torch.nonzero(~lane_ok).flatten().tolist():
        log(f"    K3 lane {b}: n_accept {int(nk[b])} vs {int(npl[b])}, "
            f"cost {float(ck[b]):.6g} vs {float(cpl[b]):.6g}, max "
            f"|dpos| {float(perr[b]):.3g} m")
    log(f"[{tag}] {SHORT_ITERS} iterations: {n_agree}/{B} lanes with "
        f"equal n_accept, cost rtol 5e-3 and positions < 1e-3 m (max "
        f"|dpos| over all lanes {float(perr.max()):.3g} m); against the "
        f"float64 plain loop: kernel {k_vs_64}/{B}, f32 plain {p_vs_64}/{B}")
    check(n_agree >= min_agree,
          f"{tag} short budget: {n_agree}/{B} lanes agree < {min_agree}")
    check(k_vs_64 >= p_vs_64 - MAX_EXTRA_DRIFT,
          f"{tag} short budget: kernel agrees with float64 on {k_vs_64} "
          f"lanes, f32 plain on {p_vs_64}")
    return p_err, n_agree


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def phase_frontend(dist, wps, map_cfg, card):
    """Phase 8: search_batch, static and dynamic, on the bench fields."""
    from grad_traj_optimization_torch.search import kinodynamic as kd
    from grad_traj_optimization_torch.search.predictor import ObjPrediction

    dev = dist.device
    B = wps.shape[0]
    res = map_cfg.resolution
    starts, goals, origins = bench_missions(wps, map_cfg, dev)
    pred = bench_prediction(B, dev)
    zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
    sl = slice(0, N_CPU_LANES)
    cpu_pred = ObjPrediction(*(x[sl].cpu() for x in pred))
    for mode, p in (("static", None), ("dynamic", pred)):
        def run():
            return kd.search_batch(dist, origins, res, starts, goals,
                                   obstacle_pred=p,
                                   start_times=None if p is None else zeros,
                                   **SEARCH_KW)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = run()
        torch.cuda.synchronize()
        peak = peak_gb()
        n = int(r.reached.sum())
        # the same port code on the CPU: the card's sorts, argmins and
        # gathers must land on the same beams
        rc = kd.search_batch(
            dist[sl].cpu(), origins[sl].cpu(), res, starts[sl].cpu(),
            goals[sl].cpu(), obstacle_pred=None if p is None else cpu_pred,
            start_times=None if p is None else zeros[sl].cpu(), **SEARCH_KW)
        same_reached = bool(torch.equal(rc.reached, r.reached[sl].cpu()))
        k_err = max(float((a[sl].cpu() - b).abs().max())
                    for a, b in zip(r[:4], rc[:4]))
        log(f"[8 search {mode}] reached {n}/{B} (JAX gather path "
            f"{TARGET_REACHED[mode]}), peak {peak:.2f} GiB {card}; "
            f"first {N_CPU_LANES} lanes on the CPU: reached equal "
            f"{same_reached}, max knot-state difference {k_err:.3g}")
        check(same_reached and k_err <= 1e-4,
              f"search {mode}: the card and the CPU disagree")
        check(abs(n - TARGET_REACHED[mode]) <= REACHED_SLACK,
              f"search {mode}: reached {n}, target {TARGET_REACHED[mode]}")
        check(bool(torch.isfinite(r.pos).all()
                   & torch.isfinite(r.times).all()),
              f"search {mode}: non-finite knots")


def phase_pipeline(dist, wps, map_cfg, card, counted):
    """Phase 9: search_batch_adaptive -> resample_knots_batch ->
    solve_kino_batch (then the race), and plan_batch.  Returns the
    refine's solve_kino_batch arguments (field, origins, resolutions and
    the resampled knots) for phase 19."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import pipeline, solver
    from grad_traj_optimization_torch.search import kinodynamic as kd

    dev = dist.device
    B = wps.shape[0]
    res = map_cfg.resolution
    cfg = gto.OptimizerConfig()
    starts, goals, origins = bench_missions(wps, map_cfg, dev)
    ress = torch.full((B,), res, dtype=torch.float32, device=dev)

    knots = []

    def run(race):
        r, n_re, _ = kd.search_batch_adaptive(dist, origins, res, starts,
                                              goals, retries=1, **SEARCH_KW)
        p6, v6, a6, t6 = kd.resample_knots_batch(r.pos, r.vel, r.acc,
                                                 r.times, 6)
        args = (dist, origins, ress, p6, v6, a6, t6)
        if race:
            sol = solver.solve_kino_batch_race(*args, stretches=(1.0, 1.2),
                                               cfg=cfg, steps=(2,))
        else:
            sol = solver.solve_kino_batch(*args, cfg=cfg, steps=(2,))
            knots.append(args)
        return r, n_re, sol, p6

    for race in (False, True):
        tag = "race" if race else "refine"
        torch.cuda.reset_peak_memory_stats()

        def path():
            r, n_re, sol, p6 = run(race)
            ok = r.reached & (sol.status == solver.STATUS_OK)
            idx = torch.nonzero(ok).flatten()
            clear = solver.min_clearance(
                solver.Solution(*(x[idx] for x in sol)),
                solver.Scenario(dist[idx], origins[idx], ress[idx], p6[idx]))
            return r, n_re, sol, ok, clear

        r, n_re, sol, ok, clear = counted(f"pipeline {tag}", path,
                                          {"K3": 2 if race else 1, "K2": 1})
        peak = peak_gb()
        n_reached = int(r.reached.sum())
        n_ok = int(ok.sum())
        check(abs(n_reached - TARGET_REACHED["retry"]) <= REACHED_SLACK,
              f"pipeline: reached {n_reached}, target "
              f"{TARGET_REACHED['retry']}")
        check(n_ok == n_reached, f"pipeline {tag}: {n_reached - n_ok} "
              "reached lanes did not converge")
        check(bool(torch.isfinite(sol.cost[ok]).all()),
              f"pipeline {tag}: non-finite costs")
        log(f"[9 pipeline {tag}] reached {n_reached}/{B} ({n_re} lanes "
            f"retried), ok {n_ok}/{B}; min clearance on ok lanes: median "
            f"{float(clear.median()):.3f} m, {int((clear > 0).sum())}/{n_ok}"
            f" collision-free; peak {peak:.2f} GiB {card}")

    def plan():
        return pipeline.plan_batch(dist, origins, res, starts, goals,
                                   cfg=cfg, retries=1, long_tau_arm=False,
                                   **SEARCH_KW)

    pr = counted("plan_batch", plan, {"K3": 2})
    t = wall_s(plan)
    check(abs(int(pr.reached.sum()) - TARGET_REACHED["retry"])
          <= REACHED_SLACK, "plan_batch reach")
    check(int(pr.ok.sum()) == int(pr.reached.sum()),
          "plan_batch: reached lanes did not converge")
    log(f"[9 plan_batch] reached {int(pr.reached.sum())}/{B}, ok "
        f"{int(pr.ok.sum())}/{B}, {pr.n_retried} lanes retried; "
        f"{B / t:.1f} plans/s ({t * 1e3:.1f} ms per {B}, warm, min of 3) "
        f"{card}")
    return knots[0]


def phase_dual(scns, card, counted):
    """Phase 10: the dual-seed presets against OptimizerConfig()."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import config, solver

    B = scns.waypoints.shape[0]
    ref = solver.solve_batch(scns, cfg=gto.OptimizerConfig())
    for name, n_k3 in (("TURBO_POLISH_CONFIG", 3), ("TURBO_SAFE_CONFIG", 2)):
        cfg = getattr(config, name)
        sol = counted(name, lambda: solver.solve_batch(scns, cfg=cfg),
                      {"K3": n_k3})
        n_ok = int((sol.status == solver.STATUS_OK).sum())
        check(n_ok == B, f"{name}: status ok on {n_ok}/{B} lanes")
        ratio = (sol.cost.double() / ref.cost.double()).cpu().numpy()
        gm = float(np.exp(np.mean(np.log(ratio))))
        p99 = float(np.percentile(ratio, 99))
        mx = float(ratio.max())
        log(f"[10 dual {name}] {n_ok}/{B} status ok, {n_k3} K3 launches; "
            f"cost ratio vs OptimizerConfig(): geometric mean {gm:.4f}, "
            f"p99 {p99:.4f}, max {mx:.6f} {card}")
        if name == "TURBO_SAFE_CONFIG":
            # the reference arm runs OptimizerConfig()'s very K3 program,
            # so no lane may end worse (config.py: the never-worse preset)
            check(mx <= 1.0 + 1e-6, f"{name}: cost ratio max {mx} > 1")


def pct(a, q):
    return float(np.percentile(a, q)) if len(a) else float("nan")


def phase_ladder(dist, wps, map_cfg, card, counted):
    """Phase 11: plan_batch with the exact host A* rung on the 1024 bench
    missions (the JAX bench's call, bench.py:283-287)."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import pipeline

    B = wps.shape[0]
    res = map_cfg.resolution
    starts, goals, origins = bench_missions(wps, map_cfg, dist.device)

    def ladder():
        return pipeline.plan_batch(dist, origins, res, starts, goals,
                                   cfg=gto.OptimizerConfig(), retries=1,
                                   host_fallback=True, **SEARCH_KW)

    # the race is 2 K3 launches (stretches 1.0 and 1.2), and the rung's
    # race 2 more when it recovers a lane
    pr = counted("ladder", ladder,
                 lambda r: {"K3": 2 + 2 * (r.n_host_fallback > 0)})
    n_reached, n_ok = int(pr.reached.sum()), int(pr.ok.sum())
    check(abs(n_ok - TARGET_LADDER_OK) <= REACHED_SLACK,
          f"ladder: ok {n_ok}, target {TARGET_LADDER_OK} +- {REACHED_SLACK}")
    check(bool(torch.isfinite(pr.solution.cost[torch.as_tensor(
        pr.ok, device=dist.device)]).all()), "ladder: non-finite costs")
    ends = pr.search.pos[:, -1].cpu().numpy()
    rec = pr.reached & np.isinf(pr.search.cost.cpu().numpy())
    check(int(rec.sum()) == pr.n_host_fallback, "ladder: recovered lanes")
    check(np.abs(ends[rec] - goals.cpu().numpy()[rec, :3]).max(initial=0)
          < 1e-4, "ladder: a recovered branch misses its goal")
    rung = pr.rung_ms
    log(f"[11 ladder] reached {n_reached}/{B}, ok {n_ok}/{B} (JAX gather "
        f"path on the CPU: {TARGET_LADDER_OK}), {pr.n_host_fallback} lanes "
        f"recovered by the host rung, {pr.n_retried} retried; the rung's "
        f"host time in this first run: download "
        f"{rung.get('download', 0):.2f} ms, host searches "
        f"{rung.get('search', 0):.2f} ms, resample + race + scatter "
        f"{rung.get('refine', 0):.2f} ms {card}")
    return pr


def _lane_rule(served, lanes):
    """Per lane: the served numpy Solution against the direct solve's
    (equal n_accept, cost rtol 5e-3, positions < 1e-3 m); returns
    (agreeing lanes, bitwise lanes)."""
    from grad_traj_optimization_torch.core import poly

    ok = bit = 0
    for sol, (d, i) in zip(served, lanes):
        c = torch.as_tensor(sol.coeff).double()
        T = torch.as_tensor(sol.T).double()
        dc, dT = d.coeff[i].cpu().double(), d.T[i].cpu().double()
        perr = float((poly.sample_uniform(c, T, 100)[0]
                      - poly.sample_uniform(dc, dT, 100)[0]).abs().max())
        cs_, cd = float(sol.cost), float(d.cost[i])
        ok += (int(sol.n_accept) == int(d.n_accept[i])
               and abs(cs_ - cd) <= 5e-3 * abs(cd) and perr < 1e-3)
        bit += all(np.array_equal(a, b[i].cpu().numpy())
                   for a, b in zip(sol, d))
    return ok, bit


def _recording(server):
    """Record each batch a server dispatches (its entries, in order)."""
    batches = []
    inner = server._dispatch

    def dispatch(batch):
        batches.append(list(batch))
        return inner(batch)

    server._dispatch = dispatch
    return batches


def phase_solve_server(scns, card, counted):
    """Phase 12: SolveServer at its defaults: a burst of 1024 bench
    scenarios from 8 threads, then 256 that share one field tensor."""
    from concurrent.futures import ThreadPoolExecutor

    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import serving, solver

    cfg = gto.OptimizerConfig()
    B = scns.waypoints.shape[0]
    own = [solver.Scenario(scns.dist[i], scns.origin[i],
                           scns.resolution[i], scns.waypoints[i])
           for i in range(B)]
    shared = [solver.Scenario(scns.dist[0], scns.origin[i % B],
                              scns.resolution[i % B], scns.waypoints[i % B])
              for i in range(256)]
    for tag, reqs in (("burst", own), ("shared map", shared)):
        srv = serving.SolveServer()
        batches = _recording(srv)

        def serve():
            chunks = [reqs[k::N_SUBMIT_THREADS]
                      for k in range(N_SUBMIT_THREADS)]
            with ThreadPoolExecutor(N_SUBMIT_THREADS) as ex:
                futs = list(ex.map(lambda c: [srv.submit(r) for r in c],
                                   chunks))
            return [(r, f.result(timeout=FUTURE_TIMEOUT))
                    for c, fs in zip(chunks, futs) for r, f in zip(c, fs)]

        try:
            out = counted(f"SolveServer {tag}", serve, lambda _: {
                "K3": sum(len(srv._bucket_groups(len(b)))
                          for b in batches)})
        finally:
            srv.shutdown()
        n_ok = sum(int(sol.status) == solver.STATUS_OK for _, sol in out)
        check(len(out) == len(reqs) and n_ok == len(reqs),
              f"SolveServer {tag}: {n_ok}/{len(reqs)} lanes status ok")
        # each group again, directly: the same padded lanes in one
        # solve_batch
        served = {id(r): sol for r, sol in out}
        pairs, sols = [], []
        for b in batches:
            entries = [e[0] for e in b]
            ofs = 0
            for g in srv._bucket_groups(len(entries)):
                sub = entries[ofs:ofs + g]
                sub = sub + [entries[-1]] * (g - len(sub))
                first = sub[0].dist
                d = solver.solve_batch(solver.Scenario(
                    first[None] if all(s.dist is first for s in sub)
                    else torch.stack([s.dist for s in sub]),
                    torch.stack([s.origin for s in sub]),
                    torch.stack([s.resolution for s in sub]),
                    torch.stack([s.waypoints for s in sub])), cfg=cfg)
                for i in range(min(g, len(entries) - ofs)):
                    pairs.append((served[id(entries[ofs + i])], (d, i)))
                ofs += g
        n_rule, n_bit = _lane_rule([p[0] for p in pairs],
                                   [p[1] for p in pairs])
        check(n_rule == len(reqs), f"SolveServer {tag}: {n_rule}/"
              f"{len(reqs)} lanes agree with the direct solve")
        st = srv.stats.summary()
        n_groups = sum(len(srv._bucket_groups(len(b))) for b in batches)
        log(f"[12 SolveServer {tag}] {len(reqs)} requests from "
            f"{N_SUBMIT_THREADS} threads, {st['n_batches']} batches (sizes "
            f"{srv.stats.batch_sizes}), {n_groups} K3 launches; all status "
            f"ok; {n_rule} lanes agree with a direct "
            f"solve_batch of their group ({n_bit} bitwise); wait p50/p99 "
            f"{st['wait_ms_p50']:.2f}/{st['wait_ms_p99']:.2f} ms, total "
            f"{st['total_ms_p50']:.2f}/{st['total_ms_p99']:.2f} ms, device "
            f"{st['device_ms_p50']:.2f}/{st['device_ms_p99']:.2f} ms, "
            f"assemble p50 {st['assemble_ms_p50']:.2f} ms, mean batch "
            f"{st['mean_batch']:.1f}, pad fraction "
            f"{st['pad_fraction']:.4f} {card}")


def _flown_clearance(results, field, origin, res, boxes=None):
    """Per flown tick: the least space-time distance over the window the
    vehicle flew (50 samples of [0, t_fly] of that tick's trajectory),
    against ``field`` and, with ``boxes``, the predicted boxes at the
    samples' absolute times."""
    from grad_traj_optimization_torch.core import poly
    from grad_traj_optimization_torch.fields import dynamic
    from grad_traj_optimization_torch.search import predictor

    dev = field.device
    f32 = dict(dtype=torch.float32, device=dev)
    t_abs, out = 0.0, []
    for r in results:
        T = torch.as_tensor(r.times, **f32)
        t_fly = min(0.5, float(T.sum()))
        if r.search_ok:
            ts = torch.linspace(0.0, t_fly, 50, **f32)
            pos = poly.evaluate(torch.as_tensor(r.coeff, **f32), T, ts)
            pred = None
            if boxes is not None:
                pred = predictor.fit_const_vel(
                    *(torch.as_tensor(x, **f32) for x in boxes(t_abs)))
            out.append(float(dynamic.evaluate_coarse(
                field, origin, res, pos, t_abs + ts, pred).min()))
        t_abs += t_fly
    return out


def phase_replan(dev, card, counted):
    """Phase 13: replan_loop on the opti_node map, static, with moving
    boxes and a wall added by edt_update at the third tick (held bitwise
    against a full edt), and the exact-A* fallback run."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import fixtures, replan
    from grad_traj_optimization_torch.fields import sdf

    mc, obss, wp = fixtures.opti_node_scenario()
    res = mc.resolution
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(mc.origin, **f32)
    occ0 = sdf.rasterize(torch.as_tensor(obss, **f32), origin, res,
                         mc.grid_shape)
    dist = sdf.edt(occ0, res)
    occ1 = torch.as_tensor(wall_occupancy(occ0.cpu().numpy()), device=dev)
    full = sdf.edt(occ1, res)
    start = np.concatenate([wp[0], np.zeros(3)])
    goal = np.concatenate([wp[-1], np.zeros(3)])
    ticks = {}
    for name, kw in REPLAN_RUNS.items():
        extra, updated = {}, []
        if name == "dynamic":
            def map_update(t, grid):
                updated.append(None)
                if len(updated) - 1 != WALL_TICK:
                    return None
                new = sdf.edt_update(grid, occ1, res, WALL_LO, WALL_HI,
                                     mode="add")
                updated[-1] = new
                return new

            extra = dict(obstacle_update=replan_boxes, map_update=map_update)

        def run():
            return replan.replan_loop(dist, mc.origin, res, start, goal,
                                      rcfg=replan.ReplanConfig(**kw),
                                      ocfg=gto.OptimizerConfig(), **extra,
                                      device=dev)

        results = counted(f"replan {name}", run, lambda rs: {
            "K3": sum(r.search_ok for r in rs)})
        n_t, reached = len(results), results[-1].reached_goal
        want_t, want_r = TARGET_REPLAN[name]
        check(reached or not want_r, f"replan {name}: goal not reached in "
              f"{n_t} ticks (the JAX package reaches it in {want_t})")
        flown = _flown_clearance(results, full if name == "dynamic" else
                                 dist, origin, res,
                                 replan_boxes if name == "dynamic" else None)
        check(min(flown) > 0, f"replan {name}: flown clearance {flown}")
        n_fb = sum(r.via_fallback for r in results)
        if name == "fallback":
            check(n_fb >= 1, "replan fallback: no tick via the exact A*")
        if name == "dynamic":
            check(updated[WALL_TICK] is not None, "the wall never appeared")
            check(torch.equal(updated[WALL_TICK], full),
                  "edt_update('add') is not bitwise a full edt")
            t_upd = gpu_ms(lambda: sdf.edt_update(dist, occ1, res, WALL_LO,
                                                  WALL_HI, mode="add"))
            t_full = gpu_ms(lambda: sdf.edt(occ1, res))
            log(f"[13 edt_update] add, box {WALL_LO}..{WALL_HI} on "
                f"{tuple(dist.shape)}: bitwise the full edt; {t_upd:.3f} ms "
                f"vs full rebuild {t_full:.3f} ms {card}")
        ticks[name] = n_t
        ts = [r.t_search * 1e3 for r in results]
        tf = [r.t_fallback * 1e3 for r in results
              if r.via_fallback or not r.search_ok]
        tr = [r.t_refine * 1e3 for r in results if r.search_ok]
        tick = [a + b + c for a, b, c in zip(
            ts, [r.t_fallback * 1e3 for r in results],
            [r.t_refine * 1e3 for r in results])]
        log(f"[13 replan {name}] {n_t} ticks (JAX package on the CPU: "
            f"{want_t}), reached {reached} ({want_r}), {n_fb} via the exact "
            f"A*, {sum(not r.search_ok for r in results)} hovering; flown "
            f"clearance min {min(flown):.3f} m, planned min "
            f"{min(r.min_clearance for r in results):.3f} m; tick p50/p99 "
            f"{pct(tick, 50):.1f}/{pct(tick, 99):.1f} ms: t_search "
            f"{pct(ts, 50):.1f}/{pct(ts, 99):.1f}, t_fallback "
            f"{pct(tf, 50):.1f}/{pct(tf, 99):.1f} ({len(tf)} ticks), "
            f"t_refine {pct(tr, 50):.1f}/{pct(tr, 99):.1f} ms {card}")
    return ticks


def phase_rrt_and_missions(dist, wps, map_cfg, card, counted):
    """Phase 14: replan_loop_rrt with the native tree on the opti_node
    map; MissionServer with the host rung on the first bench field, each
    served lane's flags against a direct plan_batch of its bucket."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import fixtures, pipeline, replan
    from grad_traj_optimization_torch import serving, solver
    from grad_traj_optimization_torch.fields import sdf

    dev = dist.device
    mc, obss, wp = fixtures.opti_node_scenario()
    scn = solver.make_scenario(wp, obss, mc, device=dev)

    def rrt():
        return replan.replan_loop_rrt(
            scn.dist, mc.origin, mc.resolution, wp[0], wp[-1],
            rcfg=replan.RRTReplanConfig(backend="native"),
            ocfg=gto.OptimizerConfig(), device=dev)

    results = counted("replan_loop_rrt", rrt, lambda rs: {
        "K3": sum(r.search_ok for r in rs)})
    want_t, want_r = TARGET_REPLAN["rrt"]
    check(results[-1].reached_goal or not want_r,
          f"replan_loop_rrt: goal not reached in {len(results)} ticks")
    flown = _flown_clearance(results, scn.dist, scn.origin, mc.resolution)
    check(min(flown) > 0, f"replan_loop_rrt: flown clearance {flown}")
    ts = [r.t_search * 1e3 for r in results]
    tr = [r.t_refine * 1e3 for r in results if r.search_ok]
    log(f"[14 replan_loop_rrt] native tree: {len(results)} ticks (JAX "
        f"package on the CPU: {want_t}), reached "
        f"{results[-1].reached_goal}, one K3 launch a tick; flown clearance "
        f"min {min(flown):.3f} m; tree p50/p99 {pct(ts, 50):.1f}/"
        f"{pct(ts, 99):.1f} ms, refine + fly p50/p99 {pct(tr, 50):.1f}/"
        f"{pct(tr, 99):.1f} ms {card}")

    # MissionServer: 256 bench missions on the first bench field, as
    # scripts/mission_serve_bench.py runs it
    n = min(256, wps.shape[0])
    starts, goals, _ = bench_missions(wps[:n], map_cfg, "cpu")
    starts, goals = starts.numpy(), goals.numpy()
    cfg = gto.OptimizerConfig()
    srv = serving.MissionServer(dist[:1], map_cfg.origin,
                                map_cfg.resolution, cfg=cfg, max_batch=256,
                                max_wait_ms=5.0, host_fallback=True,
                                device=dev, **SEARCH_KW)
    batches = _recording(srv)

    t_serve, runs = [], []

    def serve():
        t0 = time.perf_counter()
        futs = [srv.submit(starts[i], goals[i]) for i in range(n)]
        outs = [f.result(timeout=FUTURE_TIMEOUT) for f in futs]
        t_serve.append(time.perf_counter() - t0)
        return outs

    def direct(b):
        """The batch's padded bucket through plan_batch directly."""
        pad = serving._pow2(len(b), srv.max_batch) - len(b)
        s = np.stack([e[0] for e in b] + [b[-1][0]] * pad)
        g = np.stack([e[1] for e in b] + [b[-1][1]] * pad)
        return pipeline.plan_batch(srv.dist, map_cfg.origin,
                                   map_cfg.resolution, s, g, cfg=cfg,
                                   host_fallback=True, **SEARCH_KW)

    def expect(_):
        # each served batch's launches, from its direct re-run (run after
        # the counts are read): 2 for the race, 2 more when the rung
        # recovers a lane
        runs.extend(direct(b) for b in batches)
        return {"K3": sum(2 + 2 * (d.n_host_fallback > 0) for d in runs)}

    try:
        outs = counted("MissionServer", serve, expect)
    finally:
        srv.shutdown()
    flags = [(bool(r.reached[i]), bool(r.ok[i]))
             for r, b in zip(runs, batches) for i in range(len(b))]
    got = [(o["reached"], o["ok"]) for o in outs]
    check(got == flags, "MissionServer: served flags differ from a direct "
          "plan_batch of the same bucket")
    st = srv.stats.summary()
    log(f"[14 MissionServer] {n} bench missions on the first bench field: "
        f"{sum(o['reached'] for o in outs)} reached, "
        f"{sum(o['ok'] for o in outs)} ok, equal to a direct plan_batch of "
        f"each bucket; {st['n_batches']} batches (sizes "
        f"{srv.stats.batch_sizes}), "
        f"{sum(d.n_host_fallback for d in runs)} lanes by the host rung; "
        f"total p50/p99 {st['total_ms_p50']:.1f}/{st['total_ms_p99']:.1f} "
        f"ms, {n / t_serve[0]:.1f} missions/s over the burst {card}")


def phase_mission_rung(dist, wps, map_cfg, card, counted):
    """Phase 14, the rung under MissionServer: a starved beam
    (tests/test_torch_cuda.py:315) leaves lanes unreached, which the
    exact host A* recovers; every lane must end ok."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import pipeline, serving, solver

    n = min(RUNG_MISSIONS, wps.shape[0])
    starts, goals, _ = bench_missions(wps[:n], map_cfg, "cpu")
    starts, goals = starts.numpy(), goals.numpy()
    cfg = gto.OptimizerConfig()
    srv = serving.MissionServer(dist[:1], map_cfg.origin,
                                map_cfg.resolution, cfg=cfg, max_batch=n,
                                max_wait_ms=5.0, host_fallback=True,
                                device=dist.device, **STARVED_BEAM)
    batches = _recording(srv)
    runs = []

    def serve():
        futs = [srv.submit(starts[i], goals[i]) for i in range(n)]
        return [f.result(timeout=FUTURE_TIMEOUT) for f in futs]

    def expect(_):
        # each served batch's direct re-run (after the counts are read):
        # one K3 launch for the race, one more when the rung recovers a
        # lane
        for b in batches:
            pad = serving._pow2(len(b), srv.max_batch) - len(b)
            runs.append(pipeline.plan_batch(
                srv.dist, map_cfg.origin, map_cfg.resolution,
                np.stack([e[0] for e in b] + [b[-1][0]] * pad),
                np.stack([e[1] for e in b] + [b[-1][1]] * pad), cfg=cfg,
                host_fallback=True, **STARVED_BEAM))
        return {"K3": sum(1 + (d.n_host_fallback > 0) for d in runs)}

    try:
        outs = counted("MissionServer rung", serve, expect)
    finally:
        srv.shutdown()
    by_rung = sum(d.n_host_fallback for d in runs)
    n_ok = sum(o["ok"] for o in outs)
    n_status = sum(int(o["solution"].status) == solver.STATUS_OK
                   for o in outs)
    log(f"[14 MissionServer rung] {n} bench missions, beam "
        f"{STARVED_BEAM['beam']} x {STARVED_BEAM['max_iters']} iterations: "
        f"{by_rung} lanes by the host rung, {n_ok}/{n} ok, {n_status}/{n} "
        f"status ok; batches {srv.stats.batch_sizes} {card}")
    check(by_rung >= 1, "MissionServer rung: no lane recovered by the rung")
    check(n_ok == n and n_status == n,
          f"MissionServer rung: {n_ok} ok, {n_status} status ok of {n}")


def gap_wall_field(gap_lo, gap_hi, thickness_cells=1, dev="cuda"):
    """The tests' gap-wall map (tests/conftest.py:26) built with the
    port's sdf: a wall across y=0 of the 10 m arena with one gap at x in
    (gap_lo, gap_hi), 40 x 40 x 16 at 0.25 m.  Returns (dist, origin,
    res)."""
    from grad_traj_optimization_torch.fields import sdf

    origin = np.array([-5.0, -5.0, 0.0])
    res = 0.25
    rows = tuple(res * k for k in range(thickness_cells))
    pts = [(x, y, z) for x in np.arange(-5.0, 5.0, res) for y in rows
           for z in np.arange(0.1, 4.0, res) if not (gap_lo < x < gap_hi)]
    f32 = dict(dtype=torch.float32, device=dev)
    occ = sdf.rasterize(torch.as_tensor(np.array(pts), **f32),
                        torch.as_tensor(origin, **f32), res, (40, 40, 16))
    return sdf.edt(occ, res), origin, res


def _dist_rule(got, want):
    """The repo's full-budget distribution rule on |log cost ratio|
    (__graft_entry__.py:109-117): (holds, (p50, p90, mean))."""
    r = np.sort(np.abs(np.log(np.asarray(got) / np.asarray(want))))
    p50 = float(r[len(r) // 2])
    p90 = float(r[int(np.ceil(0.9 * (len(r) - 1)))])
    mean = float(np.mean(r))
    return p50 < 0.02 and p90 < 0.25 and mean < 0.10, (p50, p90, mean)


def phase_compare2(dev, card, counted):
    """Phase 15: the compare2 suite of scripts/run_compare2_suite.py on
    the card: its 20 cases built here, run_suite (warm_compile) and
    run_suite_batched against the JAX package's CPU results, the exact-A*
    retry, run_case_rrt, the compare2 logs and a checkpoint round trip."""
    import glob
    import shutil

    from grad_traj_optimization_torch import (
        checkpoint, fixtures, harness, solver,
    )
    from grad_traj_optimization_torch.config import (
        COMPARE2_CONFIG, OptimizerConfig,
    )
    from grad_traj_optimization_torch.search import grid_search as gs
    from grad_traj_optimization_torch.utils import profiling

    n_cases = len(TARGET_COMPARE2_COST)
    n_built = [0]

    def build():
        rng = np.random.default_rng(11)
        cases = []
        while len(cases) < n_cases:
            n_built[0] += 1
            c = fixtures.random_search_case(rng, n_pillars=(5, 10),
                                            gap_walls=None, device=dev)
            if c is not None:
                cases.append(c)
        return cases

    cases = counted("compare2 maps", build,
                    lambda _: {"K1": 2 * n_built[0], "K3": 0})
    check(all(c[0].device == dev and c[0].shape == (64, 64, 20)
              for c in cases),
          "compare2 maps: not 64 x 64 x 20 fields on the card")

    # the front end: each case's grid plan on the card equals the same
    # code's on the CPU (the card's field is bitwise the CPU's, phase 3);
    # cost_to_go's sweeps and both stages' times, from wrappers around
    # the module's functions while the card's plans run
    ctg_ms, ext_ms, n_sweeps = [], [], []

    def timed(fn, acc):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def counting(fn):
        def run(*a, **kw):
            n_sweeps[-1] += 1
            return fn(*a, **kw)
        return run

    saved = (gs.cost_to_go, gs.extract_path, gs._sweep)
    for dist, origin, res, start, goal in cases:
        n_sweeps.append(0)
        gs.cost_to_go = timed(saved[0], ctg_ms)
        gs.extract_path = timed(saved[1], ext_ms)
        gs._sweep = counting(saved[2])
        try:
            got = gs.plan(dist, origin, res, start, goal)
        finally:
            gs.cost_to_go, gs.extract_path, gs._sweep = saved
        want = gs.plan(dist.cpu(), origin, res, start, goal)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              "compare2: a grid plan on the card differs from the CPU's")

    # run_suite, as scripts/run_compare2_suite.py calls it: 2 K3 launches
    # a case (the untimed warm solve and the timed one)
    recs = counted("compare2 run_suite", lambda: harness.run_suite(
        cases, cfg=COMPARE2_CONFIG, n_waypoints=6, warm_compile=True),
        {"K3": 2 * n_cases})
    summ = harness.summarize(recs)
    got = {k: summ[k] for k in TARGET_COMPARE2}
    check(got == TARGET_COMPARE2,
          f"compare2 run_suite: {got}, JAX package {TARGET_COMPARE2}")
    final = np.array([r.cost_curve[-1] for r in recs], np.float64)
    rel = np.abs(final - TARGET_COMPARE2_COST) / np.asarray(
        TARGET_COMPARE2_COST)
    n_close = int((rel <= COMPARE2_RTOL).sum())
    ok, (p50, p90, mean) = _dist_rule(final, TARGET_COMPARE2_COST)
    check(ok, f"compare2 final costs vs JAX: |log ratio| p50 {p50} p90 "
              f"{p90} mean {mean}")
    check(all(all(b <= a for a, b in zip(r.cost_curve, r.cost_curve[1:]))
              for r in recs), "compare2: a cost curve is not monotone")

    # run_suite_batched: one K3 launch for the suite, under the profiler
    trace_dir = os.path.join("build", "compare2_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)

    def batched():
        with profiling.device_trace(trace_dir):
            return harness.run_suite_batched(cases, cfg=COMPARE2_CONFIG,
                                             n_waypoints=6)

    recb = counted("compare2 run_suite_batched", batched, {"K3": 1})
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    check(len(traces) == 1, f"device_trace wrote {traces}")
    with open(traces[0]) as f:
        check("descend_kernel" in f.read(),
              "the device trace does not name K3's descend_kernel")
    for b, r in zip(recb, recs):
        check(b.status == r.status and b.frontend_ok == r.frontend_ok,
              f"batched case {b.case_id}: flags differ from run_suite")
        check(abs(b.jerk - r.jerk) <= 1e-3 * abs(r.jerk)
              and abs(b.traj_time_s - r.traj_time_s)
              <= 1e-5 * abs(r.traj_time_s)
              and abs(b.cost_curve[-1] - r.cost_curve[-1])
              <= 1e-3 * abs(r.cost_curve[-1]),
              f"batched case {b.case_id} differs from run_suite")

    # the exact-A* retry: at clearance 1.2 the grid search seals the gap
    # (tests/test_replan_harness.py:324-354)
    gdist, gorigin, gres = gap_wall_field(-0.8, 0.8, dev=dev)
    s0, g0 = np.array([0.0, -3.0, 2.0]), np.array([0.0, 3.0, 2.0])
    fb = counted("compare2 fallback", lambda: harness.run_case(
        0, gdist, gorigin, gres, s0, g0,
        cfg=OptimizerConfig(iters_step1=4, iters_step2=12), clearance=1.2),
        {"K3": 1})
    check(fb.via_fallback and fb.frontend_ok and fb.status == 0,
          f"compare2 fallback case: {fb}")

    # run_case_rrt on the off-centre gap map (tests/test_misc.py:265)
    odist, oorigin, ores = gap_wall_field(0.8, 2.4, thickness_cells=2,
                                          dev=dev)
    rr = counted("compare2 run_case_rrt", lambda: harness.run_case_rrt(
        0, odist, oorigin, ores, s0, g0,
        cfg=OptimizerConfig(iters_step1=10, iters_step2=40), steps=(1, 2),
        rrt_iters=1500, seed=1), {"K3": 1})
    check(rr.status == 0 and rr.traj_length_m > 6.0,
          f"compare2 run_case_rrt: status {rr.status}, length "
          f"{rr.traj_length_m}")

    # the compare2 logs, parsed back; a checkpoint round trip of a batched
    # CUDA Solution, bitwise and on the card
    out = os.path.join("build", "compare2")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    front, back = os.path.join(out, "front2.txt"), os.path.join(out,
                                                                "back2.txt")
    harness.write_compare2_logs(recs, front, back)
    with open(front) as f:
        fl = f.read().splitlines()
    with open(back) as f:
        bl = f.read().splitlines()
    check(len(fl) == len(bl) == n_cases, "compare2 logs: line counts")
    for i, (a, b, r) in enumerate(zip(fl, bl, recs)):
        head, rest = a.split("solve_time:")
        st, tt, ac = rest.split(",")
        check(head == f"test2:{i + 1}" and float(st) == r.frontend_time_s
              and tt == f"traj_time:{r.traj_time_s}"
              and ac == f"acc_cost:{r.acc_cost}", f"front2 line {i}: {a}")
        costs = [float(x) for x in b.split(",cost:")[1].split(";")]
        check(b.startswith(f"test2:{i + 1},jerk:{r.jerk},time:")
              and costs == [float(c) for c in r.cost_curve],
              f"back2 line {i}")
    # the batched solve of run_suite_batched's shape: the compare2 fields
    # with straight 6-point waypoints
    batch = solver.Scenario(
        dist=torch.stack([c[0] for c in cases]),
        origin=torch.as_tensor(np.stack([c[1] for c in cases]),
                               dtype=torch.float32, device=dev),
        resolution=torch.full((n_cases,), cases[0][2], device=dev),
        waypoints=torch.as_tensor(np.stack([
            np.linspace(c[3], c[4], 6) for c in cases]), dtype=torch.float32,
            device=dev))
    sol = solver.solve_batch(batch, cfg=COMPARE2_CONFIG)
    path = checkpoint.save(os.path.join(out, "solution"), sol)
    back_sol = checkpoint.restore(path, sol)
    check(all(b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)
              for a, b in zip(sol, back_sol)),
          "checkpoint round trip of a CUDA Solution is not bitwise")

    be = [r.backend_time_s * 1e3 for r in recs]
    log(f"[15 compare2] {n_cases} cases (64 x 64 x 20 at 0.25 m, "
        f"{n_built[0]} maps built on the card), COMPARE2_CONFIG, 6 "
        f"waypoints: run_suite ok {summ['n_ok']}, front end ok "
        f"{summ['n_frontend_ok']}, via fallback {summ['n_via_fallback']} "
        f"(JAX package on the CPU: 20/20/0); grid plans equal to the CPU's; "
        f"final cost within {COMPARE2_RTOL} of the JAX package on {n_close}"
        f"/{n_cases}, |log ratio| p50 {p50:.3g} p90 {p90:.3g} mean "
        f"{mean:.3g} (limits 0.02/0.25/0.10); mean jerk "
        f"{summ['mean_jerk']:.5f}, acc cost {summ['mean_acc_cost']:.6f}, "
        f"traj time {summ['mean_traj_time_s']:.6f} s (JAX 82.02790/"
        f"1.124886/6.019740)")
    log(f"[15 compare2] batched: one K3 launch, every record within the "
        f"per-case rule; trace names descend_kernel; fallback case via the "
        f"exact A* (status {fb.status}); run_case_rrt status {rr.status}, "
        f"length {rr.traj_length_m:.3f} m; logs parsed back; checkpoint "
        f"round trip bitwise on the card")
    log(f"[15 compare2] front end p50/p95 {summ['frontend_p50_ms']:.2f}/"
        f"{summ['frontend_p95_ms']:.2f} ms; back end per case p50/p95 "
        f"{pct(be, 50):.3f}/{pct(be, 95):.3f} ms, batched "
        f"{recb[0].backend_time_s * 1e3:.3f} ms a case "
        f"({recb[0].backend_time_s * n_cases * 1e3:.3f} ms for {n_cases}); "
        f"cost_to_go p50/p95 {pct(ctg_ms, 50):.2f}/{pct(ctg_ms, 95):.2f} ms, "
        f"sweeps p50/max {pct(n_sweeps, 50):.0f}/{max(n_sweeps)}; "
        f"extract_path p50/p95 {pct(ext_ms, 50):.2f}/{pct(ext_ms, 95):.2f} "
        f"ms {card}")


# ---- 16: several cards ----------------------------------------------

#: phase 16's stress EDT: BASELINE.md:27's 512^3 grid (537 MB float32),
#: occupancy drawn as scripts/stress_edt_sharded.py draws it
STRESS_N = 512
STRESS_DENSITY = 5e-4
STRESS_RES = 0.2
#: the grid held against the native oracle, as tests/test_parallel.py:
#: 179-199 holds the JAX package's sharded EDT
ORACLE_SHAPE = (512, 96, 48)
ORACLE_TOL = 1e-4


def _bitwise(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def guard_check(occ, scns, map_cfg, card):
    """Phase 16, step 0: K1, K2 and K3 on cuda:1 tensors while cuda:0 is
    current, bitwise the same calls on cuda:0 (each wrapper makes its
    tensor's card current for the launch)."""
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.ops import edt_cuda, trilinear_cuda

    dev0, dev1 = torch.device("cuda:0"), torch.device("cuda:1")
    check(torch.cuda.current_device() == 0, "cuda:0 is not current")
    sq = sdf._nearest_sq_1d(occ, dim=-1)
    k1 = []
    for d in (dev0, dev1):
        x = sq.to(d, copy=True)
        k1 += [edt_cuda.minplus_along(x, -2).clone(),
               edt_cuda.minplus_along(x, -3)]
    rng = np.random.default_rng(SEED)
    lo = np.asarray(map_cfg.origin)
    pos = rng.uniform(lo - 1.0, lo + np.asarray(map_cfg.map_size) + 1.0,
                      (scns.dist.shape[0], 180, 3))
    args = (scns.dist, scns.origin, scns.resolution,
            torch.as_tensor(pos, dtype=torch.float32, device=dev0))
    k2 = [trilinear_cuda.trilinear_batch(*(a.to(d) for a in args))
          for d in (dev0, dev1)]
    k3 = [solver.solve_batch(scns.map(lambda x: x.to(d)))
          for d in (dev0, dev1)]
    torch.cuda.synchronize(dev1)
    ok = {"K1": all(_bitwise(a.cpu(), b.cpu())
                    for a, b in zip(k1[:2], k1[2:])),
          "K2": all(_bitwise(a.cpu(), b.cpu()) for a, b in zip(*k2)),
          "K3": all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(*k3))}
    log(f"[16 guard] K1 (y and x passes), K2 and K3 (solve_batch) on "
        f"cuda:1 with cuda:0 current, bitwise the same calls on cuda:0: "
        f"{ok}; current card after: {torch.cuda.current_device()} {card}")
    check(all(ok.values()) and torch.cuda.current_device() == 0,
          f"kernels on cuda:1 differ from cuda:0: {ok}")


def mesh_rank(rank, world, port, queue):
    """Phase 16 on one card: one spawned process a card, NCCL.  Each
    path's launches are counted here (the counters are per process); the
    checks and times go to rank 0 and from it to the parent, which holds
    them."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import fixtures, native, solver
    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.parallel import edt_sharded as pedt
    from grad_traj_optimization_torch.parallel import mesh as pmesh
    from grad_traj_optimization_torch.search import kinodynamic as kd
    from grad_traj_optimization_torch.search.predictor import ObjPrediction

    pmesh.init_distributed(f"localhost:{port}", world, rank)
    m = pmesh.make_mesh(world, 1)
    dev = pmesh.local_device(m)
    rep = {"rank": rank, "device": str(dev), "paths": {}, "checks": {},
           "ms": {}, "reached": {}}

    def counted(path, fn):
        torch.cuda.synchronize()
        profiling.reset_counters("launch.")
        profiling.reset_counters("plain.")
        out = fn()
        torch.cuda.synchronize()
        rep["paths"][path] = {k: profiling.counter(c)
                              for k, c in KERNEL_COUNTERS.items()}
        rep["paths"][path]["plain"] = sum(
            profiling.counters("plain.").values())
        return out

    def timed(fn, reps=3):
        """Min over reps of this card's event time, every rank starting
        at a barrier; the parent takes the slowest rank."""
        fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(reps):
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    def lanes_equal(got, want):
        """Every field equal, float32 fields bitwise (so that the NaN
        trace of a run without record_trace equals itself)."""
        return all(_bitwise(a.to_local(), b) if b.is_floating_point()
                   else torch.equal(a.to_local(), b)
                   for a, b in zip(got, want))

    # the bench batch, the whole of it on every card (as the JAX
    # package's sharded_solve takes a global batch)
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        BATCH, n_waypoints=N_WP, seed=SEED, max_obstacle_points=4096)
    res = map_cfg.resolution
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(map_cfg.origin, **f32)
    b = BATCH // world
    sl = slice(rank * b, (rank + 1) * b)

    def scenario(rows):
        occ = sdf.rasterize(torch.as_tensor(pts[rows], **f32), origin, res,
                            map_cfg.grid_shape,
                            valid_mask=torch.as_tensor(valid[rows],
                                                       device=dev))
        d = sdf.edt_batch(occ, res)
        n = d.shape[0]
        return solver.Scenario(d, origin.expand(n, 3).contiguous(),
                               torch.full((n,), res, **f32),
                               torch.as_tensor(wps[rows], **f32))

    whole = scenario(slice(None))
    cfg = gto.OptimizerConfig()
    sol = counted("sharded_solve", lambda: pmesh.sharded_solve(
        pmesh.shard_scenarios(whole, m), m, cfg=cfg))
    rows = whole.map(lambda x: x[sl].contiguous())
    rep["checks"]["sharded_solve lanes bitwise solve_batch of the rows"] = \
        lanes_equal(sol, solver.solve_batch(rows, cfg=cfg))
    rep["stats"] = {k: float(v) for k, v in
                    pmesh.convergence_stats(sol).items()}
    costs = sol.cost.full_tensor()
    if rank == 0:
        one = solver.solve_batch(whole, cfg=cfg)
        rep["rule"] = _dist_rule(costs.cpu().numpy(), one.cost.cpu().numpy())
    rep["checks"]["sharded_solve of the whole batch bitwise"] = lanes_equal(
        pmesh.sharded_solve(whole, m, cfg=cfg), solver.Solution(
            *(x.to_local() for x in sol)))
    rep["ms"]["sharded_solve"] = timed(
        lambda: pmesh.sharded_solve(whole, m, cfg=cfg))
    # the same rows without the mesh: what the sharding and the wrapping
    # into DTensors add
    rep["ms"]["solve_rows"] = timed(lambda: solver.solve_batch(rows,
                                                               cfg=cfg))
    # the per-iteration descent over the mesh (its default config,
    # lookup_mode="fused"): each rank bitwise its own solve_batch_fused
    fsol = counted("sharded_solve_fused", lambda: pmesh.sharded_solve_fused(
        whole, m))
    cfg_f = gto.OptimizerConfig(lookup_mode="fused")
    rep["checks"]["sharded_solve_fused lanes bitwise solve_batch_fused of "
                  "the rows"] = lanes_equal(
        fsol, solver.solve_batch_fused(rows, cfg=cfg_f))
    rep["fused_n_ok"] = float(pmesh.convergence_stats(fsol)["n_ok"])
    rep["ms"]["sharded_solve_fused"] = timed(
        lambda: pmesh.sharded_solve_fused(whole, m), reps=2)

    # global_scenarios: each rank builds only its own rows
    gsol = counted("global_scenarios", lambda: pmesh.sharded_solve(
        pmesh.global_scenarios(scenario(sl), m), m, cfg=cfg))
    rep["checks"]["global_scenarios equal to the shard_scenarios run"] = \
        all(torch.equal(a.to_local(), g.to_local())
            for a, g in zip(sol, gsol))

    # the bench missions, static, with phase 8's two moving boxes a lane,
    # and all lanes on the first bench map
    starts, goals, origins = bench_missions(wps, map_cfg, dev)
    pred = bench_prediction(BATCH, dev)
    zeros = torch.zeros((BATCH,), **f32)
    modes = {"static": (whole.dist, {}, {}),
             "dynamic": (whole.dist,
                         dict(obstacle_pred=pred, start_times=zeros),
                         dict(obstacle_pred=ObjPrediction(
                             *(x[sl] for x in pred)),
                             start_times=zeros[sl])),
             "shared": (whole.dist[:1], {}, {})}
    for mode, (dd, kw, kw_rows) in modes.items():
        r = counted(f"sharded_search {mode}", lambda: pmesh.sharded_search(
            dd, origins, res, starts, goals, m, **kw, **SEARCH_KW))
        own = kd.search_batch(dd if dd.shape[0] == 1 else dd[sl],
                              origins[sl], res, starts[sl], goals[sl],
                              **kw_rows, **SEARCH_KW)
        rep["checks"][f"sharded_search {mode} lanes bitwise search_batch "
                      "of the rows"] = lanes_equal(r, own)
        n = r.reached.to_local().sum().to(torch.int64)
        dist.all_reduce(n)
        rep["reached"][mode] = int(n)

    # the x-sharded EDT at the stress size, against one card's sdf.edt
    ms = pmesh.make_mesh(1, world)
    rng = np.random.default_rng(0)
    occ_np = np.empty((STRESS_N,) * 3, np.float32)
    for x in np.array_split(occ_np, 8):  # rng.random((n, n, n)) in slabs
        x[:] = rng.random(x.shape) < STRESS_DENSITY
    occ = torch.as_tensor(occ_np, device=dev)
    del occ_np
    out = counted("edt_sharded 512^3", lambda: pedt.edt_sharded(
        occ, STRESS_RES, ms))
    want = sdf.edt(occ, STRESS_RES)
    nxl = STRESS_N // world
    xs = slice(rank * nxl, (rank + 1) * nxl)
    rep["checks"]["edt_sharded 512^3 bitwise sdf.edt of the whole grid"] = \
        isinstance(out, DTensor) and _bitwise(out.to_local(), want[xs])
    del out, want
    rep["ms"]["edt_sharded"] = timed(
        lambda: pedt.edt_sharded(occ, STRESS_RES, ms))
    rep["ms"]["edt_one_card"] = timed(lambda: sdf.edt(occ, STRESS_RES))
    # x lines of 8192 cells: the all-to-all hands each rank whole lines,
    # which K1's long-line kernel transforms
    rng = np.random.default_rng(0)
    occ_np = np.empty(LONG_SHARDED, np.float32)
    for x in np.array_split(occ_np, 8):
        x[:] = rng.random(x.shape) < STRESS_DENSITY
    occ_long = torch.as_tensor(occ_np, device=dev)
    del occ_np
    tag = "x".join(map(str, LONG_SHARDED))
    out = counted(f"edt_sharded {tag}", lambda: pedt.edt_sharded(
        occ_long, STRESS_RES, ms))
    want = sdf.edt(occ_long, STRESS_RES)
    nxl = LONG_SHARDED[0] // world
    xs = slice(rank * nxl, (rank + 1) * nxl)
    rep["checks"][f"edt_sharded {tag} bitwise sdf.edt of the whole grid"] = \
        isinstance(out, DTensor) and _bitwise(out.to_local(), want[xs])
    del out, want
    rep["ms"]["edt_sharded_long"] = timed(
        lambda: pedt.edt_sharded(occ_long, STRESS_RES, ms))
    rep["ms"]["edt_one_card_long"] = timed(
        lambda: sdf.edt(occ_long, STRESS_RES))
    del occ_long
    occ_o = (np.random.default_rng(3).random(ORACLE_SHAPE)
             < STRESS_DENSITY).astype(np.float32)
    d_o = pedt.edt_sharded(occ_o, STRESS_RES, ms).full_tensor()
    if rank == 0:
        rep["oracle_err"] = float(np.abs(
            d_o.cpu().numpy() - native.edt(occ_o, STRESS_RES)).max())

    if world == 4:  # both axes at once: a (2, 2) mesh
        m22 = pmesh.make_mesh(2, 2)
        r22 = m22.get_local_rank("data")
        s22 = counted("sharded_solve (2, 2)", lambda: pmesh.sharded_solve(
            whole, m22, cfg=cfg))
        rows = slice(r22 * BATCH // 2, (r22 + 1) * BATCH // 2)
        rep["checks"]["(2, 2) sharded_solve lanes bitwise"] = lanes_equal(
            s22, solver.solve_batch(whole.map(lambda x: x[rows]), cfg=cfg))
        e22 = counted("edt_sharded 512^3 (2, 2)",
                      lambda: pedt.edt_sharded(occ, STRESS_RES, m22))
        h = STRESS_N // 2
        x22 = slice(m22.get_local_rank("space") * h,
                    (m22.get_local_rank("space") + 1) * h)
        rep["checks"]["(2, 2) edt_sharded 512^3 bitwise"] = _bitwise(
            e22.to_local(), sdf.edt(occ, STRESS_RES)[x22])

    reps = [None] * world
    dist.all_gather_object(reps, rep)
    if rank == 0:
        queue.put(reps)
    dist.destroy_process_group()


def phase_mesh(occ, scns, map_cfg, card, per_path, totals):
    """Phase 16: the parallel package on every visible card, one spawned
    process a card (NCCL): sharded_solve on the bench batch,
    global_scenarios, sharded_search (static, dynamic, shared map) and
    edt_sharded at 512^3, and sharded_solve_fused on the bench batch;
    each rank's launches are counted per path and summed into the
    kernels' line."""
    import socket

    from grad_traj_optimization_torch.config import OptimizerConfig

    world = torch.cuda.device_count()
    if world >= 2:
        guard_check(occ, scns, map_cfg, card)
    if BATCH % world:
        raise ValueError(f"{world} cards do not divide the {BATCH} lanes")
    log(f"[16 mesh] world size {world}: {world} process(es), one card each, "
        f"NCCL; mesh ({world}, 1) for the data paths and (1, {world}) for "
        "the EDT" + (", and (2, 2)" if world == 4 else "")
        + ("; at world 1 nothing is split, the path still runs through "
           "NCCL, the DeviceMesh and DTensor" if world == 1 else ""))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    # rank 0's report is a few KB, under the pipe's buffer, so its put
    # returns before this process reads; a rank that raises makes spawn
    # end the others and raise here
    queue = torch.multiprocessing.get_context("spawn").SimpleQueue()
    torch.multiprocessing.spawn(mesh_rank, args=(world, port, queue),
                                nprocs=world, join=True)
    reps = queue.get()
    r0 = reps[0]
    for rep in reps:
        for what, ok in rep["checks"].items():
            check(ok, f"rank {rep['rank']}: {what}")
    expect = {"sharded_solve": {"K3": 1},
              "sharded_solve_fused": {"K2": descent_evals(
                  OptimizerConfig(), (2,))},
              "global_scenarios":
              {"K1": 2, "K3": 1}, "edt_sharded 512^3": {"K1": 2},
              "edt_sharded " + "x".join(map(str, LONG_SHARDED)):
              {"K1": 2, "K1 long": 1},
              **{f"sharded_search {m}": {} for m in r0["reached"]}}
    if world == 4:
        expect.update({"sharded_solve (2, 2)": {"K3": 1},
                       "edt_sharded 512^3 (2, 2)": {"K1": 2}})
    for path, want in expect.items():
        want = {"K1": 0, "K1 long": 0, "K2": 0, "K3": 0, **want,
                "plain": 0}
        got = [rep["paths"][path] for rep in reps]
        log(f"    [16 {path}] launches per rank {got}")
        check(all(g == want for g in got),
              f"{path}: launches {got}, expected {want} on every rank")
        per_path[f"16 {path}"] = {k: sum(g[k] for g in got)
                                  for k in totals}
        for k in totals:
            totals[k] += per_path[f"16 {path}"][k]
    st = r0["stats"]
    holds, (p50, p90, mean) = r0["rule"]
    solve_ms = max(rep["ms"]["sharded_solve"] for rep in reps)
    rows_ms = max(rep["ms"]["solve_rows"] for rep in reps)
    log(f"[16 sharded_solve] world {world}: {BATCH} bench lanes, "
        f"{BATCH // world} a rank, each rank bitwise its own solve_batch; "
        f"convergence_stats n_ok {st['n_ok']:.0f}, mean cost "
        f"{st['mean_cost']:.6g}, mean accepted {st['mean_accept']:.4g}; "
        f"against one card's solve_batch of the whole batch |log cost "
        f"ratio| p50 {p50:.3g} p90 {p90:.3g} mean {mean:.3g}; "
        f"{solve_ms:.3f} ms (slowest rank, events, min of 3), "
        f"{BATCH / solve_ms * 1e3:.1f} solves/s world-wide; solve_batch of "
        f"the same rows without the mesh {rows_ms:.3f} ms; per rank "
        f"{[round(r['ms']['sharded_solve'], 3) for r in reps]} and "
        f"{[round(r['ms']['solve_rows'], 3) for r in reps]} ms {card}")
    check(st["n_ok"] == BATCH, f"sharded_solve n_ok {st['n_ok']}")
    f_ms = max(rep["ms"]["sharded_solve_fused"] for rep in reps)
    log(f"[16 sharded_solve_fused] world {world}: each rank bitwise its own "
        f"solve_batch_fused of its rows; n_ok {r0['fused_n_ok']:.0f}; "
        f"{f_ms:.3f} ms (slowest rank, events, min of 2), "
        f"{BATCH / f_ms * 1e3:.1f} solves/s world-wide {card}")
    check(r0["fused_n_ok"] == BATCH,
          f"sharded_solve_fused n_ok {r0['fused_n_ok']}")
    check(holds, f"sharded_solve against one card: p50 {p50} p90 {p90} "
                 f"mean {mean}")
    for mode, n in r0["reached"].items():
        tgt = TARGET_REACHED.get(mode)
        log(f"[16 sharded_search {mode}] world {world}: reached {n}/{BATCH}"
            + (f" (JAX gather path {tgt})" if tgt else "")
            + ", each rank bitwise its own search_batch")
        if tgt is not None:
            check(abs(n - tgt) <= REACHED_SLACK,
                  f"sharded_search {mode}: reached {n}, target {tgt}")
    edt_ms = max(rep["ms"]["edt_sharded"] for rep in reps)
    one_ms = r0["ms"]["edt_one_card"]
    log(f"[16 edt_sharded] per rank {[round(r['ms']['edt_sharded'], 3) for r in reps]} ms")
    log(f"[16 edt_sharded] world {world}: {STRESS_N}^3 at density "
        f"{STRESS_DENSITY}, bitwise sdf.edt of the whole grid on every "
        f"slab; {edt_ms:.3f} ms sharded (all-to-alls included; slowest "
        f"rank, events, min of 3) against {one_ms:.3f} ms for one card's "
        f"sdf.edt; {ORACLE_SHAPE} against the native oracle: max error "
        f"{r0['oracle_err']:.3g} m {card}")
    check(r0["oracle_err"] <= ORACLE_TOL,
          f"edt_sharded against the native oracle: {r0['oracle_err']} m")
    long_ms = max(rep["ms"]["edt_sharded_long"] for rep in reps)
    log(f"[16 edt_sharded] world {world}: {LONG_SHARDED} at density "
        f"{STRESS_DENSITY} (x lines of {LONG_SHARDED[0]} cells, K1's "
        f"long-line kernel), bitwise sdf.edt of the whole grid on every "
        f"slab; {long_ms:.3f} ms sharded against "
        f"{r0['ms']['edt_one_card_long']:.3f} ms for one card's sdf.edt "
        f"{card}")


# ---- 17: crop and stress ---------------------------------------------


def _crop_window(cropped):
    return (tuple(cropped.grid_offset[0].tolist()),
            tuple(cropped.dist.shape[1:]))


def _k3_turns_ms(pairs, cfg):
    """Device ms of K3 (3 launches back to back between events, over 3,
    min of 3) for each (tag, Scenario batch) in ``pairs``, measured in
    turns (a, b, b, a) and each arm's minimum kept."""
    from grad_traj_optimization_torch import solver
    from grad_traj_optimization_torch.ops import solve_cuda

    ph = ((2, cfg.iters_step2),)
    args = {tag: solver.kernel_inputs(scns, cfg)[0] for tag, scns in pairs}
    order = [t for t, _ in pairs]
    out = {}
    for tag in order + order[::-1]:
        k = args[tag]
        ms = stream_ms(lambda: solve_cuda.descend(*k, ph, cfg), reps=3)
        out[tag] = min(out.get(tag, math.inf), ms)
    return out


def phase_crop(dev, card, counted, positions):
    """Phase 17: exact cropping on the card and the entry points that use
    it: the 256-lane opti_node shared map solved full and cropped; the
    per-lane crop of tests/test_solve.py's fixture; the 512^3 stress
    pipeline (scripts/stress_pipeline_512_torch.py); the Monte-Carlo
    run across a checkpoint (scripts/monte_carlo_torch.py); the JAX-free
    demo (examples/demo_torch.py).  Returns the numbers the K3 entry
    reports."""
    import tempfile

    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import fixtures, solver
    from grad_traj_optimization_torch.fields import sdf

    import monte_carlo_torch as mc
    import stress_pipeline_512_torch as stress

    rep = {}
    cfg = gto.OptimizerConfig()

    # -- the opti_node shared map, 256 lanes (bench.py:370-435) ----------
    mc_o, obss_o, wp_o = fixtures.opti_node_scenario()
    scn_o = solver.make_scenario(wp_o, obss_o, mc_o, device=dev)
    lanes = opti_node_lanes(wp_o, OPTI_LANES)
    B = lanes.shape[0]
    batch = solver.Scenario(
        dist=scn_o.dist[None], origin=scn_o.origin.expand(B, 3),
        resolution=scn_o.resolution.expand(B),
        waypoints=torch.as_tensor(lanes, device=dev))
    full = counted("17 opti_node full", lambda: solver.solve_batch(
        batch, cfg=cfg), {"K3": 1})
    cropped = counted("17 opti_node crop", lambda: solver.crop_scenarios(
        batch, cfg), {"K3": 0})
    crop = counted("17 opti_node cropped", lambda: solver.solve_batch(
        cropped, cfg=cfg), {"K3": 1})
    win = _crop_window(cropped)
    n_ok = {k: int((s.status == solver.STATUS_OK).sum())
            for k, s in (("full", full), ("cropped", crop))}
    same = int(stress.bitwise_lanes(crop, full).sum())
    check(win == TARGET_WINDOWS["opti_node"],
          f"opti_node crop window {win}, JAX's {TARGET_WINDOWS['opti_node']}")
    check(n_ok == {"full": TARGET_OPTI_N_OK, "cropped": TARGET_OPTI_N_OK},
          f"opti_node row n_ok {n_ok}, JAX gather path {TARGET_OPTI_N_OK}")
    check(same == B, f"opti_node cropped solve bitwise the full one on "
                     f"{same}/{B} lanes")
    err_1, agree = k3_short_checks("17 K3 opti_node cropped", cropped, cfg,
                                   positions, min_agree=min_agree_of(B))
    t_crop = wall_s(lambda: solver.crop_scenarios(batch, cfg))
    ms = _k3_turns_ms([("full", batch), ("cropped", cropped)], cfg)
    log(f"[17 opti_node] {B} lanes sharing the {tuple(batch.dist.shape[1:])}"
        f" map: crop window offset {win[0]} shape {win[1]} (JAX's); n_ok "
        f"{n_ok} (JAX gather path {TARGET_OPTI_N_OK}); cropped dp and cost "
        f"bitwise the full solve on {same}/{B} lanes; K3 vs plain on the "
        f"cropped inputs: 1 iteration max |dpos| {err_1:.3g} m, "
        f"{SHORT_ITERS} iterations {agree}/{B} lanes agree (>= "
        f"{min_agree_of(B)}); K3 device ms full {ms['full']:.3f}, cropped "
        f"{ms['cropped']:.3f} ({ms['full'] / ms['cropped']:.3f}x); crop "
        f"{t_crop * 1e3:.3f} ms {card}")
    rep.update(opti_node_full_ms_device=ms["full"],
               opti_node_crop_ms_device=ms["cropped"],
               opti_node_crop_ms=t_crop * 1e3, opti_node_bitwise_lanes=same,
               crop_1iter_err=err_1, opti_node_crop_agree=agree)
    del scn_o, batch, cropped, full, crop

    # -- per-lane crop (tests/test_solve.py:266-343) ---------------------
    cfg_s = gto.OptimizerConfig(**CROP_ITERS)
    fx = dict(CROP_FIXTURE)
    map_cfg, pts, valid, wps = fixtures.random_scenarios(fx.pop("n"), **fx)
    origin = torch.as_tensor(map_cfg.origin, dtype=torch.float32,
                             device=dev)
    res = map_cfg.resolution
    n = wps.shape[0]

    def per_lane():
        occ = sdf.rasterize(torch.as_tensor(pts, dtype=torch.float32,
                                            device=dev),
                            origin, res, map_cfg.grid_shape,
                            valid_mask=torch.as_tensor(valid, device=dev))
        scns = solver.Scenario(
            dist=sdf.edt_batch(occ, res), origin=origin.expand(n, 3),
            resolution=torch.full((n,), res, device=dev),
            waypoints=torch.as_tensor(wps, dtype=torch.float32, device=dev))
        c = solver.crop_scenarios(scns, cfg_s)
        return scns, c, solver.solve_batch(scns, cfg=cfg_s), \
            solver.solve_batch(c, cfg=cfg_s)

    scns, c, s_full, s_crop = counted("17 per-lane crop", per_lane,
                                      {"K1": 2, "K3": 2})
    offs = [tuple(o) for o in c.grid_offset.tolist()]
    same_pl = int(stress.bitwise_lanes(s_crop, s_full).sum())
    check(c.dist.shape[0] == n and len(set(offs)) > 1,
          f"per-lane crop: offsets {offs} are not per lane")
    check(same_pl == n, f"per-lane crop: cropped K3 bitwise full K3 on "
                        f"{same_pl}/{n} lanes")
    err_pl, agree_pl = k3_short_checks("17 K3 per-lane crop", c, cfg_s,
                                       positions, min_agree=min_agree_of(n))
    log(f"[17 per-lane crop] {n} lanes of {map_cfg.grid_shape} cut to "
        f"{tuple(c.dist.shape[1:])} at offsets {offs}; cropped K3 bitwise "
        f"full K3 on {same_pl}/{n} lanes; K3 vs plain: 1 iteration max "
        f"|dpos| {err_pl:.3g} m, {SHORT_ITERS} iterations {agree_pl}/{n} "
        f"lanes agree")
    rep["crop_1iter_err"] = max(rep["crop_1iter_err"], err_pl)
    del scns, c, s_full, s_crop

    # -- the 512^3 stress pipeline ----------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = counted("17 stress 512^3", lambda: stress.stages(device=dev),
                  {"K1": 2, "K3": 2})
    st = stress.time_stages(out, cfg)
    win_s = _crop_window(out["cropped"])
    ms_s = _k3_turns_ms([("full", out["scns"]), ("cropped", out["cropped"])],
                        cfg)
    log(f"[17 stress 512^3] {st['grid']} at {stress.RES} m, {st['batch']} "
        f"lanes: crop window offset {win_s[0]} shape {win_s[1]} (JAX's "
        f"{TARGET_WINDOWS['stress']}); n_ok cropped {st['n_ok']}, uncropped "
        f"{st['n_ok_uncropped']}; cropped bitwise uncropped on "
        f"{st['bitwise_lanes']}/{st['batch']} lanes; warm, min of 3: EDT "
        f"{st['edt_warm_s'] * 1e3:.3f} ms, crop {st['crop_s'] * 1e3:.3f} ms, "
        f"cropped solve {st['solve_s'] * 1e3:.3f} ms, uncropped solve "
        f"{st['uncropped_solve_s'] * 1e3:.3f} ms (in turns; their host "
        f"kernel_inputs {st['kernel_inputs_s'] * 1e3:.3f} and "
        f"{st['uncropped_kernel_inputs_s'] * 1e3:.3f} ms), e2e "
        f"{st['pipeline_e2e_s'] * 1e3:.3f} ms; K3 device ms full "
        f"{ms_s['full']:.3f}, cropped {ms_s['cropped']:.3f} "
        f"({ms_s['full'] / ms_s['cropped']:.3f}x) {card}")
    check(win_s == TARGET_WINDOWS["stress"],
          f"stress crop window {win_s}, JAX's {TARGET_WINDOWS['stress']}")
    check(st["n_ok"] == st["batch"] and st["n_ok_uncropped"] == st["batch"],
          f"stress n_ok {st['n_ok']} / {st['n_ok_uncropped']}")
    check(st["bitwise_lanes"] == st["batch"],
          f"stress: cropped bitwise uncropped on {st['bitwise_lanes']} lanes")
    rep.update(stress_full_ms_device=ms_s["full"],
               stress_crop_ms_device=ms_s["cropped"],
               stress={k: v for k, v in st.items() if k != "device"})
    del out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- Monte-Carlo across a checkpoint ----------------------------------
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        whole = counted("17 monte_carlo", lambda: mc.run(
            MC_CHUNKS * MC_CHUNK, MC_CHUNK, os.path.join(tmp, "whole"),
            device=dev, log=lines.append),
            {"K1": 2 * MC_CHUNKS, "K3": MC_CHUNKS})
        half = os.path.join(tmp, "half")
        mc.run(MC_CHUNKS // 2 * MC_CHUNK, MC_CHUNK, half, device=dev,
               log=lines.append)
        resumed = mc.run(MC_CHUNKS * MC_CHUNK, MC_CHUNK, half, device=dev,
                         log=lines.append)
    equal = all(np.array_equal(whole["state"][k], resumed["state"][k])
                for k in whole["state"])
    log(f"[17 monte_carlo] {whole['n_scenarios']} scenarios in chunks of "
        f"{MC_CHUNK}: n_ok {whole['n_ok']}, mean cost "
        f"{whole['mean_cost']:.6g}, {whole['end_to_end_solves_per_s']:.1f} "
        f"solves/s end to end ({whole['device_solves_per_s']:.1f} in the "
        f"chunk loop); {MC_CHUNKS // 2} chunks, checkpoint, restore, "
        f"{MC_CHUNKS // 2} more: aggregates equal {equal} {card}")
    check(equal, "monte_carlo: the resumed run's aggregates differ")
    check(whole["n_ok"] == whole["n_scenarios"],
          f"monte_carlo n_ok {whole['n_ok']}/{whole['n_scenarios']}")
    rep["monte_carlo"] = {k: v for k, v in whole.items() if k != "state"}

    # -- the demo, in this process -----------------------------------------
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "examples"))
    import demo_torch

    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()

        def demo():
            with contextlib.redirect_stdout(printed):
                return demo_torch.main([tmp])

        status = counted("17 demo_torch", demo, {"K1": 2, "K3": 1})
        exported = os.path.isfile(os.path.join(tmp, "scene.npz"))
    said = [ln for ln in printed.getvalue().splitlines() if ln.strip()]
    log(f"[17 demo_torch] status {status} in "
        f"{time.perf_counter() - t0:.1f} s, scene.npz written {exported}: "
        f"{said[-4:]}")
    check(status == 0 and exported
          and any("status 0" in ln for ln in said),
          f"demo_torch: status {status}, scene.npz {exported}, {said}")
    return rep


# ---- 18: the measurement entry points ----------------------------------

#: phase 18's beam-vs-exact suites: cases a suite, and the JAX script's
#: run_suite on the CPU with the same cases (scripts/bench_targets.py;
#: retime "race:search,stretch:1.2", retries 2), by exact arm
BEAM_CASES = 100
TARGET_BEAM = {
    "kino": dict(n_cases=100, exact_success=100, beam_success=95,
                 cost_ratio_geomean=0.8405658854694734),
    "hybrid": dict(n_cases=100, exact_success=100, beam_success=95,
                   cost_ratio_geomean=0.9597755066477331),
}
BEAM_SLACK = 2
#: the geometric mean's tolerance, in |log| of the JAX script's
BEAM_LOG_TOL = 0.05
#: the repo's gates on it (tests/test_search.py:806-884)
BEAM_GATE = {"kino": 0.97, "hybrid": 1.12}
#: the sweeps' loads (requests/s; missions/s), 4 s each
SERVE_LOADS = (500.0, 2000.0)
MISSION_LOADS = (100.0, 400.0)
MISSION_SLACK = 2


def bench_launches(out):
    """The launches of ``bench_torch.run``: a first and ``REPS`` warm
    calls a row (at most 2 warm for the ladder and the opti_node rows),
    ``N_LATENCY`` B=1 solves after a first, ``REPS`` queues of
    ``N_QUEUED``."""
    import bench_torch as bt

    rung = 2 if out["pipeline_ladder_host_recovered"] else 0
    row, row2 = 1 + bt.REPS, 1 + min(bt.REPS, 2)
    return {
        # the first EDT build before the row's; the opti_node map's edt
        "K1": 2 * (1 + row) + 2,
        "K3": row                              # solve_batch
        + 1 + bt.N_LATENCY + bt.REPS * bt.N_QUEUED   # B = 1 solves
        + row * (1 + 2)                        # pipeline, its race
        + row2 * (2 + rung)                    # the ladder
        + row * (2 + 3 + 2)                    # TURBO, _POLISH, _SAFE
        + row2 * (1 + 1),                      # opti_node full, cropped
    }


def phase_benches(dev, card, counted):
    """Phase 18: the JAX-free measurement entry points in this process:
    ``bench_torch.run`` at B = 1024, both Poisson sweeps
    (``scripts/serve_bench_torch.py``, ``mission_serve_bench_torch.py``),
    the beam-vs-exact suite on the kino and hybrid arms
    (``scripts/beam_vs_exact_torch.py``) and one run of the tick bench
    (``scripts/bench_replan_tick_torch.py``)."""
    import beam_vs_exact_torch as bve
    import bench_replan_tick_torch as tick
    import bench_torch
    import mission_serve_bench_torch as msb
    import serve_bench_torch as sb

    # -- (a) bench_torch.py ------------------------------------------------
    t0 = time.perf_counter()
    out = counted("18 bench_torch", lambda: bench_torch.run(device=dev),
                  bench_launches)
    print(json.dumps(out), flush=True)
    missing = bench_torch.bench_py_keys() - set(out)
    log(f"[18 bench_torch] {time.perf_counter() - t0:.1f} s: n_status_ok "
        f"{out['n_status_ok']}, reached {out['frontend_reached']} / "
        f"{out['frontend_dynamic_reached']}, pipeline ok "
        f"{out['pipeline_ok_reached']}, ladder ok "
        f"{out['pipeline_ladder_ok']} "
        f"({out['pipeline_ladder_host_recovered']} by the rung), safe p99 "
        f"{out['safe_cost_p99_ratio']}, opti_node "
        f"{out['opti_node_map_n_ok']} ok, "
        f"{out['opti_node_map_crop_bitwise_lanes']} bitwise; bench.py's "
        f"keys missing: {sorted(missing)} {card}")
    check(not missing, f"bench_torch lacks bench.py's keys {missing}")
    check(out["n_status_ok"] == BATCH, "bench_torch n_status_ok")
    for key, want in (("frontend_reached", TARGET_REACHED["static"]),
                      ("frontend_dynamic_reached", TARGET_REACHED["dynamic"]),
                      ("pipeline_ok_reached", TARGET_REACHED["retry"]),
                      ("pipeline_ladder_ok", TARGET_LADDER_OK)):
        check(abs(out[key] - want) <= REACHED_SLACK,
              f"bench_torch {key} {out[key]}, target {want}")
    check(out["safe_cost_p99_ratio"] <= 1 + 1e-6, "bench_torch safe p99")
    check(out["opti_node_map_n_ok"] == OPTI_LANES
          and out["opti_node_map_crop_bitwise_lanes"]
          == f"{OPTI_LANES}/{OPTI_LANES}", "bench_torch opti_node row")

    # -- (b) SolveServer under Poisson load ---------------------------------
    t0 = time.perf_counter()
    held = {}

    def serve():
        srv, submit = sb.setup(dev, warm=False)
        held.update(srv=srv, batches=_recording(srv))
        sb.warm_buckets(submit)
        return sb.sweep(srv, submit, SERVE_LOADS)

    try:
        rows = counted("18 serve sweep", serve, lambda _: {"K1": 2, "K3": sum(
            len(held["srv"]._bucket_groups(len(b)))
            for b in held["batches"])})
    finally:
        if "srv" in held:
            held["srv"].shutdown()
    for row in rows:
        log(f"[18 serve sweep] {json.dumps(row)} {card}")
        n = int(row["offered_req_per_s"] * sb.DURATION)
        check(row["n_requests"] == n and row["n_status_ok"] == n,
              f"serve sweep at {row['offered_req_per_s']}: {row}")
    log(f"    [18 serve sweep] {time.perf_counter() - t0:.1f} s")

    # -- (c) MissionServer under Poisson load -------------------------------
    t0 = time.perf_counter()
    held = {}

    def missions():
        srv, submit, ms = msb.setup(dev, warm=False)
        held.update(srv=srv, batches=_recording(srv), missions=ms)
        msb.warm_buckets(submit)
        return msb.sweep(srv, submit, MISSION_LOADS)

    try:
        # plan_batch races two refine arms a batch (no host rung here)
        rows = counted("18 mission sweep", missions, lambda _: {
            "K1": 2, "K3": 2 * len(held["batches"])})
    finally:
        if "srv" in held:
            held["srv"].shutdown()
    for row in rows:
        direct = msb.direct_ok(held["missions"], row["n_requests"])
        log(f"[18 mission sweep] {json.dumps(row)}; a direct plan_batch of "
            f"the same missions: {direct} ok {card}")
        check(row["n_requests"] == int(row["offered_missions_per_s"]
                                       * msb.DURATION),
              f"mission sweep requests {row}")
        check(abs(row["n_ok"] - direct) <= MISSION_SLACK,
              f"mission sweep n_ok {row['n_ok']}, direct plan_batch {direct}")
    log(f"    [18 mission sweep] {time.perf_counter() - t0:.1f} s")

    # -- (d) beam vs exact, kino and hybrid ---------------------------------
    for exact in ("kino", "hybrid"):
        t0 = time.perf_counter()
        st = counted(f"18 beam_vs_exact {exact}", lambda: bve.run_suite(
            BEAM_CASES, exact=exact, verbose=False, device=dev,
            **bve.SUITE_KW), lambda s: {"K1": 2 * BEAM_CASES,
                                        **s["refine_launches"]})
        want = TARGET_BEAM[exact]
        gm, gm_jax = st["cost_ratio_geomean"], want["cost_ratio_geomean"]
        log(f"[18 beam_vs_exact {exact}] {BEAM_CASES} cases in "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(st)}; the JAX "
            f"script's on the CPU: {want} {card}")
        check(st["n_cases"] == want["n_cases"]
              and st["exact_success"] == want["exact_success"],
              f"beam_vs_exact {exact}: exact oracle {st}")
        check(abs(st["beam_success"] - want["beam_success"]) <= BEAM_SLACK,
              f"beam_vs_exact {exact}: beam success {st['beam_success']}")
        check(abs(math.log(gm / gm_jax)) <= BEAM_LOG_TOL
              and gm <= BEAM_GATE[exact],
              f"beam_vs_exact {exact}: cost ratio geomean {gm}, JAX {gm_jax}"
              f", gate {BEAM_GATE[exact]}")

    # -- (e) the replan tick bench --------------------------------------------
    t0 = time.perf_counter()
    ticks = counted("18 replan tick", lambda: tick.measure(
        1, device=dev, log=lambda s: log(f"    {s}")), lambda o: {
            "K1": 2, "K3": o["kino_refined_ticks"] + o["rrt_refined_ticks"]})
    log(f"[18 replan tick] {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(ticks)}")
    check(ticks["kino_runs_reached"] == 1 and ticks["rrt_runs_reached"] == 1,
          f"replan tick bench: goal not reached {ticks}")


# ---- 19: the per-iteration solve ----------------------------------------

#: phase 19c: each opti_node segment cut into this many, 11 -> 51 waypoints
LONG_CUTS = 5
LONG_LANES = 256


def descent_evals(cfg, steps) -> int:
    """Penalty evaluations of the per-iteration descent, one K2 launch
    each: the seed's and one an iteration, for every step
    (``descent.minimize_batch``); none when the collision weight is
    below the reference's 1e-4 cut."""
    if abs(cfg.w_collision) < 1e-4:
        return 0
    return sum((cfg.iters_step1 if s == 1 else cfg.iters_step2) + 1
               for s in steps)


@contextlib.contextmanager
def plain_k2():
    """K2's plain version in place of the kernel wherever the port looks
    up through ``trilinear_cuda.trilinear_batch``, on the same CUDA
    tensors: the same loop, the lookup by ``sdf.trilinear_flat``."""
    from grad_traj_optimization_torch.ops import trilinear_cuda

    kernel = trilinear_cuda.trilinear_batch
    trilinear_cuda.trilinear_batch = trilinear_cuda.trilinear_batch_plain
    try:
        yield
    finally:
        trilinear_cuda.trilinear_batch = kernel


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched under it that are not views
    (a view launches nothing; each other operation at most one kernel)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not getattr(func, "is_view", False)
        return func(*args, **(kwargs or {}))


def long_mission(wp: np.ndarray, cuts: int) -> np.ndarray:
    """Each segment of ``wp`` cut into ``cuts`` equal ones (numpy)."""
    f = np.arange(cuts)[:, None] / cuts
    inner = [wp[i] + f * (wp[i + 1] - wp[i]) for i in range(len(wp) - 1)]
    return np.concatenate(inner + [wp[-1:]])


def _sampled(sol):
    from grad_traj_optimization_torch.core import poly

    return poly.sample_uniform(sol.coeff.double(), sol.T.double(), 100)[0]


def phase_fused(scns, knots, card, counted):
    """Phase 19: the per-iteration descent (``solve_batch_fused``, one K2
    launch an evaluation) through ``solve_batch`` and
    ``solve_kino_batch``, wherever the dispatch rule does not pick K3."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import fixtures, solver
    from grad_traj_optimization_torch.core import qp
    from grad_traj_optimization_torch.opt import descent, penalty
    from grad_traj_optimization_torch.ops import trilinear_cuda

    B = scns.waypoints.shape[0]
    dev = scns.dist.device
    rep = {}

    def n_ok(sol):
        return int((sol.status == solver.STATUS_OK).sum())

    # -- (a) the bench batch, lookup_mode="fused" -------------------------
    cfg_f = gto.OptimizerConfig(lookup_mode="fused")
    n_ev = descent_evals(cfg_f, (2,))
    check(not solver.takes_k3(scns, cfg_f), "fused batch routed to K3")
    fused = counted("19 fused", lambda: solver.solve_batch(scns, cfg=cfg_f),
                    {"K3": 0, "K2": n_ev})
    check(n_ok(fused) == B, f"19 fused: status ok on {n_ok(fused)}/{B}")
    with plain_k2():
        same = solver.solve_batch(scns, cfg=cfg_f)
    bit_dp = _bitwise(fused.dp, same.dp)
    bit_cost = _bitwise(fused.cost, same.cost)
    n_bit = int(((fused.dp.view(torch.int32) == same.dp.view(torch.int32))
                 .all(dim=(1, 2)) & (fused.cost.view(torch.int32)
                                     == same.cost.view(torch.int32))).sum())
    log(f"[19a fused] {B} bench lanes, {cfg_f.iters_step2} iterations: "
        f"{n_ok(fused)}/{B} ok; K3 0, K2 {n_ev} launches; against the same "
        f"loop with K2's plain version: dp and cost bitwise on {n_bit}/{B}"
        f" lanes")
    check(bit_dp and bit_cost, f"19 fused: {B - n_bit} lanes differ from "
          "the same loop with K2's plain version")
    k3_full = solver.solve_batch(scns, cfg=gto.OptimizerConfig())
    holds, (p50, p90, mean) = _dist_rule(fused.cost.cpu().numpy(),
                                         k3_full.cost.cpu().numpy())
    c10 = gto.OptimizerConfig(iters_step2=SHORT_ITERS)
    f10 = solver.solve_batch(scns, cfg=dataclasses.replace(
        c10, lookup_mode="fused"))
    k10 = solver.solve_batch(scns, cfg=c10)
    agree, perr = lane_agree(f10.n_accept, f10.cost, _sampled(f10),
                             k10.n_accept, k10.cost, _sampled(k10))
    n_agree = int(agree.sum())
    log(f"[19a fused vs K3] {SHORT_ITERS} iterations: {n_agree}/{B} lanes "
        f"with equal n_accept, cost rtol 5e-3 and positions < 1e-3 m (max "
        f"|dpos| {float(perr.max()):.3g} m; at least {MIN_AGREE}); "
        f"{cfg_f.iters_step2} iterations: |log cost ratio| p50 {p50:.3g} "
        f"p90 {p90:.3g} mean {mean:.3g} (limits 0.02/0.25/0.10)")
    check(n_agree >= MIN_AGREE, f"19 fused vs K3 at {SHORT_ITERS}: "
          f"{n_agree}/{B} lanes agree < {MIN_AGREE}")
    check(holds, f"19 fused vs K3 at {cfg_f.iters_step2}: p50 {p50} p90 "
          f"{p90} mean {mean}")
    rep.update(bitwise_lanes=f"{n_bit}/{B}", k3_agree_lanes=n_agree,
               k3_rule=[p50, p90, mean])

    # -- (b) the configs K3 rejects ----------------------------------------
    for tag, kw in (("adaptive", dict(step_rule="adaptive")),
                    ("accept_window=200", dict(accept_window=200))):
        cfg = gto.OptimizerConfig(**kw)
        check(not solver.takes_k3(scns, cfg), f"19 {tag} routed to K3")
        sol = counted(f"19 {tag}", lambda: solver.solve_batch(scns, cfg=cfg),
                      {"K3": 0, "K2": descent_evals(cfg, (2,))})
        log(f"[19b {tag}] solve_batch: {n_ok(sol)}/{B} ok, K3 0 launches, "
            f"median cost {float(sol.cost.median()):.6g} (OptimizerConfig()"
            f" on K3: {float(k3_full.cost.median()):.6g})")
        check(n_ok(sol) == B, f"19 {tag}: status ok on {n_ok(sol)}/{B}")
    cfg_a = gto.OptimizerConfig(step_rule="adaptive")
    kino = counted("19 kino adaptive", lambda: solver.solve_kino_batch(
        *knots, cfg=cfg_a), {"K3": 0, "K2": descent_evals(cfg_a, (2,))})
    log(f"[19b kino adaptive] solve_kino_batch on phase 9's resampled knots "
        f"({tuple(knots[3].shape)}): {n_ok(kino)}/{B} ok, K3 0 launches")
    check(n_ok(kino) == B, f"19 kino adaptive: status ok on {n_ok(kino)}")

    # -- (c) a long mission on the opti_node map ---------------------------
    mc, obss, wp = fixtures.opti_node_scenario()
    scn_o = solver.make_scenario(wp, obss, mc, device=dev)
    wp_long = long_mission(wp, LONG_CUTS)
    lanes = opti_node_lanes(wp_long, LONG_LANES)
    long = solver.Scenario(
        scn_o.dist[None], scn_o.origin.expand(LONG_LANES, 3).contiguous(),
        scn_o.resolution.expand(LONG_LANES).contiguous(),
        torch.as_tensor(lanes, device=dev))
    m_long = wp_long.shape[0] - 1
    check(not solver.takes_k3(long, gto.OptimizerConfig()),
          "19 long mission routed to K3")

    def long_path():
        sol = solver.solve_batch(long, cfg=gto.OptimizerConfig())
        return sol, solver.min_clearance(sol, long)

    sol_l, clear_l = counted("19 long mission", long_path, {
        "K3": 0, "K2": descent_evals(gto.OptimizerConfig(), (2,)) + 1})
    log(f"[19c long mission] opti_node map, {wp_long.shape[0]} waypoints "
        f"(num_dp {3 * m_long - 3}, K3 takes at most 128), {LONG_LANES} "
        f"jittered lanes on the shared map: {n_ok(sol_l)}/{LONG_LANES} ok; "
        f"min clearance median {float(clear_l.median()):.3f} m, min "
        f"{float(clear_l.min()):.3f} m, {int((clear_l > 0).sum())}/"
        f"{LONG_LANES} collision-free {card}")
    check(n_ok(sol_l) == LONG_LANES, f"19 long mission: {n_ok(sol_l)} ok")
    check(bool(torch.isfinite(clear_l).all()), "19 long mission clearance")
    rep.update(long_ok=n_ok(sol_l), long_clear_median=float(
        clear_l.median()), long_num_dp=3 * m_long - 3)

    # -- (d) times ---------------------------------------------------------
    t_f = wall_s(lambda: solver.solve_batch(scns, cfg=cfg_f))
    t_k3 = wall_s(lambda: solver.solve_batch(scns, cfg=gto.OptimizerConfig()))
    # one evaluation, and the whole descent, without the host: CUDA graphs
    T = qp.allocate_times(scns.waypoints, cfg_f.mean_v, cfg_f.init_time)
    Df, dp0 = qp.straight_line_d(scns.waypoints)
    bctx = penalty.build_ctx_batch(T, Df, cfg_f)
    lb, ub = penalty.bounds(scns.waypoints, dp0.shape[2], cfg_f)
    org, rs = scns.origin.contiguous(), scns.resolution.contiguous()

    def cag(x):
        return penalty.cost_and_grad_batch(x, bctx, scns.dist, org, rs,
                                           cfg_f, 2)

    def loop():
        return descent.minimize_batch(cag, dp0, lb, ub, cfg_f.iters_step2,
                                      cfg_f)

    eval_host = host_ms(lambda: cag(dp0))
    eval_dev = graph_ms(lambda: cag(dp0))
    loop_dev = graph_ms(loop, n=1, reps=3)
    loop_wall = wall_s(loop) * 1e3
    with _OpCount() as oc:
        cag(dp0)
    ops_eval = oc.n
    with _OpCount() as oc:
        loop()
    ops_loop = oc.n
    _, pos, _ = penalty._sample_state(dp0, bctx)
    pos = pos.reshape(B, -1, 3).contiguous()
    # device time on a cold L2 (every input read from HBM), and a graph
    # of 100 launches on the same inputs, which stay in L2 (~11 MB)
    k2_ms, k2_cold_min_ms = cold_ms(lambda: trilinear_cuda.trilinear_batch(
        scns.dist, org, rs, pos))
    k2_warm_ms = graph_ms(lambda: trilinear_cuda.trilinear_batch(
        scns.dist, org, rs, pos))
    k2_plain_ms = gpu_ms(lambda: trilinear_cuda.trilinear_batch_plain(
        scns.dist, org, rs, pos))
    # inputs once (positions, origins, resolutions, the distinct corner
    # cells of the in-map points, which neighbouring samples share),
    # outputs once (d, g); ~70 operations a point
    n_pts = pos.shape[0] * pos.shape[1]
    n_cells = k2_corner_cells(scns.dist, org, rs, pos, trilinear_cuda
                              .trilinear_batch(scns.dist, org, rs, pos)[0])
    k2_bound = bound_entry({
        "bytes_ms": 4 * (3 * n_pts + 4 * B + 4 * n_pts + n_cells)
        / HBM_BPS * 1e3, "ops_ms": 70 * n_pts / FP32_FLOPS * 1e3})
    idle = 1.0 - loop_dev / loop_wall
    log(f"[19d times] per-iteration path {B / t_f:.1f} solves/s "
        f"({t_f * 1e3:.3f} ms per {B}, {cfg_f.iters_step2} iterations, warm, "
        f"min of 3) "
        f"against K3's {B / t_k3:.1f} solves/s ({t_k3 * 1e3:.3f} ms) on the "
        f"same batch; the descent loop alone {loop_wall:.3f} ms on the host "
        f"clock, {loop_dev:.3f} ms of device work (a CUDA graph of it): the "
        f"device idles {idle:.1%}; one evaluation {eval_host * 1e3:.1f} us "
        f"host enqueue, {eval_dev * 1e3:.1f} us device; {ops_eval} ATen "
        f"operations (not views) + 1 K2 launch an evaluation, {ops_loop} + "
        f"{n_ev} a {cfg_f.iters_step2}-iteration descent; K2 at this path's "
        f"shape {tuple(pos.shape[:2])}: {k2_ms * 1e3:.2f} us device on a "
        f"cold L2 (median of 30, min {k2_cold_min_ms * 1e3:.2f}), "
        f"{k2_warm_ms * 1e3:.2f} us with its inputs in L2 (graph of 100), "
        f"plain {k2_plain_ms * 1e3:.1f} us, bound "
        f"{k2_bound['bound_ms'] * 1e3:.2f} us ({k2_bound['bound_by']}; "
        f"{n_cells} distinct corner cells); "
        f"{n_ev} K2 launches a solve_batch call {card}")
    rep.update(solves_per_s=B / t_f, k3_solves_per_s=B / t_k3,
               solve_ms=t_f * 1e3, k3_solve_ms=t_k3 * 1e3,
               loop_host_ms=loop_wall, loop_device_ms=loop_dev,
               device_idle=idle, eval_host_us=eval_host * 1e3,
               eval_device_us=eval_dev * 1e3, aten_ops_per_eval=ops_eval,
               aten_ops_per_descent=ops_loop, k2_launches_per_solve=n_ev,
               k2_ms=k2_ms, k2_warm_ms=k2_warm_ms, k2_plain_ms=k2_plain_ms,
               k2_cold_min_ms=k2_cold_min_ms, k2_corner_cells=n_cells,
               k2_bound_ms=k2_bound["bound_ms"],
               k2_bound_by=k2_bound["bound_by"],
               k2_shape=list(pos.shape[:2]))
    return rep


# ---- 20: shapes and options the JAX package answers ---------------------

#: (cells, lines) of the long-line checks (40 000 cells: past what a
#: block's shared memory stages, 64-bit keys in global slots), and the x
#: pass timed at a realistic size: 8192 cells (a 1.6 km corridor at 0.2 m)
#: over 512 x 48
LONG_LINES = ((4097, 1024), (6000, 512), (20000, 64), (40000, 8))
LONG_PASS = (8192, 512, 48)
#: sdf.edt on the card against the CPU field, x lines past 4096 cells
LONG_EDT = (6000, 16, 8)
#: the x-sharded EDT of phase 16 whose x lines take the long-line kernel
LONG_SHARDED = (8192, 256, 32)
#: the dispatch sweep: sample counts (config.py's n_samples) and windows
SWEEP_K = (8, 30, 40, 64, 80, 128)
SWEEP_WINDOWS = (1, 128)
REFUSED_LANES = 256
ARM_LANES = 32
#: the beam search's arms beside exact512 and the gather lookup
SEARCH_ARMS = {
    "lex512": dict(dedup="lex512"), "approx512": dict(dedup="approx512"),
    "pp64": dict(dedup="pp64"), "pp8": dict(dedup="pp8"),
    "parent": dict(dedup="parent"), "box": dict(lookup="box"),
    "box, shot_topk=beam": dict(lookup="box",
                                shot_topk=SEARCH_KW["beam"]),
}


def long_lines_bound(numel: int) -> dict:
    """K1's bound for a pass over ``numel`` cells: each read once and
    written once, against the O(n) scan's ~10 operations a cell."""
    return {"bytes_ms": 2 * 4 * numel / HBM_BPS * 1e3,
            "ops_ms": 10 * numel / FP32_FLOPS * 1e3}


def phase_shapes(dist, wps, map_cfg, card, counted):
    """Phase 20: what the JAX package answers beyond the main path's
    shapes.  K3's dispatch rule against the kernel's own plan on a sweep,
    and the Python limits against the card's; the shapes K3 cannot
    launch, solved by the per-iteration descent; K1 on lines past 4096
    cells (bitwise its plain version, timed against its bound, on each
    of the long-line kernel's paths, and on the bench's short lines), and
    ``sdf.edt`` of a long grid against the CPU field; the beam search's
    other dedup and lookup arms against the same call on the CPU."""
    from grad_traj_optimization_torch import fixtures, solver
    from grad_traj_optimization_torch.config import OptimizerConfig
    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.ops import edt_cuda, solve_cuda
    from grad_traj_optimization_torch.search import kinodynamic as kd

    dev = dist.device
    rep = {}
    # (a) the dispatch rule against gto_descend_plan, and the limits
    lim = solve_cuda.limits(dev)
    log(f"[20 K3 limits] kMaxSmem {lim['max_smem']} B (GtoFrame "
        f"{lim['frame']} B), {lim['regs']} registers a thread, "
        f"maxThreadsPerBlock {lim['max_threads_per_block']}, largest "
        f"resident block {lim['resident']}; solve_cuda.MAX_SMEM "
        f"{solve_cuda.MAX_SMEM}, MAX_THREADS {solve_cuda.MAX_THREADS}")
    check(lim["max_smem"] == solve_cuda.MAX_SMEM
          and lim["resident"] == solve_cuda.MAX_THREADS,
          f"K3's limits {lim} differ from solve_cuda's constants")
    n_shapes, n_taken, mism = 0, 0, []
    for K in SWEEP_K:
        for use_a in (False, True):
            for window in SWEEP_WINDOWS:
                cfg = OptimizerConfig(n_samples=K, accept_window=window,
                                      alpha_a=0.5 if use_a else 0.0)
                for m in range(2, 44):
                    try:
                        solve_cuda.plan(m, K, window, use_a, 1, dev)
                        planned = True
                    except RuntimeError:
                        planned = False
                    sup = solve_cuda.supports((8, 8, 8), m * K, 3 * m - 3,
                                              cfg)
                    n_shapes += 1
                    n_taken += sup
                    if sup != planned:
                        mism.append((m, K, use_a, window, planned))
    log(f"[20 K3 dispatch] {n_shapes} shapes (m 2..43, n_samples {SWEEP_K},"
        f" alpha_a 0 / 0.5, windows {SWEEP_WINDOWS}): supports() takes "
        f"{n_taken}, {len(mism)} disagree with gto_descend_plan {mism[:5]}")
    check(not mism, f"supports() disagrees with the kernel's plan: {mism}")
    rep["dispatch_sweep"] = dict(
        shapes=n_shapes, taken=n_taken, mismatches=len(mism),
        regs=lim["regs"], max_threads_per_block=lim["max_threads_per_block"],
        resident=lim["resident"], max_smem=lim["max_smem"])

    # (b) the shapes K3 cannot launch, through solve_batch
    refused = {}
    for case, (n_wp, n_samples, kw) in fixtures.K3_REFUSED_SHAPES.items():
        mc, pts, valid, wps_c = fixtures.random_scenarios(
            REFUSED_LANES, n_waypoints=n_wp, seed=SEED)
        origin = torch.as_tensor(mc.origin, dtype=torch.float32, device=dev)
        occ = sdf.rasterize(torch.as_tensor(pts, dtype=torch.float32,
                                            device=dev), origin,
                            mc.resolution, mc.grid_shape,
                            valid_mask=torch.as_tensor(valid, device=dev))
        scns = solver.Scenario(
            dist=sdf.edt_batch(occ, mc.resolution),
            origin=origin.expand(REFUSED_LANES, 3).contiguous(),
            resolution=torch.full((REFUSED_LANES,), mc.resolution,
                                  device=dev),
            waypoints=torch.as_tensor(wps_c, dtype=torch.float32,
                                      device=dev))
        cfg = OptimizerConfig(n_samples=n_samples, **kw)
        check(not solver.takes_k3(scns, cfg), f"{case}: K3 takes it")
        t0 = time.perf_counter()

        def solve_and_clear():
            sol = solver.solve_batch(scns, cfg=cfg)
            return sol, solver.min_clearance(sol, scns)

        sol, clear = counted(f"20 {case}", solve_and_clear,
                             {"K2": descent_evals(cfg, (2,)) + 1})
        wall = time.perf_counter() - t0
        n_ok = int((sol.status == solver.STATUS_OK).sum())
        refused[case] = dict(n_ok=n_ok, wall_s=wall,
                             min_clearance_median=float(clear.median()),
                             collision_free=int((clear > 0).sum()))
        log(f"[20 K3 refused] {case}: {REFUSED_LANES} lanes through "
            f"solve_batch, K3 0; {n_ok} ok; min clearance median "
            f"{float(clear.median()):.3f} m, min {float(clear.min()):.3f} m, "
            f"{int((clear > 0).sum())} collision-free; {wall:.2f} s {card}")
        check(n_ok == REFUSED_LANES, f"{case}: {n_ok} lanes ok")
        del scns, sol, clear, occ
    rep["refused"] = refused

    # (c) K1 on long lines, bitwise its plain version, then timed
    rng = np.random.default_rng(SEED)
    per_n, err = [], 0.0
    for n, L in LONG_LINES:
        f = rng.integers(0, 3000, size=(L, n)).astype(np.float32) ** 2
        f[rng.random(f.shape) < 0.9] = sdf.BIG_CELLS ** 2
        f[0] = rng.random(n).astype(np.float32) * 3e7
        f[1:3] = sdf.BIG_CELLS ** 2
        f[1, 0] = 0.5
        f[2, n - 1] = 0.3
        f = torch.as_tensor(f, device=dev)
        got = edt_cuda.minplus_lines(f)
        want = edt_cuda.minplus_lines_plain(f)
        same = _bitwise(got, want)
        err = max(err, float((got - want).abs().max()))
        ms = gpu_ms(lambda: edt_cuda.minplus_lines(f))
        plain = gpu_ms(lambda: edt_cuda.minplus_lines_plain(f), reps=1)
        b = bound_entry(long_lines_bound(f.numel()))
        per_n.append(dict(n=n, lines=L, bitwise=same, ms=ms, plain_ms=plain,
                          bound_ms=b["bound_ms"], bound_by=b["bound_by"]))
        log(f"[20 K1 long lines] n {n}, {L} lines: bitwise plain {same}; "
            f"{ms:.3f} ms vs plain {plain:.3f} ms; bound {b['bound_ms']:.4f}"
            f" ms ({b['bound_by']}) {card}")
        check(same, f"K1 long lines at n {n}: not bitwise its plain version")
        del f, got, want
    # the x pass of LONG_PASS, out of place from the same input each time
    # (the kernel's work depends on the values): random reals, every line
    # on the two-rounding path; then the z and y passes of an occupancy
    # grid of that shape (default_rng(0), STRESS_DENSITY, as phase 16),
    # integer lines, the EDT's own case
    dims = (1, LONG_PASS[0], LONG_PASS[1] * LONG_PASS[2])
    n_lines = dims[2]
    b = bound_entry(long_lines_bound(math.prod(LONG_PASS)))
    rng0 = np.random.default_rng(0)
    occ_np = np.empty(LONG_PASS, np.float32)
    for part in np.array_split(occ_np, 8):
        part[:] = rng0.random(part.shape) < STRESS_DENSITY
    fed = sdf._nearest_sq_1d(torch.as_tensor(occ_np, device=dev), dim=-1)
    del occ_np
    edt_cuda.minplus_along(fed, dim=-2)  # the y pass: 512 cells, staged
    passes = {}
    for tag, x in (("random_reals", torch.rand(LONG_PASS, device=dev) * 1e4),
                   ("edt_fed", fed)):
        out = torch.empty_like(x)
        edt_cuda.reset_long_path_counts()
        edt_cuda.minplus_long(x, out, *dims)
        paths = edt_cuda.long_path_counts(dev)
        ms = gpu_ms(lambda: edt_cuda.minplus_long(x, out, *dims))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = edt_cuda.minplus_along_plain(x, 0)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        same = _bitwise(out, want)
        err = max(err, float((out - want).abs().max()))
        inplace = x.clone()
        edt_cuda.minplus_along(inplace, 0)
        same_inplace = _bitwise(inplace, want)
        passes[tag] = dict(ms=ms, plain_ms=plain_ms, bitwise=same,
                           bitwise_in_place=same_inplace,
                           share_of_bound=b["bound_ms"] / ms, paths=paths)
        log(f"[20 K1 long lines] x pass of {LONG_PASS}, {tag}: {ms:.3f} ms "
            f"vs plain {plain_ms:.3f} ms (one call); bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: "
            f"{2 * 4 * x.numel() / 1e9:.3f} GB), "
            f"{100 * b['bound_ms'] / ms:.2f}% of it (the dense O(n^2) kernel "
            f"this one replaced: 145.7-146.6 ms); bitwise plain {same}, in place {same_inplace};"
            f" paths {paths} {card}")
        check(same and same_inplace,
              f"K1 long x pass ({tag}): not bitwise its plain version")
        del out, want, inplace
    check(passes["edt_fed"]["paths"] == dict(
        lines_integer=n_lines, outputs_integer=fed.numel(), lines_dense=0,
        outputs_dense=0), f"EDT-fed lines off the integer path: "
        f"{passes['edt_fed']['paths']}")
    check(passes["random_reals"]["paths"]["lines_dense"] == n_lines,
          "random reals off the two-rounding path")
    del fed, x
    # the long-line kernel on the bench passes (lines of 100 cells, which
    # the dispatch gives the staged kernel), beside the staged kernel
    sq_b = sdf._nearest_sq_1d((dist == 0).float(), dim=-1)
    B_, nx_, ny_, nz_ = sq_b.shape
    y_dims, x_dims = (B_ * nx_, ny_, nz_), (B_, nx_, ny_ * nz_)
    fed_b = edt_cuda.minplus_along_plain(sq_b, -2).contiguous()
    want_b = edt_cuda.minplus_along_plain(fed_b, -3)
    out_b = torch.empty_like(sq_b)
    edt_cuda.minplus_long(sq_b, out_b, *y_dims)
    same_b = _bitwise(out_b, fed_b)
    edt_cuda.minplus_long(fed_b, out_b, *x_dims)
    same_b = same_b and _bitwise(out_b, want_b)
    bench = dict(
        long_y_ms=gpu_ms(lambda: edt_cuda.minplus_long(sq_b, out_b, *y_dims)),
        long_x_ms=gpu_ms(lambda: edt_cuda.minplus_long(fed_b, out_b,
                                                       *x_dims)))
    out_b.copy_(sq_b)  # the staged kernel's time does not depend on values
    bench["staged_y_ms"] = gpu_ms(lambda: edt_cuda.minplus_along(out_b, -2))
    bench["staged_x_ms"] = gpu_ms(lambda: edt_cuda.minplus_along(out_b, -3))
    bench.update(bitwise=same_b, shape=list(sq_b.shape),
                 **bound_entry(long_lines_bound(sq_b.numel())))
    log(f"[20 K1 long lines] the long-line kernel on the bench passes "
        f"{tuple(sq_b.shape)} (lines of {ny_}; out of place): y "
        f"{bench['long_y_ms']:.3f} ms, x {bench['long_x_ms']:.3f} ms, "
        f"bitwise the plain version {same_b}; the staged kernel in place: "
        f"y {bench['staged_y_ms']:.3f} ms, x {bench['staged_x_ms']:.3f} ms; "
        f"bound {bench['bound_ms']:.4f} ms {card}")
    check(same_b, "K1 long on the bench passes: not bitwise its plain "
          "version")
    del sq_b, fed_b, want_b, out_b
    # sdf.edt of a long grid, counted, against the CPU field
    occ_np = (rng.random(LONG_EDT) < 0.002).astype(np.float32)
    occ_np[:4200] = 0.0
    occ_l = torch.as_tensor(occ_np, device=dev)
    d_card = counted("20 sdf.edt long grid",
                     lambda: sdf.edt(occ_l, STRESS_RES),
                     {"K1": 2, "K1 long": 1})
    d_cpu = sdf.edt(occ_l.cpu(), STRESS_RES)
    same_edt = _bitwise(d_card.cpu(), d_cpu)
    log(f"[20 sdf.edt] {LONG_EDT} at {STRESS_RES} m (the first 4200 cells "
        f"free) on the card bitwise the CPU field: {same_edt}")
    check(same_edt, "sdf.edt of the long grid: card != CPU")
    fed_rep = passes["edt_fed"]
    rep["long_line"] = dict(
        shape=list(LONG_PASS), ms=fed_rep["ms"], plain_ms=fed_rep["plain_ms"],
        **b, share_of_bound=fed_rep["share_of_bound"],
        paths=fed_rep["paths"], dense_path=passes["random_reals"],
        max_abs_err=err, per_n=per_n,
        edt_bitwise_cpu=same_edt, bench_passes=bench)

    # (d) the beam search's other arms on 32 bench missions, card vs CPU
    starts, goals, origins = bench_missions(wps[:ARM_LANES], map_cfg, dev)
    d32 = dist[:ARM_LANES]
    arms = {}
    for arm, kw in SEARCH_ARMS.items():
        r = counted(f"20 search {arm}", lambda: kd.search_batch(
            d32, origins, map_cfg.resolution, starts, goals, **SEARCH_KW,
            **kw), {})
        rc = kd.search_batch(d32.cpu(), origins.cpu(), map_cfg.resolution,
                             starts.cpu(), goals.cpu(), **SEARCH_KW, **kw)
        same_reached = bool(torch.equal(rc.reached, r.reached.cpu()))
        k_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(r[:4], rc[:4]))
        n = int(r.reached.sum())
        arms[arm] = dict(reached=n, reached_equal_cpu=same_reached,
                         knot_err=k_err)
        log(f"[20 search {arm}] {ARM_LANES} bench missions: reached {n}; "
            f"the CPU: reached equal {same_reached}, max knot-state "
            f"difference {k_err:.3g}")
        check(same_reached and k_err <= 1e-4,
              f"search {arm}: the card and the CPU disagree")
    rep["search_arms"] = arms
    return rep


def main() -> int:
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        log(f"    [{phase}] phase wall {now - t_lap[0]:.1f} s, total "
            f"{now - t_start:.1f} s")
        t_lap[0] = now

    # ---- 1. device ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import _build, fixtures
    from grad_traj_optimization_torch import config as gto_config
    from grad_traj_optimization_torch.config import MapConfig
    from grad_traj_optimization_torch.core import poly, qp
    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.ops import (
        edt_cuda, solve_cuda, trilinear_cuda,
    )
    from grad_traj_optimization_torch import solver

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"[1 device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    t_build = time.perf_counter() - t0
    log(f"[2 build] nvcc build + load {t_build:.1f} s -> "
        f"{_build.library_path()}")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"    ptxas: {line.strip()}")

    # bench data: the JAX bench's own fixture call (bench.py:29-31)
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        BATCH, n_waypoints=N_WP, seed=SEED, max_obstacle_points=4096
    )
    grid = map_cfg.grid_shape
    res = map_cfg.resolution
    pts_d = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid_d = torch.as_tensor(valid, device=dev)
    origin = torch.as_tensor(map_cfg.origin, dtype=torch.float32, device=dev)
    occ = sdf.rasterize(pts_d, origin, res, grid, valid_mask=valid_d)
    check(occ.shape == (BATCH, *grid), f"occupancy shape {occ.shape}")

    # ---- 3. K1 vs plain ----------------------------------------------
    # minplus_along transforms in place; each pass is held against the
    # plain version (movedim + minplus_lines_plain + movedim back) on the
    # same input: the bench field's y and x passes and an odd shape
    sq_z = sdf._nearest_sq_1d(occ, dim=-1)
    rng = np.random.default_rng(SEED)
    odd = rng.integers(0, 60, size=ODD_SHAPE).astype(np.float32) ** 2
    odd[rng.random(ODD_SHAPE) < 0.4] = sdf.BIG_CELLS ** 2
    k1_err = 0.0
    for tag, x0 in (("bench", sq_z), ("odd", torch.as_tensor(odd, device=dev))):
        x = x0.clone()
        for dim in (-2, -3):
            want = edt_cuda.minplus_along_plain(x, dim)
            got = edt_cuda.minplus_along(x, dim)
            check(got.data_ptr() == x.data_ptr(), "K1 did not work in place")
            k1_err = max(k1_err, float((got - want).abs().max()))
            check(torch.equal(got, want),
                  f"K1 {tag} pass along {dim} differs from its plain version")
    n_cpu = 8
    d_card = sdf.edt_batch(occ[:n_cpu], res)
    d_cpu = sdf.edt_batch(occ[:n_cpu].cpu(), res)
    check(torch.equal(d_card.cpu(), d_cpu), "edt_batch: card != CPU field")
    # in-place passes on a scratch copy: K1's time does not depend on the
    # values, so repeated passes over the same tensor time it
    buf = sq_z.clone()
    k1_ms = gpu_ms(lambda: edt_cuda.minplus_along(buf, -2))
    k1_x_ms = gpu_ms(lambda: edt_cuda.minplus_along(buf, -3))
    k1_plain_ms = gpu_ms(lambda: edt_cuda.minplus_along_plain(sq_z, -2))
    B_, nx_, ny_, nz_ = sq_z.shape
    k1_bytes = 2 * 4 * sq_z.numel()  # read once and written once
    k1_pairs = sq_z.numel() * ny_  # (q, v) pairs of the dense form
    # the function's least work is the O(n) lower-envelope scan (about
    # ten operations an element); the dense form K1 runs does n FMA+min
    # pairs an element, reported beside it
    k1_bound = {"bytes_ms": k1_bytes / HBM_BPS * 1e3,
                "ops_ms": 10 * sq_z.numel() / FP32_FLOPS * 1e3}
    k1_dense_ms = 2 * k1_pairs / FP32_FLOPS * 1e3
    log(f"[3 K1] minplus_along in place on {tuple(sq_z.shape)} (y pass "
        f"{(B_ * nx_, ny_, nz_)}, x pass {(B_, nx_, ny_ * nz_)}) and "
        f"{ODD_SHAPE}: bitwise equal to plain; edt_batch of {n_cpu} maps "
        f"bitwise the CPU field; y pass {k1_ms:.3f} ms, x pass "
        f"{k1_x_ms:.3f} ms vs plain {k1_plain_ms:.3f} ms; bound "
        f"{k1_bound['bytes_ms']:.3f} ms ({k1_bytes / 1e9:.3f} GB at 3.35 "
        f"TB/s; the dense form's {k1_pairs:.3g} FMA+min pairs "
        f"{k1_dense_ms:.3f} ms at 67 TFLOP/s) {card}")
    del sq_z, buf, d_card, d_cpu

    dist = sdf.edt_batch(occ, res)
    check(bool(torch.isfinite(dist).all()), "non-finite distance field")

    # ---- 4. K2 vs plain ----------------------------------------------
    # the lookup's division by res against IEEE division, every float32
    # dividend, at each resolution the fixtures and tests use
    div_check = {}
    for r_div in DIV_RESOLUTIONS:
        t0 = time.perf_counter()
        out = trilinear_cuda.division_check(r_div, device=dev)
        t_div = time.perf_counter() - t0
        div_check[str(r_div)] = out["differ"]
        log(f"[4 K2 division] res {r_div}: {out['checked']} finite float32 "
            f"dividends, {out['differ']} differ from __fdiv_rn "
            f"{out['differ_by_exponent']} ({t_div:.2f} s)")
        check(out["checked"] == 2**32 - 2**24 and out["differ"] == 0,
              f"K2: gto_div differs from division at res {r_div}")
    # bitwise against the plain version: the bench fields, and the
    # opti_node map shared by a batch (grid stride 0); each with points
    # out of map, on and one ulp inside the margins, straddling the faces
    # and at the grid-edge cell centres (fixtures.lookup_queries)
    pos = torch.as_tensor(fixtures.lookup_queries(map_cfg, BATCH, SEED),
                          device=dev)
    org_b = origin.expand(BATCH, 3).contiguous()
    res_b = torch.full((BATCH,), res, dtype=torch.float32, device=dev)
    k2_args = (dist, org_b, res_b, pos)
    mc_o, obss_o, wp_o = fixtures.opti_node_scenario()
    scn_o = solver.make_scenario(wp_o, obss_o, mc_o, device=dev)
    n_o = 64
    # and grids of values below 1e-36 at 0.1 m: their gradient dividends
    # fall under the fast division's range, so every lookup runs again
    # with IEEE division
    mc_t = MapConfig(origin=(-1.0, -1.0, 0.0), resolution=0.1,
                     map_size=(2.0, 2.0, 1.0))
    tiny = (rng.random((8,) + mc_t.grid_shape) * 1e-36).astype(np.float32)
    k2_cases = {
        "bench": k2_args,
        "opti_node": (scn_o.dist[None],
                      scn_o.origin.expand(n_o, 3).contiguous(),
                      scn_o.resolution.expand(n_o).contiguous(),
                      torch.as_tensor(fixtures.lookup_queries(
                          mc_o, n_o, SEED + 1), device=dev)),
        "tiny values": (torch.as_tensor(tiny, device=dev),
                        torch.tensor(mc_t.origin, device=dev).expand(8, 3)
                        .contiguous(),
                        torch.full((8,), mc_t.resolution, device=dev),
                        torch.as_tensor(fixtures.lookup_queries(
                            mc_t, 8, SEED + 2), device=dev)),
    }
    k2_err = 0.0
    for tag, args in k2_cases.items():
        d_k, g_k = trilinear_cuda.trilinear_batch(*args)
        d_p, g_p = trilinear_cuda.trilinear_batch_plain(*args)
        k2_err = max(k2_err, float((d_k - d_p).abs().max()),
                     float((g_k - g_p).abs().max()))
        n_oob = int((d_k == -1.0).sum())
        same_d = torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
        same_g = torch.equal(g_k.view(torch.int32), g_p.view(torch.int32))
        log(f"[4 K2 {tag}] grid {tuple(args[0].shape)}, "
            f"{tuple(args[3].shape[:2])} lookups, {n_oob} out of map; "
            f"bitwise equal to plain: d {same_d}, g {same_g}")
        check(same_d and same_g, f"K2 {tag}: not bitwise its plain version")
        # at least the 10 beyond the far faces and the 2 on the margins
        check(n_oob >= args[3].shape[0] * 12,
              f"K2 {tag}: only {n_oob} out-of-map samples read -1")
    d_k, _ = trilinear_cuda.trilinear_batch(*k2_args)
    n_oob = int((d_k == -1.0).sum())
    # the device time (a CUDA graph of 100 launches), one wrapper call
    # between events (the host's checks and ctypes call included), and the
    # host's enqueue alone
    k2_ms = graph_ms(lambda: trilinear_cuda.trilinear_batch(*k2_args))
    k2_wrap_ms = gpu_ms(lambda: trilinear_cuda.trilinear_batch(*k2_args))
    k2_host_ms = host_ms(lambda: trilinear_cuda.trilinear_batch(*k2_args))
    k2_plain_ms = gpu_ms(lambda: trilinear_cuda.trilinear_batch_plain(
        *k2_args))
    # yardstick, computing less: F.grid_sample gives d alone (no gradient,
    # no -1 out of map), from cell indices normalised to [-1, 1] with the
    # axes reversed; the port never calls it
    gs_in = dist[:, None]
    n_cells = torch.tensor(grid, dtype=torch.float32, device=dev)
    cell = (pos - org_b[:, None]) / res_b[:, None, None] - 0.5
    gs_grid = (cell / (n_cells - 1) * 2 - 1).flip(-1)[:, :, None, None, :]

    def grid_sample_d():
        return torch.nn.functional.grid_sample(
            gs_in, gs_grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    gs_ms = graph_ms(grid_sample_d)
    inside = d_k[:, :148] != -1.0
    gs_err = float((grid_sample_d()[:, 0, :148, 0, 0] - d_k[:, :148])
                   .abs()[inside].max())
    n_pts = pos.shape[0] * pos.shape[1]
    # inputs once (positions, origins, resolutions, the eight corners of
    # every in-map point), outputs once (d, g); ~70 operations a point
    k2_bound = {"bytes_ms": (4 * (3 * n_pts + 4 * BATCH + 4 * n_pts)
                             + 32 * (n_pts - n_oob)) / HBM_BPS * 1e3,
                "ops_ms": 70 * n_pts / FP32_FLOPS * 1e3}
    log(f"[4 K2] bench {tuple(pos.shape[:2])}: device {k2_ms * 1e3:.2f} us "
        f"(graph of 100), one wrapper call {k2_wrap_ms * 1e3:.2f} us "
        f"between events, host enqueue {k2_host_ms * 1e3:.2f} us; plain "
        f"{k2_plain_ms:.3f} ms; bound "
        f"{bound_entry(k2_bound)['bound_ms'] * 1e3:.2f} us; F.grid_sample "
        f"(d only) {gs_ms * 1e3:.2f} us, max |d - K2's d| {gs_err:.3g} on "
        f"interior points {card}")
    del scn_o, k2_cases

    # ---- 5. K3 vs plain ----------------------------------------------
    scns = solver.Scenario(
        dist=dist, origin=org_b, resolution=res_b,
        waypoints=torch.as_tensor(wps, dtype=torch.float32, device=dev),
    )

    def positions(dpT, Df, T):
        coeff = qp.coeff_from_d(Df, dpT.transpose(1, 2), T)
        return poly.sample_uniform(coeff, T, 100)[0]

    # one iteration, before any rounding has been amplified: every lane
    # must agree to the rounding of f32 sums taken in another order,
    # ~1e-6 relative over 180 samples; the tolerance is ten times that
    k3_err, n_agree = k3_short_checks("5 K3", scns, gto.OptimizerConfig(),
                                      positions)

    cfg = gto.OptimizerConfig()
    kargs, _ = solver.kernel_inputs(scns, cfg)
    ph = ((2, cfg.iters_step2),)
    _, ck, _, tk = solve_cuda.descend(*kargs, ph, cfg)
    _, cpl, _, _ = solve_cuda.descend_plain(*kargs, ph, cfg)
    ok, (p50, p90, mean) = _dist_rule(ck.cpu().numpy(), cpl.cpu().numpy())
    check(bool(torch.all(tk[:, 1:] <= tk[:, :-1])), "K3 trace not monotone")
    check(ok, f"K3 full budget |log cost ratio| p50 {p50} p90 {p90} mean "
              f"{mean}")
    # one call between events (the host's wrapper inside), and the device
    # time alone (3 launches back to back)
    k3_ms = gpu_ms(lambda: solve_cuda.descend(*kargs, ph, cfg))
    k3_dev_ms = stream_ms(lambda: solve_cuda.descend(*kargs, ph, cfg))
    k3_plain_ms = gpu_ms(lambda: solve_cuda.descend_plain(*kargs, ph, cfg))
    m_b, K_b = N_WP - 1, cfg.n_samples
    k3_bound = k3_bound_ms(BATCH, m_b, K_b, cfg.iters_step2 + 1, False)
    log(f"[5 K3] {cfg.iters_step2} iterations: |log cost ratio| p50 "
        f"{p50:.3g} p90 {p90:.3g} mean {mean:.3g} (limits 0.02/0.25/0.10); "
        f"one call {k3_ms:.3f} ms ({k3_dev_ms:.3f} ms device) vs plain "
        f"{k3_plain_ms:.3f} ms for {BATCH} "
        f"scenarios; bound {bound_entry(k3_bound)['bound_ms']:.3f} ms "
        f"{card}")
    # the launch plan: every bench scenario resident at once (one wave),
    # with and without the acceleration chain
    plans = {}
    for tag, c in (("OptimizerConfig()", cfg),
                   ("CLICK_CONFIG", gto_config.CLICK_CONFIG)):
        pl = solve_cuda.plan(m_b, K_b, c.accept_window, c.alpha_a != 0.0,
                             BATCH)
        plans[tag] = pl
        resident = pl["blocks_per_sm"] * pl["sms"]
        log(f"[5 K3 plan] {tag}: {pl['spt']} samples a thread, "
            f"{pl['threads']} threads and {pl['smem']} B of shared memory a "
            f"block, {pl['blocks_per_sm']} blocks per SM x {pl['sms']} SMs "
            f"= {resident} resident >= {BATCH}: {resident >= BATCH}")
        check(resident >= BATCH, f"K3 {tag}: {resident} resident blocks, "
              f"the bench batch of {BATCH} takes more than one wave")
    lap("5 K3")

    # ---- 5b. K3 with the velocity/acceleration penalties ---------------
    click = gto_config.CLICK_CONFIG
    k3a_err, n_agree_a = k3_short_checks("5b K3 CLICK", scns, click,
                                         positions)
    kargs, _ = solver.kernel_inputs(scns, click)
    check(kargs[-1] is not None, "CLICK inputs lack the acceleration chain")
    ph_c = ((2, click.iters_step2),)
    k3a_ms = gpu_ms(lambda: solve_cuda.descend(*kargs, ph_c, click))
    k3a_dev_ms = stream_ms(lambda: solve_cuda.descend(*kargs, ph_c, click))
    k3a_plain_ms = gpu_ms(lambda: solve_cuda.descend_plain(*kargs, ph_c,
                                                           click))
    k3a_bound = k3_bound_ms(BATCH, m_b, K_b, click.iters_step2 + 1, True)
    log(f"[5b K3 CLICK] {click.iters_step2} iterations with alpha_v = "
        f"alpha_a = {click.alpha_v}: one call {k3a_ms:.3f} ms "
        f"({k3a_dev_ms:.3f} ms device) vs plain "
        f"{k3a_plain_ms:.3f} ms for {BATCH} scenarios; bound "
        f"{bound_entry(k3a_bound)['bound_ms']:.3f} ms {card}")
    del kargs, scns, dist, occ
    lap("5b K3 CLICK")

    # ---- 6. main path, counted ---------------------------------------
    counters = KERNEL_COUNTERS

    def main_path():
        occ = sdf.rasterize(pts_d, origin, res, grid, valid_mask=valid_d)
        dist = sdf.edt_batch(occ, res)
        scns = solver.Scenario(
            dist=dist, origin=org_b, resolution=res_b,
            waypoints=torch.as_tensor(wps, dtype=torch.float32, device=dev),
        )
        sols = solver.solve_batch(scns, cfg=cfg, steps=(2,))
        return sols, solver.min_clearance(sols, scns)

    totals = dict.fromkeys(counters, 0)
    per_path = {}

    def counted(path, fn, expect):
        """Run one path with every count set to 0 just before it and read
        just after: each kernel in ``expect`` launched exactly that often
        (default 0), and no plain version called.  ``expect`` may be
        a function of the path's output, called after the counts are
        read."""
        torch.cuda.synchronize()
        profiling.reset_counters("launch.")
        profiling.reset_counters("plain.")
        out = fn()
        torch.cuda.synchronize()
        got = {k: profiling.counter(c) for k, c in counters.items()}
        n_plain = sum(profiling.counters("plain.").values())
        if callable(expect):
            expect = expect(out)
        want = {"K1": 0, "K1 long": 0, "K2": 0, "K3": 0, **expect}
        log(f"    [{path}] launches {got}, plain calls {n_plain}")
        check(got == want, f"{path}: kernel launches {got}, expected {want}")
        check(n_plain == 0, f"{path}: {n_plain} plain-version calls on CUDA")
        for k in totals:
            totals[k] += got[k]
        per_path[path] = got
        return out

    sols, clear = counted("main path", main_path,
                          {"K1": 2, "K2": 1, "K3": 1})
    launches = dict(totals)
    n_ok = int((sols.status == solver.STATUS_OK).sum())
    check(n_ok == BATCH, f"status ok on {n_ok}/{BATCH} lanes")
    check(sols.coeff.shape == (BATCH, N_WP - 1, 3, 6)
          and bool(torch.isfinite(sols.coeff).all())
          and bool(torch.isfinite(sols.cost).all()), "bad solution tensors")
    ends = poly.evaluate(sols.coeff, sols.T, torch.stack(
        [torch.zeros_like(sols.T[:, 0]), sols.T.sum(1)], dim=1))
    wp_t = torch.as_tensor(wps, dtype=torch.float32, device=dev)
    end_err = float(torch.maximum((ends[:, 0] - wp_t[:, 0]).abs().amax(),
                                  (ends[:, 1] - wp_t[:, -1]).abs().amax()))
    check(end_err < 1e-3, f"trajectory endpoints off by {end_err} m")
    log(f"[6 main] {n_ok}/{BATCH} lanes status ok; launches {launches}; "
        f"endpoint error {end_err:.2g} m; "
        f"median cost {float(sols.cost.median()):.6g}; min clearance "
        f"median {float(clear.median()):.3f} m, "
        f"{int((clear > 0).sum())}/{BATCH} lanes collision-free")

    # EDT builds/s and solves/s: bench_torch.py's line (phase 18)
    dist = sdf.edt_batch(sdf.rasterize(pts_d, origin, res, grid,
                                       valid_mask=valid_d), res)
    scns = solver.Scenario(dist=dist, origin=org_b, resolution=res_b,
                           waypoints=wp_t)

    # where the time goes: each layer's device time at bench shape; the
    # y and x passes run in place on a scratch copy (K1's time does not
    # depend on the values)
    occ = sdf.rasterize(pts_d, origin, res, grid, valid_mask=valid_d)
    sq_z = sdf._nearest_sq_1d(occ, dim=-1)
    sq_y = sq_z.clone()
    sq_x = sdf._squared_edt(occ)
    layers = {
        "rasterize": lambda: sdf.rasterize(pts_d, origin, res, grid,
                                           valid_mask=valid_d),
        "z pass": lambda: sdf._nearest_sq_1d(occ, dim=-1),
        "y pass": lambda: edt_cuda.minplus_along(sq_y, dim=-2),
        "x pass": lambda: edt_cuda.minplus_along(sq_y, dim=-3),
        "metric": lambda: torch.clamp(sdf._metric(sq_x, res),
                                      max=sdf.FREE_DIST),
        "kernel_inputs": lambda: solver.kernel_inputs(scns, cfg),
    }
    split = {k: gpu_ms(fn) for k, fn in layers.items()}
    log(f"[6 main] layers, device ms per {BATCH}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; K3 {k3_ms:.3f} {card}")
    del occ, sq_z, sq_y, sq_x
    lap("6 main")

    # ---- 7. opti_node at B = 1 ---------------------------------------
    cfg_s = gto.OptimizerConfig(iters_step2=SHORT_ITERS)
    ph_s = ((2, SHORT_ITERS),)
    mc, obss, wp = fixtures.opti_node_scenario()
    scn = solver.make_scenario(wp, obss, mc, device=dev)
    one = scn.map(lambda x: x[None])
    kargs, _ = solver.kernel_inputs(one, cfg_s)
    dk, ck, nk, _ = solve_cuda.descend(*kargs, ph_s, cfg_s)
    _, cpl, npl, _ = solve_cuda.descend_plain(*kargs, ph_s, cfg_s)
    check(int(nk[0]) == int(npl[0])
          and abs(float(ck[0] - cpl[0])) <= 5e-3 * abs(float(cpl[0])),
          f"opti_node short budget: kernel {float(ck[0])}/{int(nk[0])} vs "
          f"plain {float(cpl[0])}/{int(npl[0])}")
    sol = solver.solve(scn, cfg=cfg, steps=(2,))
    check(int(sol.status) == solver.STATUS_OK, "opti_node status")
    wp_d = torch.as_tensor(wp, dtype=torch.float32, device=dev)
    ends = poly.evaluate(sol.coeff, sol.T, torch.stack(
        [torch.zeros_like(sol.T[0]), sol.T.sum()]))
    end_err = float(torch.maximum((ends[0] - wp_d[0]).abs().max(),
                                  (ends[1] - wp_d[-1]).abs().max()))
    check(end_err < 1e-3, f"opti_node endpoints off by {end_err} m")
    clear1 = float(solver.min_clearance(
        solver.Solution(*(x[None] for x in sol)), one)[0])
    check(clear1 > 0, f"opti_node trajectory collides ({clear1} m)")
    kargs, _ = solver.kernel_inputs(one, cfg)
    ph1 = ((2, cfg.iters_step2),)
    k3_one_ms = gpu_ms(lambda: solve_cuda.descend(*kargs, ph1, cfg), reps=5)
    k3_one_dev_ms = stream_ms(lambda: solve_cuda.descend(*kargs, ph1, cfg))
    m_1 = wp.shape[0] - 1
    pl1 = solve_cuda.plan(m_1, cfg.n_samples, cfg.accept_window, False, 1)
    log(f"[7 opti_node] K3 alone at B=1, {cfg.iters_step2} iterations: one "
        f"call {k3_one_ms:.3f} ms, {k3_one_dev_ms:.3f} ms device "
        f"({k3_one_dev_ms * 1e3 / cfg.iters_step2:.2f} us per iteration; "
        f"{pl1['spt']} sample a thread, {pl1['threads']} threads) {card}")
    metrics = {k: float(v) for k, v in solver.evaluate_solution(sol).items()}
    log(f"[7 opti_node] grid {tuple(scn.dist.shape)}, {wp.shape[0]} "
        f"waypoints: status ok, n_accept {int(sol.n_accept)}, cost "
        f"{float(sol.cost):.6g}, endpoint error {end_err:.2g} m, min "
        f"clearance {clear1:.3f} m, length {metrics['length']:.3f} m {card}")
    del scn, one, kargs
    lap("7 opti_node")

    # ---- 8. front-end ------------------------------------------------
    phase_frontend(dist, wps, map_cfg, card)
    lap("8 search")

    # ---- 9. mission pipeline, counted --------------------------------
    knots = phase_pipeline(dist, wps, map_cfg, card, counted)
    lap("9 pipeline")

    # ---- 10. dual-seed presets, counted ------------------------------
    phase_dual(scns, card, counted)
    lap("10 dual")

    # ---- 11-14. online use, counted -----------------------------------
    phase_ladder(dist, wps, map_cfg, card, counted)
    lap("11 ladder")
    phase_solve_server(scns, card, counted)
    lap("12 SolveServer")
    phase_replan(dev, card, counted)
    lap("13 replan_loop")
    phase_rrt_and_missions(dist, wps, map_cfg, card, counted)
    phase_mission_rung(dist, wps, map_cfg, card, counted)
    lap("14 replan_loop_rrt + MissionServer")
    phase_compare2(dev, card, counted)
    lap("15 compare2")
    phase_mesh(sdf.rasterize(pts_d, origin, res, grid, valid_mask=valid_d),
               scns, map_cfg, card, per_path, totals)
    lap("16 mesh")
    # phase 16's ranks have exited; the parent's cache goes too, so that
    # the 512^3 builds below do not stack on it
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    crop_rep = phase_crop(dev, card, counted, positions)
    lap("17 crop and stress")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_benches(dev, card, counted)
    lap("18 benches")
    fused_rep = phase_fused(scns, knots, card, counted)
    lap("19 fused")
    shapes_rep = phase_shapes(dist, wps, map_cfg, card, counted)
    lap("20 shapes and options")
    log(f"counted paths' launches {totals}")

    # ---- report --------------------------------------------------------
    src = "grad_traj_optimization_torch/csrc/"
    def on_paths(k):
        return {p: got[k] for p, got in per_path.items() if got[k]}

    kernels = [
        dict(name="K1 minplus_along", route="cuda", source=src + "minplus.cu",
             replaces="grad_traj_optimization_tpu/ops/edt_pallas.py:31",
             launches=totals["K1"], launches_per_path=on_paths("K1"),
             max_abs_err=k1_err,
             err_of="squared cell distances, y and x passes, bench and "
                    f"{ODD_SHAPE}", ms=k1_ms, ms_x_pass=k1_x_ms,
             plain_ms=k1_plain_ms, **bound_entry(k1_bound),
             dense_ops_ms=k1_dense_ms, library_ms=None,
             long_line=dict(
                 shapes_rep["long_line"], name="K1 minplus_long",
                 route="cuda", source=src + "minplus.cu (gto_minplus_long)",
                 replaces="grad_traj_optimization_tpu/ops/edt_pallas.py:31",
                 launches=totals["K1 long"],
                 launches_per_path=on_paths("K1 long"), library_ms=None,
                 of="lines longer than 4096 cells: the x pass of shape fed "
                    "by an occupancy grid's z and y passes, out of place, "
                    "device ms (events, min of 3) against one call of the "
                    "plain version; paths: the kernel's counters of lines "
                    "and outputs a path; dense_path: the same pass of "
                    "random reals; bench_passes: the kernel on the bench's "
                    "100-cell passes beside the staged kernel; per_n "
                    "bitwise checks and times")),
        dict(name="K2 trilinear_batch", route="cuda",
             source=src + "trilinear.cu",
             replaces="grad_traj_optimization_tpu/ops/trilinear_pallas.py:256",
             launches=totals["K2"], launches_per_path=on_paths("K2"),
             max_abs_err=k2_err,
             err_of="d (m) and g, bench fields and the opti_node map "
                    "(checked bitwise)",
             ms=k2_ms, ms_of="device: a CUDA graph of 100 launches",
             ms_wrapper=k2_wrap_ms, host_ms=k2_host_ms,
             plain_ms=k2_plain_ms, **bound_entry(k2_bound), library_ms=None,
             grid_sample_d_ms=gs_ms,
             grid_sample_d_of="F.grid_sample, d alone: no gradient, no -1 "
                              "out of map; not called by the port",
             lookups_in_k3=(cfg.iters_step2 + 1) * BATCH * (N_WP - 1)
             * cfg.n_samples,
             division_check_differ=div_check,
             per_iteration_path=dict(
                 fused_rep, of="phase 19: solve_batch_fused at B = 1024, "
                 "100 iterations, one K2 launch an evaluation; K2 at this "
                 "path's seed positions: k2_ms on a cold L2 (median of 30 "
                 "graph replays of one call, 1 GiB written before each), "
                 "k2_warm_ms a CUDA "
                 "graph of 100 launches with the inputs in L2, the bound's "
                 "bytes from the distinct corner cells")),
        dict(name="K3 descend", route="cuda", source=src + "solve.cu",
             replaces="grad_traj_optimization_tpu/ops/solve_pallas.py:239",
             launches=totals["K3"], launches_per_path=on_paths("K3"),
             max_abs_err=max(k3_err, k3a_err, crop_rep["crop_1iter_err"]),
             err_of=f"sampled positions (m) after 1 iteration, all lanes, "
                    f"OptimizerConfig() and CLICK_CONFIG (alpha_v, alpha_a),"
                    f" and on cropped inputs (phase 17);"
                    f" after {SHORT_ITERS}, {n_agree} and {n_agree_a}/"
                    f"{BATCH} lanes agree",
             ms=k3_ms, plain_ms=k3_plain_ms, **bound_entry(k3_bound),
             library_ms=None, alpha_ms=k3a_ms, alpha_plain_ms=k3a_plain_ms,
             alpha_bound_ms=bound_entry(k3a_bound)["bound_ms"],
             b1_opti_node_ms=k3_one_ms,
             ms_device=k3_dev_ms, alpha_ms_device=k3a_dev_ms,
             b1_opti_node_ms_device=k3_one_dev_ms,
             ms_device_of="3 launches back to back between events, over 3; "
                          "ms, alpha_ms and b1_opti_node_ms are one call "
                          "between events, the host's wrapper inside",
             plans=plans, dispatch_sweep=shapes_rep["dispatch_sweep"],
             refused_shapes=shapes_rep["refused"],
             crop=dict(crop_rep, ms_device_of="3 launches back to back "
                       "between events, over 3, min of 3, full and cropped "
                       "in turns")),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
