"""PyTorch port, the tracer (``utils.profiling``) on the CPU: spans record
only while a profiler records and then share its clock, nest as the
layers do in ``plan_batch``, ``solve_batch`` and a replan tick, and carry
the counts added while they were open; the counters count either way;
and the benchmark's readers of them (``gtop_bench/metrics``) read a
synthetic run.
"""

import os
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from grad_traj_optimization_torch import native, pipeline  # noqa: E402
from grad_traj_optimization_torch import replan, solver  # noqa: E402
from grad_traj_optimization_torch.config import OptimizerConfig  # noqa: E402
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.search import kinodynamic  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gtop_bench import spec  # noqa: E402

RES = 0.25
ORIGIN = np.array([-5.0, -5.0, 0.0], np.float32)
#: a record and its profiler range agree to this (ns)
CLOCK_TOL_NS = 50_000
#: two lanes through the wall's gap, two whose shot the wall blocks, so
#: the starved beam leaves them to the retry ladder
STARTS = [[0.0, -3.0, 2.0], [0.3, -2.0, 2.0], [-3.0, -3.0, 2.0],
          [3.0, -3.0, 2.0]]
GOALS = [[0.0, 3.0, 2.0], [-0.3, 2.0, 2.0], [-3.0, 3.0, 2.0],
         [3.0, 3.0, 2.0]]
START = np.array([0, -3, 2, 0, 0, 0], np.float64)
GOAL = np.array([0, 3, 2, 0, 0, 0], np.float64)


def _wall(gap_lo, gap_hi, rows):
    """The 10 m arena's field at 0.25 m with a wall across y = 0 in
    ``rows``, open for x in (gap_lo, gap_hi)."""
    occ = torch.zeros((40, 40, 16))
    for i, x in enumerate(-5.0 + RES * np.arange(40)):
        if not gap_lo < x < gap_hi:
            occ[i, rows, :] = 1
    return sdf.edt(occ, RES)


def _states(xyz):
    s = np.zeros((len(xyz), 6), np.float32)
    s[:, :3] = xyz
    return torch.as_tensor(s)


def _traced(fn):
    """fn() under a CPU profiler: (its result, the span records, the
    program's ranges in the profiler's events by name, in start order)."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            s = e.start_ns()
            ranges.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (s, s + e.duration_ns()))
    recs = profiling.spans()
    profiling.reset_spans()
    return out, recs, {k: sorted(v) for k, v in ranges.items()}


def _plan():
    """Four lanes, two left unreached by the ladder to the host A*."""
    return pipeline.plan_batch(
        _wall(-0.8, 0.8, 20)[None], torch.as_tensor(ORIGIN)[None], RES,
        _states(STARTS), _states(GOALS), cfg=OptimizerConfig(iters_step2=5),
        beam=4, max_iters=4, retries=1, n_waypoints=5, host_fallback=True)


def _fly(max_ticks=2, **rk):
    """The beam of one iteration fails every tick and the host A* flies
    (tests/test_torch_replan.py's fallback case)."""
    rk = dict(dict(replan_dt=0.8, max_ticks=max_ticks, kino_iters=1,
                   kino_beam=8, margin=0.2), **rk)
    return replan.replan_loop(
        _wall(0.8, 2.4, slice(20, 22)), ORIGIN, RES, START, GOAL,
        rcfg=replan.ReplanConfig(**rk),
        ocfg=OptimizerConfig(iters_step1=4, iters_step2=12), device="cpu")


def _as_on_a_card(mp):
    """Count every synchronising site as on a card: on the CPU nothing
    waits, so the helpers would count none."""
    mp.setattr(profiling, "waits", lambda device: True)


@pytest.fixture(scope="module")
def planned():
    native.load()
    with pytest.MonkeyPatch.context() as mp:
        _as_on_a_card(mp)
        return _traced(_plan)


@pytest.fixture(scope="module")
def flown():
    native.load()
    with pytest.MonkeyPatch.context() as mp:
        _as_on_a_card(mp)
        return _traced(_fly)


#: the sites that copy host data onto the card or gather by a mask
COPIES = ("sync.h2d.", "sync.nonzero.")


def _by_name(recs, name):
    return sorted((r for r in recs if r.name == name),
                  key=lambda r: r.start_ns)


def test_profiler_off_records_nothing_and_counts(monkeypatch):
    """With no profiler recording, no span opens a range (the range's
    constructor raises here) or keeps a record; the counters count and the
    tick's times are still read from its spans."""
    def no_range(*a, **kw):
        raise AssertionError("a range opened with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    _as_on_a_card(monkeypatch)
    profiling.reset_spans()
    profiling.reset_counters()
    res = _fly(max_ticks=1, fallback_exact=False)
    sol = solver.solve_batch(_scenario(), cfg=OptimizerConfig(iters_step2=2))
    assert profiling.spans() == []
    assert len(res) == 1 and res[0].t_search > 0 and sol.cost.shape == (1,)
    got = profiling.counters()
    assert got["sync.replan.reached"] == 1
    assert got["sync.h2d.replan.inputs"] >= 2  # the state and the target
    assert res[0].t_fallback == 0.0  # no host A* ran
    assert got["plain.descend"] == 1 + res[0].search_ok


@pytest.mark.parametrize("which", ["plan_batch", "replan_loop"])
def test_spans_share_the_profiler_clock(planned, flown, which):
    """Each record's interval is its ``gtop.`` range's in the profiler's
    events, to 50 microseconds, and there is one record a range."""
    _, recs, ranges = planned if which == "plan_batch" else flown
    names = {r.name for r in recs}
    assert names == set(ranges)
    for name in names:
        mine = _by_name(recs, name)
        assert len(mine) == len(ranges[name]), name
        for r, (a, b) in zip(mine, ranges[name]):
            assert abs(a - r.start_ns) <= CLOCK_TOL_NS, (name, a - r.start_ns)
            assert abs(b - r.end_ns) <= CLOCK_TOL_NS, (name, b - r.end_ns)


def test_plan_batch_spans_nest(planned):
    """``pipeline.plan_batch`` is the root of every span of its call; the
    search, the refine and the host rung are its children, K3's inputs
    the refine's and the rung's; its counts are its call's: lanes,
    retried lanes and each blocking read."""
    r, recs, _ = planned
    (root,) = _by_name(recs, "pipeline.plan_batch")
    assert root.parent is None and root.root == root.id
    assert all(s.root == root.id for s in recs)
    (search,) = _by_name(recs, "pipeline.search")
    (refine,) = _by_name(recs, "pipeline.refine")
    (rung,) = _by_name(recs, "pipeline.host_rung")
    assert search.parent == refine.parent == rung.parent == root.id
    inputs = _by_name(recs, "solver.kernel_inputs")
    assert len(inputs) == 4  # one a stretch of each race
    assert [s.parent for s in inputs] == [refine.id] * 2 + [rung.id] * 2
    assert root.start_ns <= search.start_ns < search.end_ns \
        <= refine.start_ns < refine.end_ns <= rung.start_ns \
        < rung.end_ns <= root.end_ns
    assert r.n_retried == 2 and r.n_host_fallback == 2 and r.reached.all()
    reads = {k: v for k, v in root.counts.items() if not k.startswith(COPIES)}
    assert reads == {
        "search.lanes": 4, "search.lanes_retried": 2,
        "sync.kinodynamic.ladder": 2, "sync.kinodynamic.ladder_rung": 1,
        "sync.pipeline.reached": 2, "sync.pipeline.status": 1,
        "sync.pipeline.rung_field": 1, "sync.pipeline.rung_origins": 1,
        "sync.pipeline.rung_starts": 1, "sync.pipeline.rung_goals": 1,
        "sync.pipeline.rung_status": 1, "plain.descend": 4,
        # K3's plain version descends through ``descent.minimize_batch``:
        # 5 + 1 evaluations a stretch, of the refine's 4 lanes and the
        # host rung's 2
        "descent.evals": 4 * 6, "descent.lanes": 2 * 6 * 4 + 2 * 6 * 2}
    # every search copies its constants and each lookup the grid's extent;
    # the ladder's one rung copies its indices and, reaching no lane,
    # gathers none; the host rung copies its lanes and their knots
    assert "sync.nonzero.kinodynamic.ladder" not in root.counts
    assert root.counts["sync.h2d.kinodynamic.ladder_index"] == 2
    assert root.counts["sync.h2d.pipeline.rung_index"] == 1
    assert root.counts["sync.h2d.pipeline.rung_knots"] == 4
    assert root.counts["sync.h2d.kinodynamic.lane_cells"] > 0
    assert root.counts["sync.h2d.kinodynamic.search_consts"] % 5 == 0
    for site in ("solver.grid_full", "qp.selection", "penalty.bos"):
        assert root.counts["sync.h2d." + site] > 0, site
    assert {k for k in rung.counts if "rung_" in k} == {
        k for k in root.counts if "rung_" in k}
    assert {k: v for k, v in rung.counts.items() if "rung_" in k} == {
        k: v for k, v in root.counts.items() if "rung_" in k}
    assert rung.counts["plain.descend"] == 2
    assert search.counts == {
        k: v for k, v in root.counts.items()
        if k.startswith(("search.", "sync.kinodynamic.",
                         "sync.h2d.kinodynamic.",
                         "sync.nonzero.kinodynamic."))}


def test_tick_spans_nest_and_time_the_tick_result(flown):
    """Each tick is a root with its search, fallback and refine as
    children; ``TickResult.t_search``, ``t_fallback`` and ``t_refine`` are
    those spans' durations; a tick counts its blocking reads and its
    copies onto the card."""
    res, recs, _ = flown
    ticks = _by_name(recs, "replan.tick")
    assert len(ticks) == len(res) == 2
    for tick, r in zip(ticks, res):
        assert tick.parent is None and tick.root == tick.id
        kids = [s for s in recs if s.parent == tick.id]
        assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == [
            "replan.search", "replan.fallback", "replan.refine"]
        assert all(s.root == tick.id for s in recs
                   if tick.start_ns <= s.start_ns <= tick.end_ns)
        by = {s.name: s for s in kids}
        assert r.via_fallback
        assert r.t_search == by["replan.search"].seconds
        assert r.t_fallback == by["replan.fallback"].seconds
        assert r.t_refine == by["replan.refine"].seconds
        assert r.t_fallback > 0
        # the state, the target and the host A*'s four knot arrays
        assert tick.counts["sync.h2d.replan.inputs"] == 6
        for site in ("reached", "duration", "clearance", "state", "coeff",
                     "times"):
            assert tick.counts["sync.replan." + site] == 1, site
    # the field comes to the host once, for the first fallback
    assert ticks[0].counts["sync.replan.fallback_field"] == 1
    assert "sync.replan.fallback_field" not in ticks[1].counts


def test_sync_helper_counts_the_ladders_reads(monkeypatch):
    """The ladder reads ``reached`` once, then twice a rung (the rung's
    lanes and the merged batch), copies a rung's indices and gathers its
    reached lanes by a mask (one a field); it counts its lanes and each
    rung's re-searched lanes, padding left out.  On the CPU no helper
    counts: nothing waits."""
    dist = _wall(-0.8, 0.8, 20)
    # through the gap, a lane the second rung reaches, one the wall blocks
    starts = [[0.0, -3.0, 2.0], [1.2, -1.5, 2.0], [-3.0, -3.0, 2.0]]
    goals = [[0.0, 3.0, 2.0], [1.2, 1.5, 2.0], [-3.0, 3.0, 2.0]]

    def ladder():
        return kinodynamic.search_batch_ladder(
            dist[None], torch.as_tensor(ORIGIN)[None], RES, _states(starts),
            _states(goals), retries=2, beam=2, max_iters=2)

    profiling.reset_counters()
    ladder()
    assert not any(k.startswith("sync.") for k in profiling.counters())
    _as_on_a_card(monkeypatch)
    profiling.reset_counters()
    out, n_retried, used, rounds = ladder()
    assert used == 2 and n_retried == 2
    assert rounds.tolist() == [0, 2, 2] and out.reached.tolist() == [
        True, True, False]
    got = profiling.counters()
    assert got.pop("sync.h2d.kinodynamic.lane_cells") > 0
    assert got == {
        "sync.kinodynamic.ladder": 1 + used,
        "sync.kinodynamic.ladder_rung": used,
        "sync.h2d.kinodynamic.search_consts": 5 * (1 + used),
        # each rung its padded lanes and its reached ones; the second also
        # the mask it gathers the reached lane by, each field once
        "sync.h2d.kinodynamic.ladder_index": 2 * used + 1,
        "sync.nonzero.kinodynamic.ladder": len(
            kinodynamic.KinoResult._fields),
        "search.lanes": 3, "search.lanes_retried": int(rounds.sum())}
    profiling.reset_counters("search.")
    assert not any(k.startswith("search.") for k in profiling.counters())


def _scenario():
    wps = torch.tensor([[[0.0, -3.0, 2.0], [0.0, 0.0, 2.0],
                         [0.0, 3.0, 2.0]]])
    return solver.Scenario(
        dist=_wall(-0.8, 0.8, 20)[None], origin=torch.as_tensor(ORIGIN)[None],
        resolution=torch.tensor([RES]), waypoints=wps)


def test_solve_batch_spans_nest():
    """``solver.solve_batch`` is a root when called alone, with
    ``solver.kernel_inputs`` its child."""
    scn = _scenario()
    _, recs, ranges = _traced(
        lambda: solver.solve_batch(scn, cfg=OptimizerConfig(iters_step2=2)))
    (call,) = _by_name(recs, "solver.solve_batch")
    (inputs,) = _by_name(recs, "solver.kernel_inputs")
    assert call.parent is None and call.root == call.id
    assert inputs.parent == call.id and inputs.root == call.id
    # K3's plain version: 2 + 1 evaluations of the one lane
    assert call.counts == {"plain.descend": 1, "descent.evals": 3,
                           "descent.lanes": 3}
    assert len(ranges["solver.kernel_inputs"]) == 1


def test_span_counts_are_their_threads_and_records_one_session():
    """A span keeps only the counts its own thread added while it was open
    (a count from another thread, such as a server's dispatch thread,
    lands in none of its spans), and the records are cleared when a span
    first finds a profiler recording after one found none, so they hold
    one profiler session's spans."""
    profiling.reset_spans()
    profiling.reset_counters("test.")
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("test.first"):
            pass
    assert [s.name for s in profiling.spans()] == ["test.first"]
    with profiling.span("test.between"):  # no profiler: no record
        pass
    assert [s.name for s in profiling.spans()] == ["test.first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("test.outer") as outer:
            profiling.add("test.mine")
            t = threading.Thread(
                target=lambda: profiling.add("test.other", 3))
            t.start()
            t.join()
            with profiling.span("test.inner") as inner:
                profiling.add("test.mine", 2)
    assert [s.name for s in profiling.spans()] == ["test.inner",
                                                   "test.outer"]
    assert outer.rec.counts == {"test.mine": 3}
    assert inner.rec.counts == {"test.mine": 2}
    assert profiling.counters("test.") == {"test.mine": 3, "test.other": 3}
    profiling.reset_spans()
    profiling.reset_counters("test.")


def test_counters_are_exact_under_threads():
    """Counter adds from more threads than cores lose no update."""
    profiling.reset_counters("stress.")
    n_threads, n_adds = 2 * (os.cpu_count() or 4), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [profiling.add("stress.adds")
                            for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counter("stress.adds") == n_threads * n_adds
    profiling.reset_counters("stress.")


# ------------------------------------------------ the benchmark's readers


def _span(name, i, root, ms, **counts):
    return profiling.Span(name, 10**12 * i, 10**12 * i + int(ms * 1e6), i,
                          None if i == root else root, root, counts)


#: two plan batches, a solve batch and three ticks (the last a loop's
#: last pass that flies no tick), with their device ms
SYNTHETIC = [
    _span("pipeline.search", 2, 1, 800.0, **{"search.lanes": 1024,
                                             "search.lanes_retried": 40}),
    _span("pipeline.plan_batch", 1, 1, 1000.0, **{
        "search.lanes": 1024, "search.lanes_retried": 40,
        "sync.kinodynamic.ladder": 2, "sync.pipeline.status": 1}),
    _span("pipeline.search", 4, 3, 900.0, **{"search.lanes": 1024,
                                             "search.lanes_retried": 24}),
    _span("pipeline.plan_batch", 3, 3, 1100.0, **{
        "search.lanes": 1024, "search.lanes_retried": 24,
        "sync.kinodynamic.ladder": 2, "sync.pipeline.status": 1,
        "sync.pipeline.reached": 1}),
    _span("solver.kernel_inputs", 6, 5, 7.5),
    _span("replan.search", 8, 7, 200.0),
    _span("replan.tick", 7, 7, 230.0, **{
        "sync.replan.reached": 1, "sync.replan.state": 1}),
    _span("replan.search", 10, 9, 150.0),
    _span("replan.tick", 9, 9, 400.0, **{
        "sync.replan.reached": 1, "sync.replan.fallback_field": 1,
        "sync.replan.state": 1, "sync.replan.coeff": 1,
        "sync.h2d.replan.inputs": 2}),
    _span("replan.tick", 11, 11, 0.5),
]
#: a replan window's ticks (`run.driver.ticks`): the second and the fourth
#: ran the host A*
TICKS = [types.SimpleNamespace(t_fallback=f) for f in (0.0, 0.12, 0.0, 0.3)]
DEVICE_MS = {"pipeline.search": [510.0, 510.0],
             "replan.search": [14.0, 21.0]}
EXPECTED = {
    "plan.search_ms": 850.0,
    "plan.search_idle_share": 100.0 * (1 - 1020.0 / 1700.0),
    "plan.host_syncs": 3.5,
    "plan.retried_lane_share": 100.0 * 64 / 2048,
    "solve.kernel_inputs_ms": 7.5,
    "replan.search_idle_share": 100.0 * (1 - 35.0 / 350.0),
    "replan.host_syncs_per_tick": 4.0,
    "replan.fallback_tick_share": 50.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_readers_on_a_synthetic_run(monkeypatch, metric):
    """Each new reader of the program's spans reads a synthetic run; it
    reads None where a device list and the records differ in number or
    the run has no device timeline (idle shares), and None where the
    program has no tracer (the benchmark's parent commits)."""
    read = spec.reader(metric, ROOT)
    run = types.SimpleNamespace(trace={"busy_s": 1.0,
                                       "span_device_ms": DEVICE_MS},
                                driver=types.SimpleNamespace(ticks=TICKS))
    monkeypatch.setattr(profiling.TRACER, "records", list(SYNTHETIC))
    assert read(run) == pytest.approx(EXPECTED[metric], rel=1e-12)
    if metric.endswith("idle_share"):
        short = {k: v[:1] for k, v in DEVICE_MS.items()}
        assert read(types.SimpleNamespace(
            trace={"busy_s": 1.0, "span_device_ms": short})) is None
        # a run without a device timeline (the CPU) reads nothing
        assert read(types.SimpleNamespace(
            trace={"busy_s": 0.0, "span_device_ms": DEVICE_MS})) is None
    monkeypatch.setattr(profiling.TRACER, "records", [])
    assert read(types.SimpleNamespace(
        trace=run.trace, driver=types.SimpleNamespace(ticks=[]))) is None
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "TRACER")
    assert read(run) is None
