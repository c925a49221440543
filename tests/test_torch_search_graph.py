"""The one-mission beam search as a CUDA graph (``kinodynamic.search``).

On a card (marked ``cuda``; each test skips with a reason where no GPU is
visible, decided inside the test): the graphed search against the eager
search, bitwise, over the ticks of opti_node missions with two moving
boxes and a wall that appears mid-flight; a swapped grid read by the next
replay; no call's tensors aliasing another's; one capture per search
shape, on its second call and within the cache's bound; the counters; a
field on the second card while the first is current (skipped below two
cards).  Run them from the
repository root with

    python -m pytest --noconftest -m cuda tests/test_torch_search_graph.py

On the CPU: CPU tensors stay on the eager path, and the constants and
extents that the graph builds once give what the eager search computes.
This file imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from grad_traj_optimization_torch import fixtures, replan  # noqa: E402
from grad_traj_optimization_torch.config import OptimizerConfig  # noqa: E402
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.search import kinodynamic as kd  # noqa: E402
from grad_traj_optimization_torch.search import predictor  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

COUNTS = ("search.graph_captures", "search.graph_replays")
#: two boxes crossing the opti_node route (chip_smoke's phase 13)
_boxes = chip_smoke.replan_boxes


def _counts():
    return {k: profiling.counter(k) for k in COUNTS}


def _fresh():
    """An empty graph cache, no shape seen and zeroed search counters."""
    kd._GRAPHS.clear()
    kd._SEEN.clear()
    profiling.reset_counters("search.")


def _eager(args, kw) -> kd.KinoResult:
    """The eager search of one recorded ``search`` call: ``search_batch``
    at one lane, which captures nothing."""
    kw = dict(kw)
    pred = kw.pop("obstacle_pred", None)
    t = float(kw.pop("start_time", 0.0))
    dist, origin, res, start, goal = args
    dev = dist.device
    r = kd.search_batch(
        dist[None], torch.as_tensor(origin, device=dev)[None], res,
        torch.as_tensor(start, device=dev)[None],
        torch.as_tensor(goal, device=dev)[None], obstacle_pred=pred,
        start_times=torch.full((1,), t, device=dev), **kw)
    return kd.KinoResult(*(x[0] for x in r))


def _assert_bitwise(a: kd.KinoResult, b: kd.KinoResult, what=""):
    for name, x, y in zip(kd.KinoResult._fields, a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, name)
        assert torch.equal(x, y), (what, name)


def _pred(t: float, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return predictor.fit_const_vel(
        *(torch.as_tensor(x, **f32) for x in _boxes(t)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; none is visible")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def opti(dev):
    """The opti_node field, the same field with chip_smoke's phase-13
    wall added, the map's origin and resolution, and its waypoints."""
    mc, obss, wp = fixtures.opti_node_scenario()
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(mc.origin, **f32)
    occ = sdf.rasterize(torch.as_tensor(obss, **f32), origin, mc.resolution,
                        mc.grid_shape)
    walled = torch.as_tensor(chip_smoke.wall_occupancy(occ.cpu().numpy()),
                             device=dev)
    return (sdf.edt(occ, mc.resolution), sdf.edt(walled, mc.resolution),
            origin, mc.resolution, wp)


def _state(p):
    return np.concatenate([np.asarray(p, np.float64), np.zeros(3)])


@pytest.mark.cuda
def test_graphed_search_bitwise_over_mission_ticks(dev, opti, monkeypatch):
    """Every tick's graphed search equals the eager search of the same
    inputs in every field and bit, with each tick's result kept until
    the missions end (so no replay wrote over an earlier tick's result).
    Two missions fly with two moving boxes and the wall added at their
    third tick; a third aims at a target inside the first wall, so its
    ticks go unreached.  One shape: the first call eager, the second a
    capture, every call after the first a replay."""
    field, walled, origin, res, wp = opti
    calls = []
    real = kd.search

    def record(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(kd, "search", record)
    _fresh()
    ocfg = OptimizerConfig()
    for shift in (0.0, 0.3):
        ticks = []

        def add_wall(t, grid):
            ticks.append(t)
            return walled if len(ticks) == 3 else None

        start = _state(wp[0] + np.array([shift, 0.0, 0.0]))
        replan.replan_loop(
            field, origin.cpu().numpy(), res, start, _state(wp[-1]),
            obstacle_update=_boxes, map_update=add_wall,
            rcfg=replan.ReplanConfig(horizon=10.5, fallback_exact=False),
            ocfg=ocfg, device=dev)
    # at the default 7 m horizon the first target lies within the margin
    # of the first wall: every search fails
    replan.replan_loop(field, origin.cpu().numpy(), res, _state(wp[0]),
                       _state(wp[-1]), obstacle_update=_boxes,
                       rcfg=replan.ReplanConfig(max_ticks=4,
                                                fallback_exact=False),
                       ocfg=ocfg, device=dev)
    assert len(calls) >= 20, len(calls)
    reached = [bool(out.reached) for _, _, out in calls]
    assert any(reached) and not all(reached), reached
    assert any(a[0] is walled for a, _, _ in calls)
    for i, (a, kw, out) in enumerate(calls):
        _assert_bitwise(out, _eager(a, kw), f"tick {i}")
    assert _counts() == {"search.graph_captures": 1,
                         "search.graph_replays": len(calls) - 1}


@pytest.mark.cuda
def test_replay_reads_a_swapped_grid(dev, opti):
    """After the grid changes (map_update's new field), the next replay
    reads the new grid: it equals the eager search on it, which differs
    from the search on the old one."""
    field, walled, origin, res, wp = opti
    _fresh()
    args = (origin, res, torch.as_tensor(_state(wp[0]), device=dev),
            torch.as_tensor(_state(wp[-1]), device=dev))
    kw = dict(obstacle_pred=_pred(1.0, dev), start_time=1.0, margin=0.3,
              max_iters=16, beam=64)
    kd.search(field, *args, **kw)  # the shape's first call: eager
    old = kd.search(field, *args, **kw)  # captures
    new = kd.search(walled, *args, **kw)
    assert profiling.counter("search.graph_replays") == 2
    _assert_bitwise(old, _eager((field, *args), kw), "old grid")
    _assert_bitwise(new, _eager((walled, *args), kw), "new grid")
    assert not torch.equal(old.pos, new.pos)


@pytest.mark.cuda
def test_results_do_not_alias(dev, opti):
    """A call's tensors are its own: the next call changes none of them."""
    field, _, origin, res, wp = opti
    _fresh()
    kw = dict(obstacle_pred=_pred(0.0, dev), margin=0.3, max_iters=16,
              beam=64)

    def call(p, t):
        return kd.search(field, origin, res,
                         torch.as_tensor(_state(p), device=dev),
                         torch.as_tensor(_state(wp[-1]), device=dev),
                         start_time=t, **kw)

    call(wp[0], 0.0)  # the shape's first call: eager
    first = call(wp[0], 0.0)  # captures
    kept = [x.clone() for x in first]
    second = call(wp[3], 2.0)
    assert profiling.counter("search.graph_replays") == 2
    assert not torch.equal(first.pos, second.pos)
    for x, y, z in zip(first, kept, second):
        assert torch.equal(x, y)
        assert x.data_ptr() != z.data_ptr()


@pytest.mark.cuda
def test_new_shape_captures_within_the_bound(dev, opti):
    """A shape's first call runs eagerly and captures nothing, its second
    captures; a change of ``beam`` or ``max_iters`` is a new shape.  The
    cache keeps at most ``GRAPH_CACHE_SIZE`` graphs, the least recently
    used leaving first, and an evicted shape's next call captures again.
    Every call equals the eager search."""
    field, _, origin, res, wp = opti
    _fresh()
    args = (field, origin, res, torch.as_tensor(_state(wp[0]), device=dev),
            torch.as_tensor(_state(wp[-1]), device=dev))
    shapes = [dict(beam=8, max_iters=it)
              for it in range(1, kd.GRAPH_CACHE_SIZE + 2)]
    shapes.append(dict(beam=16, max_iters=1))
    for i, kw in enumerate(shapes):
        for n in range(2):
            _assert_bitwise(kd.search(*args, **kw), _eager(args, kw),
                            f"{kw}, call {n}")
            assert profiling.counter("search.graph_captures") == i + n
            assert len(kd._GRAPHS) == min(i + n, kd.GRAPH_CACHE_SIZE)
    assert profiling.counter("search.graph_replays") == len(shapes)
    kw = shapes[-1]  # still kept: replays
    _assert_bitwise(kd.search(*args, **kw), _eager(args, kw), "kept")
    assert profiling.counter("search.graph_replays") == len(shapes) + 1
    assert profiling.counter("search.graph_captures") == len(shapes)
    kw = shapes[0]  # left first: captured again at once
    _assert_bitwise(kd.search(*args, **kw), _eager(args, kw), "evicted")
    assert profiling.counter("search.graph_captures") == len(shapes) + 1
    assert profiling.counter("search.graph_replays") == len(shapes) + 2
    assert len(kd._GRAPHS) == kd.GRAPH_CACHE_SIZE


@pytest.mark.cuda
def test_search_on_a_second_card(dev, opti):
    """A field on cuda:1 while cuda:0 is current: the search captures and
    replays on cuda:1, so each call from another start state is bitwise
    the eager search there (a graph that captured nothing would return
    one answer for all), and cuda:0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    one = torch.device("cuda:1")
    torch.cuda.set_device(0)
    field, _, origin, res, wp = opti
    field, origin = field.to(one), origin.to(one)
    goal = torch.as_tensor(_state(wp[-1]), device=one)
    kw = dict(obstacle_pred=_pred(1.0, one), start_time=1.0, margin=0.3,
              max_iters=16, beam=64)
    _fresh()
    outs = []
    for i, p in enumerate(wp[:6]):
        start = torch.as_tensor(_state(p), device=one)
        out = kd.search(field, origin, res, start, goal, **kw)
        assert out.pos.device == one
        _assert_bitwise(out, _eager((field, origin, res, start, goal), kw),
                        f"start {i}")
        outs.append(out)
    assert _counts() == {"search.graph_captures": 1,
                         "search.graph_replays": len(outs) - 1}
    assert torch.cuda.current_device() == 0
    assert not torch.equal(outs[1].pos, outs[2].pos)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    """A small pillar-and-wall search problem on the CPU."""
    rng = np.random.default_rng(5)
    c = None
    while c is None:
        c = fixtures.random_search_case(rng, device="cpu")
    dist, origin, res, start, goal = c
    return (dist, torch.as_tensor(origin, dtype=torch.float32), res,
            torch.as_tensor(_state(start), dtype=torch.float32),
            torch.as_tensor(_state(goal), dtype=torch.float32))


@pytest.mark.parametrize("lookup", ["gather", "box"])
def test_cpu_search_stays_eager(case, lookup):
    """CPU tensors never reach the graph cache or its counters, and give
    the eager batched search's lane, bitwise."""
    dist, origin, res, start, goal = case
    _fresh()
    before = _counts()
    kw = dict(obstacle_pred=_pred(0.5, "cpu"), start_time=0.5, beam=8,
              max_iters=4, lookup=lookup)
    r = kd.search(dist, origin, res, start, goal, **kw)
    _assert_bitwise(r, _eager((dist, origin, res, start, goal), kw))
    assert not kd._GRAPHS and not kd._SEEN and _counts() == before


def _extent_args(case, half=3):
    """Lane-led positions over the map and past its sides, their parents,
    and the grid's extent as the graph builds it."""
    dist, origin, res, _, _ = case
    g = torch.Generator().manual_seed(3)
    lo = origin - 1.0
    span = torch.tensor(dist.shape, dtype=torch.float32) * res + 2.0
    pos = lo + span * torch.rand((2, 4, 7, 3), generator=g)
    parent = pos[:, :, 0]
    consts = kd._search_consts(tuple(dist.shape), res, 2.0, 5, "cpu", half)
    return dist[None], origin.expand(2, 3), res, parent, pos, consts.extent


@pytest.mark.parametrize("fn", ["lane_cells", "distance_at_lanes",
                                "window_safe_lanes"])
def test_lane_extent_given_or_not(case, fn):
    """The precomputed extent gives what the helper computes without it."""
    dists, origins, res, parent, pos, ext = _extent_args(case)

    def call(extent):
        if fn == "lane_cells":
            return kd._lane_cells(dists, origins, res, pos, extent=extent)
        if fn == "distance_at_lanes":
            return (kd._distance_at_lanes(dists, origins, res, pos,
                                          extent),)
        return (kd._window_safe_lanes(dists, origins, res, parent, pos, 3,
                                      0.2, extent),)

    for a, b in zip(call(None), call(ext)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lookup", ["gather", "box"])
def test_search_consts_given_or_not(case, lookup):
    """``_search_impl`` with the constants built once (the graph's path)
    equals it with the constants and extents copied per call, bitwise."""
    dist, origin, res, start, goal = case
    p = kd._search_params(res, lookup, beam=8, max_iters=4)
    inputs = (dist[None], origin[None].expand(2, 3), res,
              torch.stack([start, start + torch.tensor([0.3, 0.0, 0.0,
                                                        0.0, 0.0, 0.0])]),
              goal.expand(2, 6), _pred(0.5, "cpu"),
              torch.tensor([0.5, 1.0]))
    consts = kd._search_consts(tuple(dist.shape), res, p["max_acc"],
                               p["n_acc"], "cpu",
                               p["box_cells"] if lookup == "box" else None)
    _assert_bitwise(kd._search_impl(*inputs, **p),
                    kd._search_impl(*inputs, consts=consts, **p))
