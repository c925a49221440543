"""PyTorch port, front end: the kinodynamic search's closed-form math, the
obstacle predictor, the space-time distance oracle, the batched beam
search (static, dynamic, each dedup arm), its retry ladder and the knot
resampler, against the JAX package on identical numpy-seeded inputs.

The JAX side runs its off-TPU path (``lookup="gather"``), as
tests/test_search.py does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu.fields import dynamic as jdyn  # noqa: E402
from grad_traj_optimization_tpu.search import kinodynamic as jkd  # noqa: E402
from grad_traj_optimization_tpu.search import predictor as jpred  # noqa: E402

from grad_traj_optimization_torch import convert  # noqa: E402
from grad_traj_optimization_torch import fixtures as tfix  # noqa: E402
from grad_traj_optimization_torch.fields import dynamic as tdyn  # noqa: E402
from grad_traj_optimization_torch.search import kinodynamic as tkd  # noqa: E402
from grad_traj_optimization_torch.search import predictor as tpred  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _same_nan_inf(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    np.testing.assert_array_equal(a[np.isinf(a)], b[np.isinf(b)])
    return fin


# ------------------------------------------------------ closed-form math


def _states(n=4096, seed=0):
    """Random (start, goal) states of the search's scale: positions in a
    16 m arena, velocities within the 3 m/s limit."""
    rng = np.random.default_rng(seed)
    x1 = np.concatenate([rng.uniform(-8, 8, (n, 3)),
                         rng.uniform(-3, 3, (n, 3))], 1).astype(np.float32)
    x2 = np.concatenate([rng.uniform(-8, 8, (n, 3)),
                         rng.uniform(-3, 3, (n, 3))], 1).astype(np.float32)
    x2[: n // 8, 3:] = 0.0  # goals at rest, as the missions have
    x2[n // 8: n // 8 + 8] = x1[n // 8: n // 8 + 8]  # start == goal
    return x1, x2


def test_state_transit_and_shot_coeffs_match_jax():
    x1, x2 = _states()
    rng = np.random.default_rng(1)
    u = rng.uniform(-2, 2, (x1.shape[0], 3)).astype(np.float32)
    tau = rng.uniform(0.05, 3.0, x1.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        _np(tkd.state_transit(_t(x1), _t(u), _t(tau))),
        np.asarray(jkd.state_transit(jnp.asarray(x1), jnp.asarray(u),
                                     jnp.asarray(tau))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(tkd.shot_coeffs(_t(x1), _t(x2), _t(tau))),
        np.asarray(jkd.shot_coeffs(jnp.asarray(x1), jnp.asarray(x2),
                                   jnp.asarray(tau))), rtol=1e-6, atol=1e-5)


def test_shot_feasible_matches_jax():
    rng = np.random.default_rng(2)
    c = None
    while c is None:
        c = jfix.random_search_case(rng)
    dist, origin, res = np.asarray(c[0]), c[1], c[2]
    x1, x2 = _states(512, seed=3)
    x1[:, 2] = np.abs(x1[:, 2]) * 0.5
    x2[:, 2] = np.abs(x2[:, 2]) * 0.5
    td = rng.uniform(0.5, 6.0, 512).astype(np.float32)
    j = jkd.shot_feasible(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(td),
                          jnp.asarray(dist), jnp.asarray(origin, jnp.float32),
                          res, 0.2, n_check=32)
    t = tkd.shot_feasible(_t(x1), _t(x2), _t(td), torch.as_tensor(dist),
                          _t(origin), res, 0.2, n_check=32)
    assert 0 < int(t.sum()) < 512
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def _heuristic_polys(n=4096):
    """The quartic estimate_heuristic solves for 4096 random state pairs,
    and the resolvent cubic quartic_roots solves for it (float32)."""
    x1, x2 = _states(n)
    dp = x2[:, :3] - x1[:, :3]
    v0, v1 = x1[:, 3:], x2[:, 3:]
    f = np.float32
    c1 = f(-36.0) * np.sum(dp * dp, 1)
    c2 = f(24.0) * np.sum((v0 + v1) * dp, 1)
    c3 = f(-4.0) * (np.sum(v0 * v0, 1) + np.sum(v0 * v1, 1)
                    + np.sum(v1 * v1, 1))
    quartic = np.stack([np.full(n, 10.0, f), np.zeros(n, f), c3, c2, c1])
    a3, a2, a1, a0 = quartic[1:] / quartic[0]
    cubic = np.stack([np.ones(n, f), -a2, a1 * a3 - 4 * a0,
                      4 * a2 * a0 - a1 * a1 - a3 * a3 * a0])
    return cubic.astype(f), quartic.astype(f)


@pytest.mark.parametrize("fast", [False, True])
def test_cubic_and_quartic_roots_match_jax(fast):
    """Same NaN/inf pattern, finite roots within rtol 1e-5 (atol 1e-5 m/s
    scale: a cancelled root sits near zero)."""
    cubic, quartic = _heuristic_polys()
    jc = np.asarray(jkd.cubic_roots(*map(jnp.asarray, cubic), fast=fast))
    tc = _np(tkd.cubic_roots(*map(_t, cubic), fast=fast))
    fin = _same_nan_inf(tc, jc)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=1e-5, atol=1e-5)
    jq = np.asarray(jkd.quartic_roots(*map(jnp.asarray, quartic), fast=fast))
    tq = _np(tkd.quartic_roots(*map(_t, quartic), fast=fast))
    fin = _same_nan_inf(tq, jq)
    assert fin.sum() > 4096
    np.testing.assert_allclose(tq[fin], jq[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_estimate_heuristic_matches_jax(fast):
    x1, x2 = _states()
    jcost, jt = jkd.estimate_heuristic(jnp.asarray(x1), jnp.asarray(x2), 10.0,
                                       3.0, fast=fast)
    tcost, tt = tkd.estimate_heuristic(_t(x1), _t(x2), 10.0, 3.0, fast=fast)
    for a, b in ((tcost, jcost), (tt, jt)):
        a, b = _np(a), np.asarray(b)
        fin = _same_nan_inf(a, b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5)


def test_fast_cbrt_matches_jax():
    x = np.concatenate([np.random.default_rng(5).normal(size=1000) * 1e3,
                        [0.0, -0.0, np.nan, 1e-38, -27.0]]).astype(np.float32)
    j = np.asarray(jkd._fast_cbrt(jnp.asarray(x)))
    t = _np(tkd._fast_cbrt(_t(x)))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], rtol=1e-6)


# ------------------------------------------------ predictor and dynamic


def _history(n_obj=3, H=5, seed=6, batch=None):
    rng = np.random.default_rng(seed)
    lead = (n_obj,) if batch is None else (batch, n_obj)
    t = np.sort(rng.uniform(-2.0, 0.0, lead + (H,)), axis=-1)
    p0 = rng.uniform(-4, 4, lead + (1, 3))
    v = rng.uniform(-0.8, 0.8, lead + (1, 3))
    pos = p0 + v * t[..., None] + rng.normal(scale=0.02, size=lead + (H, 3))
    scale = rng.uniform(0.4, 1.2, lead + (3,))
    return (pos.astype(np.float32), t.astype(np.float32),
            scale.astype(np.float32))


def test_fit_const_vel_and_predict_match_jax():
    pos, t, scale = _history()
    jp = jpred.fit_const_vel(jnp.asarray(pos), jnp.asarray(t),
                             jnp.asarray(scale))
    tp = tpred.fit_const_vel(_t(pos), _t(t), _t(scale))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    times = np.linspace(-1.0, 4.0, 11).astype(np.float32).reshape(11, 1)
    np.testing.assert_allclose(
        _np(tpred.predict_position(tp, _t(times))),
        np.asarray(jpred.predict_position(jp, jnp.asarray(times))),
        rtol=1e-6, atol=1e-6)


def test_per_lane_prediction_matches_vmap():
    """Per-lane leaves (B, n_obj, ...) read lane b's polynomials with lane
    b's times, as the JAX package's vmap over lanes does."""
    pos, t, scale = _history(batch=4)
    jp = jax.vmap(jpred.fit_const_vel)(jnp.asarray(pos), jnp.asarray(t),
                                       jnp.asarray(scale))
    tp = tpred.fit_const_vel(_t(pos), _t(t), _t(scale))
    times = np.random.default_rng(7).uniform(0, 3, (4, 6)).astype(np.float32)
    jc = jax.vmap(jpred.predict_position)(jp, jnp.asarray(times))
    np.testing.assert_allclose(_np(tpred.predict_position(tp, _t(times))),
                               np.asarray(jc), rtol=1e-6, atol=1e-6)
    q = np.random.default_rng(8).uniform(-5, 5, (4, 6, 3)).astype(np.float32)
    jd = jax.vmap(jdyn.dist_to_boxes)(jnp.asarray(q), jnp.asarray(times), jp)
    np.testing.assert_allclose(_np(tdyn.dist_to_boxes(_t(q), _t(times), tp)),
                               np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_fit_poly_matches_jax():
    pos, t, scale = _history(H=12)
    valid = np.ones(t.shape, bool)
    valid[0, :3] = False
    for v in (None, valid):
        jp = jpred.fit_poly(jnp.asarray(pos), jnp.asarray(t),
                            jnp.asarray(scale), lam=0.5,
                            valid=None if v is None else jnp.asarray(v))
        tp = tpred.fit_poly(_t(pos), _t(t), _t(scale), lam=0.5,
                            valid=None if v is None else torch.as_tensor(v))
        times = np.linspace(-2.0, 0.0, 7).astype(np.float32)
        np.testing.assert_allclose(
            _np(tpred.predict_position(tp, _t(times))),
            np.asarray(jpred.predict_position(jp, jnp.asarray(times))),
            rtol=1e-4, atol=1e-4)


def test_object_history_and_stack_match_jax():
    rng = np.random.default_rng(9)
    hj = [jpred.ObjHistory(queue_size=6, skip_num=2) for _ in range(2)]
    ht = [tpred.ObjHistory(queue_size=6, skip_num=2) for _ in range(2)]
    for k in range(17):
        for a, b in zip(hj, ht):
            p = rng.uniform(-1, 1, 3)
            assert a.observe(p, 0.1 * k) == b.observe(p, 0.1 * k)
    ht[1].observe((0.0, 0.0, 0.0), 5.0)
    hj[1].observe((0.0, 0.0, 0.0), 5.0)
    for a, b in zip(jpred.stack_histories(hj, [[1, 1, 1]] * 2),
                    tpred.stack_histories(ht, [[1, 1, 1]] * 2,
                                          device="cpu")):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    with pytest.raises(ValueError):
        tpred.stack_histories([tpred.ObjHistory()], [[1, 1, 1]],
                              device="cpu")


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(10)
    c = None
    while c is None:
        c = jfix.random_search_case(rng)
    return np.asarray(c[0]), c[1].astype(np.float32), c[2]


@pytest.mark.parametrize("time", [1.5, -1.0])
def test_dynamic_oracle_matches_jax(field, time):
    dist, origin, res = field
    pos, t, scale = _history(n_obj=2)
    jp = jpred.fit_const_vel(jnp.asarray(pos), jnp.asarray(t),
                             jnp.asarray(scale))
    tp = convert.prediction_from_numpy(*(np.asarray(x) for x in jp),
                                       device="cpu")
    q = np.random.default_rng(11).uniform(
        [-8.5, -8.5, -0.5], [8.5, 8.5, 5.5], (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tdyn.dist_to_boxes(_t(q), time, tp)),
        np.asarray(jdyn.dist_to_boxes(jnp.asarray(q), time, jp)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tdyn.evaluate_coarse(torch.as_tensor(dist), _t(origin), res,
                                 _t(q), time, tp)),
        np.asarray(jdyn.evaluate_coarse(jnp.asarray(dist),
                                        jnp.asarray(origin), res,
                                        jnp.asarray(q), time, jp)),
        rtol=1e-5, atol=1e-5)
    td, tg = tdyn.evaluate_with_grad(torch.as_tensor(dist), _t(origin), res,
                                     _t(q), time, tp)
    jd, jg = jdyn.evaluate_with_grad(jnp.asarray(dist), jnp.asarray(origin),
                                     res, jnp.asarray(q), time, jp)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-5, atol=1e-5)
    empty = tp._replace(poly=tp.poly[:0], scale=tp.scale[:0])
    assert torch.all(tdyn.min_dist_to_boxes(_t(q), time, empty) == 1e7)


# ------------------------------------------------------------- search


def _cases(n=4, seed=17):
    """n random_search_case problems, as tests/test_search.py draws them,
    as numpy batches."""
    rng = np.random.default_rng(seed)
    cases = []
    while len(cases) < n:
        c = jfix.random_search_case(rng)
        if c is not None:
            cases.append(c)
    z = np.zeros(3)
    return (
        np.stack([np.asarray(c[0]) for c in cases]),
        np.stack([c[1] for c in cases]).astype(np.float32), cases[0][2],
        np.stack([np.concatenate([c[3], z]) for c in cases]).astype(
            np.float32),
        np.stack([np.concatenate([c[4], z]) for c in cases]).astype(
            np.float32),
    )


@pytest.fixture(scope="module")
def cases():
    return _cases()


def test_random_search_case_equal():
    """The port's fixture draws the same problems, its EDT bitwise the
    JAX package's."""
    ra, rb = np.random.default_rng(17), np.random.default_rng(17)
    n = 0
    while n < 3:
        a = jfix.random_search_case(ra)
        b = tfix.random_search_case(rb, device="cpu")
        assert (a is None) == (b is None)
        if a is None:
            continue
        np.testing.assert_array_equal(_np(b[0]), np.asarray(a[0]))
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        n += 1


def _dyn_pred(B, seed=12):
    """Two drifting boxes per lane near the y = 0 walls."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((B, 2, 2, 3), np.float32)
    p0 = rng.uniform(-4, 4, (B, 2, 3))
    p0[..., 1] = rng.uniform(-2, 2, (B, 2))
    p0[..., 2] = rng.uniform(1.0, 3.0, (B, 2))
    v0 = rng.uniform(-0.6, 0.6, (B, 2, 3))
    hist[:, :, 0] = p0 - 0.5 * v0
    hist[:, :, 1] = p0
    hist_t = np.broadcast_to(np.array([[-0.5, 0.0]], np.float32), (B, 2, 2))
    scale = np.full((B, 2, 3), 0.8, np.float32)
    return jax.vmap(jpred.fit_const_vel)(jnp.asarray(hist),
                                         jnp.asarray(hist_t.copy()),
                                         jnp.asarray(scale))


def _assert_search_equal(tr, jr, atol=1e-4):
    """reached equal on every lane; knot states within ``atol``; cost rtol
    1e-5."""
    tr = convert.kino_result_to_numpy(tr)
    np.testing.assert_array_equal(tr.reached, np.asarray(jr.reached))
    for name in ("pos", "vel", "acc", "times"):
        np.testing.assert_allclose(getattr(tr, name),
                                   np.asarray(getattr(jr, name)), rtol=0,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tr.cost, np.asarray(jr.cost), rtol=1e-5)


SEARCH_CASES = {
    "static": dict(),
    "dynamic": dict(dynamic=True),
    "exact": dict(dedup="exact"),
    "exact300-fast": dict(dedup="exact300", heu="fast"),
    "shared-map": dict(shared=True),
}
#: the JAX package's other selection and lookup arms, held to 1e-5 m
ARM_CASES = {
    "lex512": dict(dedup="lex512"),
    "approx512": dict(dedup="approx512"),
    "pp64": dict(dedup="pp64"),
    "pp8": dict(dedup="pp8"),
    "parent": dict(dedup="parent"),
    "box": dict(lookup="box"),
    "box-shot-all": dict(lookup="box", shot_topk=16),
    "box-dynamic-shared": dict(lookup="box", dynamic=True, shared=True),
    "box-cells-2": dict(lookup="box", box_cells=2),
}
SEARCH_CASES.update(ARM_CASES)


@pytest.mark.parametrize("case", list(SEARCH_CASES), ids=str)
def test_search_batch_matches_jax(cases, case):
    dists, origins, res, starts, goals = cases
    kw = dict(SEARCH_CASES[case])
    B = len(starts)
    dyn = kw.pop("dynamic", False)
    if kw.pop("shared", False):
        dists = dists[:1]  # one map for every lane
    extra = {}
    if dyn:
        jp = _dyn_pred(B)
        extra = dict(start_times=np.linspace(0, 1, B).astype(np.float32))
    jr = jkd.search_batch(dists, origins, res, starts, goals,
                          obstacle_pred=jp if dyn else None,
                          **dict(dict(lookup="gather"), **kw),
                          beam=16, max_iters=8, **extra)
    tr = tkd.search_batch(
        torch.as_tensor(dists), origins, res, starts, goals,
        obstacle_pred=convert.prediction_from_numpy(
            *(np.asarray(x) for x in jp), device="cpu") if dyn else None,
        beam=16, max_iters=8, **extra, **kw)
    assert tr.pos.shape == (B, 10, 3) and tr.times.shape == (B, 9)
    _assert_search_equal(tr, jr, atol=1e-5 if case in ARM_CASES else 1e-4)


@pytest.mark.parametrize("arm,same_as", [
    (dict(dedup="lex512"), dict(dedup="exact512")),
    (dict(dedup="approx512"), dict(dedup="exact512")),
    (dict(dedup="pp16"), dict(dedup="exact")),
    (dict(lookup="box", shot_topk=16), dict(lookup="gather")),
], ids=["lex-exact", "approx-exact", "pp-beam-exact", "box-gather"])
def test_search_arms_bitwise(cases, arm, same_as):
    """Where the JAX package's tests hold two arms bitwise equal
    (tests/test_search.py: lex<K> and exact<K>; pp<beam> and exact; the
    box lookup sweeping every slot and the gather path; approx<K> off the
    TPU and exact<K>), the port's two arms give the same bits."""
    dists, origins, res, starts, goals = cases
    a, b = (tkd.search_batch(torch.as_tensor(dists), origins, res, starts,
                             goals, beam=16, max_iters=8, **kw)
            for kw in (arm, same_as))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_search_box_defaults_as_jax():
    """The box path's defaults: the half-width covers one primitive's reach
    (default_box_cells) and the one-shot sweeps min(8, beam) slots."""
    for args in ((3.0, 2.0, 0.5, 0.2), (3.0, 2.0, 0.5, 0.1),
                 (1.5, 1.0, 1.0, 0.5)):
        assert tkd.default_box_cells(*args) == jkd.default_box_cells(*args)
    with pytest.raises(ValueError):
        tkd._dedup_arm("lexx", 16)
    with pytest.raises(ValueError):
        tkd._dedup_arm("pp8x", 16)
    assert tkd._dedup_arm("pp", 16) == ("pp", 8)
    assert tkd._dedup_arm("approx", 16) == ("approx", 512)
    assert tkd._dedup_arm("lex", 16) == ("lex", 256)
    assert tkd._dedup_arm("parent", 16) == ("parent", 0)


def test_search_single_equals_batch_lane(cases):
    dists, origins, res, starts, goals = cases
    r = tkd.search(torch.as_tensor(dists[2]), origins[2], res, starts[2],
                   goals[2], beam=16, max_iters=8)
    jr = jkd.search(dists[2], jnp.asarray(origins[2]), res, starts[2],
                    goals[2], lookup="gather", beam=16, max_iters=8)
    assert r.pos.shape == (10, 3)
    _assert_search_equal(tkd.KinoResult(*(x[None] for x in r)),
                         jkd.KinoResult(*(np.asarray(x)[None] for x in jr)))


def test_search_adaptive_matches_jax(cases):
    """One mission at a time through the retry ladder, from a starved base
    beam: the retries used and the result equal the JAX package's."""
    dists, origins, res, starts, goals = cases
    kw = dict(retries=2, beam=2, max_iters=3)
    used = []
    for b in range(len(starts)):
        jr, ju = jkd.search_adaptive(dists[b], jnp.asarray(origins[b]), res,
                                     starts[b], goals[b], lookup="gather",
                                     **kw)
        tr, tu = tkd.search_adaptive(torch.as_tensor(dists[b]), origins[b],
                                     res, starts[b], goals[b], **kw)
        assert tu == ju
        used.append(tu)
        _assert_search_equal(
            tkd.KinoResult(*(x[None] for x in tr)),
            jkd.KinoResult(*(np.asarray(x)[None] for x in jr)))
    assert max(used) > 0


def test_search_batch_adaptive_matches_jax(cases):
    """A starved base beam, so the ladder runs: n_retried, used and reached
    equal, and the merged knots equal."""
    dists, origins, res, starts, goals = cases
    kw = dict(retries=2, beam=2, max_iters=3)
    jr, jn, ju = jkd.search_batch_adaptive(dists, origins, res, starts, goals,
                                           lookup="gather", **kw)
    tr, tn, tu = tkd.search_batch_adaptive(torch.as_tensor(dists), origins,
                                           res, starts, goals, **kw)
    assert jn > 0
    assert (tn, tu) == (jn, ju)
    _assert_search_equal(tr, jr)


def test_resample_knots_batch_matches_jax(cases):
    """Short branches (uniform time), long branches (knot snapping, with
    .5 roundings of linspace * r) and zero-duration prefixes."""
    dists, origins, res, starts, goals = cases
    r = jkd.search_batch(dists, origins, res, starts, goals, lookup="gather",
                         beam=16, max_iters=8)
    branches = [tuple(np.asarray(x) for x in r[:4])]
    rng = np.random.default_rng(13)
    K = 9
    t = rng.uniform(0.1, 0.6, (6, K)).astype(np.float32)
    t[0, :4] = 0.0   # zero-duration prefix, r = 5 < n - 1
    t[1, :2] = 0.0   # r = 7
    t[2, :1] = 0.0   # r = 8
    t[3, :] = 0.25   # r = 9
    t[4, :7] = 0.0   # r = 2
    p = rng.uniform(-3, 3, (6, K + 1, 3)).astype(np.float32)
    v = rng.uniform(-2, 2, (6, K + 1, 3)).astype(np.float32)
    branches.append((p, v, np.zeros_like(v), t))
    for n in (6, 7, 9):  # r = 5 at n = 9 (linspace * 5 hits .5 at 1/8..)
        for pos, vel, acc, times in branches:
            j = jkd.resample_knots_batch(pos, vel, acc, times, n)
            tt = tkd.resample_knots_batch(*(torch.as_tensor(x) for x in (
                pos, vel, acc, times)), n)
            for name, a, b in zip(("pos", "vel", "acc", "times"), tt, j):
                b = np.asarray(b)
                np.testing.assert_allclose(
                    _np(a), b, rtol=1e-5,
                    atol=1e-5 * max(1.0, float(np.abs(b).max())),
                    err_msg=f"{name} n={n}")


@pytest.mark.parametrize("mode", ["search", "stretch", "mean_v",
                                  "pontryagin"])
def test_retime_knots_matches_jax(mode):
    rng = np.random.default_rng(14)
    pos = rng.uniform(-4, 4, (8, 3))
    vel = rng.uniform(-2, 2, (8, 3))
    times = rng.uniform(0.2, 1.0, 7)
    a = tkd.retime_knots(pos, vel, times, mode=mode, stretch=1.3)
    b = jkd.retime_knots(pos, vel, times, mode=mode, stretch=1.3)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    with pytest.raises(ValueError):
        tkd.retime_knots(pos, vel, times, mode="bogus")


def test_free_end_vel_shot_matches_jax():
    rng = np.random.default_rng(15)
    p0 = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    p1 = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    v0 = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    v0[:16] = 0.0      # from rest: the linear root
    p1[16:24] = p0[16:24]  # dp = 0: the fallback duration
    v0[24:40] *= 5.0   # end-velocity stretch triggers
    jo = jkd.free_end_vel_shot(jnp.asarray(p0), jnp.asarray(p1),
                               jnp.asarray(v0))
    to = tkd.free_end_vel_shot(_t(p0), _t(p1), _t(v0))
    for a, b in zip(to, jo):
        b = np.asarray(b)
        fin = _same_nan_inf(_np(a), b)
        np.testing.assert_allclose(_np(a)[fin], b[fin], rtol=1e-6, atol=1e-6)


def test_knot_count_alignment_front_pads():
    a = tkd.KinoResult(pos=torch.arange(12.0).reshape(2, 2, 3),
                       vel=torch.ones(2, 2, 3), acc=torch.zeros(2, 2, 3),
                       times=torch.ones(2, 1),
                       reached=torch.ones(2, dtype=torch.bool),
                       cost=torch.zeros(2))
    b = a._replace(pos=torch.zeros(2, 4, 3), vel=torch.zeros(2, 4, 3),
                   acc=torch.zeros(2, 4, 3), times=torch.ones(2, 3))
    a2, b2 = tkd._align_knot_counts(a, b)
    assert b2 is b and a2.pos.shape == (2, 4, 3)
    assert torch.equal(a2.pos[:, :3], a.pos[:, :1].expand(2, 3, 3))
    assert torch.equal(a2.times, torch.tensor([[0.0, 0.0, 1.0]] * 2))
    j2, _ = jkd._align_knot_counts(
        jkd.KinoResult(*(jnp.asarray(_np(x)) for x in a)),
        jkd.KinoResult(*(jnp.asarray(_np(x)) for x in b)))
    for x, y in zip(a2, j2):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    assert [tkd._retry_bucket(n) for n in (1, 32, 33, 200)] == [
        jkd._retry_bucket(n) for n in (1, 32, 33, 200)]


def test_primitive_set_and_result_fields_equal():
    np.testing.assert_array_equal(tkd._primitive_set(2.0, 5),
                                  jkd._primitive_set(2.0, 5))
    assert tpred.ObjPrediction._fields == jpred.ObjPrediction._fields
    assert tkd.KinoResult._fields == jkd.KinoResult._fields
