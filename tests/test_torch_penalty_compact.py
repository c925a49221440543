"""The penalty's gradient through each segment's Hermite basis
(``penalty._back_project``) against the dense chains ``TL``/``TVL``/``TAL``
it replaced.

The compact form is the same linear map with its structural zeros
skipped: a sample's row of ``TL`` is its Hermite basis ``H`` scattered
into the 3m-3 free derivatives, non-zero only at its segment's two knots.
So the two forms differ only in the order of their sums (over m·K
samples against over K and one add), and agree to 1e-5 of the
gradient's scale in float32 and 1e-10 in float64.  The dense form is
written here, as the penalty had it, over the chains ``build_ctx`` keeps
for K3's inputs.

On the card (marked ``cuda``; skips with a reason where no GPU is
visible): two runs of a 64-lane, 51-waypoint ``solve_batch_fused`` on the
opti_node map are equal in every bit.  Run it from the repository root
with

    python -m pytest --noconftest -m cuda tests/test_torch_penalty_compact.py

This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grad_traj_optimization_torch import fixtures, solver  # noqa: E402
from grad_traj_optimization_torch.config import (  # noqa: E402
    OPTI_NODE_CONFIG, OptimizerConfig,
)
from grad_traj_optimization_torch.core import qp  # noqa: E402
from grad_traj_optimization_torch.fields import sdf  # noqa: E402
from grad_traj_optimization_torch.ops import trilinear_cuda  # noqa: E402
from grad_traj_optimization_torch.opt import descent, penalty  # noqa: E402

#: a 12 x 12 x 5 m map at 0.5 m, origin (-6, -6, 0)
GRID, RES, ORIGIN = (24, 24, 10), 0.5, (-6.0, -6.0, 0.0)
LANES = 3
VA = {"off": {}, "v": dict(alpha_v=0.3),
      "va": dict(alpha_v=0.3, alpha_a=0.2)}


def _field(n_maps: int, seed: int):
    """(n_maps, *GRID) distances to a few balls: smooth, with samples on
    both sides of d0 so every collision weight is live."""
    rng = np.random.default_rng(seed)
    axes = [ORIGIN[i] + RES * np.arange(GRID[i]) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    maps = []
    for _ in range(n_maps):
        c = rng.uniform([-4, -4, 1], [4, 4, 4], (4, 3))
        r = rng.uniform(0.3, 1.0, 4)
        d = np.linalg.norm(pts[..., None, :] - c, axis=-1) - r
        maps.append(np.clip(d.min(-1), 0.0, None))
    return np.stack(maps)


def _problem(m: int, shared: bool, dtype, cfg: OptimizerConfig):
    """LANES routes of m segments of 0.5-0.9 m across the map, a
    perturbed straight seed, and the batch context, in ``dtype`` on the
    CPU."""
    rng = np.random.default_rng(100 + m)
    step = rng.normal(size=(LANES, m + 1, 3))
    step *= rng.uniform(0.5, 0.9, (LANES, m + 1, 1)) / np.linalg.norm(
        step, axis=-1, keepdims=True)
    wp = np.cumsum(step, axis=1)
    wp = wp - wp.mean(axis=1, keepdims=True) + np.array([0.0, 0.0, 2.5])
    like = dict(dtype=dtype)
    wp = torch.as_tensor(wp, **like)
    T = qp.allocate_times(wp, cfg.mean_v, cfg.init_time)
    Df, dp = qp.straight_line_d(wp)
    dp = dp + torch.as_tensor(rng.normal(scale=0.05, size=dp.shape), **like)
    grids = torch.as_tensor(_field(1 if shared else LANES, m), **like)
    origin = torch.as_tensor(ORIGIN, **like).expand(LANES, 3).contiguous()
    res = torch.full((LANES,), RES, **like)
    return dp, penalty.build_ctx_batch(T, Df, cfg), (grids, origin, res)


def _dense_grad(dp, bctx, grids, origin, res, cfg: OptimizerConfig, step):
    """The penalty's gradient as the dense chains gave it: each weight
    contracted with ``TL``/``TVL``/``TAL`` over every segment and sample."""
    ws = 0.0 if step == 1 else cfg.w_smooth
    _, grad_s = penalty._smooth(dp, bctx)
    d6, pos, vel = penalty._sample_state(dp, bctx)
    B, m, K = pos.shape[:3]
    d, g = trilinear_cuda.trilinear_batch_plain(
        grids, origin, res, pos.reshape(B, m * K, 3).contiguous())
    d, g = d.reshape(B, m, K), g.reshape(B, m, K, 3)
    cd, gd, vn = penalty._collision_terms(d, vel, cfg)
    ref = cfg.gradient_mode == "reference"
    w_dist = gd * cd * vn if ref else gd * vn
    w1 = w_dist[..., None] * g
    w2 = (cd / vn)[..., None] * vel

    def chain(w, c):
        return torch.einsum("...mkx,...mkd,...m->...xd", w, c, bctx.dt)

    grad = ws * grad_s + cfg.w_collision * (chain(w1, bctx.TL)
                                            + chain(w2, bctx.TVL))
    if step == 2 and (cfg.alpha_v != 0.0 or cfg.alpha_a != 0.0):
        acc = (torch.einsum("...mkb,...xmb->...mkx", bctx.HA, d6)
               if cfg.alpha_a != 0.0 else None)
        _, _, w_tvl, w_tal = penalty._va_weights(vel, acc, vn, cfg)
        grad = grad + chain(w_tvl, bctx.TVL)
        if cfg.alpha_a != 0.0:
            grad = grad + chain(w_tal, bctx.TAL)
    return grad + cfg.grad_eps if ref else grad


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
@pytest.mark.parametrize("mode", ["reference", "exact"])
@pytest.mark.parametrize("va", list(VA))
@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("m", [2, 3, 7, 50])
def test_compact_gradient_matches_the_dense_chains(m, step, va, mode,
                                                   shared):
    """cost_and_grad_batch's gradient against the dense contraction from
    the same build_ctx: only the summation order differs, so 1e-5 of the
    gradient's largest entry in float32 and 1e-10 in float64."""
    cfg = dataclasses.replace(OptimizerConfig(gradient_mode=mode),
                              **VA[va])
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-10)):
        dp, bctx, maps = _problem(m, shared, dtype, cfg)
        _, got = penalty.cost_and_grad_batch(dp, bctx, *maps, cfg, step)
        want = _dense_grad(dp, bctx, *maps, cfg, step)
        assert got.shape == want.shape == (LANES, 3, 3 * m - 3)
        assert got.dtype == dtype
        scale = float(want.abs().max())
        assert scale > 0.0
        torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("va", ["off", "va"])
def test_per_iteration_path_reads_no_dense_chain(va):
    """With TL, TVL and TAL dropped after build_ctx, cost_and_grad_batch
    and a 5-iteration minimize_batch run and give the same bits as with
    them present: the descent never reads the dense chains."""
    cfg = dataclasses.replace(OptimizerConfig(), **VA[va])
    dp, bctx, maps = _problem(7, False, torch.float32, cfg)
    lb, ub = dp - 1.0, dp + 1.0
    runs = []
    for drop in (False, True):
        ctx = penalty.build_ctx_batch(bctx.T, bctx.Df, cfg)
        if drop:
            ctx.TL = ctx.TVL = ctx.TAL = None

        def cag(x, ctx=ctx):
            return penalty.cost_and_grad_batch(x, ctx, *maps, cfg, 2)

        res = descent.minimize_batch(cag, dp, lb, ub, 5, cfg,
                                     record_trace=True)
        runs.append((*cag(dp), *res))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc; none is visible")
    return torch.device("cuda:0")


def _fleet_routes(wp: np.ndarray, lanes: int, cuts: int, seed: int):
    """(lanes, (len(wp) - 1) * cuts + 1, 3) float32: ``wp`` shifted within
    +-0.3 m in x and y per lane, then each segment cut into ``cuts``."""
    rng = np.random.default_rng(seed)
    shift = np.zeros((lanes,) + wp.shape)
    shift[..., :2] = rng.uniform(-0.3, 0.3, (lanes, len(wp), 2))
    w = wp + shift
    f = np.arange(cuts)[:, None] / cuts
    inner = w[:, :-1, None] + f * (w[:, 1:, None] - w[:, :-1, None])
    return np.concatenate([inner.reshape(lanes, -1, 3), w[:, -1:]],
                          1).astype(np.float32)


@pytest.mark.cuda
def test_fleet_descent_bitwise_run_to_run(dev):
    """Two runs of a 64-lane, 51-waypoint solve_batch_fused (num_dp 147,
    the per-iteration descent: K2 an evaluation, the gradient by the
    segments' batched products) on the opti_node map are torch.equal."""
    mc, obss, wp = fixtures.opti_node_scenario()
    f32 = dict(dtype=torch.float32, device=dev)
    origin = torch.as_tensor(mc.origin, **f32)
    field = sdf.edt(sdf.rasterize(torch.as_tensor(obss, **f32), origin,
                                  mc.resolution, mc.grid_shape),
                    mc.resolution)
    routes = torch.as_tensor(_fleet_routes(np.asarray(wp), 64, 5, 7),
                             device=dev)
    assert routes.shape == (64, 51, 3)
    scn = solver.Scenario(
        dist=field[None], origin=origin.expand(64, 3).contiguous(),
        resolution=torch.full((64,), mc.resolution, **f32), waypoints=routes)
    assert not solver.takes_k3(scn, OPTI_NODE_CONFIG)
    a, b = (solver.solve_batch_fused(scn, cfg=OPTI_NODE_CONFIG,
                                     record_trace=True) for _ in range(2))
    assert int((a.status == 0).sum()) == 64
    for x, y in zip(a, b):
        assert torch.equal(x, y)
