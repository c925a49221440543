"""PyTorch port, distance fields: rasterize / EDT (kernel K1's plain
version) and the trilinear lookup (kernel K2's plain version) against the
JAX package, including its Pallas kernels in interpret mode.

The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py
and chip_smoke.py); here every wrapper takes its plain version because
the tensors lie on the CPU, which the call counters confirm.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu import fixtures as jfix  # noqa: E402
from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402
from grad_traj_optimization_tpu.ops import edt_pallas  # noqa: E402
from grad_traj_optimization_tpu.ops import trilinear_pallas  # noqa: E402

from grad_traj_optimization_torch.config import MapConfig  # noqa: E402
from grad_traj_optimization_torch.fields import sdf as tsdf  # noqa: E402
from grad_traj_optimization_torch.ops import edt_cuda  # noqa: E402
from grad_traj_optimization_torch.ops import trilinear_cuda  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

#: the bench map's 20 x 20 m footprint at 0.5 m: a 40 x 40 x 16 grid
MAP = MapConfig(origin=(-10.0, -10.0, 0.0), resolution=0.5,
                map_size=(20.0, 20.0, 8.0))
B = 4


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def scenes():
    """B random bench-style maps: obstacle points, occupancy and EDT from
    both packages (the JAX side on its jnp backend)."""
    _, pts, valid, _ = jfix.random_scenarios(
        B, seed=21, map_cfg=MAP, max_obstacle_points=2048
    )
    origin = np.asarray(MAP.origin, np.float32)
    jocc = jax.vmap(
        lambda p, v: jsdf.rasterize(p, jnp.asarray(origin), MAP.resolution,
                                    MAP.grid_shape, valid_mask=v)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(valid))
    jdist = jsdf.edt_batch(jocc, MAP.resolution, backend="jnp")
    tocc = tsdf.rasterize(torch.as_tensor(pts, dtype=torch.float32),
                          torch.as_tensor(origin), MAP.resolution,
                          MAP.grid_shape, valid_mask=torch.as_tensor(valid))
    return dict(pts=pts, valid=valid, origin=origin, jocc=np.asarray(jocc),
                jdist=np.asarray(jdist), tocc=tocc)


def test_rasterize_matches_jax_bitwise(scenes):
    np.testing.assert_array_equal(_np(scenes["tocc"]), scenes["jocc"])
    assert scenes["jocc"].sum() > 100  # the maps have obstacles


def test_rasterize_single_grid_and_mask():
    pts = np.random.default_rng(3).uniform(-11, 11, size=(500, 3))
    pts[:, 2] = np.abs(pts[:, 2]) % 8.0
    mask = np.random.default_rng(4).random(500) < 0.7
    origin = np.asarray(MAP.origin, np.float32)
    j = jsdf.rasterize(jnp.asarray(pts, jnp.float32), jnp.asarray(origin),
                       MAP.resolution, MAP.grid_shape,
                       valid_mask=jnp.asarray(mask))
    t = tsdf.rasterize(torch.as_tensor(pts, dtype=torch.float32),
                       torch.as_tensor(origin), MAP.resolution,
                       MAP.grid_shape, valid_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_edt_batch_matches_jax_bitwise(scenes):
    before = profiling.counter("plain.minplus_lines")
    dist = tsdf.edt_batch(scenes["tocc"], MAP.resolution)
    # CPU tensors: both min-plus passes took the plain version
    assert profiling.counter("plain.minplus_lines") == before + 2
    np.testing.assert_array_equal(_np(dist), scenes["jdist"])


def test_edt_single_matches_jax_bitwise(scenes):
    occ = scenes["jocc"][1]
    j = jsdf.edt(jnp.asarray(occ), MAP.resolution, backend="jnp")
    t = tsdf.edt(torch.tensor(occ), MAP.resolution)
    np.testing.assert_array_equal(_np(t), np.asarray(j))
    prev = np.asarray(j) * 0.5 + 0.1
    j2 = jsdf.edt(jnp.asarray(occ), MAP.resolution,
                  prev_dist=jnp.asarray(prev), backend="jnp")
    t2 = tsdf.edt(torch.tensor(occ), MAP.resolution,
                  prev_dist=torch.as_tensor(prev))
    np.testing.assert_array_equal(_np(t2), np.asarray(j2))


def test_edt_matches_brute_force():
    occ = (np.random.default_rng(5).random((9, 8, 7)) < 0.05).astype(
        np.float32)
    occ[0, 0, 0] = 1.0
    ref = jsdf.edt_brute_force(jnp.asarray(occ), 0.3)
    np.testing.assert_allclose(_np(tsdf.edt(torch.as_tensor(occ), 0.3)),
                               np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_nearest_sq_1d_matches_jax(scenes, dim):
    occ = scenes["jocc"][0]
    np.testing.assert_array_equal(
        _np(tsdf._nearest_sq_1d(torch.as_tensor(occ), dim)),
        np.asarray(jsdf._nearest_sq_1d(jnp.asarray(occ), dim)),
    )


@pytest.mark.parametrize("n", [16, 40, 100])
def test_minplus_plain_matches_pallas_interpret_bitwise(n):
    """K1's plain version against the TPU kernel (interpret mode) on the
    values the EDT feeds it: squared cell counts up to BIG_CELLS^2."""
    rng = np.random.default_rng(n)
    f = rng.integers(0, 40, size=(37, n)).astype(np.float32) ** 2
    f[rng.random(f.shape) < 0.3] = jsdf.BIG_CELLS ** 2
    f[3] = jsdf.BIG_CELLS ** 2  # a line with no obstacle at all
    out = edt_cuda.minplus_lines(torch.as_tensor(f))
    ref = edt_pallas.minplus_lines(jnp.asarray(f), interpret=True)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    np.testing.assert_array_equal(
        _np(out), np.asarray(jsdf._minplus_parabola_lines(jnp.asarray(f))))


@pytest.mark.parametrize("dim", [-2, -3], ids=["y", "x"])
@pytest.mark.parametrize("shape", [(2, 16, 20, 6), (3, 7, 9, 5)])
def test_minplus_along_matches_jax_bitwise(shape, dim):
    """minplus_along on a CPU grid (the plain path, overwriting its input)
    against the JAX package's jnp pass and its TPU kernel in interpret
    mode, on seeded squared cell counts up to BIG_CELLS^2, bitwise."""
    rng = np.random.default_rng(sum(shape) + dim)
    f = rng.integers(0, 40, size=shape).astype(np.float32) ** 2
    f[rng.random(shape) < 0.3] = jsdf.BIG_CELLS ** 2
    t = torch.as_tensor(f.copy())
    before = profiling.counter("plain.minplus_lines")
    out = edt_cuda.minplus_along(t, dim)
    assert profiling.counter("plain.minplus_lines") == before + 1
    assert out.data_ptr() == t.data_ptr()  # in place
    np.testing.assert_array_equal(
        _np(out), np.asarray(jsdf._minplus_axis(jnp.asarray(f), dim)))
    np.testing.assert_array_equal(
        _np(out), np.asarray(edt_pallas.minplus_axis(jnp.asarray(f), dim,
                                                     interpret=True)))


def test_minplus_plain_long_lines_match_jax_bitwise():
    """Past 4096 cells (q - v)^2 rounds in float32: the plain version
    rounds the square and then the sum, as the JAX package's dense pass,
    bitwise at n = 5000 (the long-line kernel's reference on the card).
    Lines: random reals; one lone source at an end (every output a
    rounded square, and with 0.5 or 0.3 added one where a single rounding
    of the sum, an FMA's, would part from two); squared cell counts as the
    EDT feeds it."""
    n = 5000
    rng = np.random.default_rng(n)
    f = np.full((5, n), jsdf.BIG_CELLS ** 2, np.float32)
    f[0] = rng.random(n).astype(np.float32) * 3e7
    f[1, 0] = 0.0
    f[2, 0] = 0.5
    f[3, n - 1] = 0.3
    keep = rng.random(n) < 0.002
    f[4, keep] = rng.integers(0, 40, keep.sum()).astype(np.float32) ** 2
    out = edt_cuda.minplus_lines(torch.as_tensor(f))
    ref = np.asarray(jsdf._minplus_parabola_lines(jnp.asarray(f)))
    np.testing.assert_array_equal(_np(out).view(np.int32),
                                  ref.view(np.int32))
    # the rounding is there: q^2 is not exact past 4096, and one rounding
    # of q^2 + 0.5 is not two
    assert float(_np(out)[1, 4097]) != 4097.0 ** 2
    once = (np.arange(n, dtype=np.float64) ** 2 + 0.5).astype(np.float32)
    assert (_np(out)[2] != once).any()


def test_edt_long_grid_matches_jax_bitwise():
    """sdf.edt of a 5000 x 4 x 3 grid (a 1 km corridor at 0.2 m): the x
    pass runs lines of 5000 cells; bitwise the JAX package's field.  The
    first 4200 cells are free, so the cells near x = 0 lie more than 4096
    cells from every obstacle, where the squares round."""
    rng = np.random.default_rng(53)
    occ = (rng.random((5000, 4, 3)) < 0.01).astype(np.float32)
    occ[:4200] = 0.0
    got = tsdf.edt(torch.as_tensor(occ), 0.2)
    want = np.asarray(jsdf.edt(jnp.asarray(occ), 0.2, backend="jnp"))
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  want.view(np.int32))


def test_minplus_plain_chunking_is_exact():
    f = np.random.default_rng(6).random((50, 24)).astype(np.float32) * 100
    whole = edt_cuda.minplus_lines_plain(torch.as_tensor(f))
    chunked = edt_cuda.minplus_lines_plain(torch.as_tensor(f),
                                           chunk_bytes=4 * 24 * 24 * 7)
    torch.testing.assert_close(whole, chunked, rtol=0, atol=0)


# ----------------------------------------------------------- trilinear


def _queries(rng, batch, s):
    """Interior, face-straddling (clamped corners) and out-of-map points
    of the 40 x 40 x 16 map."""
    lo = np.asarray(MAP.origin)
    hi = lo + np.asarray(MAP.map_size)
    interior = rng.uniform(lo + 0.3, hi - 0.3, size=(batch, s - 30, 3))
    edges = rng.uniform(lo - 0.4, hi + 0.4, size=(batch, 20, 3))
    oob = rng.uniform(hi + 1.0, hi + 4.0, size=(batch, 10, 3))
    return np.concatenate([interior, edges, oob], axis=1).astype(np.float32)


def test_trilinear_flat_matches_jax(scenes):
    """f32 lookup against the JAX f32 path: atol 1e-5 m on d, 1e-5 / res
    on g (same blend order; XLA may contract a multiply-add)."""
    rng = np.random.default_rng(7)
    pos = _queries(rng, B, 120)
    dist = scenes["jdist"]
    nvox = dist[0].size
    jd, jg = jax.vmap(
        lambda b, p: jsdf.trilinear_flat(
            jnp.asarray(dist).reshape(-1), b, MAP.grid_shape,
            jnp.asarray(scenes["origin"]), MAP.resolution, p)
    )(jnp.arange(B, dtype=jnp.int32) * nvox, jnp.asarray(pos))
    before = profiling.counter("plain.trilinear_batch")
    td, tg = trilinear_cuda.trilinear_batch(
        torch.as_tensor(dist), torch.as_tensor(scenes["origin"]).expand(B, 3),
        torch.full((B,), MAP.resolution), torch.as_tensor(pos))
    assert profiling.counter("plain.trilinear_batch") == before + 1
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=0,
                               atol=1e-5 / MAP.resolution)
    assert np.all(_np(td)[:, -10:] == -1.0)
    assert np.all(_np(tg)[:, -10:] == 0.0)


def test_trilinear_shared_grid_equals_broadcast(scenes):
    rng = np.random.default_rng(8)
    pos = torch.as_tensor(_queries(rng, B, 60))
    grid = torch.as_tensor(scenes["jdist"][2])
    org = torch.as_tensor(scenes["origin"]).expand(B, 3)
    res = torch.full((B,), MAP.resolution)
    d1, g1 = trilinear_cuda.trilinear_batch(grid[None], org, res, pos)
    d2, g2 = trilinear_cuda.trilinear_batch(
        grid.expand(B, *grid.shape).contiguous(), org, res, pos)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)


def test_trilinear_matches_fused_pallas_interpret(scenes):
    """Against the TPU kernel (interpret mode), which reads bf16 hi/mid
    planes of the grid: within that split's bound, 6e-5 m per corner
    value for d < 16 m (trilinear_pallas.PLANES), so 6e-5 m on d and
    2 * 6e-5 / res on g (a difference of two corner values over res)."""
    rng = np.random.default_rng(9)
    pos = _queries(rng, B, 180)
    grids = jnp.asarray(scenes["jdist"])
    org = jnp.broadcast_to(jnp.asarray(scenes["origin"]), (B, 3))
    ress = jnp.full((B,), MAP.resolution, jnp.float32)
    kd, kg = trilinear_pallas.trilinear_fused_batch(
        grids, org, ress, jnp.asarray(pos), interpret=True)
    td, tg = trilinear_cuda.trilinear_batch(
        torch.as_tensor(scenes["jdist"]),
        torch.as_tensor(scenes["origin"]).expand(B, 3),
        torch.full((B,), MAP.resolution), torch.as_tensor(pos))
    near = np.asarray(kd) < 16.0
    assert near.mean() > 0.9
    np.testing.assert_allclose(_np(td)[near], np.asarray(kd)[near], rtol=0,
                               atol=6e-5)
    np.testing.assert_allclose(_np(tg)[near], np.asarray(kg)[near], rtol=0,
                               atol=2 * 6e-5 / MAP.resolution)


def test_distance_at_and_gradient_match_jax(scenes):
    dist = scenes["jdist"][0]
    pos = _queries(np.random.default_rng(10), 1, 80)[0]
    org = scenes["origin"]
    np.testing.assert_array_equal(
        _np(tsdf.distance_at(torch.as_tensor(dist), torch.as_tensor(org),
                             MAP.resolution, torch.as_tensor(pos))),
        np.asarray(jsdf.distance_at(jnp.asarray(dist), jnp.asarray(org),
                                    MAP.resolution, jnp.asarray(pos))),
    )
    td, tg = tsdf.distance_and_gradient(torch.as_tensor(dist),
                                        torch.as_tensor(org),
                                        MAP.resolution, torch.as_tensor(pos))
    jd, jg = jsdf.distance_and_gradient(jnp.asarray(dist), jnp.asarray(org),
                                        MAP.resolution, jnp.asarray(pos))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=0, atol=2e-5)


def test_trilinear_mxu_matches_jax(scenes):
    """sdf.trilinear_mxu (the gathers) against the JAX package's one-hot
    contractions: d within 2e-5 m and g within 2e-4, the bounds the JAX
    package's own tests hold its contraction to against its gathers
    (tests/test_sdf.py); out of map exactly (-1, 0)."""
    dist = scenes["jdist"][1]
    pos = _queries(np.random.default_rng(14), 1, 120)[0]
    org = scenes["origin"]
    td, tg = tsdf.trilinear_mxu(torch.as_tensor(dist), torch.as_tensor(org),
                                MAP.resolution, torch.as_tensor(pos))
    jd, jg = jsdf.trilinear_mxu(jnp.asarray(dist), jnp.asarray(org),
                                MAP.resolution, jnp.asarray(pos))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=0, atol=2e-4)
    out = np.asarray(jd) == -1.0
    assert out.any()
    np.testing.assert_array_equal(_np(td)[out], -1.0)
    np.testing.assert_array_equal(_np(tg)[out], 0.0)


def test_in_map_and_pos_to_index_match_jax():
    pos = _queries(np.random.default_rng(12), 1, 200)[0]
    org = np.asarray(MAP.origin, np.float32)
    np.testing.assert_array_equal(
        _np(tsdf.in_map(torch.as_tensor(pos), torch.as_tensor(org),
                        MAP.resolution, MAP.grid_shape)),
        np.asarray(jsdf.in_map(jnp.asarray(pos), jnp.asarray(org),
                               MAP.resolution, MAP.grid_shape)),
    )
    np.testing.assert_array_equal(
        _np(tsdf.pos_to_index(torch.as_tensor(pos), torch.as_tensor(org),
                              MAP.resolution)),
        np.asarray(jsdf.pos_to_index(jnp.asarray(pos), jnp.asarray(org),
                                     MAP.resolution)),
    )
