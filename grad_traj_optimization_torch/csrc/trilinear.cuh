// K2 core: trilinear distance + analytic gradient of one query point.
//
// Replaces the lookup of grad_traj_optimization_tpu/ops/trilinear_pallas.py
// (lookup_core, run by _kernel and by solve_pallas._lookup).  The TPU
// kernel contracts one-hot corner rows against bf16 hi/mid planes of the
// grid on the MXU because gathers are slow there; on this card a gather
// is a load, so this is the f32 eight-corner form of
// fields/sdf.trilinear_flat (reference getDistWithGradTrilinear,
// sdf_map.cpp:185-242):
//   * in-map test with 1e-4 margins on every face; out of map gives
//     d = -1 and a zero gradient (sdf_map.cpp:187);
//   * the query shifts by -res/2 before indexing; corner indices clamp
//     to the grid (sdf_map.cpp:166-174);
//   * blends x, then y, then z (sdf_map.cpp:221-229).
// The exact-crop frame (solve_pallas._lookup :109-170, solver.crop_scenarios):
// the grid may be the [off, off + n) cell window of a map of `full` cells
// whose origin is unchanged.  The index and fraction arithmetic stays
// global; the in-map test becomes the window test (1e-4 on a true map
// face, res/2 on an interior crop face, bounds o + off res + m and
// o + (off + n) res - m), and the corners clamp to the map and then index
// the window: one clamp of the window-local index, as the window lies in
// the map.  An in-window lookup is then bitwise the full map's.  Offset 0
// with full = n is the uncropped lookup, bit for bit.
// Every operation is an explicitly rounded intrinsic (__fmul_rn and
// friends, which the compiler never contracts into an FMA) in the plain
// version's order, and every division by res gives the correctly rounded
// quotient, so the result is bitwise the plain PyTorch version's.
//
// What a lookup costs.  Inside K3 it runs for every sample of every
// evaluation (18.6 M lookups per bench launch), at four warps a
// scheduler, so its instruction count and its load latency are what
// matter.  Two measures:
//   * GtoFrame holds what depends only on the scenario (the six in-map
//     bounds, res/2, 1/res, the strides), built once per block by
//     gto_make_frame with the same rounded operations the per-point test
//     used, so the same bits;
//   * the nine divisions by res are gto_div_fast, three instructions from
//     the frame's reciprocal instead of div.rn's sequence with its range
//     test and slow path.  It is exact where every dividend is 0 or has
//     |a| in [2^-100, 2^100], which GtoDivGuard checks for the nine
//     together without a branch; a lookup that fails the check (never, at
//     the lookup's metres, cell fractions and distance differences up to
//     10^4) is run again with __fdiv_rn.  gto_div_check (trilinear.cu)
//     holds gto_div, the same pieces for one dividend, against __fdiv_rn
//     over all 2^32 bit patterns on the card.
// One check a lookup, not a branch to __fdiv_rn at each division: nine
// such branches split the lookup into blocks the compiler cannot
// schedule across, and cost K3 more than the divisions did.
// The eight corner loads stay four rows of the (x, y, z)-major grid, at
// least 4 sectors of 32 B a point: a grid is 1 MB at bench shape and 4 MB
// at the opti_node map, far above a block's shared memory, so the
// corners come through L1/L2.
#pragma once

#include <cuda_runtime.h>

// One scenario's lookup frame.
struct GtoFrame {
  float ox, oy, oz;     // origin (of the full map)
  float res, half, rcp;  // resolution, res / 2, RN(1 / res)
  float lox, loy, loz;  // in the window iff lo < p < hi on every axis
  float hix, hiy, hiz;
  int offx, offy, offz;  // the window's first cell in the full map
  int nx, ny, nz, sx;  // window (grid) extents; sx = ny * nz, the x stride
};

// The window's bounds along one axis, as sdf.in_window rounds them: o +
// off res + mlo and o + (off + n) res - mhi, each margin 1e-4 on a face
// of the full map (off == 0, off + n == full) and res / 2 inside it.
__device__ __forceinline__ void gto_window(float o, float res, float half,
                                           int off, int n, int full,
                                           float* lo, float* hi) {
  *lo = __fadd_rn(__fadd_rn(o, __fmul_rn(static_cast<float>(off), res)),
                  off == 0 ? 1e-4f : half);
  *hi = __fsub_rn(
      __fadd_rn(o, __fmul_rn(static_cast<float>(off + n), res)),
      off + n == full ? 1e-4f : half);
}

// The frame of an (nx, ny, nz) grid that is the window at cell (offx,
// offy, offz) of an (fx, fy, fz) map; offset 0 and full = (nx, ny, nz)
// for a whole map.
__device__ __forceinline__ GtoFrame gto_make_frame(int nx, int ny, int nz,
                                                   int offx, int offy,
                                                   int offz, int fx, int fy,
                                                   int fz, float ox,
                                                   float oy, float oz,
                                                   float res) {
  GtoFrame f;
  f.ox = ox;
  f.oy = oy;
  f.oz = oz;
  f.res = res;
  f.half = __fmul_rn(0.5f, res);
  f.rcp = __frcp_rn(res);
  gto_window(ox, res, f.half, offx, nx, fx, &f.lox, &f.hix);
  gto_window(oy, res, f.half, offy, ny, fy, &f.loy, &f.hiy);
  gto_window(oz, res, f.half, offz, nz, fz, &f.loz, &f.hiz);
  f.offx = offx;
  f.offy = offy;
  f.offz = offz;
  f.nx = nx;
  f.ny = ny;
  f.nz = nz;
  f.sx = ny * nz;
  return f;
}

// a / res, correctly rounded, from r = RN(1 / res) (Markstein): q0 =
// RN(a r) is within about an ulp of the quotient, so e = a - q0 res is
// exact in one FMA, and RN(q0 + e r) is the rounded quotient.  It is
// formed as -RN(-e r - q0), the same value, so that a zero quotient keeps
// the sign of a, as division does.  Exact where GtoDivGuard accepts a:
// below 2^-100, e can fall under the normal range and lose bits; far
// above, q0 can overflow.
__device__ __forceinline__ float gto_div_fast(float a, const GtoFrame& f) {
  const float q0 = __fmul_rn(a, f.rcp);
  const float e = __fmaf_rn(-q0, f.res, a);
  return -__fmaf_rn(-e, f.rcp, -q0);
}

// Whether every dividend added is 0 or has |a| in [2^-100, 2^100] (NaN
// is not told apart), in three instructions a dividend: the least of
// 2 bits(|a|) - 1 over the dividends (0 wraps to the top) and the
// largest |a|.
struct GtoDivGuard {
  unsigned lo = 0xffffffffu;
  float hi = 0.0f;
  __device__ __forceinline__ void add(float a) {
    lo = min(lo, __float_as_uint(a) * 2u - 1u);
    hi = fmaxf(hi, fabsf(a));
  }
  __device__ __forceinline__ bool ok() const {
    return lo >= 2u * 0x0D800000u - 1u && hi <= 0x1p100f;  // 2^-100 .. 2^100
  }
};

// a / res with __fdiv_rn's bits for every float32 a but NaN.
__device__ __forceinline__ float gto_div(float a, const GtoFrame& f) {
  GtoDivGuard guard;
  guard.add(a);
  return guard.ok() ? gto_div_fast(a, f) : __fdiv_rn(a, f.res);
}

__device__ __forceinline__ float gto_blend(float w0, float a, float w1,
                                           float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// The lookup at an in-map point p into out = (d, gx, gy, gz), dividing by
// res with gto_div_fast (kIeee false) or __fdiv_rn (kIeee true).  Returns
// whether every dividend passed GtoDivGuard (always, with kIeee).
template <bool kIeee>
__device__ __forceinline__ bool gto_lookup(const float* __restrict__ grid,
                                           const GtoFrame& f, float px,
                                           float py, float pz, float* out) {
  GtoDivGuard guard;
  const auto div = [&](float a) {
    if constexpr (kIeee) {
      return __fdiv_rn(a, f.res);
    } else {
      guard.add(a);
      return gto_div_fast(a, f);
    }
  };
  const int ix = static_cast<int>(
      floorf(div(__fsub_rn(__fsub_rn(px, f.half), f.ox))));
  const int iy = static_cast<int>(
      floorf(div(__fsub_rn(__fsub_rn(py, f.half), f.oy))));
  const int iz = static_cast<int>(
      floorf(div(__fsub_rn(__fsub_rn(pz, f.half), f.oz))));
  const float dx = div(
      __fsub_rn(px, __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(ix),
                                                  0.5f), f.res), f.ox)));
  const float dy = div(
      __fsub_rn(py, __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(iy),
                                                  0.5f), f.res), f.oy)));
  const float dz = div(
      __fsub_rn(pz, __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(iz),
                                                  0.5f), f.res), f.oz)));
  // window-local corner cells
  const int lx = ix - f.offx, ly = iy - f.offy, lz = iz - f.offz;
  const int x0 = min(max(lx, 0), f.nx - 1), x1 = min(max(lx + 1, 0), f.nx - 1);
  const int y0 = min(max(ly, 0), f.ny - 1), y1 = min(max(ly + 1, 0), f.ny - 1);
  const int z0 = min(max(lz, 0), f.nz - 1), z1 = min(max(lz + 1, 0), f.nz - 1);
  // the four rows (x, y) of the corners, then z0 and z1 along each
  const float* r00 = grid + x0 * f.sx + y0 * f.nz;
  const float* r01 = grid + x0 * f.sx + y1 * f.nz;
  const float* r10 = grid + x1 * f.sx + y0 * f.nz;
  const float* r11 = grid + x1 * f.sx + y1 * f.nz;
  // v<a><b><c>: a = x corner, b = y corner, c = z corner
  const float v000 = __ldg(r00 + z0), v001 = __ldg(r00 + z1);
  const float v010 = __ldg(r01 + z0), v011 = __ldg(r01 + z1);
  const float v100 = __ldg(r10 + z0), v101 = __ldg(r10 + z1);
  const float v110 = __ldg(r11 + z0), v111 = __ldg(r11 + z1);

  const float ex = __fsub_rn(1.0f, dx);
  const float ey = __fsub_rn(1.0f, dy);
  const float ez = __fsub_rn(1.0f, dz);
  const float v00 = gto_blend(ex, v000, dx, v100);
  const float v01 = gto_blend(ex, v001, dx, v101);
  const float v10 = gto_blend(ex, v010, dx, v110);
  const float v11 = gto_blend(ex, v011, dx, v111);
  const float v0 = gto_blend(ey, v00, dy, v10);
  const float v1 = gto_blend(ey, v01, dy, v11);
  out[0] = gto_blend(ez, v0, dz, v1);
  out[3] = div(__fsub_rn(v1, v0));
  out[2] = div(gto_blend(ez, __fsub_rn(v10, v00), dz, __fsub_rn(v11, v01)));
  const float sx = __fadd_rn(
      __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(ez, ey), __fsub_rn(v100, v000)),
                    __fmul_rn(__fmul_rn(ez, dy), __fsub_rn(v110, v010))),
          __fmul_rn(__fmul_rn(dz, ey), __fsub_rn(v101, v001))),
      __fmul_rn(__fmul_rn(dz, dy), __fsub_rn(v111, v011)));
  out[1] = div(sx);
  return guard.ok();
}

// d and its gradient at p from the scenario's grid and frame.
__device__ __forceinline__ void gto_trilinear(const float* __restrict__ grid,
                                              const GtoFrame& f, float px,
                                              float py, float pz, float* d,
                                              float* gx, float* gy,
                                              float* gz) {
  const bool ok = px > f.lox && px < f.hix && py > f.loy && py < f.hiy &&
                  pz > f.loz && pz < f.hiz;
  float out[4] = {-1.0f, 0.0f, 0.0f, 0.0f};  // out of map
  if (ok && !gto_lookup<false>(grid, f, px, py, pz, out))
    gto_lookup<true>(grid, f, px, py, pz, out);  // a dividend out of range
  *d = out[0];
  *gx = out[1];
  *gy = out[2];
  *gz = out[3];
}
