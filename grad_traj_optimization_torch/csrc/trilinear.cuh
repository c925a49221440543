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
// Every operation is an explicitly rounded intrinsic (__fmul_rn and
// friends, which the compiler never contracts into an FMA) in the plain
// version's order, so the result is bitwise the plain PyTorch version's.
//
// Bound: latency of the eight dependent 4-byte loads.  A grid is 1 MB at
// bench shape and 4 MB at the opti_node map, far above a block's shared
// memory, so the corners come through L1/L2 (the 50 MB L2 holds one
// grid per resident block many times over).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float gto_blend(float w0, float a, float w1,
                                           float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__device__ __forceinline__ void gto_trilinear(
    const float* __restrict__ grid, int nx, int ny, int nz, float ox,
    float oy, float oz, float res, float px, float py, float pz, float* d,
    float* gx, float* gy, float* gz) {
  const float half = __fmul_rn(0.5f, res);
  const bool ok =
      px > __fadd_rn(ox, 1e-4f) &&
      px < __fsub_rn(__fadd_rn(ox, __fmul_rn(static_cast<float>(nx), res)),
                     1e-4f) &&
      py > __fadd_rn(oy, 1e-4f) &&
      py < __fsub_rn(__fadd_rn(oy, __fmul_rn(static_cast<float>(ny), res)),
                     1e-4f) &&
      pz > __fadd_rn(oz, 1e-4f) &&
      pz < __fsub_rn(__fadd_rn(oz, __fmul_rn(static_cast<float>(nz), res)),
                     1e-4f);
  if (!ok) {
    *d = -1.0f;
    *gx = *gy = *gz = 0.0f;
    return;
  }
  const int ix = static_cast<int>(
      floorf(__fdiv_rn(__fsub_rn(__fsub_rn(px, half), ox), res)));
  const int iy = static_cast<int>(
      floorf(__fdiv_rn(__fsub_rn(__fsub_rn(py, half), oy), res)));
  const int iz = static_cast<int>(
      floorf(__fdiv_rn(__fsub_rn(__fsub_rn(pz, half), oz), res)));
  const float dx = __fdiv_rn(
      __fsub_rn(px, __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(ix),
                                                  0.5f), res), ox)),
      res);
  const float dy = __fdiv_rn(
      __fsub_rn(py, __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(iy),
                                                  0.5f), res), oy)),
      res);
  const float dz = __fdiv_rn(
      __fsub_rn(pz, __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(iz),
                                                  0.5f), res), oz)),
      res);
  const int x0 = min(max(ix, 0), nx - 1), x1 = min(max(ix + 1, 0), nx - 1);
  const int y0 = min(max(iy, 0), ny - 1), y1 = min(max(iy + 1, 0), ny - 1);
  const int z0 = min(max(iz, 0), nz - 1), z1 = min(max(iz + 1, 0), nz - 1);
  // v<a><b><c>: a = x corner, b = y corner, c = z corner
  const float v000 = __ldg(grid + (x0 * ny + y0) * nz + z0);
  const float v001 = __ldg(grid + (x0 * ny + y0) * nz + z1);
  const float v010 = __ldg(grid + (x0 * ny + y1) * nz + z0);
  const float v011 = __ldg(grid + (x0 * ny + y1) * nz + z1);
  const float v100 = __ldg(grid + (x1 * ny + y0) * nz + z0);
  const float v101 = __ldg(grid + (x1 * ny + y0) * nz + z1);
  const float v110 = __ldg(grid + (x1 * ny + y1) * nz + z0);
  const float v111 = __ldg(grid + (x1 * ny + y1) * nz + z1);

  const float ex = __fsub_rn(1.0f, dx);
  const float ey = __fsub_rn(1.0f, dy);
  const float ez = __fsub_rn(1.0f, dz);
  const float v00 = gto_blend(ex, v000, dx, v100);
  const float v01 = gto_blend(ex, v001, dx, v101);
  const float v10 = gto_blend(ex, v010, dx, v110);
  const float v11 = gto_blend(ex, v011, dx, v111);
  const float v0 = gto_blend(ey, v00, dy, v10);
  const float v1 = gto_blend(ey, v01, dy, v11);
  *d = gto_blend(ez, v0, dz, v1);
  *gz = __fdiv_rn(__fsub_rn(v1, v0), res);
  *gy = __fdiv_rn(gto_blend(ez, __fsub_rn(v10, v00), dz, __fsub_rn(v11, v01)),
                  res);
  const float sx = __fadd_rn(
      __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(ez, ey), __fsub_rn(v100, v000)),
                    __fmul_rn(__fmul_rn(ez, dy), __fsub_rn(v110, v010))),
          __fmul_rn(__fmul_rn(dz, ey), __fsub_rn(v101, v001))),
      __fmul_rn(__fmul_rn(dz, dy), __fsub_rn(v111, v011)));
  *gx = __fdiv_rn(sx, res);
}
