// K2: batched trilinear distance + gradient lookup.
//
// Replaces grad_traj_optimization_tpu/ops/trilinear_pallas.py::_kernel
// (launched by trilinear_fused_prepped / trilinear_fused_batch).
// Wrapper: ops/trilinear_cuda.py.  The per-point math is gto_trilinear in
// trilinear.cuh, which the whole-descent kernel (solve.cu) also runs.
//
// Design: one thread per query point; scenario b's grid starts at
// grid + b * grid_stride (stride 0 for one map shared by the batch).
// Bound: eight dependent corner loads per point through L1/L2, see
// trilinear.cuh; at bench shape (1024 x 180 points) the launch itself
// is a large share of the time.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

__global__ void trilinear_batch_kernel(
    const float* __restrict__ grids, long long grid_stride, int nx, int ny,
    int nz, const float* __restrict__ origin, const float* __restrict__ res,
    const float* __restrict__ pos, int B, int S, float* __restrict__ d,
    float* __restrict__ g) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * S) return;
  const int b = static_cast<int>(i / S);
  const float* p = pos + 3 * i;
  float dv, gx, gy, gz;
  gto_trilinear(grids + b * grid_stride, nx, ny, nz, origin[3 * b],
                origin[3 * b + 1], origin[3 * b + 2], res[b], p[0], p[1],
                p[2], &dv, &gx, &gy, &gz);
  d[i] = dv;
  g[3 * i] = gx;
  g[3 * i + 1] = gy;
  g[3 * i + 2] = gz;
}

}  // namespace

extern "C" int gto_trilinear_batch(const float* grids, long long grid_stride,
                                   int nx, int ny, int nz,
                                   const float* origin, const float* res,
                                   const float* pos, int B, int S, float* d,
                                   float* g, void* stream) {
  const long long n = static_cast<long long>(B) * S;
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  trilinear_batch_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      grids, grid_stride, nx, ny, nz, origin, res, pos, B, S, d, g);
  return static_cast<int>(cudaGetLastError());
}
