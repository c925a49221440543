// K2: batched trilinear distance + gradient lookup.
//
// Replaces grad_traj_optimization_tpu/ops/trilinear_pallas.py::_kernel
// (launched by trilinear_fused_prepped / trilinear_fused_batch).
// Wrapper: ops/trilinear_cuda.py.  The per-point math is gto_trilinear in
// trilinear.cuh, which the whole-descent kernel (solve.cu) also runs.
//
// The TPU K2 has no crop frame, nor has this launch: it passes offset 0
// and full = its grid to gto_make_frame, the whole-map lookup.
//
// Design: a gather, one thread per query point.  Block (b, c) holds
// scenario b's points c * blockDim.x onwards (a grid-stride loop past
// 65535 chunks); its first thread builds the scenario's GtoFrame in
// shared memory, which every thread then reads as a broadcast.  Scenario
// b's grid starts at grid + b * grid_stride (stride 0 for one map shared
// by the batch).  Bound: the corner loads, four or five scattered 32-byte
// sectors a point from grids far larger than L2 (1 GB at bench shape).
// At bench shape (1024 x 180 points) every thread is resident at once,
// so a grid-stride loop over fewer blocks would change nothing; the
// launch is a few tens of microseconds on the device, and the wrapper's
// host time is as long again.
//
// gto_div_check holds gto_div against __fdiv_rn over float32 bit
// patterns, on the card that runs the lookup.
#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

__global__ void trilinear_batch_kernel(
    const float* __restrict__ grids, long long grid_stride, int nx, int ny,
    int nz, const float* __restrict__ origin, const float* __restrict__ res,
    const float* __restrict__ pos, int S, float* __restrict__ d,
    float* __restrict__ g) {
  __shared__ GtoFrame frame;
  const int b = blockIdx.x;
  if (threadIdx.x == 0)
    frame = gto_make_frame(nx, ny, nz, 0, 0, 0, nx, ny, nz, origin[3 * b],
                           origin[3 * b + 1], origin[3 * b + 2], res[b]);
  __syncthreads();
  const float* grid = grids + b * grid_stride;
  for (int s = blockIdx.y * blockDim.x + threadIdx.x; s < S;
       s += gridDim.y * blockDim.x) {
    const long long i = static_cast<long long>(b) * S + s;
    const float* p = pos + 3 * i;
    float dv, gx, gy, gz;
    gto_trilinear(grid, frame, p[0], p[1], p[2], &dv, &gx, &gy, &gz);
    d[i] = dv;
    g[3 * i] = gx;
    g[3 * i + 1] = gy;
    g[3 * i + 2] = gz;
  }
}

// out[e] counts the dividends of exponent field e (sign aside) where
// gto_div and __fdiv_rn differ in any bit; out[256] the finite dividends
// checked.
__global__ void div_check_kernel(float res, long long start, long long count,
                                 unsigned long long* __restrict__ out) {
  const GtoFrame f =
      gto_make_frame(1, 1, 1, 0, 0, 0, 1, 1, 1, 0.0f, 0.0f, 0.0f, res);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned long long checked = 0;
  unsigned int run = 0;
  int cur = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += stride) {
    const unsigned int bits = static_cast<unsigned int>(start + i);
    const int ex = (bits >> 23) & 0xff;
    if (ex == 0xff) continue;  // inf and NaN
    ++checked;
    if (ex != cur) {  // a thread's dividends climb through the exponents
      if (run) atomicAdd(out + cur, static_cast<unsigned long long>(run));
      cur = ex;
      run = 0;
    }
    const float a = __uint_as_float(bits);
    run += __float_as_uint(gto_div(a, f)) !=
           __float_as_uint(__fdiv_rn(a, res));
  }
  if (run) atomicAdd(out + cur, static_cast<unsigned long long>(run));
  for (int o = 16; o > 0; o >>= 1)
    checked += __shfl_xor_sync(0xffffffffu, checked, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(out + 256, checked);
}

}  // namespace

extern "C" int gto_trilinear_batch(const float* grids, long long grid_stride,
                                   int nx, int ny, int nz,
                                   const float* origin, const float* res,
                                   const float* pos, int B, int S, float* d,
                                   float* g, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const int threads = S < 256 ? (S + 31) / 32 * 32 : 256;
  const int chunks = (S + threads - 1) / threads;
  const dim3 grid(B, chunks < 65535 ? chunks : 65535);
  trilinear_batch_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      grids, grid_stride, nx, ny, nz, origin, res, pos, S, d, g);
  return static_cast<int>(cudaGetLastError());
}

// out: 257 zeroed counters (div_check_kernel); bit patterns start ..
// start + count - 1, as unsigned 32-bit values.
extern "C" int gto_div_check(float res, long long start, long long count,
                             unsigned long long* out, void* stream) {
  if (count <= 0) return 0;
  div_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      res, start, count, out);
  return static_cast<int>(cudaGetLastError());
}
