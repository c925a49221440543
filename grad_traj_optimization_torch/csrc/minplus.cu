// K1: the EDT min-plus parabola pass,  out[b, q] = min_v f[b, v] + (q - v)^2.
//
// Replaces grad_traj_optimization_tpu/ops/edt_pallas.py::_minplus_kernel
// (launched by minplus_lines).  Wrapper: ops/edt_cuda.py.
//
// Design: one thread per output (line, q), looping over v, with a tile of
// lines staged in shared memory.  The alternative, one thread per line
// running the O(n) Felzenszwalb scan (native/gtop_core.cpp:40-66), does
// a data-dependent walk with a per-thread stack and reads each line with
// a stride of n floats across a warp; the dense form has no branches,
// coalesced loads and stores, and is trivially the plain version's
// arithmetic, so the result is bitwise equal to it: (q - v)^2 is an exact
// float for n <= 4096, fmaf(dq, dq, f) rounds f + (q - v)^2 once as the
// plain sum does, and min is exact.
//
// Bound: arithmetic.  A pass over L lines of n does L*n*n FMA+min pairs
// (2.56M lines of 100 at bench shape: 2.6e10) against 8*L*n bytes of
// traffic, far past the card's balance point.  The inner loop is three
// instructions (FMA, min, decrement) with the line read from shared
// memory as a broadcast.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // staged floats per block (16 KB)

__global__ void minplus_kernel(const float* __restrict__ f,
                               float* __restrict__ out, long long n_lines,
                               int n, int lines_per_block) {
  extern __shared__ float tile[];
  const long long line0 = static_cast<long long>(blockIdx.x) * lines_per_block;
  const long long left = n_lines - line0;
  const int nl = left < lines_per_block ? static_cast<int>(left)
                                        : lines_per_block;
  const int count = nl * n;
  const float* src = f + line0 * n;
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
  __syncthreads();
  float* dst = out + line0 * n;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int l = i / n;
    const int q = i - l * n;
    const float* fl = tile + l * n;
    float dq = static_cast<float>(q);  // q - v, exact
    float best = fmaf(dq, dq, fl[0]);
    for (int v = 1; v < n; ++v) {
      dq -= 1.0f;
      best = fminf(best, fmaf(dq, dq, fl[v]));
    }
    dst[i] = best;
  }
}

}  // namespace

extern "C" int gto_minplus_lines(const float* f, float* out,
                                 long long n_lines, int n, void* stream) {
  if (n_lines <= 0 || n <= 0) return 0;
  const int lpb = n < kTileFloats ? kTileFloats / n : 1;
  const long long blocks = (n_lines + lpb - 1) / lpb;
  const size_t smem = static_cast<size_t>(lpb) * n * sizeof(float);
  minplus_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(f, out, n_lines, n,
                                                        lpb);
  return static_cast<int>(cudaGetLastError());
}
