// K1: the EDT min-plus parabola pass,  out[l, q] = min_v f[l, v] + (q - v)^2,
// along one axis of a contiguous tensor, in place.
//
// Replaces grad_traj_optimization_tpu/ops/edt_pallas.py::_minplus_kernel
// (launched by minplus_lines / minplus_axis).  Wrapper: ops/edt_cuda.py.
//
// Layout.  The kernel sees the tensor as a contiguous (O, n, I) view with
// the line on the middle axis: line L = o * I + i holds f[o, :, i].  The
// EDT's y pass is (B*nx, ny, nz), its x pass (B, nx, ny*nz), and
// minplus_lines (L, n, 1).  So neither pass moves an axis: a block stages
// C consecutive lines (C = 32 for n <= 383, fewer for longer lines, within
// 48 KB) into shared memory, one row of line c at tile[c * s], s = n
// rounded up to odd, and writes its results back to the lines' own
// places, which no other block touches.
// For I > 1 the staging loop walks v-major, so a warp reads and writes C
// neighbouring i of one v (128 contiguous bytes when I >= 32); for I = 1
// it walks line-major, so a warp reads contiguous lines.
//
// Arithmetic.  Each thread owns R = 10 outputs q of one line.  For each v
// it reads f[v] from shared memory once and updates its R running minima
// with fminf(best, fmaf(dq, dq, f[v])).  The v loop is unrolled by U = 8,
// and the R + U - 1 distinct dq = q - v of an unrolled step are formed
// once, so a (q, v) pair costs one FFMA and one FMNMX, and one LDS feeds
// R pairs.  In a warp, lanes with different c read different banks (s is odd) and
// lanes with the same c read one address, so the reads are
// conflict-free.  A block has at most 512 threads (C lines x ceil(n / R)
// groups; a thread takes several groups of a long line).
//
// Bound.  A bench pass moves 2.05 GB (read once, written once): 0.61 ms
// at 3.35 TB/s.  Its 2.56e10 pairs are 0.77 ms of FFMA at the card's 128
// a clock per SM, and the loop issues about 2.35 instructions a pair.  On
// the H100 the loop alone, loads removed, takes about 2.9 ms whichever
// min it uses (FMNMX, IMNMX on the bit patterns, or an FADD in its place;
// scripts/k1_probe.py), and the copies in and out hide behind
// it once five blocks share an SM: __launch_bounds__(512, 3) holds a
// thread to 42 registers, where 52 left room for three.  So the dense form
// is bound by its own instruction stream, about five times the memory
// bound; a pass that reaches the memory bound needs the O(n) scan below.
//
// Bitwise.  The result equals the plain version (f + (q - v)^2, then
// amin) bit for bit: q - v is an integer of magnitude below 4096, so dq
// and dq^2 are exact in f32; fmaf(dq, dq, f) rounds dq^2 + f once, as the
// plain f32 sum does; and min is exact in any order.  Past 4096 cells
// dq^2 can need more than 24 bits: the plain version rounds it, then
// rounds the sum, and fmaf (one rounding) would part from it.  So lines
// longer than 4096 (gto_minplus_long, below) square and add with
// separate __fmul_rn and __fadd_rn.
//
// Long lines.  A line of 12 288 cells or more also outgrows the staging
// scheme's 48 KB, so gto_minplus_long streams v through shared memory in
// tiles of kLV values of 32 lines, and its grid runs over (32-line blocks
// x 128-output q tiles): 256 threads, thread (line c, group g) keeping
// kLR = 16 running minima of one line in registers across the v tiles.
// An unrolled step forms the 23 distinct dq^2 of its 16 x 8 pairs once,
// so a pair costs an FADD and an FMNMX, as in the dense loop above.
// Blocks of one line read v values that other blocks write as q, so the
// kernel writes to a scratch buffer and the entry copies it back when the
// call is in place.  dq stays exact in f32 for lines below 2^24 cells.
//
// The O(n) lower-envelope scan (reference sdf_map.cpp:266-308) would move
// only the 0.61 ms of traffic, but its float intersection test does not
// guarantee the plain version's bits; it is left to measure in a later PR.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kR = 10;                  // outputs per thread
constexpr int kU = 8;                   // v unroll
constexpr int kMaxColsShift = 5;
constexpr int kMaxCols = 1 << kMaxColsShift;  // lines per block
constexpr int kSmemBudget = 48 * 1024;  // static launch limit
constexpr int kMaxThreads = 512;        // threads a block, at most
constexpr int kMinBlocks = 3;           // so at most 42 registers a thread

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
minplus_kernel(const float* src, float* dst, long long n_lines, int n,
               long long I, int cshift, int stride) {
  extern __shared__ float tile[];
  __shared__ long long base[kMaxCols];
  // cols = 2^cshift lines a block: line c of thread or element k is
  // k & cmask, so no index needs a division by a run-time value
  const int cols = 1 << cshift, cmask = cols - 1;
  const int t = threadIdx.x, nt = blockDim.x;
  const long long line0 = static_cast<long long>(blockIdx.x) * cols;
  const long long left = n_lines - line0;
  const int nl = left < cols ? static_cast<int>(left) : cols;
  if (t < nl) {
    const long long L = line0 + t;
    const long long o = L / I;
    base[t] = o * n * I + (L - o * I);  // element v of line t: base + v * I
  }
  __syncthreads();
  const int count = cols * n;
  if (I == 1) {  // contiguous lines: walk line-major
    for (int k = t; k < count; k += nt) {
      const int c = k / n, v = k - c * n;
      if (c < nl) tile[c * stride + v] = src[base[c] + v];
    }
  } else {
    for (int k = t; k < count; k += nt) {
      const int v = k >> cshift, c = k & cmask;
      if (c < nl) tile[c * stride + v] = src[base[c] + v * I];
    }
  }
  __syncthreads();

  // thread -> (line c, q group g); a warp holds 32 / cols groups
  const int c = t & cmask;
  const int groups = (n + kR - 1) / kR;
  const float* fl = tile + c * stride;
  float best[kR];
  // A thread owns groups g0, g0 + gstep, ... (more than one only for long
  // lines).  Its last group's results wait in registers until the whole
  // block has read the tile; any earlier group is stored at once.
  int g0 = t >> cshift;
  const int gstep = nt >> cshift;
  for (int g = g0; g < groups; g += gstep) {
#pragma unroll
    for (int r = 0; r < kR; ++r) best[r] = INFINITY;
    float D = static_cast<float>(g * kR);  // q0 - v0
    int v = 0;
    for (; v + kU <= n; v += kU) {
      float fv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) fv[u] = fl[v + u];
      float dk[kR + kU - 1];  // dq = q0 + r - (v + u) = dk[r - u + kU - 1]
#pragma unroll
      for (int k = 0; k < kR + kU - 1; ++k)
        dk[k] = D + static_cast<float>(k - (kU - 1));
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float d = dk[r - u + kU - 1];
          best[r] = fminf(best[r], fmaf(d, d, fv[u]));
        }
      }
      D -= static_cast<float>(kU);
    }
    for (; v < n; ++v) {
      const float f = fl[v];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float d = D + static_cast<float>(r);
        best[r] = fminf(best[r], fmaf(d, d, f));
      }
      D -= 1.0f;
    }
    if (g + gstep < groups) {
      if (c < nl) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int q = g * kR + r;
          if (q < n) dst[base[c] + static_cast<long long>(q) * I] = best[r];
        }
      }
      continue;
    }
    g0 = g;  // the last group: staged through the tile below
  }
  __syncthreads();  // every thread has finished reading the tile
  if (g0 < groups) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int q = g0 * kR + r;
      if (q < n) tile[c * stride + q] = best[r];
    }
  }
  __syncthreads();
  // store what was staged: every thread's last group, which together are
  // the last min(groups, gstep) groups of each line
  const int q_lo = (groups > gstep ? groups - gstep : 0) * kR;
  const int span = n - q_lo;
  if (I == 1) {
    for (int k = t; k < cols * span; k += nt) {
      const int cc = k / span, q = q_lo + (k - cc * span);
      if (cc < nl) dst[base[cc] + q] = tile[cc * stride + q];
    }
  } else {
    for (int k = t; k < cols * span; k += nt) {
      const int q = q_lo + (k >> cshift), cc = k & cmask;
      if (cc < nl) dst[base[cc] + static_cast<long long>(q) * I] =
          tile[cc * stride + q];
    }
  }
}

constexpr int kLR = 16;                   // outputs per thread
constexpr int kLU = 8;                    // v unroll
constexpr int kLCols = 32;                // lines per block
constexpr int kLGroups = 8;               // q groups per line
constexpr int kLThreads = kLCols * kLGroups;
constexpr int kLQ = kLR * kLGroups;       // outputs of a line per block
constexpr int kLV = 256;                  // v tile
constexpr int kLStride = kLV + 1;         // odd: lines on distinct banks

// Lines of any length; dst must not be src (see "Long lines").
__global__ void __launch_bounds__(kLThreads)
minplus_long_kernel(const float* __restrict__ src, float* __restrict__ dst,
                    long long n_lines, int n, long long I, int n_qt) {
  __shared__ float tile[kLCols * kLStride];
  __shared__ long long base[kLCols];
  const int t = threadIdx.x;
  const long long lb = blockIdx.x / n_qt;
  const int qt = static_cast<int>(blockIdx.x - lb * n_qt);
  const long long line0 = lb * kLCols;
  const long long left = n_lines - line0;
  const int nl = left < kLCols ? static_cast<int>(left) : kLCols;
  if (t < nl) {
    const long long L = line0 + t;
    const long long o = L / I;
    base[t] = o * n * I + (L - o * I);  // element v of line t: base + v * I
  }
  const int c = t % kLCols, g = t / kLCols;
  const int q0 = qt * kLQ + g * kLR;
  const float* fl = tile + c * kLStride;
  float best[kLR];
#pragma unroll
  for (int r = 0; r < kLR; ++r) best[r] = INFINITY;
  for (int v0 = 0; v0 < n; v0 += kLV) {
    const int vn = n - v0 < kLV ? n - v0 : kLV;
    __syncthreads();  // base is set; the previous tile has been read
    if (I == 1) {  // contiguous lines: walk line-major
      for (int k = t; k < kLCols * vn; k += kLThreads) {
        const int cc = k / vn, v = k - cc * vn;
        if (cc < nl) tile[cc * kLStride + v] = src[base[cc] + v0 + v];
      }
    } else {  // a warp reads 32 neighbouring lines of one v
      for (int k = t; k < kLCols * vn; k += kLThreads) {
        const int v = k / kLCols, cc = k % kLCols;
        if (cc < nl)
          tile[cc * kLStride + v] =
              src[base[cc] + static_cast<long long>(v0 + v) * I];
      }
    }
    __syncthreads();
    float D = static_cast<float>(q0 - v0);  // q0 - v, exact
    int v = 0;
    for (; v + kLU <= vn; v += kLU) {
      float fv[kLU];
#pragma unroll
      for (int u = 0; u < kLU; ++u) fv[u] = fl[v + u];
      float sq[kLR + kLU - 1];  // dq = q0 + r - (v + u): sq[r - u + kLU - 1]
#pragma unroll
      for (int k = 0; k < kLR + kLU - 1; ++k) {
        const float d = D + static_cast<float>(k - (kLU - 1));
        sq[k] = __fmul_rn(d, d);
      }
#pragma unroll
      for (int u = 0; u < kLU; ++u) {
#pragma unroll
        for (int r = 0; r < kLR; ++r)
          best[r] = fminf(best[r], __fadd_rn(sq[r - u + kLU - 1], fv[u]));
      }
      D -= static_cast<float>(kLU);
    }
    for (; v < vn; ++v) {
      const float f = fl[v];
#pragma unroll
      for (int r = 0; r < kLR; ++r) {
        const float d = D + static_cast<float>(r);
        best[r] = fminf(best[r], __fadd_rn(__fmul_rn(d, d), f));
      }
      D -= 1.0f;
    }
  }
  if (c < nl) {
#pragma unroll
    for (int r = 0; r < kLR; ++r) {
      const int q = q0 + r;
      if (q < n) dst[base[c] + static_cast<long long>(q) * I] = best[r];
    }
  }
}

}  // namespace

// f (O, n, I) contiguous -> out (O, n, I), lines of any length below
// 2^24.  When out is f (in place), scratch (as large as f) takes the
// result and is copied back on the stream; otherwise it may be null.
extern "C" int gto_minplus_long(const float* f, float* out, float* scratch,
                                long long O, int n, long long I,
                                void* stream) {
  if (O <= 0 || n <= 0 || I <= 0) return 0;
  if (n >= (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_place = f == out;
  if (in_place && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = in_place ? scratch : out;
  const long long n_lines = O * I;
  const int n_qt = (n + kLQ - 1) / kLQ;
  const long long blocks = (n_lines + kLCols - 1) / kLCols * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  minplus_long_kernel<<<static_cast<unsigned>(blocks), kLThreads, 0, st>>>(
      f, dst, n_lines, n, I, n_qt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !in_place) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyAsync(
      out, dst, static_cast<size_t>(n_lines) * n * sizeof(float),
      cudaMemcpyDeviceToDevice, st));
}

// f (O, n, I) contiguous -> out (O, n, I); out may be f (in place).
extern "C" int gto_minplus_axis(const float* f, float* out, long long O,
                                int n, long long I, void* stream) {
  if (O <= 0 || n <= 0 || I <= 0) return 0;
  const int stride = n | 1;
  int cols = kMaxCols, cshift = kMaxColsShift;
  while (cols > 1 &&
         static_cast<size_t>(cols) * stride * sizeof(float) > kSmemBudget) {
    cols >>= 1;
    --cshift;
  }
  const int groups = (n + kR - 1) / kR;
  int nt = cols * groups;
  nt = nt < 32 ? 32 : (nt > kMaxThreads ? kMaxThreads : (nt + 31) / 32 * 32);
  const long long n_lines = O * I;
  const long long blocks = (n_lines + cols - 1) / cols;
  const size_t smem = static_cast<size_t>(cols) * stride * sizeof(float);
  minplus_kernel<<<static_cast<unsigned>(blocks), nt, smem,
                   static_cast<cudaStream_t>(stream)>>>(f, out, n_lines, n, I,
                                                        cshift, stride);
  return static_cast<int>(cudaGetLastError());
}
