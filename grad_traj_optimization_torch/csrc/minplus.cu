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
// rounds the sum, and fmaf (one rounding) would part from it.  Lines
// longer than 4096 take gto_minplus_long, below.
//
// Long lines: the exact O(n) lower envelope.  The plain result is
// P(q) = min_v fl(fl(d^2) + f_v), d = q - v, and the EDT feeds K1 only
// integer-valued floats (0, squared cell counts, BIG_CELLS^2).  On a line
// whose values below 2^24 are all non-negative integers, let H(q) be the
// exact minimum of d^2 + f_v over the sources with f_v < 2^24, in integer
// arithmetic.  Where H < 2^24, P = H: the winning term is exact, every
// other term with d^2 and f_v below 2^24 is an exact integer >= H, and
// every term with d^2 or f_v at or above 2^24 rounds to at least 2^24
// (rounding is monotone).  So the envelope needs only exact integer
// comparisons.  With keys K_v = f_v + v^2, v beats u < v at the integer
// q iff q >= t(u, v) = ceil((K_v - K_u) / (2 (v - u))); t is kept clamped
// to [0, n], the only outputs there are, so the stack's pop test N <= z D
// multiplies two numbers below 2^25, and the one division a push makes is
// a float estimate that exact integer steps correct.
// Every other output takes the two-rounding evaluation, __fmul_rn then
// __fadd_rn, in the same launch: an output with H >= 2^24 (over 4096
// cells from every source below 2^24), and every output of a line that
// holds a value below 2^24 that is not a non-negative integer (a real,
// a negative, NaN).  On a line with no negative value a term is at least
// fl(d^2) and at least f_v, so with U a term of q (its own, the
// envelope's winner's, the best of its 33 nearest cells) only the window
// d^2 < U can go below U, and a value that is the line's minimum is its
// own output.  A line with a negative value or NaN is scanned over every
// v.  So the scan is O(n) only where the envelope's value stays below
// 2^24: an output more than 4096 cells from every source costs O(d), d
// its distance to the nearest source (a line of 20 000 cells with one
// source at an end, about n^2 / 2 steps), and an output of a non-integer
// line O(n) at most (n^2 steps for a line of BIG_CELLS^2 around one 0.5).
// The kernel counts lines and outputs on each path.
//
// Layout.  One block of 256 threads owns a line: it stages the line's
// values with the band stacks, so outputs are written in place.  A line
// of up to 27 904 cells lies in shared memory with no scratch at all
// (8 bytes a cell: keys, their differences and z D fit 32 bits and a
// threshold 16); a longer one in a global slot per resident block (10
// bytes a cell, 64-bit keys).  Thread b builds the envelope of the
// sources in its band of s = ceil(n / 256) cells (cell b s + k staged at
// b (s | 1) + k, so the threads of a warp read distinct banks), leaving
// out a source that its two neighbouring sources beat at every output
// (a minimiser it would be has an equal one to its right, so all such
// sources go at once); the 256 band envelopes merge pairwise in 8 levels,
// each merge a Felzenszwalb push of the right stack onto the left that
// stops once a right entry keeps its predecessor (what follows is then
// unchanged), with the survivors of a band a range of its stack and the
// nonempty bands a linked list.  Thread b then walks the merged envelope
// over the outputs of its band.
//
// Bound.  An x pass of 8192 x 512 x 48 moves 1.61 GB, 0.481 ms at
// 3.35 TB/s.  It takes 6.5-6.8 ms on an H100 fed by an occupancy grid's
// z and y passes (7.0-7.3% of the bound; 145.7-146.6 ms for the dense
// form this replaced), every line on the integer path
// (scripts/k1_long_probe.py).  The time is in dependent chains, not
// bytes: 3 blocks an SM (shared memory) leave 24 warps to hide them; a
// line spends about 31 000 cycles staging (each value of an x pass its own
// 32-byte sector), 77 000-81 000 on the band envelopes (a step is a chain
// of shared loads and integer arithmetic), 64 000-66 000 on the merge
// levels (one thread a merge) and 30 000-32 000 on the outputs, wall clock
// with two other blocks on the SM.
#include <cuda_runtime.h>

#include <climits>
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

constexpr int kLT = 256;                // threads a block = bands a line
constexpr float kExact = 16777216.0f;   // 2^24: integers below it are exact
constexpr int kNoZ = INT_MIN;           // a stack's bottom: no threshold
constexpr int kLStage = 8;              // loads in flight a thread
constexpr int kSmallLine = 32767;       // longest line of 32-bit keys
constexpr size_t kSlotBudget = size_t{256} << 20;  // global slots, at most

// Per-band state of the merge and the merged envelope's band list.
struct LongBands {
  int lo[kLT], hi[kLT];    // surviving range of a band's stack (empty: hi < lo)
  int zf[kLT];             // threshold of a band's first survivor
  short prv[kLT], nxt[kLT];  // neighbouring nonempty bands
  short gf[kLT], gl[kLT];  // first / last nonempty band of a group
  int nb[kLT], nz[kLT];    // the merged list: nonempty bands, thresholds
  int wsum[kLT / 32];
  int m;                   // nonempty bands
  int fmin_bits;           // the line's minimum (when >= 0)
  int n_int;               // outputs of the line on the integer path
};

// The integer types of a line's envelope.  Up to kSmallLine cells the
// keys f + v^2 (f < 2^24), their differences and the products z D (z <= n,
// D < 2n) stay below 2^31, and a threshold in [0, n] fits 16 bits: such a
// line, when it fits, is staged in shared memory (kShared).  Other lines
// use 64-bit keys and 32-bit thresholds in a global slot.
template <bool kShared>
struct LongInts {
  using Key = long long;
  using Z = int;
};
template <>
struct LongInts<true> {
  using Key = int;
  using Z = unsigned short;
};

// A line of n cells in bands of s = ceil(n / kLT): cell v = b s + k lies
// at b sp + k, sp = s | 1, so that the threads of a warp, each in its
// own band, read distinct banks.
struct LongLayout {
  int n, s, sp;
  __host__ __device__ explicit LongLayout(int n_)
      : n(n_), s((n_ + kLT - 1) / kLT), sp(((n_ + kLT - 1) / kLT) | 1) {}
  __host__ __device__ int cells() const { return kLT * sp; }
};

// Where cells t, t + kLT, t + 2 kLT, ... lie, one after the other, with
// no division a cell.
struct LongWalk {
  int b, k, db, dk, s, sp;
  __device__ LongWalk(const LongLayout& ly, int t)
      : b(t / ly.s), k(t - t / ly.s * ly.s), db(kLT / ly.s),
        dk(kLT - kLT / ly.s * ly.s), s(ly.s), sp(ly.sp) {}
  __device__ int at() const { return b * sp + k; }
  __device__ void next() {
    b += db;
    k += dk;
    if (k >= s) {
      k -= s;
      ++b;
    }
  }
};

// Bytes a line takes: the staged line (float), the band stacks'
// thresholds and their cells (offsets in the band, 16 bits): 8 bytes a
// cell in shared memory, 10 in a global slot.
template <bool kShared>
__host__ __device__ inline size_t long_slot_bytes(int n) {
  const size_t cells = static_cast<size_t>(LongLayout(n).cells());
  return ((kShared ? 8 : 10) * cells + 255) / 256 * 256;
}

// ceil(N / D) clamped to [0, n], D > 0: a float estimate, then exact
// integer steps (the estimate is off by at most a few units).
template <typename Key>
__device__ __forceinline__ int ceil_clamped(Key N, int D, int n) {
  if (N <= 0) return 0;
  if (N > static_cast<Key>(n) * D) return n;
  Key t = static_cast<Key>(ceilf(
      __fdividef(static_cast<float>(N), static_cast<float>(D))));
  t = t < 1 ? 1 : (t > n ? n : t);
  while (t > 1 && (t - 1) * D >= N) --t;
  while (t * D < N) ++t;
  return static_cast<int>(t);
}

// Radius of the window |q - v| <= r that holds every v with d^2 < U.
__device__ __forceinline__ int long_radius(float U, int n) {
  return static_cast<int>(
      fmin(static_cast<double>(n), floor(sqrt(static_cast<double>(U))) + 1.0));
}

// min over v in [lo, hi] of fl(fl(d^2) + f_v), d = q - v, one band's run
// of cells at a time.
__device__ float long_scan(const float* F, const LongLayout& ly, int q,
                           int lo, int hi) {
  float b0 = INFINITY, b1 = INFINITY, b2 = INFINITY, b3 = INFINITY;
  float d = static_cast<float>(q - lo);  // exact below 2^24
  int v = lo, b = lo / ly.s;
  int k = lo - b * ly.s;
  while (v <= hi) {
    const int run = min(hi - v + 1, ly.s - k);
    const float* f = F + b * ly.sp + k;
    int i = 0;
    for (; i + 3 < run; i += 4) {
      const float d1 = d - 1.0f, d2 = d - 2.0f, d3 = d - 3.0f;
      b0 = fminf(b0, __fadd_rn(__fmul_rn(d, d), f[i]));
      b1 = fminf(b1, __fadd_rn(__fmul_rn(d1, d1), f[i + 1]));
      b2 = fminf(b2, __fadd_rn(__fmul_rn(d2, d2), f[i + 2]));
      b3 = fminf(b3, __fadd_rn(__fmul_rn(d3, d3), f[i + 3]));
      d -= 4.0f;
    }
    for (; i < run; ++i, d -= 1.0f)
      b0 = fminf(b0, __fadd_rn(__fmul_rn(d, d), f[i]));
    v += run;
    ++b;
    k = 0;
  }
  return fminf(fminf(b0, b1), fminf(b2, b3));
}

// min over v of fl(fl(d^2) + f_v): over every v when `every` (a negative
// value or NaN on the line); else U is a term of q or exceeds one, the
// nearest 33 cells' best term lowers it, and only the window d^2 < U
// can go below it.
__device__ float long_dense(const float* F, const LongLayout& ly, int q,
                            float U, bool every) {
  const int n = ly.n;
  if (every) return long_scan(F, ly, q, 0, n - 1);
  U = fminf(U, long_scan(F, ly, q, q > 16 ? q - 16 : 0,
                         q + 16 < n - 1 ? q + 16 : n - 1));
  if (!(U < 1.0e14f)) return fminf(U, long_scan(F, ly, q, 0, n - 1));
  const int r = long_radius(U, n);
  return fminf(U, long_scan(F, ly, q, q - r > 0 ? q - r : 0,
                            q + r < n - 1 ? q + r : n - 1));
}

// A line's staged values and band stacks.
template <bool kShared>
struct LongLine {
  using Key = typename LongInts<kShared>::Key;
  using Z = typename LongInts<kShared>::Z;
  LongLayout ly;
  float* F;
  Z* SZ;
  unsigned short* SV;
  // entry j of band b's stack: its threshold (j above the band's first)
  __device__ int z(int b, int j) const { return SZ[b * ly.sp + j]; }
};

// Stack entry j of band b: its cell, where it is staged, its value and
// key f + v^2.
template <typename Key>
struct LongEntry {
  int v, at, f;
  Key key;
};

template <bool kShared>
__device__ __forceinline__ LongEntry<typename LongInts<kShared>::Key>
long_entry(const LongLine<kShared>& ln, int b, int j) {
  using Key = typename LongInts<kShared>::Key;
  const int off = ln.SV[b * ln.ly.sp + j];
  const int v = b * ln.ly.s + off;
  const int at = b * ln.ly.sp + off;
  const int f = static_cast<int>(ln.F[at]);
  return {v, at, f, f + static_cast<Key>(v) * v};
}

// Merge group B (bands from m) into group A (bands from a0, before m):
// push B's survivors onto A's stack in order, popping A's tail, and drop
// B's head while its successor in B beats it from the new threshold on;
// once a B entry keeps its successor, the rest of B is unchanged.
template <bool kShared>
__device__ void long_merge(LongBands& sh, const LongLine<kShared>& ln, int a0,
                           int m) {
  using Key = typename LongInts<kShared>::Key;
  const int la = sh.gl[a0], fb = sh.gf[m];
  if (la < 0) {
    sh.gf[a0] = sh.gf[m];
    sh.gl[a0] = sh.gl[m];
    return;
  }
  if (fb < 0) return;
  const int n = ln.ly.n;
  const int glb = sh.gl[m];
  int ta = la, ja = sh.hi[la];  // A's top
  int hb = fb, jb = sh.lo[fb];  // B's head
  int zc;
  LongEntry<Key> c = long_entry(ln, hb, jb), e = long_entry(ln, ta, ja);
  for (;;) {
    const Key N = c.key - e.key;
    const int D = 2 * (c.v - e.v);
    const int zt = ja == sh.lo[ta] ? sh.zf[ta] : ln.z(ta, ja);
    if (zt != kNoZ && (zt >= n || N <= static_cast<Key>(zt) * D)) {
      if (ja > sh.lo[ta]) {
        --ja;
      } else {  // the band empties (A's bottom never pops, so prv exists)
        sh.hi[ta] = sh.lo[ta] - 1;
        ta = sh.prv[ta];
        ja = sh.hi[ta];
      }
      e = long_entry(ln, ta, ja);
      continue;
    }
    zc = ceil_clamped(N, D, n);
    int zn = INT_MAX;  // the head's successor in B, relative to the head
    if (jb < sh.hi[hb]) zn = ln.z(hb, jb + 1);
    else if (hb != glb) zn = sh.zf[sh.nxt[hb]];
    if (zn > zc) break;
    if (jb < sh.hi[hb]) {
      ++jb;
    } else {
      sh.hi[hb] = sh.lo[hb] - 1;
      hb = sh.nxt[hb];
      jb = sh.lo[hb];
    }
    c = long_entry(ln, hb, jb);
  }
  sh.hi[ta] = ja;
  sh.lo[hb] = jb;
  sh.zf[hb] = zc;
  sh.prv[hb] = static_cast<short>(ta);
  sh.nxt[ta] = static_cast<short>(hb);
  sh.gl[a0] = static_cast<short>(glb);
}

// Built with -DGTO_LONG_PROBE (scripts/k1_long_probe.py), each thread reads
// clock64() at the phases' ends, and thread 0 adds the cycles of each phase
// of an integer line (staging, band envelopes, merge levels, merged list,
// outputs) to counts[4..8].
#ifdef GTO_LONG_PROBE
#define LONG_CLOCK(i) clk[i] = clock64()
#else
#define LONG_CLOCK(i)
#endif

// One block a line (a grid-stride loop over lines).  Lines are f[base +
// v * I]; the block stages a line in dynamic shared memory (kShared) or
// in `slots` (global, one slot a block).  counts (may be null) gains
// lines and outputs on the integer path, then on the two-rounding path.
template <bool kShared>
__global__ void __launch_bounds__(kLT, 3)
minplus_long_kernel(const float* src, float* dst, long long n_lines, int n,
                    long long I, unsigned char* slots,
                    unsigned long long* counts) {
  using Key = typename LongInts<kShared>::Key;
  using Z = typename LongInts<kShared>::Z;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LongBands sh;
  const LongLayout ly(n);
  const int s = ly.s, sp = ly.sp;
  unsigned char* buf =
      kShared ? smem : slots + blockIdx.x * long_slot_bytes<false>(n);
  const size_t cells = static_cast<size_t>(ly.cells());
  const LongLine<kShared> ln{
      ly, reinterpret_cast<float*>(buf),
      reinterpret_cast<Z*>(buf + 4 * cells),
      reinterpret_cast<unsigned short*>(buf + (4 + sizeof(Z)) * cells)};
  float* F = ln.F;
  const int t = threadIdx.x;
  unsigned long long lines_int = 0, outs_int = 0, lines_dense = 0,
                     outs_dense = 0;
#ifdef GTO_LONG_PROBE
  long long clk[6];
#endif
  for (long long L = blockIdx.x; L < n_lines; L += gridDim.x) {
    const long long o = L / I;
    const long long base = o * n * I + (L - o * I);
    if (t == 0) {
      sh.fmin_bits = 0x7f800000;  // +inf
      sh.n_int = 0;
    }
    LONG_CLOCK(0);
    // stage the line; a line is "integer" when every value below 2^24 is
    // a non-negative integer
    bool other = false, neg = false;
    float lmin = INFINITY;
    LongWalk w(ly, t);
    for (int v0 = t; v0 < n; v0 += kLStage * kLT) {
      float r[kLStage];
#pragma unroll
      for (int u = 0; u < kLStage; ++u) {
        const int v = v0 + u * kLT;
        r[u] = v < n ? src[base + static_cast<long long>(v) * I] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLStage; ++u) {
        const int v = v0 + u * kLT;
        if (v < n) {
          const float f = r[u];
          F[w.at()] = f;
          w.next();
          other |= !(f >= kExact) && !(f >= 0.0f && f == floorf(f));
          neg |= !(f >= 0.0f);
          lmin = fminf(lmin, f + 0.0f);
        }
      }
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, k));
    __syncthreads();  // sh's reset is seen
    // non-negative floats order as their bit patterns
    if ((t & 31) == 0) atomicMin(&sh.fmin_bits, __float_as_int(lmin));
    const bool any_other = __syncthreads_or(other);
    const bool every = __syncthreads_or(neg);
    const float fmn = __int_as_float(sh.fmin_bits);
    LONG_CLOCK(1);

    if (any_other) {  // every output takes the two-rounding evaluation
      LongWalk wq(ly, t);
      for (int q = t; q < n; q += kLT, wq.next()) {
        const float fq = F[wq.at()];
        dst[base + static_cast<long long>(q) * I] =
            !every && fq <= fmn ? __fadd_rn(0.0f, fq)
                                : long_dense(F, ly, q, fq, every);
      }
      if (t == 0) {
        lines_dense += 1;
        outs_dense += n;
      }
      __syncthreads();  // F is read before the next line overwrites it
      continue;
    }

    // band envelope of the sources below 2^24 in cells [v0, v1)
    const int v0 = t * s;
    const int v1 = v0 + s < n ? v0 + s : n;
    const float* fb = F + t * sp;
    Z* zb = ln.SZ + t * sp;
    unsigned short* vb = ln.SV + t * sp;
    int c = 0, vt = 0, zt = kNoZ;
    Key kt = 0;
    // the cells beside v: a source that its two neighbours, sources too,
    // beat at every output is never needed (so it is skipped by every
    // band at once: a minimiser it would have been ties one to its right)
    float fl = v0 > 0 ? F[(t - 1) * sp + s - 1] : INFINITY;
    float fr = v0 < v1 ? fb[0] : INFINITY;
    for (int v = v0; v < v1; ++v) {
      const float fv = fr, fp = fl;
      fr = v + 1 >= n ? INFINITY
           : v + 1 < v1 ? fb[v + 1 - v0] : F[(t + 1) * sp];
      fl = fv;
      if (!(fv < kExact)) continue;
      if (fp < kExact && fr < kExact) {
        // v + 1 beats v from ceil(A / 2) on, v beats v - 1 from ceil(B / 2)
        const Key A = static_cast<Key>(static_cast<int>(fr)) -
                      static_cast<int>(fv) + 2 * v + 1;
        const Key B = static_cast<Key>(static_cast<int>(fv)) -
                      static_cast<int>(fp) + 2 * v - 1;
        const Key a = (A + 1) >> 1, b = (B + 1) >> 1;
        if ((a < 0 ? 0 : (a > n ? n : a)) <= (b < 0 ? 0 : (b > n ? n : b)))
          continue;
      }
      const Key K = static_cast<int>(fv) + static_cast<Key>(v) * v;
      int z = kNoZ;
      while (c > 0) {
        const Key N = K - kt;
        const int D = 2 * (v - vt);
        if (zt != kNoZ && (zt >= n || N <= static_cast<Key>(zt) * D)) {
          if (--c > 0) {
            const int off = vb[c - 1];
            vt = v0 + off;
            kt = static_cast<int>(fb[off]) + static_cast<Key>(vt) * vt;
            zt = c == 1 ? kNoZ : static_cast<int>(zb[c - 1]);
          }
          continue;
        }
        z = ceil_clamped(N, D, n);
        break;
      }
      vb[c] = static_cast<unsigned short>(v - v0);
      zb[c] = static_cast<Z>(z);  // the bottom's is never read
      ++c;
      vt = v;
      kt = K;
      zt = z;
    }
    sh.lo[t] = 0;
    sh.hi[t] = c - 1;
    sh.zf[t] = kNoZ;
    sh.prv[t] = sh.nxt[t] = -1;
    sh.gf[t] = sh.gl[t] = static_cast<short>(c ? t : -1);
    __syncthreads();
    LONG_CLOCK(2);
    for (int w = 1; w < kLT; w <<= 1) {
      if ((t & (2 * w - 1)) == 0) long_merge(sh, ln, t, t + w);
      __syncthreads();
    }
    LONG_CLOCK(3);
    // the merged list of nonempty bands, in order
    const bool alive = sh.hi[t] >= sh.lo[t];
    const unsigned bal = __ballot_sync(0xffffffffu, alive);
    if ((t & 31) == 0) sh.wsum[t >> 5] = __popc(bal);
    __syncthreads();
    int rank = __popc(bal & ((1u << (t & 31)) - 1u));
    for (int w = 0; w < (t >> 5); ++w) rank += sh.wsum[w];
    if (alive) {
      sh.nb[rank] = t;
      sh.nz[rank] = sh.zf[t];
    }
    if (t == kLT - 1) sh.m = rank + alive;
    __syncthreads();
    LONG_CLOCK(4);

    // outputs of band t: walk the merged envelope
    const int m = sh.m;
    const int q0 = t * s;
    const int q1 = q0 + s < n ? q0 + s : n;
    int n_int = 0;
    if (q0 < n) {
      int k = 0, b = 0, j = 0, hb = -1, zn = INT_MAX;
      LongEntry<Key> e{0, 0, 0, 0};
      if (m > 0) {
        int lo = 0, hi = m - 1;  // the last band starting at or before q0
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (sh.nz[mid] <= q0) lo = mid;
          else hi = mid - 1;
        }
        k = lo;
        b = sh.nb[k];
        lo = sh.lo[b];
        hb = hi = sh.hi[b];
        while (lo < hi) {  // the band's last entry starting at or before q0
          const int mid = (lo + hi + 1) >> 1;
          if (ln.z(b, mid) <= q0) lo = mid;
          else hi = mid - 1;
        }
        j = lo;
        e = long_entry(ln, b, j);
        zn = j < hb ? ln.z(b, j + 1) : (k + 1 < m ? sh.nz[k + 1] : INT_MAX);
      }
      for (int q = q0; q < q1; ++q) {
        float out;
        if (m > 0) {
          while (zn <= q) {
            if (j < hb) {
              ++j;
            } else {
              b = sh.nb[++k];
              j = sh.lo[b];
              hb = sh.hi[b];
            }
            e = long_entry(ln, b, j);
            zn = j < hb ? ln.z(b, j + 1)
                        : (k + 1 < m ? sh.nz[k + 1] : INT_MAX);
          }
          const long long d = q - e.v;
          const long long H = e.f + d * d;
          if (H < (1LL << 24)) {
            dst[base + static_cast<long long>(q) * I] =
                static_cast<float>(H);
            ++n_int;
            continue;
          }
        }
        const float fq = F[t * sp + (q - q0)];
        if (fq <= fmn) {
          out = __fadd_rn(0.0f, fq);
        } else {
          float U = fq;
          if (m > 0) {
            const float d = static_cast<float>(q - e.v);
            U = fminf(U, __fadd_rn(__fmul_rn(d, d), F[e.at]));
          }
          out = long_dense(F, ly, q, U, false);
        }
        dst[base + static_cast<long long>(q) * I] = out;
      }
    }
    atomicAdd(&sh.n_int, n_int);
    __syncthreads();  // the counts are in, and F is read
#ifdef GTO_LONG_PROBE
    LONG_CLOCK(5);
    if (t == 0 && counts != nullptr)
      for (int i = 0; i < 5; ++i)
        atomicAdd(counts + 4 + i,
                  static_cast<unsigned long long>(clk[i + 1] - clk[i]));
#endif
    if (t == 0) {
      lines_int += 1;
      outs_int += sh.n_int;
      outs_dense += n - sh.n_int;
    }
    __syncthreads();  // sh.n_int is read before the next line resets it
  }
  if (counts != nullptr && t == 0) {
    atomicAdd(counts + 0, lines_int);
    atomicAdd(counts + 1, outs_int);
    atomicAdd(counts + 2, lines_dense);
    atomicAdd(counts + 3, outs_dense);
  }
}

// Global slots a call takes (0: a line fits in shared memory) and their
// total bytes.
int long_slots(int n, long long n_lines, size_t* bytes) {
  int dev = 0, optin = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, minplus_long_kernel<true>);
  *bytes = 0;
  if (n <= kSmallLine && long_slot_bytes<true>(n) + attr.sharedSizeBytes <=
                             static_cast<size_t>(optin))
    return 0;
  const size_t slot = long_slot_bytes<false>(n);
  long long slots = static_cast<long long>(kSlotBudget / slot);
  if (slots > 2LL * sms) slots = 2LL * sms;
  if (slots > n_lines) slots = n_lines;
  if (slots < 1) slots = 1;
  *bytes = static_cast<size_t>(slots) * slot;
  return static_cast<int>(slots);
}

}  // namespace

// Bytes of global scratch gto_minplus_long needs for n_lines lines of n
// cells: 0 while a line fits in one block's shared memory.
extern "C" long long gto_minplus_long_scratch(int n, long long n_lines) {
  if (n <= 0 || n_lines <= 0) return 0;
  size_t bytes = 0;
  long_slots(n, n_lines, &bytes);
  return static_cast<long long>(bytes);
}

// f (O, n, I) contiguous -> out (O, n, I), lines of any length below
// 2^24; out may be f (in place).  scratch: gto_minplus_long_scratch bytes
// (null when that is 0).  counts: 4 uint64 accumulators (lines and
// outputs on the integer path, lines and outputs on the two-rounding
// path), or null.
extern "C" int gto_minplus_long(const float* f, float* out, void* scratch,
                                unsigned long long* counts, long long O,
                                int n, long long I, void* stream) {
  if (O <= 0 || n <= 0 || I <= 0) return 0;
  if (n >= (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_lines = O * I;
  size_t bytes = 0;
  const int slots = long_slots(n, n_lines, &bytes);
  if (slots > 0) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    minplus_long_kernel<false><<<slots, kLT, 0, st>>>(
        f, out, n_lines, n, I, static_cast<unsigned char*>(scratch), counts);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = long_slot_bytes<true>(n);
  cudaError_t e = cudaFuncSetAttribute(
      minplus_long_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = n_lines < 0x7fffffffLL ? n_lines : 0x7fffffffLL;
  minplus_long_kernel<true><<<static_cast<unsigned>(grid), kLT, smem, st>>>(
      f, out, n_lines, n, I, nullptr, counts);
  return static_cast<int>(cudaGetLastError());
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
