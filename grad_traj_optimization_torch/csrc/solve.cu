// K3: one scenario's whole projected Barzilai-Borwein descent per block.
//
// Replaces grad_traj_optimization_tpu/ops/solve_pallas.py::_solve_kernel
// (launched by descend_fused).  Wrapper: ops/solve_cuda.py; inputs come
// from solver.kernel_inputs in the JAX package's layouts, plus the
// compact sample chains below.
//
// Each iteration evaluates the candidate's cost and gradient:
//   pos/vel = A_pos/A_vel @ [Df; dp]            per sample
//   d, g    = trilinear lookup (trilinear.cuh)
//   cd = alpha exp(-(d - d0)/r), vn = |v| + vel_eps, cost_c = sum cd vn dt
//   w1 = (w_dist dt) g, w2 = ((cd/vn) dt) v, with the reference gradient's
//        extra cd factor in w_dist (grad_traj_optimizer.cpp:376-381)
//   grad = ws (cgt + 2 Rpp dp) + wc [TL^T | TVL^T] [w1; w2] (+ grad_eps)
//   cost = ws (c_ff + cgt.dp + dp.Rpp.dp) + wc cost_c + cost_eps
// plus, in step-2 phases with alpha_v or alpha_a != 0, the velocity and
// acceleration penalties of opt/penalty._va_weights (acc = A_acc @ [Df; dp],
// cv = alpha_v exp((|v| - v0)/r_v), ca likewise; the reference gradient
// mode keeps no sign() and the last axis's stale cv/ca factor):
//   cost += sum (sum cv + sum ca) vn dt,  w2 += w_tvl dt,  grad += TAL^T w_tal
// then the BB accept/reject step of opt/descent.minimize_batch: step
// clipped to [lr_min, lr_max], shrink on reject with a 1e-8 floor, a
// nonmonotone accept_window ring, the best iterate carried and the
// monotone best-cost trace recorded.
//
// Compact chains.  dep.L = A^-1 C^T is block per segment, so a sample's
// row of A_pos / A_vel / A_acc has at most 6 non-zero entries: the (p, v,
// a) columns of its segment's two knots (qp.segment_columns, one int table
// per m).  The kernel keeps those 6 values per sample in shared memory,
// in ascending column order, so a position sums the same non-zero terms
// in the same order as the dense row.  At bench shape (m = 6, K = 30,
// P = 15) that is 6 instead of 21 columns per chain.
//
// Threads.  A segment's K samples go to a group of G = pow2ceil(K) / spt
// lanes, spt samples each, so groups never straddle a warp.  The gradient
// entry of knot w's derivative i on axis k takes contributions only from
// the samples of segments w-1 and w: every thread sums its own samples'
// 18 (column, axis) products in registers, then each group reduces its 18
// sums with independent xor-shuffle trees, and the entry's thread adds
// the two segments' sums.  The host picks spt (a power of two) from the
// occupancy API: the fewest waves of resident blocks, then the fewest
// samples a thread.  On the H100 the bench batch runs spt = 4 on 64
// threads, 8 blocks per SM (at most 128 registers), so all 1024
// scenarios are resident at once; a single scenario runs spt = 1, 32
// lanes a segment, the shortest iteration.  Entry thread t < 3P keeps
// dp, the gradient, the candidate, the best iterate and the bounds of
// entry t in registers; only the candidate is shared, with Df ahead of
// it, so column j of [Df; x] is at xD + 3 j.
//
// Barriers: three per BB iteration.  (1) the candidate is visible; (2)
// the group sums and the per-warp cost sums are visible, after which
// every thread adds the cost in one fixed order and each entry thread
// forms its gradient and s.y, y.y partials (the accept ring is read
// here); (3) the per-warp s.y, y.y sums are visible, after which every
// thread takes the same accept decision and each entry thread updates
// its own state and writes the next candidate.
//
// Tensor cores do not apply: every scenario has its own segment times and
// so its own chains, and the products are per-scenario matrix-vector
// products of width at most 6 (chains) or 3P = 45 (Rpp), not a shared
// matrix against many vectors.
//
// Bound: one iteration's instruction stream and its dependent steps
// (chain FMAs, the lookup, expf/sqrtf, shuffles, three barriers).  The
// lookup's share, and how much of it its corner loads and its divisions
// take, is what scripts/k2_probe.py measures: with the lookup frame and
// its division sequence (trilinear.cuh) the loads hide behind the
// arithmetic.  The arithmetic of the compact form is about 45 kflop per
// scenario and evaluation, 4.6 GFLOP for the bench batch of 1024 x 101
// evaluations, 0.07 ms at 67 TFLOP/s; the grids (1 MB each at bench
// shape) stay in device memory and come through L1/L2.
#include <cuda_runtime.h>

#include "trilinear.cuh"

#define GTO_MAX_PHASES 4

namespace {

struct DescendParams {
  float w_smooth, w_collision, alpha, d0, r, vel_eps, cost_eps, grad_eps;
  float lr0, lr_shrink, lr_min, lr_max;
  float alpha_v, v0, r_v, alpha_a, a0, r_a;
  int ref_grad, window, n_phases, total_iters;
  int phase_step[GTO_MAX_PHASES];
  int phase_iters[GTO_MAX_PHASES];
};

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sign(x) with sign(0) = 0, as torch.sign
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// At most 128 registers a thread, so that 8 blocks of 64 threads share an
// SM and the bench batch stays in one wave whatever ptxas would choose;
// the build log shows whether that costs spills.
__global__ void __maxnreg__(128) descend_kernel(
    const float* __restrict__ grids, long long grid_stride, int nx, int ny,
    int nz, const float* __restrict__ cpos, const float* __restrict__ cvel,
    const float* __restrict__ cacc, const int* __restrict__ ccols,
    const float* __restrict__ rpp, const float* __restrict__ cgt,
    const float* __restrict__ lbT, const float* __restrict__ ubT,
    const float* __restrict__ dp0T, const float* __restrict__ dts,
    const float* __restrict__ dfT, const float* __restrict__ misc, int SP,
    int m, int K, int G, int spt, DescendParams prm,
    float* __restrict__ odp, float* __restrict__ ocost,
    int* __restrict__ onacc, float* __restrict__ otrace) {
  extern __shared__ float sm[];
  const int P = 3 * m - 3, P3 = 3 * P;
  const int nt = blockDim.x;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5, nw = nt >> 5;
  const long long b = blockIdx.x;
  const int slots = spt * nt;

  const bool use_v = prm.alpha_v != 0.0f, use_a = prm.alpha_a != 0.0f;
  float* cA = sm;                            // 6 x slots, (q, j * nt + t)
  float* cV = cA + 6 * slots;                // 6 x slots
  float* cC = cV + 6 * slots;                // 6 x slots (alpha_a only)
  float* cDt = cC + (use_a ? 6 * slots : 0);  // slots
  float* R = cDt + slots;                    // P x P
  float* xD = R + P * P;                     // [Df (6 x 3); candidate]
  float* x = xD + 18;                        // P3, dpT layout (p * 3 + k)
  float* Sg = x + P3;                        // m x 18 group sums
  float* hist = Sg + 18 * m;                 // accept_window
  float* red = hist + prm.window;            // 3 x 32 cost sums
  float* red2 = red + 96;                    // 2 x 32 BB sums
  int* scols = reinterpret_cast<int*>(red2 + 64);  // m x 6

  // this thread's segment and lane in its group
  const int seg = t / G, gl = t - seg * G;
  const bool sampler = seg < m;
  for (int i = t; i < 6 * m; i += nt) scols[i] = ccols[i];
  for (int j = 0; j < spt; ++j) {
    const int loc = gl * spt + j;
    const bool ok = sampler && loc < K;
    const long long row = b * SP + (ok ? seg * K + loc : 0);
    const int sl = j * nt + t;
    for (int q = 0; q < 6; ++q) {
      cA[q * slots + sl] = ok ? cpos[row * 6 + q] : 0.0f;
      cV[q * slots + sl] = ok ? cvel[row * 6 + q] : 0.0f;
      if (use_a) cC[q * slots + sl] = ok ? cacc[row * 6 + q] : 0.0f;
    }
    cDt[sl] = ok ? dts[row] : 0.0f;
  }
  for (int i = t; i < P * P; i += nt) R[i] = rpp[b * P * P + i];
  for (int i = t; i < 18; i += nt) xD[i] = dfT[b * 18 + i];
  // the scenario's lookup frame, read by every thread as a broadcast:
  // misc[5:8] the crop offset and misc[8:11] the full map's extents
  // (solver.kernel_inputs; offset 0 and the grid's own for a full grid)
  __shared__ GtoFrame frame;
  if (t == 0) {
    const float* mb = misc + b * 16;
    frame = gto_make_frame(
        nx, ny, nz, static_cast<int>(mb[5]), static_cast<int>(mb[6]),
        static_cast<int>(mb[7]), static_cast<int>(mb[8]),
        static_cast<int>(mb[9]), static_cast<int>(mb[10]), mb[0], mb[1],
        mb[2], mb[3]);
  }
  const float c_ff = misc[b * 16 + 4];
  const float* grid = grids + b * grid_stride;
  const bool collide = fabsf(prm.w_collision) >= 1e-4f;  // reference :346

  // entry thread t < P3 owns gradient entry (p, k): knot w = p / 3 + 1,
  // derivative i = p % 3, d column 6 + p; its state lives in registers
  const bool entry = t < P3;
  float e_cg = 0.0f, e_lb = 0.0f, e_ub = 0.0f, e_dp = 0.0f;
  if (entry) {
    e_cg = cgt[b * P3 + t];
    e_lb = lbT[b * P3 + t];
    e_ub = ubT[b * P3 + t];
    e_dp = fminf(fmaxf(dp0T[b * P3 + t], e_lb), e_ub);
  }
  __syncthreads();
  int cols[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) cols[q] = sampler ? scols[seg * 6 + q] : 0;
  // the entry's slots in the sums of segments w-1 and w
  int e_lo = 0, e_hi = 0;
  const int e_p = t / 3, e_k = t - 3 * e_p, e_w = e_p / 3 + 1;
  if (entry) {
    for (int q = 0; q < 6; ++q) {
      if (scols[(e_w - 1) * 6 + q] == 6 + e_p)
        e_lo = (e_w - 1) * 18 + 3 * q + e_k;
      if (scols[e_w * 6 + q] == 6 + e_p) e_hi = e_w * 18 + 3 * q + e_k;
    }
  }

  // cost at the shared candidate (all threads) and its gradient entry
  // (entry threads, into gout); va: this phase adds the velocity and
  // acceleration penalties (step 2 only).  Contains barrier (2).
  auto evaluate = [&](float ws, bool va, float& gout) -> float {
    const bool va_a = va && use_a;
    float part_s = 0.0f, part_c = 0.0f, part_va = 0.0f, gs = 0.0f;
    if (entry) {
      float z = 0.0f;
      for (int q = 0; q < P; ++q) z += R[e_p * P + q] * x[3 * q + e_k];
      part_s = e_cg * x[t] + x[t] * z;
      gs = ws * (e_cg + 2.0f * z);
    }
    float gp[18];
#pragma unroll
    for (int i = 0; i < 18; ++i) gp[i] = 0.0f;
    if (collide && sampler) {
      for (int j = 0; j < spt; ++j) {
        if (gl * spt + j >= K) break;
        const int sl = j * nt + t;
        float px = 0.0f, py = 0.0f, pz = 0.0f;
        float vx = 0.0f, vy = 0.0f, vz = 0.0f;
        float ax = 0.0f, ay = 0.0f, az = 0.0f;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float* dj = xD + 3 * cols[q];
          const float a = cA[q * slots + sl], v = cV[q * slots + sl];
          px += a * dj[0];
          py += a * dj[1];
          pz += a * dj[2];
          vx += v * dj[0];
          vy += v * dj[1];
          vz += v * dj[2];
          if (va_a) {
            const float c = cC[q * slots + sl];
            ax += c * dj[0];
            ay += c * dj[1];
            az += c * dj[2];
          }
        }
        const float my_dt = cDt[sl];
        float d, gx, gy, gz;
        gto_trilinear(grid, frame, px, py, pz, &d, &gx, &gy, &gz);
        const float cd = prm.alpha * expf(-(d - prm.d0) / prm.r);
        const float gd = -cd / prm.r;
        const float vn = sqrtf(vx * vx + vy * vy + vz * vz) + prm.vel_eps;
        part_c += cd * vn * my_dt;
        const float w_dist = prm.ref_grad ? gd * cd * vn : gd * vn;
        const float f1 = w_dist * my_dt, f2 = (cd / vn) * my_dt;
        const float wc = prm.w_collision;
        const float w1x = wc * (f1 * gx), w1y = wc * (f1 * gy),
                    w1z = wc * (f1 * gz);
        float w2x = wc * (f2 * vx), w2y = wc * (f2 * vy), w2z = wc * (f2 * vz);
        float w3x = 0.0f, w3y = 0.0f, w3z = 0.0f;
        if (va) {
          // opt/penalty._va_weights, term for term
          float tvx = 0.0f, tvy = 0.0f, tvz = 0.0f;
          float cost_v = 0.0f, cost_a = 0.0f;
          if (use_v) {
            const float cvx =
                prm.alpha_v * expf((fabsf(vx) - prm.v0) / prm.r_v);
            const float cvy =
                prm.alpha_v * expf((fabsf(vy) - prm.v0) / prm.r_v);
            const float cvz =
                prm.alpha_v * expf((fabsf(vz) - prm.v0) / prm.r_v);
            float gvx = cvx / prm.r_v, gvy = cvy / prm.r_v, gvz = cvz / prm.r_v;
            const float sum_cv = cvx + cvy + cvz;
            cost_v = sum_cv * vn;
            float cfac = cvz;  // reference: the last axis's stale cv
            if (!prm.ref_grad) {
              gvx *= sgn(vx);
              gvy *= sgn(vy);
              gvz *= sgn(vz);
              cfac = sum_cv;
            }
            tvx = gvx * vn + cfac * vx / vn;
            tvy = gvy * vn + cfac * vy / vn;
            tvz = gvz * vn + cfac * vz / vn;
          }
          if (va_a) {
            const float cax =
                prm.alpha_a * expf((fabsf(ax) - prm.a0) / prm.r_a);
            const float cay =
                prm.alpha_a * expf((fabsf(ay) - prm.a0) / prm.r_a);
            const float caz =
                prm.alpha_a * expf((fabsf(az) - prm.a0) / prm.r_a);
            float gax = cax / prm.r_a, gay = cay / prm.r_a, gaz = caz / prm.r_a;
            const float sum_ca = cax + cay + caz;
            cost_a = sum_ca * vn;
            float cafac = caz;
            if (!prm.ref_grad) {
              gax *= sgn(ax);
              gay *= sgn(ay);
              gaz *= sgn(az);
              cafac = sum_ca;
            }
            tvx = tvx + cafac * vx / vn;
            tvy = tvy + cafac * vy / vn;
            tvz = tvz + cafac * vz / vn;
            w3x = (gax * vn) * my_dt;
            w3y = (gay * vn) * my_dt;
            w3z = (gaz * vn) * my_dt;
          }
          part_va += (cost_v + cost_a) * my_dt;
          w2x = w2x + tvx * my_dt;
          w2y = w2y + tvy * my_dt;
          w2z = w2z + tvz * my_dt;
        }
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float a = cA[q * slots + sl], v = cV[q * slots + sl];
          gp[3 * q] += a * w1x + v * w2x;
          gp[3 * q + 1] += a * w1y + v * w2y;
          gp[3 * q + 2] += a * w1z + v * w2z;
          if (va_a) {
            const float c = cC[q * slots + sl];
            gp[3 * q] += c * w3x;
            gp[3 * q + 1] += c * w3y;
            gp[3 * q + 2] += c * w3z;
          }
        }
      }
    }
    // 18 independent xor trees over the group's G lanes
    for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < 18; ++i)
        gp[i] += __shfl_xor_sync(0xffffffffu, gp[i], o);
    }
    if (gl == 0 && sampler) {
#pragma unroll
      for (int i = 0; i < 18; ++i) Sg[seg * 18 + i] = gp[i];
    }
    part_s = warp_sum(part_s);
    part_c = warp_sum(part_c);
    part_va = warp_sum(part_va);
    if (lane == 0) {
      red[3 * wid] = part_s;
      red[3 * wid + 1] = part_c;
      red[3 * wid + 2] = part_va;
    }
    __syncthreads();  // (2)
    float ss = 0.0f, sc = 0.0f, sv = 0.0f;
    for (int w = 0; w < nw; ++w) {
      ss += red[3 * w];
      sc += red[3 * w + 1];
      sv += red[3 * w + 2];
    }
    float cost = ws * (c_ff + ss) + prm.w_collision * sc + prm.cost_eps;
    if (va) cost = cost + sv;
    if (entry) {
      float g = gs + (Sg[e_lo] + Sg[e_hi]);
      if (prm.ref_grad) g += prm.grad_eps;
      gout = g;
    }
    return cost;
  };

  int off = 0, n_acc = 0;
  float best_c = 0.0f;
  for (int ph = 0; ph < prm.n_phases; ++ph) {
    const int iters = prm.phase_iters[ph];
    const float ws = prm.phase_step[ph] == 1 ? 0.0f : prm.w_smooth;
    const bool va = prm.phase_step[ph] == 2 && (use_v || use_a);
    if (entry) x[t] = e_dp;
    __syncthreads();
    float e_gr = 0.0f;
    const float c0 = evaluate(ws, va, e_gr);
    const float gg = warp_sum(entry ? e_gr * e_gr : 0.0f);
    if (lane == 0) red2[wid] = gg;
    for (int i = t; i < prm.window; i += nt) hist[i] = c0;
    __syncthreads();
    float gsum = 0.0f;
    for (int w = 0; w < nw; ++w) gsum += red2[w];
    float lr = prm.lr0 / (sqrtf(gsum) + 1e-12f);
    float scale = 1.0f;
    int ptr = 0;
    best_c = c0;
    float e_best = e_dp, e_cand = 0.0f;
    if (entry) {
      e_cand = fminf(fmaxf(e_dp - (lr * scale) * e_gr, e_lb), e_ub);
      x[t] = e_cand;
    }
    for (int it = 0; it < iters; ++it) {
      __syncthreads();  // (1)
      float e_g2 = 0.0f;
      const float c2 = evaluate(ws, va, e_g2);
      float hmax = hist[0];
      for (int i = 1; i < prm.window; ++i) hmax = fmaxf(hmax, hist[i]);
      float sv = 0.0f, yv = 0.0f;
      if (entry) {
        const float s_ = e_cand - e_dp, y_ = e_g2 - e_gr;
        sv = s_ * y_;
        yv = y_ * y_;
      }
      sv = warp_sum(sv);
      yv = warp_sum(yv);
      if (lane == 0) {
        red2[2 * wid] = sv;
        red2[2 * wid + 1] = yv;
      }
      __syncthreads();  // (3)
      float sy = 0.0f, yy = 0.0f;
      for (int w = 0; w < nw; ++w) {
        sy += red2[2 * w];
        yy += red2[2 * w + 1];
      }
      const bool acc = c2 < hmax;
      const float lr_bb =
          fminf(fmaxf(fabsf(sy) / fmaxf(yy, 1e-20f), prm.lr_min), prm.lr_max);
      if (acc) {
        lr = lr_bb;
        scale = 1.0f;
        if (t == 0) hist[ptr] = c2;
        ptr = (ptr + 1) % prm.window;
      } else {
        scale = fmaxf(scale * prm.lr_shrink, 1e-8f);
      }
      const bool imp = c2 < best_c;
      if (imp) best_c = c2;
      n_acc += acc ? 1 : 0;
      if (t == 0) otrace[b * prm.total_iters + off + it] = best_c;
      if (entry) {
        if (imp) e_best = e_cand;
        if (acc) {
          e_dp = e_cand;
          e_gr = e_g2;
        }
        e_cand = fminf(fmaxf(e_dp - (lr * scale) * e_gr, e_lb), e_ub);
        x[t] = e_cand;
      }
    }
    e_dp = e_best;  // the next phase starts from the best
    off += iters;
  }
  if (entry) odp[b * P3 + t] = e_dp;
  if (t == 0) {
    ocost[b] = best_c;
    onacc[b] = n_acc;
  }
}

int pow2ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

struct Plan {
  int spt, G, nt;
  size_t smem;
};

// Threads and shared memory for spt samples per thread (mirrored by
// ops/solve_cuda.launch_shape).
Plan make_plan(int m, int K, int window, bool use_a, int spt) {
  Plan pl;
  pl.spt = spt;
  pl.G = pow2ceil(K) / spt;
  const int P = 3 * m - 3, P3 = 3 * P;
  int nt = m * pl.G;
  if (nt < P3) nt = P3;
  if (nt < 32) nt = 32;
  pl.nt = (nt + 31) / 32 * 32;
  const size_t slots = static_cast<size_t>(spt) * pl.nt;
  const size_t floats = (use_a ? 19 : 13) * slots + P * P + 18 + P3 +
                        18 * m + window + 96 + 64 + 6 * m;
  pl.smem = floats * sizeof(float);
  return pl;
}

// shared memory a block may use on sm_90, less K3's static lookup frame
constexpr size_t kMaxSmem = 232448 - sizeof(GtoFrame);

// The plan for B scenarios: among spt = 2^k with groups of at most 32
// lanes and at most 1024 threads, the fewest waves of resident blocks,
// then the fewest samples per thread.  out: spt, threads, shared bytes,
// resident blocks per SM, SMs.
cudaError_t choose_plan(int m, int K, int window, bool use_a, int B,
                        int* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int kp = pow2ceil(K);
  long long best_waves = -1;
  for (int spt = kp > 32 ? kp / 32 : 1; spt <= kp; spt <<= 1) {
    const Plan pl = make_plan(m, K, window, use_a, spt);
    if (pl.nt > 1024 || pl.smem > kMaxSmem) continue;
    e = cudaFuncSetAttribute(descend_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, descend_kernel,
                                                      pl.nt, pl.smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) continue;
    const long long resident = static_cast<long long>(per_sm) * sms;
    const long long waves = (B + resident - 1) / resident;
    if (best_waves < 0 || waves < best_waves) {
      best_waves = waves;
      out[0] = spt;
      out[1] = pl.nt;
      out[2] = static_cast<int>(pl.smem);
      out[3] = per_sm;
      out[4] = sms;
    }
    if (waves <= 1) break;
  }
  return best_waves < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The largest block descend_kernel keeps resident on this card: its
// maxThreadsPerBlock (what its registers allow), lowered in whole warps
// until the occupancy API finds room for one block an SM.
cudaError_t resident_threads(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, descend_kernel);
  if (e != cudaSuccess) return e;
  int nt = fa.maxThreadsPerBlock / 32 * 32;
  for (; nt >= 32; nt -= 32) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, descend_kernel,
                                                      nt, 0);
    if (e != cudaSuccess) return e;
    if (per_sm >= 1) break;
  }
  *out = nt;
  return cudaSuccess;
}

}  // namespace

// K3's launch limits, for the dispatch rule's constants
// (ops/solve_cuda.MAX_SMEM, MAX_THREADS).  out: kMaxSmem,
// sizeof(GtoFrame), the kernel's registers a thread, its
// maxThreadsPerBlock, and the largest resident block (resident_threads).
extern "C" int gto_descend_limits(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, descend_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<int>(kMaxSmem);
  out[1] = static_cast<int>(sizeof(GtoFrame));
  out[2] = fa.numRegs;
  out[3] = fa.maxThreadsPerBlock;
  return static_cast<int>(resident_threads(out + 4));
}

// The launch plan gto_descend takes for these shapes (see choose_plan).
extern "C" int gto_descend_plan(int m, int K, int window, int use_a, int B,
                                int* out) {
  return static_cast<int>(choose_plan(m, K, window, use_a != 0, B, out));
}

// fparams: w_smooth w_collision alpha d0 r vel_eps cost_eps grad_eps
//          lr0 lr_shrink lr_min lr_max alpha_v v0 r_v alpha_a a0 r_a
// cpos/cvel/cacc: (B, SP, 6) compact chains, ccols (m, 6) their columns;
// cacc is read only when alpha_a != 0
// iparams: ref_grad window n_phases total_iters, then n_phases
//          (step, iters) pairs
extern "C" int gto_descend(const float* grids, long long grid_stride, int nx,
                           int ny, int nz, const float* cpos,
                           const float* cvel, const float* cacc,
                           const int* ccols, const float* rpp,
                           const float* cgt, const float* lbT,
                           const float* ubT, const float* dp0T,
                           const float* dts, const float* dfT,
                           const float* misc, int B, int SP, int m, int K,
                           const float* fparams, const int* iparams,
                           float* odp, float* ocost, int* onacc,
                           float* otrace, void* stream) {
  if (B <= 0) return 0;
  DescendParams prm;
  prm.w_smooth = fparams[0];
  prm.w_collision = fparams[1];
  prm.alpha = fparams[2];
  prm.d0 = fparams[3];
  prm.r = fparams[4];
  prm.vel_eps = fparams[5];
  prm.cost_eps = fparams[6];
  prm.grad_eps = fparams[7];
  prm.lr0 = fparams[8];
  prm.lr_shrink = fparams[9];
  prm.lr_min = fparams[10];
  prm.lr_max = fparams[11];
  prm.alpha_v = fparams[12];
  prm.v0 = fparams[13];
  prm.r_v = fparams[14];
  prm.alpha_a = fparams[15];
  prm.a0 = fparams[16];
  prm.r_a = fparams[17];
  if (prm.alpha_a != 0.0f && cacc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  prm.ref_grad = iparams[0];
  prm.window = iparams[1];
  prm.n_phases = iparams[2];
  prm.total_iters = iparams[3];
  if (prm.n_phases < 1 || prm.n_phases > GTO_MAX_PHASES || prm.window < 1 ||
      m < 2 || K < 1 || m * K > SP)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < prm.n_phases; ++i) {
    prm.phase_step[i] = iparams[4 + 2 * i];
    prm.phase_iters[i] = iparams[5 + 2 * i];
  }
  int plan[5];
  const cudaError_t e =
      choose_plan(m, K, prm.window, prm.alpha_a != 0.0f, B, plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int spt = plan[0], nt = plan[1];
  const size_t smem = static_cast<size_t>(plan[2]);
  const int G = pow2ceil(K) / spt;
  // choose_plan may have tried a larger plan last
  const cudaError_t ea = cudaFuncSetAttribute(
      descend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (ea != cudaSuccess) return static_cast<int>(ea);
  descend_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      grids, grid_stride, nx, ny, nz, cpos, cvel, cacc, ccols, rpp, cgt, lbT,
      ubT, dp0T, dts, dfT, misc, SP, m, K, G, spt, prm, odp, ocost, onacc,
      otrace);
  return static_cast<int>(cudaGetLastError());
}
