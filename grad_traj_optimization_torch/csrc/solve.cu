// K3: one scenario's whole projected Barzilai-Borwein descent per block.
//
// Replaces grad_traj_optimization_tpu/ops/solve_pallas.py::_solve_kernel
// (launched by descend_fused).  Wrapper: ops/solve_cuda.py; inputs come
// from solver.kernel_inputs in the JAX package's layouts.
//
// Each iteration evaluates the candidate's cost and gradient:
//   pos/vel = A_pos/A_vel @ [Df; dp]            one sample per thread
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
// Design: one block per scenario, one thread per sample row (blockDim =
// the padded sample count rounded up to a warp).  The sampling chains
// A_pos and A_vel (SP x ndim each, 31 KB at bench shape) sit in shared
// memory column-major, so thread s reads row s conflict-free, for all
// iterations.  [TL^T | TVL^T] are the dp columns of those same chains
// (kernel_inputs builds tltv from them), so the gradient reads them there
// instead of a second copy; with alpha_a != 0 the acceleration chain A_acc
// is one more column-major block whose dp columns serve as TAL^T.  Each of
// the P*3 gradient entries is one warp's strided sum over samples, reduced
// with shuffles.  The cost is one more
// block sum; the BB scalars are computed redundantly by every thread from
// block sums, so no thread waits on a broadcast.
//
// Bound: latency.  Per iteration a block runs ~ndim*6 FMAs and one lookup
// per thread, ~P*3/warps strided sums per warp and four barriers; the grid
// stays in device memory and its corners come through L1/L2 (1 MB at
// bench shape, 4 MB at the opti_node map, both far above a block's
// 227 KB of shared memory).  The design keeps every per-iteration operand
// on chip so the only device-memory traffic per iteration is the eight
// corner loads per sample.
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

// Sums of a, b and c over the block, the same values in every thread.
__device__ float3 block_sum3(float a, float b, float c, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) {
    red[3 * wid] = a;
    red[3 * wid + 1] = b;
    red[3 * wid + 2] = c;
  }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f, sc = 0.0f;
  for (int w = 0; w < nw; ++w) {
    sa += red[3 * w];
    sb += red[3 * w + 1];
    sc += red[3 * w + 2];
  }
  return make_float3(sa, sb, sc);
}

__device__ float2 block_sum2(float a, float b, float* red) {
  const float3 s = block_sum3(a, b, 0.0f, red);
  return make_float2(s.x, s.y);
}

// sign(x) with sign(0) = 0, as torch.sign
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

__global__ void descend_kernel(
    const float* __restrict__ grids, long long grid_stride, int nx, int ny,
    int nz, const float* __restrict__ apos, const float* __restrict__ avel,
    const float* __restrict__ rpp, const float* __restrict__ cgt,
    const float* __restrict__ lbT, const float* __restrict__ ubT,
    const float* __restrict__ dp0T, const float* __restrict__ dts,
    const float* __restrict__ dfT, const float* __restrict__ misc,
    const float* __restrict__ aacc, int SP, int ndim, DescendParams prm,
    float* __restrict__ odp,
    float* __restrict__ ocost, int* __restrict__ onacc,
    float* __restrict__ otrace) {
  extern __shared__ float sm[];
  const int P = ndim - 6, P3 = 3 * P;
  const int nt = blockDim.x;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5, nw = nt >> 5;
  const long long b = blockIdx.x;

  const bool use_v = prm.alpha_v != 0.0f, use_a = prm.alpha_a != 0.0f;
  const int n_w = use_a ? 9 : 6;
  float* A = sm;               // ndim x nt, column j at A + j * nt
  float* V = A + ndim * nt;    // ndim x nt
  float* C = V + ndim * nt;    // ndim x nt acceleration chain (alpha_a only)
  float* Wt = C + (use_a ? ndim * nt : 0);
  // n_w x nt: wc*w1 (x,y,z), wc*w2 + w_tvl dt (x,y,z), w_tal dt (x,y,z)
  float* R = Wt + n_w * nt;    // P x P
  float* cg = R + P * P;       // P3 each, dpT layout (p * 3 + axis)
  float* lb = cg + P3;
  float* ub = lb + P3;
  float* dp = ub + P3;
  float* gr = dp + P3;
  float* cand = gr + P3;
  float* g2 = cand + P3;
  float* best = g2 + P3;
  float* zz = best + P3;       // Rpp @ x of the last evaluation
  float* df = zz + P3;         // 6 x 3
  float* hist = df + 18;       // accept_window
  float* red = hist + prm.window;  // 3 x 32

  const float* ap = apos + b * SP * ndim;
  const float* av = avel + b * SP * ndim;
  for (int i = t; i < SP * ndim; i += nt) {
    const int s = i / ndim, j = i - s * ndim;
    A[j * nt + s] = ap[i];
    V[j * nt + s] = av[i];
  }
  if (t >= SP) {
    for (int j = 0; j < ndim; ++j) A[j * nt + t] = V[j * nt + t] = 0.0f;
  }
  if (use_a) {
    const float* ac = aacc + b * SP * ndim;
    for (int i = t; i < SP * ndim; i += nt) {
      const int s = i / ndim, j = i - s * ndim;
      C[j * nt + s] = ac[i];
    }
    if (t >= SP) {
      for (int j = 0; j < ndim; ++j) C[j * nt + t] = 0.0f;
    }
  }
  for (int i = t; i < P * P; i += nt) R[i] = rpp[b * P * P + i];
  for (int i = t; i < P3; i += nt) {
    cg[i] = cgt[b * P3 + i];
    lb[i] = lbT[b * P3 + i];
    ub[i] = ubT[b * P3 + i];
    dp[i] = fminf(fmaxf(dp0T[b * P3 + i], lb[i]), ub[i]);
  }
  for (int i = t; i < 18; i += nt) df[i] = dfT[b * 18 + i];
  const float my_dt = t < SP ? dts[b * SP + t] : 0.0f;
  const float ox = misc[b * 16], oy = misc[b * 16 + 1],
              oz = misc[b * 16 + 2], res = misc[b * 16 + 3],
              c_ff = misc[b * 16 + 4];
  const float* grid = grids + b * grid_stride;
  const bool collide = fabsf(prm.w_collision) >= 1e-4f;  // reference :346
  __syncthreads();

  // cost at x (shared, dpT layout); gradient into gout (shared).  va:
  // this phase adds the velocity/acceleration penalties (step 2 only).
  auto evaluate = [&](const float* x, float ws, bool va,
                      float* gout) -> float {
    const bool va_a = va && use_a;
    float part_s = 0.0f, part_c = 0.0f, part_va = 0.0f;
    if (t < P3) {
      const int p = t / 3, k = t - 3 * p;
      float z = 0.0f;
      for (int q = 0; q < P; ++q) z += R[p * P + q] * x[3 * q + k];
      zz[t] = z;
      part_s = cg[t] * x[t] + x[t] * z;
    }
    if (collide) {
      if (t < SP) {
        float px = 0.0f, py = 0.0f, pz = 0.0f;
        float vx = 0.0f, vy = 0.0f, vz = 0.0f;
        float ax = 0.0f, ay = 0.0f, az = 0.0f;
        for (int j = 0; j < ndim; ++j) {
          const float* dj = j < 6 ? df + 3 * j : x + 3 * (j - 6);
          const float a = A[j * nt + t], v = V[j * nt + t];
          px += a * dj[0];
          py += a * dj[1];
          pz += a * dj[2];
          vx += v * dj[0];
          vy += v * dj[1];
          vz += v * dj[2];
          if (va_a) {
            const float c = C[j * nt + t];
            ax += c * dj[0];
            ay += c * dj[1];
            az += c * dj[2];
          }
        }
        float d, gx, gy, gz;
        gto_trilinear(grid, nx, ny, nz, ox, oy, oz, res, px, py, pz, &d, &gx,
                      &gy, &gz);
        const float cd = prm.alpha * expf(-(d - prm.d0) / prm.r);
        const float gd = -cd / prm.r;
        const float vn = sqrtf(vx * vx + vy * vy + vz * vz) + prm.vel_eps;
        part_c = cd * vn * my_dt;
        const float w_dist = prm.ref_grad ? gd * cd * vn : gd * vn;
        const float f1 = w_dist * my_dt, f2 = (cd / vn) * my_dt;
        const float wc = prm.w_collision;
        Wt[t] = wc * (f1 * gx);
        Wt[nt + t] = wc * (f1 * gy);
        Wt[2 * nt + t] = wc * (f1 * gz);
        float w2x = wc * (f2 * vx), w2y = wc * (f2 * vy), w2z = wc * (f2 * vz);
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
            Wt[6 * nt + t] = (gax * vn) * my_dt;
            Wt[7 * nt + t] = (gay * vn) * my_dt;
            Wt[8 * nt + t] = (gaz * vn) * my_dt;
          }
          part_va = (cost_v + cost_a) * my_dt;
          w2x = w2x + tvx * my_dt;
          w2y = w2y + tvy * my_dt;
          w2z = w2z + tvz * my_dt;
        }
        Wt[3 * nt + t] = w2x;
        Wt[4 * nt + t] = w2y;
        Wt[5 * nt + t] = w2z;
      } else {
        for (int c = 0; c < n_w; ++c) Wt[c * nt + t] = 0.0f;
      }
    }
    // zz and Wt visible after the barriers inside
    const float3 s = block_sum3(part_s, part_c, part_va, red);
    float cost = ws * (c_ff + s.x) + prm.w_collision * s.y + prm.cost_eps;
    if (va) cost = cost + s.z;
    for (int o = wid; o < P3; o += nw) {
      const int p = o / 3, k = o - 3 * p;
      float acc = 0.0f;
      if (collide) {
        const float* ac = A + (6 + p) * nt;
        const float* vc = V + (6 + p) * nt;
        const float* w1 = Wt + k * nt;
        const float* w2 = Wt + (3 + k) * nt;
        if (va_a) {
          const float* cc = C + (6 + p) * nt;
          const float* w3 = Wt + (6 + k) * nt;
          for (int s2 = lane; s2 < SP; s2 += 32)
            acc += ac[s2] * w1[s2] + vc[s2] * w2[s2] + cc[s2] * w3[s2];
        } else {
          for (int s2 = lane; s2 < SP; s2 += 32)
            acc += ac[s2] * w1[s2] + vc[s2] * w2[s2];
        }
        acc = warp_sum(acc);
      }
      if (lane == 0) {
        float g = ws * (cg[o] + 2.0f * zz[o]) + acc;
        if (prm.ref_grad) g += prm.grad_eps;
        gout[o] = g;
      }
    }
    __syncthreads();
    return cost;
  };

  int off = 0, n_acc = 0;
  float best_c = 0.0f;
  for (int ph = 0; ph < prm.n_phases; ++ph) {
    const int iters = prm.phase_iters[ph];
    const float ws = prm.phase_step[ph] == 1 ? 0.0f : prm.w_smooth;
    const bool va = prm.phase_step[ph] == 2 && (use_v || use_a);
    const float c0 = evaluate(dp, ws, va, gr);
    const float gg = t < P3 ? gr[t] * gr[t] : 0.0f;
    const float gnorm = sqrtf(block_sum2(gg, 0.0f, red).x);
    float lr = prm.lr0 / (gnorm + 1e-12f);
    float scale = 1.0f;
    int ptr = 0;
    best_c = c0;
    for (int i = t; i < prm.window; i += nt) hist[i] = c0;
    if (t < P3) best[t] = dp[t];
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      const float step = lr * scale;
      if (t < P3) cand[t] = fminf(fmaxf(dp[t] - step * gr[t], lb[t]), ub[t]);
      __syncthreads();
      const float c2 = evaluate(cand, ws, va, g2);
      float hmax = hist[0];
      for (int i = 1; i < prm.window; ++i) hmax = fmaxf(hmax, hist[i]);
      const bool acc = c2 < hmax;
      float sv = 0.0f, yv = 0.0f;
      if (t < P3) {
        const float s_ = cand[t] - dp[t], y_ = g2[t] - gr[t];
        sv = s_ * y_;
        yv = y_ * y_;
      }
      const float2 sy = block_sum2(sv, yv, red);  // hist reads are done
      const float lr_bb = fminf(
          fmaxf(fabsf(sy.x) / fmaxf(sy.y, 1e-20f), prm.lr_min), prm.lr_max);
      if (acc) {
        lr = lr_bb;
        scale = 1.0f;
        if (t == 0) hist[ptr] = c2;
        ptr = (ptr + 1) % prm.window;
      } else {
        scale = fmaxf(scale * prm.lr_shrink, 1e-8f);
      }
      const bool imp = c2 < best_c;
      if (t < P3) {
        if (imp) best[t] = cand[t];
        if (acc) {
          dp[t] = cand[t];
          gr[t] = g2[t];
        }
      }
      if (imp) best_c = c2;
      n_acc += acc ? 1 : 0;
      if (t == 0) otrace[b * prm.total_iters + off + it] = best_c;
      __syncthreads();
    }
    if (t < P3) dp[t] = best[t];  // the next phase starts from the best
    __syncthreads();
    off += iters;
  }
  for (int i = t; i < P3; i += nt) odp[b * P3 + i] = dp[i];
  if (t == 0) {
    ocost[b] = best_c;
    onacc[b] = n_acc;
  }
}

}  // namespace

// fparams: w_smooth w_collision alpha d0 r vel_eps cost_eps grad_eps
//          lr0 lr_shrink lr_min lr_max alpha_v v0 r_v alpha_a a0 r_a
// aacc: (B, SP, ndim) acceleration chain, read only when alpha_a != 0
// iparams: ref_grad window n_phases total_iters, then n_phases
//          (step, iters) pairs
extern "C" int gto_descend(const float* grids, long long grid_stride, int nx,
                           int ny, int nz, const float* apos,
                           const float* avel, const float* rpp,
                           const float* cgt, const float* lbT,
                           const float* ubT, const float* dp0T,
                           const float* dts, const float* dfT,
                           const float* misc, const float* aacc, int B,
                           int SP, int ndim,
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
  if (prm.alpha_a != 0.0f && aacc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  prm.ref_grad = iparams[0];
  prm.window = iparams[1];
  prm.n_phases = iparams[2];
  prm.total_iters = iparams[3];
  if (prm.n_phases < 1 || prm.n_phases > GTO_MAX_PHASES || prm.window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < prm.n_phases; ++i) {
    prm.phase_step[i] = iparams[4 + 2 * i];
    prm.phase_iters[i] = iparams[5 + 2 * i];
  }
  const int P = ndim - 6, P3 = 3 * P;
  int nt = SP > P3 ? SP : P3;
  nt = ((nt > 32 ? nt : 32) + 31) / 32 * 32;
  if (nt > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chain = prm.alpha_a != 0.0f ? 3 : 2;
  const int n_w = prm.alpha_a != 0.0f ? 9 : 6;
  const size_t floats = static_cast<size_t>(n_chain * ndim + n_w) * nt +
                        P * P + 9 * P3 + 18 + prm.window + 96;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        descend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  descend_kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      grids, grid_stride, nx, ny, nz, apos, avel, rpp, cgt, lbT, ubT, dp0T,
      dts, dfT, misc, aacc, SP, ndim, prm, odp, ocost, onacc, otrace);
  return static_cast<int>(cudaGetLastError());
}
