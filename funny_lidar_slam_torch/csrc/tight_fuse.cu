// The per-frame 30-dof tight-fusion solve, one thread block per call:
// the factor assembly, the Levenberg-Marquardt loop, a fresh posterior
// assembly at the optimum, the Schur marginalization of the old state and
// the projection of the new prior onto the PSD cone.
//
// Replaces the `lax.while_loop` LM and its tail in
// funny_lidar_slam_tpu/fusion/tight.py (`fuse`); the plain version is
// fusion/tight.py::fuse_plain, whose steps this kernel follows one for one
// but for the one deliberate deviation marked below:
//   * six factors (prior 15, lidar rotation 3, lidar position 3,
//     preintegration 9, two bias random walks 3 + 3) assembled into the
//     30x30 H, b and the cost, H symmetrized as 0.5 (H + H^T); the
//     preintegration information inv(cov + 1e-16 I) is inverted once
//     (Gauss-Jordan with partial pivoting, no singularity check, as
//     `inv_ex` has none);
//   * LM: Jacobi scaling d = rsqrt(max(diag H, 1e-12)), (Hs + lambda I) y =
//     -b d by LU with partial pivoting (the f32 Schur prior can be slightly
//     indefinite, so no Cholesky), dx = d y, right-perturbation trial state,
//     a strict `cost_try < cost` accept, lambda halved (floor 1e-6) or
//     multiplied by 8 (ceiling 1e2), exit on (accept & |dx| < 1e-6) |
//     (reject & lambda >= 1e2) or after `iterations`; the exit is a branch
//     on values in shared memory, uniform over the block, with no host read;
//   * `marginalize(H, 0, 14)[15:, 15:]`: the 15x15 old-state block Jacobi
//     scaled (rsqrt(max(diag, 1e-24))) and pseudo-inverted with |eigenvalues|
//     below 1e-6 dropped (for a symmetric block this equals the SVD
//     pseudo-inverse with singular values below 1e-6 dropped), then the
//     Schur complement. DEVIATION: the pseudo-inverse is refined by one
//     Newton-Schulz step P <- P (2I - A P), which neither the plain nor the
//     JAX version takes (their SVD is accurate enough without it; this
//     float32 Jacobi solve is not, see the kernel body);
//   * symmetrize, eigendecompose, V max(w, 0) V^T.
// Both eigenproblems use one cyclic (round-robin) Jacobi solver in shared
// memory: seven disjoint rotations a round, 15 rounds a sweep, a relative
// off-diagonal test, at most kSweeps sweeps. The count of sweeps that
// rotated in each solve goes to the output: kSweeps means it stopped
// unconverged.
//
// Bound: a few hundred thousand operations a call on ~2.7 KB of input and
// output, so neither bytes nor operations bound it on this card; the chain
// of dependent steps does (30 pivot steps a solve, 15 Jacobi rounds a
// sweep, a barrier each). The design keeps every matrix in shared memory
// and runs the whole solve in one launch, where the plain version makes
// hundreds of launches an iteration and a host read after each.
//
// Layouts (float32, packed by ops/recurrences.py):
//   input:  last r[9] v[3] p[3] bg[3] ba[3] info[225] | pre d_r[9] d_v[3]
//           d_p[3] cov[81] dr_dbg[9] dv_dbg[9] dv_dba[9] dp_dbg[9]
//           dp_dba[9] dt[1] bg[3] ba[3] | lidar pose[16] (4x4) |
//           predicted r[9] v[3] p[3]
//   output: r[9] v[3] p[3] bg[3] ba[3] info[225] iterations[1]
//           sweeps[2] (the marginalization's and the projection's)
// Gravity, the iteration count and the four factor variances come by value.

#include <cuda_runtime.h>

#include "so3.cuh"

namespace {

enum {
  I_LR = 0, I_LV = 9, I_LP = 12, I_LBG = 15, I_LBA = 18, I_INFO = 21,
  I_PRE = 246, I_POSE = 394, I_PR = 410, I_PV = 419, I_PP = 422, I_SIZE = 425
};
// offsets inside the preintegration block
enum {
  P_DR = 0, P_DV = 9, P_DP = 12, P_COV = 15, P_DR_DBG = 96, P_DV_DBG = 105,
  P_DV_DBA = 114, P_DP_DBG = 123, P_DP_DBA = 132, P_DT = 141, P_BG = 142, P_BA = 145
};
enum { O_R = 0, O_V = 9, O_P = 12, O_BG = 15, O_BA = 18, O_INFO = 21, O_ITERS = 246, O_SWEEPS = 247 };
// the 30-dof state: [R_i V_i P_i bg_i ba_i R_j V_j P_j bg_j ba_j]
enum {
  S_RI = 0, S_VI = 9, S_PI = 12, S_BGI = 15, S_BAI = 18, S_RJ = 21, S_VJ = 30, S_PJ = 33,
  S_BGJ = 36, S_BAJ = 39, S_SIZE = 42
};

constexpr int kThreads = 256;
constexpr int kRows = 36;   // stacked residual rows of the six factors
constexpr int kDim = 30;
constexpr int kLd = 31;     // the augmented [Hs + lambda I | rhs]
constexpr int kN = 15;      // eigenproblems
constexpr int kE = 16;      // their leading dimension
constexpr int kSweeps = 12;
constexpr float kJacobiTol = 2.4e-7f;  // two float32 ulps of sqrt(|a_pp a_qq|)
__constant__ int kFactorRow[7] = {0, 15, 18, 21, 30, 33, 36};

// one Jacobi rotation of the pair (p, q) and the 2x2 block it zeroes
struct Rot {
  int p, q;
  float c, s, t, app, aqq, apq;
};

struct Smem {
  float in[I_SIZE];
  float g[3], lr[9], lp[3];
  float lam9[81];
  float st[2][S_SIZE];
  float jac[kRows * kDim];
  float err[kRows];
  float lj[kRows * kDim];
  float le[kRows];
  float h[2][kDim * kDim];
  float b[2][kDim];
  float cost[2];
  float m[kDim * kLd];
  float dinv[kDim];
  float dx[kDim];
  float ea[kE * kE], ev[kE * kE];
  Rot rot[8];
  float w[kN], x[kN * kN], pinv[kN * kN];
  float lm_lambda;
  int accept, done, tiny, flag;
};

__device__ inline void put3(float* jac, int row, int col, const float* blk,
                            float scale = 1.f) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) jac[(row + i) * kDim + col + j] = scale * blk[3 * i + j];
}

// the preintegration factor: rows 21..29 of jac and err
__device__ void preint_factor(Smem& sm, const float* s) {
  const float* pre = sm.in + I_PRE;
  const float* ri = s + S_RI;
  const float* rj = s + S_RJ;
  const float dt = pre[P_DT];
  const float* g = sm.g;
  float dbg[3], dba[3];
  for (int c = 0; c < 3; ++c) {
    dbg[c] = s[S_BGI + c] - pre[P_BG + c];
    dba[c] = s[S_BAI + c] - pre[P_BA + c];
  }
  float t1[3], ex[9], cdr[9], m1[9], m2[9], er[3];
  so3::mv(pre + P_DR_DBG, dbg, t1);
  so3::exp(t1, ex);
  so3::mul(pre + P_DR, ex, cdr);
  for (int i = 0; i < 3; ++i)  // corrected_dr^T r_i^T
    for (int j = 0; j < 3; ++j)
      m1[3 * i + j] = cdr[i] * ri[3 * j] + cdr[3 + i] * ri[3 * j + 1]
                      + cdr[6 + i] * ri[3 * j + 2];
  so3::mul(m1, rj, m2);
  so3::log(m2, er);
  float dvw[3], dpw[3], a[3], bb[3], u1[3], u2[3], u3[3], u4[3];
  for (int c = 0; c < 3; ++c) {
    dvw[c] = s[S_VJ + c] - s[S_VI + c] - g[c] * dt;
    dpw[c] = s[S_PJ + c] - s[S_PI + c] - s[S_VI + c] * dt - 0.5f * g[c] * dt * dt;
  }
  so3::mtv(ri, dvw, a);
  so3::mtv(ri, dpw, bb);
  so3::mv(pre + P_DV_DBG, dbg, u1);
  so3::mv(pre + P_DV_DBA, dba, u2);
  so3::mv(pre + P_DP_DBG, dbg, u3);
  so3::mv(pre + P_DP_DBA, dba, u4);
  float* err = sm.err + 21;
  for (int c = 0; c < 3; ++c) {
    err[c] = er[c];
    err[3 + c] = a[c] - (pre[P_DV + c] + u1[c] + u2[c]);
    err[6 + c] = bb[c] - (pre[P_DP + c] + u3[c] + u4[c]);
  }
  float jri[9], nj[9], t2[9], blk[9], rit[9], ha[9], hb[9];
  so3::jr_inv(er, jri);
  for (int k = 0; k < 9; ++k) {
    nj[k] = -jri[k];
    rit[k] = ri[3 * (k % 3) + k / 3];
  }
  so3::mul_nt(nj, rj, t2);
  so3::mul(t2, ri, blk);
  so3::hat(a, ha);
  so3::hat(bb, hb);
  float* jac = sm.jac;
  put3(jac, 21, 0, blk);
  put3(jac, 24, 0, ha);
  put3(jac, 27, 0, hb);
  put3(jac, 24, 3, rit, -1.f);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) jac[(27 + i) * kDim + 3 + j] = -rit[3 * i + j] * dt;
  put3(jac, 27, 6, rit, -1.f);
  float eer[9], t3[9], jrt[9], t4[9], t5[9];
  so3::exp(er, eer);
  so3::mul_nt(nj, eer, t3);
  so3::jr(t1, jrt);
  so3::mul(t3, jrt, t4);
  so3::mul(t4, pre + P_DR_DBG, t5);
  put3(jac, 21, 9, t5);
  put3(jac, 24, 9, pre + P_DV_DBG, -1.f);
  put3(jac, 27, 9, pre + P_DP_DBG, -1.f);
  put3(jac, 24, 12, pre + P_DV_DBA, -1.f);
  put3(jac, 27, 12, pre + P_DP_DBA, -1.f);
  put3(jac, 21, 15, jri);
  put3(jac, 24, 18, rit);
  put3(jac, 27, 21, rit);
}

// residuals and the state-dependent Jacobian blocks of factor f (one thread)
__device__ void factor(Smem& sm, int f, const float* s) {
  float* err = sm.err;
  if (f == 0) {  // prior on the last state: measure (-) estimate
    float m[9], e[3], j[9];
    so3::mul_tn(sm.in + I_LR, s + S_RI, m);
    so3::log(m, e);
    so3::jr_inv(e, j);
    for (int c = 0; c < 3; ++c) {
      err[c] = e[c];
      err[3 + c] = sm.in[I_LV + c] - s[S_VI + c];
      err[6 + c] = sm.in[I_LP + c] - s[S_PI + c];
      err[9 + c] = sm.in[I_LBG + c] - s[S_BGI + c];
      err[12 + c] = sm.in[I_LBA + c] - s[S_BAI + c];
    }
    put3(sm.jac, 0, 0, j);
  } else if (f == 1) {  // lidar rotation on R_j
    float m[9], e[3], j[9];
    so3::mul_tn(sm.lr, s + S_RJ, m);
    so3::log(m, e);
    so3::jr_inv(e, j);
    for (int c = 0; c < 3; ++c) err[15 + c] = e[c];
    put3(sm.jac, 15, 15, j);
  } else if (f == 2) {  // lidar position on P_j
    for (int c = 0; c < 3; ++c) err[18 + c] = sm.lp[c] - s[S_PJ + c];
  } else if (f == 3) {
    preint_factor(sm, s);
  } else if (f == 4) {  // gyro bias random walk
    for (int c = 0; c < 3; ++c) err[30 + c] = s[S_BGJ + c] - s[S_BGI + c];
  } else {  // accel bias random walk
    for (int c = 0; c < 3; ++c) err[33 + c] = s[S_BAJ + c] - s[S_BAI + c];
  }
}

// the Jacobian blocks that do not depend on the state
__device__ void constant_blocks(float* jac) {
  for (int k = 0; k < 12; ++k) jac[(3 + k) * kDim + 3 + k] = -1.f;  // prior V P bg ba
  for (int c = 0; c < 3; ++c) {
    jac[(18 + c) * kDim + 21 + c] = -1.f;  // lidar position
    jac[(30 + c) * kDim + 9 + c] = -1.f;   // gyro bias walk
    jac[(30 + c) * kDim + 24 + c] = 1.f;
    jac[(33 + c) * kDim + 12 + c] = -1.f;  // accel bias walk
    jac[(33 + c) * kDim + 27 + c] = 1.f;
  }
}

// H (symmetrized), b and the cost of state s into slot `out`
__device__ void assemble(Smem& sm, const float* s, int out, const float inv_var[4]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (lane == 0 && warp < 6) factor(sm, warp, s);
  __syncthreads();

  // lam J and lam e, factor by factor
  for (int e = tid; e < kRows * (kDim + 1); e += blockDim.x) {
    const int r = e / (kDim + 1), c = e % (kDim + 1);
    const float* col = (c < kDim) ? sm.jac + c : sm.err;
    const int stride = (c < kDim) ? kDim : 1;
    float v;
    if (r < 15) {
      v = 0.f;
      for (int m = 0; m < 15; ++m) v += sm.in[I_INFO + 15 * r + m] * col[m * stride];
    } else if (r >= 21 && r < 30) {
      v = 0.f;
      for (int m = 0; m < 9; ++m) v += sm.lam9[9 * (r - 21) + m] * col[(21 + m) * stride];
    } else {
      const float iv = inv_var[r < 18 ? 0 : r < 21 ? 1 : r < 33 ? 2 : 3];
      v = iv * col[r * stride];
    }
    if (c < kDim) sm.lj[r * kDim + c] = v;
    else sm.le[r] = v;
  }
  __syncthreads();

  // H = sum over factors of J^T (lam J), b, cost; 0.5 (H + H^T)
  float* h = sm.h[out];
  for (int e = tid; e < kDim * (kDim + 1) / 2 + kDim + 1; e += blockDim.x) {
    if (e < kDim * (kDim + 1) / 2) {
      int i = 0, rem = e;
      while (rem >= kDim - i) rem -= kDim - i++;
      const int j = i + rem;
      float hij = 0.f, hji = 0.f;
      for (int f = 0; f < 6; ++f) {
        float a = 0.f, c = 0.f;
        for (int r = kFactorRow[f]; r < kFactorRow[f + 1]; ++r) {
          a += sm.jac[r * kDim + i] * sm.lj[r * kDim + j];
          c += sm.jac[r * kDim + j] * sm.lj[r * kDim + i];
        }
        hij += a;
        hji += c;
      }
      const float sym = 0.5f * (hij + hji);
      h[i * kDim + j] = sym;
      h[j * kDim + i] = sym;
    } else if (e < kDim * (kDim + 1) / 2 + kDim) {
      const int i = e - kDim * (kDim + 1) / 2;
      float bi = 0.f;
      for (int f = 0; f < 6; ++f) {
        float a = 0.f;
        for (int r = kFactorRow[f]; r < kFactorRow[f + 1]; ++r)
          a += sm.jac[r * kDim + i] * sm.le[r];
        bi += a;
      }
      sm.b[out][i] = bi;
    } else {
      float cost = 0.f;
      for (int f = 0; f < 6; ++f) {
        float a = 0.f;
        for (int r = kFactorRow[f]; r < kFactorRow[f + 1]; ++r) a += sm.err[r] * sm.le[r];
        cost += a;
      }
      sm.cost[out] = cost;
    }
  }
  __syncthreads();
}

// (Hs + lambda I) y = -b d by LU with partial pivoting; dx = d y; sm.tiny
__device__ void lm_solve(Smem& sm, const float* h, const float* b, float lam) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kDim; i += blockDim.x)
    sm.dinv[i] = rsqrtf(fmaxf(h[i * kDim + i], 1e-12f));
  __syncthreads();
  float* m = sm.m;
  for (int e = tid; e < kDim * kLd; e += blockDim.x) {
    const int i = e / kLd, j = e % kLd;
    m[e] = (j < kDim) ? h[i * kDim + j] * sm.dinv[i] * sm.dinv[j] + (i == j ? lam : 0.f)
                      : -(b[i] * sm.dinv[i]);
  }
  __syncthreads();
  for (int k = 0; k < kDim; ++k) {
    if (warp == 0) {  // the pivot: the first row of largest |m_ik|, i >= k
      float v = (lane >= k && lane < kDim) ? fabsf(m[lane * kLd + k]) : -1.f;
      int idx = lane;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, idx, off);
        if (ov > v || (ov == v && oi < idx)) {
          v = ov;
          idx = oi;
        }
      }
      const int piv = __shfl_sync(0xffffffffu, idx, 0);
      if (piv != k && lane < kLd) {
        const float t = m[k * kLd + lane];
        m[k * kLd + lane] = m[piv * kLd + lane];
        m[piv * kLd + lane] = t;
      }
    }
    __syncthreads();
    const int w = kLd - k - 1;
    for (int e = tid; e < (kDim - k - 1) * w; e += blockDim.x) {
      const int i = k + 1 + e / w, j = k + 1 + e % w;
      m[i * kLd + j] -= (m[i * kLd + k] / m[k * kLd + k]) * m[k * kLd + j];
    }
    __syncthreads();
  }
  if (warp == 0) {  // back substitution, row i in lane i
    float y = (lane < kDim) ? m[lane * kLd + kDim] : 0.f;
    for (int k = kDim - 1; k >= 0; --k) {
      const float yk = __shfl_sync(0xffffffffu, y, k) / m[k * kLd + k];
      if (lane == k) y = yk;
      else if (lane < k) y -= m[lane * kLd + k] * yk;
    }
    const float dx = (lane < kDim) ? sm.dinv[lane] * y : 0.f;
    if (lane < kDim) sm.dx[lane] = dx;
    float sq = dx * dx;
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
    if (lane == 0) sm.tiny = sqrtf(sq) < 1e-6f;
  }
  __syncthreads();
}

// s_out = s (+) dx: right perturbation of the rotations, sums elsewhere
__device__ void apply_dx(Smem& sm, const float* s, float* s_out) {
  const int tid = threadIdx.x;
  if (tid == 0 || tid == 32) {
    const int off = tid == 0 ? S_RI : S_RJ, d = tid == 0 ? 0 : 15;
    float e[9];
    so3::exp(sm.dx + d, e);
    so3::mul(s + off, e, s_out + off);
  } else if (tid >= 64 && tid < 88) {
    const int k = tid - 64;
    const int off = k < 12 ? S_VI + k : S_VJ + k - 12;
    const int d = k < 12 ? 3 + k : 18 + k - 12;
    s_out[off] = s[off] + sm.dx[d];
  }
  __syncthreads();
}

// round r, slot k of the round-robin schedule of 15 indices (16 with a
// dummy 15): seven disjoint pairs a round, every pair once in 15 rounds
__device__ inline void rr_pair(int r, int k, int* p, int* q) {
  if (k == 0) {
    *p = r;
    *q = kN;
  } else {
    *p = (r + k) % kN;
    *q = (r - k + kN) % kN;
  }
}

// cyclic Jacobi eigensolver of the symmetric 15x15 `a` (leading dimension
// kE): on return diag(a) holds the eigenvalues and the columns of v the
// eigenvectors. Returns the sweeps that rotated (the same on every
// thread); kSweeps means the last sweep still rotated, i.e. no convergence.
__device__ int jacobi15(Smem& sm, float* a, float* v) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kE * kE; e += blockDim.x) v[e] = (e / kE == e % kE) ? 1.f : 0.f;
  __syncthreads();
  int sweep = 0;
  for (; sweep < kSweeps; ++sweep) {
    if (tid == 0) sm.flag = 0;
    __syncthreads();
    for (int r = 0; r < kN; ++r) {
      if (tid < 8) {  // the rotation of pair `tid`; p < 0 marks no rotation
        int p, q;
        rr_pair(r, tid, &p, &q);
        Rot rt = {-1, q, 1.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (q < kN) {
          const float app = a[p * kE + p], aqq = a[q * kE + q], apq = a[p * kE + q];
          if (apq != 0.f && fabsf(apq) > kJacobiTol * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq))) {
            const float tau = (aqq - app) / (2.f * apq);
            const float t = fabsf(tau) > 1e18f
                                ? 0.5f / tau
                                : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
            const float c = 1.f / sqrtf(1.f + t * t);
            rt = {p, q, c, t * c, t, app, aqq, apq};
            sm.flag = 1;
          }
        }
        sm.rot[tid] = rt;
      }
      __syncthreads();
      // a <- a J and v <- v J
      for (int e = tid; e < 2 * kN * 8; e += blockDim.x) {
        const int k = e % 8, i = (e / 8) % kN;
        const Rot rt = sm.rot[k];
        if (rt.p < 0) continue;
        float* mtx = e < kN * 8 ? a : v;
        const float x = mtx[i * kE + rt.p], y = mtx[i * kE + rt.q];
        mtx[i * kE + rt.p] = rt.c * x - rt.s * y;
        mtx[i * kE + rt.q] = rt.s * x + rt.c * y;
      }
      __syncthreads();
      // a <- J^T a; the rotated 2x2 block gets its exact diagonal and zeros
      for (int e = tid; e < kN * 8; e += blockDim.x) {
        const int k = e % 8, j = e / 8;
        const Rot rt = sm.rot[k];
        if (rt.p < 0) continue;
        const int p = rt.p, q = rt.q;
        if (j == p) {
          a[p * kE + p] = rt.app - rt.t * rt.apq;
          a[q * kE + p] = 0.f;
        } else if (j == q) {
          a[q * kE + q] = rt.aqq + rt.t * rt.apq;
          a[p * kE + q] = 0.f;
        } else {
          const float x = a[p * kE + j], y = a[q * kE + j];
          a[p * kE + j] = rt.c * x - rt.s * y;
          a[q * kE + j] = rt.s * x + rt.c * y;
        }
      }
      __syncthreads();
    }
    const int rotated = sm.flag;
    __syncthreads();
    if (!rotated) break;
  }
  return sweep;
}

__global__ void __launch_bounds__(kThreads)
tight_fuse_kernel(const float* __restrict__ in, float* __restrict__ out, float gx, float gy,
                  float gz, int iterations, float var_rot, float var_pos, float var_gyro_rw,
                  float var_acc_rw) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float inv_var[4] = {1.f / var_rot, 1.f / var_pos, 1.f / var_gyro_rw,
                            1.f / var_acc_rw};

  for (int i = tid; i < I_SIZE; i += blockDim.x) sm.in[i] = in[i];
  for (int i = tid; i < kRows * kDim; i += blockDim.x) sm.jac[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    sm.g[0] = gx; sm.g[1] = gy; sm.g[2] = gz;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) sm.lr[3 * i + j] = sm.in[I_POSE + 4 * i + j];
      sm.lp[i] = sm.in[I_POSE + 4 * i + 3];
    }
    constant_blocks(sm.jac);
  }
  // the starting state: the last state, the predicted R V P, the last biases
  for (int i = tid; i < S_SIZE; i += blockDim.x) {
    float v;
    if (i < S_RJ) v = sm.in[I_LR + i];
    else if (i < S_VJ) v = sm.in[I_PR + i - S_RJ];
    else if (i < S_PJ) v = sm.in[I_PV + i - S_VJ];
    else if (i < S_BGJ) v = sm.in[I_PP + i - S_PJ];
    else v = sm.in[I_LBG + i - S_BGJ];  // bg_j, ba_j <- last bg, ba
    sm.st[0][i] = v;
  }
  if (warp == 1) {  // lam9 = inv(pre.cov + 1e-16 I) by Gauss-Jordan
    float* aug = sm.m;  // [9, 18]
    const float* cov = sm.in + I_PRE + P_COV;
    for (int e = lane; e < 9 * 18; e += 32) {
      const int i = e / 18, j = e % 18;
      aug[e] = j < 9 ? cov[9 * i + j] + (i == j ? 1e-16f : 0.f) : (j - 9 == i ? 1.f : 0.f);
    }
    __syncwarp();
    for (int k = 0; k < 9; ++k) {
      int piv = k;
      float best = fabsf(aug[18 * k + k]);
      for (int i = k + 1; i < 9; ++i)
        if (fabsf(aug[18 * i + k]) > best) {
          best = fabsf(aug[18 * i + k]);
          piv = i;
        }
      __syncwarp();
      if (piv != k && lane < 18) {
        const float t = aug[18 * k + lane];
        aug[18 * k + lane] = aug[18 * piv + lane];
        aug[18 * piv + lane] = t;
      }
      __syncwarp();
      const float pv = aug[18 * k + k];
      __syncwarp();
      if (lane < 18) aug[18 * k + lane] /= pv;
      __syncwarp();
      float fk[9];
      for (int i = 0; i < 9; ++i) fk[i] = aug[18 * i + k];
      __syncwarp();
      if (lane < 18)
        for (int i = 0; i < 9; ++i)
          if (i != k) aug[18 * i + lane] -= fk[i] * aug[18 * k + lane];
      __syncwarp();
    }
    for (int e = lane; e < 81; e += 32) sm.lam9[e] = aug[18 * (e / 9) + 9 + e % 9];
  }
  __syncthreads();

  int cur = 0;
  assemble(sm, sm.st[cur], cur, inv_var);
  float lam = 1e-4f;
  int it = 0;
  while (it < iterations) {
    lm_solve(sm, sm.h[cur], sm.b[cur], lam);
    apply_dx(sm, sm.st[cur], sm.st[1 - cur]);
    assemble(sm, sm.st[1 - cur], 1 - cur, inv_var);
    if (tid == 0) {
      const bool accept = sm.cost[1 - cur] < sm.cost[cur];
      const bool stuck = !accept && lam >= 1e2f;
      sm.accept = accept;
      sm.done = (accept && sm.tiny) || stuck;
      sm.lm_lambda = accept ? fmaxf(lam * 0.5f, 1e-6f) : fminf(lam * 8.f, 1e2f);
    }
    __syncthreads();
    const bool accept = sm.accept, done = sm.done;
    lam = sm.lm_lambda;
    __syncthreads();
    if (accept) cur = 1 - cur;
    ++it;
    if (done) break;
  }

  // the posterior at the optimum: one fresh assembly
  const float* s = sm.st[cur];
  assemble(sm, s, 1 - cur, inv_var);
  const float* h = sm.h[1 - cur];

  // marginalize the old state: Jacobi-scaled pseudo-inverse, Schur complement
  if (tid < kN) sm.dinv[tid] = rsqrtf(fmaxf(h[tid * kDim + tid], 1e-24f));
  __syncthreads();
  for (int e = tid; e < kE * kE; e += blockDim.x) {
    const int i = e / kE, j = e % kE, lo = min(i, j), hi = max(i, j);
    sm.ea[e] = (i < kN && j < kN) ? h[lo * kDim + hi] * sm.dinv[lo] * sm.dinv[hi] : 0.f;
  }
  __syncthreads();
  const int sweeps_marg = jacobi15(sm, sm.ea, sm.ev);
  if (tid < kN) {
    const float w = sm.ea[tid * kE + tid];
    sm.w[tid] = fabsf(w) > 1e-6f ? 1.f / w : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int k = 0; k < kN; ++k) v += sm.ev[i * kE + k] * sm.w[k] * sm.ev[j * kE + k];
    sm.pinv[e] = v;
  }
  __syncthreads();
  // The deviation from the plain version (see the header): one
  // Newton-Schulz step P <- P (2I - A P) on the scaled block A: the
  // rotations leave V orthogonal to a few 1e-6 only, and the Schur
  // complement below cancels large terms, so P is brought to the accuracy
  // of a direct inverse; directions P drops stay dropped.
  for (int e = tid; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int m = 0; m < kN; ++m) {
      const int lo = min(i, m), hi = max(i, m);
      v += h[lo * kDim + hi] * sm.dinv[lo] * sm.dinv[hi] * sm.pinv[m * kN + j];
    }
    sm.x[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int m = 0; m < kN; ++m) v += sm.pinv[i * kN + m] * sm.x[m * kN + j];
    sm.ea[e] = 2.f * sm.pinv[e] - v;
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    sm.pinv[e] = sm.ea[e] * sm.dinv[i] * sm.dinv[j];
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {  // h_km pinv
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int m = 0; m < kN; ++m) v += h[(kN + i) * kDim + m] * sm.pinv[m * kN + j];
    sm.x[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {  // h_kk - h_km pinv h_mk
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int m = 0; m < kN; ++m) v += sm.x[i * kN + m] * h[m * kDim + kN + j];
    sm.pinv[e] = h[(kN + i) * kDim + kN + j] - v;
  }
  __syncthreads();
  for (int e = tid; e < kE * kE; e += blockDim.x) {
    const int i = e / kE, j = e % kE;
    sm.ea[e] = (i < kN && j < kN) ? 0.5f * (sm.pinv[i * kN + j] + sm.pinv[j * kN + i]) : 0.f;
  }
  __syncthreads();

  // project onto the PSD cone: V max(w, 0) V^T
  const int sweeps_psd = jacobi15(sm, sm.ea, sm.ev);
  if (tid < kN) sm.w[tid] = fmaxf(sm.ea[tid * kE + tid], 0.f);
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int k = 0; k < kN; ++k) v += sm.ev[i * kE + k] * sm.w[k] * sm.ev[j * kE + k];
    out[O_INFO + e] = v;
  }
  for (int i = tid; i < 15; i += blockDim.x) {
    if (i < 9) out[O_R + i] = s[S_RJ + i];
    else out[O_V + i - 9] = s[S_VJ + i - 9];
  }
  for (int i = tid; i < 9; i += blockDim.x) {
    if (i < 3) out[O_P + i] = s[S_PJ + i];
    else if (i < 6) out[O_BG + i - 3] = s[S_BGJ + i - 3];
    else out[O_BA + i - 6] = s[S_BAJ + i - 6];
  }
  if (tid == 0) {
    out[O_ITERS] = (float)it;
    out[O_SWEEPS] = (float)sweeps_marg;
    out[O_SWEEPS + 1] = (float)sweeps_psd;
  }
}

}  // namespace

extern "C" int tight_fuse_launch(const float* in, float* out, float gx, float gy, float gz,
                                 int iterations, float var_rot, float var_pos,
                                 float var_gyro_rw, float var_acc_rw, void* stream) {
  tight_fuse_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, gx, gy, gz, iterations, var_rot, var_pos, var_gyro_rw, var_acc_rw);
  return static_cast<int>(cudaGetLastError());
}
