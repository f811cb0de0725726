// The per-frame 30-dof tight-fusion solve, one thread block per call:
// the factor assembly, the Levenberg-Marquardt loop, the Schur
// marginalization of the old state at the optimum and the projection of
// the new prior onto the PSD cone.
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
//     on values in shared memory, the same on every thread, with no host
//     read. The LU scales each pivot column by the pivot's reciprocal, as
//     LAPACK's getf2 does, and the back substitution multiplies by the same
//     reciprocals where LAPACK's getrs divides (a last-bit difference);
//   * the posterior H at the optimum: the plain version assembles it anew;
//     the kernel keeps the assembly of the accepted state, which is the
//     same arithmetic on the same state and so the same H;
//   * `marginalize(H, 0, 14)[15:, 15:]`: the 15x15 old-state block Jacobi
//     scaled (rsqrt(max(diag, 1e-24))) and pseudo-inverted with |eigenvalues|
//     below 1e-6 dropped (for a symmetric block this equals the SVD
//     pseudo-inverse with singular values below 1e-6 dropped), then the
//     Schur complement. DEVIATION: the pseudo-inverse is refined by one
//     Newton-Schulz step P <- P (2I - A P), which neither the plain nor the
//     JAX version takes (their SVD is accurate enough without it; this
//     float32 Jacobi solve is not, see the kernel body);
//   * symmetrize, eigendecompose, V max(w, 0) V^T.
// Both eigenproblems use one cyclic (round-robin) Jacobi solver: seven
// disjoint rotations a round, round r pairing (r + k, r - k) mod 15 for
// k = 1..7, 15 rounds a sweep, a relative off-diagonal test, at most kSweeps
// sweeps. The count of sweeps that rotated in each solve goes to the
// output: kSweeps means it stopped unconverged.
//
// Bound: a few hundred thousand operations a call on ~2.7 KB of input and
// output, so neither bytes nor operations bound it on this card; the chain
// of dependent steps does. A call with 12 LM iterations and the usual 6 + 5
// rotating sweeps runs, one after another: 12 x (30 pivot steps, 30
// back-substitution steps, one assembly of three stages) and 13 sweeps x 15
// Jacobi rounds. The design keeps that chain off block barriers and cuts
// each link:
//   * the LM solve runs in warp 0 alone, lane i holding row i of the
//     augmented [Hs + lambda I | -b d] in registers (the pivot and column
//     loops unrolled so every register index is a constant). A pivot step
//     is a warp max of the column (`__reduce_max_sync` on the bits of
//     |m_ik|, the lowest lane of the largest value), a ballot, the
//     pivot's reciprocal (taken beside the ballot, so no division is on the
//     chain) and the pivot row broadcast by shuffles; rows are not swapped,
//     each lane remembers the step at which it was the pivot, which leaves
//     every row's arithmetic as with swaps. The back substitution and the
//     trial state (both right-perturbed rotations, one entry a lane) follow
//     in the same warp: no block barrier inside a solve;
//   * an assembly is three parallel stages, a barrier after each: the
//     factors' residuals and state-dependent Jacobian blocks (one thread a
//     factor, the preintegration factor split over two warps); lam J and
//     lam e, one item a thread (the blocks that do not depend on the state
//     are written once, at entry); G = J^T [lam J | lam e], a warp a column
//     block of J so that the row blocks it skips as structural zeros are
//     the same on every lane. H = 0.5 (G + G^T) is taken where it is read;
//   * each eigensolve runs in warp 0 alone, lane i holding half a row of A
//     and of V in registers (jacobi_warp): a round is one exchange between
//     a row's halves (column rotations), one between the pair's rows (row
//     rotations) and a renumbering that keeps the pairs on fixed lanes. No
//     barrier at all inside a solve.
// Every sum keeps the order of the dense products it replaces, so skipping
// a structural zero leaves its rounding unchanged.
// A build with -DFLS_STAGE_CLOCKS (stage_clock.cuh) writes the cycles of
// each stage (C_* below) after the output; tools/profile_torch_loops.py
// --stages reads them.
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
#include "stage_clock.cuh"

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
constexpr int kLdH = 31;    // H's leading dimension (odd: row loads hit distinct banks)
constexpr int kLdL = 31;    // [lam J | lam e]
constexpr int kN = 15;      // eigenproblems
constexpr int kE = 16;      // their leading dimension
constexpr int kSweeps = 12;
constexpr float kJacobiTol = 2.4e-7f;  // two float32 ulps of sqrt(|a_pp a_qq|)
constexpr unsigned kFull = 0xffffffffu;
// Row blocks (3 rows each) of the stacked Jacobian: 0-4 prior, 5 lidar
// rotation, 6 lidar position, 7-9 preintegration, 10 gyro walk, 11 accel
// walk. For each of the 10 column blocks, the row blocks whose Jacobian
// block is not structurally zero, 12 bits each: column blocks 0-4 in kColRows0,
// 5-9 in kColRows1.
constexpr unsigned long long kColRows0 =
    0x381ull | (0x302ull << 12) | (0x204ull << 24) | (0x788ull << 36) | (0xB10ull << 48);
constexpr unsigned long long kColRows1 =
    0x0A0ull | (0x100ull << 12) | (0x240ull << 24) | (0x400ull << 36) | (0x800ull << 48);

__device__ inline unsigned col_rows(int col) {
  const int cb = col / 3;
  return static_cast<unsigned>(((cb < 5 ? kColRows0 : kColRows1) >> (12 * (cb % 5))) & 0xfffu);
}

struct Smem {
  float in[I_SIZE];
  float g[3];
  float lam9[81];
  float aug[9 * 18];
  float st[2][S_SIZE];
  float jac[kRows * kDim];
  float err[kRows];
  float lj[kRows * kLdL];  // lam J, and lam e in column kDim
  float g2[2][kDim * kLdH];  // G = J^T (lam J) of each state slot; H = 0.5 (G + G^T)
  float hs[kDim * kLdH];     // the tail's H
  float b[2][kDim];
  float cost[2];
  float dx[32];
  int tiny[2];
  float dm[kN];
  float ev[kE * kE];
  float w[kN], x[kN * kN], pinv[kN * kN], ea[kN * kN];
};

__device__ inline void put3(float* jac, int row, int col, const float* blk,
                            float scale = 1.f) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) jac[(row + i) * kDim + col + j] = scale * blk[3 * i + j];
}

// the preintegration factor's rotation residual and its state-dependent
// Jacobian blocks (rows 21..23): the longest chain of an assembly
__device__ void preint_rotation(Smem& sm, const float* s) {
  const float* pre = sm.in + I_PRE;
  const float* ri = s + S_RI;
  const float* rj = s + S_RJ;
  float dbg[3];
  for (int c = 0; c < 3; ++c) dbg[c] = s[S_BGI + c] - pre[P_BG + c];
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
  for (int c = 0; c < 3; ++c) sm.err[21 + c] = er[c];
  float jri[9], nj[9], t2[9], blk[9];
  so3::jr_inv(er, jri);
  for (int k = 0; k < 9; ++k) nj[k] = -jri[k];
  so3::mul_nt(nj, rj, t2);
  so3::mul(t2, ri, blk);
  put3(sm.jac, 21, 0, blk);
  put3(sm.jac, 21, 15, jri);
  float eer[9], t3[9], jrt[9], t4[9], t5[9];
  so3::exp(er, eer);
  so3::mul_nt(nj, eer, t3);
  so3::jr(t1, jrt);
  so3::mul(t3, jrt, t4);
  so3::mul(t4, pre + P_DR_DBG, t5);
  put3(sm.jac, 21, 9, t5);
}

// the preintegration factor's velocity and position residuals and their
// state-dependent Jacobian blocks (rows 24..29)
__device__ void preint_velocity_position(Smem& sm, const float* s) {
  const float* pre = sm.in + I_PRE;
  const float* ri = s + S_RI;
  const float dt = pre[P_DT];
  const float* g = sm.g;
  float dbg[3], dba[3], dvw[3], dpw[3], a[3], bb[3], u1[3], u2[3], u3[3], u4[3];
  for (int c = 0; c < 3; ++c) {
    dbg[c] = s[S_BGI + c] - pre[P_BG + c];
    dba[c] = s[S_BAI + c] - pre[P_BA + c];
    dvw[c] = s[S_VJ + c] - s[S_VI + c] - g[c] * dt;
    dpw[c] = s[S_PJ + c] - s[S_PI + c] - s[S_VI + c] * dt - 0.5f * g[c] * dt * dt;
  }
  so3::mtv(ri, dvw, a);
  so3::mtv(ri, dpw, bb);
  so3::mv(pre + P_DV_DBG, dbg, u1);
  so3::mv(pre + P_DV_DBA, dba, u2);
  so3::mv(pre + P_DP_DBG, dbg, u3);
  so3::mv(pre + P_DP_DBA, dba, u4);
  for (int c = 0; c < 3; ++c) {
    sm.err[24 + c] = a[c] - (pre[P_DV + c] + u1[c] + u2[c]);
    sm.err[27 + c] = bb[c] - (pre[P_DP + c] + u3[c] + u4[c]);
  }
  float rit[9], ha[9], hb[9];
  for (int k = 0; k < 9; ++k) rit[k] = ri[3 * (k % 3) + k / 3];
  so3::hat(a, ha);
  so3::hat(bb, hb);
  float* jac = sm.jac;
  put3(jac, 24, 0, ha);
  put3(jac, 27, 0, hb);
  put3(jac, 24, 3, rit, -1.f);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) jac[(27 + i) * kDim + 3 + j] = -rit[3 * i + j] * dt;
  put3(jac, 27, 6, rit, -1.f);
  put3(jac, 24, 18, rit);
  put3(jac, 27, 21, rit);
}

// a rotation factor: measure (-) estimate on rotation `r` against `meas`
// (row-major, leading dimension `ld`); residual rows and Jacobian block at
// (row, col)
__device__ void rotation_factor(Smem& sm, const float* meas, int ld, const float* r,
                                int row, int col) {
  float mt[9], m[9], e[3], j[9];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) mt[3 * a + c] = meas[ld * a + c];
  so3::mul_tn(mt, r, m);
  so3::log(m, e);
  so3::jr_inv(e, j);
  for (int c = 0; c < 3; ++c) sm.err[row + c] = e[c];
  put3(sm.jac, row, col, j);
}

__device__ inline float inv_var_of_row(int r, const float iv[4]) {
  return r < 18 ? iv[0] : r < 21 ? iv[1] : r < 33 ? iv[2] : iv[3];
}

// rows 3 cb .. 3 cb + 2 of G = J^T [lam J | lam e] at column j: over the
// factors in order, each factor's sum over its rows (ascending), taking
// only the row blocks whose Jacobian block in column block cb is not a
// structural zero (`rows`, the same on every lane of the warp)
__device__ inline void g_rows(const float* jac, const float* lj, int cb, int j, unsigned rows,
                              float out[3]) {
  const int lo[7] = {0, 5, 6, 7, 10, 11, 12};  // each factor's row blocks
  float h[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int rb = lo[f]; rb < lo[f + 1]; ++rb)
      if ((rows >> rb) & 1u)
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) {
          const int r = 3 * rb + rr;
          const float y = lj[r * kLdL + j];
#pragma unroll
          for (int ii = 0; ii < 3; ++ii) a[ii] += jac[r * kDim + 3 * cb + ii] * y;
        }
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) h[ii] += a[ii];
  }
#pragma unroll
  for (int ii = 0; ii < 3; ++ii) out[ii] = h[ii];
}

// H_ij of a slot's G = J^T (lam J): the symmetrized 0.5 (G_ij + G_ji)
__device__ inline float h_at(const float* g, int i, int j) {
  return 0.5f * (g[i * kLdH + j] + g[j * kLdH + i]);
}

// stage clocks of a profiling build (stage_clock.cuh)
enum {
  C_SETUP, C_FACTORS, C_LAM_J, C_H, C_ELIMINATE, C_SUBSTITUTE, C_TRIAL, C_SOLVE_WAIT,
  C_JACOBI_MARG, C_PRODUCTS, C_JACOBI_PSD, C_OUTPUT
};

// H (symmetrized), b and the cost of state slot `k` into slot `k`: three
// stages, a block barrier after each
__device__ void assemble(Smem& sm, int k, const float iv[4], StageClock& clk) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* s = sm.st[k];
  // 1. residuals and the state-dependent Jacobian blocks, one thread a part
  if (lane == 0) {
    if (warp == 0) {  // prior on the last state: measure (-) estimate
      rotation_factor(sm, sm.in + I_LR, 3, s + S_RI, 0, 0);
      for (int c = 0; c < 3; ++c) {
        sm.err[3 + c] = sm.in[I_LV + c] - s[S_VI + c];
        sm.err[6 + c] = sm.in[I_LP + c] - s[S_PI + c];
        sm.err[9 + c] = sm.in[I_LBG + c] - s[S_BGI + c];
        sm.err[12 + c] = sm.in[I_LBA + c] - s[S_BAI + c];
      }
    } else if (warp == 1) {  // lidar rotation on R_j
      rotation_factor(sm, sm.in + I_POSE, 4, s + S_RJ, 15, 15);
    } else if (warp == 2) {  // lidar position, bias random walks
      for (int c = 0; c < 3; ++c) {
        sm.err[18 + c] = sm.in[I_POSE + 4 * c + 3] - s[S_PJ + c];
        sm.err[30 + c] = s[S_BGJ + c] - s[S_BGI + c];
        sm.err[33 + c] = s[S_BAJ + c] - s[S_BAI + c];
      }
    } else if (warp == 3) {
      preint_rotation(sm, s);
    } else if (warp == 4) {
      preint_velocity_position(sm, s);
    }
  }
  __syncthreads();
  clk.mark(C_FACTORS);

  // 2. lam e (36 rows), the preintegration rows of lam J (9 x 24, two
  // columns a thread), the prior's rows on R_i (15 x 3, a row a thread) and
  // the lidar rotation's (3 x 3, likewise): one item a thread; the other
  // blocks of lam J do not depend on the state
  const float* info = sm.in + I_INFO;
  if (tid < 36) {  // lam e, in column kDim
    const int r = tid;
    float v = 0.f;
    if (r < 15) {
      for (int m = 0; m < 15; ++m) v += info[15 * r + m] * sm.err[m];
    } else if (r >= 21 && r < 30) {
      for (int m = 0; m < 9; ++m) v += sm.lam9[9 * (r - 21) + m] * sm.err[21 + m];
    } else {
      v = inv_var_of_row(r, iv) * sm.err[r];
    }
    sm.lj[r * kLdL + kDim] = v;
  } else if (tid < 36 + 15) {
    const int r = tid - 36;
    for (int c = 0; c < 3; ++c) {
      float v = 0.f;
      for (int m = 0; m < 3; ++m) v += info[15 * r + m] * sm.jac[m * kDim + c];
      sm.lj[r * kLdL + c] = v;
    }
  } else if (tid < 36 + 15 + 3) {
    const int r = 15 + tid - 51;
    for (int c = 15; c < 18; ++c) sm.lj[r * kLdL + c] = iv[0] * sm.jac[r * kDim + c];
  } else if (tid < 36 + 15 + 3 + 108) {
    const int e = tid - 54, r = e / 12, c = 2 * (e % 12);
    float v0 = 0.f, v1 = 0.f;
    for (int m = 0; m < 9; ++m) {
      const float l = sm.lam9[9 * r + m];
      v0 += l * sm.jac[(21 + m) * kDim + c];
      v1 += l * sm.jac[(21 + m) * kDim + c + 1];
    }
    sm.lj[(21 + r) * kLdL + c] = v0;
    sm.lj[(21 + r) * kLdL + c + 1] = v1;
  }
  __syncthreads();
  clk.mark(C_LAM_J);

  // 3. G = sum over factors of J^T (lam J) and b = J^T (lam e), a warp a
  // column block of J (three rows of G; its structural zeros the same on
  // every lane), lane j column j of [G | b]; the cost. H = 0.5 (G + G^T) is
  // taken where it is read (`h_at`).
  float* g = sm.g2[k];
  for (int cb = warp; cb < kDim / 3; cb += kThreads / 32) {
    if (lane > kDim) break;
    float rows3[3];
    g_rows(sm.jac, sm.lj, cb, lane, col_rows(3 * cb), rows3);
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
      if (lane < kDim) g[(3 * cb + ii) * kLdH + lane] = rows3[ii];
      else sm.b[k][3 * cb + ii] = rows3[ii];
    }
  }
  if (tid == kThreads - 1) {
    float cost = 0.f;
    const int lo[7] = {0, 15, 18, 21, 30, 33, 36};
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      float a = 0.f;
      for (int r = lo[f]; r < lo[f + 1]; ++r) a += sm.err[r] * sm.lj[r * kLdL + kDim];
      cost += a;
    }
    sm.cost[k] = cost;
  }
  __syncthreads();
  clk.mark(C_H);
}

// Warp 0: (Hs + lambda I) y = -b d by LU with partial pivoting, dx = d y,
// |dx| < 1e-6 into sm.tiny[parity], and the trial state s (+) dx into slot
// `out` (right perturbation of the rotations, sums elsewhere).
__device__ void lm_step(Smem& sm, int cur, int out, float lam, int parity, StageClock& clk) {
  const int lane = threadIdx.x % 32;
  const int row = lane < kDim ? lane : kDim - 1;  // lanes 30, 31 mirror row 29
  const float* g = sm.g2[cur];
  const float d = rsqrtf(fmaxf(h_at(g, row, row), 1e-12f));
  float m[kDim + 1];
#pragma unroll
  for (int j = 0; j < kDim; ++j) {
    const float dj = __shfl_sync(kFull, d, j);
    m[j] = h_at(g, row, j) * d * dj + (row == j ? lam : 0.f);
  }
  m[kDim] = -(sm.b[cur][row] * d);

  // elimination: the pivot of column k is the lowest lane of largest |m_k|
  // among the rows not yet pivots; no row moves
  bool cand = lane < kDim;
  int step = 99;  // the column this lane's row is the pivot of
  int piv[kDim];     // the pivot row (lane) of each column
  float rk[kDim];    // the reciprocal of each pivot
#pragma unroll
  for (int k = 0; k < kDim; ++k) {
    const float v = m[k];
    const unsigned key = cand ? __float_as_uint(fabsf(v)) + 1u : 0u;
    const unsigned neg = __ballot_sync(kFull, __float_as_uint(v) >> 31);
    const unsigned top = __reduce_max_sync(kFull, key);
    const float rabs = 1.f / __uint_as_float(top - 1u);  // 1 / |m_pk|, beside the ballot
    const int p = __ffs(__ballot_sync(kFull, key == top)) - 1;
    piv[k] = p;
    if (lane == p) {
      cand = false;
      step = k;
    }
    rk[k] = ((neg >> p) & 1u) ? -rabs : rabs;  // 1 / m_pk
    const float f = cand ? v * rk[k] : 0.f;      // rows already pivots subtract 0 exactly
#pragma unroll
    for (int j = 0; j <= kDim; ++j) {
      if (j > k) {
        const float pj = __shfl_sync(kFull, m[j], p);
        m[j] -= f * pj;
      }
    }
  }
  clk.mark(C_ELIMINATE);

  // back substitution: unknown k sits in the lane of pivot k
  float y = m[kDim];
#pragma unroll
  for (int k = kDim - 1; k >= 0; --k) {
    const int p = piv[k];
    const float yk = __shfl_sync(kFull, y, p) * rk[k];
    if (step == k) y = yk;
    else if (step < k) y -= m[k] * yk;
  }
  const float ds = __shfl_sync(kFull, d, step & 31);
  if (step < kDim) sm.dx[step] = ds * y;
  __syncwarp();
  const float dxl = lane < kDim ? sm.dx[lane] : 0.f;
  float sq = dxl * dxl;
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(kFull, sq, off);
  if (lane == 0) sm.tiny[parity] = sqrtf(sq) < 1e-6f;
  clk.mark(C_SUBSTITUTE);

  // the trial state
  const float* s = sm.st[cur];
  float* so = sm.st[out];
  if (lane < 24) {  // V, P, bg, ba of both states
    const int off = lane < 12 ? S_VI + lane : S_VJ + lane - 12;
    const int di = lane < 12 ? 3 + lane : 18 + lane - 12;
    so[off] = s[off] + sm.dx[di];
  }
  if (lane < 18) {  // R_i Exp(dx[0:3]) and R_j Exp(dx[15:18]), one entry a lane
    const int base = lane < 9 ? S_RI : S_RJ, e = lane % 9, i = e / 3, j = e % 3;
    float ex[9];
    so3::exp(sm.dx + (lane < 9 ? 0 : 15), ex);
    so[base + e] = s[base + 3 * i] * ex[j] + s[base + 3 * i + 1] * ex[3 + j]
                   + s[base + 3 * i + 2] * ex[6 + j];
  }
  clk.mark(C_TRIAL);
}

// a[idx] of an 8-entry register array by a select tree (no local memory)
__device__ inline float pick8(const float a[8], int idx) {
  float b4[4], b2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) b4[k] = (idx & 1) ? a[2 * k + 1] : a[2 * k];
#pragma unroll
  for (int k = 0; k < 2; ++k) b2[k] = (idx & 2) ? b4[2 * k + 1] : b4[2 * k];
  return (idx & 4) ? b2[1] : b2[0];
}

// The column a half-row register holds: lane L keeps row L % 16, columns
// 0..7 in x[0..7] for L < 16 and columns 15..8 in x[0..7] for L >= 16.
__device__ inline int half_col(int lane, int m) { return lane < 16 ? m : kE - 1 - m; }

// Warp 0: cyclic Jacobi eigensolver of a symmetric 15x15 matrix A held in
// half rows (half_col; row and column 15 are a zero dummy). On return x
// holds the rotated A (its diagonal the eigenvalues: A_rr sits in
// x[pair_of(r)] of lane r for r <= 7 and of lane r + 16 for r >= 8) and y
// the eigenvectors, V in the same half-row layout. Returns the sweeps that
// rotated (the same on every lane); kSweeps means the last sweep still
// rotated, i.e. no convergence.
//
// Round r rotates the pairs (r + k, r - k) mod 15, k = 1..7 (index 15 is a
// dummy that pairs with r). Index x is stored at (x - r) mod 15 during
// round r (row for rows, column for columns), so the pairs are always
// (k, 15 - k), k = 1..7: row k plays p, row 15 - k plays q, and the two
// halves of a row hold the two columns of every pair in the same register
// (column k in x[k] of the low half, 15 - k in x[k] of the high half). A
// column rotation is one exchange between a row's halves, a row rotation
// one exchange between the pair's rows, half by half. After each round the
// storage moves one index down; after 15 rounds it is back.
__device__ inline int pair_of(int row) { return row <= 7 ? row : kN - row; }

__device__ int jacobi_warp(float x[8], float y[8]) {
  const int lane = threadIdx.x % 32, r = lane % 16, hf = lane / 16;
  const int kk = pair_of(r);           // my pair (row 0 and the dummy 15: pair 0)
  const bool is_p = r >= 1 && r <= 7;  // row p of pair kk (else row q = 15 - kk)
  const bool live = r >= 1 && r < kN;
  const int partner = (kN - r) + 16 * hf;                 // the pair's other row, same half
  const int from = (r < kN ? (r + 1) % kN : r) + 16 * hf;  // the frame move's source row
#pragma unroll
  for (int m = 0; m < 8; ++m) y[m] = (half_col(lane, m) == r) ? 1.f : 0.f;
  int sweep = 0;
  for (; sweep < kSweeps; ++sweep) {
    bool rotated = false;
    for (int round = 0; round < kN; ++round) {
      // x[kk]: A_pp in the low half of row p, A_pq in its high half, A_qq in
      // the high half of row q
      const float vk = pick8(x, kk);
      const float app = __shfl_sync(kFull, vk, kk);
      const float apq = __shfl_sync(kFull, vk, kk + 16);
      const float aqq = __shfl_sync(kFull, vk, (kN - kk) + 16);
      bool rot = false;
      float c = 1.f, s = 0.f, t = 0.f;
      if (live && apq != 0.f
          && fabsf(apq) > kJacobiTol * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq))) {
        const float tau = (aqq - app) / (2.f * apq);
        t = fabsf(tau) > 1e18f ? 0.5f / tau
                               : copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
        c = 1.f / sqrtf(1.f + t * t);
        s = t * c;
        rot = true;
      }
      rotated |= rot;
      if (__any_sync(kFull, rot)) {
        // A <- A J and V <- V J: column p = k (low half) and q = 15 - k
        // (high half) of every row, x[k] on both sides
        const float sgn = hf ? 1.f : -1.f;
#pragma unroll
        for (int k = 1; k <= 7; ++k) {
          const float ck = __shfl_sync(kFull, c, k), sk = sgn * __shfl_sync(kFull, s, k);
          const float xo = __shfl_xor_sync(kFull, x[k], 16);
          const float yo = __shfl_xor_sync(kFull, y[k], 16);
          x[k] = ck * x[k] + sk * xo;  // low: c x_p - s x_q; high: s x_p + c x_q
          y[k] = ck * y[k] + sk * yo;
        }
        // A <- J^T A: rows p and q mix; the rotated 2x2 block gets its
        // exact diagonal and zeros (both in x[kk])
        const float sr = is_p ? -s : s;
        const float dnew = is_p ? app - t * apq : aqq + t * apq;
        const float fix = (is_p == (hf == 0)) ? dnew : 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float other = __shfl_sync(kFull, x[m], partner);
          float nv = c * x[m] + sr * other;
          if (rot && m == kk) nv = fix;
          x[m] = nv;
        }
      }
      // the next round's frame: index x moves from x - r to x - r - 1
      const float x0 = __shfl_xor_sync(kFull, x[0], 16), x7 = __shfl_xor_sync(kFull, x[7], 16);
      const float y0 = __shfl_xor_sync(kFull, y[0], 16), y7 = __shfl_xor_sync(kFull, y[7], 16);
      float nx[8], ny[8];
      nx[0] = hf ? x[0] : x[1];
      ny[0] = hf ? y[0] : y[1];
      nx[1] = hf ? x0 : x[2];
      ny[1] = hf ? y0 : y[2];
#pragma unroll
      for (int m = 2; m < 7; ++m) {
        nx[m] = hf ? x[m - 1] : x[m + 1];
        ny[m] = hf ? y[m - 1] : y[m + 1];
      }
      nx[7] = hf ? x[6] : x7;
      ny[7] = hf ? y[6] : y7;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        x[m] = __shfl_sync(kFull, nx[m], from);
        y[m] = ny[m];
      }
    }
    if (!__any_sync(kFull, rotated)) break;
  }
  return sweep;
}

// Warp 0: the eigenvalues (diagonal of the rotated x) into sm.w and the
// eigenvectors (y) into sm.ev, from jacobi_warp's half rows
__device__ void store_eigen(Smem& sm, const float x[8], const float y[8]) {
  const int lane = threadIdx.x % 32, r = lane % 16;
  if (r >= kN) return;
  const float d = pick8(x, pair_of(r));
  if ((lane < 16) == (r <= 7)) sm.w[r] = d;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int col = half_col(lane, m);
    if (col < kN) sm.ev[r * kE + col] = y[m];
  }
}

__global__ void __launch_bounds__(kThreads)
tight_fuse_kernel(const float* __restrict__ in, float* __restrict__ out, float gx, float gy,
                  float gz, int iterations, float var_rot, float var_pos, float var_gyro_rw,
                  float var_acc_rw) {
  __shared__ Smem sm;
  StageClock clk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float iv[4] = {1.f / var_rot, 1.f / var_pos, 1.f / var_gyro_rw, 1.f / var_acc_rw};

  for (int i = tid; i < I_SIZE; i += blockDim.x) sm.in[i] = in[i];
  for (int i = tid; i < kRows * kDim; i += blockDim.x) sm.jac[i] = 0.f;
  for (int i = tid; i < kRows * kLdL; i += blockDim.x) sm.lj[i] = 0.f;
  __syncthreads();

  if (warp == 1) {  // lam9 = inv(pre.cov + 1e-16 I) by Gauss-Jordan
    float* aug = sm.aug;  // [9, 18]
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
  } else if (warp == 0) {
    // the starting state: the last state, the predicted R V P, the last biases
    for (int i = lane; i < S_SIZE; i += 32) {
      float v;
      if (i < S_RJ) v = sm.in[I_LR + i];
      else if (i < S_VJ) v = sm.in[I_PR + i - S_RJ];
      else if (i < S_PJ) v = sm.in[I_PV + i - S_VJ];
      else if (i < S_BGJ) v = sm.in[I_PP + i - S_PJ];
      else v = sm.in[I_LBG + i - S_BGJ];  // bg_j, ba_j <- last bg, ba
      sm.st[0][i] = v;
    }
    if (lane == 0) {
      sm.g[0] = gx;
      sm.g[1] = gy;
      sm.g[2] = gz;
    }
  } else if (warp == 2) {  // the Jacobian blocks that do not depend on the state
    float* jac = sm.jac;
    const float* pre = sm.in + I_PRE;
    if (lane < 12) jac[(3 + lane) * kDim + 3 + lane] = -1.f;  // prior V P bg ba
    if (lane < 3) {
      const int c = lane;
      jac[(18 + c) * kDim + 21 + c] = -1.f;  // lidar position
      jac[(30 + c) * kDim + 9 + c] = -1.f;   // gyro bias walk
      jac[(30 + c) * kDim + 24 + c] = 1.f;
      jac[(33 + c) * kDim + 12 + c] = -1.f;  // accel bias walk
      jac[(33 + c) * kDim + 27 + c] = 1.f;
    }
    if (lane == 0) {  // the preintegration's bias blocks
      put3(jac, 24, 9, pre + P_DV_DBG, -1.f);
      put3(jac, 27, 9, pre + P_DP_DBG, -1.f);
      put3(jac, 24, 12, pre + P_DV_DBA, -1.f);
      put3(jac, 27, 12, pre + P_DP_DBA, -1.f);
    }
  } else if (warp == 3) {  // lam J of those blocks: -info, -1/var, +1/var
    const float* info = sm.in + I_INFO;
    for (int e = lane; e < 15 * 12; e += 32) {
      const int r = e / 12, c = 3 + e % 12;
      sm.lj[r * kLdL + c] = -info[15 * r + c];
    }
    if (lane < 3) {
      const int c = lane;
      sm.lj[(18 + c) * kLdL + 21 + c] = -iv[1];
      sm.lj[(30 + c) * kLdL + 9 + c] = -iv[2];
      sm.lj[(30 + c) * kLdL + 24 + c] = iv[2];
      sm.lj[(33 + c) * kLdL + 12 + c] = -iv[3];
      sm.lj[(33 + c) * kLdL + 27 + c] = iv[3];
    }
  }
  __syncthreads();
  clk.mark(C_SETUP);

  int cur = 0;
  assemble(sm, cur, iv, clk);
  float lam = 1e-4f;
  int it = 0;
  while (it < iterations) {
    if (warp == 0) lm_step(sm, cur, 1 - cur, lam, it & 1, clk);
    __syncthreads();
    clk.mark(C_SOLVE_WAIT);
    assemble(sm, 1 - cur, iv, clk);
    const bool accept = sm.cost[1 - cur] < sm.cost[cur];
    const bool stuck = !accept && lam >= 1e2f;
    const bool done = (accept && sm.tiny[it & 1]) || stuck;
    lam = accept ? fmaxf(lam * 0.5f, 1e-6f) : fminf(lam * 8.f, 1e2f);
    if (accept) cur = 1 - cur;
    ++it;
    if (done) break;
  }

  // the posterior at the optimum: the accepted state's assembly
  const float* s = sm.st[cur];
  const float* h = sm.hs;
  for (int e = tid; e < kDim * kDim; e += blockDim.x) {
    const int i = e / kDim, j = e % kDim;
    sm.hs[i * kLdH + j] = h_at(sm.g2[cur], i, j);
  }
  __syncthreads();

  // marginalize the old state: Jacobi-scaled pseudo-inverse, Schur complement
  int sweeps_marg = 0;
  if (warp == 0) {
    if (lane < kN) sm.dm[lane] = rsqrtf(fmaxf(h[lane * kLdH + lane], 1e-24f));
    __syncwarp();
    const int r = lane % 16;
    float a[8], v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int col = half_col(lane, m), lo = min(r, col), hi = max(r, col);
      a[m] = (r < kN && col < kN) ? h[lo * kLdH + hi] * sm.dm[lo] * sm.dm[hi] : 0.f;
    }
    sweeps_marg = jacobi_warp(a, v);
    store_eigen(sm, a, v);
    __syncwarp();
    if (lane < kN) sm.w[lane] = fabsf(sm.w[lane]) > 1e-6f ? 1.f / sm.w[lane] : 0.f;
  }
  __syncthreads();
  clk.mark(C_JACOBI_MARG);
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
      v += h[lo * kLdH + hi] * sm.dm[lo] * sm.dm[hi] * sm.pinv[m * kN + j];
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
    sm.pinv[e] = sm.ea[e] * sm.dm[i] * sm.dm[j];
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {  // h_km pinv
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int m = 0; m < kN; ++m) v += h[(kN + i) * kLdH + m] * sm.pinv[m * kN + j];
    sm.x[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < kN * kN; e += blockDim.x) {  // h_kk - h_km pinv h_mk
    const int i = e / kN, j = e % kN;
    float v = 0.f;
    for (int m = 0; m < kN; ++m) v += sm.x[i * kN + m] * h[m * kLdH + kN + j];
    sm.pinv[e] = h[(kN + i) * kLdH + kN + j] - v;
  }
  __syncthreads();
  clk.mark(C_PRODUCTS);

  // project onto the PSD cone: V max(w, 0) V^T
  int sweeps_psd = 0;
  if (warp == 0) {
    const int r = lane % 16;
    float a[8], v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int col = half_col(lane, m);
      a[m] = (r < kN && col < kN) ? 0.5f * (sm.pinv[r * kN + col] + sm.pinv[col * kN + r])
                                  : 0.f;
    }
    sweeps_psd = jacobi_warp(a, v);
    store_eigen(sm, a, v);
    __syncwarp();
    if (lane < kN) sm.w[lane] = fmaxf(sm.w[lane], 0.f);
    if (lane == 0) {
      out[O_ITERS] = (float)it;
      out[O_SWEEPS] = (float)sweeps_marg;
      out[O_SWEEPS + 1] = (float)sweeps_psd;
    }
  }
  __syncthreads();
  clk.mark(C_JACOBI_PSD);
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
  clk.mark(C_OUTPUT);
  clk.write(out + O_SWEEPS + 2);
}

}  // namespace

extern "C" int tight_fuse_launch(const float* in, float* out, float gx, float gy, float gz,
                                 int iterations, float var_rot, float var_pos,
                                 float var_gyro_rw, float var_acc_rw, void* stream) {
  tight_fuse_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, gx, gy, gz, iterations, var_rot, var_pos, var_gyro_rw, var_acc_rw);
  return static_cast<int>(cudaGetLastError());
}
