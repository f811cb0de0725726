// The ICP Gauss-Newton loop over cached candidates, one thread block a call:
//
//   icp_gn_kernel  the body of the JAX `lax.while_loop` of
//                  funny_lidar_slam_tpu/registration/gn.py:232 (body
//                  :156-212) with hg_fn = point_to_point_hg_cand
//                  (funny_lidar_slam_tpu/registration/residuals.py:226),
//                  from a carry held on the device until the loop ends or
//                  the next iteration would need a fresh gather. Plain
//                  version ops/gn_loop.py::icp_gn_rounds_plain.
//
// A call is handed the candidate set gathered at the carry's pose. Each
// iteration: test the loop bound (gathers < max_iters, it < max_total, not
// done; else status S_DONE) and the trust region (moved = |dt| + theta r >
// skip_dist, theta = |R Rg^T - I|_F / sqrt 2); if the iteration refreshes
// ((want & moved) | it == 0) and the call's gather is spent, status
// S_NEED_GATHER. Otherwise transform every source row, pick the nearest
// valid candidate among its M (a strict < over the lanes in order: argmin's
// first minimum), gate it at d2 <= max_corr_dist_sq, and sum over the rows
// H = sum J^T J and g = -sum J^T r with J = [I | -R hat(s)], r = R s + t - q,
// the count of valid rows and sum |r|; then solve6_damped (scale =
// max(trace H / 6, 1), Cholesky of H + 1e-6 scale I in f32, NaN where it
// fails), the ICP update (t += dt, R := R Exp(dr)), and the carry update of
// the JAX body. The host reads the status word once a call.
//
// Bound: an iteration reads px, py, pz [N, M] f32, valid [N, M] u8 and src
// [N, 3] f32: N M 13 + N 12 bytes, 3.6 MB at N = 16,384, M = 16, or 1.1 us
// at 3.35 TB/s; the operations (~9 a lane, ~80 a row) are a fraction of
// that at 67 TFLOP/s f32. Counting each input once, as a call's least
// time, the bound is one such read (the set fits in the 50 MB L2), 1.1 us
// a call whatever its iterations. This design sits far above it: one
// block on one SM streams the set once an iteration, and one thread solves
// the 6x6 system between two barriers. It keeps the loop on the device (no
// launch and no host read an iteration), which is what the step lacked; a
// cooperative multi-block reduction, or wgmma and TMA, is later work.
//
// Design: each of the 512 threads strides over the rows and keeps its 23
// partial sums in registers (g_t[3], g_r[3], H_tr[9], the 6 unique entries
// of H_rr, the count, sum |r|; H_tt is count I). Where M = 16 and the
// planes are 16-byte aligned (icp_gn_kernel<16>, every gather of the port)
// a row's lanes come as thirteen 16-byte loads issued together, so a
// thread waits on memory once a row, not once a lane (icp_gn_kernel<0>
// takes any M). The partials are reduced in a fixed order, warp shuffles
// then the warps' rows of shared memory in warp order, with no atomics, so
// two runs agree bit for bit. Thread 0 keeps the carry in shared memory,
// tests the bound, solves, updates and sets the flags between barriers.
//
// The sums are float64, the kernel's one departure from the reference's
// float32: these normal equations have a condition near 1e3 (the rotation
// block ~ N |s|^2 against the translation block's N), and at convergence g
// is a sum of terms that cancel, so float32 sums in any order move the pose
// by up to ~1e-4 m (two float32 implementations part by that much on the
// card). Float64 sums fix g, and so the pose GN settles at, to ~1e-6 m of a
// float64 run; each row's terms, the distances and the Cholesky stay f32.
//
// Carry (int32 words, float fields as their bits; ops/gn_loop.py CARRY):
//   t_mat[16] t_gather[16] last_rot last_pos total_res (f32) | it gathers
//   since_gather force_gather done converged num_valid status (int32)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "so3.cuh"

namespace {

enum {
  C_T_MAT = 0, C_T_GATHER = 16, C_LAST_ROT = 32, C_LAST_POS = 33, C_TOTAL_RES = 34,
  C_IT = 35, C_GATHERS = 36, C_SINCE_GATHER = 37, C_FORCE_GATHER = 38, C_DONE = 39,
  C_CONVERGED = 40, C_NUM_VALID = 41, C_STATUS = 42, C_SIZE = 43
};
enum { S_NEED_GATHER = 1, S_DONE = 2 };
// the per-thread sums: -g's two halves before the sign, H's t-r block, the
// upper triangle of its r-r block, the valid rows and sum |r|
enum { A_GT = 0, A_GR = 3, A_HTR = 6, A_HRR = 15, A_COUNT = 21, A_RES = 22, A_SIZE = 23 };

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kDamping = 1e-6f;  // lin3.solve6_damped

struct Params {
  int n, m, max_iters, max_total, corr_every, min_valid, use_stall;
  float rot_eps, pos_eps, stall_eps, skip_dist, max_d2;
};

// (dx^2 + dy^2) + dz^2 with every product and sum rounded, as the plain
// version's elementwise ops take it: no fused multiply-add, so both sides
// decide the nearest lane and the gate on the same values
__device__ inline float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ inline float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// the nearest valid candidate of the row at `base` to the point q, over the
// lanes in order with a strict < (argmin's first minimum): its squared
// distance in *best (+inf if no lane is valid) and its point in c. kM = 16:
// the row's 16 lanes of px, py, pz and valid as thirteen 16-byte loads, all
// issued before any is used; kM = 0: m lanes, one load each
template <int kM>
__device__ inline void nearest(const float* __restrict__ px, const float* __restrict__ py,
                               const float* __restrict__ pz,
                               const unsigned char* __restrict__ valid, size_t base, int m,
                               const float* q, float* best, float* c) {
  float bd = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
  if constexpr (kM == 16) {
    float4 x[4], y[4], z[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = __ldg(reinterpret_cast<const float4*>(px + base) + k);
      y[k] = __ldg(reinterpret_cast<const float4*>(py + base) + k);
      z[k] = __ldg(reinterpret_cast<const float4*>(pz + base) + k);
    }
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(valid + base));
    const unsigned words[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (!((words[j >> 2] >> (8 * (j & 3))) & 0xffu)) continue;
      const float cx = lane4(x[j >> 2], j & 3), cy = lane4(y[j >> 2], j & 3),
                  cz = lane4(z[j >> 2], j & 3);
      const float d2 = dist2(cx - q[0], cy - q[1], cz - q[2]);
      if (d2 < bd) {
        bd = d2;
        bx = cx;
        by = cy;
        bz = cz;
      }
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      if (!__ldg(valid + base + j)) continue;
      const float cx = __ldg(px + base + j), cy = __ldg(py + base + j),
                  cz = __ldg(pz + base + j);
      const float d2 = dist2(cx - q[0], cy - q[1], cz - q[2]);
      if (d2 < bd) {
        bd = d2;
        bx = cx;
        by = cy;
        bz = cz;
      }
    }
  }
  *best = bd;
  c[0] = bx;
  c[1] = by;
  c[2] = bz;
}

// the rows' sums at pose (rot, t): each thread's strided rows, then the
// warps, then the block; out on every thread's return: sums[A_SIZE]
template <int kM>
__device__ void linearize(const float* __restrict__ px, const float* __restrict__ py,
                          const float* __restrict__ pz, const unsigned char* __restrict__ valid,
                          const float* __restrict__ src, const Params& p, const float* rot,
                          const float* t, double (*part)[A_SIZE], double* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double acc[A_SIZE];
#pragma unroll
  for (int k = 0; k < A_SIZE; ++k) acc[k] = 0.0;
  for (int r = tid; r < p.n; r += kThreads) {
    const float s0 = __ldg(src + 3 * r), s1 = __ldg(src + 3 * r + 1), s2 = __ldg(src + 3 * r + 2);
    float q[3], cand[3], best;
#pragma unroll
    for (int i = 0; i < 3; ++i)  // s R^T + t: a multiply-add chain over k, then + t
      q[i] = __fadd_rn(fmaf(rot[3 * i + 2], s2, fmaf(rot[3 * i + 1], s1, __fmul_rn(rot[3 * i], s0))),
                       t[i]);
    nearest<kM>(px, py, pz, valid, static_cast<size_t>(r) * p.m, p.m, q, &best, cand);
    if (!(best < INFINITY && best <= p.max_d2)) continue;  // no valid lane, or gated
    const float e[3] = {q[0] - cand[0], q[1] - cand[1], q[2] - cand[2]};
    // a = -R hat(s), row-major
    float a[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float r0 = rot[3 * i], r1 = rot[3 * i + 1], r2 = rot[3 * i + 2];
      a[3 * i] = -(r1 * s2 - r2 * s1);
      a[3 * i + 1] = -(r2 * s0 - r0 * s2);
      a[3 * i + 2] = -(r0 * s1 - r1 * s0);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc[A_GT + i] += e[i];
      acc[A_GR + i] += a[i] * e[0] + a[3 + i] * e[1] + a[6 + i] * e[2];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[A_HTR + k] += a[k];
    int u = A_HRR;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) acc[u++] += a[i] * a[j] + a[3 + i] * a[3 + j] + a[6 + i] * a[6 + j];
    acc[A_COUNT] += 1.0;
    acc[A_RES] += sqrtf(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
  }
#pragma unroll
  for (int k = 0; k < A_SIZE; ++k) {
    double v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (tid < A_SIZE) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += part[w][tid];
    sums[tid] = v;
  }
  __syncthreads();
}

// (H + damping scale I) x = g by Cholesky, as lin3.solve6_damped; false
// where the factorization fails (a pivot not > 0)
__device__ bool solve6(const float* h, const float* g, float* x) {
  float l[36];
  float tr = 0.f;
  for (int i = 0; i < 6; ++i) tr += h[7 * i];
  const float scale = fmaxf(tr / 6.f, 1.f);
  for (int k = 0; k < 36; ++k) l[k] = h[k];
  for (int i = 0; i < 6; ++i) l[7 * i] += kDamping * scale;
  for (int j = 0; j < 6; ++j) {
    float d = l[7 * j];
    for (int k = 0; k < j; ++k) d -= l[6 * j + k] * l[6 * j + k];
    if (!(d > 0.f)) return false;
    d = sqrtf(d);
    l[7 * j] = d;
    for (int i = j + 1; i < 6; ++i) {
      float v = l[6 * i + j];
      for (int k = 0; k < j; ++k) v -= l[6 * i + k] * l[6 * j + k];
      l[6 * i + j] = v / d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float v = g[i];
    for (int k = 0; k < i; ++k) v -= l[6 * i + k] * y[k];
    y[i] = v / l[7 * i];
  }
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
    for (int k = i + 1; k < 6; ++k) v -= l[6 * k + i] * x[k];
    x[i] = v / l[7 * i];
  }
  return true;
}

// the trust-region test of the JAX body (gn.py:157-167)
__device__ bool moved_beyond(const float* tm, const float* tg, float radius, float dist) {
  const float d[3] = {tm[3] - tg[3], tm[7] - tg[7], tm[11] - tg[11]};
  const float dt = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  float fro = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float v = tm[4 * i] * tg[4 * j] + tm[4 * i + 1] * tg[4 * j + 1]
                      + tm[4 * i + 2] * tg[4 * j + 2] - (i == j ? 1.f : 0.f);
      fro += v * v;
    }
  const float theta = sqrtf(fro) / sqrtf(2.f);
  return dt + theta * radius > dist;
}

template <int kM>
__global__ void __launch_bounds__(kThreads)
icp_gn_kernel(const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ pz, const unsigned char* __restrict__ valid,
              const float* __restrict__ src, int* __restrict__ carry,
              const float* __restrict__ radius_ptr, Params p) {
  __shared__ double part[kWarps][A_SIZE];
  __shared__ double sums[A_SIZE];
  __shared__ int ci[C_SIZE];        // the carry (thread 0's)
  __shared__ float pose[12];        // R[9] t[3] of the iteration
  __shared__ int go;
  float* cf = reinterpret_cast<float*>(ci);
  const int tid = threadIdx.x;
  // thread 0's iteration state
  bool fresh = true, refresh = false, moved = true;
  const float radius = p.skip_dist > 0.f ? *radius_ptr : 0.f;

  if (tid == 0)
    for (int k = 0; k < C_SIZE; ++k) ci[k] = carry[k];

  for (;;) {
    if (tid == 0) {
      int run = 0;
      if (!(ci[C_GATHERS] < p.max_iters && ci[C_IT] < p.max_total && !ci[C_DONE])) {
        ci[C_STATUS] = S_DONE;
      } else {
        moved = p.skip_dist > 0.f ? moved_beyond(cf + C_T_MAT, cf + C_T_GATHER, radius,
                                                  p.skip_dist)
                                  : true;
        const bool want = ci[C_SINCE_GATHER] >= p.corr_every || ci[C_FORCE_GATHER];
        refresh = (want && moved) || ci[C_IT] == 0;
        if (refresh && !fresh) {
          ci[C_STATUS] = S_NEED_GATHER;
        } else {
          if (refresh) {
            for (int k = 0; k < 16; ++k) cf[C_T_GATHER + k] = cf[C_T_MAT + k];
            fresh = false;
          }
          for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) pose[3 * i + j] = cf[C_T_MAT + 4 * i + j];
            pose[9 + i] = cf[C_T_MAT + 4 * i + 3];
          }
          run = 1;
        }
      }
      go = run;
    }
    __syncthreads();
    if (!go) break;

    float rot[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
    linearize<kM>(px, py, pz, valid, src, p, rot, t, part, sums);

    if (tid == 0) {
      float h[36], g[6], x[6];
      const float cnt = static_cast<float>(sums[A_COUNT]);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          h[6 * i + j] = i == j ? cnt : 0.f;
          h[6 * i + 3 + j] = static_cast<float>(sums[A_HTR + 3 * i + j]);
          h[6 * (3 + j) + i] = h[6 * i + 3 + j];
        }
      int u = A_HRR;
      for (int i = 0; i < 3; ++i)
        for (int j = i; j < 3; ++j) {
          h[6 * (3 + i) + 3 + j] = static_cast<float>(sums[u++]);
          h[6 * (3 + j) + 3 + i] = h[6 * (3 + i) + 3 + j];
        }
      for (int i = 0; i < 3; ++i) {
        g[i] = static_cast<float>(-sums[A_GT + i]);
        g[3 + i] = static_cast<float>(-sums[A_GR + i]);
      }
      if (!solve6(h, g, x))
        for (int k = 0; k < 6; ++k) x[k] = NAN;
      // the ICP update: t += dt, R := R Exp(dr)
      float e[9], rn[9];
      so3::exp(x + 3, e);
      so3::mul(rot, e, rn);
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) cf[C_T_MAT + 4 * i + j] = rn[3 * i + j];
        cf[C_T_MAT + 4 * i + 3] = t[i] + x[i];
      }
      const float rnorm = sqrtf(x[3] * x[3] + x[4] * x[4] + x[5] * x[5]);
      const float pnorm = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
      const int nv = static_cast<int>(cnt);
      const bool enough = nv >= p.min_valid;
      const bool conv = rnorm < p.rot_eps && pnorm < p.pos_eps && enough;
      const bool exact = refresh || !moved;
      const bool stall = p.use_stall && exact
                         && fabsf(rnorm - cf[C_LAST_ROT]) < p.stall_eps
                         && fabsf(pnorm - cf[C_LAST_POS]) < p.stall_eps;
      const bool settled = conv || stall;
      ci[C_IT] += 1;
      ci[C_GATHERS] += refresh ? 1 : 0;
      ci[C_SINCE_GATHER] = refresh ? 1 : ci[C_SINCE_GATHER] + 1;
      ci[C_FORCE_GATHER] = settled && !exact;
      ci[C_DONE] = settled && exact;
      ci[C_CONVERGED] = (conv || (stall && enough)) && exact;
      if (exact) {
        cf[C_LAST_ROT] = rnorm;
        cf[C_LAST_POS] = pnorm;
      }
      ci[C_NUM_VALID] = nv;
      cf[C_TOTAL_RES] = static_cast<float>(sums[A_RES]);
    }
  }
  if (tid == 0)
    for (int k = 0; k < C_SIZE; ++k) carry[k] = ci[k];
}

}  // namespace

extern "C" int icp_gn_launch(const float* px, const float* py, const float* pz,
                             const unsigned char* valid, const float* src, int* carry,
                             const float* radius, int n, int m, int max_iters, int max_total,
                             int corr_every, int min_valid, int use_stall, float rot_eps,
                             float pos_eps, float stall_eps, float skip_dist, float max_d2,
                             void* stream) {
  const Params p{n, m, max_iters, max_total, corr_every, min_valid, use_stall,
                 rot_eps, pos_eps, stall_eps, skip_dist, max_d2};
  const auto bits = reinterpret_cast<uintptr_t>(px) | reinterpret_cast<uintptr_t>(py)
                    | reinterpret_cast<uintptr_t>(pz) | reinterpret_cast<uintptr_t>(valid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 16 && (bits & 15) == 0)  // 16-byte rows: the vector loads
    icp_gn_kernel<16><<<1, kThreads, 0, st>>>(px, py, pz, valid, src, carry, radius, p);
  else
    icp_gn_kernel<0><<<1, kThreads, 0, st>>>(px, py, pz, valid, src, carry, radius, p);
  return static_cast<int>(cudaGetLastError());
}
