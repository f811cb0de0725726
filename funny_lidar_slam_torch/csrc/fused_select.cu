// fused_select: K-nearest stencil candidates per voxel-sorted query.
//
// Replaces the TPU Pallas kernel funny_lidar_slam_tpu/ops/pallas_select.py
// (fused_select, body _kernel, mask _stencil_mask). Same function, not the
// TPU design: the TPU kernel spreads group windows to queries with a one-hot
// MXU matmul over a banded two-block window because its gathers are slow;
// here the gather is a plain indexed read.
//
// Per query q:
//   row   = cand_tab[clamp(gid[q])]: 8 block rows of [x(plane)|y(plane)|z(plane)]
//   d2_j  = |p_j - q|^2 for every candidate lane j < 8*plane (512 at bucket 8)
//   mask  = stencil test of lane j's window voxel against the query parity
//           (2 - (qvox & 1)); masked lanes get +inf
//   key_j = d2_j * (1 + 2e-7*j) + 1e-30*j   (breaks exact ties by lane)
//   K rounds: each extracts exactly ONE winner, the lowest key with the lowest
//   lane on an exact key tie; the reported value is the exact d2.
//
// Design: one warp per query. Lane l holds candidates j = l + 32*i
// (i < 8*plane/32) in registers, so the row read is coalesced; each round is
// a per-thread argmin then a warp butterfly argmin on (key, j). Queries of one
// group are adjacent in sorted order, so L1/L2 serve the repeated row.
//
// Bound on an H100 at the mapping shape (N=16384, Gp=8192, plane=64, K=16):
// memory. The unique cover rows read (<= Gp * 6 KB, ~50 MB when every group
// slot is used) dominate; the outputs are 4*N*K*4 B = 4 MB; arithmetic is
// ~N*512*(11+K) operations, a few microseconds at the f32 peak.
//
// Built by funny_lidar_slam_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int CPT>  // candidates per thread = 8*plane/32
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_select_kernel(const float* __restrict__ cand_tab, const int* __restrict__ gid,
                    const float* __restrict__ qpts, const int* __restrict__ qvox,
                    float* __restrict__ out_d2, float* __restrict__ out_x,
                    float* __restrict__ out_y, float* __restrict__ out_z,
                    int n, int gp, int k, int stencil) {
  constexpr int kPlane = 4 * CPT;       // 8*plane = 32*CPT
  constexpr int kBucket = kPlane / 8;
  constexpr int kRow = 3 * kPlane;      // one block row
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warp leaves together

  const int g = min(max(gid[q], 0), gp - 1);
  const float* row = cand_tab + static_cast<size_t>(g) * (8 * kRow);
  const float qx = qpts[3 * q], qy = qpts[3 * q + 1], qz = qpts[3 * q + 2];
  const int qwx = 2 - (qvox[3 * q] & 1);
  const int qwy = 2 - (qvox[3 * q + 1] & 1);
  const int qwz = 2 - (qvox[3 * q + 2] & 1);

  float d2[CPT], key[CPT], px[CPT], py[CPT], pz[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int j = lane + 32 * i;
    const int blk = j / kPlane;
    const int within = j - blk * kPlane;
    const int l = within / kBucket;
    const float* b = row + blk * kRow + within;
    const float x = __ldg(b), y = __ldg(b + kPlane), z = __ldg(b + 2 * kPlane);
    const float dx = __fsub_rn(x, qx), dy = __fsub_rn(y, qy), dz = __fsub_rn(z, qz);
    float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    const int ax = abs(2 * (blk >> 2) + (l >> 2) - qwx);
    const int ay = abs(2 * ((blk >> 1) & 1) + ((l >> 1) & 1) - qwy);
    const int az = abs(2 * (blk & 1) + (l & 1) - qwz);
    const bool in26 = ax <= 1 && ay <= 1 && az <= 1;
    bool keep;
    if (stencil == 0) keep = ax == 0 && ay == 0 && az == 0;        // center
    else if (stencil == 1) keep = in26 && ax + ay + az <= 1;       // nearby6
    else if (stencil == 2) keep = in26 && !(ax == 1 && ay == 1 && az == 1);  // nearby18
    else keep = in26;                                              // nearby26
    if (!keep) d = CUDART_INF_F;
    const float fj = static_cast<float>(j);
    d2[i] = d;
    key[i] = __fadd_rn(__fmul_rn(d, __fadd_rn(1.0f, __fmul_rn(2e-7f, fj))),
                       __fmul_rn(1e-30f, fj));
    px[i] = x;
    py[i] = y;
    pz[i] = z;
  }

  unsigned taken = 0u;  // bit i: candidate i of this lane already extracted
  float rd = CUDART_INF_F, rx = 0.f, ry = 0.f, rz = 0.f;  // lane r keeps round r
  for (int r = 0; r < k; ++r) {
    float bk = CUDART_INF_F;
    int bj = INT_MAX;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int j = lane + 32 * i;
      const bool avail = !((taken >> i) & 1u);
      if (avail && (key[i] < bk || (key[i] == bk && j < bj))) {
        bk = key[i];
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_xor_sync(kFull, bk, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (ok < bk || (ok == bk && oj < bj)) {
        bk = ok;
        bj = oj;
      }
    }
    const int owner = bj & 31;
    const int slot = bj >> 5;
    float wd = CUDART_NAN_F, wx = 0.f, wy = 0.f, wz = 0.f;  // NaN keys: no winner
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (i == slot) {
        wd = d2[i];
        wx = px[i];
        wy = py[i];
        wz = pz[i];
      }
    }
    if (lane == owner && bj != INT_MAX) taken |= 1u << slot;
    wd = __shfl_sync(kFull, wd, owner);
    wx = __shfl_sync(kFull, wx, owner);
    wy = __shfl_sync(kFull, wy, owner);
    wz = __shfl_sync(kFull, wz, owner);
    if (lane == r) {
      rd = bj == INT_MAX ? CUDART_NAN_F : wd;
      rx = wx;
      ry = wy;
      rz = wz;
    }
  }
  if (lane < k) {
    const size_t o = static_cast<size_t>(q) * k + lane;
    out_d2[o] = rd;
    out_x[o] = rx;
    out_y[o] = ry;
    out_z[o] = rz;
  }
}

template <int CPT>
void launch(const float* cand_tab, const int* gid, const float* qpts, const int* qvox,
            float* d2, float* x, float* y, float* z, int n, int gp, int k, int stencil,
            cudaStream_t stream) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fused_select_kernel<CPT><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      cand_tab, gid, qpts, qvox, d2, x, y, z, n, gp, k, stencil);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after launch.
extern "C" int fused_select_launch(const void* cand_tab, const void* gid, const void* qpts,
                                   const void* qvox, void* out_d2, void* out_x,
                                   void* out_y, void* out_z, int n, int gp, int plane,
                                   int k, int stencil, void* stream) {
  if (n <= 0) return 0;
  if (gp <= 0 || k < 1 || k > 32 || k > 8 * plane) return static_cast<int>(cudaErrorInvalidValue);
  auto* t = static_cast<const float*>(cand_tab);
  auto* g = static_cast<const int*>(gid);
  auto* p = static_cast<const float*>(qpts);
  auto* v = static_cast<const int*>(qvox);
  auto* d = static_cast<float*>(out_d2);
  auto* x = static_cast<float*>(out_x);
  auto* y = static_cast<float*>(out_y);
  auto* z = static_cast<float*>(out_z);
  auto s = static_cast<cudaStream_t>(stream);
  switch (plane) {
    case 8: launch<2>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 16: launch<4>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 32: launch<8>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 64: launch<16>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 128: launch<32>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
