// fused_select: K-nearest stencil candidates per voxel-sorted query.
//
// Replaces the TPU Pallas kernel funny_lidar_slam_tpu/ops/pallas_select.py:164
// (fused_select; body _kernel :90, mask _stencil_mask :57). Same function, not
// the TPU design: the TPU kernel spreads group windows to queries with a
// one-hot MXU matmul over a banded two-block window because its gathers are
// slow; here a block copies its queries' cover rows into shared memory.
//
// Per query q:
//   row   = cand_tab[clamp(gid[q])]: 8 block rows of [x(plane)|y(plane)|z(plane)]
//   d2_j  = |p_j - q|^2 for every candidate lane j < 8*plane (512 at plane 64)
//   mask  = stencil test of lane j's window voxel against the query parity
//           (2 - (qvox & 1)); masked lanes get +inf
//   key_j = d2_j * (1 + 2e-7*j) + 1e-30*j   (breaks exact ties by lane)
//   K rounds: each extracts exactly ONE winner, the lowest key with the lowest
//   lane on an exact key tie; the reported value is the exact d2.
//
// Bound on an H100 at the grid shape (N=16384, Gp=8192, plane 64, K=16):
// bytes. The distinct cover rows (6,433 of 6 KB, 39.5 MB), the queries and
// the 4 MB of outputs take 0.013 ms at 3.35 TB/s; the arithmetic,
// N*512*(12+K) f32 operations, takes 3.5 us at 67 TFLOP/s. So the time over
// the bound is latency and issue, and the design is about those:
//  - Staging. A block of 8 warps takes 8 consecutive sorted queries. Their
//    group ids do not decrease, so the block's rows are the range
//    [gid[q0], gid[q7]]: at most 8 rows of 96*plane bytes. One thread arms an
//    mbarrier and starts one cp.async.bulk for the range; the other blocks on
//    the SM overlap the copy. A query whose row lies outside the staged
//    range (a gid that decreases, or a range of more than 8 rows) reads its
//    row from global memory, so any gid gives the right answer.
//  - Occupancy. A lane keeps only the keys of its candidates j = lane + 32*i,
//    as uint32 bits: for keys >= 0 the unsigned order is the float order,
//    +inf sorts above every finite key and NaN above +inf. It keeps no
//    coordinates and no d2, so up to plane 64 a thread fits in 64 registers
//    and 4 blocks (32 warps) stay resident on an SM.
//  - Rounds. Each lane keeps its smallest and second smallest (key, i), the
//    lower i on a tie. A round is two warp reductions (__reduce_min_sync):
//    the warp's minimum key, then the lowest j among the lanes that hold it.
//    The owner marks that slot taken and promotes its second key. Only when
//    an owner had no second key left does the warp recompute every lane's
//    two smallest untaken keys, by a log2(CPT)-level tree whose indices are
//    all static (a dynamic register index would spill). A common round is
//    about 30 SASS instructions; a tree recomputed every round, the first
//    design of this kernel, made it about 100.
//  - Early end. Once the warp's minimum key is +inf or NaN, no finite key is
//    left and the rounds stop; the rest report d2 = +inf and the sentinel
//    coordinate 1e30 (callers read only entries with d2 < 1e18).
//  - Winners. Lane r reads x, y, z of round r's winner from the staged row
//    and recomputes its d2 with the same rounded ops: bit for bit the value
//    a carried d2 would have had.
//
// Not the tensor cores: the distance work is 3.5 us of f32 against a kernel
// bound by latency and issue, and the matrix form |p|^2 - 2p.q + |q|^2 would
// lose the exact d2 (at map coordinates near 100 m, |p|^2 ~ 1e4 against d2 ~
// 0.01-1).
//
// Built by funny_lidar_slam_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // queries a block, and cover rows it stages
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kRetired = 0xffffffffu;   // above every key, NaN included
constexpr uint32_t kNotFinite = 0x7f800000u;  // +inf; keys from here up are +inf or NaN
constexpr float kSentinel = 1e30f;

// CPT = 8*plane/32 candidates a lane; one cover row is 24*plane floats
template <int CPT>
__host__ __device__ constexpr int cover_floats() { return 96 * CPT; }

template <int CPT>
__host__ __device__ constexpr int stage_bytes() { return kWarpsPerBlock * cover_floats<CPT>() * 4; }

// resident blocks asked of ptxas: 4 (64 registers) up to plane 64
template <int CPT>
__host__ __device__ constexpr int min_blocks() { return CPT <= 16 ? 4 : 2; }

struct Query {
  float x, y, z;
  int wx, wy, wz;  // the query voxel's window coordinate, 2 - (v & 1)
};

__device__ __forceinline__ float dist2(float x, float y, float z, const Query& q) {
  const float dx = __fsub_rn(x, q.x), dy = __fsub_rn(y, q.y), dz = __fsub_rn(z, q.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the keys (as bits) of this lane's candidates j = lane + 32*i of one cover row
template <int CPT>
__device__ __forceinline__ void lane_keys(const float* row, const Query& q, int stencil,
                                          int lane, uint32_t (&key)[CPT]) {
  constexpr int kPlane = 4 * CPT;
  constexpr int kBucket = kPlane / 8;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int j = lane + 32 * i;
    const int blk = j / kPlane;
    const int within = j - blk * kPlane;
    const int l = within / kBucket;
    const float* b = row + blk * 3 * kPlane + within;
    float d = dist2(b[0], b[kPlane], b[2 * kPlane], q);
    const int ax = abs(2 * (blk >> 2) + (l >> 2) - q.wx);
    const int ay = abs(2 * ((blk >> 1) & 1) + ((l >> 1) & 1) - q.wy);
    const int az = abs(2 * (blk & 1) + (l & 1) - q.wz);
    const bool in26 = ax <= 1 && ay <= 1 && az <= 1;
    bool keep;
    if (stencil == 0) keep = ax == 0 && ay == 0 && az == 0;        // center
    else if (stencil == 1) keep = in26 && ax + ay + az <= 1;       // nearby6
    else if (stencil == 2) keep = in26 && !(ax == 1 && ay == 1 && az == 1);  // nearby18
    else keep = in26;                                              // nearby26
    if (!keep) d = CUDART_INF_F;
    const float fj = static_cast<float>(j);
    key[i] = __float_as_uint(__fadd_rn(__fmul_rn(d, __fadd_rn(1.0f, __fmul_rn(2e-7f, fj))),
                                       __fmul_rn(1e-30f, fj)));
  }
}

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// this lane's minimum key and its slot i (the lowest i on a tie), by a tree
// of log2(CPT) levels; every index is a constant once the loops unroll
template <int CPT>
__device__ __forceinline__ void lane_min(const uint32_t (&key)[CPT], uint32_t& mk, int& mi) {
  uint32_t tk[CPT / 2];
  int ti[CPT / 2];
#pragma unroll
  for (int t = 0; t < CPT / 2; ++t) {
    const bool upper = key[2 * t + 1] < key[2 * t];  // strict: the lower slot keeps a tie
    tk[t] = min(key[2 * t], key[2 * t + 1]);
    ti[t] = upper ? 2 * t + 1 : 2 * t;
  }
#pragma unroll
  for (int level = 1; level < ilog2(CPT); ++level) {
    const int w = CPT >> (level + 1);
#pragma unroll
    for (int t = 0; t < w; ++t) {
      const bool upper = tk[2 * t + 1] < tk[2 * t];
      tk[t] = min(tk[2 * t], tk[2 * t + 1]);
      ti[t] = upper ? ti[2 * t + 1] : ti[2 * t];
    }
  }
  mk = tk[0];
  mi = ti[0];
}

// this lane's two smallest keys among the slots not in `taken`, in the
// order (key, i): (m1, i1) then (m2, i2); kRetired where none is left
template <int CPT>
__device__ __forceinline__ void lane_top2(const uint32_t (&key)[CPT], uint32_t taken,
                                          uint32_t& m1, int& i1, uint32_t& m2, int& i2) {
  uint32_t a1[CPT / 2], a2[CPT / 2];
  int x1[CPT / 2], x2[CPT / 2];
#pragma unroll
  for (int t = 0; t < CPT / 2; ++t) {
    const uint32_t lo = (taken >> (2 * t)) & 1u ? kRetired : key[2 * t];
    const uint32_t hi = (taken >> (2 * t + 1)) & 1u ? kRetired : key[2 * t + 1];
    const bool upper = hi < lo;
    a1[t] = min(lo, hi);
    a2[t] = max(lo, hi);
    x1[t] = upper ? 2 * t + 1 : 2 * t;
    x2[t] = upper ? 2 * t : 2 * t + 1;
  }
#pragma unroll
  for (int level = 1; level < ilog2(CPT); ++level) {
    const int w = CPT >> (level + 1);
#pragma unroll
    for (int t = 0; t < w; ++t) {
      const int a = 2 * t, b = 2 * t + 1;  // every index of a is below every index of b
      const bool bwin = a1[b] < a1[a];
      // the second is the loser's first or the winner's second; on a key tie the a side
      const uint32_t c = bwin ? a1[a] : a2[a], d = bwin ? a2[b] : a1[b];
      const int xc = bwin ? x1[a] : x2[a], xd = bwin ? x2[b] : x1[b];
      const int first_x = bwin ? x1[b] : x1[a];
      a1[t] = min(a1[a], a1[b]);
      x1[t] = first_x;
      a2[t] = min(c, d);
      x2[t] = d < c ? xd : xc;
    }
  }
  m1 = a1[0];
  i1 = x1[0];
  m2 = a2[0];
  i2 = x2[0];
}

template <int CPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, min_blocks<CPT>())
fused_select_kernel(const float* __restrict__ cand_tab, const int* __restrict__ gid,
                    const float* __restrict__ qpts, const int* __restrict__ qvox,
                    float* __restrict__ out_d2, float* __restrict__ out_x,
                    float* __restrict__ out_y, float* __restrict__ out_z,
                    int n, int gp, int k, int stencil) {
  constexpr int kPlane = 4 * CPT;
  constexpr int kCover = cover_floats<CPT>();
  extern __shared__ __align__(16) float rows[];  // the staged cover rows
  __shared__ uint64_t bar;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kWarpsPerBlock;
  const int q = q0 + (threadIdx.x >> 5);
  const bool active = q < n;  // whole warps

  // the staged rows [lo, lo + nrows), from the block's first and last query
  const int lo = min(max(gid[q0], 0), gp - 1);
  const int hi = min(max(gid[min(q0 + kWarpsPerBlock, n) - 1], 0), gp - 1);
  const int nrows = hi >= lo ? min(hi - lo + 1, kWarpsPerBlock) : 1;
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(nrows * kCover * 4);
    async_copy::mbar_init(&bar, 1);
    async_copy::fence_mbar_init();
    async_copy::mbar_expect_tx(&bar, bytes);
    async_copy::bulk_copy_g2s(rows, cand_tab + static_cast<size_t>(lo) * kCover, bytes, &bar);
  }
  Query qq{};
  int g = lo;
  if (active) {  // in the copy's shadow
    qq.x = qpts[3 * q];
    qq.y = qpts[3 * q + 1];
    qq.z = qpts[3 * q + 2];
    qq.wx = 2 - (qvox[3 * q] & 1);
    qq.wy = 2 - (qvox[3 * q + 1] & 1);
    qq.wz = 2 - (qvox[3 * q + 2] & 1);
    g = min(max(gid[q], 0), gp - 1);
  }
  __syncthreads();  // the barrier's init is visible; warp 0 (always active) waits below
  if (!active) return;
  async_copy::mbar_wait(&bar, 0);

  const bool staged = g >= lo && g < lo + nrows;
  const float* grow = cand_tab + static_cast<size_t>(g) * kCover;
  uint32_t key[CPT];
  if (staged) lane_keys<CPT>(rows + (g - lo) * kCover, qq, stencil, lane, key);
  else lane_keys<CPT>(grow, qq, stencil, lane, key);

  uint32_t m1, m2 = kRetired;
  int i1, i2 = 0;
  lane_min<CPT>(key, m1, i1);
  bool has2 = false;     // (m2, i2) holds this lane's second smallest key
  uint32_t taken = 0u;   // bit i: slot i was a winner
  int found = 0;  // rounds with a winner (the same in every lane)
  int rj = 0;     // lane r < found: round r's winner j
  for (;;) {
    const uint32_t m = __reduce_min_sync(kFull, m1);
    if (m >= kNotFinite) break;  // only +inf and NaN keys left: the early end
    const uint32_t j = __reduce_min_sync(
        kFull, m1 == m ? static_cast<uint32_t>(32 * i1 + lane) : kRetired);
    if (lane == found) rj = static_cast<int>(j);
    if (++found == k) break;
    const bool owner = lane == static_cast<int>(j & 31);
    if (owner) {
      taken |= 1u << i1;
      m1 = m2;
      i1 = i2;
    }
    const bool refresh = __any_sync(kFull, owner && !has2);
    has2 = has2 && !owner;
    if (refresh) {
      lane_top2<CPT>(key, taken, m1, i1, m2, i2);
      has2 = true;
    }
  }

  if (lane < k) {
    float d = CUDART_INF_F, x = kSentinel, y = kSentinel, z = kSentinel;
    if (lane < found) {
      const int blk = rj / kPlane;
      const float* p = (staged ? rows + (g - lo) * kCover : grow) + blk * 3 * kPlane +
                       (rj - blk * kPlane);
      x = p[0];
      y = p[kPlane];
      z = p[2 * kPlane];
      d = dist2(x, y, z, qq);
    }
    const size_t o = static_cast<size_t>(q) * k + lane;
    out_d2[o] = d;
    out_x[o] = x;
    out_y[o] = y;
    out_z[o] = z;
  }
}

// opts in to the staging buffer above 48 KB and asks for the largest
// shared-memory carveout; per call, so that any current device is set
template <int CPT>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(fused_select_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         stage_bytes<CPT>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_select_kernel<CPT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int CPT>
cudaError_t launch(const float* cand_tab, const int* gid, const float* qpts, const int* qvox,
                   float* d2, float* x, float* y, float* z, int n, int gp, int k, int stencil,
                   cudaStream_t stream) {
  const cudaError_t err = configure<CPT>();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fused_select_kernel<CPT><<<grid, kWarpsPerBlock * 32, stage_bytes<CPT>(), stream>>>(
      cand_tab, gid, qpts, qvox, d2, x, y, z, n, gp, k, stencil);
  return cudaGetLastError();
}

template <int CPT>
int resident_blocks() {
  int blocks = 0;
  cudaError_t err = configure<CPT>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_select_kernel<CPT>,
                                                        kWarpsPerBlock * 32, stage_bytes<CPT>());
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after launch.
// cand_tab must be 16-byte aligned (the bulk copy's source).
extern "C" int fused_select_launch(const void* cand_tab, const void* gid, const void* qpts,
                                   const void* qvox, void* out_d2, void* out_x,
                                   void* out_y, void* out_z, int n, int gp, int plane,
                                   int k, int stencil, void* stream) {
  if (n <= 0) return 0;
  if (gp <= 0 || k < 1 || k > 32 || k > 8 * plane ||
      reinterpret_cast<uintptr_t>(cand_tab) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* t = static_cast<const float*>(cand_tab);
  auto* g = static_cast<const int*>(gid);
  auto* p = static_cast<const float*>(qpts);
  auto* v = static_cast<const int*>(qvox);
  auto* d = static_cast<float*>(out_d2);
  auto* x = static_cast<float*>(out_x);
  auto* y = static_cast<float*>(out_y);
  auto* z = static_cast<float*>(out_z);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (plane) {
    case 8: err = launch<2>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 16: err = launch<4>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 32: err = launch<8>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 64: err = launch<16>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    case 128: err = launch<32>(t, g, p, v, d, x, y, z, n, gp, k, stencil, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Blocks of fused_select_kernel resident on one SM of the current device at
// this plane (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the
// staging buffer); a CUDA error as a negative number.
extern "C" int fused_select_occupancy(int plane) {
  switch (plane) {
    case 8: return resident_blocks<2>();
    case 16: return resident_blocks<4>();
    case 32: return resident_blocks<8>();
    case 64: return resident_blocks<16>();
    case 128: return resident_blocks<32>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
