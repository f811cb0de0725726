// Platform probes: five small kernels, the Hopper counterparts of the TPU
// platform probes in tools/pallas_smoke.py (test_basic, test_dynamic_row_loop,
// test_vector_gather, test_take_along_axis_lanes, test_hbm_dma_rows). Each
// computes what its TPU probe computes; none copies the TPU's block layout.
//
//   scale2            out = x * 2                       one thread per float4
//   row_gather_loop   out[i] = tab[idx[i]]              8 rows a block, one row
//                     a warp: the block stages its 8 indices in shared memory
//                     once (the counterpart of scalar prefetch); each lane then
//                     issues all its float4 loads of the row (up to 12, a
//                     1536-float row, unrolled into registers) before its
//                     stores, so a warp pays one row round trip after the index
//   row_gather_vector out[i,c] = tab[idx[i],c]          one thread per element
//                     (the elementwise form of jnp.take)
//   lane_gather       out[b,j] = x[b, idx[b,j]]         the B*J outputs taken
//                     flat, four a thread: one 16-byte load of their indices,
//                     four direct reads of x (__ldg, nothing staged: each read
//                     is one of the values the output needs), one 16-byte
//                     store; spread over at least as many blocks as SMs
//   dma_rows          out[i] = tab[idx[i]]              a ring of up to 8 row
//                     slots in shared memory per one-warp block, one mbarrier a
//                     slot. Lane s owns slot s: it starts a 1-D bulk async copy
//                     (cp.async.bulk global -> shared, complete_tx of the row's
//                     bytes) into the slot, waits on the slot's phase parity,
//                     and writes the slot out with a bulk store (shared ->
//                     global, a bulk group); before it refills the slot with
//                     its next row it waits for that store to have read it.
//                     Every lane starts its first copy before any lane waits,
//                     so a block with at most 8 rows pays one round trip. The
//                     counterpart of pltpu.make_async_copy plus a DMA semaphore.
//
// Every gather clamps its index to [0, C), as a JAX gather clamps.
//
// Bound on an H100: memory, for all five. They move a few bytes per element
// and do no arithmetic to speak of; at the probe shapes they are a few
// microseconds of bytes, so launch latency dominates their times. That is
// why the two row gathers spread their rows over at least as many warps as
// the card has SMs and keep each warp's loads in flight together, and the
// lane gather its outputs over at least as many blocks as SMs, a thread's
// four reads of x in flight together.
//
// Built by funny_lidar_slam_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace async_copy;

constexpr int kThreads = 256;
constexpr int kLoopWarps = 8;     // row_gather_loop: rows (one a warp) per block
constexpr int kLoopUnroll = 12;   // row_gather_loop: float4 loads in flight per lane
constexpr int kSlots = 8;         // dma_rows: ring depth of a block
constexpr int kDmaMaxD = 3072;    // dma_rows: widest row in floats (12 KB; a 96 KB ring)
constexpr int kDmaBarBytes = 128; // dma_rows: the barriers, ahead of the 128-B aligned ring
constexpr int kDmaBlocksPerSm = 8;          // dma_rows: most blocks per SM in the grid
constexpr size_t kDmaSmemPerSm = 200 << 10;  // dma_rows: ring bytes per SM the grid aims at

__device__ __forceinline__ int clamp_index(int i, int c) { return min(max(i, 0), c - 1); }

__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float4* __restrict__ x, float4* __restrict__ out, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    float4 v = x[i];
    v.x *= 2.f;
    v.y *= 2.f;
    v.z *= 2.f;
    v.w *= 2.f;
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
scale2_tail_kernel(const float* __restrict__ x, float* __restrict__ out, int start, int n) {
  const int i = start + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.f;
}

__global__ void __launch_bounds__(kLoopWarps * 32)
row_gather_loop_kernel(const float4* __restrict__ tab, const int* __restrict__ idx,
                       float4* __restrict__ out, int c, int d4, int b) {
  __shared__ int s_idx[kLoopWarps];
  const int row0 = blockIdx.x * kLoopWarps;
  const int rows = min(kLoopWarps, b - row0);
  if (threadIdx.x < rows) s_idx[threadIdx.x] = clamp_index(__ldg(idx + row0 + threadIdx.x), c);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp >= rows) return;
  const float4* src = tab + static_cast<size_t>(s_idx[warp]) * d4;
  float4* dst = out + static_cast<size_t>(row0 + warp) * d4;
  for (int k0 = lane; k0 < d4; k0 += 32 * kLoopUnroll) {
    float4 v[kLoopUnroll];
#pragma unroll
    for (int u = 0; u < kLoopUnroll; ++u)
      if (k0 + 32 * u < d4) v[u] = __ldg(src + k0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kLoopUnroll; ++u)
      if (k0 + 32 * u < d4) dst[k0 + 32 * u] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
row_gather_vector_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                         float* __restrict__ out, int c, int d, int b) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(b) * d) return;
  const int i = static_cast<int>(e / d);
  const int col = static_cast<int>(e - static_cast<size_t>(i) * d);
  out[e] = __ldg(tab + static_cast<size_t>(clamp_index(__ldg(idx + i), c)) * d + col);
}

// Thread t < n4 takes outputs 4t..4t+3 of the flat [B*J] output (idx and
// out 16-byte aligned), thread n4 + u the single output 4 n4 + u; the row
// of output e is e / J, so a ragged J needs no padding.
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int d, int j, int n4, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx) + t);
    int b = (4 * t) / j, c = 4 * t - b * j;  // the row and column of output 4t
    const int k[4] = {q.x, q.y, q.z, q.w};
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = __ldg(x + static_cast<size_t>(b) * d + clamp_index(k[u], d));
      if (++c == j) {
        c = 0;
        ++b;
      }
    }
    reinterpret_cast<float4*>(out)[t] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const int e = 4 * n4 + (t - n4);
    if (e < total)
      out[e] = __ldg(x + static_cast<size_t>(e / j) * d + clamp_index(__ldg(idx + e), d));
  }
}

// One warp per block; block k gathers its even share [lo, hi) of the rows,
// q or q + 1 of them (the first `rem` blocks take one more), through a ring
// of min(8, hi - lo) slots. Lane s alone owns slot s and its barrier (init,
// arm, copy in, wait, copy out), so no lane waits on another; it moves rows
// lo + s, lo + s + slots, ... The u-th use of a slot completes its barrier's
// phase u, so the wait parity is u & 1. Lanes without a slot (a block with
// fewer than 8 rows) leave at once and wait on nothing. The first index
// load is issued before the barrier's init, which runs in its shadow.
__global__ void __launch_bounds__(32)
dma_rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                float* __restrict__ out, int c, int d, int q, int rem) {
  extern __shared__ __align__(128) unsigned char s_raw[];
  const int k = blockIdx.x;
  const int lo = k * q + min(k, rem);
  const int hi = lo + q + (k < rem ? 1 : 0);
  const int slots = min(kSlots, hi - lo);
  const int s = threadIdx.x;
  if (s >= slots) return;
  int r = lo + s;
  int row = __ldg(idx + r);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_raw) + s;
  float* slot = reinterpret_cast<float*>(s_raw + kDmaBarBytes) + static_cast<size_t>(s) * d;
  const uint32_t bytes = static_cast<uint32_t>(d) * 4u;
  mbar_init(bar, 1);
  fence_mbar_init();  // the barrier is initialized before the copy engine counts on it

  row = clamp_index(row, c);
  for (uint32_t use = 0;; ++use) {
    mbar_expect_tx(bar, bytes);
    bulk_copy_g2s(slot, tab + static_cast<size_t>(row) * d, bytes, bar);
    const int next = r + slots;
    if (next < hi) row = clamp_index(__ldg(idx + next), c);  // under the copy
    mbar_wait(bar, use & 1);
    fence_proxy_async();
    bulk_copy_s2g(out + static_cast<size_t>(r) * d, slot, bytes);
    bulk_commit();
    if (next >= hi) break;
    r = next;
    bulk_wait_read();  // the store has read the slot before the next copy refills it
  }
  bulk_wait_read();  // the block's shared memory outlives its last store's read
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() after
// its launch.
extern "C" int probe_scale2_launch(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  if (!aligned16(x) || !aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const int n4 = n / 4;
  if (n4 > 0)
    scale2_kernel<<<(n4 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out), n4);
  if (4 * n4 < n)
    scale2_tail_kernel<<<1, kThreads, 0, s>>>(static_cast<const float*>(x),
                                              static_cast<float*>(out), 4 * n4, n);
  return last_error();
}

extern "C" int probe_row_gather_loop_launch(const void* tab, const void* idx, void* out, int c,
                                            int d, int b, void* stream) {
  if (b <= 0) return 0;
  if (c <= 0 || d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(tab) || !aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  row_gather_loop_kernel<<<(b + kLoopWarps - 1) / kLoopWarps, kLoopWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tab), static_cast<const int*>(idx), static_cast<float4*>(out),
      c, d / 4, b);
  return last_error();
}

extern "C" int probe_row_gather_vector_launch(const void* tab, const void* idx, void* out,
                                              int c, int d, int b, void* stream) {
  if (b <= 0 || d <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(b) * d;
  row_gather_vector_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), static_cast<float*>(out), c,
      d, b);
  return last_error();
}

extern "C" int probe_lane_gather_launch(const void* x, const void* idx, void* out, int b, int d,
                                        int j, void* stream) {
  if (b <= 0 || j <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * j;
  if (total > INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // four outputs a thread where idx and out allow 16-byte accesses
  const int n4 = aligned16(idx) && aligned16(out) ? static_cast<int>(total / 4) : 0;
  const int threads = n4 + static_cast<int>(total - 4LL * n4);
  // the widest block (a multiple of a warp, at most kThreads) that still
  // gives every SM a block
  const int block = std::max(32, std::min(kThreads, threads / std::max(sms, 1) / 32 * 32));
  lane_gather_kernel<<<(threads + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), d, j,
      n4, static_cast<int>(total));
  return last_error();
}

extern "C" int probe_dma_rows_launch(const void* tab, const void* idx, void* out, int c, int d,
                                     int b, void* stream) {
  if (b <= 0) return 0;
  // rows are whole 16-B units of at most 3072 floats: 8 slots in 96 KB
  if (c <= 0 || d <= 0 || d % 4 != 0 || d > kDmaMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(tab) || !aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as the SMs hold full rings of this width (at most 8 an
  // SM), but at least 2 rows a block (fewer blocks to launch; at B=512 still
  // 256 blocks on 132 SMs); each block takes an even share of the rows
  const size_t row_bytes = static_cast<size_t>(d) * 4;
  const size_t full_ring = kDmaBarBytes + kSlots * row_bytes;
  const int per_sm = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(kDmaBlocksPerSm, kDmaSmemPerSm / full_ring)));
  const int blocks = std::min((b + 1) / 2, per_sm * sms);
  const int q = b / blocks, rem = b % blocks;
  const size_t smem = kDmaBarBytes + std::min(kSlots, q + (rem > 0 ? 1 : 0)) * row_bytes;
  if (smem > (48u << 10)) {  // above the default dynamic limit: opt in
    err = cudaFuncSetAttribute(dma_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dma_rows_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), static_cast<float*>(out), c,
      d, q, rem);
  return last_error();
}
