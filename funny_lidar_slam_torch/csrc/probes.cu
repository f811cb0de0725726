// Platform probes: five small kernels, the Hopper counterparts of the TPU
// platform probes in tools/pallas_smoke.py (test_basic, test_dynamic_row_loop,
// test_vector_gather, test_take_along_axis_lanes, test_hbm_dma_rows). Each
// computes what its TPU probe computes; none copies the TPU's block layout.
//
//   scale2            out = x * 2                       one thread per float4
//   row_gather_loop   out[i] = tab[idx[i]]              the block stages its
//                     slice of idx in shared memory once (the counterpart of
//                     scalar prefetch); one warp copies one row, a float4 a lane
//   row_gather_vector out[i,c] = tab[idx[i],c]          one thread per element
//                     (the elementwise form of jnp.take)
//   lane_gather       out[b,j] = x[b, idx[b,j]]         one block per row b
//                     stages x[b,:] in shared memory with coalesced loads
//   dma_rows          out[i] = tab[idx[i]]              an 8-slot ring of rows
//                     in shared memory, one mbarrier per slot: an elected lane
//                     starts a 1-D bulk async copy (cp.async.bulk, global ->
//                     shared, complete_tx of the row's bytes) for row i into
//                     slot i % 8; the warp waits on the slot's phase and copies
//                     the slot to out[i]. The counterpart of
//                     pltpu.make_async_copy plus a DMA semaphore.
//
// Every gather clamps its index to [0, C), as a JAX gather clamps.
//
// Bound on an H100: memory, for all five. They move a few bytes per element
// and do no arithmetic to speak of; at the probe shapes they are a few
// microseconds of bytes, so launch latency dominates their times.
//
// Built by funny_lidar_slam_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 64;  // row_gather_loop: rows staged per block
constexpr int kSlots = 8;          // dma_rows: ring depth
constexpr int kDmaRowsPerWarp = 16;  // each slot is used twice per warp

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

__global__ void __launch_bounds__(kThreads)
row_gather_loop_kernel(const float4* __restrict__ tab, const int* __restrict__ idx,
                       float4* __restrict__ out, int c, int d4, int b) {
  __shared__ int s_idx[kRowsPerBlock];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, b - row0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s_idx[r] = clamp_index(idx[row0 + r], c);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float4* src = tab + static_cast<size_t>(s_idx[r]) * d4;
    float4* dst = out + static_cast<size_t>(row0 + r) * d4;
    for (int k = lane; k < d4; k += 32) dst[k] = __ldg(src + k);
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

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int d, int j) {
  extern __shared__ float s_x[];  // one row of x, d floats
  const int b = blockIdx.x;
  const float* xr = x + static_cast<size_t>(b) * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) s_x[k] = xr[k];
  __syncthreads();
  const int* ir = idx + static_cast<size_t>(b) * j;
  float* orow = out + static_cast<size_t>(b) * j;
  for (int k = threadIdx.x; k < j; k += blockDim.x) orow[k] = s_x[clamp_index(ir[k], d)];
}

// --- mbarrier and bulk-copy primitives (PTX, sm_90) ---
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// global -> shared bulk copy of `bytes` (a multiple of 16, both ends 16-B
// aligned); completion is counted on `bar` as transaction bytes
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One warp per block. The warp gathers rows [row0, row0 + rows) through the
// ring: slot s holds rows s, s + 8, ...; the u-th use of a slot completes its
// barrier's phase u, so the wait parity is u & 1.
__global__ void __launch_bounds__(32)
dma_rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                float* __restrict__ out, int c, int d, int b) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_raw);  // kSlots barriers
  float* ring = reinterpret_cast<float*>(s_raw + 16 * ((kSlots * 8 + 15) / 16));
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kDmaRowsPerWarp;
  const int rows = min(kDmaRowsPerWarp, b - row0);
  const uint32_t bytes = static_cast<uint32_t>(d) * 4u;

  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  auto load_row = [&](int r) {  // elected lane: row r of this warp into its slot
    const int s = r % kSlots;
    const float* src = tab + static_cast<size_t>(clamp_index(__ldg(idx + row0 + r), c)) * d;
    mbar_expect_tx(&bars[s], bytes);
    bulk_copy_g2s(ring + static_cast<size_t>(s) * d, src, bytes, &bars[s]);
  };
  if (lane == 0)
    for (int r = 0; r < min(kSlots, rows); ++r) load_row(r);

  const int d4 = d / 4;
  for (int r = 0; r < rows; ++r) {
    const int s = r % kSlots;
    while (!mbar_try_wait(&bars[s], static_cast<uint32_t>((r / kSlots) & 1))) {
    }
    const float4* slot = reinterpret_cast<const float4*>(ring + static_cast<size_t>(s) * d);
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * d);
    for (int k = lane; k < d4; k += 32) dst[k] = slot[k];
    // the slot's generic-proxy reads come before the next async-proxy write
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0 && r + kSlots < rows) load_row(r + kSlots);
  }
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
  row_gather_loop_kernel<<<(b + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
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
  if (d <= 0 || d > 12288) return static_cast<int>(cudaErrorInvalidValue);  // 48 KB of row
  lane_gather_kernel<<<b, kThreads, static_cast<size_t>(d) * 4,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), d, j);
  return last_error();
}

extern "C" int probe_dma_rows_launch(const void* tab, const void* idx, void* out, int c, int d,
                                     int b, void* stream) {
  if (b <= 0) return 0;
  // the ring holds 8 rows in at most 32 KB; rows are whole 16-B units
  if (c <= 0 || d <= 0 || d % 4 != 0 || d > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(tab) || !aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = 16 * ((kSlots * 8 + 15) / 16) + static_cast<size_t>(kSlots) * d * 4;
  dma_rows_kernel<<<(b + kDmaRowsPerWarp - 1) / kDmaRowsPerWarp, 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int*>(idx), static_cast<float*>(out), c,
      d, b);
  return last_error();
}
