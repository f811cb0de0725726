// The LOAM corner selection of one ordered scan, one launch:
//
//   loam_corners_kernel  the roughness, the occlusion and parallel-beam
//                        marks, the row guard, the block lattice and the
//                        greedy corner picks of every angular block.
//                        Replaces the jitted feature extraction of
//                        funny_lidar_slam_tpu/loam/features.py
//                        (`extract_features` up to the corner mask, with
//                        its `lax.scan` of masked argmax picks), plain
//                        version loam/features.py::corner_mask_plain.
//
// Bound: bytes. The call reads depth, col and row (4 B a point), the mask
// (1 B) and the row bounds, and writes the corner mask (1 B a point):
// ~230 KB at 16,384 points, well under a microsecond at 3.35 TB/s, and a
// few hundred operations a point. What holds it is latency: the block's
// reads before its first score, and its picks, a chain of up to
// max_corners dependent argmaxes.
//
// Design: one thread block an angular block, B = rows x blocks_per_row of
// them, of ceil(l_max / 32) warps (at most 16), a thread a lane offset (a
// thread several offsets above 512 lanes).
// Block b of row r spans len6 = floor((end - start - 11) / blocks_per_row)
// packed points from b_start = start + 5 + i len6; its lanes are the
// offsets 0..l_max-1, in block where offset < len6 and the packed index is
// below n (the first L lanes).
//   1. Stage: the block's window, packed indices b_start - 6 .. b_start +
//      L + 5 taken modulo n as the plain version's rolls take them, is
//      loaded into shared memory by coalesced loads (depth, col, mask; 9 B
//      a point). Each thread's own row id is loaded beside it.
//   2. Score: every thread takes its lane's 13 window points (offsets -6
//      .. +6) from shared memory into registers and computes, with no other
//      read, the score the plain version's argmax reads: the roughness
//      where the point is pickable (in block, masked in, inside its row's
//      guard, no occlusion or parallel-beam mark), else -1. The score is
//      kept as an order-preserving uint32 key: a NaN above every number,
//      -0 as +0, so that a larger key is the plain argmax's larger score.
//   3. Pick, in warp 0 alone: each lane holds the keys of its offsets
//      lane, lane + 32, ... in registers (K of them, K = 8 or 16 by the
//      launcher; K = 0 keeps them in shared memory, for l_max above 512,
//      or for every l_max where built with -DFLS_CORNER_KEYS_IN_SMEM, to
//      time the two against each other).
//      A pick is a lane-local first maximum, then two warp reductions:
//      __reduce_max_sync of the key, __reduce_min_sync of the offset among
//      the lanes that hold it (the lowest offset among equal scores, a NaN
//      first, as torch.argmax). A pick above corner_threshold marks its
//      offset picked on the lane that owns it, and the keys of offsets
//      p-5..p+5 are set to -1's (the plain version's suppression of
//      `pickable`). A pick at or below the threshold ends the block, as
//      every later pick of the plain loop repeats it. After the picks each
//      lane writes True at clamp(b_start + p, 0, n - 1), where the scan's
//      mask holds there, for the offsets it picked.
// Blocks write True only, into a mask the caller zeroed, so no write of
// one block can undo another's. The fill stays outside the kernel: a pick
// of an out-of-block lane (a threshold below -1) writes at a clamped index
// in another block's span or at n - 1, and the points of no block (a
// row's first 5 and last 6) belong to none, so zeroing inside the kernel
// would need a barrier across the grid.
//
// Row bounds are the projection's (row_start >= 0), so every lane in block
// has a packed index in [0, n) and its 13 points in the window. (The plain
// version clamps a negative index to 0; a row starting below -5 is not
// supported.)
//
// Arithmetic as the plain version's, each float operation rounded once
// (__fadd_rn / __fmul_rn / __fsub_rn, so nvcc contracts nothing into an
// FMA): roughness acc = -10 d, then acc = (acc + d[i-k]) + d[i+k] for k =
// 1..5, then acc * acc, over d = depth where masked in, else 0; the marks
// compare float32 differences with the float32 thresholds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kHalo = 6;          // window points either side of a lane
constexpr int kSpan = 2 * kHalo + 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNanKey = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no offset

__device__ __forceinline__ int wrap(int j, int n) {
  const int r = j % n;
  return r < 0 ? r + n : r;
}

struct Scan {
  const float* __restrict__ depth;
  const int* __restrict__ col;
  const int* __restrict__ row;
  const unsigned char* __restrict__ mask;
  const int* __restrict__ row_start;
  const int* __restrict__ row_end;
  int n;
  int rows;
};

struct Config {
  int blocks_per_row;
  int l_max;
  int max_corners;
  int col_diff;
  float jump;
  float ratio;
  float threshold;
};

// the key of a score: unsigned order is the plain argmax's order
__device__ __forceinline__ unsigned key_of(float v) {
  if (isnan(v)) return kNanKey;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);  // -0 as +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float score_of(unsigned key) {
  if (key == kNanKey) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// a lane's window: packed points g-6..g+6 of its clamped index g
struct Points {
  float d[kSpan];
  int c[kSpan];
  bool m[kSpan];
};

// (sum of the 10 packed neighbours - 10 d)^2 in the plain version's order,
// over the depths where masked in
__device__ __forceinline__ float roughness(const Points& w) {
  float md[kSpan];
#pragma unroll
  for (int k = 0; k < kSpan; ++k) md[k] = w.m[k] ? w.d[k] : 0.f;
  float acc = __fmul_rn(-10.f, md[kHalo]);
#pragma unroll
  for (int k = 1; k <= 5; ++k) {
    acc = __fadd_rn(acc, md[kHalo - k]);
    acc = __fadd_rn(acc, md[kHalo + k]);
  }
  return __fmul_rn(acc, acc);
}

// an occlusion seed at window point j: masked in, the next column near, and
// a depth step above `jump` toward the next point (`ahead`: d[j] - d[j+1],
// which marks j-5..j) or from it (d[j+1] - d[j], which marks j+1..j+6)
__device__ __forceinline__ bool occlusion_seed(const Points& w, int j, bool ahead,
                                               const Config& cfg) {
  if (!w.m[j] || abs(w.c[j + 1] - w.c[j]) >= cfg.col_diff) return false;
  const float step = ahead ? __fsub_rn(w.d[j], w.d[j + 1]) : __fsub_rn(w.d[j + 1], w.d[j]);
  return step > cfg.jump;
}

// mark_valid at the window's centre (masked in, its row guard checked by
// the caller): no parallel beam and no occlusion mark
__device__ __forceinline__ bool unmarked(const Points& w, const Config& cfg) {
  const float d = w.d[kHalo];
  const float lim = __fmul_rn(cfg.ratio, d);
  if (fabsf(__fsub_rn(w.d[kHalo - 1], d)) > lim && fabsf(__fsub_rn(w.d[kHalo + 1], d)) > lim) {
    return false;  // a parallel beam
  }
  bool kill = false;
#pragma unroll
  for (int k = 0; k <= 5; ++k) kill |= occlusion_seed(w, kHalo + k, true, cfg);
#pragma unroll
  for (int k = 1; k <= 6; ++k) kill |= occlusion_seed(w, kHalo - k, false, cfg);
  return !kill;
}

// the score key of a lane whose window is `w`: its roughness where pickable
// (the block's own row r, whose bounds it holds, saves the bounds' reads)
__device__ __forceinline__ unsigned lane_key(const Scan& s, const Points& w, int gs, int rg,
                                             int r, int start, int end, const Config& cfg) {
  if (!w.m[kHalo] || rg < 0 || rg >= s.rows) return key_of(-1.f);
  const int lo = rg == r ? start : s.row_start[rg];
  const int hi = rg == r ? end : s.row_end[rg];
  if (gs < lo + 5 || gs >= hi - 6) return key_of(-1.f);
  return unmarked(w, cfg) ? key_of(roughness(w)) : key_of(-1.f);
}

// K > 0: warp 0 keeps K keys a lane in registers; K = 0: in shared memory
template <int K>
__global__ void __launch_bounds__(K > 0 ? 32 * K : 512)
loam_corners_kernel(Scan s, unsigned char* __restrict__ out, Config cfg) {
  extern __shared__ unsigned smem[];
  unsigned* s_key = smem;                                           // [l_max]
  float* s_d = reinterpret_cast<float*>(s_key + cfg.l_max);         // [l_max + 12]
  int* s_c = reinterpret_cast<int*>(s_d + cfg.l_max + 2 * kHalo);   // [l_max + 12]
  unsigned char* s_m = reinterpret_cast<unsigned char*>(s_c + cfg.l_max + 2 * kHalo);

  const int tid = threadIdx.x;
  const int r = blockIdx.x / cfg.blocks_per_row;
  const int i = blockIdx.x % cfg.blocks_per_row;
  const int start = s.row_start[r];
  const int end = s.row_end[r];
  const int span = end - start - 11;
  // floor division, as the plain version's (span may be negative)
  const int len6 = span >= 0 ? span / cfg.blocks_per_row
                             : -((-span + cfg.blocks_per_row - 1) / cfg.blocks_per_row);
  const int b_start = start + 5 + i * len6;
  // the lanes in block: offset < len6 and packed index < n
  const int lanes_in = max(0, min(min(len6, cfg.l_max), s.n - b_start));

  // 1. the window, and this thread's first lane's row id beside it
  const int first_row = tid < lanes_in ? s.row[b_start + tid] : -1;
  if (lanes_in > 0) {
    const int base = b_start - kHalo;
    for (int w = tid; w < lanes_in + 2 * kHalo; w += blockDim.x) {
      int j = base + w;
      if (static_cast<unsigned>(j) >= static_cast<unsigned>(s.n)) j = wrap(j, s.n);
      s_d[w] = s.depth[j];
      s_c[w] = s.col[j];
      s_m[w] = s.mask[j];
    }
  }
  __syncthreads();

  // 2. every lane's score key
  for (int p = tid; p < cfg.l_max; p += blockDim.x) {
    unsigned key = key_of(-1.f);
    if (p < lanes_in) {
      const int g = b_start + p;
      Points w;
#pragma unroll
      for (int k = 0; k < kSpan; ++k) {
        w.d[k] = s_d[p + k];
        w.c[k] = s_c[p + k];
        w.m[k] = s_m[p + k] != 0;
      }
      key = lane_key(s, w, g, p == tid ? first_row : s.row[g], r, start, end, cfg);
    }
    s_key[p] = key;
  }
  __syncthreads();
  if (tid >= 32) return;

  // 3. the picks, warp 0
  const int lane = tid;
  const unsigned minus1 = key_of(-1.f);
  if constexpr (K > 0) {
    unsigned key[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = 32 * k + lane;
      key[k] = p < cfg.l_max ? s_key[p] : 0u;  // 0: below every score, never picked
    }
    unsigned picked = 0;  // bit k: offset 32 k + lane picked
    for (int c = 0; c < cfg.max_corners; ++c) {
      unsigned best = 0, at = kNone;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (key[k] > best) {  // strict: the lane's first maximum
          best = key[k];
          at = 32 * k + lane;
        }
      }
      const unsigned top = __reduce_max_sync(kFull, best);
      const unsigned p = __reduce_min_sync(kFull, best == top ? at : kNone);
      if (!(score_of(top) > cfg.threshold)) break;  // every later pick repeats this one
      if ((p & 31u) == static_cast<unsigned>(lane)) picked |= 1u << (p >> 5);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = 32 * k + lane;
        if (q < cfg.l_max && static_cast<unsigned>(q - static_cast<int>(p) + 5) <= 10u) {
          key[k] = minus1;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (picked >> k & 1u) {
        const int p = 32 * k + lane;
        const int g = min(max(b_start + p, 0), s.n - 1);
        const bool m = p < lanes_in ? s_m[p + kHalo] != 0 : s.mask[g] != 0;
        if (m) out[g] = 1;
      }
    }
  } else {
    for (int c = 0; c < cfg.max_corners; ++c) {
      unsigned best = 0, at = kNone;
      for (int p = lane; p < cfg.l_max; p += 32) {
        const unsigned k = s_key[p];
        if (k > best) {
          best = k;
          at = p;
        }
      }
      const unsigned top = __reduce_max_sync(kFull, best);
      const unsigned p = __reduce_min_sync(kFull, best == top ? at : kNone);
      if (!(score_of(top) > cfg.threshold)) break;
      if (lane == 0) {
        const int g = min(max(b_start + static_cast<int>(p), 0), s.n - 1);
        const bool m = static_cast<int>(p) < lanes_in ? s_m[p + kHalo] != 0 : s.mask[g] != 0;
        if (m) out[g] = 1;
      }
      __syncwarp();
      if (lane <= 10) {
        const int q = static_cast<int>(p) - 5 + lane;
        if (q >= 0 && q < cfg.l_max) s_key[q] = minus1;
      }
      __syncwarp();
    }
  }
}

template <int K>
cudaError_t launch(const Scan& s, unsigned char* out, const Config& cfg, size_t smem,
                   cudaStream_t stream) {
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        loam_corners_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = min(32 * ((cfg.l_max + 31) / 32), K > 0 ? 32 * K : 512);
  loam_corners_kernel<K><<<s.rows * cfg.blocks_per_row, threads, smem, stream>>>(s, out, cfg);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Writes the corner mask into
// `out` [n] (bool as 0/1 bytes), which the caller has zeroed; launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take (a block's window and keys, 13 B a
// lane and 108 B beside, must fit in one block's shared memory).
extern "C" int loam_corners_launch(const float* depth, const int* col, const int* row,
                                   const unsigned char* mask, const int* row_start,
                                   const int* row_end, unsigned char* out, int n, int rows,
                                   int blocks_per_row, int l_max, int max_corners,
                                   int col_diff, float jump, float parallel_ratio,
                                   float corner_threshold, void* stream) {
  if (rows < 1 || blocks_per_row < 1 || l_max < 1 || max_corners < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const size_t window = static_cast<size_t>(l_max) + 2 * kHalo;
  const size_t smem = static_cast<size_t>(l_max) * 4 + window * (4 + 4 + 1);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const Scan s{depth, col, row, mask, row_start, row_end, n, rows};
  const Config cfg{blocks_per_row, l_max, max_corners, col_diff,
                   jump, parallel_ratio, corner_threshold};
  const auto st = static_cast<cudaStream_t>(stream);
#ifdef FLS_CORNER_KEYS_IN_SMEM
  return static_cast<int>(launch<0>(s, out, cfg, smem, st));
#else
  cudaError_t err;
  if (l_max <= 32 * 8) {
    err = launch<8>(s, out, cfg, smem, st);
  } else if (l_max <= 32 * 16) {
    err = launch<16>(s, out, cfg, smem, st);
  } else {
    err = launch<0>(s, out, cfg, smem, st);
  }
  return static_cast<int>(err);
#endif
}
