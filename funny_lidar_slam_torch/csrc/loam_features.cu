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
// few hundred operations a point. What holds it is latency: a block's
// picks are a chain of up to max_corners dependent argmaxes.
//
// Design: one warp (one thread block of 32 threads) an angular block, B =
// rows x blocks_per_row of them. Block b of row r spans len6 = floor((end
// - start - 11) / blocks_per_row) packed points from start + 5 + i len6;
// its lanes are the offsets 0..l_max-1, in block where offset < len6 and
// the packed index is below n. A lane computes, for the offsets it holds
// (p = lane, lane + 32, ...), the score the plain version's argmax reads:
// the roughness where the point is pickable (in block, masked in, inside
// its row's guard, no occlusion or parallel-beam mark), else -1, from
// direct reads of its neighbours modulo n (the plain version's rolls), and
// keeps it in shared memory. Then each pick is one pass over the warp's
// scores and a shuffle argmax (the first maximum: the lowest offset among
// equal scores, a NaN above every number, as torch.argmax); a pick above
// corner_threshold writes True at clamp(start + p, 0, n - 1) where the
// scan's mask holds there, and sets the scores of offsets p-5..p+5 to -1
// (the plain version's suppression of `pickable`). No block barrier a
// pick: the warp's own __syncwarp. A pick at or below the threshold ends
// the block, as every later pick of the plain loop repeats it. Blocks
// write True only, into a mask the caller zeroed, so no write of one block
// can undo another's.
//
// Arithmetic as the plain version's, each float operation rounded once
// (__fadd_rn / __fmul_rn / __fsub_rn, so nvcc contracts nothing into an
// FMA): roughness acc = -10 d, then acc = (acc + d[i-k]) + d[i+k] for k =
// 1..5, then acc * acc, over d = depth where masked in, else 0; the marks
// compare float32 differences with the float32 thresholds.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

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

__device__ __forceinline__ float masked_depth(const Scan& s, int j) {
  return s.mask[j] ? s.depth[j] : 0.f;
}

// (sum of the 10 packed neighbours - 10 d)^2 in the plain version's order
__device__ float roughness(const Scan& s, int g) {
  float acc = __fmul_rn(-10.f, masked_depth(s, g));
  for (int k = 1; k <= 5; ++k) {
    acc = __fadd_rn(acc, masked_depth(s, wrap(g - k, s.n)));
    acc = __fadd_rn(acc, masked_depth(s, wrap(g + k, s.n)));
  }
  return __fmul_rn(acc, acc);
}

// an occlusion seed at j: masked in, the next column near, and a depth step
// above `jump` toward the next point (`ahead`: d[j] - d[j+1], which marks
// j-5..j) or from it (d[j+1] - d[j], which marks j+1..j+6)
__device__ bool occlusion_seed(const Scan& s, int j, bool ahead, int col_diff, float jump) {
  if (!s.mask[j]) return false;
  const int j1 = wrap(j + 1, s.n);
  if (abs(s.col[j1] - s.col[j]) >= col_diff) return false;
  const float step = ahead ? __fsub_rn(s.depth[j], s.depth[j1])
                           : __fsub_rn(s.depth[j1], s.depth[j]);
  return step > jump;
}

// mark_valid and the row guard of packed point g
__device__ bool pickable(const Scan& s, int g, int col_diff, float jump, float ratio) {
  if (!s.mask[g]) return false;
  const int r = s.row[g];
  if (r < 0 || r >= s.rows) return false;
  if (g < s.row_start[r] + 5 || g >= s.row_end[r] - 6) return false;
  const float d = s.depth[g];
  const float lim = __fmul_rn(ratio, d);
  if (fabsf(__fsub_rn(s.depth[wrap(g - 1, s.n)], d)) > lim &&
      fabsf(__fsub_rn(s.depth[wrap(g + 1, s.n)], d)) > lim) {
    return false;  // a parallel beam
  }
  for (int k = 0; k <= 5; ++k) {
    if (occlusion_seed(s, wrap(g + k, s.n), true, col_diff, jump)) return false;
  }
  for (int k = 1; k <= 6; ++k) {
    if (occlusion_seed(s, wrap(g - k, s.n), false, col_diff, jump)) return false;
  }
  return true;
}

// whether (a, pa) comes before (b, pb) in argmax order: NaN first, then the
// larger score, then the lower offset
__device__ __forceinline__ bool before(float a, int pa, float b, int pb) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || pa < pb);
  return a > b || (a == b && pa < pb);
}

__global__ void loam_corners_kernel(Scan s, unsigned char* __restrict__ out,
                                    int blocks_per_row, int l_max, int max_corners,
                                    int col_diff, float jump, float ratio, float threshold) {
  extern __shared__ float score[];  // [l_max]: the block's scores
  const int lane = threadIdx.x;
  const int r = blockIdx.x / blocks_per_row;
  const int i = blockIdx.x % blocks_per_row;
  const int start = s.row_start[r];
  const int span = s.row_end[r] - start - 11;
  // floor division, as the plain version's (span may be negative)
  const int len6 = span >= 0 ? span / blocks_per_row
                             : -((-span + blocks_per_row - 1) / blocks_per_row);
  const int b_start = start + 5 + i * len6;

  for (int p = lane; p < l_max; p += 32) {
    const int g = b_start + p;
    const int gs = min(max(g, 0), s.n - 1);  // the plain version's clamped index
    float v = -1.f;
    if (p < len6 && g < s.n && pickable(s, gs, col_diff, jump, ratio)) v = roughness(s, gs);
    score[p] = v;
  }
  __syncwarp();

  for (int c = 0; c < max_corners; ++c) {
    float best = -INFINITY;
    int at = INT_MAX;
    for (int p = lane; p < l_max; p += 32) {
      const float v = score[p];
      if (before(v, p, best, at)) {
        best = v;
        at = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int op = __shfl_xor_sync(0xffffffffu, at, off);
      if (before(ov, op, best, at)) {
        best = ov;
        at = op;
      }
    }
    if (!(best > threshold)) break;  // every later pick repeats this one
    if (lane == 0) {
      const int g = min(max(b_start + at, 0), s.n - 1);
      if (s.mask[g]) out[g] = 1;
    }
    __syncwarp();
    if (lane <= 10) {
      const int q = at - 5 + lane;
      if (q >= 0 && q < l_max) score[q] = -1.f;
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Writes the corner mask into
// `out` [n] (bool as 0/1 bytes), which the caller has zeroed; launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take (a block's l_max scores must fit in
// one block's shared memory).
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
  const size_t smem = static_cast<size_t>(l_max) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        loam_corners_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Scan s{depth, col, row, mask, row_start, row_end, n, rows};
  loam_corners_kernel<<<rows * blocks_per_row, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      s, out, blocks_per_row, l_max, max_corners, col_diff, jump, parallel_ratio,
      corner_threshold);
  return static_cast<int>(cudaGetLastError());
}
