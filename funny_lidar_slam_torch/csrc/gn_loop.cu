// The Gauss-Newton loops over cached candidates, one thread block cluster a
// call:
//
//   icp_gn_kernel    the body of the JAX `lax.while_loop` of
//                    funny_lidar_slam_tpu/registration/gn.py:232 (body
//                    :156-212) with hg_fn = point_to_point_hg_cand
//                    (funny_lidar_slam_tpu/registration/residuals.py:226)
//                    and the ICP update. Plain version
//                    ops/gn_loop.py::icp_gn_rounds_plain.
//   loam_gn_kernel   the same body with the LOAM update over
//                    point_to_plane_hg_cand rows (residuals.py:237-251) of
//                    one set (<false>: PointToPlaneMatcher, plain version
//                    plane_gn_rounds_plain), or point_to_line_hg_cand rows
//                    (:253-270) of a corner set plus plane rows of a planar
//                    set, summed, the planar count as num_valid (<true>:
//                    LoamFullMatcher, matchers.py:628-637; plain version
//                    loam_gn_rounds_plain).
//   ndt_gn_kernel    the same body with ndt_corr + ndt_hg_corr
//                    (residuals.py:519-560) and the NDT update, the
//                    stencil lookup in the NDT map's hash table inside
//                    every iteration, a row's 7 probe windows loaded
//                    together and its pairs folded through J's structure
//                    (NdtMatcher and the loop closure's NDT stages; plain
//                    version ndt_gn_rounds_plain).
//   plane_map_gn_kernel  the same body with point_to_plane_hg
//                    (residuals.py:366-420: a fresh 5-NN gather over the
//                    hashed block map, the plane fit and its gates) and the
//                    LOAM update: the block map's cover lookup and the 5
//                    nearest in the nearby26 stencil inside every iteration
//                    (the loop closure's point-to-plane refine,
//                    funny_lidar_slam_tpu/backend/loop_closure.py:159-169;
//                    plain version plane_map_gn_rounds_plain).
//
// Each runs from a carry held on the device until the loop ends or the
// next iteration would need a fresh gather. NDT and the refine regather
// every iteration (corr_every 1, no trust-region skip), and their kernels
// make each gather themselves, so one of their calls runs to the end.
//
// A call is handed the candidate set(s) gathered at the carry's pose. Each
// iteration: test the loop bound (gathers < max_iters, it < max_total, not
// done; else status S_DONE) and the trust region (moved = |dt| + theta r >
// skip_dist, theta = |R Rg^T - I|_F / sqrt 2); if the iteration refreshes
// ((want & moved) | it == 0) and the call's gather is spent, status
// S_NEED_GATHER. Otherwise linearize every row at the current pose and sum
// the normal equations, solve6_damped (scale = max(trace H / 6, 1),
// Cholesky of H + 1e-6 scale I in f32, NaN where it fails), update the
// pose, and update the carry as the JAX body does. The host reads the
// status word once a call.
//
// The rows. ICP: the nearest valid candidate among the row's M (a strict <
// over the lanes in order: argmin's first minimum), gated at d2 <=
// max_corr_dist_sq, J = [I | -R hat(s)], r = R s + t - q. LOAM: the 5
// nearest valid candidates, ascending (ties to the lower lane, as
// lax.top_k), all within max_search_dist_sq; then
//   plane (fit_plane_5nn, :336-358): A^T A + 1e-9 I inverted by the
//     adjugate (lin3.inv3) in f32, x = (A^T A)^-1 A^T (-1), each
//     |a_k.x + 1| / |x| <= plane_thresh, n = x / |x|, d = (p - a_0).n, the
//     near reject |s| < 81 d^2; r = |d|, J = [Rs x v | v], v = sign(d) n;
//   line (point_to_line_corr, :438-471): the centroid c and covariance / 5
//     of the 5, its eigenvalues in closed form (lin3.sym3_eigvalsh: arccos
//     and cos), the gate lambda_max > ratio lambda_mid, the direction n by
//     exactly 12 shifted power iterations from (1, 1, 1)/sqrt 3 (lin3.
//     sym3_principal_eigvec, no early exit: the same unconverged vector
//     where the start is nearly orthogonal to it); u = (p - c) x n / |.|,
//     r = |(p - c) x n| > 1e-9, J = [Rs x v | v], v = n x u.
// The fits' small sums (A^T A, A^T 1, (A^T A)^-1 A^T 1, the residuals, |x|,
// d, the centroid and the covariance) are taken in float64 from the exact
// float32 products and rounded once to float32, as residuals.py's
// `_einsum_small` / `_sum_small` / `_dot` take them on the card: far from
// the origin A^T A's determinant cancels and the plane gates follow the
// last bits, which cuBLAS's summation order would otherwise decide. The
// rest of both fits (the adjugate, the eigenvalues, the power steps) stays
// float32, each product and sum rounded in the plain version's order (no
// fused multiply-add where PyTorch runs separate elementwise ops).
// NDT (ndt_corr, residuals.py:386-398; the map's lookup, maps/ndt_map.py):
// p = R s + t, its voxel floor(p inv) (the caller's float32 inv); for each
// of the 7 stencil voxels (NDT_STENCIL, in its order) the slot hash and the
// fingerprint (ops/voxel.py spatial_hash, maps/voxel_hash.py fingerprint,
// uint32 arithmetic), the first of num_probes slots from the hash whose
// fingerprint matches, read from the map's probe-window rows fpwin[hash]
// as the plain version's `_probe` reads them; the pair is valid where that
// slot is estimated, the row is unmasked and res = e^T lam e <=
// outlier_thresh and finite (e = p - mean, lam = info). Valid pairs add
// J^T lam J, J^T lam^T e (residuals._reduce_vec3's g), 1 and res, J = [a |
// I], a = -R hat(s). p and res are taken in float64 from the exact
// float32 products in a fixed order and rounded once, as residuals.py's
// `_transform_fixed` / `_mahalanobis64` take them on the card: a point one
// ulp across a voxel face changes its stencil, and res decides the gate.
//
// Bound: an iteration reads, for each set, px, py, pz [N, M] f32, valid
// [N, M] u8 and src [N, 3] f32: N M 13 + N 12 bytes, 3.6 MB at N = 16,384,
// M = 16, or 1.1 us at 3.35 TB/s; the operations (~9 a lane, ~80 an ICP
// row, a few hundred a plane or line row) are a fraction of that at 67
// TFLOP/s f32. Counting each input once, as a call's least time, the bound
// is one such read (the sets fit in the 50 MB L2), whatever the call's
// iterations. Both kernels sit far above it: a row is a long dependent
// chain (thirteen loads, the five-slot insertion, a plane or line fit with
// correctly rounded divisions), so an iteration's time is the rows a
// thread walks times that chain's latency, and one thread solves the 6x6
// system between barriers. Both keep the loop on the device (no launch and
// no host read an iteration), which is what the step lacked.
//
// Design: every kernel is one loop skeleton (`cluster_loop`) over its own
// rows. Every iteration's rows are spread over the R blocks of 256
// threads of one thread block cluster (R = 16, or 8 where no 16-block
// cluster fits; `cluster_blocks`), so each thread walks ~4 rows an
// iteration at N = 16,384. Each thread keeps its partial sums in registers
// (icp: g_t[3], g_r[3], H_tr[9], the 6 unique entries of H_rr, the count,
// sum |r|, H_tt being count I; loam: the 21 unique entries of H, g[6], the
// planar count, sum |r|; 256 threads, so that a LOAM row's sixteen lanes,
// its five neighbours, its fit and the 29 partial sums fit the 255
// registers a thread may hold). Where M = 16 and the planes are 16-byte
// aligned (<16>, every gather of the port) a row's lanes come as thirteen
// 16-byte loads issued together, so a thread waits on memory once a row,
// not once a lane (<0> takes any M). The rows are dealt to the ranks in
// tiles of 256 rows, tile k to rank k mod R, a row of a tile to each
// thread; LoamFull's two sets are one range of rows (the corner rows
// first). The split depends only on the total rows and R (so no corner
// rows gives the plane kernel's sums bit for bit); the line rows, about
// three times a plane row's chain, fall on R ranks at once, not on the
// first one or two; and a warp keeps neighbouring rows, neighbours in the
// gathers' voxel order and alike in their gates, so its threads diverge
// less than over rows dealt one by one to the ranks (`rank_rows`). Below
// 256 rows every row falls on rank 0's first tile.
//
// The partials are reduced in a fixed order, with no atomics, so two runs
// agree bit for bit: warp shuffles, then the warps' rows of shared memory
// in warp order into the block's own shared memory, double-buffered by
// the iteration's parity; one cluster barrier; then every rank reads all R
// ranks' partials through distributed shared memory, sums them in rank
// order and runs the iteration's end (the solve, the update, the flags:
// `end_iteration`) and the next one's begin (the bound, the trust region,
// the gather test: `begin_iteration`) on one thread itself. Every rank so
// holds the same carry bit for bit and decides the loop alike (no second
// barrier, no broadcast; a rank that skipped the cluster barrier would
// hang the card); the parity buffer lets a rank start the next iteration's
// rows while another still reads this one's partials (a rank writes a
// buffer again two iterations on, after a barrier that every reader of its
// last contents has passed). A last cluster barrier keeps every block's
// shared memory alive until the others have read it; rank 0 writes the
// carry back.
//
// The sums are float64, the kernels' one departure from the reference's
// float32: these normal equations have a condition near 1e3 (the rotation
// block ~ N |s|^2 against the translation block's N), and at convergence g
// is a sum of terms that cancel, so float32 sums in any order move the pose
// by up to ~1e-4 m (two float32 implementations part by that much on the
// card). Float64 sums fix g, and so the pose GN settles at, to ~1e-6 m of a
// float64 run; each row's terms, the distances, the fits and the Cholesky
// stay f32.
//
// The NDT kernel's bound: an iteration reads the mask [N] and src [N, 3] f32
// of the unmasked rows, and for each row's 7 voxels up to num_probes 8-byte
// fingerprints, a mean (12 B), an info (36 B) and the estimated flag; the
// map (131,072 slots at the bench's size, ~7.5 MB, 16 MB more for fpwin)
// stays in L2 across iterations. Counted by J's structure, a valid pair
// needs ~52 operations and a row with one or more ~190 (chip_smoke.py
// `ndt_cost`). Neither bounds the kernel, whose rows run on
// the 16 SMs of one cluster: a row's lookup is up to 7 x num_probes
// fingerprint compares, and a probe chain that loads the next fingerprint
// only after the last compare failed (the reference's loop read
// literally) waits on L2 up to 7 x (8 + 1) times a row, since most of a
// surface voxel's face neighbours are not in the map and walk every probe.
//
// NDT design: one thread a row, the rows dealt as the other kernels'
// (`rank_rows`), and a row waits on memory twice. It computes its 7
// voxels' hashes and fingerprints first, then loads the first 8 probes of
// its windows, 4 16-byte loads of an fpwin row each (128-byte aligned, so
// no wrap and 2 sectors a window), four windows at a time
// (kLookupGroup), before their first compare; the first match of each
// window is its slot (no stop at an empty slot: the reference takes the
// first match over all num_probes, whatever lies before it). Only where
// num_probes > 8 do the windows without a match in their first 8 probes
// load probes 9-16, a third wait. Then the found slots' means, infos and
// flags load together, four voxels at a time (kGaussGroup), and the next
// row's mask and source were loaded with this row's. A group's pairs run
// the same instructions whether valid or not (selects), so their chains
// interleave. From a call's third iteration a row whose voxel is the one
// it kept takes its 7 slots from the call's slot cache (written in the
// second iteration, so a one-iteration call pays nothing for it) and
// waits only on the Gaussians: the map is frozen within a call, so the
// kept slots are the lookup's.
// Why one thread a row: a cluster block is 256 threads, one block an SM,
// so loads in flight come from a thread's independent loads; a row's 7
// voxels over 8 lanes would give a warp 4 rows in flight instead of 32
// and walk each lane group through 8 times the rows in turn. The stage
// clocks put the rows first either way (thread 0's rows 61-72 % of an
// iteration after the redesign, ~88 % before); what holds them is how
// many scattered loads and instructions 16 SMs of 8 warps get through,
// not a chain of waits: in trial builds, issuing 2, 3 or all 7 windows at
// a time, prefetching the kept slots a row ahead, or the pair sums and
// the fold in float32 left the time where it was, and the Gaussians as
// 16-byte loads made it slower, while taking loads and instructions out
// of a row (the kept slots, branch-free pairs) took time off. The groups
// of four keep the kernel within 255 registers without a spill (the
// ptxas report, chip_smoke.py phase 22).
// A row's valid pairs are summed first (lsum = sum lam, esum = sum lam^T e,
// in float64 from the exact float32 products, in stencil order), and J's
// structure applied once a row (`ndt_fold_row`): H_rr = a^T lsum a, H_rt =
// a^T lsum, H_tt = lsum, -g = [a^T esum; esum], about 160 float64
// operations a row and ~30 a pair beside e^T lam e, instead of ~265 a
// pair for the dense J^T lam J. The order is fixed and there are no atomics, so a second
// launch gives the same bits; the sums differ from a pair-by-pair float32
// fold in the last bits only.
//
// The refine (plane_map_gn_kernel; block_map.py's cover lookup, select.py's
// stencil, residuals.py's plane rows): a row's p = R s + t is taken as the
// NDT rows take it (affine_row, residuals._transform_fixed on the card) and
// its voxel floor(p inv), so both sides put a point one ulp from a voxel
// face on the same side and gather the same stencil. The 8 cover blocks
// ((v - 1) >> 1) + {0, 1}^3 are hashed and probed as NDT's voxels
// (probe_windows, 8 probes of 4 windows loaded together); a missed block
// is the _MISS row, every lane +inf, and is skipped. The 5 nearest come
// from the 27 stencil voxels of the cover's 64 in the cover row's lane
// order (block, local voxel, bucket slot), each voxel's S slots as float4
// loads of the x, y and z planes, d2 as fused_select's dist2, insert5's
// strict < keeping ties on the lower lane (the plain version's exact top-k
// on the CPU and lax.top_k; fused_select's kernel orders lanes by d2 (1 +
// 2e-7 j), so on the card the plain route through it may take another
// fifth where two d2 lie within 1e-4 relative; chip_smoke.py phase 25 holds
// the kernel to a plain select in its own order, `exact_select`). The block
// loop stays rolled: unrolled, the 8 blocks' lane loops spilled (254
// registers; rolled 232 and a 64-byte stack frame for the slots, ptxas on
// sm_90a). Then loam_rows' plane row at p with its
// once-rounded small sums, and the rows' float64 sums, loam_system, solve6
// and end_iteration<U_LOAM> as for the other kernels.
// Its bound: an iteration reads the mask [N] and src [N, 3] of the
// unmasked rows, 8 probe windows a row and the stencil's 27 x S lanes of
// x, y, z of each found block (3 x 27 x 8 x 4 = 2.6 kB a row at S = 8, up
// to ~40 MB an iteration, mostly from L2 since the rows of one voxel read
// the same cover); a lane costs ~10 operations (d2, the compare) and a row
// with five points ~250 (chip_smoke.py `refine_cost`). One thread a row
// walks its 216 lanes in a chain of dependent compares, so the rows are
// the iteration's time, as in NDT; a first design, one cluster of 16 SMs.
//
// Carry (int32 words, float fields as their bits; ops/gn_loop.py CARRY):
//   t_mat[16] t_gather[16] last_rot last_pos total_res (f32) | it gathers
//   since_gather force_gather done converged num_valid status (int32)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "so3.cuh"
#include "stage_clock.cuh"

namespace cg = cooperative_groups;

namespace {

enum {
  C_T_MAT = 0, C_T_GATHER = 16, C_LAST_ROT = 32, C_LAST_POS = 33, C_TOTAL_RES = 34,
  C_IT = 35, C_GATHERS = 36, C_SINCE_GATHER = 37, C_FORCE_GATHER = 38, C_DONE = 39,
  C_CONVERGED = 40, C_NUM_VALID = 41, C_STATUS = 42, C_SIZE = 43
};
enum { S_NEED_GATHER = 1, S_DONE = 2 };
// the update conventions: ICP dx = [t, r], P += dt, R := R Exp(dr); LOAM
// dx = [r, t], R := Exp(dr) R, P += dt; NDT dx = [r, t], R := R Exp(dr),
// P += dt
enum { U_ICP = 0, U_LOAM = 1, U_NDT = 2 };
// the wrappers whose cluster gn_cluster_blocks reports: icp_gn_launch,
// plane_gn_launch, loam_gn_launch, ndt_gn_launch, plane_map_gn_launch
enum { G_ICP = 0, G_PLANE = 1, G_LOAM = 2, G_NDT = 3, G_PLANE_MAP = 4 };
// the ICP per-thread sums: -g's two halves before the sign, H's t-r block,
// the upper triangle of its r-r block, the valid rows and sum |r|
enum { A_GT = 0, A_GR = 3, A_HTR = 6, A_HRR = 15, A_COUNT = 21, A_RES = 22, A_SIZE = 23 };
// the LOAM per-thread sums: the upper triangle of H = sum J J^T (row by
// row), sum J r (-g), the planar rows and sum |r|; NDT's the same layout:
// H = sum J^T lam J, sum J^T lam e (-g), the valid pairs and sum e^T lam e
enum { L_H = 0, L_G = 21, L_COUNT = 27, L_RES = 28, L_SIZE = 29 };
// the stage clocks of either kernel in a profiling build (stage_clock.cuh):
// rank 0's SM cycles, summed over the call's iterations, written as floats
// after the carry (a buffer of C_SIZE + kStageClocks words): the start to
// the first go; thread 0's rows; its block's sum (to its slowest warp); the
// wait at the cluster barrier (the slowest rank); the distributed shared
// memory sum; thread 0's end and next begin of an iteration; the last
// barrier
enum {
  K_SETUP = 0, K_ROWS = 1, K_BLOCK = 2, K_CLUSTER = 3, K_DSMEM = 4, K_SERIAL = 5, K_EXIT = 6
};

constexpr int kThreads = 256;  // a block of the cluster, and a tile of rows
constexpr int kWarps = kThreads / 32;
constexpr int kClusterBlocks[2] = {16, 8};  // tried in order, once a device
constexpr float kDamping = 1e-6f;  // lin3.solve6_damped

// the loop's own settings (GNConfig)
struct Loop {
  int max_iters, max_total, corr_every, min_valid, use_stall;
  float rot_eps, pos_eps, stall_eps, skip_dist;
};

struct IcpParams {
  int m;
  Loop loop;
  float max_d2;
};

// one candidate set: px, py, pz, valid [n, m], src [n, 3]
struct Set {
  const float* px;
  const float* py;
  const float* pz;
  const unsigned char* valid;
  const float* src;
  int n;
};

struct LoamParams {
  int m;
  Loop loop;
  float max_d2, plane_thresh, line_ratio;
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

// the rows' 16 lanes of px, py, pz and valid at `base` as thirteen 16-byte
// loads, all issued before any is used
__device__ inline void load16(const float* __restrict__ px, const float* __restrict__ py,
                              const float* __restrict__ pz,
                              const unsigned char* __restrict__ valid, size_t base, float4* x,
                              float4* y, float4* z, unsigned* words) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = __ldg(reinterpret_cast<const float4*>(px + base) + k);
    y[k] = __ldg(reinterpret_cast<const float4*>(py + base) + k);
    z[k] = __ldg(reinterpret_cast<const float4*>(pz + base) + k);
  }
  const uint4 vb = __ldg(reinterpret_cast<const uint4*>(valid + base));
  words[0] = vb.x;
  words[1] = vb.y;
  words[2] = vb.z;
  words[3] = vb.w;
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

// a fixed-order block sum of every thread's acc[kSums] into sums[kSums]:
// warp shuffles, then the warps' rows of `part` in warp order. sums[k] is
// written by thread k: the caller's next barrier publishes it
template <int kSums, int kNumWarps>
__device__ __forceinline__ void block_sum(const double* acc, double (*part)[kSums], double* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    double v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    double v = 0.0;
    for (int w = 0; w < kNumWarps; ++w) v += part[w][tid];
    sums[tid] = v;
  }
}

// the ICP rows' sums at pose (rot, t) into acc[A_SIZE]: the rows first,
// first + stride, ... below end of the set cs
template <int kM>
__device__ __forceinline__ void icp_rows(const Set& cs, const IcpParams& p, const float* rot,
                                         const float* t, int first, int end, int stride,
                                         double* acc) {
#pragma unroll
  for (int k = 0; k < A_SIZE; ++k) acc[k] = 0.0;
  for (int r = first; r < end; r += stride) {
    const float s0 = __ldg(cs.src + 3 * r), s1 = __ldg(cs.src + 3 * r + 1),
                s2 = __ldg(cs.src + 3 * r + 2);
    float q[3], cand[3], best;
#pragma unroll
    for (int i = 0; i < 3; ++i)  // s R^T + t: a multiply-add chain over k, then + t
      q[i] = __fadd_rn(fmaf(rot[3 * i + 2], s2, fmaf(rot[3 * i + 1], s1, __fmul_rn(rot[3 * i], s0))),
                       t[i]);
    nearest<kM>(cs.px, cs.py, cs.pz, cs.valid, static_cast<size_t>(r) * p.m, p.m, q, &best, cand);
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
}

// the ICP normal equations from the cluster's sums: H (count I in its t-t
// block), g, the valid rows and the residual sum
__device__ __forceinline__ void icp_system(const double* sums, float* h, float* g, int* nv,
                                           float* res) {
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
  *nv = static_cast<int>(cnt);
  *res = static_cast<float>(sums[A_RES]);
}

// ------------------------------------------------------------ LOAM rows

// slot j of the five nearest: insert (cd, cx, cy, cz) before the first
// entry it is strictly below and shift the rest down (ties stay in lane
// order, as lax.top_k keeps them); every index static, so d and c stay in
// registers
__device__ __forceinline__ void insert5(float cd, float cx, float cy, float cz, float* d, float (*c)[3]) {
  bool shift = false;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    shift = shift || cd < d[k];
    if (shift) {
      const float td = d[k], tx = c[k][0], ty = c[k][1], tz = c[k][2];
      d[k] = cd;
      c[k][0] = cx;
      c[k][1] = cy;
      c[k][2] = cz;
      cd = td;
      cx = tx;
      cy = ty;
      cz = tz;
    }
  }
}

// the 5 nearest valid candidates of the row at `base` to q, ascending:
// squared distances d[5] (+inf past the valid lanes, as the plain
// version's topk over +inf lanes) and points c[5][3] (0 there)
template <int kM>
__device__ __forceinline__ void nearest5(const float* __restrict__ px, const float* __restrict__ py,
                                         const float* __restrict__ pz,
                                         const unsigned char* __restrict__ valid, size_t base,
                                         int m, const float* q, float* d, float (*c)[3]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    d[k] = INFINITY;
    c[k][0] = c[k][1] = c[k][2] = 0.f;
  }
  if constexpr (kM == 16) {
    float4 x[4], y[4], z[4];
    unsigned words[4];
    load16(px, py, pz, valid, base, x, y, z, words);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (!((words[j >> 2] >> (8 * (j & 3))) & 0xffu)) continue;
      const float cx = lane4(x[j >> 2], j & 3), cy = lane4(y[j >> 2], j & 3),
                  cz = lane4(z[j >> 2], j & 3);
      insert5(dist2(cx - q[0], cy - q[1], cz - q[2]), cx, cy, cz, d, c);
    }
  } else {
    for (int j = 0; j < m; ++j) {
      if (!__ldg(valid + base + j)) continue;
      const float cx = __ldg(px + base + j), cy = __ldg(py + base + j), cz = __ldg(pz + base + j);
      insert5(dist2(cx - q[0], cy - q[1], cz - q[2]), cx, cy, cz, d, c);
    }
  }
}

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }

// sum over the five neighbours of c[k][i] c[k][j] in float64 (the float32
// products are exact there), rounded once to float32: residuals.py
// `_einsum_small` on the card, whose value no summation order changes
__device__ inline float sum5_prod(const float (*c)[3], int i, int j) {
  double v = 0.0;
#pragma unroll
  for (int k = 0; k < 5; ++k) v = __fma_rn(static_cast<double>(c[k][i]), c[k][j], v);
  return __double2float_rn(v);
}

// sum over the five neighbours of c[k][i], likewise rounded once
__device__ inline float sum5(const float (*c)[3], int i) {
  double v = 0.0;
#pragma unroll
  for (int k = 0; k < 5; ++k) v += c[k][i];
  return __double2float_rn(v);
}

// a.b over three components, likewise rounded once (residuals.py `_dot`)
__device__ inline float dot3(const float* a, const float* b) {
  return __double2float_rn(__fma_rn(static_cast<double>(a[2]), b[2],
                                    __fma_rn(static_cast<double>(a[1]), b[1],
                                             static_cast<double>(a[0]) * b[0])));
}

__device__ inline void cross3(const float* a, const float* b, float* out) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// the point-to-plane row (_plane_gates + point_to_plane_hg_corr) on the
// five nearest c (all within max_d2): true with v (J = [rp x v | v]) and
// the residual r where every gate passes
__device__ __forceinline__ bool plane_row(const float (*c)[3], const float* q, const float* s,
                                 float thresh, float* v, float* r) {
  // A^T A + 1e-9 I (symmetric) and A^T (-1)
  float m[9], atb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) m[3 * i + j] = m[3 * j + i] = sum5_prod(c, i, j);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[4 * i] = add(m[4 * i], 1e-9f);
    atb[i] = -sum5(c, i);
  }
  // lin3.inv3: the adjugate over the determinant, each op rounded in order
  const float c00 = sub(mul(m[4], m[8]), mul(m[5], m[7]));
  const float c01 = sub(mul(m[2], m[7]), mul(m[1], m[8]));
  const float c02 = sub(mul(m[1], m[5]), mul(m[2], m[4]));
  const float c10 = sub(mul(m[5], m[6]), mul(m[3], m[8]));
  const float c11 = sub(mul(m[0], m[8]), mul(m[2], m[6]));
  const float c12 = sub(mul(m[2], m[3]), mul(m[0], m[5]));
  const float c20 = sub(mul(m[3], m[7]), mul(m[4], m[6]));
  const float c21 = sub(mul(m[1], m[6]), mul(m[0], m[7]));
  const float c22 = sub(mul(m[0], m[4]), mul(m[1], m[3]));
  const float det = add(add(mul(m[0], c00), mul(m[1], c01)), mul(m[2], c02));
  const float inv_det = __fdiv_rn(1.f, fabsf(det) < 1e-30f ? 1e-30f : det);
  const float inv[9] = {mul(c00, inv_det), mul(c01, inv_det), mul(c02, inv_det),
                        mul(c10, inv_det), mul(c11, inv_det), mul(c12, inv_det),
                        mul(c20, inv_det), mul(c21, inv_det), mul(c22, inv_det)};
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = dot3(inv + 3 * i, atb);
  const float safe = fmaxf(__fsqrt_rn(dot3(x, x)), 1e-12f);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 5; ++k)
    ok = ok && __fdiv_rn(fabsf(add(dot3(c[k], x), 1.f)), safe) <= thresh;
  if (!ok) return false;
  float n[3], e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    n[i] = __fdiv_rn(x[i], safe);
    e[i] = sub(q[i], c[0][i]);
  }
  const float d = dot3(e, n);
  if (__fsqrt_rn(dot3(s, s)) < mul(mul(81.f, d), d)) return false;  // the near reject
  const float sign = d > 0.f ? 1.f : -1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = mul(n[i], sign);
  *r = fabsf(d);
  return true;
}

// lin3.sym3_eigvalsh's largest two eigenvalues (lam_max, lam_mid) of the
// symmetric a, each op in the plain version's order
__device__ __forceinline__ void eig_top2(const float* a, float* lam_max, float* lam_mid) {
  const float q = __fdiv_rn(add(add(a[0], a[4]), a[8]), 3.f);
  float dm[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) dm[k] = k % 4 == 0 ? sub(a[k], q) : a[k];
  float p2 = mul(dm[0], dm[0]);
#pragma unroll
  for (int k = 1; k < 9; ++k) p2 = add(p2, mul(dm[k], dm[k]));
  if (p2 < 1e-30f) {
    *lam_max = *lam_mid = q;
    return;
  }
  const float p = __fsqrt_rn(fmaxf(__fdiv_rn(p2, 6.f), 0.f));
  const float pc = fmaxf(p, 1e-30f);
  float b[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) b[k] = __fdiv_rn(dm[k], pc);
  const float det = add(sub(mul(b[0], sub(mul(b[4], b[8]), mul(b[5], b[7]))),
                            mul(b[1], sub(mul(b[3], b[8]), mul(b[5], b[6])))),
                        mul(b[2], sub(mul(b[3], b[7]), mul(b[4], b[6]))));
  const float rr = fminf(fmaxf(__fdiv_rn(det, 2.f), -1.f), 1.f);
  const float phi = __fdiv_rn(acosf(rr), 3.f);
  const float l0 = add(q, mul(mul(2.f, p), cosf(phi)));
  const float l2 = add(q, mul(mul(2.f, p), cosf(add(phi, 2.0943951023931953f))));
  *lam_max = l0;
  *lam_mid = sub(sub(mul(3.f, q), l0), l2);
}

// the point-to-line row (point_to_line_hg_cand) on the five nearest c (all
// within max_d2): true with v (J = [rp x v | v]) and the residual r where
// the line gate passes and r > 1e-9
__device__ __forceinline__ bool line_row(const float (*c)[3], const float* q, float ratio, float* v,
                                float* r) {
  float ctr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ctr[i] = __fdiv_rn(sum5(c, i), 5.f);
  float cen[5][3];
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) cen[k][i] = sub(c[k][i], ctr[i]);
  float cov[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) cov[3 * i + j] = cov[3 * j + i] = __fdiv_rn(sum5_prod(cen, i, j), 5.f);
  float lam_max, lam_mid;
  eig_top2(cov, &lam_max, &lam_mid);
  if (!(lam_max > mul(ratio, lam_mid))) return false;
  // sym3_principal_eigvec: the Gershgorin shift, 12 power steps
  float shift = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    shift = fmaxf(shift, add(add(fabsf(cov[3 * i]), fabsf(cov[3 * i + 1])), fabsf(cov[3 * i + 2])));
  float sm[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) sm[k] = k % 4 == 0 ? add(cov[k], shift) : cov[k];
  float n[3] = {0.577350269f, 0.577350269f, 0.577350269f};
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    float w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = dot3(sm + 3 * i, n);
    const float nrm = fmaxf(__fsqrt_rn(dot3(w, w)), 1e-30f);
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = __fdiv_rn(w[i], nrm);
  }
  float diff[3], cx[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) diff[i] = sub(q[i], ctr[i]);
  cross3(diff, n, cx);
  const float dist = __fsqrt_rn(dot3(cx, cx));
  if (!(dist > 1e-9f)) return false;
  float u[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = __fdiv_rn(cx[i], fmaxf(dist, 1e-9f));
  cross3(n, u, v);
  *r = dist;
  return true;
}

// one valid LOAM row into the sums: J = [rp x v | v], H += J J^T, -g += J r
__device__ __forceinline__ void add_row(double* acc, const float* rp, const float* v, float r,
                               bool planar) {
  float jac[6];
  cross3(rp, v, jac);
  jac[3] = v[0];
  jac[4] = v[1];
  jac[5] = v[2];
  int u = L_H;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[u++] += jac[i] * jac[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[L_G + i] += jac[i] * r;
  acc[L_COUNT] += planar ? 1.0 : 0.0;
  acc[L_RES] += r;
}

// the LOAM rows' sums at pose (rot, t) into acc[L_SIZE]: of the corner
// set's line rows (with kLines) then the planar set's plane rows, as one
// range, the rows first, first + stride, ... below end
template <bool kLines, int kM>
__device__ __forceinline__ void loam_rows(const Set& corner, const Set& planar, const LoamParams& p,
                          const float* rot, const float* t, int first, int end, int stride,
                          double* acc) {
#pragma unroll
  for (int k = 0; k < L_SIZE; ++k) acc[k] = 0.0;
  const int nc = kLines ? corner.n : 0;
  for (int r = first; r < end; r += stride) {
    // the row's set, field by field (a reference to either kernel
    // parameter would put both on the stack)
    const bool line = kLines && r < nc;
    const int row = line ? r : r - nc;
    const float* px = line ? corner.px : planar.px;
    const float* py = line ? corner.py : planar.py;
    const float* pz = line ? corner.pz : planar.pz;
    const unsigned char* valid = line ? corner.valid : planar.valid;
    const float* sp = (line ? corner.src : planar.src) + 3 * row;
    const float src[3] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2)};
    float rp[3], q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // R s: a multiply-add chain over k; then + t
      rp[i] = fmaf(rot[3 * i + 2], src[2], fmaf(rot[3 * i + 1], src[1], __fmul_rn(rot[3 * i], src[0])));
      q[i] = __fadd_rn(rp[i], t[i]);
    }
    float d[5], c[5][3];
    nearest5<kM>(px, py, pz, valid, static_cast<size_t>(row) * p.m, p.m, q, d, c);
    if (!(d[4] <= p.max_d2)) continue;  // fewer than five valid lanes, or gated
    float v[3], res;
    const bool ok = line ? line_row(c, q, p.line_ratio, v, &res)
                         : plane_row(c, q, src, p.plane_thresh, v, &res);
    if (ok) add_row(acc, rp, v, res, !line);
  }
}

// the LOAM normal equations from the cluster's sums: H, g, the planar rows
// and the residual sum
__device__ __forceinline__ void loam_system(const double* sums, float* h, float* g, int* nv,
                                            float* res) {
  int u = L_H;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) h[6 * i + j] = h[6 * j + i] = static_cast<float>(sums[u++]);
  for (int i = 0; i < 6; ++i) g[i] = static_cast<float>(-sums[L_G + i]);
  *nv = static_cast<int>(sums[L_COUNT]);
  *res = static_cast<float>(sums[L_RES]);
}

// ------------------------------------------------------------- NDT rows

// the hash constants of ops/voxel.py (_P1-3 and fmix32's multipliers) and
// maps/voxel_hash.py (_F1-3); uint32 arithmetic wraps as their int64 lanes
// masked to 32 bits do
constexpr uint32_t kP1 = 73856093u, kP2 = 471943u, kP3 = 83492791u;
constexpr uint32_t kF1 = 2654435761u, kF2 = 805459861u, kF3 = 3674653429u;
constexpr uint32_t kFmix1 = 0x85EBCA6Bu, kFmix2 = 0xC2B2AE35u;
// maps/ndt_map.py NDT_STENCIL in its order: the voxel, then its 6 faces
__constant__ int kStencil[7][3] = {{0, 0, 0}, {-1, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, -1, 0}, {0, 0, -1}, {0, 0, 1}};

constexpr int kNdtVoxels = 7;
constexpr int kWindowPairs = 8;  // a row of fpwin: PROBE_WINDOW (16) int64 as 16-byte pairs
// a lookup batch: 8 probes of a window, as 4 16-byte loads of its row
constexpr int kBatchProbes = 8;
constexpr int kBatchPairs = kBatchProbes / 2;
// the voxels whose windows (and, after, whose Gaussians) load together:
// four keep the kernel within 255 registers (seven spill)
constexpr int kLookupGroup = 4, kGaussGroup = 4;

// the NDT map's tensors (maps/ndt_map.py NdtMap), read as stored
struct NdtMapView {
  const longlong2* fpwin;          // [C, 16] int64 probe windows as 8 pairs a row:
                                   // fpwin[i][k] = fp[(i + k) mod C] (uint32 bits, 0 = empty)
  const float* mean;               // [C, 3]
  const float* info;               // [C, 3, 3]
  const unsigned char* estimated;  // [C]
  int capacity, num_probes;        // C a power of two, num_probes <= 16 (ops/gn_loop.py checks)
};

struct NdtParams {
  Loop loop;
  float inv, outlier;  // the voxel's inverse size (float32), the gate on e^T lam e
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kFmix1;
  h ^= h >> 13;
  h *= kFmix2;
  return h ^ (h >> 16);
}

// the slot hash (ops/voxel.py spatial_hash) and the fingerprint
// (maps/voxel_hash.py fingerprint) of the voxel or block (x, y, z) of a
// table of mask + 1 slots, in uint32, where a saturated coordinate wraps as
// the int32 tensor sum does
__device__ __forceinline__ void hash_key(uint32_t x, uint32_t y, uint32_t z, uint32_t mask,
                                         uint32_t* base, uint32_t* key) {
  *base = fmix32((x * kP1) ^ (y * kP2) ^ (z * kP3)) & mask;
  *key = fmix32(x * kF1 + y * kF2 + z * kF3) | 1u;
}

// probes [kFrom, kFrom + 8) of the voxels (NDT's stencil voxels, or a
// cover's blocks) [kV0, kN) whose slot is not known yet (slot[v] < 0), from
// the window at base[v] of the table's probe-window rows fpwin ([capacity,
// 16] int64 as 8 pairs a row), kLookupGroup voxels at a time: each group's
// loads all issued before its first compare, then the first probe below
// num_probes whose fingerprint is key[v] (ndt_map._probe,
// block_map.find_block_slots, _first_true), its slot, or -1 where none is.
// An empty slot (0) ends nothing: the fingerprint has its low bit set, so
// it never matches one, and the probes after it are read all the same.
template <int kN, int kFrom, int kV0 = 0>
__device__ __forceinline__ void probe_windows(const longlong2* __restrict__ fpwin, int capacity,
                                              int num_probes, const uint32_t* base,
                                              const uint32_t* key, int* slot) {
  constexpr int kV1 = kV0 + kLookupGroup < kN ? kV0 + kLookupGroup : kN;
  longlong2 w[kV1 - kV0][kBatchPairs];
#pragma unroll
  for (int v = kV0; v < kV1; ++v)
#pragma unroll
    for (int j = 0; j < kBatchPairs; ++j)
      w[v - kV0][j] =
          slot[v] < 0 && kFrom + 2 * j < num_probes
              ? __ldg(fpwin + kWindowPairs * static_cast<size_t>(base[v]) + kFrom / 2 + j)
              : make_longlong2(0, 0);
  const uint32_t mask = static_cast<uint32_t>(capacity) - 1u;
#pragma unroll
  for (int v = kV0; v < kV1; ++v) {
    int first = -1;
#pragma unroll
    for (int k = kBatchProbes - 1; k >= 0; --k) {  // downwards: the first match stays
      const longlong2& pair = w[v - kV0][k >> 1];
      const long long stored = k & 1 ? pair.y : pair.x;
      if (kFrom + k < num_probes && stored == static_cast<long long>(key[v])) first = k;
    }
    if (slot[v] < 0 && first >= 0) slot[v] = static_cast<int>((base[v] + kFrom + first) & mask);
  }
  if constexpr (kV1 < kN)
    probe_windows<kN, kFrom, kV1>(fpwin, capacity, num_probes, base, key, slot);
}

// r s + t of one row r of R, in float64 from the exact float32 products,
// ((r0 s0 + r1 s1) + r2 s2) + t, rounded once (residuals._transform_fixed)
__device__ __forceinline__ float affine_row(const float* r, const float* s, float t) {
  const double v = __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn(r[0], s[0]), __dmul_rn(r[1], s[1])),
                                       __dmul_rn(r[2], s[2])),
                             t);
  return __double2float_rn(v);
}

// e^T lam e in float64 from the exact float32 products: q_a = (lam_a0 e0 +
// lam_a1 e1) + lam_a2 e2, then (e0 q0 + e1 q1) + e2 q2, rounded once
// (residuals._mahalanobis64); a non-finite lam gives a non-finite result
__device__ __forceinline__ float mahalanobis(const float* e, const float* lam) {
  double q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    q[a] = __dadd_rn(__dadd_rn(__dmul_rn(lam[3 * a], e[0]), __dmul_rn(lam[3 * a + 1], e[1])),
                     __dmul_rn(lam[3 * a + 2], e[2]));
  return __double2float_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(e[0], q[0]), __dmul_rn(e[1], q[1])), __dmul_rn(e[2], q[2])));
}

// the stencil voxels [kV0, 7) of a row at q with slots slot[]: the
// Gaussians and flags of kGaussGroup found slots at a time, all their
// loads issued together, then each valid pair in stencil order into the
// row's sums: lsum += lam, esum += lam^T e (float64 from the exact float32
// products), count and res_sum (residuals.ndt_corr's gate). Every voxel of
// a group runs the same instructions, an invalid pair adding zeros
// (selects, not branches), so the compiler interleaves the group's
// independent chains; x + 0 is x, so the sums are those of the valid
// pairs alone
template <int kV0 = 0>
__device__ __forceinline__ void ndt_pairs(const NdtMapView& m, const NdtParams& p, const float* q,
                                          const int* slot, double* lsum, double* esum,
                                          double* count, double* res_sum) {
  constexpr int kV1 = kV0 + kGaussGroup < kNdtVoxels ? kV0 + kGaussGroup : kNdtVoxels;
  float mu[kV1 - kV0][3], lam[kV1 - kV0][9];
  bool est[kV1 - kV0];
#pragma unroll
  for (int v = kV0; v < kV1; ++v) {
    const bool hit = slot[v] >= 0;
    const int sl = hit ? slot[v] : 0;
    est[v - kV0] = hit && __ldg(m.estimated + sl);
#pragma unroll
    for (int i = 0; i < 3; ++i) mu[v - kV0][i] = hit ? __ldg(m.mean + 3 * sl + i) : 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) lam[v - kV0][k] = hit ? __ldg(m.info + 9 * sl + k) : 0.f;
  }
#pragma unroll
  for (int v = 0; v < kV1 - kV0; ++v) {
    float e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = __fsub_rn(q[i], mu[v][i]);
    const float res = mahalanobis(e, lam[v]);
    // NaN and inf never reach the sums: a select, not a product with 0
    const bool ok = est[v] && res <= p.outlier && isfinite(res);
#pragma unroll
    for (int k = 0; k < 9; ++k) lsum[k] += ok ? static_cast<double>(lam[v][k]) : 0.0;
#pragma unroll
    for (int i = 0; i < 3; ++i)  // lam^T e, as residuals._reduce_vec3's g takes it
      esum[i] += ok ? (static_cast<double>(lam[v][i]) * e[0]
                       + static_cast<double>(lam[v][3 + i]) * e[1])
                      + static_cast<double>(lam[v][6 + i]) * e[2]
                    : 0.0;
    *count += ok ? 1.0 : 0.0;
    *res_sum += ok ? res : 0.f;
  }
  if constexpr (kV1 < kNdtVoxels) ndt_pairs<kV1>(m, p, q, slot, lsum, esum, count, res_sum);
}

// a row's valid pairs folded into the sums through J = [a | I] (a = -R
// hat(s), row-major), from the row's sum of lam (lsum, row-major) and of
// lam^T e (esum): H_rr += a^T lsum a, H_rt += a^T lsum, H_tt += lsum, -g_r
// += a^T esum, -g_t += esum (the upper triangle of H, row by row). All in
// float64, a rounded from its float32 terms
__device__ __forceinline__ void ndt_fold_row(double* acc, const float* af, const double* lsum,
                                             const double* esum) {
  double a[9], la[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) a[k] = af[k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j)  // (lsum a)_kj
      la[3 * k + j] = lsum[3 * k] * a[j] + lsum[3 * k + 1] * a[3 + j] + lsum[3 * k + 2] * a[6 + j];
  int u = L_H;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      if (i < 3 && j < 3)
        acc[u] += a[i] * la[j] + a[3 + i] * la[3 + j] + a[6 + i] * la[6 + j];
      else if (i < 3)
        acc[u] += a[i] * lsum[j - 3] + a[3 + i] * lsum[j] + a[6 + i] * lsum[j + 3];
      else
        acc[u] += lsum[3 * (i - 3) + j - 3];
      ++u;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[L_G + i] += a[i] * esum[0] + a[3 + i] * esum[1] + a[6 + i] * esum[2];
    acc[L_G + 3 + i] += esum[i];
  }
}

// the NDT rows' sums at pose (rot, t) into acc[L_SIZE]: the rows first,
// first + stride, ... below end, each row's 7 stencil voxels looked up in
// the map at this pose (every iteration a fresh gather). A row waits on
// memory twice: its 7 windows' fingerprints (a third time only where
// num_probes > 8 and a voxel is not in the first 8), then the found
// slots' means, infos and flags; its mask and source come with the
// previous row's. `pass` counts the call's iterations: from the second
// on, a row keeps its voxel and its 7 slots in cache[3 r .. 3 r + 2]
// ({x, y, z, s0} {s1 .. s4} {s5, s6, -, -}), and from the third on a row
// whose voxel is the one kept takes the kept slots and loads no
// fingerprint (the map is frozen within a call, so the slots are the
// lookup's); a call of one iteration writes nothing there
__device__ __forceinline__ void ndt_rows(const float* __restrict__ src,
                                         const unsigned char* __restrict__ src_mask,
                                         const NdtMapView& m, const NdtParams& p,
                                         int4* __restrict__ cache, int pass, const float* rot,
                                         const float* t, int first, int end, int stride,
                                         double* acc) {
#pragma unroll
  for (int k = 0; k < L_SIZE; ++k) acc[k] = 0.0;
  const uint32_t mask = static_cast<uint32_t>(m.capacity) - 1u;
  bool on_next = false;
  float s_next[3] = {0.f, 0.f, 0.f};
  if (first < end) {
    on_next = __ldg(src_mask + first);
#pragma unroll
    for (int i = 0; i < 3; ++i) s_next[i] = __ldg(src + 3 * first + i);
  }
  for (int r = first; r < end; r += stride) {
    const bool on = on_next;  // a masked row has no valid pair
    const float s[3] = {s_next[0], s_next[1], s_next[2]};
    if (r + stride < end) {
      on_next = __ldg(src_mask + r + stride);
#pragma unroll
      for (int i = 0; i < 3; ++i) s_next[i] = __ldg(src + 3 * (r + stride) + i);
    }
    if (!on) continue;
    float q[3];
    int c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // ops/voxel.py voxel_coords: floor(p * inv) as int32
      q[i] = affine_row(rot + 3 * i, s, t[i]);
      c[i] = static_cast<int>(floorf(__fmul_rn(q[i], p.inv)));
    }
    int slot[kNdtVoxels];
    bool kept = false;
    if (pass >= 2) {
      const int4 k0 = cache[3 * r], k1 = cache[3 * r + 1], k2 = cache[3 * r + 2];
      kept = k0.x == c[0] && k0.y == c[1] && k0.z == c[2];
      slot[0] = k0.w;
      slot[1] = k1.x;
      slot[2] = k1.y;
      slot[3] = k1.z;
      slot[4] = k1.w;
      slot[5] = k2.x;
      slot[6] = k2.y;
    }
    if (!kept) {
      uint32_t base[kNdtVoxels], key[kNdtVoxels];
#pragma unroll
      for (int v = 0; v < kNdtVoxels; ++v) {
        hash_key(static_cast<uint32_t>(c[0]) + static_cast<uint32_t>(kStencil[v][0]),
                 static_cast<uint32_t>(c[1]) + static_cast<uint32_t>(kStencil[v][1]),
                 static_cast<uint32_t>(c[2]) + static_cast<uint32_t>(kStencil[v][2]), mask,
                 &base[v], &key[v]);
        slot[v] = -1;
      }
      probe_windows<kNdtVoxels, 0>(m.fpwin, m.capacity, m.num_probes, base, key, slot);
      if (m.num_probes > kBatchProbes)
        probe_windows<kNdtVoxels, kBatchProbes>(m.fpwin, m.capacity, m.num_probes, base, key, slot);
      if (pass >= 1) {
        cache[3 * r] = make_int4(c[0], c[1], c[2], slot[0]);
        cache[3 * r + 1] = make_int4(slot[1], slot[2], slot[3], slot[4]);
        cache[3 * r + 2] = make_int4(slot[5], slot[6], 0, 0);
      }
    }
    double lsum[9] = {}, esum[3] = {}, count = 0.0, res_sum = 0.0;
    ndt_pairs(m, p, q, slot, lsum, esum, &count, &res_sum);
    if (count == 0.0) continue;
    // a = -R hat(s), row-major (residuals.ndt_hg_corr's J rotation block)
    float a[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float r0 = rot[3 * i], r1 = rot[3 * i + 1], r2 = rot[3 * i + 2];
      a[3 * i] = -(r1 * s[2] - r2 * s[1]);
      a[3 * i + 1] = -(r2 * s[0] - r0 * s[2]);
      a[3 * i + 2] = -(r0 * s[1] - r1 * s[0]);
    }
    ndt_fold_row(acc, a, lsum, esum);
    acc[L_COUNT] += count;
    acc[L_RES] += res_sum;
  }
}

// ------------------------------------------------------ block-map rows

constexpr int kCoverBlocks = 8;  // maps/block_map.py _COVER

// the loop closure's hashed block map (maps/block_map.py BlockMap), read as
// stored: probe windows as fused_select's cover gather probes them, and the
// plane rows of the blocks found
struct BlockMapView {
  const longlong2* fpwin;  // [Cb, 16] int64 probe windows as 8 pairs a row
  const float* tab;        // [Cb + 1, 24 S]: a block's x(8 S) | y(8 S) | z(8 S), a local
                           // voxel's S bucket slots together, _MISS (1e30) where empty
  int capacity, num_probes, bucket;  // Cb a power of two, num_probes <= 16, S
  bool vec4;                         // S % 4 == 0 and tab 16-byte aligned: float4 loads
};

struct PlaneMapParams {
  Loop loop;
  float inv, max_d2, plane_thresh;  // the voxel's inverse size (float32), the gates
};

// the slots of the 8 blocks that cover the 3x3x3 voxels around voxel v
// (block_map.gather_cover): ((v - 1) >> 1) + {0, 1}^3 in _COVER order (x
// outermost), each the first fingerprint match of its probe window, or -1
// where the block is not in the map (the cover gathers the _MISS row there)
__device__ __forceinline__ void cover_slots(const BlockMapView& m, const int* v, int* slot) {
  const uint32_t mask = static_cast<uint32_t>(m.capacity) - 1u;
  uint32_t b0[3], base[kCoverBlocks], key[kCoverBlocks];
#pragma unroll
  for (int i = 0; i < 3; ++i) b0[i] = static_cast<uint32_t>((v[i] - 1) >> 1);  // floors negatives
#pragma unroll
  for (int b = 0; b < kCoverBlocks; ++b) {
    hash_key(b0[0] + (b >> 2), b0[1] + ((b >> 1) & 1), b0[2] + (b & 1), mask, &base[b], &key[b]);
    slot[b] = -1;
  }
  probe_windows<kCoverBlocks, 0>(m.fpwin, m.capacity, m.num_probes, base, key, slot);
  if (m.num_probes > kBatchProbes)
    probe_windows<kCoverBlocks, kBatchProbes>(m.fpwin, m.capacity, m.num_probes, base, key, slot);
}

// one candidate lane at (cx, cy, cz) into the five nearest to q: its d2 as
// fused_select takes it, inserted only below the fifth (insert5 leaves the
// five as they are for any d2 >= d[4], so the test only skips its work)
__device__ __forceinline__ void offer5(float cx, float cy, float cz, const float* q, float* d,
                                       float (*c)[3]) {
  const float cd = dist2(__fsub_rn(cx, q[0]), __fsub_rn(cy, q[1]), __fsub_rn(cz, q[2]));
  if (cd < d[4]) insert5(cd, cx, cy, cz, d, c);
}

// the 5 nearest map points to q among the cover's lanes inside the nearby26
// stencil of q's voxel v (fused_select over gather_cover's row, K = 5):
// ascending, ties to the lower lane, +inf and 0 past the points found. The
// lanes come in the cover row's order (block, local voxel, bucket slot),
// so the stencil's 27 voxels of the cover's 64 keep their order; a voxel is
// in the stencil where its window coordinate 2 b_a + l_a lies within 1 of
// the query's, 2 - (v_a & 1), on every axis (ops/select.py _stencil_mask).
// A missed block's lanes (the _MISS row, d2 +inf) are never read
__device__ __forceinline__ void cover_nearest5(const BlockMapView& m, const int* slot,
                                               const int* v, const float* q, float* d,
                                               float (*c)[3]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    d[k] = INFINITY;
    c[k][0] = c[k][1] = c[k][2] = 0.f;
  }
  const int qw[3] = {2 - (v[0] & 1), 2 - (v[1] & 1), 2 - (v[2] & 1)};
  const int s = m.bucket, plane = 8 * s;
#pragma unroll 1  // unrolled it spills (the header)
  for (int b = 0; b < kCoverBlocks; ++b) {
    if (slot[b] < 0) continue;
    const float* row = m.tab + static_cast<size_t>(slot[b]) * 3 * plane;
#pragma unroll 1
    for (int l = 0; l < 8; ++l) {
      if (abs(2 * (b >> 2) + (l >> 2) - qw[0]) > 1
          || abs(2 * ((b >> 1) & 1) + ((l >> 1) & 1) - qw[1]) > 1
          || abs(2 * (b & 1) + (l & 1) - qw[2]) > 1)
        continue;
      const float* px = row + l * s;
      if (m.vec4) {
        for (int k = 0; k < s; k += 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(px + k));
          const float4 y = __ldg(reinterpret_cast<const float4*>(px + plane + k));
          const float4 z = __ldg(reinterpret_cast<const float4*>(px + 2 * plane + k));
          offer5(x.x, y.x, z.x, q, d, c);
          offer5(x.y, y.y, z.y, q, d, c);
          offer5(x.z, y.z, z.z, q, d, c);
          offer5(x.w, y.w, z.w, q, d, c);
        }
      } else {
        for (int k = 0; k < s; ++k)
          offer5(__ldg(px + k), __ldg(px + plane + k), __ldg(px + 2 * plane + k), q, d, c);
      }
    }
  }
}

// the loop closure's point-to-plane rows (point_to_plane_corr +
// point_to_plane_hg_corr) at pose (rot, t) into acc[L_SIZE], the rows
// first, first + stride, ... below end, each row's 5 nearest looked up in
// the block map at this pose (every iteration a fresh gather): p = R s + t
// taken as the NDT rows take it (affine_row, residuals._transform_fixed),
// its voxel floor(p inv), the cover's slots, the 5 nearest in the stencil,
// the gate on the fifth's d2, then loam_rows' plane row at p (the plane
// fit, its gates and the near reject) with J = [R s x v | v]
__device__ __forceinline__ void plane_map_rows(const float* __restrict__ src,
                                               const unsigned char* __restrict__ src_mask,
                                               const BlockMapView& m, const PlaneMapParams& p,
                                               const float* rot, const float* t, int first,
                                               int end, int stride, double* acc) {
#pragma unroll
  for (int k = 0; k < L_SIZE; ++k) acc[k] = 0.0;
  for (int r = first; r < end; r += stride) {
    if (!__ldg(src_mask + r)) continue;
    const float s[3] = {__ldg(src + 3 * r), __ldg(src + 3 * r + 1), __ldg(src + 3 * r + 2)};
    float q[3], rp[3];
    int v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q[i] = affine_row(rot + 3 * i, s, t[i]);
      v[i] = static_cast<int>(floorf(__fmul_rn(q[i], p.inv)));  // ops/voxel.py voxel_coords
      // R s: a multiply-add chain over k, as loam_rows takes it
      rp[i] = fmaf(rot[3 * i + 2], s[2], fmaf(rot[3 * i + 1], s[1], __fmul_rn(rot[3 * i], s[0])));
    }
    int slot[kCoverBlocks];
    cover_slots(m, v, slot);
    float d[5], c[5][3];
    cover_nearest5(m, slot, v, q, d, c);
    if (!(d[4] <= p.max_d2)) continue;  // fewer than five points in the stencil, or gated
    float n[3], res;
    if (plane_row(c, q, s, p.plane_thresh, n, &res)) add_row(acc, rp, n, res, true);
  }
}

// ------------------------------------------------------- the loop skeleton

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

// thread 0's state within a call
struct Iter {
  bool fresh;    // the call's gather, not yet used
  bool refresh;  // this iteration takes it
  bool moved;    // the pose left the trust region
  bool inside;   // each iteration makes its own gather (NDT): never spent
};

// thread 0, before an iteration: the loop bound, the trust region and the
// gather test of the JAX body. Returns 1 with the pose (R[9], t[3]) to
// linearize at, or 0 with the status word set
__device__ __forceinline__ int begin_iteration(int* ci, const Loop& p, float radius, Iter& s, float* pose) {
  float* cf = reinterpret_cast<float*>(ci);
  if (!(ci[C_GATHERS] < p.max_iters && ci[C_IT] < p.max_total && !ci[C_DONE])) {
    ci[C_STATUS] = S_DONE;
    return 0;
  }
  s.moved = p.skip_dist > 0.f ? moved_beyond(cf + C_T_MAT, cf + C_T_GATHER, radius, p.skip_dist)
                              : true;
  const bool want = ci[C_SINCE_GATHER] >= p.corr_every || ci[C_FORCE_GATHER];
  s.refresh = (want && s.moved) || ci[C_IT] == 0;
  if (s.refresh && !s.fresh) {
    ci[C_STATUS] = S_NEED_GATHER;
    return 0;
  }
  if (s.refresh) {
    for (int k = 0; k < 16; ++k) cf[C_T_GATHER + k] = cf[C_T_MAT + k];
    s.fresh = s.inside;
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) pose[3 * i + j] = cf[C_T_MAT + 4 * i + j];
    pose[9 + i] = cf[C_T_MAT + 4 * i + 3];
  }
  return 1;
}

// thread 0, after the sums (H, g, the valid count, the residual sum): the
// solve, the update (kUpdate) and the carry's flags, as the JAX body sets
// them
template <int kUpdate>
__device__ __forceinline__ void end_iteration(int* ci, const Loop& p, const float* h, const float* g, int nv,
                              float total_res, const Iter& s) {
  float* cf = reinterpret_cast<float*>(ci);
  float x[6];
  if (!solve6(h, g, x))
    for (int k = 0; k < 6; ++k) x[k] = NAN;
  const float* dr = kUpdate == U_ICP ? x + 3 : x;
  const float* dt = kUpdate == U_ICP ? x : x + 3;
  float rot[9], t[3], e[9], rn[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) rot[3 * i + j] = cf[C_T_MAT + 4 * i + j];
    t[i] = cf[C_T_MAT + 4 * i + 3];
  }
  so3::exp(dr, e);
  if (kUpdate == U_LOAM)
    so3::mul(e, rot, rn);
  else
    so3::mul(rot, e, rn);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) cf[C_T_MAT + 4 * i + j] = rn[3 * i + j];
    cf[C_T_MAT + 4 * i + 3] = t[i] + dt[i];
  }
  const float rnorm = sqrtf(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]);
  const float pnorm = sqrtf(dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]);
  const bool enough = nv >= p.min_valid;
  const bool conv = rnorm < p.rot_eps && pnorm < p.pos_eps && enough;
  const bool exact = s.refresh || !s.moved;
  const bool stall = p.use_stall && exact
                     && fabsf(rnorm - cf[C_LAST_ROT]) < p.stall_eps
                     && fabsf(pnorm - cf[C_LAST_POS]) < p.stall_eps;
  const bool settled = conv || stall;
  ci[C_IT] += 1;
  ci[C_GATHERS] += s.refresh ? 1 : 0;
  ci[C_SINCE_GATHER] = s.refresh ? 1 : ci[C_SINCE_GATHER] + 1;
  ci[C_FORCE_GATHER] = settled && !exact;
  ci[C_DONE] = settled && exact;
  ci[C_CONVERGED] = (conv || (stall && enough)) && exact;
  if (exact) {
    cf[C_LAST_ROT] = rnorm;
    cf[C_LAST_POS] = pnorm;
  }
  ci[C_NUM_VALID] = nv;
  cf[C_TOTAL_RES] = total_res;
}

// the rows of one thread of a cluster rank: first, first + stride, ...
// below the call's rows. Tiles of kThreads rows, tile k to rank k mod R, a
// row of a tile to each thread, so the split depends only on the rows and R
// (gn_rank_rows counts a rank's rows with it on the host)
struct RankRows {
  int first, stride;
};

__host__ __device__ inline RankRows rank_rows(int ranks, int rank, int thread) {
  return {rank * kThreads + thread, ranks * kThreads};
}

// a GN kernel's shared memory, kSums partial sums
template <int kSums>
struct GnShared {
  double part[kWarps][kSums];  // the warps' partials
  double red[2][kSums];        // this block's partials, by iteration parity
  double sums[kSums];          // the cluster's, in rank order
  int ci[C_SIZE];              // the carry (thread 0's)
  float pose[12];              // R[9] t[3] of the iteration
  int go;
};

// The loop of either kernel over its cluster (the design above), from the
// carry until it ends or needs a gather. linearize(rot, t, first, end,
// stride, acc) sums a thread's rows at the pose into acc[kSums];
// system(sums, h, g, &nv, &res) turns the cluster's sums into the 6x6
// system, the valid count and the residual sum; kUpdate is the update
// convention; kInside: linearize makes each iteration's gather itself, so
// the call never stops for one (NDT).
template <int kSums, int kUpdate, bool kInside = false, class Rows, class System>
__device__ __forceinline__ void cluster_loop(GnShared<kSums>& sh, int* __restrict__ carry,
                                             const float* __restrict__ radius_ptr,
                                             const Loop& loop, int rows, Rows linearize,
                                             System system) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const RankRows mine = rank_rows(ranks, rank, tid);
  Iter s{true, false, true, kInside};
  StageClock clk;
  const float radius = loop.skip_dist > 0.f ? *radius_ptr : 0.f;

  if (tid == 0) {
    for (int k = 0; k < C_SIZE; ++k) sh.ci[k] = carry[k];
    sh.go = begin_iteration(sh.ci, loop, radius, s, sh.pose);
  }
  __syncthreads();
  clk.mark(K_SETUP);
  for (int parity = 0; sh.go; parity ^= 1) {
    float rot[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k] = sh.pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = sh.pose[9 + k];
    double acc[kSums];
    linearize(rot, t, mine.first, rows, mine.stride, acc);
    clk.mark(K_ROWS);
    block_sum<kSums, kWarps>(acc, sh.part, sh.red[parity]);
    clk.mark(K_BLOCK);
    cluster.sync();  // every rank's red[parity] written
    clk.mark(K_CLUSTER);
    if (tid < kSums) {
      double v = 0.0;
      for (int r = 0; r < ranks; ++r) v += cluster.map_shared_rank(sh.red[parity], r)[tid];
      sh.sums[tid] = v;
    }
    __syncthreads();
    clk.mark(K_DSMEM);
    if (tid == 0) {
      float h[36], g[6], res;
      int nv;
      system(sh.sums, h, g, &nv, &res);
      end_iteration<kUpdate>(sh.ci, loop, h, g, nv, res, s);
      sh.go = begin_iteration(sh.ci, loop, radius, s, sh.pose);
    }
    __syncthreads();
    clk.mark(K_SERIAL);
  }
  cluster.sync();  // no rank's red[] read any more
  clk.mark(K_EXIT);
  if (rank == 0 && tid == 0)
    for (int k = 0; k < C_SIZE; ++k) carry[k] = sh.ci[k];
  if (rank == 0) clk.write(reinterpret_cast<float*>(carry) + C_SIZE);
}

template <int kM>
__global__ void __launch_bounds__(kThreads, 1)
icp_gn_kernel(Set cs, int* __restrict__ carry, const float* __restrict__ radius_ptr,
              IcpParams p) {
  __shared__ GnShared<A_SIZE> sh;
  cluster_loop<A_SIZE, U_ICP>(
      sh, carry, radius_ptr, p.loop, cs.n,
      [&](const float* rot, const float* t, int first, int end, int stride, double* acc) {
        icp_rows<kM>(cs, p, rot, t, first, end, stride, acc);
      },
      [](const double* sums, float* h, float* g, int* nv, float* res) {
        icp_system(sums, h, g, nv, res);
      });
}

template <bool kLines, int kM>
__global__ void __launch_bounds__(kThreads, 1)
loam_gn_kernel(Set corner, Set planar, int* __restrict__ carry,
               const float* __restrict__ radius_ptr, LoamParams p) {
  __shared__ GnShared<L_SIZE> sh;
  cluster_loop<L_SIZE, U_LOAM>(
      sh, carry, radius_ptr, p.loop, (kLines ? corner.n : 0) + planar.n,
      [&](const float* rot, const float* t, int first, int end, int stride, double* acc) {
        loam_rows<kLines, kM>(corner, planar, p, rot, t, first, end, stride, acc);
      },
      [](const double* sums, float* h, float* g, int* nv, float* res) {
        loam_system(sums, h, g, nv, res);
      });
}

__global__ void __launch_bounds__(kThreads, 1)
ndt_gn_kernel(const float* __restrict__ src, const unsigned char* __restrict__ src_mask,
              NdtMapView m, int n, int* __restrict__ carry, int4* __restrict__ cache,
              NdtParams p) {
  __shared__ GnShared<L_SIZE> sh;
  // the call's iterations so far (every thread counts its own); without a
  // slot cache it stays 0, so every iteration looks up afresh
  int pass = 0;
  cluster_loop<L_SIZE, U_NDT, true>(  // no trust-region skip, so no radius
      sh, carry, nullptr, p.loop, n,
      [&](const float* rot, const float* t, int first, int end, int stride, double* acc) {
        ndt_rows(src, src_mask, m, p, cache, cache ? pass++ : 0, rot, t, first, end, stride, acc);
      },
      [](const double* sums, float* h, float* g, int* nv, float* res) {
        loam_system(sums, h, g, nv, res);
      });
}

__global__ void __launch_bounds__(kThreads, 1)
plane_map_gn_kernel(const float* __restrict__ src, const unsigned char* __restrict__ src_mask,
                    BlockMapView m, int n, int* __restrict__ carry, PlaneMapParams p) {
  __shared__ GnShared<L_SIZE> sh;
  cluster_loop<L_SIZE, U_LOAM, true>(  // no trust-region skip, so no radius
      sh, carry, nullptr, p.loop, n,
      [&](const float* rot, const float* t, int first, int end, int stride, double* acc) {
        plane_map_rows(src, src_mask, m, p, rot, t, first, end, stride, acc);
      },
      [](const double* sums, float* h, float* g, int* nv, float* res) {
        loam_system(sums, h, g, nv, res);
      });
}

Loop make_loop(int max_iters, int max_total, int corr_every, int min_valid, int use_stall,
               float rot_eps, float pos_eps, float stall_eps, float skip_dist) {
  return Loop{max_iters, max_total, corr_every, min_valid, use_stall,
              rot_eps, pos_eps, stall_eps, skip_dist};
}

bool aligned16(const Set& s) {
  const auto bits = reinterpret_cast<uintptr_t>(s.px) | reinterpret_cast<uintptr_t>(s.py)
                    | reinterpret_cast<uintptr_t>(s.pz) | reinterpret_cast<uintptr_t>(s.valid);
  return (bits & 15) == 0;
}

// a launch of one cluster of `blocks` blocks of kThreads threads
cudaLaunchConfig_t cluster_config(int blocks, cudaStream_t st, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

constexpr int kMaxDevices = 64;

// the blocks of `kernel`'s cluster on the current device: the first of
// kClusterBlocks of which the occupancy calculator fits one cluster on the
// card (16 needs the non-portable cluster size), chosen on the first call a
// device and kept in chosen[device]. 0 with *err set on a CUDA error, or
// with cudaErrorLaunchOutOfResources where not even 8 blocks fit
template <class Kernel>
int cluster_blocks(Kernel* kernel, int* chosen, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && chosen[dev]) return chosen[dev];
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (*err != cudaSuccess) return 0;
  for (const int blocks : kClusterBlocks) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(blocks, nullptr, &attr);
    int fit = 0;
    if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size the card refuses: try the next
      fit = 0;
    }
    if (fit >= 1) {
      if (dev < kMaxDevices) chosen[dev] = blocks;
      return blocks;
    }
  }
  *err = cudaErrorLaunchOutOfResources;
  return 0;
}

// each kernel variant's cluster, by device
template <int kM>
int icp_blocks(cudaError_t* err) {
  static int chosen[kMaxDevices] = {};
  return cluster_blocks(icp_gn_kernel<kM>, chosen, err);
}

template <bool kLines, int kM>
int loam_blocks(cudaError_t* err) {
  static int chosen[kMaxDevices] = {};
  return cluster_blocks(loam_gn_kernel<kLines, kM>, chosen, err);
}

int ndt_blocks(cudaError_t* err) {
  static int chosen[kMaxDevices] = {};
  return cluster_blocks(ndt_gn_kernel, chosen, err);
}

int plane_map_blocks(cudaError_t* err) {
  static int chosen[kMaxDevices] = {};
  return cluster_blocks(plane_map_gn_kernel, chosen, err);
}

// one cluster of `blocks` blocks of `kernel` on `args`, or `err` (the
// cluster's choice failed) where blocks is 0
template <class Kernel, class... Args>
int launch_cluster(Kernel* kernel, int blocks, cudaError_t err, cudaStream_t st, Args... args) {
  if (blocks == 0) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(blocks, st, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int kM>
int icp_launch(const Set& cs, int* carry, const float* radius, const IcpParams& p,
               cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  const int blocks = icp_blocks<kM>(&err);
  return launch_cluster(icp_gn_kernel<kM>, blocks, err, st, cs, carry, radius, p);
}

template <bool kLines, int kM>
int loam_launch(const Set& corner, const Set& planar, int* carry, const float* radius,
                const LoamParams& p, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  const int blocks = loam_blocks<kLines, kM>(&err);
  return launch_cluster(loam_gn_kernel<kLines, kM>, blocks, err, st, corner, planar, carry,
                        radius, p);
}

int loam_launch(const Set& corner, const Set& planar, bool lines, int* carry,
                const float* radius, const LoamParams& p, cudaStream_t st) {
  const bool vec = p.m == 16 && aligned16(planar) && (!lines || aligned16(corner));
  if (lines && vec) return loam_launch<true, 16>(corner, planar, carry, radius, p, st);
  if (lines) return loam_launch<true, 0>(corner, planar, carry, radius, p, st);
  if (vec) return loam_launch<false, 16>(corner, planar, carry, radius, p, st);
  return loam_launch<false, 0>(corner, planar, carry, radius, p, st);
}

}  // namespace

extern "C" int icp_gn_launch(const float* px, const float* py, const float* pz,
                             const unsigned char* valid, const float* src, int* carry,
                             const float* radius, int n, int m, int max_iters, int max_total,
                             int corr_every, int min_valid, int use_stall, float rot_eps,
                             float pos_eps, float stall_eps, float skip_dist, float max_d2,
                             void* stream) {
  const IcpParams p{m, make_loop(max_iters, max_total, corr_every, min_valid, use_stall,
                                 rot_eps, pos_eps, stall_eps, skip_dist),
                    max_d2};
  const Set cs{px, py, pz, valid, src, n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 16 && aligned16(cs)) return icp_launch<16>(cs, carry, radius, p, st);
  return icp_launch<0>(cs, carry, radius, p, st);
}

extern "C" int plane_gn_launch(const float* px, const float* py, const float* pz,
                               const unsigned char* valid, const float* src, int* carry,
                               const float* radius, int n, int m, int max_iters, int max_total,
                               int corr_every, int min_valid, int use_stall, float rot_eps,
                               float pos_eps, float stall_eps, float skip_dist, float max_d2,
                               float plane_thresh, void* stream) {
  const LoamParams p{m, make_loop(max_iters, max_total, corr_every, min_valid, use_stall,
                                  rot_eps, pos_eps, stall_eps, skip_dist),
                     max_d2, plane_thresh, 0.f};
  const Set planar{px, py, pz, valid, src, n};
  return loam_launch(Set{nullptr, nullptr, nullptr, nullptr, nullptr, 0}, planar, false, carry,
                     radius, p, static_cast<cudaStream_t>(stream));
}

extern "C" int loam_gn_launch(const float* cpx, const float* cpy, const float* cpz,
                              const unsigned char* cvalid, const float* csrc, const float* ppx,
                              const float* ppy, const float* ppz, const unsigned char* pvalid,
                              const float* psrc, int* carry, const float* radius, int nc,
                              int np, int m, int max_iters, int max_total, int corr_every,
                              int min_valid, int use_stall, float rot_eps, float pos_eps,
                              float stall_eps, float skip_dist, float max_d2,
                              float plane_thresh, float line_ratio, void* stream) {
  const LoamParams p{m, make_loop(max_iters, max_total, corr_every, min_valid, use_stall,
                                  rot_eps, pos_eps, stall_eps, skip_dist),
                     max_d2, plane_thresh, line_ratio};
  return loam_launch(Set{cpx, cpy, cpz, cvalid, csrc, nc}, Set{ppx, ppy, ppz, pvalid, psrc, np},
                     true, carry, radius, p, static_cast<cudaStream_t>(stream));
}

// NDT's GN loop over the map's stencil Gaussians, the whole loop in one
// launch: a gather every iteration (corr_every 1) and no trust-region skip,
// the callers' only settings. fpwin is the map's [C, 16] probe-window view,
// 16-byte aligned; slot_cache is [n, 12] int32 scratch, 16-byte aligned,
// whose contents before the call do not matter, or null: then no row keeps
// its slots and every iteration looks up afresh (the same result; what
// tools/profile_torch_loops.py --gn times the kept slots against). The wrapper
// (ops/gn_loop.py ndt_gn_rounds) checks the settings, num_probes, the
// capacity and the alignment.
extern "C" int ndt_gn_launch(const float* src, const unsigned char* src_mask,
                             const long long* fpwin, const float* mean, const float* info,
                             const unsigned char* estimated, int* carry, int* slot_cache, int n,
                             int capacity,
                             int num_probes, int max_iters, int max_total, int min_valid,
                             int use_stall, float rot_eps, float pos_eps, float stall_eps,
                             float inv, float outlier_thresh, void* stream) {
  const NdtParams p{make_loop(max_iters, max_total, 1, min_valid, use_stall, rot_eps, pos_eps,
                              stall_eps, 0.f),
                    inv, outlier_thresh};
  const NdtMapView m{reinterpret_cast<const longlong2*>(fpwin), mean, info, estimated, capacity,
                     num_probes};
  cudaError_t err = cudaSuccess;
  const int blocks = ndt_blocks(&err);
  return launch_cluster(ndt_gn_kernel, blocks, err, static_cast<cudaStream_t>(stream), src,
                        src_mask, m, n, carry, reinterpret_cast<int4*>(slot_cache), p);
}

// The loop closure's point-to-plane refine over its hashed block map, the
// whole loop in one launch: a gather every iteration (corr_every 1), no
// trust-region skip and the nearby26 stencil, the callers' only settings.
// fpwin is the map's [C, 16] probe-window view, 16-byte aligned; tab its
// [C + 1, 24 bucket] plane rows. The wrapper (ops/gn_loop.py
// plane_map_gn_rounds) checks the settings, num_probes, the capacity and
// the alignment of fpwin.
extern "C" int plane_map_gn_launch(const float* src, const unsigned char* src_mask,
                                   const long long* fpwin, const float* tab, int* carry, int n,
                                   int capacity, int num_probes, int bucket, int max_iters,
                                   int max_total, int min_valid, int use_stall, float rot_eps,
                                   float pos_eps, float stall_eps, float inv, float max_d2,
                                   float plane_thresh, void* stream) {
  const PlaneMapParams p{make_loop(max_iters, max_total, 1, min_valid, use_stall, rot_eps,
                                   pos_eps, stall_eps, 0.f),
                         inv, max_d2, plane_thresh};
  const bool vec4 = bucket % 4 == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0;
  const BlockMapView m{reinterpret_cast<const longlong2*>(fpwin), tab, capacity, num_probes,
                       bucket, vec4};
  cudaError_t err = cudaSuccess;
  const int blocks = plane_map_blocks(&err);
  return launch_cluster(plane_map_gn_kernel, blocks, err, static_cast<cudaStream_t>(stream), src,
                        src_mask, m, n, carry, p);
}

// the blocks of the cluster that the launcher of `kind` (G_*) launches on
// the current device for M = 16 with aligned planes (vec 1) or any M
// (vec 0; NDT and the refine have one kernel each, whatever vec); minus the CUDA error where
// none fits or `kind` is unknown
extern "C" int gn_cluster_blocks(int kind, int vec) {
  cudaError_t err = cudaErrorInvalidValue;
  int blocks = 0;
  if (kind == G_ICP) blocks = vec ? icp_blocks<16>(&err) : icp_blocks<0>(&err);
  if (kind == G_PLANE) blocks = vec ? loam_blocks<false, 16>(&err) : loam_blocks<false, 0>(&err);
  if (kind == G_LOAM) blocks = vec ? loam_blocks<true, 16>(&err) : loam_blocks<true, 0>(&err);
  if (kind == G_NDT) blocks = ndt_blocks(&err);
  if (kind == G_PLANE_MAP) blocks = plane_map_blocks(&err);
  return blocks ? blocks : -static_cast<int>(err);
}

// the rows that rank `rank` of a cluster of `ranks` blocks linearizes an
// iteration of a call with `rows` rows (ICP: the set's; LoamFull: corner +
// planar; NDT and the refine: the source's), counted with the kernels' own split
extern "C" int gn_rank_rows(int rows, int ranks, int rank) {
  int n = 0;
  for (int t = 0; t < kThreads; ++t) {
    const RankRows mine = rank_rows(ranks, rank, t);
    for (int r = mine.first; r < rows; r += mine.stride) ++n;
  }
  return n;
}
