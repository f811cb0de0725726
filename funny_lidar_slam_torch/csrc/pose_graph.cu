// The pose graph's Gauss-Newton loop, one launch an optimize:
//
//   pose_graph_gn_kernel  the `iterations` GN steps of the JAX package's
//                         `optimize` (funny_lidar_slam_tpu/backend/
//                         pose_graph.py:69-134, its `lax.fori_loop` at :133),
//                         plain version backend/pose_graph.py::optimize_plain.
//                         It replaces no Pallas kernel: the JAX package runs
//                         the loop as one XLA program; the port ran it as 15
//                         host-driven iterations of dense torch ops, each a
//                         Cholesky of all 6 K unknowns (K = the capacity).
//
// What it computes, as the plain version: per edge the residual
// e = Log(T_m^-1 T_i^-1 T_j), J_j = Jr(e)^-1 Adj(T_j^-1), J_i = -J_j, the
// information applied where the edge's mask is set; H = sum J^T Lam J and
// b = sum J^T Lam e; vertex 0 and the vertices whose mask is clear fixed;
// Jacobi equilibration dj = 1 / sqrt(max(diag H, 1e-12)), + damping I; a
// Cholesky solve; the left-multiplicative update se3_exp(dx) @ pose. A pivot
// that is not > 0 (a NaN included) makes every free pose NaN, as the plain
// version's `cholesky_ex` and the JAX Cholesky do. se3_log, Jr, Adj and
// se3_exp are core/lie.py's, with their small-angle branches (so3.cuh); the
// three coefficients of the Q block of Jr are taken in float64 from the
// float32 angle (in float32 their 1/theta^4 terms cancel to rounding noise,
// as they do in the plain version); every other value is float32.
//
// Why only the free vertices are solved: after the plain version's gating,
// its dense [6K, 6K] system is block diagonal between the free vertices and
// the pinned ones, whose rows are dj = 1 and (1 + damping) dx = 0, so their
// step is exactly 0. The free block's equations are the compact system's.
// An edge with one pinned end still adds its free end's diagonal block and
// b (the odometry edge 0 -> 1, loop edges to vertex 0).
//
// Bound: operations. The factorization of the compact system, at most
// (6 n_f)^3 / 3 operations an iteration and far fewer where blocks are
// skipped (a chain: a 6x6 Cholesky, one panel block and one update a
// vertex), against the bytes of the graph read once (97 B an edge, 64 B a
// pose in and out). At the figure-8's graphs (42 and 84 free vertices, a
// chain and loop edges to vertex 0) both are under a microsecond; what
// holds the kernel is latency: the factorization and the two substitutions
// are chains of n_f dependent block steps, each a global round trip.
//
// Design: one block of 512 threads runs the whole call, so every step
// between phases is a __syncthreads and nothing is read back to the host.
//   0. The output is the input poses; the free vertices get a compact index
//      (a block scan of the mask, any mask), and each free vertex the list
//      of its incident (edge, end) pairs in edge order (counted, placed by
//      atomics, then each list sorted), once a call.
//   Each iteration:
//   1. A thread an edge: its residual, J (Jr^-1 by the 3x3 inverse of its
//      diagonal block and the Q block: [[A^-1, -A^-1 Q A^-1], [0, A^-1]]),
//      h = J^T Lam J and g = J^T Lam e, to the edge scratch.
//   2. A thread a free vertex: its diagonal block (+h for each incident
//      edge), b (-g at the i end, +g at the j end) and its blocks below the
//      diagonal (-h) summed in its list's order, so H and b come out bit
//      for bit alike from run to run; then dj, and the vertex's blocks
//      scaled by dj on both sides, + damping on its diagonal.
//   3. Right-looking Cholesky by 6x6 vertex blocks over the packed lower
//      block triangle of the compact system: for each column k, one thread
//      factors the diagonal block, six threads a block solve the panel
//      blocks below it, and a thread a block pair (i, j) updates
//      A_ij -= L_ik L_jk^T. A block no edge and no update has written is
//      zero and skipped: each block carries the iteration that last wrote
//      it (`epoch`), so nothing is cleared between iterations.
//   4. Warp 0 solves L y = -(dj b) row by row (each row's sum over its
//      written blocks a warp reduction in a fixed order) and L^T x = y from
//      the last row up (each row's x scattered into the sums of the rows
//      it touches, a lane a row); dx = dj x.
//   5. A thread a free vertex: pose = se3_exp(dx) @ pose.
//
// Scratch (the wrapper allocates it, ops/pose_graph.py::scratch_sizes):
// floats: the block triangle, K(K+1)/2 blocks of 36, of which the kernel
// touches the first n_f(n_f+1)/2 (0.13 MB and 0.51 MB at the figure-8's
// graphs, so they stay in L2; sized for K, 19 MB at K = 512, so the
// wrapper need not read n_f from the card); 42 an edge; three 6K vectors.
// ints: the compact index, the vertex of each index, the list cursors (K
// each), the list offsets (K + 1), the lists (2E), the epochs (K(K+1)/2).
//
// Built by funny_lidar_slam_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "so3.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEdgeFloats = 42;  // an edge's h (6x6, row-major), then g (6)

struct Graph {
  const float* poses;              // [K, 4, 4]
  const unsigned char* pose_mask;  // [K]
  const int* ei;                   // [E]
  const int* ej;                   // [E]
  const float* meas;               // [E, 4, 4]
  const float* info;               // [E, 6]
  const unsigned char* edge_mask;  // [E]
  int k, e;
};

struct Scratch {
  float* blocks;  // [K(K+1)/2, 36] lower block triangle, packed by rows
  float* edges;   // [E, 42]
  float* rhs;     // [6K] b, then -(dj b), then y, then x
  float* dj;      // [6K]
  float* acc;     // [6K] the back substitution's sums
  int* cidx;      // [K] compact index of each vertex, -1 where fixed
  int* vid;       // [K] the vertex of each compact index
  int* off;       // [K + 1] list offsets
  int* rows;      // [K] list cursors, then the rows of a column's panel
  int* inc;       // [2E] incident (edge, end) pairs, 2 e + end (0: i, 1: j)
  int* epoch;     // [K(K+1)/2] the iteration + 1 that last wrote each block
};

struct Layout {
  long long floats, ints;
};

Layout layout(int k, int e) {
  const long long nb = static_cast<long long>(k) * (k + 1) / 2;
  return {nb * 36 + static_cast<long long>(e) * kEdgeFloats + 18LL * k,
          4LL * k + 1 + 2LL * e + nb};
}

__device__ __forceinline__ long long tri(int i) { return static_cast<long long>(i) * (i + 1) / 2; }
__device__ __forceinline__ float* block_at(const Scratch& s, int i, int j) {
  return s.blocks + (tri(i) + j) * 36;
}
__device__ __forceinline__ int* epoch_at(const Scratch& s, int i, int j) {
  return s.epoch + tri(i) + j;
}

// Exclusive prefix sum of x over the block, called by every thread; *total
// gets the block's sum.
__device__ int block_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? s_warp[warp - 1] : 0) + v - x;
  *total = s_warp[kWarps - 1];
  __syncthreads();
  return before;
}

// The edge's ends where it counts (mask set, both ends in [0, K), one end
// free).
__device__ __forceinline__ bool edge_used(const Graph& g, const int* cidx, int e, int& vi,
                                          int& vj) {
  if (!g.edge_mask[e]) return false;
  vi = g.ei[e];
  vj = g.ej[e];
  if (vi < 0 || vi >= g.k || vj < 0 || vj >= g.k) return false;
  return cidx[vi] >= 0 || cidx[vj] >= 0;
}

// se3_inv of a row-major 4x4: r = R^T, p = -(R^T t)
__device__ void inv_rt(const float* t, float r[9], float p[3]) {
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) r[3 * a + b] = t[4 * b + a];
  for (int a = 0; a < 3; ++a)
    p[a] = -(r[3 * a] * t[3] + r[3 * a + 1] * t[7] + r[3 * a + 2] * t[11]);
}

// (r1, p1) then (r2, p2) as the 4x4 product: r = r1 r2, p = r1 p2 + p1
__device__ void compose(const float r1[9], const float p1[3], const float r2[9],
                        const float p2[3], float r[9], float p[3]) {
  so3::mul(r1, r2, r);
  for (int a = 0; a < 3; ++a)
    p[a] = r1[3 * a] * p2[0] + r1[3 * a + 1] * p2[1] + r1[3 * a + 2] * p2[2] + p1[a];
}

// lie._se3_q_block(rho, phi), its coefficients c1..c3 in float64
__device__ void q_block(const float rho[3], const float phi[3], float q[9]) {
  const float th2 = so3::theta_sq(phi);
  float c1 = 1.f / 6.f, c2 = 1.f / 24.f, c3 = 1.f / 120.f;
  if (!(th2 < so3::kEps)) {
    const double s = fmaxf(sqrtf(th2), so3::kEps);
    const double st = sin(s), ct = cos(s), it = 1.0 / s;
    const double it2 = it * it, it4 = it2 * it2;
    c1 = static_cast<float>(it2 - st * it2 * it);
    c2 = static_cast<float>(0.5 * it2 + ct * it4 - it4);
    c3 = static_cast<float>(it4 + 0.5 * ct * it4 - 1.5 * st * it * it4);
  }
  float u[9], w[9], wu[9], uw[9], wuw[9], t1[9], t2[9];
  so3::hat(rho, u);
  so3::hat(phi, w);
  so3::mul(w, u, wu);
  so3::mul(wu, w, wuw);
  so3::mul(u, w, uw);
  so3::mul(wuw, w, t1);
  so3::mul(w, wuw, t2);
  for (int k = 0; k < 9; ++k)
    q[k] = 0.5f * u[k] + c1 * (wu[k] + uw[k] + wuw[k]) - c2 * (th2 * u[k] + 2.f * wuw[k]) +
           c3 * (t1[k] + t2[k]);
}

// 3x3 inverse by Gauss-Jordan elimination with partial pivoting
__device__ void inv3(const float a[9], float out[9]) {
  float m[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m[r][c] = a[3 * r + c];
      m[r][3 + c] = r == c ? 1.f : 0.f;
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int p = c;
#pragma unroll
    for (int r = c + 1; r < 3; ++r)
      if (fabsf(m[r][c]) > fabsf(m[p][c])) p = r;
#pragma unroll
    for (int r = c + 1; r < 3; ++r)
      if (r == p)
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float t = m[c][q];
          m[c][q] = m[r][q];
          m[r][q] = t;
        }
    const float piv = m[c][c];
#pragma unroll
    for (int q = 0; q < 6; ++q) m[c][q] = m[c][q] / piv;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r == c) continue;
      const float f = m[r][c];
#pragma unroll
      for (int q = 0; q < 6; ++q) m[r][q] = m[r][q] - f * m[c][q];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * r + c] = m[r][3 + c];
}

// One edge at poses ti, tj (row-major 4x4): h = J^T Lam J and g = J^T Lam e
// with J = J_j, to out[0..42).
__device__ void edge_blocks(const float* ti, const float* tj, const float* meas,
                            const float* info, float* out) {
  float rm[9], pm[3], ri[9], pi[3], ra[9], pa[3], rj[9], pj[3], re[9], pe[3];
  inv_rt(meas, rm, pm);
  inv_rt(ti, ri, pi);
  compose(rm, pm, ri, pi, ra, pa);
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) rj[3 * a + b] = tj[4 * a + b];
    pj[a] = tj[4 * a + 3];
  }
  compose(ra, pa, rj, pj, re, pe);
  float e[6], jli[9];
  so3::log(re, e + 3);
  so3::jl_inv(e + 3, jli);
  so3::mv(jli, pe, e);
  // Jr(e) = se3_jl(-e) = [[A, Q], [0, A]]
  const float nrho[3] = {-e[0], -e[1], -e[2]}, nphi[3] = {-e[3], -e[4], -e[5]};
  float a[9], q[9], ai[9];
  so3::jl(nphi, a);
  q_block(nrho, nphi, q);
  inv3(a, ai);
  // Adj(T_j^-1) = [[Rt, hat(pt) Rt], [0, Rt]]; J = [[M, N], [0, M]] with
  // M = A^-1 Rt, N = A^-1 hat(pt) Rt - (A^-1 Q A^-1) Rt
  float rt[9], pt[3], mm[9], hx[9], x[9], aiq[9], y[9], nn[9], yr[9];
  inv_rt(tj, rt, pt);
  so3::mul(ai, rt, mm);
  so3::hat(pt, hx);
  so3::mul(hx, rt, x);
  so3::mul(ai, q, aiq);
  so3::mul(aiq, ai, y);
  so3::mul(ai, x, nn);
  so3::mul(y, rt, yr);
  for (int k = 0; k < 9; ++k) nn[k] = nn[k] - yr[k];
  float j[36];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      j[6 * r + c] = mm[3 * r + c];
      j[6 * r + 3 + c] = nn[3 * r + c];
      j[6 * (r + 3) + c] = 0.f;
      j[6 * (r + 3) + 3 + c] = mm[3 * r + c];
    }
  float lam[6];
  for (int k = 0; k < 6; ++k) lam[k] = info[k];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float jtl[6];  // row r of J^T Lam
#pragma unroll
    for (int k = 0; k < 6; ++k) jtl[k] = j[6 * k + r] * lam[k];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += jtl[k] * j[6 * k + c];
      out[6 * r + c] = s;
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += jtl[k] * e[k];
    out[36 + r] = s;
  }
}

// The NaN-keeping clamp of torch.clamp(x, min=lo)
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__global__ void __launch_bounds__(kThreads)
pose_graph_gn_kernel(Graph g, Scratch s, float* poses, int iterations, float damping) {
  __shared__ int s_warp[kWarps];
  __shared__ float s_l[36];
  __shared__ int s_count, s_fail;
  const int tid = threadIdx.x;

  for (int q = tid; q < g.k * 16; q += kThreads) poses[q] = g.poses[q];

  // 0. compact indices, then the incident lists in edge order
  int nf = 0;
  for (int v0 = 0; v0 < g.k; v0 += kThreads) {
    const int v = v0 + tid;
    const int f = (v < g.k && v != 0 && g.pose_mask[v]) ? 1 : 0;
    int total;
    const int before = block_scan(f, s_warp, &total);
    if (v < g.k) s.cidx[v] = f ? nf + before : -1;
    if (f) s.vid[nf + before] = v;
    nf += total;
  }
  if (nf == 0 || iterations <= 0) return;
  for (int c = tid; c <= nf; c += kThreads) s.off[c] = 0;
  for (long long t = tid; t < tri(nf); t += kThreads) s.epoch[t] = 0;
  __syncthreads();
  for (int q = tid; q < 2 * g.e; q += kThreads) {
    int vi, vj;
    if (!edge_used(g, s.cidx, q >> 1, vi, vj)) continue;
    const int c = s.cidx[(q & 1) ? vj : vi];
    if (c >= 0) atomicAdd(&s.off[c + 1], 1);
  }
  __syncthreads();
  int base = 0;
  for (int c0 = 0; c0 < nf; c0 += kThreads) {
    const int c = c0 + tid;
    const int x = c < nf ? s.off[c + 1] : 0;
    int total;
    const int before = block_scan(x, s_warp, &total);
    if (c < nf) {
      s.off[c + 1] = base + before + x;
      s.rows[c] = base + before;
    }
    base += total;
  }
  __syncthreads();
  for (int q = tid; q < 2 * g.e; q += kThreads) {
    int vi, vj;
    if (!edge_used(g, s.cidx, q >> 1, vi, vj)) continue;
    const int c = s.cidx[(q & 1) ? vj : vi];
    if (c >= 0) s.inc[atomicAdd(&s.rows[c], 1)] = q;
  }
  __syncthreads();
  for (int c = tid; c < nf; c += kThreads) {  // insertion sort: edge order, then i before j
    for (int p = s.off[c] + 1; p < s.off[c + 1]; ++p) {
      const int x = s.inc[p];
      int r = p - 1;
      for (; r >= s.off[c] && s.inc[r] > x; --r) s.inc[r + 1] = s.inc[r];
      s.inc[r + 1] = x;
    }
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const int epoch = it + 1;
    // 1. the edges
    for (int e = tid; e < g.e; e += kThreads) {
      int vi, vj;
      if (edge_used(g, s.cidx, e, vi, vj))
        edge_blocks(poses + 16 * vi, poses + 16 * vj, g.meas + 16 * e, g.info + 6 * e,
                    s.edges + static_cast<long long>(kEdgeFloats) * e);
    }
    __syncthreads();
    // 2. a row's blocks and b, in its list's order
    for (int c = tid; c < nf; c += kThreads) {
      float diag[36], bv[6];
#pragma unroll
      for (int k = 0; k < 36; ++k) diag[k] = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) bv[r] = 0.f;
      for (int p = s.off[c]; p < s.off[c + 1]; ++p) {
        const int ent = s.inc[p], e = ent >> 1, end = ent & 1;
        const float* hg = s.edges + static_cast<long long>(kEdgeFloats) * e;
        const int o = s.cidx[end ? g.ei[e] : g.ej[e]];
#pragma unroll
        for (int k = 0; k < 36; ++k) diag[k] += hg[k];
#pragma unroll
        for (int r = 0; r < 6; ++r) bv[r] += end ? hg[36 + r] : -hg[36 + r];
        if (o == c) {  // both ends here: the two cross blocks land on the diagonal
#pragma unroll
          for (int k = 0; k < 36; ++k) diag[k] += -hg[k];
        } else if (o >= 0 && o < c) {
          float* blk = block_at(s, c, o);
          int* ep = epoch_at(s, c, o);
          if (*ep == epoch) {
            for (int k = 0; k < 36; ++k) blk[k] += -hg[k];
          } else {
            for (int k = 0; k < 36; ++k) blk[k] = -hg[k];
            *ep = epoch;
          }
        }
      }
      float* d = block_at(s, c, c);
#pragma unroll
      for (int k = 0; k < 36; ++k) d[k] = diag[k];
      *epoch_at(s, c, c) = epoch;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        s.rhs[6 * c + r] = bv[r];
        s.dj[6 * c + r] = 1.f / sqrtf(clamp_min(diag[7 * r], 1e-12f));
      }
    }
    __syncthreads();
    //    equilibration: each block (row c, column o) scaled once, by its row
    for (int c = tid; c < nf; c += kThreads) {
      const float* djc = s.dj + 6 * c;
      float* d = block_at(s, c, c);
      for (int r = 0; r < 6; ++r)
        for (int q = 0; q < 6; ++q) d[6 * r + q] = (d[6 * r + q] * djc[r]) * djc[q];
      for (int r = 0; r < 6; ++r) {
        d[7 * r] += damping;
        s.rhs[6 * c + r] = -(s.rhs[6 * c + r] * djc[r]);
      }
      for (int p = s.off[c]; p < s.off[c + 1]; ++p) {
        const int e = s.inc[p] >> 1;
        const int o = s.cidx[(s.inc[p] & 1) ? g.ei[e] : g.ej[e]];
        if (o < 0 || o >= c) continue;
        bool first = true;
        for (int p2 = s.off[c]; p2 < p && first; ++p2) {
          const int e2 = s.inc[p2] >> 1;
          first = s.cidx[(s.inc[p2] & 1) ? g.ei[e2] : g.ej[e2]] != o;
        }
        if (!first) continue;
        float* blk = block_at(s, c, o);
        const float* djo = s.dj + 6 * o;
        for (int r = 0; r < 6; ++r)
          for (int q = 0; q < 6; ++q) blk[6 * r + q] = (blk[6 * r + q] * djc[r]) * djo[q];
      }
    }
    if (tid == 0) s_fail = 0;
    __syncthreads();
    // 3. right-looking block Cholesky, written blocks only
    for (int k = 0; k < nf; ++k) {
      if (tid == 0) {
        float* a = block_at(s, k, k);
        float l[36];
        bool ok = true;
#pragma unroll
        for (int jc = 0; jc < 6; ++jc) {
          float dot = 0.f;
#pragma unroll
          for (int m = 0; m < jc; ++m) dot += l[6 * jc + m] * l[6 * jc + m];
          const float d = a[7 * jc] - dot;
          ok = ok && d > 0.f;
          l[7 * jc] = sqrtf(d);
#pragma unroll
          for (int i = jc + 1; i < 6; ++i) {
            float di = 0.f;
#pragma unroll
            for (int m = 0; m < jc; ++m) di += l[6 * i + m] * l[6 * jc + m];
            l[6 * i + jc] = (a[6 * i + jc] - di) / l[7 * jc];
          }
#pragma unroll
          for (int i = 0; i < jc; ++i) l[6 * i + jc] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < 36; ++q) {
          a[q] = l[q];
          s_l[q] = l[q];
        }
        if (!ok) s_fail = 1;
        s_count = 0;
      }
      __syncthreads();
      if (s_fail) break;
      for (int t = tid; t < (nf - k - 1) * 6; t += kThreads) {  // the panel, a block row a thread
        const int i = k + 1 + t / 6, r = t % 6;
        if (*epoch_at(s, i, k) != epoch) continue;
        float* row = block_at(s, i, k) + 6 * r;
        float x[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          float dot = 0.f;
#pragma unroll
          for (int m = 0; m < c; ++m) dot += x[m] * s_l[6 * c + m];
          x[c] = (row[c] - dot) / s_l[7 * c];
        }
#pragma unroll
        for (int c = 0; c < 6; ++c) row[c] = x[c];
        if (r == 0) s.rows[atomicAdd(&s_count, 1)] = i;
      }
      __syncthreads();
      const long long m = s_count;
      for (long long p = tid; p < m * (m + 1) / 2; p += kThreads) {  // a thread a block pair
        long long x = static_cast<long long>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) / 2.0);
        while ((x + 1) * (x + 2) / 2 <= p) ++x;
        while (x * (x + 1) / 2 > p) --x;
        int i = s.rows[x], j = s.rows[p - x * (x + 1) / 2];
        if (i < j) {
          const int t = i;
          i = j;
          j = t;
        }
        const float* li = block_at(s, i, k);
        const float* lj = block_at(s, j, k);
        float* a = block_at(s, i, j);
        int* ep = epoch_at(s, i, j);
        const bool had = *ep == epoch;
        float ljr[36];
#pragma unroll
        for (int q = 0; q < 36; ++q) ljr[q] = lj[q];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          float lir[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) lir[q] = li[6 * r + q];
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < 6; ++q) acc += lir[q] * ljr[6 * c + q];
            a[6 * r + c] = had ? a[6 * r + c] - acc : -acc;
          }
        }
        if (!had) *ep = epoch;
      }
      __syncthreads();
    }
    const bool failed = s_fail != 0;
    // 4. the two substitutions, warp 0
    if (!failed && tid < 32) {
      const int lane = tid;
      for (int i = 0; i < nf; ++i) {
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int j = lane; j < i; j += 32) {
          if (*epoch_at(s, i, j) != epoch) continue;
          const float* l = block_at(s, i, j);
          const float* y = s.rhs + 6 * j;
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            float dot = 0.f;
#pragma unroll
            for (int q = 0; q < 6; ++q) dot += l[6 * r + q] * y[q];
            acc[r] += dot;
          }
        }
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int d = 16; d >= 1; d >>= 1) acc[r] += __shfl_xor_sync(kFullMask, acc[r], d);
        if (lane == 0) {
          const float* l = block_at(s, i, i);
          float* y = s.rhs + 6 * i;
          float v[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            float dot = 0.f;
#pragma unroll
            for (int m = 0; m < q; ++m) dot += l[6 * q + m] * v[m];
            v[q] = ((y[q] - acc[q]) - dot) / l[7 * q];
          }
#pragma unroll
          for (int q = 0; q < 6; ++q) y[q] = v[q];
        }
        __syncwarp();
      }
      for (int q = lane; q < 6 * nf; q += 32) s.acc[q] = 0.f;
      __syncwarp();
      for (int i = nf - 1; i >= 0; --i) {
        if (lane == 0) {
          const float* l = block_at(s, i, i);
          float* y = s.rhs + 6 * i;
          float v[6];
#pragma unroll
          for (int q = 5; q >= 0; --q) {
            float dot = 0.f;
#pragma unroll
            for (int m = q + 1; m < 6; ++m) dot += l[6 * m + q] * v[m];
            v[q] = ((y[q] - s.acc[6 * i + q]) - dot) / l[7 * q];
          }
#pragma unroll
          for (int q = 0; q < 6; ++q) y[q] = v[q];
        }
        __syncwarp();
        const float* x = s.rhs + 6 * i;
        for (int j = lane; j < i; j += 32) {
          if (*epoch_at(s, i, j) != epoch) continue;
          const float* l = block_at(s, i, j);
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            float dot = 0.f;
#pragma unroll
            for (int r = 0; r < 6; ++r) dot += l[6 * r + q] * x[r];
            s.acc[6 * j + q] += dot;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // 5. pose = se3_exp(dx) @ pose
    for (int c = tid; c < nf; c += kThreads) {
      float dx[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) dx[r] = failed ? NAN : s.dj[6 * c + r] * s.rhs[6 * c + r];
      float r3[9], jl[9], t[3];
      so3::exp(dx + 3, r3);
      so3::jl(dx + 3, jl);
      so3::mv(jl, dx, t);
      const float tm[16] = {r3[0], r3[1], r3[2], t[0], r3[3], r3[4], r3[5], t[1],
                            r3[6], r3[7], r3[8], t[2], 0.f,   0.f,   0.f,   1.f};
      float* pose = poses + 16 * s.vid[c];
      float p[16], out[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) p[q] = pose[q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          out[4 * a + b] = tm[4 * a] * p[b] + tm[4 * a + 1] * p[4 + b] + tm[4 * a + 2] * p[8 + b] +
                           tm[4 * a + 3] * p[12 + b];
#pragma unroll
      for (int q = 0; q < 16; ++q) pose[q] = out[q];
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a size or a scratch it cannot take.
extern "C" int pose_graph_gn_launch(const float* poses, const unsigned char* pose_mask,
                                    const int* edge_i, const int* edge_j, const float* edge_meas,
                                    const float* edge_info, const unsigned char* edge_mask,
                                    float* out, float* fscratch, int* iscratch,
                                    long long fscratch_size, long long iscratch_size, int k,
                                    int e, int iterations, float damping, void* stream) {
  if (k < 1 || e < 0 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(k, e);
  if (fscratch_size < lay.floats || iscratch_size < lay.ints)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = static_cast<long long>(k) * (k + 1) / 2;
  const Graph g{poses, pose_mask, edge_i, edge_j, edge_meas, edge_info, edge_mask, k, e};
  float* f = fscratch;
  int* n = iscratch;
  const Scratch s{f, f + nb * 36, f + nb * 36 + static_cast<long long>(e) * kEdgeFloats,
                  f + nb * 36 + static_cast<long long>(e) * kEdgeFloats + 6LL * k,
                  f + nb * 36 + static_cast<long long>(e) * kEdgeFloats + 12LL * k,
                  n, n + k, n + 2 * k, n + 3 * k + 1, n + 4 * k + 1, n + 4 * k + 1 + 2LL * e};
  pose_graph_gn_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, s, out,
                                                                               iterations, damping);
  return static_cast<int>(cudaGetLastError());
}
