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
// step is exactly 0. The free block's equations are the compact system's,
// here eliminated in a fill-reducing order: a symmetric permutation of a
// positive definite system changes the solution by rounding only.
//
// Bound: operations, those of the factorization in this order (each block
// update L_ik L_jk^T, panel block and 6x6 Cholesky once) and of the edges,
// against the bytes of the graph read once (97 B an edge, 64 B a pose in and
// out). Both are under a microsecond at the figure-8's graphs; what holds
// the kernel is latency: chains of dependent steps, most of them one
// thread's or one team's serial arithmetic. The first design eliminated the
// vertices one at a time in their natural order, three block barriers a
// vertex, and its substitutions walked every row, so an iteration was
// ~3 n_f dependent global round trips; and on a graph with long loops (the
// dry run's 1,000-keyframe circle with 600 chords) the natural order
// filled the factor to a dense band (15.1 M block updates an iteration).
// Here the order is a nested dissection, whose elimination tree has
// ~log2(n_f) levels on a chain and 22 on the dry run's graph (8,194 block
// updates), and each stage runs a tree level at a time.
//
// Design: one block of 512 threads runs the whole call, so every step
// between stages is a __syncthreads and nothing is read back to the host.
//   Symbolic phase, once a call:
//   0. The output is the input poses; the free vertices get a compact index
//      (a block scan of the mask, any mask); each free vertex the list of
//      its incident (edge, end) pairs in edge order, and beside each entry
//      the compact index of the other end (-1 where it is pinned).
//   1. The order, a nested dissection by rounds, a thread a part (the
//      parts of a round on different warps). A part is a range of
//      positions whose vertices are kept in ascending compact index. A part
//      of one vertex is placed. Otherwise a BFS from its smallest vertex:
//      if it does not reach the whole part, the part splits into its
//      connected components, in the order of their smallest vertices. If it
//      does, up to kSweeps more BFS from the smallest vertex of the last
//      level, while the eccentricity grows (a pseudo-peripheral root); the
//      part splits into A (levels below the middle level e / 2), B (above)
//      and the separator S (the middle level), placed A, B, S. Every choice
//      is by level sets and compact indices, never by the order threads
//      ran, so ops/pose_graph.py::symbolic_plain reproduces the permutation
//      exactly.
//   2. The elimination tree by Liu's row-subtree walk (one thread); each
//      row's column list, sorted (a thread a row); the blocks numbered by
//      columns, the diagonal first, then the rows ascending (a thread a
//      column, walking its ancestors); the tree levels (leaves 0) and the
//      columns by level; for each incident entry, the block of L it adds to
//      where its vertex comes later in the order.
//   Each iteration:
//   3. A thread an edge: its residual, J (Jr^-1 by the 3x3 inverse of its
//      diagonal block and the Q block: [[A^-1, -A^-1 Q A^-1], [0, A^-1]]),
//      h = J^T Lam J and g = J^T Lam e, to the edge scratch; L's blocks
//      zeroed.
//   4. A thread a free vertex: its diagonal block (+h for each incident
//      edge), b (-g at the i end, +g at the j end) and the blocks it owns
//      below the diagonal (-h) summed in its list's order, so H and b come
//      out bit for bit alike from run to run; then dj and -(dj b).
//   5. Left-looking block Cholesky a tree level at a time, leaves first,
//      one barrier a level (__syncthreads_or, which also tells every
//      thread of a failed pivot). A column is the work of a team of 6
//      lanes (5 teams a warp, a lane a block row), or of several teams
//      where the level has fewer columns than teams. A team forms the
//      column's equilibrated, damped diagonal less sum_k L_jk L_jk^T over
//      the column's row list and factors it across its lanes (shuffles,
//      rsqrtf for each pivot's inverse); every team of the column computes
//      the same factor, so no team waits for another. The first team
//      writes L_jj, its inverse pivots and y_j = L_jj^-1 (b_j - sum_k
//      L_jk y_k) from the same loads: the forward substitution is done
//      with the factorization. Each team then takes its share of the
//      column's blocks below the diagonal: dj_i A_ij dj_j less
//      sum_k L_ik L_jk^T over the common entries of rows i and j (a merge of
//      the two sorted row lists, k ascending), solved against L_jj^T. Each
//      block of L has one writer and its sums a fixed order: no atomics,
//      and two launches agree bit for bit.
//   6. The back substitution from the root down, a level at a time: a
//      column a warp where the level has no more columns than warps (its
//      blocks spread over the lanes, a fixed shuffle tree), else a column a
//      thread.
//   7. A thread a free vertex: pose = se3_exp(dj x) @ pose.
//   The symbolic phase's per-vertex working arrays live in dynamic shared
//   memory where they fit; then L's pattern, and beside it L, b, dj, A's
//   diagonal and the inverse pivots, where they fit (kDynBytes: all of it
//   at the figure-8's graphs, ~240 blocks; the pattern alone at the dry
//   run's, whose ~4,450 blocks of L stay in the float scratch).
//
// Scratch (the wrapper allocates it, ops/pose_graph.py::scratch_sizes),
// sized from K and E alone, so the wrapper need not read n_f from the card:
// floats: L's blocks, at most K(K+1)/2 of 36 (a filled triangle); A's
// diagonal blocks (36 K); 42 an edge; b, dj and L's inverse pivots (6 K
// each). ints: the permutation (position -> compact index) first, then the
// per-vertex arrays, the incident lists and their side arrays (2E each),
// and the block pattern (three arrays of K(K+1)/2), as `carve` sets out.
// A build with -DFLS_STAGE_CLOCKS (stage_clock.cuh) writes thread 0's
// cycles in each stage (PG_* below) after the float scratch, which must
// then hold kStageClocks floats more.
//
// Built by funny_lidar_slam_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "so3.cuh"
#include "stage_clock.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTeamLanes = 6;  // a team: a block's 6 rows
constexpr int kTeamsPerWarp = 32 / kTeamLanes;
constexpr int kTeams = kWarps * kTeamsPerWarp;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEdgeFloats = 42;  // an edge's h (6x6, row-major), then g (6)
constexpr int kSweeps = 4;       // pseudo-peripheral BFS after the first
constexpr int kDynBytes = 128 * 1024;
constexpr int kHotArrays = 7;    // per-vertex ints of the symbolic phase (n_f + 1 each)

// stage clocks of a profiling build (stage_clock.cuh)
// (PG_F_*: thread 0's part of the factorization, the first team's column
// of each level: its diagonal sum, its factor and y_j, its panels, then
// the wait at the level's barrier)
enum {
  PG_ORDER, PG_TREE, PG_EDGES, PG_ASSEMBLY, PG_FACTOR, PG_SUBSTITUTE, PG_UPDATE,
  PG_F_DIAG, PG_F_CHOL, PG_F_PANEL, PG_F_WAIT
};

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
  // floats
  float* blocks;  // [K(K+1)/2, 36] L by columns: the diagonal, then rows ascending
  float* adiag;   // [K, 36] A's diagonal blocks by position
  float* edges;   // [E, 42]
  float* rhs;     // [6K] by position: -(dj b), then y, then x
  float* dj;      // [6K] by position
  float* pinv;    // [6K] by position: 1 / L_jj's diagonal
  // ints, [K] each unless named
  int* perm;      // position -> compact index
  int* where;     // compact index -> position
  int* cidx;      // vertex -> compact index, -1 where fixed
  int* vid;       // compact index -> vertex
  int* cur;       // cursors
  int* tmp;       // the order's partitions
  int* lev;       // BFS levels and component labels
  int* q;         // BFS queues
  int* seg;       // seg[p] = end of the active part that starts at p, else 0
  int* parts;     // a round's part starts
  int* parent;    // the elimination tree by position, -1 at a root
  int* flag;      // the row-subtree walk's marks
  int* lvl;       // tree level by position (leaves 0)
  int* levcol;    // the columns by level, ascending in each
  int* off;       // [K + 1] incident list offsets
  int* rowptr;    // [K + 1] row list offsets
  int* colptr;    // [K + 1] the first block of each column
  int* levptr;    // [K + 1] levcol offsets of each level
  int* inc;       // [2E] incident (edge, end) pairs, 2 e + end (0: i, 1: j)
  int* nbr;       // [2E] the compact index of the entry's other end, -1 if fixed
  int* tgt;       // [2E] the block of L the entry adds -h to, -1 if none
  int* rowk;      // [K(K+1)/2] each row's columns k < i, ascending
  int* rowb;      // [K(K+1)/2] the block of each row-list entry
  int* brow;      // [K(K+1)/2] each block's row
};

struct Layout {
  long long floats, ints;
};

Layout layout(int k, int e) {
  const long long nb = static_cast<long long>(k) * (k + 1) / 2;
  return {nb * 36 + 54LL * k + static_cast<long long>(e) * kEdgeFloats,
          18LL * k + 4 + 6LL * e + 3 * nb};
}

Scratch carve(float* f, int* n, int k, int e) {
  const long long nb = static_cast<long long>(k) * (k + 1) / 2;
  Scratch s;
  s.blocks = f;
  f += nb * 36;
  s.adiag = f;
  f += 36LL * k;
  s.edges = f;
  f += static_cast<long long>(e) * kEdgeFloats;
  s.rhs = f;
  s.dj = f + 6LL * k;
  s.pinv = f + 12LL * k;
  int** per_vertex[] = {&s.perm, &s.where, &s.cidx,   &s.vid,  &s.cur,  &s.tmp,    &s.lev,
                        &s.q,    &s.seg,   &s.parts,  &s.parent, &s.flag, &s.lvl, &s.levcol};
  for (int** p : per_vertex) {
    *p = n;
    n += k;
  }
  for (int** p : {&s.off, &s.rowptr, &s.colptr, &s.levptr}) {
    *p = n;
    n += k + 1;
  }
  for (int** p : {&s.inc, &s.nbr, &s.tgt}) {
    *p = n;
    n += 2LL * e;
  }
  for (int** p : {&s.rowk, &s.rowb, &s.brow}) {
    *p = n;
    n += nb;
  }
  return s;
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

// a[0..n) = its exclusive prefix sum, a[n] = the total; every thread
__device__ void block_exclusive(int* a, int n, int* s_warp) {
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const int x = c < n ? a[c] : 0;
    int total;
    const int before = block_scan(x, s_warp, &total);
    if (c < n) a[c] = base + before;
    base += total;
  }
  if (threadIdx.x == 0) a[n] = base;
  __syncthreads();
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
__device__ __forceinline__ void edge_blocks(const float* ti, const float* tj, const float* meas,
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


// ------------------------------------------------------------ the order
// The per-vertex arrays the order's BFS and the tree walk hit most, in
// shared memory where kHotArrays of them fit, else in the scratch.
struct Order {
  int* pv;           // = perm: the vertices of each part, ascending
  int* tmp;
  int* where;        // hot
  int* lev;          // hot
  int* q;            // hot
  int* seg;
  const int* off;
  const int* nbr;
};

// A BFS inside the part [lo, hi) from `root`: lev gets the levels of the
// vertices it reaches (-1 elsewhere in the part), q[lo..) their BFS order,
// *ecc the last level and *last_min the smallest vertex in it. Returns the
// number reached.
__device__ int part_bfs(const Order& a, int lo, int hi, int root, int* ecc, int* last_min) {
  for (int p = lo; p < hi; ++p) a.lev[a.pv[p]] = -1;
  a.lev[root] = 0;
  a.q[lo] = root;
  int head = lo, tail = lo + 1;
  while (head < tail) {
    const int v = a.q[head++];
    const int lv = a.lev[v] + 1;
    for (int p = a.off[v]; p < a.off[v + 1]; ++p) {
      const int n = a.nbr[p];
      if (n < 0) continue;
      const int w = a.where[n];
      if (w < lo || w >= hi || a.lev[n] >= 0) continue;
      a.lev[n] = lv;
      a.q[tail++] = n;
    }
  }
  const int e = a.lev[a.q[tail - 1]];
  int mn = a.q[tail - 1];
  for (int p = tail - 2; p >= lo && a.lev[a.q[p]] == e; --p) mn = min(mn, a.q[p]);
  *ecc = e;
  *last_min = mn;
  return tail - lo;
}

// Moves the part's vertices to tmp at `dst(v)`'s positions, then back.
template <class Dst>
__device__ void part_scatter(const Order& a, int lo, int hi, Dst dst) {
  for (int p = lo; p < hi; ++p) a.tmp[dst(a.pv[p])] = a.pv[p];
  for (int p = lo; p < hi; ++p) {
    a.pv[p] = a.tmp[p];
    a.where[a.pv[p]] = p;
  }
}

// One part's step of the nested dissection (one thread): its sub-parts are
// registered in seg, its separator placed.
__device__ void nd_split(const Order& a, int lo, int hi) {
  if (hi - lo == 1) return;
  int ecc, cand;
  if (part_bfs(a, lo, hi, a.pv[lo], &ecc, &cand) < hi - lo) {
    // components: label each (lev) in the order of its smallest vertex,
    // seg[lo + c] the start of component c; then the stable partition
    for (int p = lo; p < hi; ++p) a.lev[a.pv[p]] = -1;
    int nc = 0, tail = lo;
    for (int p = lo; p < hi; ++p) {
      const int r = a.pv[p];
      if (a.lev[r] >= 0) continue;
      a.seg[lo + nc] = tail;
      int head = tail;
      a.lev[r] = nc;
      a.q[tail++] = r;
      while (head < tail) {
        const int v = a.q[head++];
        for (int t = a.off[v]; t < a.off[v + 1]; ++t) {
          const int n = a.nbr[t];
          if (n < 0) continue;
          const int w = a.where[n];
          if (w < lo || w >= hi || a.lev[n] >= 0) continue;
          a.lev[n] = nc;
          a.q[tail++] = n;
        }
      }
      ++nc;
    }
    for (int c = 0; c < nc; ++c) {  // the cursors to q, the marks cleared
      a.q[lo + c] = a.seg[lo + c];
      a.seg[lo + c] = 0;
    }
    part_scatter(a, lo, hi, [&](int v) { return a.q[lo + a.lev[v]]++; });
    for (int c = 0, start = lo; c < nc; ++c) {  // q[lo + c] is now component c's end
      const int end = a.q[lo + c];
      a.seg[start] = end;
      start = end;
    }
    return;
  }
  for (int s = 0; s < kSweeps; ++s) {  // a pseudo-peripheral root
    int e2, c2;
    part_bfs(a, lo, hi, cand, &e2, &c2);
    const bool grew = e2 > ecc;
    ecc = e2;
    cand = c2;
    if (!grew) break;
  }
  const int m = ecc / 2;
  int na = 0, nb = 0;
  for (int p = lo; p < hi; ++p) {
    const int l = a.lev[a.pv[p]];
    na += l < m;
    nb += l > m;
  }
  int ia = lo, ib = lo + na, is = lo + na + nb;
  part_scatter(a, lo, hi, [&](int v) {
    const int l = a.lev[v];
    return l < m ? ia++ : (l > m ? ib++ : is++);
  });
  if (na > 0) a.seg[lo] = lo + na;
  if (nb > 0) a.seg[lo + na] = lo + na + nb;
}

// ------------------------------------------------------- the factorization
// A team's 6x6 Cholesky, a row a lane (r; `base` the team's first lane):
// s, row r of the matrix (its lower part), becomes row r of the lower
// factor, zeros above, and *inv 1 / L_rr. Right-looking: column c's pivot
// from lane c, rsqrtf for 1 / L_cc (L_cc = d / sqrt(d)), the rows below
// scaled, the columns to its right updated with L_c2c from lane c2. False
// on a pivot that is not > 0 (every lane sees every pivot).
__device__ __forceinline__ bool team_chol(float s[6], float* inv, int r, int base, unsigned mask) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float d = __shfl_sync(mask, s[c], base + c);
    const float ic = rsqrtf(d);
    ok = ok && d > 0.f;
    if (r == c) *inv = ic;
    s[c] = r == c ? d * ic : (r > c ? s[c] * ic : 0.f);
#pragma unroll
    for (int c2 = c + 1; c2 < 6; ++c2) {
      const float l2 = __shfl_sync(mask, s[c], base + c2);
      if (r >= c2) s[c2] -= s[c] * l2;
    }
  }
  return ok;
}

// the 6 floats at p (8-byte aligned: a row of a block, a 6-vector of b)
__device__ __forceinline__ void load6(const float* p, float x[6]) {
  const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 v = q[k];
    x[2 * k] = v.x;
    x[2 * k + 1] = v.y;
  }
}

// the 36 floats of a block of L (16-byte aligned)
__device__ __forceinline__ void load36(const float* p, float x[36]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float4 v = q[k];
    x[4 * k] = v.x;
    x[4 * k + 1] = v.y;
    x[4 * k + 2] = v.z;
    x[4 * k + 3] = v.w;
  }
}

// s[c] -= (row r of a) . (row c of b), c = 0..5
__device__ __forceinline__ void sub_rows(float s[6], const float* ar, const float* b) {
  float x[6], bb[36];
  load6(ar, x);
  load36(b, bb);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) acc += x[q] * bb[6 * c + q];
    s[c] = s[c] - acc;
  }
}

struct Numeric {
  float* L;         // the blocks of L
  float* rhs;
  float* dj;
  float* adiag;
  float* pinv;      // 1 / L_jj's diagonal, by column
  const int* rowptr;
  const int* rowk;
  const int* rowb;
  const int* colptr;
  const int* brow;
};

// One team's share of column j (lane r = a block row): the column's
// equilibrated, damped diagonal less sum_k L_jk L_jk^T over its row list,
// factored across the team (every team of the column computes the same
// factor, so none waits for another); the team of part 0 also writes L_jj,
// its inverse pivots and y_j = L_jj^-1 (rhs_j - sum_k L_jk y_k) (the
// forward substitution, from the same loads); then the blocks below the
// diagonal part, part + parts, ..., each dj_i A_ij dj_j less
// sum_k L_ik L_jk^T over the common entries of rows i and j (a merge, k
// ascending), solved against L_jj^T (t: L_jj, then its inverse pivots).
// Returns false on a failed pivot.
__device__ __forceinline__ bool factor_column(const Numeric n, int j, int part, int parts, float damping,
                              float* t, int r, int base, unsigned mask, StageClock& clk) {
  const float* djj = n.dj + 6 * j;
  float s[6], u = n.rhs[6 * j + r];
  {
    float a[6], d[6];
    load6(n.adiag + 36 * j + 6 * r, a);
    load6(djj, d);
    const float dr = djj[r];
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c] = (a[c] * dr) * d[c] + (c == r ? damping : 0.f);
    for (int p = n.rowptr[j]; p < n.rowptr[j + 1]; ++p) {
      const float* l = n.L + 36LL * n.rowb[p];
      sub_rows(s, l + 6 * r, l);
      float lr[6], yk[6];
      load6(l + 6 * r, lr);
      load6(n.rhs + 6 * n.rowk[p], yk);
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) dot += lr[q] * yk[q];
      u -= dot;
    }
  }
  clk.mark(PG_F_DIAG);
  float inv;
  const bool ok = team_chol(s, &inv, r, base, mask);
#pragma unroll
  for (int c = 0; c < 6; ++c) t[6 * r + c] = s[c];
  t[36 + r] = inv;
  if (part == 0) {  // L_jj and y_j, a row a lane
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      if (r == q) v = u * inv;
      const float vq = __shfl_sync(mask, v, base + q);
      if (r > q) u -= s[q] * vq;
    }
    n.rhs[6 * j + r] = v;
    n.pinv[6 * j + r] = inv;
    float* out = n.L + 36LL * n.colptr[j] + 6 * r;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c] = s[c];
  }
  __syncwarp(mask);
  clk.mark(PG_F_CHOL);
  for (int b = n.colptr[j] + 1 + part; b < n.colptr[j + 1]; b += parts) {
    const int i = n.brow[b];
    float* out = n.L + 36LL * b + 6 * r;
    const float dr = n.dj[6 * i + r];
    float a[6], d[6];
    load6(out, a);
    load6(djj, d);
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c] = (a[c] * dr) * d[c];
    int pi = n.rowptr[i], pj = n.rowptr[j];
    const int ei = n.rowptr[i + 1], ej = n.rowptr[j + 1];
    while (pi < ei && pj < ej) {  // the common k of rows i and j, ascending
      const int ki = n.rowk[pi], kj = n.rowk[pj];
      if (ki == kj) sub_rows(s, n.L + 36LL * n.rowb[pi] + 6 * r, n.L + 36LL * n.rowb[pj]);
      pi += ki <= kj;
      pj += kj <= ki;
    }
    float x[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {  // x L_jj^T = s
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < c; ++m) dot += x[m] * t[6 * c + m];
      x[c] = (s[c] - dot) * t[36 + c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c] = x[c];
  }
  __syncwarp(mask);  // t is read by every lane before the team's next column writes it
  clk.mark(PG_F_PANEL);
  return ok;
}

// x_j = L_jj^-T (y_j - sum_i L_ij^T x_i) over column j's blocks below the
// diagonal, the blocks lane, lane + lanes, ... summed here; `lanes` > 1: a
// warp's sums reduced by a fixed shuffle tree, lane 0 solves.
__device__ __forceinline__ void back_column(const Numeric n, int j, int lane, int lanes) {
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int first = n.colptr[j];
  for (int b = first + 1 + lane; b < n.colptr[j + 1]; b += lanes) {
    float l[36], x[6];
    load36(n.L + 36LL * b, l);
    load6(n.rhs + 6 * n.brow[b], x);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) dot += l[6 * r + q] * x[r];
      acc[q] += dot;
    }
  }
  if (lanes > 1)
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) acc[q] += __shfl_xor_sync(kFullMask, acc[q], d);
  if (lane == 0) {
    const float* l = n.L + 36LL * first;
    float* y = n.rhs + 6 * j;
    const float* inv = n.pinv + 6 * j;
    float v[6];
#pragma unroll
    for (int q = 5; q >= 0; --q) {
      float dot = 0.f;
#pragma unroll
      for (int m = q + 1; m < 6; ++m) dot += l[6 * m + q] * v[m];
      v[q] = ((y[q] - acc[q]) - dot) * inv[q];
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) y[q] = v[q];
  }
}

// The back substitution over the columns of a level: a warp a column where
// they are no more than the warps, else a thread a column.
__device__ __forceinline__ void back_level(const Numeric n, const int* cols, int count) {
  const int tid = threadIdx.x;
  if (count <= kWarps) {
    if ((tid >> 5) < count) back_column(n, cols[tid >> 5], tid & 31, 32);
  } else {
    for (int c = tid; c < count; c += kThreads) back_column(n, cols[c], 0, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
pose_graph_gn_kernel(Graph g, Scratch s, float* poses, float* clocks, int iterations,
                     float damping) {
  extern __shared__ float4 s_dyn[];
  __shared__ int s_warp[kWarps];
  __shared__ float s_team[kTeams][42];  // a diagonal factor, then its inverse pivots
  __shared__ int s_height;
  const int tid = threadIdx.x;
  // a thread's rank where each takes its own irregular work (a part, a row,
  // a column): consecutive ranks on different warps, so their loops do not
  // serialize in one warp
  const int slot = (tid & 31) * kWarps + (tid >> 5);
  StageClock clk;

  for (int q = tid; q < g.k * 16; q += kThreads) poses[q] = g.poses[q];

  // 0. compact indices, the incident lists in edge order, the other ends
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
  if (nf == 0 || iterations <= 0) {
    clk.write(clocks);
    return;
  }
  for (int c = tid; c < nf; c += kThreads) s.off[c] = 0;
  __syncthreads();
  for (int q = tid; q < 2 * g.e; q += kThreads) {
    int vi, vj;
    if (!edge_used(g, s.cidx, q >> 1, vi, vj)) continue;
    const int c = s.cidx[(q & 1) ? vj : vi];
    if (c >= 0) atomicAdd(&s.off[c], 1);
  }
  __syncthreads();
  block_exclusive(s.off, nf, s_warp);
  for (int c = tid; c < nf; c += kThreads) s.cur[c] = s.off[c];
  __syncthreads();
  for (int q = tid; q < 2 * g.e; q += kThreads) {
    int vi, vj;
    if (!edge_used(g, s.cidx, q >> 1, vi, vj)) continue;
    const int c = s.cidx[(q & 1) ? vj : vi];
    if (c >= 0) s.inc[atomicAdd(&s.cur[c], 1)] = q;
  }
  __syncthreads();
  for (int c = tid; c < nf; c += kThreads) {  // insertion sort: edge order, then i before j
    for (int p = s.off[c] + 1; p < s.off[c + 1]; ++p) {
      const int x = s.inc[p];
      int r = p - 1;
      for (; r >= s.off[c] && s.inc[r] > x; --r) s.inc[r + 1] = s.inc[r];
      s.inc[r + 1] = x;
    }
    for (int p = s.off[c]; p < s.off[c + 1]; ++p) {
      const int e = s.inc[p] >> 1;
      s.nbr[p] = s.cidx[(s.inc[p] & 1) ? g.ei[e] : g.ej[e]];
    }
  }

  // 1. the order: nested dissection by rounds, a thread a part
  //    (the hot arrays, then the adjacency: each vertex's list offsets and
  //    the other ends)
  __syncthreads();
  const int hn = nf + 1, entries = s.off[nf];
  const bool hot_fits =
      (kHotArrays * hn + hn + entries) * static_cast<int>(sizeof(int)) <= kDynBytes;
  int* hot = reinterpret_cast<int*>(s_dyn);
  int* adj = hot + kHotArrays * hn;
  if (hot_fits) {
    for (int c = tid; c <= nf; c += kThreads) adj[c] = s.off[c];
    for (int p = tid; p < entries; p += kThreads) adj[hn + p] = s.nbr[p];
  }
  const int* off = hot_fits ? adj : s.off;
  const int* nbr = hot_fits ? adj + hn : s.nbr;
  const Order ord{s.perm, s.tmp, hot_fits ? hot : s.where, hot_fits ? hot + hn : s.lev,
                  hot_fits ? hot + 2 * hn : s.q, s.seg, off, nbr};
  int* parent = hot_fits ? hot + 3 * hn : s.parent;
  int* flag = hot_fits ? hot + 4 * hn : s.flag;
  int* lvl = hot_fits ? hot + 5 * hn : s.lvl;
  int* cnt = hot_fits ? hot + 6 * hn : s.cur;
  for (int p = tid; p < nf; p += kThreads) {
    ord.pv[p] = p;
    ord.where[p] = p;
    ord.seg[p] = p == 0 ? nf : 0;
  }
  for (;;) {
    __syncthreads();
    int count = 0;
    for (int p0 = 0; p0 < nf; p0 += kThreads) {
      const int p = p0 + tid;
      const int f = (p < nf && ord.seg[p] > 0) ? 1 : 0;
      int total;
      const int before = block_scan(f, s_warp, &total);
      if (f) s.parts[count + before] = p;
      count += total;
    }
    if (count == 0) break;
    __syncthreads();
    for (int t = slot; t < count; t += kThreads) {
      const int lo = s.parts[t], hi = ord.seg[lo];
      ord.seg[lo] = 0;
      nd_split(ord, lo, hi);
    }
  }

  clk.mark(PG_ORDER);

  // 2. the elimination tree, by Liu's row-subtree walk (one thread): the
  //    parents, each row's count and each column's below the diagonal
  const int* where = ord.where;
  if (tid == 0) {
    for (int i = 0; i < nf; ++i) {
      flag[i] = i;
      parent[i] = -1;
      cnt[i] = 0;
    }
    for (int i = 0; i < nf; ++i) {
      int rc = 0;
      const int c = ord.pv[i];
      for (int p = off[c]; p < off[c + 1]; ++p) {
        const int o = nbr[p];
        if (o < 0) continue;
        for (int j = where[o]; j < i && flag[j] != i; j = parent[j]) {
          flag[j] = i;
          ++rc;
          ++cnt[j];
          if (parent[j] < 0) parent[j] = i;
        }
      }
      s.rowptr[i] = rc;
    }
  }
  __syncthreads();
  for (int j = tid; j < nf; j += kThreads) s.colptr[j] = 1 + cnt[j];
  __syncthreads();
  block_exclusive(s.rowptr, nf, s_warp);
  block_exclusive(s.colptr, nf, s_warp);
  //    each row's list, ascending (a thread a row): the path from each
  //    earlier neighbour up the tree, until a column already listed
  for (int i = slot; i < nf; i += kThreads) {
    const int base = s.rowptr[i], c = ord.pv[i];
    int len = 0;
    for (int p = off[c]; p < off[c + 1]; ++p) {
      const int o = nbr[p];
      if (o < 0) continue;
      for (int j = where[o]; j < i; j = parent[j]) {
        int t = len;
        while (t > 0 && s.rowk[base + t - 1] > j) --t;
        if (t > 0 && s.rowk[base + t - 1] == j) break;
        for (int u = len; u > t; --u) s.rowk[base + u] = s.rowk[base + u - 1];
        s.rowk[base + t] = j;
        ++len;
      }
    }
  }
  __syncthreads();
  //    each column's blocks (a thread a column): the diagonal, then the
  //    ancestors whose row lists hold the column, in order; the levels (one
  //    thread), and the columns by level (a counting sort, ascending in
  //    each level)
  for (int j = slot; j < nf; j += kThreads) {
    int b = s.colptr[j];
    const int end = s.colptr[j + 1];
    s.brow[b] = j;
    for (int i = parent[j]; ++b < end && i >= 0; i = parent[i]) {
      int lo = s.rowptr[i], hi = s.rowptr[i + 1];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s.rowk[mid] < j)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < s.rowptr[i + 1] && s.rowk[lo] == j) {
        s.rowb[lo] = b;
        s.brow[b] = i;
      } else {
        --b;
      }
    }
  }
  if (tid == 0) {
    int height = 0;
    for (int j = 0; j < nf; ++j) lvl[j] = 0;
    for (int j = 0; j < nf; ++j) {
      if (parent[j] >= 0) lvl[parent[j]] = max(lvl[parent[j]], lvl[j] + 1);
      height = max(height, lvl[j] + 1);
    }
    for (int l = 0; l <= height; ++l) cnt[l] = 0;
    for (int j = 0; j < nf; ++j) ++cnt[lvl[j] + 1];
    for (int l = 0; l < height; ++l) cnt[l + 1] += cnt[l];
    for (int l = 0; l <= height; ++l) s.levptr[l] = cnt[l];
    for (int j = 0; j < nf; ++j) s.levcol[cnt[lvl[j]]++] = j;
    s_height = height;
  }
  __syncthreads();
  const int height = s_height;
  //    each incident entry's block of L, where its vertex is the later
  for (int c = slot; c < nf; c += kThreads) {
    const int i = where[c];
    for (int p = off[c]; p < off[c + 1]; ++p) {
      const int o = nbr[p];
      int b = -1;
      if (o >= 0 && where[o] < i)
        for (int t = s.rowptr[i]; t < s.rowptr[i + 1]; ++t)
          if (s.rowk[t] == where[o]) b = s.rowb[t];
      s.tgt[p] = b;
    }
  }
  __syncthreads();
  const int nblocks = s.colptr[nf];
  if (hot_fits)
    for (int c = tid; c < nf; c += kThreads) s.where[c] = where[c];
  __syncthreads();  // the hot arrays are dead: the numeric stages take the shared memory
  //    the pattern the numeric stages walk, in shared memory where it fits
  //    (rowptr, colptr, levptr, levcol, rowk, rowb, brow), then L, b, dj and
  //    A's diagonal where they fit beside it
  const int nrow = nblocks - nf;
  const int* src[] = {s.rowptr, s.colptr, s.levptr, s.levcol, s.rowk, s.rowb, s.brow};
  const int len[] = {nf + 1, nf + 1, nf + 1, nf, nrow, nrow, nblocks};
  const int words = 4 * nf + 3 + 2 * nrow + nblocks;
  const bool idx_fits = words * static_cast<int>(sizeof(int)) <= kDynBytes;
  const int* pat[7];
  int* di = reinterpret_cast<int*>(s_dyn);
  for (int a = 0; a < 7; di += len[a++]) {
    pat[a] = idx_fits ? di : src[a];
    if (idx_fits)
      for (int q = tid; q < len[a]; q += kThreads) di[q] = src[a][q];
  }
  const int skip = idx_fits ? (words + 3) / 4 * 4 : 0;  // L 16-byte aligned
  const long long fwords = skip + 36LL * nblocks + 54LL * nf;
  const bool l_fits = fwords * static_cast<int>(sizeof(float)) <= kDynBytes;
  float* dyn = reinterpret_cast<float*>(s_dyn) + skip;
  const Numeric num{l_fits ? dyn : s.blocks,
                    l_fits ? dyn + 36LL * nblocks : s.rhs,
                    l_fits ? dyn + 36LL * nblocks + 6 * nf : s.dj,
                    l_fits ? dyn + 36LL * nblocks + 12 * nf : s.adiag,
                    l_fits ? dyn + 36LL * nblocks + 48 * nf : s.pinv,
                    pat[0], pat[4], pat[5], pat[1], pat[6]};
  const int* levptr = pat[2];
  const int* levcol = pat[3];
  __syncthreads();
  const int lane = tid & 31, team = (tid >> 5) * kTeamsPerWarp + lane / kTeamLanes;
  const int row = lane % kTeamLanes;
  const bool in_team = lane < kTeamsPerWarp * kTeamLanes;
  const unsigned team_mask = ((1u << kTeamLanes) - 1u) << (lane - row);
  clk.mark(PG_TREE);

  for (int it = 0; it < iterations; ++it) {
    // 3. the edges; L's blocks zeroed
    for (int e = tid; e < g.e; e += kThreads) {
      int vi, vj;
      if (edge_used(g, s.cidx, e, vi, vj))
        edge_blocks(poses + 16 * vi, poses + 16 * vj, g.meas + 16 * e, g.info + 6 * e,
                    s.edges + static_cast<long long>(kEdgeFloats) * e);
    }
    for (long long q = tid; q < 36LL * nblocks; q += kThreads) num.L[q] = 0.f;
    __syncthreads();
    clk.mark(PG_EDGES);
    // 4. a vertex's blocks and b, in its list's order, at its position
    for (int c = tid; c < nf; c += kThreads) {
      float diag[36], bv[6];
#pragma unroll
      for (int k = 0; k < 36; ++k) diag[k] = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) bv[r] = 0.f;
      for (int p = s.off[c]; p < s.off[c + 1]; ++p) {
        const int end = s.inc[p] & 1, o = s.nbr[p], b = s.tgt[p];
        const float* src = s.edges + static_cast<long long>(kEdgeFloats) * (s.inc[p] >> 1);
        float hg[kEdgeFloats];  // the whole edge first: no load waits on a store below
#pragma unroll
        for (int k = 0; k < kEdgeFloats; ++k) hg[k] = src[k];
#pragma unroll
        for (int k = 0; k < 36; ++k) diag[k] += hg[k];
#pragma unroll
        for (int r = 0; r < 6; ++r) bv[r] += end ? hg[36 + r] : -hg[36 + r];
        if (o == c) {  // both ends here: the two cross blocks land on the diagonal
#pragma unroll
          for (int k = 0; k < 36; ++k) diag[k] += -hg[k];
        } else if (b >= 0) {
          float* blk = num.L + 36LL * b;
          float acc[36];
#pragma unroll
          for (int k = 0; k < 36; ++k) acc[k] = blk[k];
#pragma unroll
          for (int k = 0; k < 36; ++k) blk[k] = acc[k] + (-hg[k]);
        }
      }
      const int i = s.where[c];
      float* d = num.adiag + 36 * i;
#pragma unroll
      for (int k = 0; k < 36; ++k) d[k] = diag[k];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const float dj = 1.f / sqrtf(clamp_min(diag[7 * r], 1e-12f));
        num.dj[6 * i + r] = dj;
        num.rhs[6 * i + r] = -(bv[r] * dj);
      }
    }
    __syncthreads();
    clk.mark(PG_ASSEMBLY);
    // 5. the factorization and the forward substitution, a level at a
    //    time: a team a column, or `parts` teams a column where the level
    //    has fewer columns than teams; a failed pivot anywhere ends it at
    //    the level's barrier, where every thread learns of it
    bool failed = false;
    for (int l = 0; l < height && !failed; ++l) {
      const int c0 = levptr[l], cols = levptr[l + 1] - c0;
      bool ok = true;
      const int parts = max(1, kTeams / cols);
      if (in_team)
        for (int t = team; t < cols * parts; t += kTeams)
          ok = factor_column(num, levcol[c0 + t / parts], t % parts, parts, damping,
                             s_team[team], row, lane - row, team_mask, clk) && ok;
      failed = __syncthreads_or(!ok) != 0;
      clk.mark(PG_F_WAIT);
    }
    clk.mark(PG_FACTOR);
    // 6. the back substitution, a level at a time from the root
    if (!failed)
      for (int l = height - 1; l >= 0; --l) {
        back_level(num, levcol + levptr[l], levptr[l + 1] - levptr[l]);
        __syncthreads();
      }
    clk.mark(PG_SUBSTITUTE);
    // 7. pose = se3_exp(dx) @ pose
    for (int c = tid; c < nf; c += kThreads) {
      const int i = s.where[c];
      float dx[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) dx[r] = failed ? NAN : num.dj[6 * i + r] * num.rhs[6 * i + r];
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
    clk.mark(PG_UPDATE);
  }
  clk.write(clocks);
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
#ifdef FLS_STAGE_CLOCKS
  const long long clock_floats = kStageClocks;
#else
  const long long clock_floats = 0;
#endif
  if (fscratch_size < lay.floats + clock_floats || iscratch_size < lay.ints)
    return static_cast<int>(cudaErrorInvalidValue);
  // on every launch: the opt-in holds for the current device's context only
  const cudaError_t attr = cudaFuncSetAttribute(
      pose_graph_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Graph g{poses, pose_mask, edge_i, edge_j, edge_meas, edge_info, edge_mask, k, e};
  pose_graph_gn_kernel<<<1, kThreads, kDynBytes, static_cast<cudaStream_t>(stream)>>>(
      g, carve(fscratch, iscratch, k, e), out, fscratch + lay.floats, iterations, damping);
  return static_cast<int>(cudaGetLastError());
}
