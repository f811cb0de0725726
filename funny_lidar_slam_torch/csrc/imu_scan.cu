// The IMU recurrences of the step, one thread block per call:
//
//   preintegrate_kernel  Forster preintegration over a padded IMU segment.
//                        Replaces the `lax.scan` of
//                        funny_lidar_slam_tpu/imu/preintegration.py
//                        (`preintegrate`), plain version
//                        imu/preintegration.py::preintegrate_plain.
//   eskf_predict_kernel  ESKF mean and covariance propagation over the same
//                        kind of segment. Replaces the `lax.scan` of
//                        funny_lidar_slam_tpu/fusion/eskf.py (`predict`),
//                        plain version fusion/eskf.py::predict_plain.
//
// Bound: both are serial recurrences over the segment's slots with a few
// thousand operations each (a 9x9 or 15x15 sandwich product) on a few KB
// of input, so neither bytes nor operations bound them on this card: the
// chain of dependent steps does.
//
// preintegrate_kernel takes the per-slot work off that chain. Of a slot's
// update only d_r (the prefix product of the r_step rotations), the bias
// Jacobians and the covariance are carried; r_step = Exp(w dt), Jr(w dt),
// the mean accel, the noise / dt and the validity are per slot. So the
// kernel stages up to kChunk slots at a time in four parts, a block
// barrier between parts (four a chunk, none a slot):
//   1. two threads a slot, all at once: validity, dt, the midpoint gyro and
//      accel, r_step, noise / max(dt, 1e-9) on one, Jr on the other;
//   2. the valid slots as two ballots; then serial, each chain one thread
//      in its own warp, the next slot's inputs loaded while the current one
//      is taken: d_r (27 FMAs a slot) with d_v, d_p and the total dt beside
//      it; dr_dbg, one column a lane (the column recurrences are
//      independent). Each valid slot's d_r and dr_dbg before the update go
//      to shared memory;
//   3. one thread a (valid slot, row): A = [[R^T,0,0],[X,I,0],[Y,dt I,I]]
//      by rows (X, Y from d_r hat(a)), d_r hat(a) dr_dbg, and
//      B (Sigma / dt) B^T;
//   4. serial over the valid slots: the covariance A cov A^T + B Sigma B^T
//      in one warp, lane 3i + b holding row i, columns 3b..3b+2, the rows
//      and columns the products need broadcast by shuffles, so no barrier
//      at all; the four other bias Jacobians in another warp, one entry a
//      lane.
// Every entry keeps the plain version's order of operations: the products
// with A skip its structural zeros and ones, which leaves each sum's
// rounding as the dense product's. A slot that is not valid (masked, or a
// dt that is not positive) is left out of every chain, which is exact: the
// plain version's torch.where leaves the state untouched there. A build
// with -DFLS_STAGE_CLOCKS (stage_clock.cuh) writes the cycles of each part
// (C_* below) after the output.
//
// eskf_predict_kernel takes the same treatment. Of a slot's update only r
// (with v and p beside it) and the covariance are carried; validity, dt,
// the midpoint accel less its bias, r_step = Exp(w dt), hat(acc) dt and Q's
// diagonal (its variances times dt) are per slot. So per chunk of kChunk
// slots, four parts and a block barrier between parts (none a slot):
//   1. one thread a slot, all at once: validity, dt, acc, r_step, hat(acc)
//      dt;
//   2. the valid slots as two ballots; then serial in one thread, the next
//      slot's inputs loaded while the current one is taken: r (27 FMAs a
//      slot), v and p; each valid slot's r before its update goes to shared
//      memory;
//   3. one thread a (valid slot, row): F's blocks at that r, -r hat(acc) dt
//      and -r dt, beside r_step;
//   4. serial over the valid slots: cov <- F cov F^T + Q dt in one warp, lane
//      5 bi + bj holding the 3x3 block (bi, bj) of the 15x15 matrix in
//      registers; the two block products (F cov, then its F^T) read the
//      blocks they need from other lanes by shuffles, so no barrier at all.
// The products skip F's structural zeros and ones as preintegrate_kernel's
// do (the same one form on every lane, the zero blocks as zero factors),
// each sum an explicit fmaf chain in the dense product's order. Where a
// compiler contracts the dense product's multiply-adds otherwise, an entry
// may round apart from it: the result agrees with the dense product and the
// plain version within float32 rounding, not bit for bit (PERF.md §6 has the
// gap measured on the card). An invalid slot is
// left out of every chain, which is exact: the plain version's torch.where
// leaves the state untouched there. The stage clocks as preintegrate's.
//
// Layouts (float32, packed by ops/recurrences.py):
//   preintegrate input:  bg[3] ba[3] gyro_var[3] acc_var[3] integ_var[3] |
//                        t[S] gyro[S,3] accel[S,3] mask[S] | init state
//                        (PS_SIZE floats, only when has_init)
//   preintegrate output: the state, PS_* offsets below
//   eskf input:          r[9] v[3] p[3] bg[3] ba[3] cov[225] gyro_var[3]
//                        acc_var[3] gyro_rw_var[3] acc_rw_var[3] |
//                        t[S] gyro[S,3] accel[S,3] mask[S]
//   eskf output:         r[9] v[3] p[3] cov[225]
// Gravity comes by value.

#include <cuda_runtime.h>

#include "so3.cuh"
#include "stage_clock.cuh"

namespace {

// the preintegrated state (PreintState without the biases)
enum {
  PS_DR = 0, PS_DV = 9, PS_DP = 12, PS_COV = 15, PS_DR_DBG = 96, PS_DV_DBG = 105,
  PS_DV_DBA = 114, PS_DP_DBG = 123, PS_DP_DBA = 132, PS_DT = 141, PS_SIZE = 142
};
enum { PH_BG = 0, PH_BA = 3, PH_GVAR = 6, PH_AVAR = 9, PH_IVAR = 12, PH_SIZE = 15 };
enum {
  EI_R = 0, EI_V = 9, EI_P = 12, EI_BG = 15, EI_BA = 18, EI_COV = 21, EI_GVAR = 246,
  EI_AVAR = 249, EI_GRW = 252, EI_ARW = 255, EI_SIZE = 258
};
enum { EO_R = 0, EO_V = 9, EO_P = 12, EO_COV = 15, EO_SIZE = 240 };

constexpr int kPreintThreads = 256;
constexpr int kEskfThreads = 192;  // 3 x kChunk: part 3's (valid slot, row)
constexpr int kChunk = 64;  // slots staged at a time
constexpr unsigned kFull = 0xffffffffu;
// stage clocks of a profiling build (stage_clock.cuh)
enum { C_INIT, C_SLOTS, C_PREFIX, C_BLOCKS, C_SERIAL, C_OUTPUT };

// slot k runs from sample k to k+1 (the plain version's `valid`)
__device__ inline bool slot_valid(const float* t, const float* mask, int k, float* dt) {
  *dt = t[k + 1] - t[k];
  return mask[k] > 0.5f && mask[k + 1] > 0.5f && *dt > 0.f;
}

// row i (0..8) of B [9,6] of a slot: Jr dt, d_r dt, 0.5 d_r dt^2 blocks
__device__ inline void b_row(int i, const float* jrm, const float* dr, float dt, float b[6]) {
  for (int m = 0; m < 6; ++m) b[m] = 0.f;
  for (int m = 0; m < 3; ++m) {
    if (i < 3) b[m] = jrm[3 * i + m] * dt;
    else if (i < 6) b[3 + m] = dr[3 * (i - 3) + m] * dt;
    else b[3 + m] = 0.5f * dr[3 * (i - 6) + m] * dt * dt;
  }
}

// the slots of a chunk (kChunk = 64) that are valid, as two lane masks
struct SlotMasks {
  unsigned lo, hi;
  __device__ int count() const { return __popc(lo) + __popc(hi); }
  // the next valid slot, removed from the masks; -1 when none is left
  __device__ int pop() {
    if (lo) {
      const int k = __ffs(lo) - 1;
      lo &= lo - 1;
      return k;
    }
    if (hi) {
      const int k = __ffs(hi) - 1;
      hi &= hi - 1;
      return 32 + k;
    }
    return -1;
  }
};

__global__ void __launch_bounds__(kPreintThreads)
preintegrate_kernel(const float* __restrict__ in, float* __restrict__ out, int slots,
                    int has_init) {
  // part 1, by slot of the chunk
  __shared__ float s_dt[kChunk], s_rs[kChunk][9], s_jr[kChunk][9], s_acc[kChunk][3];
  __shared__ float s_noise[kChunk][6];
  __shared__ int s_valid[kChunk];
  // parts 2-3, by valid slot of the chunk, in order: the slot, d_r and
  // dr_dbg before it, A by rows (the three entries on rows 0-2 of cov, the
  // entry on row i-3, the entry on row i), d_r hat(a) dr_dbg, B Sigma B^T
  __shared__ int v_slot[kChunk];
  __shared__ float v_dr[kChunk][9], v_drdbg[kChunk][9], v_a[kChunk][9][5];
  __shared__ float v_m[kChunk][9], v_q[kChunk][81];
  StageClock clk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* hdr = in;
  const float* t = in + PH_SIZE;
  const float* gyro = t + slots;
  const float* accel = gyro + 3 * slots;
  const float* mask = accel + 3 * slots;
  const float* init = mask + slots;  // PS_SIZE floats when has_init
  // warp 0 lane 3i + b (i < 9, b < 3): row i, columns 3b..3b+2 of cov
  const int ci = min(lane / 3, 8), cb = lane < 27 ? lane % 3 : 2;

  // the carried state, each part in the registers of the lanes that chain it
  float dr[9], dv[3], dp[3], dt_sum = 0.f;  // warp 0 lane 0
  float drdbg_col[3];                        // warp 1 lanes 0-2: column `lane`
  float cov[3];                              // warp 0 lanes 0-26: C[ci][3 cb + 0..2]
  float jv = 0.f, jp = 0.f;                  // warp 1 lanes 0-17: dv_dbg, dp_dbg
                                             // entry lane, or dv_dba, dp_dba lane - 9
  for (int k = 0; k < 9; ++k) dr[k] = has_init ? init[PS_DR + k] : (k % 4 == 0 ? 1.f : 0.f);
  for (int c = 0; c < 3; ++c) {
    dv[c] = has_init ? init[PS_DV + c] : 0.f;
    dp[c] = has_init ? init[PS_DP + c] : 0.f;
    drdbg_col[c] = has_init && lane < 3 ? init[PS_DR_DBG + 3 * c + lane] : 0.f;
    cov[c] = has_init ? init[PS_COV + 9 * ci + 3 * cb + c] : 0.f;
  }
  if (has_init) dt_sum = init[PS_DT];
  if (has_init && lane < 18) {
    const int e = lane % 9;
    jv = init[(lane < 9 ? PS_DV_DBG : PS_DV_DBA) + e];
    jp = init[(lane < 9 ? PS_DP_DBG : PS_DP_DBA) + e];
  }
  clk.mark(C_INIT);

  for (int c0 = 0; c0 + 1 < slots; c0 += kChunk) {
    const int n = min(kChunk, slots - 1 - c0);
    // 1. the per-slot values, two threads a slot (warps 0-1: validity,
    // accel, r_step, noise; warps 2-3: Jr)
    if (tid < 2 * kChunk) {
      const int sl = tid % kChunk, k = c0 + sl;
      float dt = 0.f;
      const bool ok = sl < n && slot_valid(t, mask, k, &dt);
      if (tid < kChunk) {
        s_valid[sl] = ok;
        s_dt[sl] = dt;
      }
      if (ok) {
        float phi[3];
        for (int c = 0; c < 3; ++c)
          phi[c] = (0.5f * (gyro[3 * k + c] + gyro[3 * k + 3 + c]) - hdr[PH_BG + c]) * dt;
        if (tid < kChunk) {
          for (int c = 0; c < 3; ++c)
            s_acc[sl][c] = 0.5f * (accel[3 * k + c] + accel[3 * k + 3 + c]) - hdr[PH_BA + c];
          so3::exp(phi, s_rs[sl]);
          const float safe_dt = fmaxf(dt, 1e-9f);
          for (int c = 0; c < 3; ++c) {
            s_noise[sl][c] = hdr[PH_GVAR + c] / safe_dt;
            s_noise[sl][3 + c] = hdr[PH_AVAR + c] / safe_dt;
          }
        } else {
          so3::jr(phi, s_jr[sl]);
        }
      }
    }
    __syncthreads();
    clk.mark(C_SLOTS);
    SlotMasks valid = {__ballot_sync(kFull, s_valid[lane]),
                       __ballot_sync(kFull, s_valid[32 + lane])};
    const int nv = valid.count();

    // 2. the serial chains over the valid slots, the next slot's inputs
    // loaded while the current one is taken: d_r with d_v, d_p and dt (warp
    // 0 lane 0) and dr_dbg by columns (warp 1 lanes 0-2)
    if (warp == 0) {
      if (s_valid[lane]) v_slot[__popc(valid.lo & ((1u << lane) - 1))] = lane;
      if (s_valid[32 + lane])
        v_slot[__popc(valid.lo) + __popc(valid.hi & ((1u << lane) - 1))] = 32 + lane;
    }
    if (tid == 0) {
      SlotMasks left = valid;
      int k = left.pop();
      float rs[9], acc[3], dt = 0.f;
      if (k >= 0) {
        for (int e = 0; e < 9; ++e) rs[e] = s_rs[k][e];
        for (int c = 0; c < 3; ++c) acc[c] = s_acc[k][c];
        dt = s_dt[k];
      }
      for (int v = 0; v < nv; ++v) {
        const int kn = left.pop();
        float rs_n[9], acc_n[3], dt_n = 0.f;
        if (kn >= 0) {
          for (int e = 0; e < 9; ++e) rs_n[e] = s_rs[kn][e];
          for (int c = 0; c < 3; ++c) acc_n[c] = s_acc[kn][c];
          dt_n = s_dt[kn];
        }
        float dracc[3], nr[9];
        for (int e = 0; e < 9; ++e) v_dr[v][e] = dr[e];
        so3::mv(dr, acc, dracc);
        for (int c = 0; c < 3; ++c) {
          const float pv = dp[c] + dv[c] * dt + 0.5f * dracc[c] * dt * dt;
          dv[c] = dv[c] + dracc[c] * dt;
          dp[c] = pv;
        }
        so3::mul(dr, rs, nr);
        for (int e = 0; e < 9; ++e) {
          dr[e] = nr[e];
          rs[e] = rs_n[e];
        }
        for (int c = 0; c < 3; ++c) acc[c] = acc_n[c];
        dt_sum += dt;
        dt = dt_n;
      }
    } else if (warp == 1 && lane < 3) {
      SlotMasks left = valid;
      int k = left.pop();
      float rs[9], jr[3], dt = 0.f;
      if (k >= 0) {
        for (int e = 0; e < 9; ++e) rs[e] = s_rs[k][e];
        for (int i = 0; i < 3; ++i) jr[i] = s_jr[k][3 * i + lane];
        dt = s_dt[k];
      }
      for (int v = 0; v < nv; ++v) {
        const int kn = left.pop();
        float rs_n[9], jr_n[3], dt_n = 0.f;
        if (kn >= 0) {
          for (int e = 0; e < 9; ++e) rs_n[e] = s_rs[kn][e];
          for (int i = 0; i < 3; ++i) jr_n[i] = s_jr[kn][3 * i + lane];
          dt_n = s_dt[kn];
        }
        float nc[3];
        for (int i = 0; i < 3; ++i) {
          v_drdbg[v][3 * i + lane] = drdbg_col[i];
          nc[i] = (rs[i] * drdbg_col[0] + rs[3 + i] * drdbg_col[1] + rs[6 + i] * drdbg_col[2])
                  - jr[i] * dt;
        }
        for (int i = 0; i < 3; ++i) {
          drdbg_col[i] = nc[i];
          jr[i] = jr_n[i];
        }
        for (int e = 0; e < 9; ++e) rs[e] = rs_n[e];
        dt = dt_n;
      }
    }
    __syncthreads();
    clk.mark(C_PREFIX);

    // 3. one thread a (valid slot, row i): A's row i (for i < 3 also rows
    // 3 + i and 6 + i, from d_r hat(a)), the dr_dbg term of the bias
    // Jacobians, and row i of B (Sigma / dt) B^T
    for (int e = tid; e < nv * 9; e += blockDim.x) {
      const int v = e / 9, i = e % 9, k = v_slot[v];
      const float dt = s_dt[k];
      const float* d = v_dr[v];
      if (i < 3) {
        const float* rs = s_rs[k];
        float ah[9];
        so3::hat(s_acc[k], ah);
        const float* g = v_drdbg[v];
        float dra[3];  // row i of d_r hat(a)
        for (int j = 0; j < 3; ++j) {
          dra[j] = d[3 * i] * ah[j] + d[3 * i + 1] * ah[3 + j] + d[3 * i + 2] * ah[6 + j];
          v_a[v][i][j] = rs[3 * j + i];        // A_00 = r_step^T
          v_a[v][3 + i][j] = -dra[j] * dt;     // X = -d_r hat(a) dt
          v_a[v][6 + i][j] = -0.5f * dra[j] * dt * dt;  // Y
        }
        v_a[v][i][3] = 0.f;
        v_a[v][i][4] = 0.f;
        v_a[v][3 + i][3] = 0.f;
        v_a[v][3 + i][4] = 1.f;
        v_a[v][6 + i][3] = dt;
        v_a[v][6 + i][4] = 1.f;
        for (int j = 0; j < 3; ++j)
          v_m[v][3 * i + j] = dra[0] * g[j] + dra[1] * g[3 + j] + dra[2] * g[6 + j];
      }
      float bi[6], bj[6];
      b_row(i, s_jr[k], d, dt, bi);
      for (int j = 0; j < 9; ++j) {
        float q = 0.f;
        if ((i < 3) == (j < 3)) {  // B's two column blocks meet no other row block
          b_row(j, s_jr[k], d, dt, bj);
          for (int m = 0; m < 6; ++m) q += bi[m] * (s_noise[k][m] * bj[m]);
        }
        v_q[v][9 * i + j] = q;
      }
    }
    __syncthreads();
    clk.mark(C_BLOCKS);

    // 4. the covariance (warp 0, lane 3i + b: row i, columns 3b..3b+2) and
    // the bias Jacobians (warp 1), serial over the valid slots,
    // warp-synchronous
    if (warp == 0) {
      const float* ivar = hdr + PH_IVAR;
      for (int v = 0; v < nv; ++v) {
        const float dt = s_dt[v_slot[v]];
        const float* ai = v_a[v][ci];
        float tr[3];  // (A cov)[ci][3 cb + c]
        for (int c = 0; c < 3; ++c) {
          const float r0 = __shfl_sync(kFull, cov[c], cb);
          const float r1 = __shfl_sync(kFull, cov[c], 3 + cb);
          const float r2 = __shfl_sync(kFull, cov[c], 6 + cb);
          const float rb = __shfl_sync(kFull, cov[c], lane >= 9 ? lane - 9 : lane);
          float s = 0.f;
          s += ai[0] * r0;
          s += ai[1] * r1;
          s += ai[2] * r2;
          s += ai[3] * rb;
          s += ai[4] * cov[c];
          tr[c] = s;
        }
        float t0[3], tb[3];  // (A cov)[ci][0..2], (A cov)[ci][3 cb - 3 + c]
        for (int c = 0; c < 3; ++c) {
          t0[c] = __shfl_sync(kFull, tr[c], 3 * ci);
          tb[c] = __shfl_sync(kFull, tr[c], lane >= 1 ? lane - 1 : lane);
        }
        for (int c = 0; c < 3; ++c) {  // (A cov) A^T, row j of A by its blocks
          const int j = 3 * cb + c;
          const float* aj = v_a[v][j];
          float s = 0.f;
          s += t0[0] * aj[0];
          s += t0[1] * aj[1];
          s += t0[2] * aj[2];
          s += tb[c] * aj[3];
          s += tr[c] * aj[4];
          float cn = s + v_q[v][9 * ci + j];
          if (j >= 6 && ci == j) cn += ivar[j - 6] * dt;
          cov[c] = cn;
        }
      }
    } else if (warp == 1 && lane < 18) {
      const int e = lane % 9;
      for (int v = 0; v < nv; ++v) {
        const float dt = s_dt[v_slot[v]];
        const float m = lane < 9 ? v_m[v][e] : v_dr[v][e];
        const float np = jp + jv * dt - 0.5f * m * dt * dt;
        jv = jv - m * dt;
        jp = np;
      }
    }
    __syncthreads();
    clk.mark(C_SERIAL);
  }

  if (tid == 0) {
    for (int e = 0; e < 9; ++e) out[PS_DR + e] = dr[e];
    for (int c = 0; c < 3; ++c) {
      out[PS_DV + c] = dv[c];
      out[PS_DP + c] = dp[c];
    }
    out[PS_DT] = dt_sum;
  }
  if (warp == 0 && lane < 27)
    for (int c = 0; c < 3; ++c) out[PS_COV + 9 * ci + 3 * cb + c] = cov[c];
  if (warp == 1 && lane < 3)
    for (int i = 0; i < 3; ++i) out[PS_DR_DBG + 3 * i + lane] = drdbg_col[i];
  if (warp == 1 && lane < 18) {
    const int e = lane % 9;
    out[(lane < 9 ? PS_DV_DBG : PS_DV_DBA) + e] = jv;
    out[(lane < 9 ? PS_DP_DBG : PS_DP_DBA) + e] = jp;
  }
  clk.mark(C_OUTPUT);
  clk.write(out + PS_SIZE);
}

// one valid slot of eskf_predict_kernel's chunk as the covariance warp reads
// it: r_step, F's blocks -r hat(acc) dt and -r dt at the slot's r, and dt
struct __align__(16) EskfSlot {
  float rs[9], a[9], b[9], dt;
};

__global__ void __launch_bounds__(kEskfThreads)
eskf_predict_kernel(const float* __restrict__ in, float* __restrict__ out, int slots,
                    float gx, float gy, float gz) {
  // part 1, by slot of the chunk
  __shared__ float s_dt[kChunk], s_rs[kChunk][9], s_ah[kChunk][9], s_acc[kChunk][3];
  __shared__ int s_valid[kChunk];
  // parts 2-3, by valid slot of the chunk, in order: the slot, r before it,
  // and what the covariance warp reads
  __shared__ int v_slot[kChunk];
  __shared__ float v_r[kChunk][9];
  __shared__ EskfSlot v_f[kChunk];
  StageClock clk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* t = in + EI_SIZE;
  const float* gyro = t + slots;
  const float* accel = gyro + 3 * slots;
  const float* mask = accel + 3 * slots;
  // warp 0 lane 5 bi + bj (bi, bj < 5): the 3x3 block (bi, bj) of cov, its
  // entry (a, b) in c[3 a + b]; lanes 25-31 shadow block (4, 4)
  const int bi = lane < 25 ? lane / 5 : 4, bj = lane < 25 ? lane % 5 : 4;
  // the lanes whose blocks a lane's products read: step 1 (F cov) reads
  // column block bj's row blocks 3 (bi 0), 0 and 4 (bi 1) or 1 (bi 2);
  // step 2 ((F cov) F^T) row block bi's column blocks 3 (bj 0), 0 and 4
  // (bj 1) or 1 (bj 2); a lane that needs none reads its own
  const int x1 = bi == 0 ? 15 + bj : bi == 1 ? bj : bi == 2 ? 5 + bj : lane;
  const int y1 = bi == 1 ? 20 + bj : lane;
  const int x2 = bj == 0 ? 5 * bi + 3 : bj == 1 ? 5 * bi : bj == 2 ? 5 * bi + 1 : lane;
  const int y2 = bj == 1 ? 5 * bi + 4 : lane;
  // Q's diagonal over dt in the diagonal blocks: gyro, accel, 0, the two
  // random walks
  const int var = bi == 0 ? EI_GVAR : bi == 1 ? EI_AVAR : bi == 3 ? EI_GRW : EI_ARW;
  float qv[3];
  for (int a = 0; a < 3; ++a) qv[a] = bi == bj && bi != 2 ? in[var + a] : 0.f;

  // the carried state, each part in the registers of the lanes that chain it
  float r[9], v[3], p[3];  // warp 0 lane 0
  float c[9];              // warp 0: block (bi, bj) of cov
  for (int k = 0; k < 9; ++k) r[k] = in[EI_R + k];
  for (int k = 0; k < 3; ++k) {
    v[k] = in[EI_V + k];
    p[k] = in[EI_P + k];
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) c[3 * a + b] = in[EI_COV + 15 * (3 * bi + a) + 3 * bj + b];
  clk.mark(C_INIT);

  for (int c0 = 0; c0 + 1 < slots; c0 += kChunk) {
    const int n = min(kChunk, slots - 1 - c0);
    // 1. the per-slot values, one thread a slot: validity, dt, the midpoint
    // accel less its bias, r_step = Exp((midpoint gyro - bg) dt), hat(acc) dt
    if (tid < kChunk) {
      const int sl = tid, k = c0 + sl;
      float dt = 0.f;
      const bool ok = sl < n && slot_valid(t, mask, k, &dt);
      s_valid[sl] = ok;
      s_dt[sl] = dt;
      if (ok) {
        float w[3], acc[3], phi[3], ah[9];
        for (int e = 0; e < 3; ++e) {
          w[e] = 0.5f * (gyro[3 * k + e] + gyro[3 * k + 3 + e]) - in[EI_BG + e];
          acc[e] = 0.5f * (accel[3 * k + e] + accel[3 * k + 3 + e]) - in[EI_BA + e];
          phi[e] = w[e] * dt;
          s_acc[sl][e] = acc[e];
        }
        so3::exp(phi, s_rs[sl]);
        so3::hat(acc, ah);
        for (int e = 0; e < 9; ++e) s_ah[sl][e] = ah[e] * dt;
      }
    }
    __syncthreads();
    clk.mark(C_SLOTS);
    const SlotMasks valid = {__ballot_sync(kFull, s_valid[lane]),
                             __ballot_sync(kFull, s_valid[32 + lane])};
    const int nv = valid.count();

    // 2. the mean's chain over the valid slots (warp 0 lane 0), the next
    // slot's inputs loaded while the current one is taken; r before each
    // slot to shared memory
    if (warp == 0) {
      if (s_valid[lane]) v_slot[__popc(valid.lo & ((1u << lane) - 1))] = lane;
      if (s_valid[32 + lane])
        v_slot[__popc(valid.lo) + __popc(valid.hi & ((1u << lane) - 1))] = 32 + lane;
    }
    if (tid == 0) {
      const float g[3] = {gx, gy, gz};
      SlotMasks left = valid;
      int k = left.pop();
      float rs[9], acc[3], dt = 0.f;
      if (k >= 0) {
        for (int e = 0; e < 9; ++e) rs[e] = s_rs[k][e];
        for (int e = 0; e < 3; ++e) acc[e] = s_acc[k][e];
        dt = s_dt[k];
      }
      for (int u = 0; u < nv; ++u) {
        const int kn = left.pop();
        float rs_n[9], acc_n[3], dt_n = 0.f;
        if (kn >= 0) {
          for (int e = 0; e < 9; ++e) rs_n[e] = s_rs[kn][e];
          for (int e = 0; e < 3; ++e) acc_n[e] = s_acc[kn][e];
          dt_n = s_dt[kn];
        }
        float aw[3], nr[9];
        for (int e = 0; e < 9; ++e) v_r[u][e] = r[e];
        so3::mv(r, acc, aw);
        for (int e = 0; e < 3; ++e) aw[e] = aw[e] + g[e];
        so3::mul(r, rs, nr);
        for (int e = 0; e < 3; ++e) {
          const float pn = p[e] + v[e] * dt + 0.5f * aw[e] * dt * dt;
          v[e] = v[e] + aw[e] * dt;
          p[e] = pn;
        }
        for (int e = 0; e < 9; ++e) {
          r[e] = nr[e];
          rs[e] = rs_n[e];
        }
        for (int e = 0; e < 3; ++e) acc[e] = acc_n[e];
        dt = dt_n;
      }
    }
    __syncthreads();
    clk.mark(C_PREFIX);

    // 3. one thread a (valid slot, row i < 3): row i of -r hat(acc) dt and of
    // -r dt at the slot's r, and of r_step
    if (tid < 3 * nv) {
      const int u = tid / 3, i = tid % 3, k = v_slot[u];
      const float dt = s_dt[k];
      const float* rr = v_r[u];
      const float* ah = s_ah[k];
      EskfSlot& f = v_f[u];
      for (int j = 0; j < 3; ++j) {
        f.a[3 * i + j] = -rr[3 * i] * ah[j] - rr[3 * i + 1] * ah[3 + j] - rr[3 * i + 2] * ah[6 + j];
        f.b[3 * i + j] = -rr[3 * i + j] * dt;
        f.rs[3 * i + j] = s_rs[k][3 * i + j];
      }
      if (i == 0) f.dt = dt;
    }
    __syncthreads();
    clk.mark(C_BLOCKS);

    // 4. the covariance, serial over the valid slots in warp 0 (lane: block
    // (bi, bj)), the next slot's F loaded while the current one is taken;
    // blocks move between lanes by shuffles, so no barrier. F by blocks:
    //   [ rs^T  0     0   -dt I  0    ]
    //   [ A     I     0    0     B    ]   A = -r hat(acc) dt, B = -r dt
    //   [ 0     dt I  I    0     0    ]
    //   [ 0     0     0    I     0    ]
    //   [ 0     0     0    0     I    ]
    // Every lane takes one form, a sum in the dense product's order over the
    // blocks (the 3x3 product, the unit or dt block, the second unit block,
    // the B product) with the blocks that are zero for its row (step 1) or
    // column (step 2) given a zero factor: a term 0 x adds nothing, so each
    // entry is the dense in-order product F cov F^T + Q dt's sum, within the
    // rounding of its fused multiply-adds
    if (warp == 0) {
      EskfSlot f = nv > 0 ? v_f[0] : EskfSlot{};
      for (int u = 0; u < nv; ++u) {
        const EskfSlot fn = u + 1 < nv ? v_f[u + 1] : f;
        float x[9], y[9], tc[9];
        // step 1: tc = (F cov)[bi][bj]
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          x[e] = __shfl_sync(kFull, c[e], x1);
          y[e] = __shfl_sync(kFull, c[e], y1);
        }
        {
          const float alpha = bi == 0 ? -f.dt : bi == 1 ? 1.f : bi == 2 ? f.dt : 0.f;
          const float beta = bi >= 2 ? 1.f : 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              float s = 0.f;
#pragma unroll
              for (int m = 0; m < 3; ++m) {
                const float pf = bi == 0 ? f.rs[3 * m + a] : bi == 1 ? f.a[3 * a + m] : 0.f;
                s = fmaf(pf, bi == 0 ? c[3 * m + b] : x[3 * m + b], s);
              }
              s = fmaf(alpha, bi == 1 ? c[3 * a + b] : x[3 * a + b], s);
              s = fmaf(beta, c[3 * a + b], s);
#pragma unroll
              for (int m = 0; m < 3; ++m)
                s = fmaf(bi == 1 ? f.b[3 * a + m] : 0.f, y[3 * m + b], s);
              tc[3 * a + b] = s;
            }
        }
        // step 2: c = (tc F^T)[bi][bj] + Q dt
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          x[e] = __shfl_sync(kFull, tc[e], x2);
          y[e] = __shfl_sync(kFull, tc[e], y2);
        }
        {
          const float alpha = bj == 0 ? -f.dt : bj == 1 ? 1.f : bj == 2 ? f.dt : 0.f;
          const float beta = bj >= 2 ? 1.f : 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              float s = 0.f;
#pragma unroll
              for (int m = 0; m < 3; ++m) {
                const float pf = bj == 0 ? f.rs[3 * m + b] : bj == 1 ? f.a[3 * b + m] : 0.f;
                s = fmaf(bj == 0 ? tc[3 * a + m] : x[3 * a + m], pf, s);
              }
              s = fmaf(bj == 1 ? tc[3 * a + b] : x[3 * a + b], alpha, s);
              s = fmaf(tc[3 * a + b], beta, s);
#pragma unroll
              for (int m = 0; m < 3; ++m)
                s = fmaf(y[3 * a + m], bj == 1 ? f.b[3 * b + m] : 0.f, s);
              c[3 * a + b] = __fadd_rn(s, a == b ? __fmul_rn(qv[a], f.dt) : 0.f);
            }
        }
        f = fn;
      }
    }
    __syncthreads();
    clk.mark(C_SERIAL);
  }

  if (tid == 0) {
    for (int k = 0; k < 9; ++k) out[EO_R + k] = r[k];
    for (int k = 0; k < 3; ++k) {
      out[EO_V + k] = v[k];
      out[EO_P + k] = p[k];
    }
  }
  if (warp == 0 && lane < 25)
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) out[EO_COV + 15 * (3 * bi + a) + 3 * bj + b] = c[3 * a + b];
  clk.mark(C_OUTPUT);
  clk.write(out + EO_SIZE);
}

}  // namespace

extern "C" int preintegrate_launch(const float* in, float* out, int slots, int has_init,
                                   void* stream) {
  preintegrate_kernel<<<1, kPreintThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, slots, has_init);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eskf_predict_launch(const float* in, float* out, int slots, float gx,
                                   float gy, float gz, void* stream) {
  eskf_predict_kernel<<<1, kEskfThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, slots, gx, gy, gz);
  return static_cast<int>(cudaGetLastError());
}
