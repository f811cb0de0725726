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
// chain of dependent steps and the block barriers between them do. The
// design keeps the whole carried state in shared memory, one block per
// call, so the loop runs on the device without a launch a slot: one thread
// takes the slot's scalar 3x3 work, then every thread takes entries of the
// small dense products. A slot that is not valid (masked, or a dt that is
// not positive) is skipped by the whole block, which is exact: the plain
// version's torch.where leaves the state untouched there. Every thread
// reads the validity from global memory itself, so the branch is uniform
// without a barrier.
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

constexpr int kPreintThreads = 128;
constexpr int kEskfThreads = 256;

// slot k runs from sample k to k+1 (the plain version's `valid`)
__device__ inline bool slot_valid(const float* t, const float* mask, int k, float* dt) {
  *dt = t[k + 1] - t[k];
  return mask[k] > 0.5f && mask[k + 1] > 0.5f && *dt > 0.f;
}

__global__ void __launch_bounds__(kPreintThreads)
preintegrate_kernel(const float* __restrict__ in, float* __restrict__ out, int slots,
                    int has_init) {
  __shared__ float st[PS_SIZE];           // the carried state
  __shared__ float a[81], b[54], tm[81];  // A, B and A cov of the slot
  __shared__ float rs[9], jrm[9], dra[9], dracc[3], noise[6];
  const int tid = threadIdx.x;
  const float* hdr = in;
  const float* t = in + PH_SIZE;
  const float* gyro = t + slots;
  const float* accel = gyro + 3 * slots;
  const float* mask = accel + 3 * slots;

  for (int i = tid; i < PS_SIZE; i += blockDim.x)
    st[i] = has_init ? mask[slots + i]
                     : ((i == PS_DR || i == PS_DR + 4 || i == PS_DR + 8) ? 1.f : 0.f);
  __syncthreads();

  for (int k = 0; k + 1 < slots; ++k) {
    float dt;
    if (!slot_valid(t, mask, k, &dt)) continue;  // uniform over the block
    if (tid == 0) {
      float g[3], acc[3], phi[3], ah[9];
      for (int c = 0; c < 3; ++c) {
        g[c] = 0.5f * (gyro[3 * k + c] + gyro[3 * k + 3 + c]) - hdr[PH_BG + c];
        acc[c] = 0.5f * (accel[3 * k + c] + accel[3 * k + 3 + c]) - hdr[PH_BA + c];
        phi[c] = g[c] * dt;
      }
      so3::exp(phi, rs);
      so3::jr(phi, jrm);
      so3::hat(acc, ah);
      so3::mul(st + PS_DR, ah, dra);
      so3::mv(st + PS_DR, acc, dracc);
      const float safe_dt = fmaxf(dt, 1e-9f);
      for (int c = 0; c < 3; ++c) {
        noise[c] = hdr[PH_GVAR + c] / safe_dt;
        noise[3 + c] = hdr[PH_AVAR + c] / safe_dt;
      }
    }
    __syncthreads();

    // A [9,9] and B [9,6] of the slot; each thread's new Jacobian or delta
    // entry from the old state
    const float* dr = st + PS_DR;
    for (int e = tid; e < 81 + 54; e += blockDim.x) {
      if (e < 81) {
        const int i = e / 9, j = e % 9;
        float v = 0.f;
        if (j < 3) {
          if (i < 3) v = rs[3 * j + i];
          else if (i < 6) v = -dra[3 * (i - 3) + j] * dt;
          else v = -0.5f * dra[3 * (i - 6) + j] * dt * dt;
        } else if (j < 6) {
          if (i >= 3 && i - 3 == j - 3) v = 1.f;
          else if (i >= 6 && i - 6 == j - 3) v = dt;
        } else if (i == j) {
          v = 1.f;
        }
        a[e] = v;
      } else {
        const int f = e - 81, i = f / 6, j = f % 6;
        float v = 0.f;
        if (i < 3 && j < 3) v = jrm[3 * i + j] * dt;
        else if (i >= 3 && i < 6 && j >= 3) v = dr[3 * (i - 3) + (j - 3)] * dt;
        else if (i >= 6 && j >= 3) v = 0.5f * dr[3 * (i - 6) + (j - 3)] * dt * dt;
        b[f] = v;
      }
    }
    float nv = 0.f;
    int slot_out = -1;
    if (tid < 45) {  // the five bias Jacobians, 3x3 each
      const int which = tid / 9, i = (tid % 9) / 3, j = tid % 3, ij = 3 * i + j;
      const float* drdbg = st + PS_DR_DBG;
      // (d_r acc_hat dr_dbg)_ij
      const float m = dra[3 * i] * drdbg[j] + dra[3 * i + 1] * drdbg[3 + j]
                      + dra[3 * i + 2] * drdbg[6 + j];
      if (which == 0) {
        nv = st[PS_DP_DBG + ij] + st[PS_DV_DBG + ij] * dt - 0.5f * m * dt * dt;
        slot_out = PS_DP_DBG + ij;
      } else if (which == 1) {
        nv = st[PS_DP_DBA + ij] + st[PS_DV_DBA + ij] * dt - 0.5f * dr[ij] * dt * dt;
        slot_out = PS_DP_DBA + ij;
      } else if (which == 2) {
        nv = st[PS_DV_DBG + ij] - m * dt;
        slot_out = PS_DV_DBG + ij;
      } else if (which == 3) {
        nv = st[PS_DV_DBA + ij] - dr[ij] * dt;
        slot_out = PS_DV_DBA + ij;
      } else {
        nv = (rs[i] * drdbg[j] + rs[3 + i] * drdbg[3 + j] + rs[6 + i] * drdbg[6 + j])
             - jrm[ij] * dt;
        slot_out = PS_DR_DBG + ij;
      }
    } else if (tid < 54) {  // d_r <- d_r r_step
      const int ij = tid - 45, i = ij / 3, j = ij % 3;
      nv = dr[3 * i] * rs[j] + dr[3 * i + 1] * rs[3 + j] + dr[3 * i + 2] * rs[6 + j];
      slot_out = PS_DR + ij;
    } else if (tid < 57) {  // d_v <- d_v + d_r acc dt
      const int c = tid - 54;
      nv = st[PS_DV + c] + dracc[c] * dt;
      slot_out = PS_DV + c;
    } else if (tid < 60) {  // d_p <- d_p + d_v dt + 0.5 d_r acc dt^2
      const int c = tid - 57;
      nv = st[PS_DP + c] + st[PS_DV + c] * dt + 0.5f * dracc[c] * dt * dt;
      slot_out = PS_DP + c;
    }
    __syncthreads();

    // A cov; the new entries replace the old ones
    for (int e = tid; e < 81; e += blockDim.x) {
      const int i = e / 9, j = e % 9;
      float s = 0.f;
      for (int m = 0; m < 9; ++m) s += a[9 * i + m] * st[PS_COV + 9 * m + j];
      tm[e] = s;
    }
    if (slot_out >= 0) st[slot_out] = nv;
    __syncthreads();

    // cov <- A cov A^T + B (Sigma / dt) B^T, plus the position integration noise
    for (int e = tid; e < 81; e += blockDim.x) {
      const int i = e / 9, j = e % 9;
      float s = 0.f;
      for (int m = 0; m < 9; ++m) s += tm[9 * i + m] * a[9 * j + m];
      float q = 0.f;
      for (int m = 0; m < 6; ++m) q += b[6 * i + m] * (noise[m] * b[6 * j + m]);
      float c = s + q;
      if (i == j && i >= 6) c += hdr[PH_IVAR + i - 6] * dt;
      st[PS_COV + e] = c;
    }
    if (tid == 0) st[PS_DT] += dt;
    __syncthreads();
  }
  for (int i = tid; i < PS_SIZE; i += blockDim.x) out[i] = st[i];
}

__global__ void __launch_bounds__(kEskfThreads)
eskf_predict_kernel(const float* __restrict__ in, float* __restrict__ out, int slots,
                    float gx, float gy, float gz) {
  __shared__ float r[9], v[3], p[3], cov[225];
  __shared__ float f[225], tm[225], nrvp[15];
  __shared__ float rs[9], fra[9], qd[15];
  const int tid = threadIdx.x;
  const float* t = in + EI_SIZE;
  const float* gyro = t + slots;
  const float* accel = gyro + 3 * slots;
  const float* mask = accel + 3 * slots;

  for (int i = tid; i < 240; i += blockDim.x) {
    if (i < 9) r[i] = in[EI_R + i];
    else if (i < 12) v[i - 9] = in[EI_V + i - 9];
    else if (i < 15) p[i - 12] = in[EI_P + i - 12];
    else cov[i - 15] = in[EI_COV + i - 15];
  }
  __syncthreads();

  for (int k = 0; k + 1 < slots; ++k) {
    float dt;
    if (!slot_valid(t, mask, k, &dt)) continue;  // uniform over the block
    if (tid == 0) {
      const float g[3] = {gx, gy, gz};
      float w[3], acc[3], phi[3], ah[9], aw[3];
      for (int c = 0; c < 3; ++c) {
        w[c] = 0.5f * (gyro[3 * k + c] + gyro[3 * k + 3 + c]) - in[EI_BG + c];
        acc[c] = 0.5f * (accel[3 * k + c] + accel[3 * k + 3 + c]) - in[EI_BA + c];
        phi[c] = w[c] * dt;
      }
      so3::exp(phi, rs);
      so3::hat(acc, ah);
      for (int e = 0; e < 9; ++e) ah[e] = ah[e] * dt;
      for (int i = 0; i < 3; ++i)  // -r @ (acc_hat dt)
        for (int j = 0; j < 3; ++j)
          fra[3 * i + j] = -r[3 * i] * ah[j] - r[3 * i + 1] * ah[3 + j]
                           - r[3 * i + 2] * ah[6 + j];
      so3::mv(r, acc, aw);
      for (int c = 0; c < 3; ++c) aw[c] = aw[c] + g[c];
      so3::mul(r, rs, nrvp);
      for (int c = 0; c < 3; ++c) {
        nrvp[9 + c] = v[c] + aw[c] * dt;
        nrvp[12 + c] = p[c] + v[c] * dt + 0.5f * aw[c] * dt * dt;
      }
      for (int c = 0; c < 3; ++c) {
        qd[c] = in[EI_GVAR + c] * dt;
        qd[3 + c] = in[EI_AVAR + c] * dt;
        qd[6 + c] = 0.f;
        qd[9 + c] = in[EI_GRW + c] * dt;
        qd[12 + c] = in[EI_ARW + c] * dt;
      }
    }
    __syncthreads();

    // the error-state transition F [15,15]
    for (int e = tid; e < 225; e += blockDim.x) {
      const int i = e / 15, j = e % 15;
      float x = (i == j) ? 1.f : 0.f;
      if (i < 3 && j < 3) x = rs[3 * j + i];
      else if (i < 3 && j >= 9 && j < 12) x = (j - 9 == i) ? -dt : 0.f;
      else if (i >= 3 && i < 6 && j < 3) x = fra[3 * (i - 3) + j];
      else if (i >= 3 && i < 6 && j >= 12) x = -r[3 * (i - 3) + (j - 12)] * dt;
      else if (i >= 6 && i < 9 && j >= 3 && j < 6) x = (j - 3 == i - 6) ? dt : 0.f;
      f[e] = x;
    }
    __syncthreads();

    // F cov; the new mean replaces the old one
    for (int e = tid; e < 225; e += blockDim.x) {
      const int i = e / 15, j = e % 15;
      float s = 0.f;
      for (int m = 0; m < 15; ++m) s += f[15 * i + m] * cov[15 * m + j];
      tm[e] = s;
    }
    if (tid < 9) r[tid] = nrvp[tid];
    else if (tid < 12) v[tid - 9] = nrvp[tid];
    else if (tid < 15) p[tid - 12] = nrvp[tid];
    __syncthreads();

    // cov <- F cov F^T + Q dt
    for (int e = tid; e < 225; e += blockDim.x) {
      const int i = e / 15, j = e % 15;
      float s = 0.f;
      for (int m = 0; m < 15; ++m) s += tm[15 * i + m] * f[15 * j + m];
      cov[e] = s + (i == j ? qd[i] : 0.f);
    }
    __syncthreads();
  }
  for (int i = tid; i < EO_SIZE; i += blockDim.x) {
    if (i < 9) out[EO_R + i] = r[i];
    else if (i < 12) out[EO_V + i - 9] = v[i - 9];
    else if (i < 15) out[EO_P + i - 12] = p[i - 12];
    else out[EO_COV + i - 15] = cov[i - 15];
  }
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
