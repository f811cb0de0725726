// SO(3) helpers for one thread, float32, row-major 3x3 matrices: the
// functions of core/lie.py with the same small-angle branches, thresholds
// and order of operations (so3_exp, so3_jl / so3_jr, so3_jl_inv /
// so3_jr_inv, so3_log through the branch-free Shepperd quaternion).
#pragma once

#include <math.h>

namespace so3 {

constexpr float kEps = 1e-7f;              // lie._eps(float32)
constexpr float kSmall = 3.16227766e-4f;   // lie._eps(float32) ** 0.5

__device__ inline void hat(const float v[3], float m[9]) {
  m[0] = 0.f;   m[1] = -v[2]; m[2] = v[1];
  m[3] = v[2];  m[4] = 0.f;   m[5] = -v[0];
  m[6] = -v[1]; m[7] = v[0];  m[8] = 0.f;
}

// c = a b
__device__ inline void mul(const float a[9], const float b[9], float c[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

// c = a^T b
__device__ inline void mul_tn(const float a[9], const float b[9], float c[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[i] * b[j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j];
}

// c = a b^T
__device__ inline void mul_nt(const float a[9], const float b[9], float c[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1]
                     + a[3 * i + 2] * b[3 * j + 2];
}

// out = a v
__device__ inline void mv(const float a[9], const float v[3], float out[3]) {
  for (int i = 0; i < 3; ++i)
    out[i] = a[3 * i] * v[0] + a[3 * i + 1] * v[1] + a[3 * i + 2] * v[2];
}

// out = a^T v
__device__ inline void mtv(const float a[9], const float v[3], float out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = a[i] * v[0] + a[3 + i] * v[1] + a[6 + i] * v[2];
}

// I + a [v]x + b [v]x^2
__device__ inline void rodrigues(const float v[3], float a, float b, float out[9]) {
  float vx[9], vx2[9];
  hat(v, vx);
  mul(vx, vx, vx2);
  for (int k = 0; k < 9; ++k) out[k] = ((k % 4 == 0) ? 1.f : 0.f) + a * vx[k] + b * vx2[k];
}

__device__ inline float theta_sq(const float v[3]) {
  return v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
}

// so(3) -> SO(3) (Rodrigues)
__device__ inline void exp(const float v[3], float r[9]) {
  const float th2 = theta_sq(v), th = sqrtf(th2), safe = fmaxf(th, kEps);
  const bool small = th < kSmall;
  const float a = small ? 1.f - th2 / 6.f : sinf(safe) / safe;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(safe)) / (safe * safe);
  rodrigues(v, a, b, r);
}

// left Jacobian
__device__ inline void jl(const float v[3], float j[9]) {
  const float th2 = theta_sq(v), th = sqrtf(th2), safe = fmaxf(th, kEps);
  const bool small = th < kSmall;
  const float a = small ? 0.5f - th2 / 24.f : (1.f - cosf(safe)) / (safe * safe);
  const float b = small ? (float)(1.0 / 6.0) - th2 / 120.f
                        : (safe - sinf(safe)) / (safe * safe * safe);
  rodrigues(v, a, b, j);
}

// right Jacobian: Jr(v) = Jl(-v)
__device__ inline void jr(const float v[3], float j[9]) {
  const float m[3] = {-v[0], -v[1], -v[2]};
  jl(m, j);
}

// inverse left Jacobian
__device__ inline void jl_inv(const float v[3], float j[9]) {
  const float th2 = theta_sq(v), th = sqrtf(th2), safe = fmaxf(th, kEps);
  const bool small = th < kSmall;
  const float half = safe / 2.f;
  const float cot = small ? (float)(1.0 / 12.0) + th2 / 720.f
                          : (1.f / (safe * safe)) - (cosf(half) / (2.f * safe * sinf(half)));
  rodrigues(v, -0.5f, cot, j);
}

// inverse right Jacobian: Jr^-1(v) = Jl^-1(-v)
__device__ inline void jr_inv(const float v[3], float j[9]) {
  const float m[3] = {-v[0], -v[1], -v[2]};
  jl_inv(m, j);
}

// SO(3) -> so(3) through the unit quaternion (lie.mat_to_quat: all four
// Shepperd candidates, the first largest pivot kept, w >= 0)
__device__ inline void log(const float r[9], float out[3]) {
  const float m00 = r[0], m01 = r[1], m02 = r[2];
  const float m10 = r[3], m11 = r[4], m12 = r[5];
  const float m20 = r[6], m21 = r[7], m22 = r[8];
  const float tr = m00 + m11 + m22;
  const float piv[4] = {1.f + tr, 1.f + m00 - m11 - m22, 1.f - m00 + m11 - m22,
                        1.f - m00 - m11 + m22};
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (piv[k] > piv[best]) best = k;
  float q[4];
  if (best == 0) {
    q[0] = 1.f + tr; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (best == 1) {
    q[0] = m21 - m12; q[1] = 1.f + m00 - m11 - m22; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (best == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = 1.f - m00 + m11 - m22; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = 1.f - m00 - m11 + m22;
  }
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float sgn = (q[0] / qn < 0.f) ? -1.f : 1.f;
  for (int k = 0; k < 4; ++k) q[k] = q[k] / qn * sgn;
  const float w = q[0];
  const float nv = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (nv < kEps) {
    const float wd = fmaxf(w, kEps);
    for (int k = 0; k < 3; ++k) out[k] = 2.f * q[k + 1] / wd;
  } else {
    const float phi = 2.f * atan2f(nv, w);
    const float nd = fmaxf(nv, kEps);
    for (int k = 0; k < 3; ++k) out[k] = phi * (q[k + 1] / nd);
  }
}

}  // namespace so3
