"""Lie-group math for SO(3)/SE(3) on tensors (port of core/lie.py).

Only the functions the mapping path uses. Every function takes arbitrary
leading batch dimensions, has no data-dependent Python control flow
(small-angle branches are `torch.where` with safe denominators) and works in
float32 and float64.

Conventions follow the JAX package: quaternions are [w, x, y, z],
`rotation_to_rpy` is the fixed-axis Rz*Ry*Rx extraction.
"""

from __future__ import annotations

import torch

_EPS = {torch.float32: 1e-7, torch.float64: 1e-12}


def _eps(dtype) -> float:
    return _EPS.get(dtype, 1e-7)


def _eye(n, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def so3_hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def _theta(v: torch.Tensor):
    """Return (theta, safe_theta, theta_sq) with safe_theta bounded away from 0."""
    theta_sq = torch.sum(v * v, dim=-1)
    theta = torch.sqrt(theta_sq)
    safe = torch.clamp(theta, min=_eps(v.dtype))
    return theta, safe, theta_sq


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) via Rodrigues. [..., 3] -> [..., 3, 3]."""
    theta, safe, theta_sq = _theta(v)
    small = theta < _eps(v.dtype) ** 0.5
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    vx = so3_hat(v)
    return _eye(3, v) + a[..., None, None] * vx + b[..., None, None] * (vx @ vx)


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], w >= 0 (branch-free
    Shepperd-style: all four candidates, the best-conditioned one kept)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    sel = torch.nn.functional.one_hot(torch.argmax(pivots, dim=-1), 4).to(r.dtype)
    q = (sel[..., 0, None] * qw + sel[..., 1, None] * qx
         + sel[..., 2, None] * qy + sel[..., 3, None] * qz)
    q = q / _norm(q, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [w, x, y, z] convention."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_nlerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Normalized linear interpolation with shortest-path sign flip."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim == q0.ndim - 1:
        t = t[..., None]
    q = q0 + (q1 - q0) * t
    return q / torch.clamp(_norm(q, keepdim=True), min=_eps(q0.dtype))


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3), quaternion based (robust at theta = pi)."""
    q = mat_to_quat(r)
    w = q[..., 0]
    vec = q[..., 1:]
    norm_vec = _norm(vec)
    eps = _eps(r.dtype)
    small = norm_vec < eps
    phi = 2.0 * torch.atan2(norm_vec, w)
    u = vec / torch.clamp(norm_vec, min=eps)[..., None]
    small_log = 2.0 * vec / torch.clamp(w, min=eps)[..., None]
    return torch.where(small[..., None], small_log, phi[..., None] * u)


def so3_jl(v: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3)."""
    theta, safe, theta_sq = _theta(v)
    small = theta < _eps(v.dtype) ** 0.5
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe - torch.sin(safe)) / (safe * safe * safe))
    vx = so3_hat(v)
    return _eye(3, v) + a[..., None, None] * vx + b[..., None, None] * (vx @ vx)


def so3_jr(v: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3): Jr(v) = Jl(-v)."""
    return so3_jl(-v)


def so3_jl_inv(v: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian (closed form, Taylor-safe)."""
    theta, safe, theta_sq = _theta(v)
    small = theta < _eps(v.dtype) ** 0.5
    half = safe / 2.0
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / (safe * safe)) - (torch.cos(half) / (2.0 * safe * torch.sin(half))),
    )
    vx = so3_hat(v)
    return _eye(3, v) - 0.5 * vx + cot_term[..., None, None] * (vx @ vx)


def so3_jr_inv(v: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian: Jr_inv(v) = Jl_inv(-v)."""
    return so3_jl_inv(-v)


def make_se3(r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Assemble a 4x4 homogeneous transform from R [..., 3, 3] and p [..., 3]."""
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = p
    out[..., 3, 3] = 1.0
    return out


def se3_inv(t_mat: torch.Tensor) -> torch.Tensor:
    """Fast SE(3) inverse (no general 4x4 solve)."""
    rt = t_mat[..., :3, :3].transpose(-1, -2)
    p = t_mat[..., :3, 3]
    return make_se3(rt, -torch.einsum("...ij,...j->...i", rt, p))


def rotation_to_rpy(r: torch.Tensor) -> torch.Tensor:
    """Fixed-axis roll/pitch/yaw from R = Rz*Ry*Rx."""
    roll = torch.atan2(r[..., 2, 1], r[..., 2, 2])
    pitch = torch.asin(torch.clamp(-r[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(r[..., 1, 0], r[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def marginalize(h: torch.Tensor, start: int, end: int,
                sv_thresh: float = 1e-6) -> torch.Tensor:
    """Schur-marginalize the block [start, end] (inclusive) out of the square
    information matrix `h`; the marginalized rows/cols of the result are 0.

    The pseudo-inverse of the marginalized block is an SVD with singular
    values below `sv_thresh` zeroed, taken after Jacobi scaling so the f32
    SVD keeps the small directions (same rationale as the JAX package)."""
    n = h.shape[-1]
    a = start
    c = n - (end + 1)
    idx_keep = list(range(0, a)) + list(range(end + 1, n))
    idx_marg = list(range(a, end + 1))
    perm = torch.tensor(idx_keep + idx_marg, device=h.device)

    hp = h[..., perm, :][..., :, perm]
    k = a + c
    h_kk = hp[..., :k, :k]
    h_km = hp[..., :k, k:]
    h_mk = hp[..., k:, :k]
    h_mm = hp[..., k:, k:]

    d_inv = torch.rsqrt(torch.clamp(torch.diagonal(h_mm, dim1=-2, dim2=-1), min=1e-24))
    h_mm_s = h_mm * d_inv[..., :, None] * d_inv[..., None, :]
    u, s, vt = torch.linalg.svd(h_mm_s)
    s_inv = torch.where(s > sv_thresh, 1.0 / torch.clamp(s, min=sv_thresh),
                        torch.zeros_like(s))
    pinv_s = vt.transpose(-1, -2) @ (s_inv[..., :, None] * u.transpose(-1, -2))
    h_mm_pinv = pinv_s * d_inv[..., :, None] * d_inv[..., None, :]

    h_marg = h_kk - h_km @ h_mm_pinv @ h_mk
    out = torch.zeros_like(hp)
    out[..., :k, :k] = h_marg
    inv_perm = torch.argsort(perm)
    return out[..., inv_perm, :][..., :, inv_perm]
