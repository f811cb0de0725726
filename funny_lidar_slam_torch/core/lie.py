"""Lie-group math for SO(3)/SE(3) on tensors (port of core/lie.py, whole).

Every function takes arbitrary leading batch dimensions, has no data-dependent Python control flow
(small-angle branches are `torch.where` with safe denominators) and works in
float32 and float64.

Conventions follow the JAX package: quaternions are [w, x, y, z],
`rotation_to_rpy` is the fixed-axis Rz*Ry*Rx extraction, and `se3_exp`
takes (and `se3_log` returns) tangents ordered [translation, rotation].
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


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of `so3_hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


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


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation, nlerp fallback for nearly-parallel quats."""
    eps = _eps(q0.dtype)
    dot = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(dot[..., None] < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.acos(torch.clamp(dot, 0.0, 1.0 - eps))
    sin_theta = torch.clamp(torch.sin(theta), min=eps)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    w0 = torch.sin((1.0 - t) * theta) / sin_theta
    w1 = torch.sin(t * theta) / sin_theta
    close = dot > 1.0 - 1e-6
    q_slerp = w0[..., None] * q0 + w1[..., None] * q1
    q_nlerp = q0 + (q1 - q0) * t[..., None]
    q = torch.where(close[..., None], q_nlerp, q_slerp)
    return q / torch.clamp(_norm(q, keepdim=True), min=eps)


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


def _se3_q_block(rho: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Upper-right Q block of the SE(3) left Jacobian (Barfoot's closed
    form)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq)
    eps = _eps(phi.dtype)
    small = theta_sq < eps
    safe = torch.clamp(theta, min=eps)
    st, ct = torch.sin(safe), torch.cos(safe)
    it = 1.0 / safe
    it2 = it * it
    it4 = it2 * it2
    c1 = torch.where(small, 1.0 / 6.0, it2 - st * it2 * it)
    c2 = torch.where(small, 1.0 / 24.0, 0.5 * it2 + ct * it4 - it4)
    c3 = torch.where(small, 1.0 / 120.0, it4 + 0.5 * ct * it4 - 1.5 * st * it * it4)
    u, w = so3_hat(rho), so3_hat(phi)
    wu = w @ u
    wuw = wu @ w
    uw = u @ w
    return (0.5 * u
            + c1[..., None, None] * (wu + uw + wuw)
            - c2[..., None, None] * (theta_sq[..., None, None] * u + 2.0 * wuw)
            + c3[..., None, None] * (wuw @ w + w @ wuw))


def se3_exp(v: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3). v = [..., 6] ordered [translation, rotation]."""
    rho, phi = v[..., :3], v[..., 3:]
    t = torch.einsum("...ij,...j->...i", so3_jl(phi), rho)
    return make_se3(so3_exp(phi), t)


def se3_log(t_mat: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3), [translation, rotation] ordering."""
    phi = so3_log(t_mat[..., :3, :3])
    rho = torch.einsum("...ij,...j->...i", so3_jl_inv(phi), t_mat[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def _blocks(a, b, c, d) -> torch.Tensor:
    """[[a, b], [c, d]] of [..., 3, 3] blocks -> [..., 6, 6]."""
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def se3_adj(t_mat: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) for the [translation, rotation] tangent ordering."""
    r = t_mat[..., :3, :3]
    return _blocks(r, so3_hat(t_mat[..., :3, 3]) @ r, torch.zeros_like(r), r)


def se3_jl(v: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SE(3), 6x6, [translation, rotation] ordering."""
    rho, phi = v[..., :3], v[..., 3:]
    j = so3_jl(phi)
    return _blocks(j, _se3_q_block(rho, phi), torch.zeros_like(j), j)


def se3_jr(v: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SE(3): Jr(v) = Jl(-v)."""
    return se3_jl(-v)


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


def chord_angle(a, b) -> torch.Tensor:
    """Angle between the rotations of `a` and `b` (rotation matrices or
    poses: the top-left 3x3 block), rad, in float64 from the chord
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2). Equal rotations give exactly 0,
    where arccos((trace(Ra^T Rb) - 1) / 2) reads an f32 rotation's
    orthonormality error (~1e-7 in the trace) as ~1e-3 rad."""
    ra = torch.as_tensor(a, dtype=torch.float64)[..., :3, :3]
    rb = torch.as_tensor(b, dtype=torch.float64, device=ra.device)[..., :3, :3]
    chord = torch.linalg.matrix_norm(ra - rb)
    return 2.0 * torch.asin(torch.clamp(chord / (2.0 * 2.0 ** 0.5), max=1.0))


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
