"""Closed-form batched small-matrix linear algebra (port of ops/lin3.py):
3x3 inverse, 3x3 symmetric eigenvalues and principal eigenvector, and the
damped 6x6 solve."""

from __future__ import annotations

import torch


def inv3(a: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] via adjugate."""
    m00, m01, m02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    m10, m11, m12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    m20, m21, m22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion along the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def sym3_eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending [..., 3].

    Trigonometric closed form (Smith's algorithm), safe for repeated roots:
    phi = arccos(clip(det(B) / 2)) / 3 with B the normalized deviator."""
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    d = a - q[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    p2 = torch.sum(d * d, dim=(-2, -1))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    b = d / torch.clamp(p, min=1e-30)[..., None, None]
    r = torch.clamp(_det3(b) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    lam0 = q + 2.0 * p * torch.cos(phi)  # largest
    lam2 = q + 2.0 * p * torch.cos(phi + two_pi_3)  # smallest
    lam1 = 3.0 * q - lam0 - lam2
    lams = torch.stack([lam2, lam1, lam0], dim=-1)
    return torch.where((p2 < 1e-30)[..., None], q[..., None].expand_as(lams), lams)


def sym3_principal_eigvec(a: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of symmetric [..., 3, 3].

    Shifted power iteration: the Gershgorin shift makes the target
    eigenvalue dominant for indefinite inputs, and the fixed start vector
    (1, 1, 1)/sqrt(3) fixes the sign as the JAX package's."""
    shift = torch.sum(torch.abs(a), dim=-1).amax(-1)  # max row sum
    m = a + shift[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    v = torch.full(a.shape[:-1], 0.577350269, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", m, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def solve6_damped(h: torch.Tensor, g: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """Solve (H + damping*diag_scale*I) dx = g for 6x6 normal equations.

    The damping is scaled by the mean diagonal. `cholesky_ex` neither raises
    nor syncs; a failed factorization yields NaN, as the JAX solve does."""
    diag_scale = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1.0)
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    hd = h + (damping * diag_scale)[..., None, None] * eye
    chol, info = torch.linalg.cholesky_ex(hd)
    x = torch.cholesky_solve(g[..., None], chol)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))
