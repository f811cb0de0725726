"""Closed-form small-matrix linear algebra (port of ops/lin3.py, the subset
the mapping path uses)."""

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
