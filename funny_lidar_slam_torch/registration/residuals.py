"""Residuals and Jacobians for scan-to-map ICP (port of the IcpOptimized
subset of registration/residuals.py).

For every padded source point at the current pose: a correspondence, a
residual, its 6-dof Jacobian and a validity mask, reduced to 6x6 normal
equations H and right-hand side g. Point-to-point convention (the
reference's icp_optimized.h): dx = [t(0:3), r(3:6)], P += dt, R := R Exp(dr).

Candidate-set caching: one stencil gather (`gather_candidates`) caches the
M nearest map points per source point; every GN iteration re-selects the
nearest among them at the CURRENT pose (`point_to_point_hg_cand`), so the
expensive gather runs only when the pose has moved.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import so3_hat
from ..maps import block_map
from ..ops import select
from ..ops.voxel import group_by_voxel


class HG(NamedTuple):
    """Reduced normal equations + per-iteration statistics."""

    h: torch.Tensor  # [6, 6]
    g: torch.Tensor  # [6]
    num_valid: torch.Tensor  # [] int32
    total_res: torch.Tensor  # [] summed residual magnitude


def _reduce_vec3(j: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
                 valid: torch.Tensor) -> HG:
    """3-vector residuals with per-point information matrices lam [N,3,3]."""
    w = valid.to(j.dtype)
    lj = torch.einsum("nab,nbk->nak", lam, j) * w[:, None, None]  # [N,3,6]
    h = torch.einsum("nak,nam->km", j, lj)
    g = -torch.einsum("nak,na->k", lj, r)
    res = torch.einsum("na,nab,nb->n", r, lam, r)
    return HG(h, g, valid.sum(dtype=torch.int32), torch.sum(res * w))


def transform_points(t_mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ t_mat[:3, :3].T + t_mat[:3, 3]


class CandSet(NamedTuple):
    """Cached NN candidates: the M nearest map points per source point,
    gathered at some past pose, in coordinate-plane layout ([N, M] per
    axis). Rows are in the voxel-sorted order of the gather; `src` and
    `src_mask` carry the matching source points, so every consumer is an
    order-invariant masked reduction."""

    px: torch.Tensor  # [N, M] candidate x (world frame)
    py: torch.Tensor  # [N, M]
    pz: torch.Tensor  # [N, M]
    valid: torch.Tensor  # [N, M]
    src: torch.Tensor  # [N, 3] source points in candidate-row order
    src_mask: torch.Tensor  # [N]


def gather_candidates(
    t_mat: torch.Tensor,
    src: torch.Tensor,
    src_mask: torch.Tensor,
    m,
    inv_voxel_size,
    m_cand: int,
    stencil: str = "nearby26",
    num_probes: int = 8,
    group_capacity: int | None = None,
) -> CandSet:
    """One stencil gather -> M nearest candidates per transformed source
    point: voxel-sort the transformed points, gather the 8-block cover per
    unique voxel (`block_map.gather_cover_any`: the hashed block map or the
    dense grid), then `select.fused_select` (the CUDA kernel on the card,
    its plain version on the CPU). Results stay in sorted order."""
    p_t = transform_points(t_mat, src)
    n = src.shape[0]
    gcap = group_capacity or n
    gcap = -(-gcap // select.TQ) * select.TQ
    g = group_by_voxel(p_t, src_mask, inv_voxel_size)
    rep_tgt = torch.where((g.rank == 0) & (g.group_id < gcap), g.group_id,
                          torch.full_like(g.group_id, gcap))
    uniq = torch.zeros((gcap + 1, 3), dtype=torch.int32, device=src.device)
    uniq[rep_tgt] = g.group_coords  # row gcap absorbs dropped writes
    wnd = block_map.gather_cover_any(m, uniq[:gcap], num_probes)
    gid = torch.clamp(g.group_id, max=gcap - 1).to(torch.int32)
    d2, px, py, pz = select.fused_select(wnd, gid, g.sorted_pts.contiguous(), m_cand,
                                         m.plane, stencil=stencil, qvox=g.group_coords)
    valid = (d2 < 1e18) & g.sorted_mask[:, None] & (g.group_id < gcap)[:, None]
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    px, py, pz = (torch.where(valid, v, zero) for v in (px, py, pz))
    return CandSet(px=px, py=py, pz=pz, valid=valid, src=src[g.order],
                   src_mask=g.sorted_mask)


def query_knn_any(m, queries, inv_voxel_size, k, stencil, num_probes, group_capacity=None):
    """Stencil k-NN over a block or grid map (`block_map.query_knn`)."""
    return block_map.query_knn(m, queries, inv_voxel_size, k=k, stencil=stencil,
                               num_probes=num_probes, group_capacity=group_capacity)


def _take_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, M] values + [N, k] lane indices -> [N, k]."""
    return torch.gather(x, 1, idx)


def _select_knn(t_mat: torch.Tensor, cand: CandSet, k: int):
    """Re-select the k nearest cached candidates at the CURRENT pose.
    Returns (p_t [N,3], nbrs [N,k,3], d2 [N,k], ok [N,k])."""
    p_t = transform_points(t_mat, cand.src)
    d2 = ((cand.px - p_t[:, 0:1]) ** 2 + (cand.py - p_t[:, 1:2]) ** 2
          + (cand.pz - p_t[:, 2:3]) ** 2)
    d2 = torch.where(cand.valid, d2, torch.full_like(d2, float("inf")))
    if k == 1:
        idx = torch.argmin(d2, dim=1, keepdim=True)
        kd2 = torch.gather(d2, 1, idx)
    else:
        kd2, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    nbrs = torch.stack([_take_lanes(cand.px, idx), _take_lanes(cand.py, idx),
                        _take_lanes(cand.pz, idx)], dim=-1)
    return p_t, nbrs, kd2, torch.isfinite(kd2)


class P2PCorr(NamedTuple):
    q: torch.Tensor  # [N, 3] matched map point
    valid: torch.Tensor  # [N]


def point_to_point_hg_cand(t_mat: torch.Tensor, cand: CandSet, max_corr_dist_sq) -> HG:
    """ICP linearization on the candidate cache: exact NN re-selection at
    the current pose, restricted to the cached candidates."""
    _, nbrs, d2, ok = _select_knn(t_mat, cand, 1)
    corr = P2PCorr(q=nbrs[:, 0], valid=ok[:, 0] & (d2[:, 0] <= max_corr_dist_sq))
    return point_to_point_hg_corr(t_mat, cand.src, corr)


def point_to_point_hg_corr(t_mat: torch.Tensor, src: torch.Tensor, corr: P2PCorr) -> HG:
    """Point-to-point linearization: r = (R p + t) - q,
    J = [ I | -R hat(p) ] (dx ordering [t, r])."""
    n = src.shape[0]
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    err = transform_points(t_mat, src) - corr.q  # [N, 3]
    jac = torch.cat([eye.expand(n, 3, 3),
                     -torch.einsum("ij,njk->nik", t_mat[:3, :3], so3_hat(src))], dim=-1)
    hg = _reduce_vec3(jac, err, eye.expand(n, 3, 3), corr.valid)
    # the reference accumulates |r| (norm), not mahalanobis, for ICP stats
    w = corr.valid.to(src.dtype)
    return hg._replace(total_res=torch.sum(torch.linalg.vector_norm(err, dim=-1) * w))


def fitness_score(t_mat: torch.Tensor, src: torch.Tensor, src_mask: torch.Tensor, m,
                  inv_voxel_size, max_range_sq, stencil: str = "nearby26",
                  num_probes: int = 8) -> torch.Tensor:
    """Mean squared NN distance of the inlier correspondences (squared
    distances, as the reference's GetFitnessScore accumulates them); +inf
    when there is none."""
    p_t = transform_points(t_mat, src)
    _, d2, ok = query_knn_any(m, p_t, inv_voxel_size, 1, stencil, num_probes)
    good = src_mask & ok[:, 0] & (d2[:, 0] <= max_range_sq)
    n = good.sum(dtype=torch.int32)
    s = torch.where(good, d2[:, 0], 0.0).sum()
    return torch.where(n > 0, s / torch.clamp(n, min=1), float("inf"))
