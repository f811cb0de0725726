"""Residuals and Jacobians for scan-to-map registration (port of
registration/residuals.py: the point-to-point, point-to-plane,
point-to-line and NDT families, over block, grid and voxel-hash maps).

For every padded source point at the current pose: a correspondence, a
residual, its 6-dof Jacobian and a validity mask, reduced to 6x6 normal
equations H and right-hand side g. Tangent/update conventions (gn.py):
  * point_to_point (the reference's icp_optimized.h): dx = [t(0:3), r(3:6)],
    P += dt, R := R Exp(dr);
  * point_to_plane / point_to_line (loam_*_kdtree.h): dx = [r(0:3), t(3:6)],
    R := Exp(dr) R (left), P += dt;
  * ndt (incremental_ndt.h): dx = [r, t], R := R Exp(dr), P += dt.

Candidate-set caching: one stencil gather (`gather_candidates`) caches the
M nearest map points per source point; every GN iteration re-selects the
nearest among them at the CURRENT pose (`*_hg_cand`), and re-fits the plane
or line there, so the expensive gather runs only when the pose has moved.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import so3_hat
from ..maps import block_map, ndt_map, voxel_hash
from ..ops import select
from ..ops.lin3 import inv3, sym3_eigvalsh, sym3_principal_eigvec
from ..ops.voxel import group_by_voxel


class HG(NamedTuple):
    """Reduced normal equations + per-iteration statistics."""

    h: torch.Tensor  # [6, 6]
    g: torch.Tensor  # [6]
    num_valid: torch.Tensor  # [] int32
    total_res: torch.Tensor  # [] summed residual magnitude


def _reduce_scalar(j: torch.Tensor, r: torch.Tensor, valid: torch.Tensor) -> HG:
    """Scalar residual rows: H = sum J J^T, g = -sum J r (masked)."""
    w = valid.to(j.dtype)
    jw = j * w[:, None]
    return HG(jw.T @ j, -(jw.T @ r), valid.sum(dtype=torch.int32),
              torch.sum(torch.abs(r) * w))


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
    point. On a block or grid map: voxel-sort the transformed points,
    gather the 8-block cover per unique voxel (`block_map.gather_cover_any`),
    then `select.fused_select` (the CUDA kernel on the card, its plain
    version on the CPU); results stay in sorted order. On a `VoxelHashMap`:
    the per-voxel stencil gather of `voxel_hash.query_knn`, in the original
    order."""
    p_t = transform_points(t_mat, src)
    if isinstance(m, voxel_hash.VoxelHashMap):
        nbrs, _, ok = voxel_hash.query_knn(m, p_t, inv_voxel_size, k=m_cand, stencil=stencil,
                                           num_probes=num_probes, group_capacity=group_capacity)
        return CandSet(px=nbrs[..., 0], py=nbrs[..., 1], pz=nbrs[..., 2],
                       valid=ok & src_mask[:, None], src=src, src_mask=src_mask)
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
    """Stencil k-NN dispatched by map type: `voxel_hash.query_knn` on a
    `VoxelHashMap`, else `block_map.query_knn` (block and grid maps)."""
    mod = voxel_hash if isinstance(m, voxel_hash.VoxelHashMap) else block_map
    return mod.query_knn(m, queries, inv_voxel_size, k=k, stencil=stencil,
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
    else:  # ascending, ties to the lower lane (lax.top_k's order; topk's is unspecified)
        kd2, idx = torch.sort(d2, dim=1, stable=True)
        kd2, idx = kd2[:, :k], idx[:, :k]
    nbrs = torch.stack([_take_lanes(cand.px, idx), _take_lanes(cand.py, idx),
                        _take_lanes(cand.pz, idx)], dim=-1)
    return p_t, nbrs, kd2, torch.isfinite(kd2)


class P2PCorr(NamedTuple):
    q: torch.Tensor  # [N, 3] matched map point
    valid: torch.Tensor  # [N]


def point_to_point_corr(t_mat, src, src_mask, m, inv_voxel_size, max_corr_dist_sq,
                        stencil: str = "nearby26", num_probes: int = 8,
                        group_capacity: int | None = None) -> P2PCorr:
    """Nearest map point within the correspondence distance, at the gather
    pose (the reference's optimized-ICP search)."""
    p_t = transform_points(t_mat, src)
    nbrs, d2, ok = query_knn_any(m, p_t, inv_voxel_size, 1, stencil, num_probes,
                                 group_capacity)
    return P2PCorr(q=nbrs[:, 0], valid=src_mask & ok[:, 0] & (d2[:, 0] <= max_corr_dist_sq))


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


def point_to_point_hg(t_mat, src, src_mask, m, inv_voxel_size, max_corr_dist_sq,
                      stencil: str = "nearby26", num_probes: int = 8) -> HG:
    """One-shot gather + linearize (the reference's per-iteration search)."""
    corr = point_to_point_corr(t_mat, src, src_mask, m, inv_voxel_size, max_corr_dist_sq,
                               stencil, num_probes)
    return point_to_point_hg_corr(t_mat, src, corr)


def _einsum_small(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(eq, a, b)` over a few products a term (the LOAM fits'
    small sums). On a CUDA tensor each entry is summed in float64 from the
    exact products and rounded once to the inputs' dtype: far from the
    origin A^T A's determinant cancels and the plane gates follow the last
    bits, cuBLAS's order for these tiny batched products is none a kernel
    can repeat (on an H100 a probe matched no sequential order, and its
    choice moved with the batch), and csrc/gn_loop.cu rounds the same sums once.
    On the CPU the library's order, which the tests hold against the JAX
    package."""
    if a.is_cuda:
        return torch.einsum(eq, a.double(), b.double()).to(a.dtype)
    return torch.einsum(eq, a, b)


def _sum_small(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`torch.sum(x, dim)` over a few terms, rounded once on a CUDA tensor
    (see `_einsum_small`)."""
    return torch.sum(x.double(), dim=dim).to(x.dtype) if x.is_cuda else torch.sum(x, dim=dim)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.b over the last axis, rounded once on a CUDA tensor (see
    `_einsum_small`)."""
    if a.is_cuda:
        return torch.sum(a.double() * b.double(), dim=-1).to(a.dtype)
    return torch.sum(a * b, dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis: sqrt of `_dot(v, v)` on a CUDA tensor."""
    return torch.sqrt(_dot(v, v)) if v.is_cuda else torch.linalg.vector_norm(v, dim=-1)


def fit_plane_5nn(nbrs: torch.Tensor, ok: torch.Tensor, plane_thresh):
    """Closed-form plane fit through k neighbours, solving A x = -1 (the
    plane n.p = -1, as the reference parameterizes it). Returns (unit
    normal [N,3], the first neighbour [N,3], valid [N]); valid when all k
    neighbours are ok and each residual |a_i.x + 1|/|x| <= plane_thresh.
    A^T A is inverted in world coordinates, in the input dtype; on a CUDA
    tensor its entries and the small products after it are rounded once
    (`_einsum_small`)."""
    eye = torch.eye(3, dtype=nbrs.dtype, device=nbrs.device)
    a = nbrs * ok.to(nbrs.dtype)[..., None]  # masked rows contribute zero
    ata = _einsum_small("nka,nkb->nab", a, a)
    atb = -_sum_small(a, 1)  # A^T (-1)
    # regularized: masked or degenerate systems must not produce NaN
    coef = _einsum_small("nab,nb->na", inv3(ata + 1e-9 * eye), atb)
    safe = torch.clamp(_norm(coef), min=1e-12)
    resid = torch.abs(_einsum_small("nka,na->nk", nbrs, coef) + 1.0) / safe[:, None]
    fit_ok = torch.all(ok & (resid <= plane_thresh), dim=-1) & torch.all(ok, dim=-1)
    return coef / safe[:, None], nbrs[:, 0], fit_ok


class PlaneCorr(NamedTuple):
    normal: torch.Tensor  # [N, 3] unit plane normal
    q0: torch.Tensor  # [N, 3] plane anchor point
    valid: torch.Tensor  # [N]


def _plane_gates(p_t, src, nbrs, ok, plane_thresh) -> PlaneCorr:
    """Plane fit through the neighbours, valid where the fit passes and the
    point is not rejected as near: |src| < 81 d^2, with the body-frame
    source point and d its transformed point's distance to the plane."""
    normal, q0, fit_ok = fit_plane_5nn(nbrs, ok, plane_thresh)
    d = _dot(p_t - q0, normal)
    near_reject = _norm(src) < 81.0 * d * d
    return PlaneCorr(normal=normal, q0=q0, valid=fit_ok & ~near_reject)


def point_to_plane_hg_cand(t_mat: torch.Tensor, cand: CandSet, plane_thresh,
                           max_search_dist_sq) -> HG:
    """Point-to-plane on the candidate cache: 5-NN re-selection, plane re-fit
    and every gate at the CURRENT pose."""
    p_t, nbrs, d2, ok = _select_knn(t_mat, cand, 5)
    corr = _plane_gates(p_t, cand.src, nbrs, ok & (d2 <= max_search_dist_sq), plane_thresh)
    return point_to_plane_hg_corr(t_mat, cand.src, corr)


def point_to_plane_corr(t_mat, src, src_mask, m, inv_voxel_size, plane_thresh,
                        max_search_dist_sq, stencil: str = "nearby26", num_probes: int = 8,
                        group_capacity: int | None = None) -> PlaneCorr:
    """5-NN plane fit + gates at the gather pose: the 5th-NN distance gate,
    the plane-fit residual gate and the near-point rejection. On CUDA
    tensors p_t is taken in csrc/gn_loop.cu's fixed order
    (`_transform_fixed`), which the loop closure's refine kernel repeats, so
    that both gather the same stencil for a point one ulp from a voxel
    face."""
    p_t = _transform_fixed(t_mat, src)
    nbrs, d2, ok = query_knn_any(m, p_t, inv_voxel_size, 5, stencil, num_probes,
                                 group_capacity)
    corr = _plane_gates(p_t, src, nbrs, ok & (d2 <= max_search_dist_sq), plane_thresh)
    return corr._replace(valid=src_mask & corr.valid)


def point_to_plane_hg_corr(t_mat: torch.Tensor, src: torch.Tensor, corr: PlaneCorr) -> HG:
    """Point-to-plane linearization: residual |d| with d = (p_t - q0).n;
    J = [sign(d) (-hat(R p)^T n) | sign(d) n] (dx = [r, t])."""
    p_t = transform_points(t_mat, src)
    d = _dot(p_t - corr.q0, corr.normal)
    sign = torch.where(d > 0, 1.0, -1.0).to(src.dtype)
    rp = src @ t_mat[:3, :3].T  # R p, no translation
    j_rot = -torch.einsum("nij,nj->ni", so3_hat(rp).transpose(-1, -2),
                          corr.normal) * sign[:, None]
    jac = torch.cat([j_rot, corr.normal * sign[:, None]], dim=-1)  # [N, 6]
    return _reduce_scalar(jac, torch.abs(d), corr.valid)


def point_to_plane_hg(t_mat, src, src_mask, m, inv_voxel_size, plane_thresh,
                      max_search_dist_sq, stencil: str = "nearby26",
                      num_probes: int = 8) -> HG:
    """One-shot gather + linearize."""
    corr = point_to_plane_corr(t_mat, src, src_mask, m, inv_voxel_size, plane_thresh,
                               max_search_dist_sq, stencil, num_probes)
    return point_to_plane_hg_corr(t_mat, src, corr)


class LineCorr(NamedTuple):
    center: torch.Tensor  # [N, 3] 5-NN centroid
    n_dir: torch.Tensor  # [N, 3] line direction (principal eigenvector)
    valid: torch.Tensor  # [N]


def _fit_line(nbrs: torch.Tensor, ok: torch.Tensor, line_ratio_thresh):
    """5-NN covariance line fit: (centroid, principal direction, line gate
    lambda_2 > ratio * lambda_1)."""
    w = ok.to(nbrs.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    center = _sum_small(nbrs * w, 1) / cnt
    centered = (nbrs - center[:, None, :]) * w
    cov = _einsum_small("nka,nkb->nab", centered, centered) / 5.0
    lams = sym3_eigvalsh(cov)
    return center, sym3_principal_eigvec(cov), lams[:, 2] > line_ratio_thresh * lams[:, 1]


def point_to_line_hg_cand(t_mat: torch.Tensor, cand: CandSet, line_ratio_thresh,
                          max_search_dist_sq) -> HG:
    """Point-to-line on the candidate cache: 5-NN re-selection and the
    covariance line re-fit at the CURRENT pose."""
    _, nbrs, d2, ok = _select_knn(t_mat, cand, 5)
    all_ok = torch.all(ok & (d2 <= max_search_dist_sq), dim=-1)
    center, n_dir, line_ok = _fit_line(nbrs, ok, line_ratio_thresh)
    corr = LineCorr(center=center, n_dir=n_dir, valid=all_ok & line_ok)
    return point_to_line_hg_corr(t_mat, cand.src, corr)


def point_to_line_corr(t_mat, src, src_mask, m, inv_voxel_size, line_ratio_thresh,
                       max_search_dist_sq, stencil: str = "nearby26", num_probes: int = 8,
                       group_capacity: int | None = None) -> LineCorr:
    """5-NN covariance line fit at the gather pose: the direction is the
    principal eigenvector, valid when lambda_2 > ratio * lambda_1 (the
    reference's singular values of the covariance equal its eigenvalues)."""
    p_t = transform_points(t_mat, src)
    nbrs, d2, ok = query_knn_any(m, p_t, inv_voxel_size, 5, stencil, num_probes,
                                 group_capacity)
    all_ok = torch.all(ok & (d2 <= max_search_dist_sq), dim=-1)
    center, n_dir, line_ok = _fit_line(nbrs, ok, line_ratio_thresh)
    return LineCorr(center=center, n_dir=n_dir, valid=src_mask & all_ok & line_ok)


def point_to_line_hg_corr(t_mat: torch.Tensor, src: torch.Tensor, corr: LineCorr) -> HG:
    """Point-to-line linearization: residual |(p_t - c) x n|;
    J = [ (hat(n) hat(R p))^T u | -hat(n)^T u ] with u the unit residual
    direction (dx = [r, t])."""
    diff = transform_points(t_mat, src) - corr.center
    cx = torch.linalg.cross(diff, corr.n_dir, dim=-1)
    dist = torch.linalg.vector_norm(cx, dim=-1)
    u = cx / torch.clamp(dist, min=1e-9)[:, None]
    valid = corr.valid & (dist > 1e-9)
    n_hat = so3_hat(corr.n_dir)
    j_rot = torch.einsum("nji,nj->ni", n_hat @ so3_hat(src @ t_mat[:3, :3].T), u)
    j_tr = torch.einsum("nji,nj->ni", -n_hat, u)
    return _reduce_scalar(torch.cat([j_rot, j_tr], dim=-1), dist, valid)


def point_to_line_hg(t_mat, src, src_mask, m, inv_voxel_size, line_ratio_thresh,
                     max_search_dist_sq, stencil: str = "nearby26",
                     num_probes: int = 8) -> HG:
    """One-shot gather + linearize."""
    corr = point_to_line_corr(t_mat, src, src_mask, m, inv_voxel_size, line_ratio_thresh,
                              max_search_dist_sq, stencil, num_probes)
    return point_to_line_hg_corr(t_mat, src, corr)


class NdtCorr(NamedTuple):
    mu: torch.Tensor  # [N, 7, 3] voxel means
    lam: torch.Tensor  # [N, 7, 3, 3] voxel information matrices
    valid: torch.Tensor  # [N, 7]


def _transform_fixed(t_mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """`transform_points`. On a CUDA tensor each component in float64 from
    the exact float32 products, ((R_i0 s_0 + R_i1 s_1) + R_i2 s_2) + t_i,
    rounded once: the order csrc/gn_loop.cu's NDT and refine rows repeat,
    so that both put a point in the same voxel (floor is discontinuous at a voxel face,
    and cuBLAS's order for `pts @ R.T` is none a kernel can repeat). On the
    CPU the library's order, which the tests hold against the JAX package."""
    if not pts.is_cuda:
        return transform_points(t_mat, pts)
    r, t, s = t_mat[:3, :3].double(), t_mat[:3, 3].double(), pts.double()
    p = s[:, 0:1] * r[:, 0] + s[:, 1:2] * r[:, 1]
    return ((p + s[:, 2:3] * r[:, 2]) + t).to(pts.dtype)


def _mahalanobis64(err: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """e^T lam e over the last axes ([..., 3] and [..., 3, 3]) in float64
    from the exact float32 products, q_a = (lam_a0 e_0 + lam_a1 e_1) +
    lam_a2 e_2, then (e_0 q_0 + e_1 q_1) + e_2 q_2, rounded once: the order
    csrc/gn_loop.cu's NDT rows repeat, as the outlier gate compares it with
    a threshold (the CUDA route of `ndt_corr`)."""
    e, lm = err.double(), lam.double()
    q = lm[..., 0] * e[..., None, 0] + lm[..., 1] * e[..., None, 1]
    q = q + lm[..., 2] * e[..., None, 2]
    res = e[..., 0] * q[..., 0] + e[..., 1] * q[..., 1]
    return (res + e[..., 2] * q[..., 2]).to(err.dtype)


def ndt_corr(t_mat, src, src_mask, m: ndt_map.NdtMap, inv_voxel_size, outlier_thresh,
             num_probes: int = 8) -> NdtCorr:
    """7-voxel stencil Gaussian lookup and the outlier gate on the
    Mahalanobis residual, at the gather pose. On CUDA tensors p_t and the
    residual are taken in csrc/gn_loop.cu's fixed order (`_transform_fixed`,
    `_mahalanobis64`)."""
    p_t = _transform_fixed(t_mat, src)
    mu, lam, valid_v = ndt_map.query_stencil(m, p_t, inv_voxel_size, num_probes)
    err = p_t[:, None, :] - mu
    res = (_mahalanobis64(err, lam) if err.is_cuda
           else torch.einsum("nva,nvab,nvb->nv", err, lam, err))
    valid = valid_v & src_mask[:, None] & (res <= outlier_thresh) & torch.isfinite(res)
    # an under-populated slot's info can be inf/NaN; it is gated invalid
    # above, but NaN * 0 would still poison the masked reduction
    lam = torch.where(valid[..., None, None] & torch.isfinite(lam), lam, 0.0)
    mu = torch.where(valid[..., None], mu, p_t[:, None, :])
    return NdtCorr(mu=mu, lam=lam, valid=valid)


def ndt_hg_corr(t_mat: torch.Tensor, src: torch.Tensor, corr: NdtCorr) -> HG:
    """NDT Mahalanobis linearization: e = p_t - mu per stencil voxel,
    J = [-R hat(p) | I] (dx = [r, t])."""
    n = src.shape[0]
    err = _transform_fixed(t_mat, src)[:, None, :] - corr.mu  # [N, 7, 3]
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    jac = torch.cat([-torch.einsum("ij,njk->nik", t_mat[:3, :3], so3_hat(src)),
                     eye.expand(n, 3, 3)], dim=-1)  # [N, 3, 6]
    v = err.shape[1]
    jac7 = jac[:, None].expand(n, v, 3, 6).reshape(n * v, 3, 6)
    return _reduce_vec3(jac7, err.reshape(n * v, 3), corr.lam.reshape(n * v, 3, 3),
                        corr.valid.reshape(n * v))


def ndt_hg(t_mat, src, src_mask, m: ndt_map.NdtMap, inv_voxel_size, outlier_thresh,
           num_probes: int = 8) -> HG:
    """One-shot gather + linearize."""
    return ndt_hg_corr(t_mat, src, ndt_corr(t_mat, src, src_mask, m, inv_voxel_size,
                                            outlier_thresh, num_probes))


def merge_hg(*hgs: HG) -> HG:
    """Sum of several normal-equation sets (LoamFull: lines + planes)."""
    return HG(*(sum(getattr(x, f) for x in hgs) for f in HG._fields))


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
