"""Distributed pose-graph optimization over a mesh (port of
backend/distributed.py).

  * The EDGES are sharded over the mesh: each rank evaluates residuals,
    Jacobians and the per-edge 6x6 blocks of its own contiguous block of
    edges. Poses and `pose_mask` are replicated.
  * The Hessian is never dense: per-keyframe diagonal blocks and per-edge
    off-diagonal blocks that stay on the rank owning the edge.
  * The Newton system is solved by block-Jacobi preconditioned CG:
      - the diagonal blocks are summed and each rank OWNS the blocks of its
        keyframe range (`psum_scatter`), Jacobi-equilibrates and inverts
        them, and replicates the result by a zero-filled slice write and a
        `psum`;
      - each CG matvec is local per-edge block products and one `psum` of
        the [K, 6] vector.
Gauge: vertex 0 is fixed by masking its update rows.

Port notes: the JAX `while_loop` of the CG exits on the relative residual.
Here every iteration's update is masked by that test (so the result is the
JAX loop's), and the host reads whether any rank is still active only every
`_CHECK_EVERY` iterations, from a psum, so all ranks leave at the same
collective. The owner's 6x6 blocks are inverted by `inv_ex` (no sync).
"""

from __future__ import annotations

import torch

from ..core.lie import se3_exp
from ..parallel.comm import Mesh, make_mesh
from .pose_graph import PoseGraph, _edge_residuals

__all__ = ["AXIS", "make_mesh", "sharded_optimize"]

AXIS = "graph"

# CG iterations between two host reads of the exit test
_CHECK_EVERY = 16


def _edge_blocks(g: PoseGraph, poses: torch.Tensor):
    """Per-edge H blocks and b contributions for this rank's edge shard."""
    e, j_i, j_j = _edge_residuals(g._replace(poses=poses))
    lam = g.edge_info * g.edge_mask.to(poses.dtype)[:, None]
    jtl_i = j_i.transpose(-1, -2) * lam[:, None, :]  # [E, 6, 6]
    jtl_j = j_j.transpose(-1, -2) * lam[:, None, :]
    # h_ji = h_ij^T (H symmetric); never materialized separately
    return (jtl_i @ j_i, jtl_i @ j_j, jtl_j @ j_j,
            torch.einsum("eab,eb->ea", jtl_i, e), torch.einsum("eab,eb->ea", jtl_j, e))


def _solve_pcg(mesh: Mesh, matvec, precond, b: torch.Tensor, iterations: int,
               rtol: float = 1e-6):
    """Conjugate gradients on H dx = b with a preconditioner, ending when
    the residual falls to rtol of the start or after `iterations`.
    Returns (x, the iterations run). x, r and p are replicated, so the dot
    products need no psum beyond the matvec's."""
    x = torch.zeros_like(b)
    r = b
    p = z = precond(r)
    rz = torch.dot(r, z)
    rr = rr0 = torch.dot(r, r)
    thresh = rtol * rtol * rr0
    tiny = 1e-30
    i = torch.zeros((), dtype=torch.int32, device=b.device)
    for it in range(iterations):
        if it % _CHECK_EVERY == 0 and it and not bool(mesh.psum((rr > thresh).to(torch.int32))):
            break
        active = rr > thresh
        hp = matvec(p)
        denom = torch.dot(p, hp)
        alpha = torch.where(torch.abs(denom) > tiny, rz / denom, 0.0)
        x_n = x + alpha * p
        r_n = r - alpha * hp
        z = precond(r_n)
        rz_n = torch.dot(r_n, z)
        beta = torch.where(torch.abs(rz) > tiny, rz_n / rz, 0.0)
        p_n = z + beta * p
        x, r, p = (torch.where(active, a, o) for a, o in ((x_n, x), (r_n, r), (p_n, p)))
        rz = torch.where(active, rz_n, rz)
        rr = torch.where(active, torch.dot(r_n, r_n), rr)
        i = i + active.to(torch.int32)
    return x, i


def sharded_optimize(mesh: Mesh, g: PoseGraph, iterations: int = 15, damping: float = 1e-6,
                     cg_iterations: int = 64, cg_iters_out: list | None = None) -> PoseGraph:
    """Block-sparse Gauss-Newton/PCG over the pose graph, edges sharded.

    Every rank passes the same (replicated) graph. Edge and keyframe
    capacities must divide by the mesh size (the preconditioner blocks are
    keyframe-sharded). Returns the graph with optimized poses (replicated).
    `cg_iters_out`, if given, receives one [] int32 tensor per GN iteration:
    the CG iterations it ran."""
    n_dev = mesh.size
    e_cap = g.edge_i.shape[0]
    k = g.poses.shape[0]
    assert e_cap % n_dev == 0, f"edge capacity {e_cap} % mesh {n_dev} != 0"
    assert k % n_dev == 0, f"vertex capacity {k} % mesh {n_dev} != 0"
    dtype, dev = g.poses.dtype, g.poses.device

    local = g._replace(**{f: mesh.shard_rows(getattr(g, f)) for f in
                          ("edge_i", "edge_j", "edge_meas", "edge_info", "edge_mask")})
    ei, ej = local.edge_i.long(), local.edge_j.long()
    free = g.pose_mask.clone()
    free[0] = False  # vertex 0 fixed (gauge)
    fmask = free.to(dtype)[:, None]  # [K, 1]
    kp = k // n_dev
    rows = slice(mesh.axis_index() * kp, (mesh.axis_index() + 1) * kp)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def replicate(own: torch.Tensor) -> torch.Tensor:
        """Owned rows [K/P, ...] -> all rows [K, ...] on every rank."""
        full = torch.zeros((k,) + own.shape[1:], dtype=dtype, device=dev)
        full[rows] = own
        return mesh.psum(full)

    poses = g.poses
    for _ in range(iterations):
        h_ii, h_ij, h_jj, b_i, b_j = _edge_blocks(local, poses)

        # gradient: local scatter + one [K, 6] psum
        b = torch.zeros((k, 6), dtype=dtype, device=dev)
        b.index_add_(0, ei, b_i).index_add_(0, ej, b_j)
        b = -mesh.psum(b) * fmask

        # block diagonal of H: local scatter, summed and owned by keyframe range
        hdiag = torch.zeros((k, 6, 6), dtype=dtype, device=dev)
        hdiag.index_add_(0, ei, h_ii).index_add_(0, ej, h_jj)
        hdiag_own = mesh.psum_scatter(hdiag)  # [K/P, 6, 6]

        # Jacobi equilibration D H D with D = diag(H)^-1/2 (f32 has no
        # headroom for the O(info * r^2) lever-arm entries), d computed on
        # the owner and replicated
        d_own = torch.rsqrt(torch.clamp(torch.diagonal(hdiag_own, dim1=-2, dim2=-1), min=1e-12))
        d = torch.where(fmask > 0, replicate(d_own), 1.0)  # [K, 6]
        di, dj = d[ei], d[ej]
        h_ii_s = di[:, :, None] * h_ii * di[:, None, :]
        h_ij_s = di[:, :, None] * h_ij * dj[:, None, :]
        h_jj_s = dj[:, :, None] * h_jj * dj[:, None, :]

        # preconditioner: the equilibrated diagonal blocks (unit diagonal),
        # damped and inverted on the owner, then replicated
        hdiag_s = d_own[:, :, None] * hdiag_own * d_own[:, None, :]
        m_inv = replicate(torch.linalg.inv_ex(hdiag_s + damping * eye6).inverse)

        def matvec(x):
            # (D H D) x from this rank's equilibrated edge blocks
            x = x.view(k, 6)
            xi, xj = x[ei], x[ej]
            y = torch.zeros((k, 6), dtype=dtype, device=dev)
            y.index_add_(0, ei, torch.einsum("eab,eb->ea", h_ii_s, xi)
                         + torch.einsum("eab,eb->ea", h_ij_s, xj))
            y.index_add_(0, ej, torch.einsum("eab,eb->ea", h_jj_s, xj)
                         + torch.einsum("eba,eb->ea", h_ij_s, xi))  # H_ji = H_ij^T
            y = mesh.psum(y) + damping * x
            # gauge: fixed and unused rows pinned to the identity
            return (y * fmask + x * (1.0 - fmask)).reshape(-1)

        def precond(r):
            return (torch.einsum("kab,kb->ka", m_inv, r.view(k, 6) * fmask) * fmask).reshape(-1)

        y, cg_iters = _solve_pcg(mesh, matvec, precond, (b * d).reshape(-1), cg_iterations)
        if cg_iters_out is not None:
            cg_iters_out.append(cg_iters)
        dx = d * y.view(k, 6) * fmask  # undo the equilibration
        poses = torch.where(free[:, None, None], se3_exp(dx) @ poses, poses)
    return g._replace(poses=poses)
