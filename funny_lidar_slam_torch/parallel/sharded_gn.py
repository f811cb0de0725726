"""Data-parallel scan matching over a mesh (port of parallel/sharded_gn.py).

Each rank evaluates the point-to-point residuals and Jacobians of its
contiguous block of the source points against a replicated
`VoxelHashMap`; the 6x6 normal equations are summed over the ranks with one
`all_reduce` an iteration, and the solve and the pose update stay
replicated, so no rank reads anything back to the host.
"""

from __future__ import annotations

import torch

from ..ops.lin3 import solve6_damped
from ..registration.gn import UPDATE_ICP, apply_update
from ..registration.residuals import point_to_point_hg
from .comm import Mesh, make_mesh

__all__ = ["make_mesh", "sharded_icp_step"]


def psum_hg(mesh: Mesh, h: torch.Tensor, g: torch.Tensor):
    """(H, g) summed over the ranks in one all_reduce."""
    hg = mesh.psum(torch.cat([h.reshape(-1), g]))
    return hg[:36].view(6, 6), hg[36:]


def sharded_icp_step(mesh: Mesh, max_corr_dist_sq: float, inv_voxel_size: float,
                     iters: int = 8, stencil: str = "nearby26"):
    """fn(map, points [N,3], mask [N], t0 [4,4]) -> t [4,4]: `iters`
    point-to-point GN iterations with the points split over the mesh and
    the map replicated (every rank passes the same map, points and t0)."""

    def run(m, points, mask, t0):
        pts, msk = mesh.shard_rows(points), mesh.shard_rows(mask)
        t_mat = t0
        for _ in range(iters):
            hg = point_to_point_hg(t_mat, pts, msk, m, inv_voxel_size, max_corr_dist_sq,
                                   stencil)
            h, g = psum_hg(mesh, hg.h, hg.g)
            t_mat = apply_update(t_mat, solve6_damped(h, g), UPDATE_ICP)
        return t_mat

    return run
