"""Region-sharded device map with halo exchange (port of
parallel/sharded_map.py).

Each rank owns the voxel blocks of the XY tiles assigned to it
(block-cyclic, `tile_owner`, a pure function of position) plus a halo one
stencil reach wide around them, so its local stencil queries are exact at
region borders. The halo exchange is a mask: the scan is replicated, and
each rank inserts only the points inside its region or halo. A GN step
evaluates on each rank only the source points its region owns at the
current pose, and sums the 6x6 normal equations over the ranks; the pose
update stays replicated.

Each rank holds its own `BlockMap` (the JAX package stacks them on a
leading mesh axis). Parity with one replicated map holds up to the order
of the sums, except in overfull voxels (more than `bucket_size` points),
which keep a subset that depends on insertion order.

Port note: `tile_owner` reproduces the JAX package's int32 arithmetic
exactly (wrapping products, the XOR of the two, `abs` with abs(INT_MIN) =
INT_MIN, floor `%`), computed in int64 with explicit 32-bit wrapping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..maps import block_map
from ..ops.lin3 import solve6_damped
from ..registration.gn import UPDATE_ICP, apply_update
from ..registration.residuals import point_to_plane_hg, point_to_point_hg, transform_points
from .comm import Mesh
from .sharded_gn import psum_hg


class ShardedMapConfig(NamedTuple):
    tile_size: float = 8.0  # XY tile edge (the shard partition unit)
    voxel_size: float = 1.0  # NN voxel; halo width = 2*voxel (stencil_halo)
    map_capacity: int = 16384  # VOXEL capacity PER RANK
    bucket_size: int = 8
    num_probes: int = 8
    stencil: str = "nearby26"


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their int32 two's-complement value, held in int64."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def tile_owner(pts: torch.Tensor, tile_size: float, n_dev: int) -> torch.Tensor:
    """Block-cyclic XY-tile -> rank assignment. [N, 3] -> [N] int32."""
    tx = torch.floor(pts[..., 0] / tile_size).to(torch.int32).to(torch.int64)
    ty = torch.floor(pts[..., 1] / tile_size).to(torch.int32).to(torch.int64)
    # mix the two coordinates so long straight paths still spread over ranks
    h = _wrap_i32(tx * 73856093) ^ _wrap_i32(ty * 19349663)
    h = torch.abs(h)
    h = torch.where(h == 2**31, -(2**31), h)  # int32 abs(INT_MIN) wraps
    return torch.remainder(h, n_dev).to(torch.int32)


def in_region_or_halo(pts: torch.Tensor, dev: int, tile_size: float, halo: float,
                      n_dev: int) -> torch.Tensor:
    """True where a point lies in rank `dev`'s region or within `halo` of
    it: any of the 9 XY offsets within +-halo lands in a tile `dev` owns.
    With halo < tile_size the +-halo square meets at most 4 tiles, each
    holding one of its corners, so the 9 samples are exact. [N, 3] -> [N]."""
    assert halo < tile_size, "halo sampling requires halo < tile_size"
    hit = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for dx in (-halo, 0.0, halo):
        for dy in (-halo, 0.0, halo):
            off = torch.tensor([dx, dy, 0.0], dtype=pts.dtype, device=pts.device)
            hit |= tile_owner(pts + off, tile_size, n_dev) == dev
    return hit


def stencil_halo(cfg: ShardedMapConfig) -> float:
    """Exact halo width for the voxel stencil: a query's candidates lie up
    to TWO voxel edges away in the infinity norm (the query at one edge of
    its voxel, the candidate at the far edge of the +-1 neighbour)."""
    return 2.0 * cfg.voxel_size


def create_sharded(mesh: Mesh, cfg: ShardedMapConfig, dtype=torch.float32) -> block_map.BlockMap:
    """This rank's empty map."""
    return block_map.create(cfg.map_capacity, cfg.bucket_size, dtype, mesh.device)


def insert_sharded(mesh: Mesh, cfg: ShardedMapConfig):
    """fn(local_map, pts, mask) -> local_map: the scan is replicated and
    each rank inserts its (region ∪ halo) points, with a full probe window
    of claim rounds (the no-drop guarantee `block_map.build` gives a
    one-shot load, which parity with the replicated map needs)."""
    inv = 1.0 / cfg.voxel_size

    def run(m, pts, msk):
        keep = msk & in_region_or_halo(pts, mesh.axis_index(), cfg.tile_size,
                                       stencil_halo(cfg), mesh.size)
        return block_map.insert(m, pts, keep, inv, num_probes=cfg.num_probes,
                                claim_rounds=cfg.num_probes)

    return run


def sharded_gn_step(mesh: Mesh, cfg: ShardedMapConfig, max_corr_dist_sq: float = 1.0,
                    iters: int = 8, residual: str = "point_to_point",
                    planar_thresh: float = 0.1):
    """fn(local_map, pts, mask, t0) -> t: scan-to-sharded-map GN. Each rank
    evaluates only the source points its region owns at the CURRENT pose
    (against its region+halo map, exact by the halo construction); the
    normal equations are summed over the ranks every iteration. The pose
    update is the ICP one ([t, r], right-multiplied rotation) for both
    residuals, as in the JAX package."""
    inv = 1.0 / cfg.voxel_size

    def run(m, pts, msk, t0):
        t_mat = t0
        for _ in range(iters):
            own = msk & (tile_owner(transform_points(t_mat, pts), cfg.tile_size, mesh.size)
                         == mesh.axis_index())
            if residual == "point_to_plane":
                hg = point_to_plane_hg(t_mat, pts, own, m, inv, planar_thresh, max_corr_dist_sq,
                                       cfg.stencil, cfg.num_probes)
            else:
                hg = point_to_point_hg(t_mat, pts, own, m, inv, max_corr_dist_sq, cfg.stencil,
                                       cfg.num_probes)
            h, g = psum_hg(mesh, hg.h, hg.g)
            t_mat = apply_update(t_mat, solve6_damped(h, g), UPDATE_ICP)
        return t_mat

    return run


def shard_occupancy(mesh: Mesh, m: block_map.BlockMap) -> torch.Tensor:
    """Occupied blocks of every rank, [size] on every rank (a load-balance
    diagnostic, and the proof that blocks live on different ranks)."""
    occ = torch.zeros(mesh.size, dtype=torch.int64, device=m.fp.device)
    occ[mesh.axis_index()] = (m.fp != 0).sum()
    return mesh.psum(occ)
