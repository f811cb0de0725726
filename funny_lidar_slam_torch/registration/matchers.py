"""Scan-to-map matchers (port of the IcpOptimized part of
registration/matchers.py).

`IcpMatcher` is point-to-point ICP over the dense grid map with the
incremental window policy: each converged scan that passes the insertion
gate is voxel-filtered and inserted with `max_age = local_map_size` epoch
eviction. The hashed block map, the rebuild window policy and the other
matchers (LOAM, point-to-plane, NDT) are later slices of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cloud import Cloud, transform_cloud
from ..core.device import resolve_device
from ..core.lie import rotation_to_rpy
from ..maps import grid_map
from ..ops.voxel import voxel_downsample
from .gn import GNConfig, GNResult, run_gn_corr
from .residuals import gather_candidates, point_to_point_hg_cand

_LATER = "not ported yet: the hashed block map and the rebuild window policy are a later slice"


def _source_radius(points, mask):
    """Max range of valid source points: the rotation-displacement radius of
    the GN trust-region skip."""
    r2 = torch.sum(points * points, dim=-1)
    return torch.sqrt(torch.max(torch.where(mask, r2, torch.zeros_like(r2))))


def need_add_cloud(t_mat, last_t, dist_thresh, rot_thresh):
    """Map-insertion gate: translation delta > d or any RPY of the delta
    rotation > r."""
    d = torch.linalg.vector_norm(t_mat[:3, 3] - last_t[:3, 3])
    rpy = torch.abs(rotation_to_rpy(last_t[:3, :3].T @ t_mat[:3, :3]))
    return (d > dist_thresh) | torch.any(rpy > rot_thresh)


class WindowMapState(NamedTuple):
    m: grid_map.GridMap
    window_pts: torch.Tensor  # [1, 1, 3] placeholder (incremental policy)
    window_mask: torch.Tensor  # [1, 1]
    head: torch.Tensor  # [] int32 ring position
    filled: torch.Tensor  # [] int32 number of valid ring entries
    last_added: torch.Tensor  # [4, 4]


def window_create(window_size, cloud_cap, map_capacity, bucket, dtype=torch.float32,
                  incremental=False, grid_dims=None, device="cpu") -> WindowMapState:
    """Empty window state over the dense grid. The incremental policy never
    re-reads inserted clouds, so the ring buffers are 1-element
    placeholders, as in the JAX package."""
    del window_size, cloud_cap, map_capacity
    if grid_dims is None or not incremental:
        raise NotImplementedError(_LATER)
    return WindowMapState(
        m=grid_map.create(tuple(grid_dims), bucket, dtype, device),
        window_pts=torch.zeros((1, 1, 3), dtype=dtype, device=device),
        window_mask=torch.zeros((1, 1), dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        filled=torch.zeros((), dtype=torch.int32, device=device),
        last_added=torch.eye(4, dtype=dtype, device=device),
    )


def window_add(s: WindowMapState, cloud_world: Cloud, t_mat, map_filter_size,
               nn_inv_voxel, merged_capacity, num_probes: int = 8,
               window_size: int = 0) -> WindowMapState:
    """Incremental policy (`window_size > 0`): voxel-filter the new cloud and
    scatter-insert it with `max_age=window_size` epoch eviction."""
    del merged_capacity, num_probes
    if window_size <= 0 or not isinstance(s.m, grid_map.GridMap):
        raise NotImplementedError(_LATER)
    cap = cloud_world.points.shape[0]
    ds = voxel_downsample(cloud_world.points, cloud_world.mask, map_filter_size, cap)
    m = grid_map.insert(s.m, ds.points, ds.mask, nn_inv_voxel, max_age=window_size)
    return s._replace(m=m, last_added=t_mat,
                      filled=torch.clamp(s.filled + 1, max=window_size))


class IcpConfig(NamedTuple):
    max_iterations: int = 30
    local_map_size: int = 25
    map_filter_size: float = 0.5
    source_filter_size: float = 0.4
    max_correspond_distance: float = 1.0
    position_converge_thresh: float = 0.01
    rotation_converge_thresh: float = 0.05
    rot_thresh_add_cloud: float = 0.2
    dist_thresh_add_cloud: float = 1.0
    # capacities (static)
    source_capacity: int = 16384
    cloud_capacity: int = 16384
    merged_capacity: int = 131072
    map_capacity: int = 65536
    bucket_size: int = 8
    nn_voxel_size: float = 1.0
    stencil: str = "nearby26"
    num_probes: int = 8
    is_localization_mode: bool = False
    incremental_map: bool = True
    # candidate-cache GN schedule (gn.run_gn_corr + residuals.CandSet)
    corr_every: int = 10
    cand_k: int = 16
    # voxel-deduplicated stencil gather: one cover lookup per unique voxel
    group_capacity: int = 8192
    # trust-region re-gather skip (GNConfig.skip_regather_dist); 0 disables
    regather_skip_dist: float = 0.2
    regather_radius: float = 20.0
    # "grid" is the dense modulo grid (maps/grid_map.py); grid_dims are
    # BLOCKS (2x2x2 voxels) per axis. The default "block" layout is the
    # hashed block map, a later slice of the port.
    map_layout: str = "block"
    grid_dims: tuple = (96, 96, 24)


class IcpMatcher:
    """Point-to-point ICP over the dense grid map. Runs on `device`
    (default: CUDA; pass device='cpu' for the CPU)."""

    def __init__(self, cfg: IcpConfig, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.gn_cfg = GNConfig(
            max_iters=cfg.max_iterations,
            rotation_eps=cfg.rotation_converge_thresh,
            position_eps=cfg.position_converge_thresh,
            use_stall_check=False,
            corr_every=cfg.corr_every,
            skip_regather_dist=cfg.regather_skip_dist,
            regather_radius=cfg.regather_radius,
        )

    def _window_size(self) -> int:
        c = self.cfg
        return c.local_map_size if c.incremental_map else 0

    def create_state(self) -> WindowMapState:
        c = self.cfg
        return window_create(c.local_map_size, c.cloud_capacity, c.map_capacity,
                             c.bucket_size, self.dtype, incremental=c.incremental_map,
                             grid_dims=c.grid_dims if c.map_layout == "grid" else None,
                             device=self.device)

    def _source(self, cloud: Cloud):
        c = self.cfg
        return voxel_downsample(cloud.points, cloud.mask, c.source_filter_size,
                                c.source_capacity)

    def _as_pose(self, t_mat) -> torch.Tensor:
        return torch.as_tensor(t_mat, dtype=self.dtype, device=self.device)

    def match(self, s: WindowMapState, cloud: Cloud, t_init) -> tuple[WindowMapState, GNResult]:
        t_init = self._as_pose(t_init)
        c = self.cfg
        src = self._source(cloud)
        inv = 1.0 / c.nn_voxel_size
        gc = c.group_capacity or None

        def corr_fn(t_mat):
            return gather_candidates(t_mat, src.points, src.mask, s.m, inv, c.cand_k,
                                     c.stencil, c.num_probes, group_capacity=gc)

        def hg_fn(t_mat, cand):
            return point_to_point_hg_cand(t_mat, cand, c.max_correspond_distance**2)

        res = run_gn_corr(corr_fn, hg_fn, t_init, self.gn_cfg,
                          regather_radius=_source_radius(src.points, src.mask))
        if c.is_localization_mode:
            return s, res
        do_add = res.converged & need_add_cloud(
            res.t_mat, s.last_added, c.dist_thresh_add_cloud, c.rot_thresh_add_cloud)
        if bool(do_add):
            world = transform_cloud(res.t_mat, Cloud(src.points, src.mask))
            s = window_add(s, world, res.t_mat, c.map_filter_size, inv,
                           c.merged_capacity, c.num_probes, window_size=self._window_size())
        return s, res

    def add_first(self, s: WindowMapState, cloud: Cloud, t_mat) -> WindowMapState:
        """Seed the map with the first (transformed) cloud."""
        t_mat = self._as_pose(t_mat)
        c = self.cfg
        src = self._source(cloud)
        world = transform_cloud(t_mat, Cloud(src.points, src.mask))
        return window_add(s, world, t_mat, c.map_filter_size, 1.0 / c.nn_voxel_size,
                          c.merged_capacity, c.num_probes, window_size=self._window_size())
