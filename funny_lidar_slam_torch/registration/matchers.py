"""Scan-to-map matchers (port of registration/matchers.py).

  mode string          matcher
  -----------          -------
  IcpOptimized         IcpMatcher (point-to-point)
  PointToPlane_KdTree  PointToPlaneMatcher, window mode
  PointToPlane_IVOX    PointToPlaneMatcher, ivox mode
  LoamFull_KdTree      LoamFullMatcher (corner lines + planar planes)
  IncrementalNDT       NdtMatcher (voxel Gaussians, maps/ndt_map.py)

Map policies, over the hashed block map (`maps/block_map.py`, the default)
or the dense grid (`maps/grid_map.py`):
  * window, incremental (`incremental_map=True`): each converged scan that
    passes the insertion gate is voxel-filtered and inserted with
    `max_age = local_map_size` epoch eviction;
  * window, rebuild: a ring buffer of the last W inserted clouds, merged,
    voxel filtered and rebuilt into a fresh block map on every insertion;
  * ivox: every converged scan is inserted with the closer-to-center rule.
Localization mode freezes the map (`set_map` replaces it wholesale) and
adds `fitness`. The NDT matcher inserts every scan with enough matches
into its Gaussian map, selected on the device without a host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cloud import Cloud, transform_cloud
from ..core.device import resolve_device
from ..core.lie import rotation_to_rpy
from ..core.state import where_tree
from ..maps import block_map, grid_map, ndt_map
from ..ops.voxel import voxel_downsample
from .gn import (
    UPDATE_ICP,
    UPDATE_LOAM,
    UPDATE_NDT,
    GNConfig,
    GNResult,
    run_gn_icp_cand,
    run_gn_loam_cand,
    run_gn_ndt,
    run_gn_plane_cand,
)
from .residuals import fitness_score, gather_candidates


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
    m: block_map.BlockMap | grid_map.GridMap
    window_pts: torch.Tensor  # [W, cap, 3] world-frame inserted clouds (rebuild policy)
    window_mask: torch.Tensor  # [W, cap]
    head: torch.Tensor  # [] int32 ring position
    filled: torch.Tensor  # [] int32 number of valid ring entries
    last_added: torch.Tensor  # [4, 4]


def window_create(window_size, cloud_cap, map_capacity, bucket, dtype=torch.float32,
                  incremental=False, grid_dims=None, device="cpu") -> WindowMapState:
    """Empty window state. The incremental policy never re-reads inserted
    clouds, so its ring buffers are 1-element placeholders, as in the JAX
    package. The dense grid (`grid_dims`) takes the incremental policy only."""
    w, cap = (1, 1) if incremental else (window_size, cloud_cap)
    if grid_dims is not None:
        if not incremental:
            raise ValueError("map_layout='grid' requires incremental_map")
        m = grid_map.create(tuple(grid_dims), bucket, dtype, device)
    else:
        m = block_map.create(map_capacity, bucket, dtype, device)
    return WindowMapState(
        m=m,
        window_pts=torch.zeros((w, cap, 3), dtype=dtype, device=device),
        window_mask=torch.zeros((w, cap), dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        filled=torch.zeros((), dtype=torch.int32, device=device),
        last_added=torch.eye(4, dtype=dtype, device=device),
    )


def window_add(s: WindowMapState, cloud_world: Cloud, t_mat, map_filter_size,
               nn_inv_voxel, merged_capacity, num_probes: int = 8,
               window_size: int = 0) -> WindowMapState:
    """Push a world-frame cloud into the sliding-window map.

    Incremental policy (`window_size > 0`): voxel-filter the new cloud and
    scatter-insert it with `max_age=window_size` epoch eviction (two claim
    rounds on the block map: an incremental scan adds few new blocks).

    Rebuild policy (`window_size == 0`): write the cloud into the ring,
    merge the ring, voxel-filter it and build a fresh block map."""
    if window_size > 0:
        cap = cloud_world.points.shape[0]
        ds = voxel_downsample(cloud_world.points, cloud_world.mask, map_filter_size, cap)
        if isinstance(s.m, grid_map.GridMap):
            m = grid_map.insert(s.m, ds.points, ds.mask, nn_inv_voxel, max_age=window_size)
        else:
            m = block_map.insert(s.m, ds.points, ds.mask, nn_inv_voxel, num_probes=num_probes,
                                 max_age=window_size, claim_rounds=2)
        return s._replace(m=m, last_added=t_mat,
                          filled=torch.clamp(s.filled + 1, max=window_size))
    w = s.window_pts.shape[0]
    head = s.head.reshape(1).to(torch.int64)
    window_pts = s.window_pts.index_copy(0, head, cloud_world.points[None])
    window_mask = s.window_mask.index_copy(0, head, cloud_world.mask[None])
    ds = voxel_downsample(window_pts.reshape(-1, 3), window_mask.reshape(-1),
                          map_filter_size, merged_capacity)
    # build() takes the VOXEL capacity; the live map holds capacity // 2 blocks
    m = block_map.build(s.m.block_capacity * 2, s.m.bucket_size, ds.points, ds.mask,
                        nn_inv_voxel, num_probes=num_probes)
    return WindowMapState(m=m, window_pts=window_pts, window_mask=window_mask,
                          head=(s.head + 1) % w, filled=torch.clamp(s.filled + 1, max=w),
                          last_added=t_mat)


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
    # "block" is the hashed block map (maps/block_map.py); "grid" is the
    # dense modulo grid (maps/grid_map.py, incremental policy only), whose
    # grid_dims are BLOCKS (2x2x2 voxels) per axis
    map_layout: str = "block"
    grid_dims: tuple = (96, 96, 24)


def _window_size(c) -> int:
    """window_add's window: the incremental policy's eviction age, or 0 for
    the rebuild policy."""
    return c.local_map_size if c.incremental_map else 0


class _Matcher:
    """A matcher's config, dtype, device and GN settings. Runs on `device`
    (default: CUDA; pass device='cpu' for the CPU)."""

    update = UPDATE_LOAM  # the GN update convention
    use_stall_check = True  # the reference's LOAM matchers only

    def __init__(self, cfg, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.gn_cfg = GNConfig(
            max_iters=cfg.max_iterations,
            rotation_eps=cfg.rotation_converge_thresh,
            position_eps=cfg.position_converge_thresh,
            update=self.update,
            use_stall_check=self.use_stall_check,
            corr_every=cfg.corr_every,
        )
        if hasattr(cfg, "regather_skip_dist"):  # NdtConfig has no trust-region skip
            self.gn_cfg = self.gn_cfg._replace(skip_regather_dist=cfg.regather_skip_dist,
                                               regather_radius=cfg.regather_radius)

    def _as_pose(self, t_mat) -> torch.Tensor:
        return torch.as_tensor(t_mat, dtype=self.dtype, device=self.device)


class IcpMatcher(_Matcher):
    """Point-to-point ICP over a sliding-window block or grid map."""

    update = UPDATE_ICP
    use_stall_check = False

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

    def match(self, s: WindowMapState, cloud: Cloud, t_init) -> tuple[WindowMapState, GNResult]:
        t_init = self._as_pose(t_init)
        c = self.cfg
        src = self._source(cloud)
        inv = 1.0 / c.nn_voxel_size
        gc = c.group_capacity or None

        def corr_fn(t_mat):
            return gather_candidates(t_mat, src.points, src.mask, s.m, inv, c.cand_k,
                                     c.stencil, c.num_probes, group_capacity=gc)

        def gate_fn(r):  # the map-insertion gate, read with the last status word
            return r.converged & need_add_cloud(r.t_mat, s.last_added, c.dist_thresh_add_cloud,
                                                c.rot_thresh_add_cloud)

        res, do_add = run_gn_icp_cand(corr_fn, t_init, self.gn_cfg,
                                      c.max_correspond_distance**2,
                                      regather_radius=_source_radius(src.points, src.mask),
                                      gate_fn=None if c.is_localization_mode else gate_fn)
        if c.is_localization_mode:
            return s, res
        if do_add:
            world = transform_cloud(res.t_mat, Cloud(src.points, src.mask))
            s = window_add(s, world, res.t_mat, c.map_filter_size, inv,
                           c.merged_capacity, c.num_probes, window_size=_window_size(self.cfg))
        return s, res

    def add_first(self, s: WindowMapState, cloud: Cloud, t_mat) -> WindowMapState:
        """Seed the map with the first (transformed) cloud."""
        t_mat = self._as_pose(t_mat)
        c = self.cfg
        src = self._source(cloud)
        world = transform_cloud(t_mat, Cloud(src.points, src.mask))
        return window_add(s, world, t_mat, c.map_filter_size, 1.0 / c.nn_voxel_size,
                          c.merged_capacity, c.num_probes, window_size=_window_size(self.cfg))

    def fitness(self, s: WindowMapState, cloud: Cloud, t_mat, max_range=1.0) -> torch.Tensor:
        """Mean squared NN distance of the filtered cloud at `t_mat` against
        the map, over inliers within `max_range` (+inf without any)."""
        t_mat = self._as_pose(t_mat)
        c = self.cfg
        src = self._source(cloud)
        return fitness_score(t_mat, src.points, src.mask, s.m, 1.0 / c.nn_voxel_size,
                             max_range**2, c.stencil, c.num_probes)

    def set_map(self, s: WindowMapState, map_cloud: Cloud) -> WindowMapState:
        """Replace the local map wholesale (localization mode)."""
        c = self.cfg
        inv = 1.0 / c.nn_voxel_size
        if c.map_layout == "grid":
            m = grid_map.build(tuple(c.grid_dims), c.bucket_size, map_cloud.points,
                               map_cloud.mask, inv, self.dtype)
        else:
            m = block_map.build(c.map_capacity, c.bucket_size, map_cloud.points,
                                map_cloud.mask, inv, num_probes=c.num_probes)
        return s._replace(m=m)


# ---------------------------------------------------------------------------
# Point-to-plane (KdTree-window and iVox variants)
# ---------------------------------------------------------------------------


class PointToPlaneConfig(NamedTuple):
    mode: str = "ivox"  # "window" (PointToPlane_KdTree) | "ivox" (PointToPlane_IVOX)
    max_iterations: int = 30
    point_to_planar_thresh: float = 0.1
    position_converge_thresh: float = 0.01
    rotation_converge_thresh: float = 0.05
    rot_thresh_add_cloud: float = 0.2
    dist_thresh_add_cloud: float = 1.0
    local_map_size: int = 30  # window mode only
    map_filter_size: float = 0.5  # window mode only
    min_valid_planar: int = 50
    ivox_voxel_size: float = 0.5
    ivox_max_age: int = 0  # 0 = no eviction
    stencil: str = "nearby18"
    num_probes: int = 8
    max_search_dist: float = 5.0
    source_capacity: int = 16384
    cloud_capacity: int = 16384
    merged_capacity: int = 131072
    map_capacity: int = 262144
    bucket_size: int = 8
    is_localization_mode: bool = False
    corr_every: int = 10  # candidate-cache GN schedule (see IcpConfig)
    cand_k: int = 16
    # grouped stencil gather (0 = one group capacity of N)
    group_capacity: int = 0
    incremental_map: bool = True  # window mode: see window_add
    regather_skip_dist: float = 0.1  # trust-region skip (see IcpConfig)
    regather_radius: float = 20.0
    # "block" (hashed) or "grid" (dense, ivox mode only; dims are BLOCKS of
    # 2x2x2 voxels, so at the 0.5 m ivox voxel the extent is dims * 1 m)
    map_layout: str = "block"
    grid_dims: tuple = (192, 192, 32)


class P2PlaneWindowState(NamedTuple):
    w: WindowMapState


class P2PlaneIvoxState(NamedTuple):
    m: block_map.BlockMap | grid_map.GridMap
    last_added: torch.Tensor


class PointToPlaneMatcher(_Matcher):
    """LOAM point-to-plane over a planar-feature map.

    window mode: the map is the merged window of inserted clouds, gated by
    the insertion rule. ivox mode: incremental center-policy insertion of
    EVERY converged scan (the reference's ivox matcher has no gate)."""

    def __init__(self, cfg: PointToPlaneConfig, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        self.inv = 1.0 / cfg.ivox_voxel_size

    def create_state(self):
        c = self.cfg
        if c.mode == "window":
            return P2PlaneWindowState(window_create(
                c.local_map_size, c.cloud_capacity, c.map_capacity, c.bucket_size,
                self.dtype, incremental=c.incremental_map, device=self.device))
        if c.map_layout == "grid":
            m = grid_map.create(tuple(c.grid_dims), c.bucket_size, self.dtype, self.device)
        else:
            m = block_map.create(c.map_capacity, c.bucket_size, self.dtype, self.device)
        return P2PlaneIvoxState(m=m, last_added=torch.eye(4, dtype=self.dtype,
                                                          device=self.device))

    def _map(self, s):
        return s.w.m if isinstance(s, P2PlaneWindowState) else s.m

    def _ivox_insert(self, m, world: Cloud, claim_rounds: int = 3):
        c = self.cfg
        if isinstance(m, grid_map.GridMap):
            return grid_map.insert(m, world.points, world.mask, self.inv,
                                   max_age=c.ivox_max_age, center_policy=True)
        return block_map.insert(m, world.points, world.mask, self.inv,
                                num_probes=c.num_probes, max_age=c.ivox_max_age,
                                center_policy=True, claim_rounds=claim_rounds)

    def match(self, s, planar: Cloud, t_init) -> tuple[object, GNResult]:
        t_init = self._as_pose(t_init)
        c = self.cfg
        m = self._map(s)
        gc = c.group_capacity or None

        def corr_fn(t_mat):
            return gather_candidates(t_mat, planar.points, planar.mask, m, self.inv,
                                     c.cand_k, c.stencil, c.num_probes, group_capacity=gc)

        def gate_fn(r):  # read with the last status word
            ok = r.num_valid >= c.min_valid_planar
            if isinstance(s, P2PlaneWindowState):  # the map-insertion gate
                return ok & need_add_cloud(r.t_mat, s.w.last_added, c.dist_thresh_add_cloud,
                                           c.rot_thresh_add_cloud)
            return ok  # ivox: every converged scan

        res, do_add = run_gn_plane_cand(
            corr_fn, t_init, self.gn_cfg, c.point_to_planar_thresh, c.max_search_dist**2,
            regather_radius=_source_radius(planar.points, planar.mask),
            gate_fn=None if c.is_localization_mode else gate_fn)
        # convergence requires enough valid planar matches
        res = res._replace(converged=res.num_valid >= c.min_valid_planar)
        if not do_add:  # localization mode reads no gate
            return s, res
        if isinstance(s, P2PlaneWindowState):
            return P2PlaneWindowState(window_add(
                s.w, transform_cloud(res.t_mat, planar), res.t_mat, c.map_filter_size,
                self.inv, c.merged_capacity, c.num_probes,
                window_size=_window_size(self.cfg))), res
        # ivox: insert every converged scan; two claim rounds (per-scan
        # frontier contention is small, and this matcher inserts every frame)
        return P2PlaneIvoxState(self._ivox_insert(s.m, transform_cloud(res.t_mat, planar),
                                                  claim_rounds=2), res.t_mat), res

    def add_first(self, s, planar: Cloud, t_mat):
        t_mat = self._as_pose(t_mat)
        c = self.cfg
        world = transform_cloud(t_mat, planar)
        if isinstance(s, P2PlaneWindowState):
            return P2PlaneWindowState(window_add(
                s.w, world, t_mat, c.map_filter_size, self.inv, c.merged_capacity,
                c.num_probes, window_size=_window_size(self.cfg)))
        return P2PlaneIvoxState(self._ivox_insert(s.m, world), t_mat)

    def fitness(self, s, planar: Cloud, t_mat, max_range=1.0) -> torch.Tensor:
        return fitness_score(self._as_pose(t_mat), planar.points, planar.mask, self._map(s),
                             self.inv, max_range**2, self.cfg.stencil, self.cfg.num_probes)

    def set_map(self, s, map_cloud: Cloud):
        """Replace the map wholesale (localization mode)."""
        c = self.cfg
        if isinstance(s, P2PlaneWindowState):
            m = block_map.build(c.map_capacity, c.bucket_size, map_cloud.points,
                                map_cloud.mask, self.inv, num_probes=c.num_probes)
            return P2PlaneWindowState(s.w._replace(m=m))
        if c.map_layout == "grid":
            fresh = grid_map.create(tuple(c.grid_dims), c.bucket_size, self.dtype,
                                    map_cloud.points.device)
            m = grid_map.insert(fresh, map_cloud.points, map_cloud.mask, self.inv,
                                center_policy=True)
        else:
            fresh = block_map.create(c.map_capacity, c.bucket_size, self.dtype,
                                     map_cloud.points.device)
            m = block_map.insert(fresh, map_cloud.points, map_cloud.mask, self.inv,
                                 num_probes=c.num_probes, max_age=0, center_policy=True)
        return P2PlaneIvoxState(m, s.last_added)


# ---------------------------------------------------------------------------
# Full LOAM: corner (line) + planar (plane) maps
# ---------------------------------------------------------------------------


class LoamFullConfig(NamedTuple):
    max_iterations: int = 30
    point_to_planar_thresh: float = 0.1
    point_search_thresh: float = 1.0  # 5th-NN gate (applied squared)
    line_ratio_thresh: float = 3.0
    position_converge_thresh: float = 0.01
    rotation_converge_thresh: float = 0.05
    rot_thresh_add_cloud: float = 0.2
    dist_thresh_add_cloud: float = 1.0
    corner_map_size: int = 30
    planar_map_size: int = 30
    corner_filter_size: float = 0.2
    planar_filter_size: float = 0.4
    min_valid_planar: int = 50
    nn_voxel_size: float = 1.0
    stencil: str = "nearby26"
    num_probes: int = 8
    corner_capacity: int = 4096
    planar_capacity: int = 16384
    merged_capacity: int = 131072
    map_capacity: int = 65536
    bucket_size: int = 8
    is_localization_mode: bool = False
    corr_every: int = 8  # candidate-cache GN schedule (see IcpConfig)
    cand_k: int = 16
    group_capacity: int = 8192  # grouped stencil gather (0 = N)
    incremental_map: bool = True  # see window_add
    regather_skip_dist: float = 0.1  # trust-region skip (see IcpConfig)
    regather_radius: float = 20.0


class LoamFullState(NamedTuple):
    corner: WindowMapState
    planar: WindowMapState


class LoamFullMatcher(_Matcher):
    """Full LOAM: point-to-line on the corner map plus point-to-plane on the
    planar map, one GN over the summed normal equations."""

    def __init__(self, cfg: LoamFullConfig, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        self.inv = 1.0 / cfg.nn_voxel_size

    def create_state(self) -> LoamFullState:
        c = self.cfg
        inc = c.incremental_map
        return LoamFullState(
            corner=window_create(c.corner_map_size, c.corner_capacity, c.map_capacity,
                                 c.bucket_size, self.dtype, incremental=inc,
                                 device=self.device),
            planar=window_create(c.planar_map_size, c.planar_capacity, c.map_capacity,
                                 c.bucket_size, self.dtype, incremental=inc,
                                 device=self.device),
        )

    def _add(self, s: LoamFullState, corner: Cloud, planar: Cloud, t_mat) -> LoamFullState:
        c = self.cfg
        wc = c.corner_map_size if c.incremental_map else 0
        wp = c.planar_map_size if c.incremental_map else 0
        return LoamFullState(
            corner=window_add(s.corner, transform_cloud(t_mat, corner), t_mat,
                              c.corner_filter_size, self.inv, c.merged_capacity,
                              c.num_probes, window_size=wc),
            planar=window_add(s.planar, transform_cloud(t_mat, planar), t_mat,
                              c.planar_filter_size, self.inv, c.merged_capacity,
                              c.num_probes, window_size=wp),
        )

    def match(self, s: LoamFullState, corner: Cloud, planar: Cloud, t_init):
        t_init = self._as_pose(t_init)
        c = self.cfg
        thr2 = c.point_search_thresh**2
        gc = c.group_capacity or None

        def corr_fn(t_mat):
            return (gather_candidates(t_mat, corner.points, corner.mask, s.corner.m, self.inv,
                                      c.cand_k, c.stencil, c.num_probes, group_capacity=gc),
                    gather_candidates(t_mat, planar.points, planar.mask, s.planar.m, self.inv,
                                      c.cand_k, c.stencil, c.num_probes, group_capacity=gc))

        def gate_fn(r):  # the map-insertion gate, read with the last status word
            return (r.num_valid >= c.min_valid_planar) & need_add_cloud(
                r.t_mat, s.planar.last_added, c.dist_thresh_add_cloud, c.rot_thresh_add_cloud)

        radius = torch.maximum(_source_radius(corner.points, corner.mask),
                               _source_radius(planar.points, planar.mask))
        # line rows of the corner set plus plane rows of the planar set; the
        # reference's convergence gate counts PLANAR matches only, so the
        # loop's num_valid is the planar count
        res, do_add = run_gn_loam_cand(corr_fn, t_init, self.gn_cfg, c.line_ratio_thresh,
                                       c.point_to_planar_thresh, thr2, regather_radius=radius,
                                       gate_fn=None if c.is_localization_mode else gate_fn)
        res = res._replace(converged=res.num_valid >= c.min_valid_planar)
        if do_add:
            s = self._add(s, corner, planar, res.t_mat)
        return s, res

    def add_first(self, s: LoamFullState, corner: Cloud, planar: Cloud, t_mat) -> LoamFullState:
        return self._add(s, corner, planar, self._as_pose(t_mat))

    def fitness(self, s: LoamFullState, planar: Cloud, t_mat, max_range=1.0) -> torch.Tensor:
        return fitness_score(self._as_pose(t_mat), planar.points, planar.mask, s.planar.m,
                             self.inv, max_range**2, self.cfg.stencil, self.cfg.num_probes)

    def set_map(self, s: LoamFullState, map_cloud: Cloud) -> LoamFullState:
        """Replace both feature maps with the (unlabelled) local map cloud,
        as localization mode feeds every matcher."""
        c = self.cfg
        m = block_map.build(c.map_capacity, c.bucket_size, map_cloud.points, map_cloud.mask,
                            self.inv, num_probes=c.num_probes)
        return LoamFullState(corner=s.corner._replace(m=m), planar=s.planar._replace(m=m))


# ---------------------------------------------------------------------------
# Incremental NDT
# ---------------------------------------------------------------------------


class NdtConfig(NamedTuple):
    voxel_size: float = 1.0
    res_outlier_thresh: float = 20.0
    source_filter_size: float = 1.0
    rotation_converge_thresh: float = 0.05
    position_converge_thresh: float = 0.01
    min_points_in_voxel: int = 3
    max_points_in_voxel: int = 50
    min_effective_pts: int = 10
    max_iterations: int = 30
    max_age: int = 0
    source_capacity: int = 16384
    map_capacity: int = 262144
    is_localization_mode: bool = False
    # the stencil lookup changes whenever a point crosses a voxel boundary,
    # so NDT keeps the reference's search-every-iteration schedule
    corr_every: int = 1


class NdtState(NamedTuple):
    m: ndt_map.NdtMap
    first_scan: torch.Tensor  # [] bool: the next insert estimates every voxel


class NdtMatcher(_Matcher):
    """Incremental NDT: Mahalanobis residuals against the 7-voxel stencil
    Gaussians, every converged scan merged into the map."""

    update = UPDATE_NDT
    use_stall_check = False

    def __init__(self, cfg: NdtConfig, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        self.inv = 1.0 / cfg.voxel_size

    def create_state(self) -> NdtState:
        return NdtState(ndt_map.create(self.cfg.map_capacity, self.dtype, self.device),
                        torch.tensor(True, device=self.device))

    def _source(self, cloud: Cloud):
        c = self.cfg
        return voxel_downsample(cloud.points, cloud.mask, c.source_filter_size,
                                c.source_capacity)

    def _insert(self, s: NdtState, world: Cloud) -> NdtState:
        """One insert; the first scan (and a localization map) estimates every
        voxel whatever its count. In localization mode the flag stays set, so
        every frozen-map reload re-estimates all voxels."""
        c = self.cfg
        m = ndt_map.insert(s.m, world.points, world.mask, self.inv, max_age=c.max_age,
                           min_points=c.min_points_in_voxel, max_points=c.max_points_in_voxel,
                           estimate_all=s.first_scan)
        return NdtState(m, torch.full_like(s.first_scan, c.is_localization_mode))

    def match(self, s: NdtState, cloud: Cloud, t_init) -> tuple[NdtState, GNResult]:
        t_init = self._as_pose(t_init)
        c = self.cfg
        src = self._source(cloud)
        # the whole loop, the stencil lookup of every iteration inside it:
        # one launch and one host read
        res = run_gn_ndt(src.points, src.mask, s.m, self.inv, c.res_outlier_thresh, t_init,
                         self.gn_cfg)
        # the reference forces convergence after the loop unless too few
        # effective points matched
        enough = res.num_valid >= c.min_effective_pts
        res = res._replace(converged=enough)
        if c.is_localization_mode:
            return s, res
        # insert unconditionally and keep it where enough: no host read
        added = self._insert(s, transform_cloud(res.t_mat, Cloud(src.points, src.mask)))
        return where_tree(enough, added, s), res

    def add_first(self, s: NdtState, cloud: Cloud, t_mat) -> NdtState:
        t_mat = self._as_pose(t_mat)
        src = self._source(cloud)
        return self._insert(s, transform_cloud(t_mat, Cloud(src.points, src.mask)))

    def set_map(self, s: NdtState, map_cloud: Cloud) -> NdtState:
        """Replace the map wholesale (localization mode): every voxel Gaussian
        re-estimated from the frozen local map."""
        fresh = NdtState(ndt_map.create(self.cfg.map_capacity, self.dtype,
                                        map_cloud.points.device),
                         torch.tensor(True, device=map_cloud.points.device))
        return self._insert(fresh, map_cloud)

    def fitness(self, s: NdtState, cloud: Cloud, t_mat, max_range=1.0) -> torch.Tensor:
        """Mean distance of the filtered cloud at `t_mat` to the nearest
        estimated stencil voxel mean, over points within `max_range`."""
        t_mat = self._as_pose(t_mat)
        src = self._source(cloud)
        world = src.points @ t_mat[:3, :3].T + t_mat[:3, 3]
        mu, _, valid = ndt_map.query_stencil(s.m, world, self.inv)
        d2 = torch.sum((world[:, None, :] - mu) ** 2, dim=-1)
        dmin2 = torch.where(valid, d2, float("inf")).amin(1)
        ok = src.mask & (dmin2 <= max_range**2)
        return (torch.where(ok, torch.sqrt(dmin2), 0.0).sum()
                / torch.clamp(ok.sum(), min=1))
