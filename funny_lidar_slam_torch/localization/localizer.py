"""Localization mode: scan-to-frozen-map tracking against a prebuilt map
(port of localization/localizer.py).

  * global map: a PCD file voxel-filtered to `map_filter_size`, a point
    array (`set_global_map`), or a tile-map directory (`maps/split_map.py`);
  * manual init pose: the first scan is matched against a local map around
    the init pose (through the LOAM front end when a lidar geometry is
    set) and accepted when the fitness of the whole deskewed scan <
    `init_fitness` at `init_fitness_range`;
  * local map: a `local_map_size` crop box around the latest retired pose,
    rebuilt (the matcher's `set_map`; any of the five registration modes)
    when the pose comes within
    `local_map_boundary` of the box edge; in tile mode, the 3x3 tile
    neighbourhood;
  * per scan: the mapping frontend's step with the matcher in localization
    mode (frozen map).

The host crops the map on its side (NumPy); matching and fusion run on the
matcher's device. Scans are dispatched ahead and retired in batches, each
batch with one device-to-host copy of the stacked result rows.

Port notes: the host voxel filter is the port's copy of the JAX package's
g++ library (`native`), so both load the same map; the JAX package's
executable-cached programs for the map swap and the init match are plain
calls here.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.cloud import Cloud
from ..imu.stream import ImuStream
from ..io.pcd import read_pcd
from ..lidar.deskew import deskew
from ..maps.split_map import TileMapLoader
from ..native import voxel_downsample as host_voxel
from ..pipeline.frontend import Frontend, FrontendConfig, FrontendState
from ..pipeline.system import SystemConfig, build_matcher, pad_scan


@dataclass
class LocalizationConfig:
    registration_mode: str = "IcpOptimized"
    matcher_config: object = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # map source: a single global map file, or a tile-map directory
    map_path: str | None = None
    tile_map_dir: str | None = None
    map_filter_size: float = 0.3
    # crop-box local map
    local_map_size: float = 200.0
    local_map_boundary: float = 50.0
    local_map_capacity: int = 131072
    # init gate
    init_fitness: float = 1.0
    init_fitness_range: float = 2.0
    # scan/IMU feed (mirrors SystemConfig)
    scan_capacity: int = 16384
    imu_segment_capacity: int = 32
    imu_has_orientation: bool = False
    imu_buffer_size: int = 2000
    gravity_norm: float = 9.81
    require_imu_static_init: bool = True


class Localizer:
    """Frozen-map localization pipeline. Runs on `device` (default: CUDA;
    pass device='cpu' for the CPU)."""

    def __init__(self, cfg: LocalizationConfig, device=None):
        self.cfg = cfg
        mcfg = cfg.matcher_config
        if mcfg is not None and hasattr(mcfg, "_replace"):
            mcfg = mcfg._replace(is_localization_mode=True)
        sys_like = SystemConfig(registration_mode=cfg.registration_mode, matcher_config=mcfg)
        self.matcher = build_matcher(sys_like, device)
        if not self.matcher.cfg.is_localization_mode:
            self.matcher.cfg = self.matcher.cfg._replace(is_localization_mode=True)
        self.device = self.matcher.device
        self.frontend = Frontend(self.matcher, cfg.frontend)
        self.imu = ImuStream(
            has_orientation=cfg.imu_has_orientation,
            gravity_norm=cfg.gravity_norm,
            buffer_size=cfg.imu_buffer_size,
            require_static_init=cfg.require_imu_static_init,
        )
        self.mstate = self.matcher.create_state()
        self.fstate: FrontendState | None = None
        self._last_scan_end: float | None = None
        self._last_retired_p: np.ndarray | None = None  # host pose for map refresh
        self.trajectory_t: list[float] = []
        self.trajectory: list[np.ndarray] = []
        self.stats: list[dict] = []
        self.map_refreshes = 0

        # map source
        self.tiles: TileMapLoader | None = None
        self.global_map: np.ndarray | None = None
        if cfg.tile_map_dir:
            self.tiles = TileMapLoader(cfg.tile_map_dir)
        elif cfg.map_path:
            pts, _ = read_pcd(cfg.map_path)
            self.global_map = host_voxel(pts, cfg.map_filter_size)
        self._map_center: np.ndarray | None = None
        self.initialized = False

    # -- map management ------------------------------------------------
    def set_global_map(self, points: np.ndarray) -> None:
        """Directly provide the global map cloud (test/benchmark path)."""
        self.global_map = host_voxel(points, self.cfg.map_filter_size)

    def _crop_local(self, center: np.ndarray) -> np.ndarray:
        half = self.cfg.local_map_size / 2.0
        m = self.global_map
        keep = np.all((m >= center - half) & (m <= center + half), axis=1)
        return m[keep]

    def _needs_refresh(self, position: np.ndarray) -> bool:
        """Refresh when within local_map_boundary of the crop-box edge."""
        if self._map_center is None:
            return True
        half = self.cfg.local_map_size / 2.0
        edge_dist = half - np.abs(position - self._map_center)
        return bool((edge_dist < self.cfg.local_map_boundary).any())

    def _pad_map(self, pts: np.ndarray) -> Cloud:
        cap = self.cfg.local_map_capacity
        if len(pts) > cap:
            # coarsen the voxel filter until the crop fits: uniform thinning
            size = self.cfg.map_filter_size * 1.5
            while len(pts) > cap:
                pts = host_voxel(pts, size)
                size *= 1.5
            warnings.warn(
                f"local map exceeded local_map_capacity={cap}; re-filtered to {len(pts)} "
                f"points at voxel {size / 1.5:.2f}; raise the capacity or use tile maps",
                stacklevel=2)
        n = len(pts)
        buf = np.zeros((cap, 3), np.float32)
        msk = np.zeros(cap, bool)
        buf[:n] = pts[:n]
        msk[:n] = True
        return Cloud(torch.from_numpy(buf).to(self.device), torch.from_numpy(msk).to(self.device))

    def refresh_local_map(self, position: np.ndarray, force: bool = False) -> bool:
        """Rebuild the device-resident local map when required; returns True
        when the map was replaced."""
        position = np.asarray(position, np.float64)
        if self.tiles is not None:
            if not (self.tiles.update(position[:2]) or force):
                return False
            local = host_voxel(self.tiles.local_cloud(), self.cfg.map_filter_size)
        else:
            if self.global_map is None:
                raise RuntimeError(
                    "no map loaded: set map_path/tile_map_dir or call set_global_map")
            if not (force or self._needs_refresh(position)):
                return False
            self._map_center = position.copy()
            local = self._crop_local(position)
        self.mstate = self.matcher.set_map(self.mstate, self._pad_map(local))
        self.map_refreshes += 1
        return True

    # -- IMU feed --------------------------------------------------------
    def push_imu(self, t, gyro, accel, quat=None):
        self.imu.push(t, gyro, accel, quat)
        if self.imu.init.done:
            self.cfg.frontend.gravity = tuple(self.imu.gravity)

    def _init_match(self, mstate, init_pose, pts, rts, mask, ref_time, seg):
        """Deskew + match + fitness of the init scan."""
        dpts, dmsk = deskew(pts, rts, mask, ref_time, seg, self.frontend.t_l2i)
        cloud = Cloud(dpts, dmsk)
        ring = self.frontend._default_ring(pts)
        _, res, _ = self.frontend._matcher_match(mstate, cloud, init_pose, ring, rts)
        fit = self.matcher.fitness(mstate, cloud, res.t_mat, self.cfg.init_fitness_range)
        return res.t_mat, res.converged, fit

    # -- init ------------------------------------------------------------
    def try_init(self, init_pose: np.ndarray, t_start: float, scan_end: float,
                 points, rel_times) -> bool:
        """Load the local map around the init pose, match the first scan,
        accept when its fitness < init_fitness."""
        if not self.imu.initialized or not self.imu.covers(t_start, scan_end):
            return False
        seg = self.imu.get_segment(t_start, scan_end, self.cfg.imu_segment_capacity)
        if seg is None:
            return False
        self.refresh_local_map(np.asarray(init_pose)[:3, 3], force=True)

        pts, rts, mask = pad_scan(points, rel_times, self.cfg.scan_capacity)
        fe = self.frontend
        t_mat, converged, fit = self._init_match(
            self.mstate, fe._tensor(init_pose), fe._tensor(pts),
            fe._tensor(rts - (scan_end - t_start)), fe._tensor(mask, torch.bool),
            fe._tensor(scan_end), fe.to_device_segment(seg))
        fit = float(fit)
        if not (bool(converged) and fit < self.cfg.init_fitness):
            return False
        pose = t_mat.cpu().numpy()
        self.fstate = fe.init_from_pose(pose, scan_end)
        self._last_scan_end = scan_end
        self._last_retired_p = pose[:3, 3].copy()
        self.initialized = True
        self.trajectory_t.append(scan_end)
        self.trajectory.append(pose)
        return True

    # -- per-scan tracking -------------------------------------------------
    # The map-refresh decision reads the latest RETIRED pose, which lags the
    # dispatched scans by at most one batch; the local_map_boundary dwarfs
    # that motion.
    def dispatch_scan(self, t_start: float, scan_end: float, points,
                      rel_times) -> dict | None:
        """Enqueue one tracking step on the device without reading it back."""
        if not self.initialized:
            return None
        if not self.imu.initialized or not self.imu.covers(t_start, scan_end):
            return None
        cap = self.cfg.imu_segment_capacity
        dseg = self.imu.get_segment(t_start, scan_end, cap)
        prev_end = self._last_scan_end if self._last_scan_end is not None else t_start
        pseg = self.imu.get_segment(prev_end, scan_end, cap)
        if dseg is None or pseg is None:
            return None

        # refresh the frozen local map around the latest retired pose before
        # this scan's step, which runs after it in stream order
        refreshed = self.refresh_local_map(self._last_retired_p)

        t0 = time.perf_counter()
        buf = self.frontend.pack_frame(points, rel_times - (scan_end - t_start),
                                       self.cfg.scan_capacity, scan_end, dseg, pseg)
        self.mstate, self.fstate, out = self.frontend.step_packed(
            self.mstate, self.fstate, buf, self.cfg.scan_capacity, cap)
        self._last_scan_end = scan_end
        return {"t": scan_end, "t0": t0, "out": out, "map_refreshed": refreshed}

    def retire_scan(self, pending: dict, packed_row=None) -> dict:
        """Materialize one dispatched step (one [36] row copy unless
        `retire_batch` fetched it) and update the trajectory."""
        packed = (packed_row if packed_row is not None
                  else pending["out"].packed.cpu().numpy().astype(np.float64))
        pose = packed[:16].reshape(4, 4)
        tr = time.perf_counter()
        stats = {
            "t": pending["t"],
            "pose": pose,
            "converged": bool(packed[32] > 0.5),
            "num_valid": int(packed[33]),
            "iters": int(packed[34]),
            "wall": tr - pending["t0"],
            "tr": tr,
            "map_refreshed": pending["map_refreshed"],
        }
        if stats["converged"]:
            self.trajectory_t.append(pending["t"])
            self.trajectory.append(pose)
            self._last_retired_p = pose[:3, 3].copy()
        self.stats.append(stats)
        return stats

    def retire_batch(self, pendings: list) -> list:
        """Retire several dispatched scans with ONE device-to-host copy of
        their stacked result rows."""
        if not pendings:
            return []
        stacked = torch.stack([p["out"].packed for p in pendings]).cpu().numpy()
        stacked = stacked.astype(np.float64)
        return [self.retire_scan(p, stacked[i]) for i, p in enumerate(pendings)]

    def process_scan(self, t_start: float, scan_end: float, points, rel_times) -> dict | None:
        """Synchronous feed (dispatch + retire)."""
        pending = self.dispatch_scan(t_start, scan_end, points, rel_times)
        if pending is None:
            return None
        return self.retire_scan(pending)

    # -- dataset feed ------------------------------------------------------
    def run_dataset(self, dataset, init_pose: np.ndarray, max_scans=None,
                    depth: int = 8) -> dict:
        scan_period = 1.0 / 10.0
        if len(dataset.scans) >= 2:
            scan_period = dataset.scans[1].t - dataset.scans[0].t
        imu_idx, n_imu = 0, len(dataset.imu_t)
        scans = dataset.scans[:max_scans] if max_scans else dataset.scans
        pending: list = []
        for scan in scans:
            scan_end = scan.t + scan_period
            while imu_idx < n_imu and dataset.imu_t[imu_idx] <= scan_end + 0.05:
                self.push_imu(dataset.imu_t[imu_idx], dataset.imu_gyro[imu_idx],
                              dataset.imu_accel[imu_idx])
                imu_idx += 1
            if not self.initialized:
                self.try_init(init_pose, scan.t, scan_end, scan.points, scan.rel_times)
                continue
            nxt = self.dispatch_scan(scan.t, scan_end, scan.points, scan.rel_times)
            if nxt is not None:
                pending.append(nxt)
            if len(pending) >= depth:
                self.retire_batch(pending)
                pending.clear()
        self.retire_batch(pending)
        return {"poses": np.asarray(self.trajectory), "times": np.asarray(self.trajectory_t)}
