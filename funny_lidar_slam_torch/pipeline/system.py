"""SLAM system orchestration, mapping mode (port of pipeline/system.py).

Per scan: extract the IMU segments on the host (NumPy), run the frontend
step on the device, then apply the host-side keyframe policy. Scans are
dispatched ahead and retired in batches, each batch with one device->host
copy of the per-frame result rows and one of its new keyframes' clouds.

The backend: every keyframe adds a pose-graph vertex and an odometry edge
(`backend/pose_graph.py`); with `enable_loopclosure`, each keyframe tries a
loop closure (`backend/loop_closure.py`), and an accepted loop adds its
edge, optimizes the graph on the device and rewrites every keyframe pose.
With `keyframe_save_dir` the keyframes persist as npz files, from which
`SlamSystem.resume` continues a killed run; `save_map` writes the merged
map and its tiles. `build_matcher`, `pad_scan` and `to_device_segment`
(defined beside `ImuSegment` in `core/state.py`) also serve the
localization mode (`localization/localizer.py`) and the profile tool.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..backend.loop_closure import LoopCloser, LoopClosureConfig
from ..backend.pose_graph import PoseGraphBuilder, optimize as pg_optimize
from ..core.cloud import Cloud
from ..core.state import to_device_segment  # noqa: F401  (re-exported)
from ..imu.stream import ImuStream
from ..io.pcd import write_pcd
from ..maps.split_map import save_tiles
from ..native import voxel_downsample as host_voxel
from ..registration import matchers
from .frontend import Frontend, FrontendConfig, FrontendState
from .keyframes import KeyFrame, KeyFrameStore, materialize_batch


@dataclass
class SystemConfig:
    registration_mode: str = "IcpOptimized"
    matcher_config: object = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    keyframe_delta_dist: float = 1.0
    keyframe_delta_rotation: float = 0.2
    scan_capacity: int = 16384
    imu_segment_capacity: int = 32
    imu_has_orientation: bool = False
    imu_buffer_size: int = 2000
    gravity_norm: float = 9.81
    keyframe_save_dir: str | None = None
    # when False (loose coupling without the static-init need) skip it
    require_imu_static_init: bool = True
    # loop closure + pose-graph backend
    enable_loopclosure: bool = False
    loopclosure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    pose_graph_vertex_capacity: int = 512
    pose_graph_edge_capacity: int = 1024
    pose_graph_iterations: int = 15


# scans dispatched ahead of their retirement: the first retire of a batch
# waits for the device to drain the queued steps, the rest are free
RETIRE_DEPTH = 12


def build_matcher(cfg: SystemConfig, device=None):
    mode, mcfg = cfg.registration_mode, cfg.matcher_config
    if mode == "IcpOptimized":
        return matchers.IcpMatcher(mcfg or matchers.IcpConfig(), device=device)
    if mode == "PointToPlane_IVOX":
        return matchers.PointToPlaneMatcher(mcfg or matchers.PointToPlaneConfig(mode="ivox"),
                                            device=device)
    if mode == "PointToPlane_KdTree":
        return matchers.PointToPlaneMatcher(
            mcfg or matchers.PointToPlaneConfig(mode="window"), device=device)
    if mode == "LoamFull_KdTree":
        return matchers.LoamFullMatcher(mcfg or matchers.LoamFullConfig(), device=device)
    if mode == "IncrementalNDT":
        return matchers.NdtMatcher(mcfg or matchers.NdtConfig(), device=device)
    raise ValueError(f"unknown registration mode: {mode}")


def pad_scan(points: np.ndarray, rel_times: np.ndarray, capacity: int):
    n = min(len(points), capacity)
    pts = np.zeros((capacity, 3), np.float32)
    rts = np.zeros(capacity, np.float32)
    mask = np.zeros(capacity, bool)
    pts[:n] = points[:n]
    rts[:n] = rel_times[:n]
    mask[:n] = True
    return pts, rts, mask


class SlamSystem:
    """Mapping-mode SLAM: frontend odometry, keyframing and the pose-graph
    backend. Runs on `device` (default: CUDA; pass device='cpu' for the
    CPU)."""

    def __init__(self, cfg: SystemConfig, device=None):
        self.cfg = cfg
        self.matcher = build_matcher(cfg, device)
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
        self.keyframes = KeyFrameStore(save_dir=cfg.keyframe_save_dir)
        self.trajectory_t: list[float] = []
        self.trajectory: list[np.ndarray] = []
        self._accum_delta = np.eye(4)
        self._last_scan_end: float | None = None
        self.stats: list[dict] = []
        self.graph = PoseGraphBuilder(cfg.pose_graph_vertex_capacity,
                                      cfg.pose_graph_edge_capacity)
        self.loop_closer = (LoopCloser(cfg.loopclosure, self.device)
                            if cfg.enable_loopclosure else None)
        self._last_kf_odom_pose: np.ndarray | None = None
        self.loop_results: list = []
        self._resume_pose: np.ndarray | None = None
        self._resume_vel: np.ndarray | None = None
        # keyframes whose clouds still live on the device, fetched per batch
        self._lazy_kfs: list = []

    @classmethod
    def resume(cls, cfg: SystemConfig, keyframe_dir: str | None = None,
               device=None) -> "SlamSystem":
        """Resume mapping from a persisted keyframe store.

        Rebuilds the keyframe store, the pose graph (vertices at the saved
        poses, consecutive odometry edges: loop corrections are already in
        the saved poses) and the matcher's local map (the most recent
        keyframes' clouds, or feature clouds, at their poses), and arms the
        frontend to start at the last keyframe's pose on the next scan. The
        IMU needs no static init; feed data from after the last keyframe's
        timestamp."""
        slam = cls(cfg, device)
        kf_dir = keyframe_dir or cfg.keyframe_save_dir
        if not kf_dir:
            raise ValueError("resume requires a keyframe directory")
        slam.keyframes = KeyFrameStore.load(kf_dir)
        slam.keyframes.save_dir = cfg.keyframe_save_dir
        if len(slam.keyframes) == 0:
            return slam

        prev = None
        for kf in slam.keyframes.frames:
            slam.graph.add_vertex(kf.pose, None if prev is None else np.linalg.inv(prev) @ kf.pose)
            prev = kf.pose

        # reseed the local map from the most recent keyframes (window-sized),
        # with the clouds each matcher family takes
        mcfg = slam.matcher.cfg
        n_seed = int(getattr(mcfg, "local_map_size", 0) or getattr(mcfg, "planar_map_size", 0)
                     or 10)

        def cloud_of(pts_np, capacity):
            pts, _, msk = pad_scan(pts_np, np.zeros(len(pts_np)), capacity)
            return Cloud(torch.from_numpy(pts).to(slam.device),
                         torch.from_numpy(msk).to(slam.device))

        for kf in slam.keyframes.frames[-n_seed:]:
            if isinstance(slam.matcher, matchers.LoamFullMatcher):
                # keyframes without persisted features: empty corner, the
                # whole cloud as planar
                corner = kf.corner if kf.corner is not None else np.zeros((0, 3), np.float32)
                planar = kf.planar if kf.planar is not None else kf.cloud
                slam.mstate = slam.matcher.add_first(
                    slam.mstate, cloud_of(corner, mcfg.corner_capacity),
                    cloud_of(planar, mcfg.planar_capacity), kf.pose)
            elif isinstance(slam.matcher, matchers.PointToPlaneMatcher):
                planar = kf.planar if kf.planar is not None else kf.cloud
                slam.mstate = slam.matcher.add_first(
                    slam.mstate, cloud_of(planar, mcfg.source_capacity), kf.pose)
            else:
                slam.mstate = slam.matcher.add_first(
                    slam.mstate, cloud_of(kf.cloud, cfg.scan_capacity), kf.pose)

        last = slam.keyframes.frames[-1]
        slam._resume_pose = last.pose.copy()
        # velocity from the last two keyframes: a mid-motion resume must not
        # restart the filter at standstill
        if len(slam.keyframes) >= 2:
            prev_kf = slam.keyframes.frames[-2]
            dt = last.timestamp - prev_kf.timestamp
            if dt > 1e-6:
                slam._resume_vel = (last.pose[:3, 3] - prev_kf.pose[:3, 3]) / dt
        slam._last_kf_odom_pose = last.pose.copy()
        # the resumed run may be in motion: no standstill static init;
        # gravity is the config's world-frame value
        slam.imu.require_static_init = False
        slam.imu.initialized = True
        return slam

    def push_imu(self, t, gyro, accel, quat=None):
        self.imu.push(t, gyro, accel, quat)
        if self.imu.init.done:
            self.cfg.frontend.gravity = tuple(self.imu.gravity)

    def _is_keyframe(self, accum: np.ndarray) -> bool:
        """Keyframe gate on the accumulated motion since the last keyframe."""
        if len(self.keyframes) == 0:
            return True
        d = np.linalg.norm(accum[:3, 3])
        r = accum[:3, :3]
        rpy = np.abs([
            np.arctan2(r[2, 1], r[2, 2]),
            np.arcsin(np.clip(-r[2, 0], -1.0, 1.0)),
            np.arctan2(r[1, 0], r[0, 0]),
        ])
        return d > self.cfg.keyframe_delta_dist or (rpy > self.cfg.keyframe_delta_rotation).any()

    def dispatch_scan(self, t_start: float, scan_end: float, points, rel_times) -> dict | None:
        """Host prep + the device step of one scan, without reading results
        back. Returns None if the scan is skipped (IMU not initialized or
        not covering the scan)."""
        if not self.imu.initialized or not self.imu.covers(t_start, scan_end):
            return None
        cap = self.cfg.imu_segment_capacity
        deskew_seg = self.imu.get_segment(t_start, scan_end, cap)
        if deskew_seg is None:
            return None

        t0 = time.perf_counter()
        if self.fstate is not None:
            prev_end = self._last_scan_end if self._last_scan_end is not None else t_start
            preint_seg = self.imu.get_segment(prev_end, scan_end, cap)
            if preint_seg is None:
                return None
            buf = self.frontend.pack_frame(
                points, rel_times - (scan_end - t_start),
                self.cfg.scan_capacity, scan_end, deskew_seg, preint_seg,
            )
            self.mstate, self.fstate, out = self.frontend.step_packed(
                self.mstate, self.fstate, buf, self.cfg.scan_capacity, cap)
            self._last_scan_end = scan_end
            feat = None
            if out.corner is not None:
                feat = (out.corner.points, out.corner.mask, out.planar.points, out.planar.mask)
            return {"init": False, "t": scan_end, "t0": t0, "out": out,
                    "dpts": out.points, "dmask": out.mask, "feat": feat}

        # first frame (once per run): unpacked init path; deskew reference =
        # scan end, where the first frame seeds the map (or, resuming, the
        # last persisted keyframe's pose)
        pts, rts, mask = pad_scan(points, rel_times, self.cfg.scan_capacity)
        if self._resume_pose is not None:
            self.mstate, self.fstate, (dpts, dmask) = self.frontend.init_frame_at(
                self.mstate, self._resume_pose, pts, rts - (scan_end - t_start), mask,
                scan_end, deskew_seg, velocity=self._resume_vel)
        else:
            self.mstate, self.fstate, (dpts, dmask) = self.frontend.init_frame(
                self.mstate, pts, rts - (scan_end - t_start), mask, scan_end, deskew_seg)
        self._last_scan_end = scan_end
        return {"init": True, "t": scan_end, "t0": t0, "out": None,
                "pose_dev": self.fstate.nav.pose, "dpts": dpts, "dmask": dmask}

    def retire_batch(self, pendings: list) -> list:
        """Retire several dispatched scans with ONE device->host copy of their
        stacked result rows, then fetch the batch's new keyframe clouds with
        one more copy and persist them."""
        idxs = [i for i, p in enumerate(pendings) if not p["init"]]
        rows = {}
        if idxs:
            stacked = torch.stack([pendings[i]["out"].packed for i in idxs])
            stacked = stacked.cpu().numpy().astype(np.float64)
            rows = {i: stacked[j] for j, i in enumerate(idxs)}
        out = [self.retire_scan(p, rows.get(i)) for i, p in enumerate(pendings)]
        self._flush_lazy()
        return out

    def _flush_lazy(self) -> None:
        materialize_batch(self._lazy_kfs)
        for kf in self._lazy_kfs:
            self.keyframes.flush(kf)
        self._lazy_kfs.clear()

    def retire_scan(self, pending: dict, packed_row=None) -> dict:
        """Materialize one dispatched scan's outputs on the host and run the
        keyframe policy. `packed_row` carries a pre-fetched result row."""
        scan_end = pending["t"]
        if pending["init"]:
            pose = pending["pose_dev"].cpu().numpy().astype(np.float64)
            converged = True
            stats = {"init": True}
        else:
            packed = (packed_row if packed_row is not None
                      else pending["out"].packed.cpu().numpy().astype(np.float64))
            pose = packed[:16].reshape(4, 4)
            converged = bool(packed[32] > 0.5)
            stats = {"init": False, "num_valid": int(packed[33]), "iters": int(packed[34])}
            self._accum_delta = self._accum_delta @ packed[16:32].reshape(4, 4)
        tr = time.perf_counter()
        stats.update({"t": scan_end, "pose": pose, "converged": converged,
                      "wall": tr - pending["t0"], "tr": tr})

        if converged:
            self.trajectory_t.append(scan_end)
            self.trajectory.append(pose)
            if self._is_keyframe(self._accum_delta):
                self._accum_delta = np.eye(4)
                kf = KeyFrame(kf_id=len(self.keyframes), timestamp=scan_end, pose=pose,
                              cloud_dev=(pending["dpts"], pending["dmask"]),
                              feat_dev=pending.get("feat"))
                self.keyframes.add(kf)
                self._lazy_kfs.append(kf)
                stats["keyframe"] = True
                self._on_keyframe(kf.kf_id, pose)
        self.stats.append(stats)
        return stats

    def process_scan(self, t_start: float, scan_end: float, points, rel_times) -> dict | None:
        """Synchronous feed: dispatch and retire one scan."""
        pending = self.dispatch_scan(t_start, scan_end, points, rel_times)
        if pending is None:
            return None
        out = self.retire_scan(pending)
        self._flush_lazy()
        return out

    def _on_keyframe(self, kf_id: int, odom_pose: np.ndarray) -> None:
        """A pose-graph vertex and odometry edge per keyframe; the edge's
        measurement comes from the odometry frame, so loop corrections do not
        leak into later increments. With loop closure on, an accepted loop
        adds its edge, optimizes the graph and rewrites every pose."""
        odom_meas = None
        if self._last_kf_odom_pose is not None:
            odom_meas = np.linalg.inv(self._last_kf_odom_pose) @ odom_pose
        self._last_kf_odom_pose = odom_pose.copy()
        self.graph.add_vertex(odom_pose, odom_meas)
        # the graph's current estimate is the keyframe's corrected pose
        self.keyframes.frames[kf_id].pose = self.graph.poses[kf_id].copy()

        if self.loop_closer is None:
            return
        corrected = self.graph.poses[: self.graph.n_vertices]
        res = self.loop_closer.try_close(self.keyframes.frames, corrected, kf_id)
        if res is None:
            return
        self.loop_results.append(res)
        self.graph.add_edge(res.candidate_id, res.current_id, res.delta_pose,
                            (1e2, 1e2, 1e2, 1e4, 1e4, 1e4))
        g = pg_optimize(self.graph.to_device(device=self.device), self.cfg.pose_graph_iterations)
        new_poses = g.poses.cpu().numpy()
        self.graph.set_poses(new_poses)
        self.keyframes.set_poses(new_poses[: self.graph.n_vertices])
        # persist the corrected history, so a resume starts from it
        self.keyframes.flush_poses()

    # -- map products ----------------------------------------------------
    def save_map(self, map_dir: str, voxel_size: float = 0.3, split: bool = False,
                 tile_size: float = 100.0) -> str:
        """Merge all keyframe clouds (voxel-filtered before and after the
        merge) into `map.pcd`; with `split`, also write the tile maps and
        their index (`maps/split_map.save_tiles`)."""
        os.makedirs(map_dir, exist_ok=True)
        materialize_batch(self.keyframes.frames)
        merged = [host_voxel(kf.cloud, voxel_size) @ kf.pose[:3, :3].T + kf.pose[:3, 3]
                  for kf in self.keyframes.frames]
        cloud = (host_voxel(np.concatenate(merged), voxel_size) if merged
                 else np.zeros((0, 3), np.float32))
        path = os.path.join(map_dir, "map.pcd")
        write_pcd(path, cloud)
        if split:
            save_tiles(map_dir, cloud, tile_size)
        return path

    def run_dataset(self, dataset, max_scans=None, progress=False) -> dict:
        """Run a SimDataset (or any object with the same fields): dispatch
        every scan and retire them in batches of `RETIRE_DEPTH`."""
        scan_period = 1.0 / 10.0
        if len(dataset.scans) >= 2:
            scan_period = dataset.scans[1].t - dataset.scans[0].t
        imu_idx = 0
        n_imu = len(dataset.imu_t)
        results = []
        scans = dataset.scans[:max_scans] if max_scans else dataset.scans
        pending: list = []
        for k, scan in enumerate(scans):
            scan_end = scan.t + scan_period
            while imu_idx < n_imu and dataset.imu_t[imu_idx] <= scan_end + 0.05:
                self.push_imu(dataset.imu_t[imu_idx], dataset.imu_gyro[imu_idx],
                              dataset.imu_accel[imu_idx])
                imu_idx += 1
            nxt = self.dispatch_scan(scan.t, scan_end, scan.points, scan.rel_times)
            if nxt is not None:
                pending.append(nxt)
            if len(pending) >= RETIRE_DEPTH:
                results.extend(self.retire_batch(pending))
                pending.clear()
            if progress and k % 20 == 0:
                print(f"scan {k}/{len(scans)}", flush=True)
        results.extend(self.retire_batch(pending))
        return {
            "poses": np.asarray(self.trajectory),
            "times": np.asarray(self.trajectory_t),
            "n_keyframes": len(self.keyframes),
            "results": results,
        }

