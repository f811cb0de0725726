"""SLAM system orchestration, mapping mode (port of pipeline/system.py).

Per scan: extract the IMU segments on the host (NumPy), run the frontend
step on the device, then apply the host-side keyframe policy. Scans are
dispatched ahead and retired in batches, each batch with one device->host
copy of the per-frame result rows.

`build_matcher` also serves the localization mode
(`localization/localizer.py`). Not ported yet (later slices): loop closure
and the pose-graph backend, resume with keyframe persistence, and
`save_map`. With loop closure off the JAX package's pose graph leaves each
keyframe at its odometry pose, which is what this port keeps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..imu.stream import ImuStream
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
    # when False (loose coupling without the static-init need) skip it
    require_imu_static_init: bool = True


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
    """Mapping-mode SLAM: frontend odometry + keyframing. Runs on `device`
    (default: CUDA; pass device='cpu' for the CPU)."""

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
        self.keyframes = KeyFrameStore()
        self.trajectory_t: list[float] = []
        self.trajectory: list[np.ndarray] = []
        self._accum_delta = np.eye(4)
        self._last_scan_end: float | None = None
        self.stats: list[dict] = []
        # keyframes whose clouds still live on the device, fetched per batch
        self._lazy_kfs: list = []

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
        # scan end, where the first frame seeds the map
        pts, rts, mask = pad_scan(points, rel_times, self.cfg.scan_capacity)
        self.mstate, self.fstate, (dpts, dmask) = self.frontend.init_frame(
            self.mstate, pts, rts - (scan_end - t_start), mask, scan_end, deskew_seg)
        self._last_scan_end = scan_end
        return {"init": True, "t": scan_end, "t0": t0, "out": None,
                "pose_dev": self.fstate.nav.pose, "dpts": dpts, "dmask": dmask}

    def retire_batch(self, pendings: list) -> list:
        """Retire several dispatched scans with ONE device->host copy of their
        stacked result rows, then fetch the batch's new keyframe clouds with
        one more copy."""
        idxs = [i for i, p in enumerate(pendings) if not p["init"]]
        rows = {}
        if idxs:
            stacked = torch.stack([pendings[i]["out"].packed for i in idxs])
            stacked = stacked.cpu().numpy().astype(np.float64)
            rows = {i: stacked[j] for j, i in enumerate(idxs)}
        out = [self.retire_scan(p, rows.get(i)) for i, p in enumerate(pendings)]
        materialize_batch(self._lazy_kfs)
        self._lazy_kfs.clear()
        return out

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
        self.stats.append(stats)
        return stats

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

