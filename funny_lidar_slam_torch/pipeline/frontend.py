"""Frontend odometry: the per-scan step (port of pipeline/frontend.py).

Per scan: deskew -> IMU predict -> scan-to-map GN -> fusion. The host
streams one packed frame buffer in (`step_packed`) and drains one packed
result row out (`StepResult.packed`); `step` takes the frame unpacked, one
host->device copy an array.

Fusion methods: TightCouplingOptimization (preintegration predict and the
30-dof fusion), LooseCoupling (IMU delta-rotation predict, matcher pose
taken) and TightCouplingKF (the error-state KF of `fusion/eskf.py`, which
keeps its 15x15 error covariance in the nav state's `info` slot); only
TightCouplingOptimization preintegrates. The localization mode starts
from a given pose (`init_from_pose`), a resumed mapping run from the last
keyframe's pose and velocity (`init_frame_at`). With `lidar_geometry` set,
each deskewed scan is projected onto the range image and split into LOAM
corner and planar clouds (`_process`) before matching; the rings are
synthesized from the elevation on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.cloud import Cloud
from ..core.lie import quat_conj, quat_mul, quat_to_mat, se3_inv
from ..core.state import ImuSegment, NavState, to_device_segment, where_tree
from ..fusion import eskf, loose
from ..fusion.tight import TightFusionConfig, fuse as tight_fuse
from ..imu.preintegration import PreintParams, predict, preintegrate
from ..lidar.deskew import deskew
from ..loam.features import FeatureConfig, extract_features
from ..loam.projection import LidarGeometry, project, synth_rings
from ..ops.voxel import voxel_downsample
from ..registration.matchers import LoamFullMatcher

FUSION_LOOSE = "LooseCoupling"
FUSION_TIGHT_OPT = "TightCouplingOptimization"
FUSION_TIGHT_KF = "TightCouplingKF"


class FrontendState(NamedTuple):
    nav: NavState
    last_pose: torch.Tensor  # [4, 4] pose of the previous accepted frame
    delta_pose: torch.Tensor  # [4, 4] last frame-to-frame increment
    initialized: torch.Tensor  # [] bool


class StepResult(NamedTuple):
    pose: torch.Tensor  # [4, 4] fused scan pose
    delta_pose: torch.Tensor
    converged: torch.Tensor
    num_valid: torch.Tensor
    iters: torch.Tensor
    fitness: torch.Tensor
    # deskewed cloud in the body frame at the scan reference time (what a
    # keyframe persists)
    points: torch.Tensor  # [N, 3]
    mask: torch.Tensor  # [N]
    # [pose(16), delta(16), converged, num_valid, iters, fitness] as one f32
    # vector, so the host retires a frame with one device->host copy
    packed: torch.Tensor  # [36]
    # LOAM-geometry modes: the extracted feature clouds (body frame), which
    # keyframes keep; None without lidar_geometry
    corner: Any = None  # Cloud | None
    planar: Any = None


@dataclass
class FrontendConfig:
    fusion_method: str = FUSION_TIGHT_OPT
    gravity: Any = (0.0, 0.0, -9.81)
    t_lidar_to_imu: Any = None  # [4, 4]
    gyro_noise_std: float = 0.01
    acc_noise_std: float = 0.1
    integration_noise_cov: float = 1.0e-8
    fusion: TightFusionConfig = TightFusionConfig()
    init_info_diag: Any = None
    # LOAM feature processing: when the geometry is set, scans are projected
    # and feature-extracted before matching
    lidar_geometry: LidarGeometry | None = None
    feature: FeatureConfig = FeatureConfig()
    planar_voxel_filter_size: float = 0.5


def initial_nav_state(segment_quat_last, dtype=torch.float32) -> NavState:
    """First-frame initialization: pose from the IMU orientation, prior
    covariance diag(1e-6^2 rot, 1e-2^2 vel, 1e-6^2 pos, (0.1 deg)^2 bg,
    0.1^2 ba)."""
    r0 = quat_to_mat(segment_quat_last.to(dtype))
    return _nav_with_init_prior(r0, torch.zeros(3, dtype=dtype, device=r0.device))


def _nav_with_init_prior(r0, p0) -> NavState:
    kw = dict(dtype=r0.dtype, device=r0.device)
    diag = [1e-12] * 3 + [1e-4] * 3 + [1e-12] * 3 + [(0.1 * math.pi / 180.0) ** 2] * 3 + [0.01] * 3
    cov = torch.diag(torch.tensor(diag, **kw))
    info = torch.linalg.inv(cov + 1e-18 * torch.eye(15, **kw))
    return NavState.identity(r0.dtype, r0.device)._replace(r=r0, p=p0, info=info)


class Frontend:
    """The per-scan step around a matcher (any of the five of
    `registration/matchers.py`); runs on the matcher's device."""

    def __init__(self, matcher, cfg: FrontendConfig, dtype=torch.float32):
        self.matcher = matcher
        self.cfg = cfg
        self.dtype = dtype
        self.device = matcher.device
        self.params = PreintParams.from_std(cfg.gyro_noise_std, cfg.acc_noise_std,
                                            cfg.integration_noise_cov, dtype, self.device)
        self.eskf_params = eskf.EskfParams.from_std(
            cfg.gyro_noise_std, cfg.acc_noise_std, cfg.fusion.gyro_rw_std,
            cfg.fusion.acc_rw_std, dtype, self.device)
        self.t_l2i = (torch.eye(4, dtype=dtype, device=self.device)
                      if cfg.t_lidar_to_imu is None
                      else torch.as_tensor(cfg.t_lidar_to_imu, dtype=dtype, device=self.device))

    # -- first frame: init odometer + seed map --
    def _init_impl(self, mstate, points, rel_times, mask, ref_time, segment: ImuSegment,
                   ring):
        n_seg = segment.mask.sum()
        nav = initial_nav_state(segment.quat[torch.clamp(n_seg - 1, min=0)], self.dtype)
        return self._init_from_nav(mstate, nav, points, rel_times, mask, ref_time, segment,
                                   ring)

    def _init_at_impl(self, mstate, pose, vel, points, rel_times, mask, ref_time,
                      segment: ImuSegment, ring):
        """Init at a GIVEN pose (mapping resume): the last keyframe's pose
        and the finite-difference velocity of the last two keyframes, biases
        at zero with the first-frame prior. A resumed run is in motion, so
        the velocity's std is 0.5 m/s, not the standstill 0.01."""
        nav = initial_nav_state(segment.quat[0], self.dtype)
        info = nav.info.clone()
        info[3:6, 3:6] = torch.eye(3, dtype=self.dtype, device=self.device) / 0.5 ** 2
        nav = nav._replace(r=pose[:3, :3].to(self.dtype), p=pose[:3, 3].to(self.dtype),
                           v=vel.to(self.dtype), info=info)
        return self._init_from_nav(mstate, nav, points, rel_times, mask, ref_time, segment,
                                   ring)

    def _init_from_nav(self, mstate, nav, points, rel_times, mask, ref_time,
                       segment: ImuSegment, ring):
        nav = self._kf_prior(nav)
        pts, msk = deskew(points, rel_times, mask, ref_time, segment, self.t_l2i)
        mstate = self._matcher_add_first(mstate, Cloud(pts, msk), nav.pose, ring, rel_times)
        fstate = FrontendState(
            nav=nav._replace(t=ref_time.to(self.dtype)),
            last_pose=nav.pose,
            delta_pose=torch.eye(4, dtype=self.dtype, device=self.device),
            initialized=torch.tensor(True, device=self.device),
        )
        return mstate, fstate, (pts, msk)

    def _step_impl(self, mstate, fstate: FrontendState, points, rel_times, mask,
                   ref_time, deskew_segment: ImuSegment, preint_segment: ImuSegment, ring):
        cfg = self.cfg
        dtype = self.dtype
        gravity = torch.as_tensor(cfg.gravity, dtype=dtype, device=self.device)
        nav = fstate.nav
        ref_t = ref_time.to(dtype)

        pts, msk = deskew(points, rel_times, mask, ref_time, deskew_segment, self.t_l2i)
        # the kernels take gravity by value, so they get the host values
        if cfg.fusion_method == FUSION_TIGHT_OPT:
            pre = preintegrate(preint_segment, self.params, nav.bg, nav.ba)
            pred = predict(pre, nav, gravity)
        elif cfg.fusion_method == FUSION_TIGHT_KF:
            es = eskf.predict(eskf.EskfState(nav=nav, cov=nav.info), preint_segment,
                              self.eskf_params, cfg.gravity)
            pred = es.nav
        elif cfg.fusion_method == FUSION_LOOSE:
            # loose predict: chain the delta pose; rotation from the IMU
            # orientation increment
            n_seg = preint_segment.mask.sum()
            q_first = preint_segment.quat[0].to(dtype)
            q_last = preint_segment.quat[torch.clamp(n_seg - 1, min=0)].to(dtype)
            dq = quat_mul(quat_conj(q_first), q_last)
            pose_pred = nav.pose @ fstate.delta_pose
            pred = nav._replace(r=nav.r @ quat_to_mat(dq), p=pose_pred[:3, 3])
        else:
            raise ValueError(f"unknown fusion method: {cfg.fusion_method}")

        mstate, res, feats = self._matcher_match(mstate, Cloud(pts, msk), pred.pose, ring,
                                                 rel_times)

        if cfg.fusion_method == FUSION_TIGHT_OPT:
            fused = tight_fuse(nav, pre, res.t_mat, pred._replace(t=ref_t), cfg.gravity,
                               cfg.fusion)
        elif cfg.fusion_method == FUSION_TIGHT_KF:
            es = eskf.update_pose(es, res.t_mat, cfg.fusion.lidar_rotation_std,
                                  cfg.fusion.lidar_position_std)
            fused = es.nav._replace(info=es.cov, t=ref_t)
        else:
            fused = loose.fuse(pred._replace(t=ref_t), res.t_mat)

        # the scan is dropped when registration fails
        new_nav = where_tree(res.converged, fused, nav)
        curr_pose = new_nav.pose
        delta = torch.where(res.converged, se3_inv(fstate.last_pose) @ curr_pose,
                            fstate.delta_pose)
        last_pose = torch.where(res.converged, curr_pose, fstate.last_pose)
        new_fstate = FrontendState(nav=new_nav, last_pose=last_pose, delta_pose=delta,
                                   initialized=fstate.initialized)
        packed = torch.cat([
            curr_pose.reshape(-1).float(), delta.reshape(-1).float(),
            torch.stack([res.converged.float(), res.num_valid.float(),
                         res.iters.float(), res.total_res.float()]),
        ])
        out = StepResult(pose=curr_pose, delta_pose=delta, converged=res.converged,
                         num_valid=res.num_valid, iters=res.iters, fitness=res.total_res,
                         points=pts, mask=msk, packed=packed,
                         corner=feats[0] if feats else None,
                         planar=feats[1] if feats else None)
        return mstate, new_fstate, out

    def _process(self, cloud: Cloud, ring, rel_times):
        """LOAM feature branch: project the deskewed cloud and split it into
        (planar, corner) clouds; the planar cloud is voxel-filtered."""
        cfg = self.cfg
        scan = project(cloud.points, ring, rel_times, cloud.mask, cfg.lidar_geometry)
        corner, planar = extract_features(scan, cfg.feature)
        planar = voxel_downsample(planar.points, planar.mask, cfg.planar_voxel_filter_size,
                                  cfg.feature.planar_capacity)
        return Cloud(planar.points, planar.mask), corner

    def _matcher_add_first(self, mstate, cloud: Cloud, pose, ring=None, rel_times=None):
        if self.cfg.lidar_geometry is not None:
            planar, corner = self._process(cloud, ring, rel_times)
            if isinstance(self.matcher, LoamFullMatcher):
                return self.matcher.add_first(mstate, corner, planar, pose)
            return self.matcher.add_first(mstate, planar, pose)
        return self.matcher.add_first(mstate, cloud, pose)

    def _matcher_match(self, mstate, cloud: Cloud, pose, ring=None, rel_times=None):
        """Returns (mstate, GNResult, feats): feats is the (corner, planar)
        Cloud pair in LOAM-geometry modes, None otherwise."""
        if self.cfg.lidar_geometry is not None:
            planar, corner = self._process(cloud, ring, rel_times)
            if isinstance(self.matcher, LoamFullMatcher):
                ms, res = self.matcher.match(mstate, corner, planar, pose)
            else:
                ms, res = self.matcher.match(mstate, planar, pose)
            return ms, res, (corner, planar)
        ms, res = self.matcher.match(mstate, cloud, pose)
        return ms, res, None

    # ------------------------------------------------------------------
    def _default_ring(self, points):
        """Ring ids: synthesized from the elevation with a lidar geometry,
        zeros otherwise."""
        if self.cfg.lidar_geometry is None:
            return torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
        return synth_rings(points, self.cfg.lidar_geometry.n_rows)

    def init_from_pose(self, pose, ref_time) -> FrontendState:
        """Localization-mode initialization: the nav state starts at the
        fitness-gated matched pose with the standard first-frame prior; the
        frozen map is not touched."""
        pose = self._tensor(pose)
        nav = self._kf_prior(_nav_with_init_prior(pose[:3, :3], pose[:3, 3]))
        return FrontendState(
            nav=nav._replace(t=self._tensor(ref_time)),
            last_pose=nav.pose,
            delta_pose=torch.eye(4, dtype=self.dtype, device=self.device),
            initialized=torch.tensor(True, device=self.device),
        )

    def _kf_prior(self, nav: NavState) -> NavState:
        """In KF mode the nav state's info slot holds the error COVARIANCE."""
        if self.cfg.fusion_method == FUSION_TIGHT_KF:
            return nav._replace(info=eskf.create(nav).cov)
        return nav

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype or self.dtype, device=self.device)

    def to_device_segment(self, seg: ImuSegment) -> ImuSegment:
        return to_device_segment(seg, self.dtype, self.device)

    def init_frame(self, mstate, scan_points, rel_times, mask, ref_time, segment, ring=None):
        pts = self._tensor(scan_points)
        ring = (self._default_ring(pts) if ring is None
                else self._tensor(ring, torch.int32))
        return self._init_impl(mstate, pts, self._tensor(rel_times),
                               self._tensor(mask, torch.bool), self._tensor(ref_time),
                               self.to_device_segment(segment), ring)

    def init_frame_at(self, mstate, pose, scan_points, rel_times, mask, ref_time, segment,
                      ring=None, velocity=None):
        """Init at a given world pose (mapping resume)."""
        pts = self._tensor(scan_points)
        ring = (self._default_ring(pts) if ring is None
                else self._tensor(ring, torch.int32))
        vel = (torch.zeros(3, dtype=self.dtype, device=self.device) if velocity is None
               else self._tensor(velocity))
        return self._init_at_impl(mstate, self._tensor(pose), vel, pts, self._tensor(rel_times),
                                  self._tensor(mask, torch.bool), self._tensor(ref_time),
                                  self.to_device_segment(segment), ring)

    def step(self, mstate, fstate, scan_points, rel_times, mask, ref_time, deskew_seg,
             preint_seg, ring=None):
        """The unpacked step: host arrays (or tensors) moved to the device
        one array at a time (scan points, rel times, mask, ref time and the
        two segments' fields), then the same step as `step_packed`."""
        pts = self._tensor(scan_points)
        ring = (self._default_ring(pts) if ring is None
                else self._tensor(ring, torch.int32))
        return self._step_impl(mstate, fstate, pts, self._tensor(rel_times),
                               self._tensor(mask, torch.bool), self._tensor(ref_time),
                               self.to_device_segment(deskew_seg),
                               self.to_device_segment(preint_seg), ring)

    # -- packed single-transfer feed path --------------------------------
    def packed_layout(self, scan_capacity: int, seg_capacity: int):
        """(total_size, offsets) of the packed frame buffer."""
        cap, s = scan_capacity, seg_capacity
        sizes = {
            "pts": cap * 3, "rts": cap, "mask": cap, "ref": 1,
            "d_t": s, "d_gyro": s * 3, "d_accel": s * 3, "d_quat": s * 4, "d_mask": s,
            "p_t": s, "p_gyro": s * 3, "p_accel": s * 3, "p_quat": s * 4, "p_mask": s,
        }
        offs, o = {}, 0
        for k, v in sizes.items():
            offs[k] = (o, o + v)
            o += v
        return o, offs

    def pack_frame(self, points, rel_times, scan_capacity, ref_time,
                   deskew_seg: ImuSegment, preint_seg: ImuSegment) -> np.ndarray:
        """Host-side (NumPy) assembly of the single-transfer frame buffer."""
        s = len(deskew_seg.t)
        total, offs = self.packed_layout(scan_capacity, s)
        buf = np.zeros(total, np.float32)
        n = min(len(points), scan_capacity)
        o = offs["pts"][0]
        buf[o:o + n * 3] = np.asarray(points[:n], np.float32).reshape(-1)
        buf[offs["rts"][0]:offs["rts"][0] + n] = rel_times[:n]
        buf[offs["mask"][0]:offs["mask"][0] + n] = 1.0
        buf[offs["ref"][0]] = ref_time
        for pre, seg in (("d", deskew_seg), ("p", preint_seg)):
            for name, arr in (("t", seg.t), ("gyro", seg.gyro), ("accel", seg.accel),
                              ("quat", seg.quat), ("mask", seg.mask)):
                a, b = offs[f"{pre}_{name}"]
                buf[a:b] = np.asarray(arr, np.float32).reshape(-1)
        return buf

    def _unpack(self, buf: torch.Tensor, scan_capacity: int, seg_capacity: int):
        cap, s = scan_capacity, seg_capacity
        _, offs = self.packed_layout(cap, s)

        def sl(k, shape=None):
            a, b = offs[k]
            v = buf[a:b]
            return v.reshape(shape) if shape else v

        def seg(pre):
            return ImuSegment(t=sl(f"{pre}_t"), gyro=sl(f"{pre}_gyro", (s, 3)),
                              accel=sl(f"{pre}_accel", (s, 3)),
                              quat=sl(f"{pre}_quat", (s, 4)), mask=sl(f"{pre}_mask") > 0.5)

        return (sl("pts", (cap, 3)), sl("rts"), sl("mask") > 0.5, buf[offs["ref"][0]],
                seg("d"), seg("p"))

    def step_packed(self, mstate, fstate, buf_np, scan_capacity, seg_capacity):
        """One host->device copy of the packed frame, then the step. The
        rel_times in the buffer are already relative to the reference time."""
        buf = torch.from_numpy(np.asarray(buf_np, np.float32)).to(self.device)
        pts, rts, mask, ref, dseg, pseg = self._unpack(buf, scan_capacity, seg_capacity)
        return self._step_impl(mstate, fstate, pts, rts, mask, ref, dseg, pseg,
                               self._default_ring(pts))
