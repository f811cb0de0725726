"""The port's kill-and-resume runs on the CPU for the feature modes: the
mirror of tests/test_resume.py:87-173 (LoamFull_KdTree and
PointToPlane_IVOX) at its configs and under its gates. The first half of
an 8 s run persists its keyframes with their feature clouds; the resumed
system reseeds its feature maps from them and is fed from the last
keyframe's scan on: the same keyframe count, planar (and for LoamFull
corner) features on the last keyframe before and after the store's round
trip, at least 10 tracked scans after the resume, and a combined ATE under
0.5 m (LoamFull) or 0.4 m (IVOX)."""

import numpy as np
import pytest
import torch

from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.loam.features import FeatureConfig
from funny_lidar_slam_torch.loam.projection import LidarGeometry
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

from test_torch_resume import combined_ate, feed

torch.set_num_threads(1)


def loam_sys_cfg(path, mode):
    geom = LidarGeometry(n_rows=16, n_cols=900, horizontal_resolution=2 * np.pi / 900,
                         min_distance=1.5, max_distance=40.0)
    if mode == "LoamFull_KdTree":
        mcfg = matchers.LoamFullConfig(
            corner_capacity=1024, planar_capacity=4096, merged_capacity=16384,
            map_capacity=16384, nn_voxel_size=1.0, corner_filter_size=0.2,
            planar_filter_size=0.4, point_search_thresh=1.0, corner_map_size=20,
            planar_map_size=20)
    else:
        mcfg = matchers.PointToPlaneConfig(
            mode="ivox", source_capacity=4096, map_capacity=65536, bucket_size=8,
            ivox_voxel_size=0.5, stencil="nearby18", min_valid_planar=50)
    return SystemConfig(
        registration_mode=mode, matcher_config=mcfg,
        frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT, lidar_geometry=geom,
                                feature=FeatureConfig(corner_capacity=1024, planar_capacity=4096),
                                planar_voxel_filter_size=0.4),
        scan_capacity=4096, keyframe_save_dir=str(path / "keyframes"))


@pytest.mark.parametrize("mode,ate_gate", [("LoamFull_KdTree", 0.5), ("PointToPlane_IVOX", 0.4)])
def test_kill_and_resume_feature_modes(tmp_path, mode, ate_gate):
    ds = simulate(SimConfig(duration=8.0, points_per_scan=4096, max_range=35.0, seed=3))
    n = len(ds.scans)
    half = n // 2

    a = SlamSystem(loam_sys_cfg(tmp_path, mode), device="cpu")
    feed(a, ds, 0, half)
    n_kf_a = len(a.keyframes)
    assert n_kf_a >= 2
    kf_last = a.keyframes.frames[-1]
    assert kf_last.planar is not None and len(kf_last.planar) > 0
    if mode == "LoamFull_KdTree":
        assert kf_last.corner is not None and len(kf_last.corner) > 0
    poses_a, times_a = np.asarray(a.trajectory), np.asarray(a.trajectory_t)
    del a  # "kill"

    b = SlamSystem.resume(loam_sys_cfg(tmp_path, mode), device="cpu")
    assert len(b.keyframes) == n_kf_a
    assert b.keyframes.frames[-1].planar is not None
    # feed from the last keyframe's scan on: the init pose is that keyframe's
    t_kf = b.keyframes.frames[-1].timestamp
    period = ds.scans[1].t - ds.scans[0].t
    resume_idx = next(i for i, s in enumerate(ds.scans) if s.t + period > t_kf)
    feed(b, ds, resume_idx, n)
    assert len(b.trajectory) >= 10, "resumed run tracked too few scans"

    ate = combined_ate(ds, np.concatenate([times_a, np.asarray(b.trajectory_t)]),
                       np.concatenate([poses_a, np.asarray(b.trajectory)]))
    assert ate < ate_gate, f"{mode} kill-and-resume ATE {ate:.3f} m"
