"""The port's LOAM-geometry mapping end to end on the CPU, as
tests/test_e2e_mapping.py runs the JAX package's: SlamSystem with a lidar
geometry (deskew -> range-image projection -> corner/planar features ->
PointToPlane_IVOX or LoamFull_KdTree -> tight fusion -> keyframes) on the
same simulated 4096-point run, under the same ATE gates."""

import numpy as np
import torch

from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse
from funny_lidar_slam_torch.loam.features import FeatureConfig
from funny_lidar_slam_torch.loam.projection import LidarGeometry
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

torch.set_num_threads(1)


def run_loam_mode(registration_mode, matcher_cfg):
    ds = simulate(SimConfig(duration=10.0, points_per_scan=4096, max_range=35.0, seed=3))
    geom = LidarGeometry(n_rows=16, n_cols=900, horizontal_resolution=2 * np.pi / 900,
                         min_distance=1.5, max_distance=40.0)
    slam = SlamSystem(SystemConfig(
        registration_mode=registration_mode, matcher_config=matcher_cfg,
        frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT, lidar_geometry=geom,
                                feature=FeatureConfig(corner_capacity=1024, planar_capacity=4096),
                                planar_voxel_filter_size=0.4),
        scan_capacity=4096, imu_segment_capacity=16), device="cpu")
    out = slam.run_dataset(ds)
    est = out["poses"]
    assert len(est) >= 40, f"too few tracked scans: {len(est)}"
    gt_map = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    gt = np.asarray([gt_map[round(t, 4)] for t in out["times"]])
    # every keyframe after the first carries its feature clouds, fetched in
    # the batched sweep with the cloud (the first is the unpacked init frame)
    kfs = slam.keyframes.frames
    assert len(kfs) >= 3 and all(kf.materialized for kf in kfs)
    for kf in kfs[1:]:
        assert len(kf.planar) > 500, kf.kf_id
        assert np.isfinite(kf.planar).all() and np.abs(kf.planar).max() < 45.0
    assert sum(len(kf.corner) for kf in kfs[1:]) > 0
    return ate_rmse(est, gt, align=True)


def test_mapping_p2plane_ivox_loam_features():
    cfg = matchers.PointToPlaneConfig(mode="ivox", source_capacity=4096, map_capacity=65536,
                                      bucket_size=8, ivox_voxel_size=0.5, stencil="nearby18",
                                      min_valid_planar=50)
    ate = run_loam_mode("PointToPlane_IVOX", cfg)
    assert ate < 0.3, f"ATE {ate:.3f} m"


def test_mapping_loam_full():
    cfg = matchers.LoamFullConfig(corner_capacity=1024, planar_capacity=4096,
                                  merged_capacity=16384, map_capacity=16384, nn_voxel_size=1.0,
                                  corner_filter_size=0.2, planar_filter_size=0.4,
                                  point_search_thresh=1.0, corner_map_size=20,
                                  planar_map_size=20)
    ate = run_loam_mode("LoamFull_KdTree", cfg)
    assert ate < 0.4, f"ATE {ate:.3f} m"
