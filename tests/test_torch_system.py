"""The port's mapping run end to end on the CPU: funny_lidar_slam_torch's
SlamSystem (IMU static init -> deskew -> preintegration -> ICP over the
dense grid or the hashed block map -> tight fusion -> keyframing)
free-running on the simulated dataset of tests/test_e2e_mapping.py, under
the same ATE gate (< 0.3 m over at least 40 tracked scans)."""

import numpy as np
import pytest
import torch

from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse, rpe_rmse
from funny_lidar_slam_torch.maps import block_map
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

torch.set_num_threads(1)


def run_mapping(**layout):
    ds = simulate(SimConfig(duration=10.0, points_per_scan=4096, max_range=35.0, seed=3))
    icp = matchers.IcpConfig(
        source_capacity=4096, cloud_capacity=4096, merged_capacity=16384,
        map_capacity=16384, max_correspond_distance=1.0, source_filter_size=0.4,
        map_filter_size=0.4, nn_voxel_size=1.0, local_map_size=20, group_capacity=4096,
        **layout)
    slam = SlamSystem(SystemConfig(matcher_config=icp,
                                   frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
                                   scan_capacity=4096, imu_segment_capacity=16),
                      device="cpu")
    out = slam.run_dataset(ds)
    est = out["poses"]
    assert len(est) >= 40, f"too few tracked scans: {len(est)}"
    gt_map = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    gt = np.asarray([gt_map[round(t, 4)] for t in out["times"]])
    ate = ate_rmse(est, gt, align=True)
    assert ate < 0.3, f"ATE {ate:.3f} m"
    assert rpe_rmse(est, gt) < 0.1
    assert out["n_keyframes"] >= 3
    return slam


def test_mapping_tight_coupling_grid_ate():
    slam = run_mapping(map_layout="grid", grid_dims=(48, 48, 12))
    # keyframe clouds were fetched in the batched sweep: deskewed body-frame
    # points, finite and within the simulated range
    kf = slam.keyframes.frames[-1]
    assert kf.materialized and len(kf.cloud) > 1000
    assert np.isfinite(kf.cloud).all() and np.abs(kf.cloud).max() < 40.0


def test_mapping_tight_coupling_block_ate():
    """The IcpConfig default layout: the hashed block map with incremental
    block inserts (claim_rounds=2, max_age eviction)."""
    slam = run_mapping()
    m = slam.mstate.m
    assert isinstance(m, block_map.BlockMap)
    assert 0.0 < float(block_map.load_factor(m)) < 0.5
    assert int(m.epoch) >= 3  # the map took several inserts


LOAM_MODES = {"PointToPlane_IVOX": matchers.P2PlaneIvoxState,
              "PointToPlane_KdTree": matchers.P2PlaneWindowState,
              "LoamFull_KdTree": matchers.LoamFullState}


@pytest.mark.parametrize("mode", sorted(LOAM_MODES))
def test_loam_modes_build(mode):
    """The three LOAM-family modes build on the CPU with their default
    matcher configs, each with its own state type."""
    slam = SlamSystem(SystemConfig(registration_mode=mode), device="cpu")
    assert isinstance(slam.mstate, LOAM_MODES[mode])
    assert slam.device.type == "cpu"


MODE_STATES = {"IcpOptimized": matchers.WindowMapState, "IncrementalNDT": matchers.NdtState,
               **LOAM_MODES}
FUSIONS = ["TightCouplingOptimization", "LooseCoupling", "TightCouplingKF"]
SMALL = 4096
SMALL_CONFIGS = {
    "IcpOptimized": lambda: matchers.IcpConfig(
        source_capacity=SMALL, cloud_capacity=SMALL, merged_capacity=8192, map_capacity=8192,
        local_map_size=20, group_capacity=SMALL),
    "IncrementalNDT": lambda: matchers.NdtConfig(
        voxel_size=2.0, source_filter_size=0.3, source_capacity=SMALL, map_capacity=16384,
        min_points_in_voxel=4, min_effective_pts=50, res_outlier_thresh=30.0),
    "PointToPlane_IVOX": lambda: matchers.PointToPlaneConfig(
        mode="ivox", source_capacity=SMALL, cloud_capacity=SMALL, map_capacity=16384),
    # the window maps insert every 0.2 m here, so a short run fills them
    "PointToPlane_KdTree": lambda: matchers.PointToPlaneConfig(
        mode="window", source_capacity=SMALL, cloud_capacity=SMALL, merged_capacity=16384,
        map_capacity=16384, dist_thresh_add_cloud=0.2),
    "LoamFull_KdTree": lambda: matchers.LoamFullConfig(
        corner_capacity=1024, planar_capacity=SMALL, merged_capacity=16384, map_capacity=16384,
        corner_map_size=20, planar_map_size=20, dist_thresh_add_cloud=0.2),
}


@pytest.fixture(scope="module")
def short_run():
    """The static IMU warm-up, then 5 moving scans."""
    return simulate(SimConfig(duration=3.4, points_per_scan=SMALL, max_range=35.0, seed=3))


@pytest.mark.parametrize("fusion", FUSIONS)
@pytest.mark.parametrize("mode", sorted(MODE_STATES))
def test_every_mode_builds(mode, fusion, short_run):
    """Every registration mode builds with every fusion method on the CPU,
    each mode with its own matcher state type, and maps the first moving
    scans of a run: every one tracked, finite, at an ATE under 1 m. (The
    map holds a scan or two here, so the accuracy gates are those of the
    long runs: run_mapping above and tests/test_torch_*_system.py.)"""
    from funny_lidar_slam_torch.loam.features import FeatureConfig
    from funny_lidar_slam_torch.loam.projection import LidarGeometry

    geom = None
    if mode in LOAM_MODES:
        geom = LidarGeometry(n_rows=16, n_cols=900, horizontal_resolution=2 * np.pi / 900,
                             min_distance=1.5, max_distance=40.0)
    fe = FrontendConfig(fusion_method=fusion, lidar_geometry=geom,
                        feature=FeatureConfig(corner_capacity=1024, planar_capacity=SMALL),
                        planar_voxel_filter_size=0.4)
    slam = SlamSystem(SystemConfig(registration_mode=mode, matcher_config=SMALL_CONFIGS[mode](),
                                   frontend=fe, scan_capacity=SMALL, imu_segment_capacity=16),
                      device="cpu")
    assert isinstance(slam.mstate, MODE_STATES[mode])
    assert slam.device.type == "cpu"
    out = slam.run_dataset(short_run)
    steps = [s for s in slam.stats if not s["init"]]
    assert len(steps) >= 5 and all(s["converged"] for s in steps)
    gt = {round(t, 4): p for t, p in zip(short_run.gt_times, short_run.gt_poses)}
    ref = np.asarray([gt[round(t, 4)] for t in out["times"]])
    ate = ate_rmse(out["poses"], ref, align=True)
    assert np.isfinite(out["poses"]).all() and ate < 1.0, f"ATE {ate:.3f} m"


@pytest.mark.parametrize("mode", sorted(MODE_STATES))
def test_localizer_builds(mode):
    """The Localizer takes every registration mode, its matcher in
    localization mode."""
    from funny_lidar_slam_torch.localization import LocalizationConfig, Localizer

    loc = Localizer(LocalizationConfig(registration_mode=mode), device="cpu")
    assert isinstance(loc.mstate, MODE_STATES[mode])
    assert loc.matcher.cfg.is_localization_mode and loc.device.type == "cpu"
