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


def test_unported_modes_raise():
    """The default config builds (the hashed block map is ported); the modes
    of later slices still refuse to: IncrementalNDT and TightCouplingKF."""
    assert isinstance(SlamSystem(SystemConfig(), device="cpu").mstate.m, block_map.BlockMap)
    with pytest.raises(NotImplementedError):
        SlamSystem(SystemConfig(registration_mode="IncrementalNDT"), device="cpu")
    with pytest.raises(NotImplementedError):
        SlamSystem(SystemConfig(frontend=FrontendConfig(fusion_method="TightCouplingKF")),
                   device="cpu")


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


@pytest.mark.parametrize("mode", sorted(LOAM_MODES))
def test_localizer_refuses_loam_modes(mode):
    """Localization keeps to IcpOptimized in the port so far."""
    from funny_lidar_slam_torch.localization import LocalizationConfig, Localizer

    with pytest.raises(NotImplementedError):
        Localizer(LocalizationConfig(registration_mode=mode), device="cpu")
