"""The port's TightCouplingKF mapping end to end on the CPU, as
tests/test_e2e_mapping.py:70-75 runs the JAX package's: SlamSystem (deskew
-> ESKF predict -> ICP -> ESKF pose update -> keyframes, no
preintegration) on the same simulated 4096-point run, under the same gates
(>= 40 tracked scans, ATE < 0.3 m)."""

import numpy as np
import torch

from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse
from funny_lidar_slam_torch.pipeline import frontend
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

torch.set_num_threads(1)


def test_mapping_eskf_ate(monkeypatch):
    def no_preint(*a, **kw):
        raise AssertionError("TightCouplingKF must not preintegrate")

    monkeypatch.setattr(frontend, "preintegrate", no_preint)
    ds = simulate(SimConfig(duration=10.0, points_per_scan=4096, max_range=35.0, seed=3))
    cfg = matchers.IcpConfig(source_capacity=4096, cloud_capacity=4096, merged_capacity=16384,
                             map_capacity=16384, max_correspond_distance=1.0,
                             source_filter_size=0.4, map_filter_size=0.4, nn_voxel_size=1.0,
                             local_map_size=20)
    slam = SlamSystem(SystemConfig(
        matcher_config=cfg, frontend=frontend.FrontendConfig(fusion_method=frontend.FUSION_TIGHT_KF),
        scan_capacity=4096), device="cpu")
    out = slam.run_dataset(ds)
    assert len(out["poses"]) >= 40, f"too few tracked scans: {len(out['poses'])}"
    gt_map = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    gt = np.asarray([gt_map[round(t, 4)] for t in out["times"]])
    ate = ate_rmse(out["poses"], gt, align=True)
    assert ate < 0.3, f"ATE {ate:.3f} m"
    # the info slot carries the ESKF covariance: symmetric, positive diagonal
    cov = slam.fstate.nav.info.numpy()
    assert np.allclose(cov, cov.T, atol=1e-6 * np.abs(cov).max()) and (np.diag(cov) > 0).all()
