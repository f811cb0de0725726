"""The port's IncrementalNDT mapping end to end on the CPU, as
tests/test_e2e_mapping.py:128-150 runs the JAX package's: SlamSystem
(deskew -> preintegration -> NDT over the incremental Gaussian map -> tight
fusion -> keyframes) on the same simulated 8192-point run with 2 m voxels,
under the same gates (>= 40 tracked scans, ATE < 0.4 m)."""

import numpy as np
import torch

from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse
from funny_lidar_slam_torch.maps import ndt_map
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

torch.set_num_threads(1)


def test_mapping_incremental_ndt():
    ds = simulate(SimConfig(duration=10.0, points_per_scan=8192, max_range=30.0, seed=3))
    cfg = matchers.NdtConfig(voxel_size=2.0, source_filter_size=0.3, source_capacity=8192,
                             map_capacity=65536, min_points_in_voxel=4, min_effective_pts=50,
                             res_outlier_thresh=30.0)
    slam = SlamSystem(SystemConfig(registration_mode="IncrementalNDT", matcher_config=cfg,
                                   frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
                                   scan_capacity=8192), device="cpu")
    out = slam.run_dataset(ds)
    assert len(out["poses"]) >= 40
    gt_map = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    gt = np.asarray([gt_map[round(t, 4)] for t in out["times"]])
    ate = ate_rmse(out["poses"], gt, align=True)
    assert ate < 0.4, f"ATE {ate:.3f} m"
    # the map took every converged scan: many epochs, estimated Gaussians
    m = slam.mstate.m
    assert int(m.epoch) >= 40 and not bool(slam.mstate.first_scan)
    assert 0 < int(ndt_map.num_estimated(m)) <= int(ndt_map.num_occupied(m))
