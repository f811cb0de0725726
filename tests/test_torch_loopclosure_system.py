"""The port's mapping run with loop closure end to end on the CPU:
funny_lidar_slam_torch's SlamSystem on the circuit of
tests/test_e2e_loopclosure.py:19-66 (a 6 m circle driven almost twice),
at its config and under its gates: more than 80 tracked scans, at least 20
pose-graph vertices, at least one accepted loop with fitness under the
threshold and an index gap over `skip_near_keyframe`, and a keyframe ATE
(after the pose-graph optimization) under 0.3 m."""

import numpy as np
import torch

from funny_lidar_slam_torch.backend.loop_closure import LoopClosureConfig
from funny_lidar_slam_torch.io.simulator import SimConfig, Trajectory, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

torch.set_num_threads(1)


def test_mapping_with_loopclosure():
    ds = simulate(SimConfig(duration=17.0, points_per_scan=4096, max_range=30.0, seed=5),
                  traj=Trajectory(radius=6.0, omega=0.7))
    mcfg = matchers.IcpConfig(
        source_capacity=4096, cloud_capacity=4096, merged_capacity=16384, map_capacity=16384,
        source_filter_size=0.4, map_filter_size=0.4, local_map_size=20)
    cfg = SystemConfig(
        registration_mode="IcpOptimized", matcher_config=mcfg,
        frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT), scan_capacity=4096,
        keyframe_delta_dist=0.8, enable_loopclosure=True,
        loopclosure=LoopClosureConfig(
            skip_near_loopclosure=10, skip_near_keyframe=15, near_neighbor_distance=4.0,
            candidate_left=3, candidate_right=3, current_left=3, submap_capacity=16384,
            source_capacity=8192, map_capacity=32768, ndt_resolutions=(4.0, 2.0),
            fitness_threshold=1.5),
        pose_graph_vertex_capacity=128, pose_graph_edge_capacity=256)
    slam = SlamSystem(cfg, device="cpu")
    out = slam.run_dataset(ds)

    assert len(out["poses"]) > 80
    assert slam.graph.n_vertices >= 20 and slam.graph.n_vertices == len(slam.keyframes)
    assert len(slam.loop_results) >= 1, "no loop closures accepted"
    for r in slam.loop_results:
        assert r.fitness < cfg.loopclosure.fitness_threshold
        assert r.current_id - r.candidate_id > cfg.loopclosure.skip_near_keyframe
    assert slam.graph.n_edges == slam.graph.n_vertices - 1 + len(slam.loop_results)

    kf_times = [f.timestamp for f in slam.keyframes.frames]
    gt_map = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    gt = np.asarray([gt_map[round(t, 4)] for t in kf_times])
    est = slam.keyframes.poses()
    # every keyframe pose is the graph's (f32) estimate after the last loop
    np.testing.assert_array_equal(est, slam.graph.poses[: len(est)])
    ate = ate_rmse(est, gt, align=True)
    assert ate < 0.3, f"keyframe ATE {ate:.3f} m"
