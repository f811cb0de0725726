"""Port parity: the mapping CLI (`pipeline/run_slam.py`) of
funny_lidar_slam_torch against the JAX package's on one ROS1 bag.

The bag and the YAML are those of `tests/test_bag_path.py` (a simulated
8 s run, 4,096 points a scan, IcpOptimized with tight coupling). Both CLIs
map it with `--save-map`, the port with `--device cpu`. Gates:
- both write the same TUM stamps, at least 40 of them, each within 0.06 s
  of a truth stamp, and each trajectory's aligned ATE against the
  nearest-stamp truth is < 0.3 m (the JAX test's gates);
- the two trajectories are within 0.1 m RMSE of each other, unaligned;
- each `map.pcd` equals exactly the other package's `save_map` of the
  keyframe store its CLI wrote; the two maps differ only as the
  trajectories do (they cannot agree to 1e-5 m: the trajectories differ by
  up to a few cm, f32 sums in another order through the tight fusion's LM).
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from funny_lidar_slam_tpu.io.pcd import read_pcd as jread_pcd
from funny_lidar_slam_tpu.io.trajectory import read_tum as jread_tum
from funny_lidar_slam_tpu.pipeline import keyframes as jkf
from funny_lidar_slam_tpu.pipeline import run_slam as jrun_slam
from funny_lidar_slam_tpu.pipeline import system as jsys
from funny_lidar_slam_torch.io import bag_export
from funny_lidar_slam_torch.io.pcd import read_pcd
from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse, read_tum
from funny_lidar_slam_torch.pipeline import keyframes as tkf
from funny_lidar_slam_torch.pipeline import run_slam
from funny_lidar_slam_torch.pipeline import system as tsys

torch.set_num_threads(1)

BAG_YAML = """
sensor_topic:
    lidar_topic: "/velodyne_points"
    imu_topic: "/imu/data"
slam_mode: 1
lidar:
    lidar_sensor_type: Velodyne_16
    lidar_point_jump_span: 1
    lidar_point_time_scale: 1.0
    lidar_use_min_distance: 1.0
    lidar_use_max_distance: 100.0
    lidar_rotation_noise_std: 0.005
    lidar_position_noise_std: 0.01
imu:
    has_orientation: false
    acc_noise_std: 0.1
    gyro_noise_std: 0.01
    acc_rw_noise_std: 1.0e-4
    gyro_rw_noise_std: 1.0e-4
    data_searcher_buffer_size: 2000
gravity: 9.81
calibration:
    lidar_to_imu: [ 1., 0., 0., 0.,
                    0., 1., 0., 0.,
                    0., 0., 1., 0.,
                    0., 0., 0., 1. ]
frontend:
    fusion_method: TightCouplingOptimization
    registration_and_searcher_mode: IcpOptimized
    registration:
        optimization_iter_num: 30
        max_correspond_distance: 1.0
        source_filter_size: 0.4
        map_filter_size: 0.4
        local_map_size: 20
        position_converge_thres: 0.01
        rotation_converge_thres: 0.05
system:
    keyframe_delta_distance: 1.0
    keyframe_delta_rotation: 0.2
loopclosure:
    skip_near_loopclosure_threshold: 100
tpu:
    scan_capacity: 4096
    source_capacity: 4096
    cloud_capacity: 4096
    merged_capacity: 16384
    map_capacity: 16384
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ds = simulate(SimConfig(duration=8.0, points_per_scan=4096, max_range=35.0, seed=3))
    bag = str(d / "synth.bag")
    bag_export.dataset_to_bag(ds, bag, lidar_topic="/velodyne_points", imu_topic="/imu/data")
    cfg = d / "config_bag_test.yaml"
    cfg.write_text(BAG_YAML)
    os.environ["FLS_AOT_CACHE"] = "0"
    common = ["--config", str(cfg), "--dataset", bag, "--save-map"]
    jrun_slam.main(common + ["--output", str(d / "jax")])
    summary, runner = run_slam.main(common + ["--output", str(d / "torch"), "--device", "cpu"])
    return ds, d, summary, runner


def test_port_cli_runs_on_the_cpu(runs):
    _, _, summary, runner = runs
    assert runner.device.type == "cpu"
    assert summary["mode"] == "mapping" and summary["frames"] >= 40
    json.dumps(summary)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_trajectory_meets_the_bag_gates(runs, pkg):
    ds, d, _, _ = runs
    times, poses = (jread_tum if pkg == "jax" else read_tum)(str(d / pkg / "trajectory_tum.txt"))
    assert len(poses) >= 40
    idx = np.abs(ds.gt_times[None, :] - times[:, None]).argmin(1)
    assert np.abs(ds.gt_times[idx] - times).max() < 0.06
    assert ate_rmse(poses, ds.gt_poses[idx], align=True) < 0.3
    assert (d / pkg / "map" / "map.pcd").exists()
    assert (d / pkg / "pose_graph.g2o").exists()


def test_trajectories_agree(runs):
    _, d, _, _ = runs
    tt, tp = read_tum(str(d / "torch" / "trajectory_tum.txt"))
    jt, jp = jread_tum(str(d / "jax" / "trajectory_tum.txt"))
    np.testing.assert_array_equal(tt, jt)
    rmse = np.sqrt(np.mean(np.sum((tp[:, :3, 3] - jp[:, :3, 3]) ** 2, axis=1)))
    assert rmse < 0.1, rmse


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_map_is_the_other_packages_save_map(runs, pkg, tmp_path):
    """Each CLI's `map.pcd` equals, exactly, the other package's `save_map`
    of the keyframe store that CLI wrote (one C++ voxel filter in both)."""
    _, d, _, _ = runs
    store = str(d / pkg / "keyframes")
    if pkg == "jax":
        slam = tsys.SlamSystem(tsys.SystemConfig(), device="cpu")
        slam.keyframes = tkf.KeyFrameStore.load(store)
        path = slam.save_map(str(tmp_path / "map"))
    else:
        slam = jsys.SlamSystem(jsys.SystemConfig())
        slam.keyframes = jkf.KeyFrameStore.load(store)
        path = slam.save_map(str(tmp_path / "map"))
    again, _ = read_pcd(path)
    written, _ = read_pcd(str(d / pkg / "map" / "map.pcd"))
    assert len(written) > 1000
    np.testing.assert_array_equal(again, written)


def test_maps_agree_within_the_trajectories(runs):
    """The two maps differ as the trajectories do (up to a few cm): 90 % of
    either map's points lie within 0.1 m of the other map, and the point
    counts agree to 2 %."""
    _, d, _, _ = runs
    t, _ = read_pcd(str(d / "torch" / "map" / "map.pcd"))
    j, _ = jread_pcd(str(d / "jax" / "map" / "map.pcd"))
    assert abs(len(t) - len(j)) <= 0.02 * len(j)
    for a, b in ((t, j), (j, t)):
        dist, _ = cKDTree(b).query(a)
        assert np.quantile(dist, 0.9) < 0.1
