"""Port parity: the localization CLI (`pipeline/run_slam.py` on a
slam_mode 2 config) of funny_lidar_slam_torch against the JAX package's.

A mapping run of the port's CLI (`--save-map --split-map`, `--device cpu`)
over the bag of `tests/test_torch_cli.py` writes the tile map; then both
packages' CLIs localize the same bag against it (`--map-dir` the tiles,
`--init-pose` the identity: the map frame is the first scan's). Gates:
both initialize; the same TUM stamps, at least 40, each within 0.06 s of a
truth stamp; each aligned ATE against the nearest-stamp truth < 0.3 m; the
two trajectories within 0.1 m RMSE of each other, unaligned."""

import os

import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.io.trajectory import read_tum as jread_tum
from funny_lidar_slam_tpu.pipeline import run_slam as jrun_slam
from funny_lidar_slam_torch.io import bag_export
from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse, read_tum
from funny_lidar_slam_torch.pipeline import run_slam

from test_torch_cli import BAG_YAML

torch.set_num_threads(1)

LOCALIZATION_YAML = BAG_YAML.replace("slam_mode: 1", "slam_mode: 2").replace(
    "tpu:\n", """localization:
    map_path: "unused/map.pcd"
    map_filter_size: 0.3
    local_map_size: 200.0
    local_map_boundary: 50.0
    init_fitness: 1.0
    init_fitness_range: 2.0
tpu:
    local_map_capacity: 65536
""")
IDENTITY = [str(v) for v in np.eye(4).ravel()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_loc")
    ds = simulate(SimConfig(duration=8.0, points_per_scan=4096, max_range=35.0, seed=3))
    bag = str(d / "synth.bag")
    bag_export.dataset_to_bag(ds, bag, lidar_topic="/velodyne_points", imu_topic="/imu/data")
    (d / "mapping.yaml").write_text(BAG_YAML)
    (d / "localization.yaml").write_text(LOCALIZATION_YAML)
    run_slam.main(["--config", str(d / "mapping.yaml"), "--dataset", bag, "--output",
                   str(d / "mapping"), "--save-map", "--split-map", "--device", "cpu"])
    os.environ["FLS_AOT_CACHE"] = "0"
    common = ["--config", str(d / "localization.yaml"), "--dataset", bag,
              "--map-dir", str(d / "mapping" / "map"), "--init-pose", *IDENTITY]
    jrun_slam.main(common + ["--output", str(d / "jax")])
    summary, runner = run_slam.main(common + ["--output", str(d / "torch"), "--device", "cpu"])
    return ds, d, summary, runner


def test_port_localizes_on_the_tiles(runs):
    _, d, summary, runner = runs
    assert (d / "mapping" / "map" / "tile_map_indices.txt").exists()
    assert runner.tiles is not None and runner.device.type == "cpu"
    assert summary["mode"] == "localization" and summary["initialized"] is True


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_trajectory_meets_the_bag_gates(runs, pkg):
    ds, d, _, _ = runs
    times, poses = (jread_tum if pkg == "jax" else read_tum)(str(d / pkg / "trajectory_tum.txt"))
    assert len(poses) >= 40
    idx = np.abs(ds.gt_times[None, :] - times[:, None]).argmin(1)
    assert np.abs(ds.gt_times[idx] - times).max() < 0.06
    assert ate_rmse(poses, ds.gt_poses[idx], align=True) < 0.3


def test_trajectories_agree(runs):
    _, d, _, _ = runs
    tt, tp = read_tum(str(d / "torch" / "trajectory_tum.txt"))
    jt, jp = jread_tum(str(d / "jax" / "trajectory_tum.txt"))
    np.testing.assert_array_equal(tt, jt)
    rmse = np.sqrt(np.mean(np.sum((tp[:, :3, 3] - jp[:, :3, 3]) ** 2, axis=1)))
    assert rmse < 0.1, rmse
