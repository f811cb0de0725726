"""The port's kill-and-resume run on the CPU (ICP): the mirror of
tests/test_resume.py:44-84 at its config and under its gates. A mapping
run with a keyframe store fed the first half of a 10 s run scan by scan
(`process_scan`), then `SlamSystem.resume` in a new system fed the rest:
the same keyframes and pose-graph vertices after the resume, at least 10
tracked scans after it, a combined ATE under 0.4 m, and the first resumed
pose within 2.5 m of the last persisted keyframe. The uninterrupted run
supplies the first half's scan times, as in the JAX test."""

import numpy as np
import torch

from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers

torch.set_num_threads(1)

ICP_CFG = matchers.IcpConfig(
    source_capacity=4096, cloud_capacity=4096, merged_capacity=16384, map_capacity=16384,
    max_correspond_distance=1.0, source_filter_size=0.4, map_filter_size=0.4,
    nn_voxel_size=1.0, local_map_size=20)


def sys_cfg(path):
    return SystemConfig(registration_mode="IcpOptimized", matcher_config=ICP_CFG,
                        frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
                        scan_capacity=4096, keyframe_save_dir=str(path / "keyframes"))


def feed(slam, ds, scan_lo, scan_hi):
    """Push the IMU up to the last fed scan's end, then process the scans
    one at a time (tests/test_resume.py:32-41)."""
    period = ds.scans[1].t - ds.scans[0].t
    t_hi = ds.scans[scan_hi - 1].t + period + 0.05 if scan_hi < len(ds.scans) else np.inf
    for k in range(len(ds.imu_t)):
        if ds.imu_t[k] > t_hi:
            break
        slam.push_imu(ds.imu_t[k], ds.imu_gyro[k], ds.imu_accel[k])
    for scan in ds.scans[scan_lo:scan_hi]:
        slam.process_scan(scan.t, scan.t + period, scan.points, scan.rel_times)


def combined_ate(ds, times, poses):
    gt_map = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    keep = [i for i, t in enumerate(times) if round(float(t), 4) in gt_map]
    gt = np.asarray([gt_map[round(float(times[i]), 4)] for i in keep])
    return ate_rmse(np.asarray(poses)[keep], gt, align=True)


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    ds = simulate(SimConfig(duration=10.0, points_per_scan=4096, max_range=35.0, seed=3))
    n = len(ds.scans)
    half = n // 2

    ref = SlamSystem(sys_cfg(tmp_path / "ref"), device="cpu")
    assert len(ref.run_dataset(ds)["poses"]) >= 40

    a = SlamSystem(sys_cfg(tmp_path / "ab"), device="cpu")
    feed(a, ds, 0, half)
    n_kf_a = len(a.keyframes)
    assert n_kf_a >= 2, "first half produced too few keyframes"
    poses_a = np.asarray(a.trajectory)
    del a  # "kill"

    b = SlamSystem.resume(sys_cfg(tmp_path / "ab"), device="cpu")
    assert len(b.keyframes) == n_kf_a and b.graph.n_vertices == n_kf_a
    feed(b, ds, half, n)
    assert len(b.trajectory) >= 10, "resumed run tracked too few scans"

    times = np.concatenate([np.asarray(ref.trajectory_t)[: len(poses_a)],
                            np.asarray(b.trajectory_t)])
    ate = combined_ate(ds, times, np.concatenate([poses_a, np.asarray(b.trajectory)]))
    assert ate < 0.4, f"kill-and-resume ATE {ate:.3f} m"
    d0 = np.linalg.norm(np.asarray(b.trajectory)[0][:3, 3]
                        - b.keyframes.frames[n_kf_a - 1].pose[:3, 3])
    assert d0 < 2.5, f"resume jumped {d0:.2f} m from the last keyframe"
    # the resumed run goes on writing to the same store
    assert len(b.keyframes) > n_kf_a
    assert (tmp_path / "ab" / "keyframes" / f"keyframe_{len(b.keyframes) - 1}.npz").exists()
