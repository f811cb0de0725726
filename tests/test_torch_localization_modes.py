"""Port parity of localization over the LOAM and NDT matchers: the port's
Localizer against the JAX package's on the same global map, IMU stream and
scans, one case per registration mode (PointToPlane_IVOX,
PointToPlane_KdTree, LoamFull_KdTree with the LOAM front end, and
IncrementalNDT):
  * the map swap (`set_map`) builds the same map: the block maps'
    bookkeeping exact; the NDT map's bookkeeping exact and its moments as
    in tests/test_torch_ndt.py;
  * `fitness` of the first scan at its true pose within 1e-4 relative;
  * the fitness-gated init accepts on both sides, and one tracking step
    from the JAX state, carried across with funny_lidar_slam_torch.convert,
    gives the same pose: NDT within 2e-3 m / 2e-3 rad, as ICP localization
    (tests/test_torch_localization.py); the LOAM modes within 5e-3 m (half
    the GN's 1 cm exit step) and 2e-3 rad; each side within 0.1 m of the
    truth (both sat 4-6.5 cm off it: localization's near-constant offset,
    PERF.md section 7).
The global map is the simulator's world, so the map frame is the world
frame. The scene sits 20-40 m from the origin, where the f32 plane fit of
the LOAM modes decides its gates by rounding, differently in each package
(ROADMAP, Queue 3): the poses there differed by 2.8-3.7 mm."""

import jax
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.cloud import Cloud as JCloud
from funny_lidar_slam_tpu.localization import localizer as jlocm
from funny_lidar_slam_tpu.loam.features import FeatureConfig as JFeatureConfig
from funny_lidar_slam_tpu.loam.projection import LidarGeometry as JGeometry
from funny_lidar_slam_tpu.pipeline.frontend import FrontendConfig as JFrontendConfig
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.cloud import Cloud as TCloud
from funny_lidar_slam_torch.io.pcd import voxel_downsample_np
from funny_lidar_slam_torch.io.simulator import SimConfig, make_world, simulate
from funny_lidar_slam_torch.localization import LocalizationConfig, Localizer
from funny_lidar_slam_torch.loam.features import FeatureConfig
from funny_lidar_slam_torch.loam.projection import LidarGeometry
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.registration import matchers as tm

from test_torch_ndt import assert_map_matches

torch.set_num_threads(1)

CAP = 4096
LOC = dict(local_map_size=80.0, local_map_boundary=20.0, local_map_capacity=65536,
           scan_capacity=CAP, map_filter_size=0.4)
GEOM = dict(n_rows=16, n_cols=900, horizontal_resolution=2 * np.pi / 900, min_distance=1.5,
            max_distance=40.0)
FEAT = dict(corner_capacity=1024, planar_capacity=CAP)
# each mode's config name and fields, the same on both sides (the bench's
# configs, bench.py:312-330, at the tests' scan size)
MODES = {
    "PointToPlane_IVOX": ("PointToPlaneConfig", dict(
        mode="ivox", source_capacity=CAP, cloud_capacity=CAP, map_capacity=131072)),
    "PointToPlane_KdTree": ("PointToPlaneConfig", dict(
        mode="window", source_capacity=CAP, cloud_capacity=CAP, merged_capacity=65536,
        map_capacity=65536)),
    "LoamFull_KdTree": ("LoamFullConfig", dict(
        corner_capacity=1024, planar_capacity=CAP, merged_capacity=65536, map_capacity=65536)),
    "IncrementalNDT": ("NdtConfig", dict(
        voxel_size=2.0, source_filter_size=0.3, source_capacity=CAP, map_capacity=65536,
        min_points_in_voxel=4, min_effective_pts=50, res_outlier_thresh=30.0)),
}


@pytest.fixture(scope="module")
def ds():
    return simulate(SimConfig(duration=3.2, points_per_scan=CAP, max_range=35.0, seed=3))


def localizers(mode):
    name, fields = MODES[mode]
    loam = mode != "IncrementalNDT"
    jfe = JFrontendConfig(fusion_method=FUSION_TIGHT_OPT,
                          lidar_geometry=JGeometry(**GEOM) if loam else None,
                          feature=JFeatureConfig(**FEAT), planar_voxel_filter_size=0.4)
    tfe = FrontendConfig(fusion_method=FUSION_TIGHT_OPT,
                         lidar_geometry=LidarGeometry(**GEOM) if loam else None,
                         feature=FeatureConfig(**FEAT), planar_voxel_filter_size=0.4)
    jl = jlocm.Localizer(jlocm.LocalizationConfig(
        registration_mode=mode, matcher_config=getattr(jm, name)(**fields), frontend=jfe,
        **LOC))
    tl = Localizer(LocalizationConfig(
        registration_mode=mode, matcher_config=getattr(tm, name)(**fields), frontend=tfe,
        **LOC), device="cpu")
    return jl, tl


def feed_imu(locs, ds, end, imu_idx):
    while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
        for loc in locs:
            loc.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
        imu_idx += 1
    return imu_idx


def rot_angle(a, b):
    dr = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))


def assert_pose_close(pt, pj, tol):
    pt, pj = np.asarray(pt, np.float64), np.asarray(pj, np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < tol
    assert rot_angle(pt, pj) < 2e-3


def block_maps(state):
    """The block map(s) a LOAM-family state holds."""
    if hasattr(state, "corner"):
        return [state.corner.m, state.planar.m]
    return [state.w.m if hasattr(state, "w") else state.m]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_localization_mode_matches_jax(ds, mode, monkeypatch):
    monkeypatch.setenv("FLS_AOT_CACHE", "0")  # plain jit: no executable cache on disk
    world = voxel_downsample_np(make_world(3), 0.4)
    jl, tl = localizers(mode)
    jl.global_map = tl.global_map = world
    period = ds.scans[1].t - ds.scans[0].t
    s0, s1 = ds.scans[0], ds.scans[1]
    imu_idx = feed_imu((jl, tl), ds, s0.t + period, 0)

    # the map swap
    center = s0.gt_pose[:3, 3]
    assert jl.refresh_local_map(center, force=True) and tl.refresh_local_map(center, force=True)
    if mode == "IncrementalNDT":
        assert_map_matches(tl.mstate.m, jl.mstate.m)
        assert bool(tl.mstate.first_scan)
    else:
        for mt, mj in zip(block_maps(tl.mstate), block_maps(jax.device_get(jl.mstate))):
            np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
            for f in ("counts", "age", "epoch"):
                np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)))

    # fitness of the first scan's points at its true pose
    pts = np.zeros((CAP, 3), np.float32)
    pts[: len(s0.points)] = s0.points[:CAP]
    msk = np.arange(CAP) < len(s0.points)
    pose = s0.gt_pose.astype(np.float32)
    fj = float(jl.matcher.fitness(jl.mstate, JCloud(jax.numpy.asarray(pts),
                                                    jax.numpy.asarray(msk)), pose, 2.0))
    ft = float(tl.matcher.fitness(tl.mstate, TCloud(torch.as_tensor(pts), torch.as_tensor(msk)),
                                  pose, 2.0))
    assert np.isfinite(fj) and fj < 1.0 and ft == pytest.approx(fj, rel=1e-4)

    # the fitness-gated init
    end0 = s0.t + period
    assert jl.try_init(s0.gt_pose, s0.t, end0, s0.points, s0.rel_times)
    assert tl.try_init(s0.gt_pose, s0.t, end0, s0.points, s0.rel_times)
    tol = 2e-3 if mode == "IncrementalNDT" else 5e-3
    assert_pose_close(tl.trajectory[-1], jl.trajectory[-1], tol)
    truth = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}  # at scan ends
    for traj in (tl.trajectory, jl.trajectory):
        assert np.linalg.norm(traj[-1][:3, 3] - truth[round(end0, 4)][:3, 3]) < 0.1

    # one tracking step from the JAX state
    end1 = s1.t + period
    feed_imu((jl, tl), ds, end1, imu_idx)
    mstate, fstate = jax.device_get((jl.mstate, jl.fstate))
    seg = jl.cfg.imu_segment_capacity
    dseg = jl.imu.get_segment(s1.t, end1, seg)
    pseg = jl.imu.get_segment(jl._last_scan_end, end1, seg)
    buf = jl.frontend.pack_frame(s1.points, s1.rel_times - period, CAP, end1, dseg, pseg)
    out_j = jl.dispatch_scan(s1.t, end1, s1.points, s1.rel_times)["out"]
    tl.frontend.cfg.gravity = jl.cfg.frontend.gravity
    _, _, out_t = tl.frontend.step_packed(convert.matcher_state(mstate),
                                          convert.frontend_state(fstate), buf, CAP, seg)
    assert bool(out_t.converged) == bool(out_j.converged) is True
    assert_pose_close(out_t.pose.numpy(), out_j.pose, tol)
    for pose in (out_t.pose.numpy(), np.asarray(out_j.pose)):
        assert np.linalg.norm(pose[:3, 3] - truth[round(end1, 4)][:3, 3]) < 0.1
