"""The port's localization mode (funny_lidar_slam_torch.localization) on the
CPU: tracking against the frozen simulator world through the crop-box and
the tile-map sources under the gates of tests/test_localization.py
(>= 35 tracked scans, ATE < 0.3 m in the map frame), the fitness-gated
init, and parity with the JAX package's Localizer: the map swap
(`set_map`) and `fitness` on the same local map, then the init match and
one tracking step from the same state.

The global map is the simulator's world point set, so the map frame is the
world frame and the simulator's truth is the reference trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.io import pcd as jpcd
from funny_lidar_slam_tpu.localization import localizer as jlocm
from funny_lidar_slam_tpu.maps import split_map as jsplit
from funny_lidar_slam_tpu.pipeline.frontend import FrontendConfig as JFrontendConfig
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.io.pcd import read_pcd, voxel_downsample_np, write_pcd
from funny_lidar_slam_torch.io.simulator import SimConfig, make_world, simulate
from funny_lidar_slam_torch.io.trajectory import ate_rmse
from funny_lidar_slam_torch.localization import LocalizationConfig, Localizer
from funny_lidar_slam_torch.maps import block_map, split_map
from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
from funny_lidar_slam_torch.registration import matchers as tm

torch.set_num_threads(1)

CAP = 4096
ICP = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=16384,
           map_capacity=16384, local_map_size=20, source_filter_size=0.4,
           map_filter_size=0.4)
LOC = dict(registration_mode="IcpOptimized", local_map_size=80.0, local_map_boundary=20.0,
           local_map_capacity=65536, scan_capacity=CAP, map_filter_size=0.4)


@pytest.fixture(scope="module")
def ds():
    return simulate(SimConfig(duration=10.0, points_per_scan=CAP, max_range=35.0, seed=3))


def port_localizer(**kw):
    cfg = LocalizationConfig(matcher_config=tm.IcpConfig(**ICP),
                             frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
                             **dict(LOC, **kw))
    return Localizer(cfg, device="cpu")


def jax_localizer():
    cfg = jlocm.LocalizationConfig(matcher_config=jm.IcpConfig(**ICP),
                                   frontend=JFrontendConfig(fusion_method=FUSION_TIGHT_OPT),
                                   **LOC)
    return jlocm.Localizer(cfg)


def assert_tracks(loc, out, ds):
    assert loc.initialized
    assert len(out["poses"]) >= 35
    gt = {round(t, 4): p for t, p in zip(ds.gt_times, ds.gt_poses)}
    ref = np.asarray([gt[round(t, 4)] for t in out["times"]])
    ate = ate_rmse(out["poses"], ref, align=False)
    assert ate < 0.3, f"localization ATE {ate:.3f} m"


def test_localization_cropbox(ds):
    loc = port_localizer()
    loc.set_global_map(make_world(3))
    out = loc.run_dataset(ds, ds.scans[0].gt_pose)
    assert_tracks(loc, out, ds)
    assert loc.map_refreshes >= 1
    assert isinstance(loc.mstate.m, block_map.BlockMap)


def test_localization_tilemap(ds, tmp_path):
    """Tiles written by the port's own save_tiles, 40 m on a side."""
    indices = split_map.save_tiles(str(tmp_path), voxel_downsample_np(make_world(3), 0.3),
                                   tile_size=40.0)
    assert len(indices) >= 9
    loc = port_localizer(tile_map_dir=str(tmp_path))
    loc.tiles.tile_size = 40.0
    out = loc.run_dataset(ds, ds.scans[0].gt_pose)
    assert_tracks(loc, out, ds)


def test_localization_init_gate_rejects_bad_pose(ds):
    """A far-off init pose must fail the fitness gate (fitness < 1.0 at 2 m)
    on every one of the first scans."""
    loc = port_localizer()
    loc.set_global_map(make_world(3))
    bad = ds.scans[0].gt_pose.copy()
    bad[:3, 3] += np.array([150.0, 150.0, 0.0])  # outside the mapped area
    imu_idx, ok = 0, False
    period = ds.scans[1].t - ds.scans[0].t
    for scan in ds.scans[:6]:
        end = scan.t + period
        while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
            loc.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
            imu_idx += 1
        ok = ok or loc.try_init(bad, scan.t, end, scan.points, scan.rel_times)
    assert loc.map_refreshes == 6  # every scan tried the init
    assert not ok and not loc.initialized


def test_pcd_and_tiles_match_jax(tmp_path):
    """The port's PCD writer, host voxel filter and tile split against the
    JAX package's readers and filter."""
    pts = make_world(5)[::7]
    np.testing.assert_array_equal(voxel_downsample_np(pts, 0.5),
                                  jpcd.voxel_downsample_np(pts, 0.5))
    write_pcd(str(tmp_path / "a.pcd"), pts)
    np.testing.assert_array_equal(jpcd.read_pcd(str(tmp_path / "a.pcd"))[0], pts)
    jpcd.write_pcd(str(tmp_path / "b.pcd"), pts, binary=False)
    np.testing.assert_allclose(read_pcd(str(tmp_path / "b.pcd"))[0], pts, atol=1e-6)
    split_map.save_tiles(str(tmp_path / "tiles"), pts, tile_size=40.0)
    jt = jsplit.TileMapLoader(str(tmp_path / "tiles"), tile_size=40.0)
    tt = split_map.TileMapLoader(str(tmp_path / "tiles"), tile_size=40.0)
    assert jt.available == tt.available
    assert tt.update(np.array([25.0, -3.0])) and jt.update(np.array([25.0, -3.0]))
    np.testing.assert_array_equal(tt.local_cloud(), jt.local_cloud())


def feed_imu(locs, ds, end, imu_idx):
    while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
        for loc in locs:
            loc.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
        imu_idx += 1
    return imu_idx


def rot_angle(a, b):
    dr = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))


def test_set_map_fitness_init_and_step_match_jax(ds, monkeypatch):
    """Both localizers get the same global map array and IMU stream:
      * the map swap builds the same block map (bookkeeping exact);
      * fitness of the first scan at its true pose agrees within 1e-4;
      * the fitness-gated init accepts on both, at poses within 2e-3;
      * one tracking step from the JAX state (carried across) gives the
        same pose within 2e-3 m / 2e-3 rad."""
    monkeypatch.setenv("FLS_AOT_CACHE", "0")  # plain jit: no executable cache on disk
    world = voxel_downsample_np(make_world(3), 0.4)
    jl, tl = jax_localizer(), port_localizer()
    jl.global_map = tl.global_map = world
    period = ds.scans[1].t - ds.scans[0].t
    s0, s1 = ds.scans[0], ds.scans[1]
    imu_idx = feed_imu((jl, tl), ds, s0.t + period, 0)

    center = s0.gt_pose[:3, 3]
    assert jl.refresh_local_map(center, force=True) and tl.refresh_local_map(center, force=True)
    mj, mt = jax.device_get(jl.mstate.m), tl.mstate.m
    np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
    for f in ("counts", "age", "epoch"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)))

    pts = np.zeros((CAP, 3), np.float32)
    pts[: len(s0.points)] = s0.points[:CAP]
    msk = np.arange(CAP) < len(s0.points)
    pose = s0.gt_pose.astype(np.float32)
    fj = float(jl.matcher.fitness(jl.mstate, jm.Cloud(jnp.asarray(pts), jnp.asarray(msk)),
                                  pose, 2.0))
    ft = float(tl.matcher.fitness(tl.mstate, tm.Cloud(torch.as_tensor(pts),
                                                      torch.as_tensor(msk)), pose, 2.0))
    assert np.isfinite(fj) and fj < 1.0 and ft == pytest.approx(fj, rel=1e-4)

    end0 = s0.t + period
    assert jl.try_init(s0.gt_pose, s0.t, end0, s0.points, s0.rel_times)
    assert tl.try_init(s0.gt_pose, s0.t, end0, s0.points, s0.rel_times)
    pj, pt = jl.trajectory[-1].astype(np.float64), tl.trajectory[-1].astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 2e-3 and rot_angle(pt, pj) < 2e-3

    end1 = s1.t + period
    feed_imu((jl, tl), ds, end1, imu_idx)
    mstate, fstate = jax.device_get((jl.mstate, jl.fstate))
    seg = jl.cfg.imu_segment_capacity
    dseg = jl.imu.get_segment(s1.t, end1, seg)
    pseg = jl.imu.get_segment(jl._last_scan_end, end1, seg)
    buf = jl.frontend.pack_frame(s1.points, s1.rel_times - period, CAP, end1, dseg, pseg)
    out_j = jl.dispatch_scan(s1.t, end1, s1.points, s1.rel_times)["out"]
    tl.frontend.cfg.gravity = jl.cfg.frontend.gravity
    _, _, out_t = tl.frontend.step_packed(convert.window_state(mstate),
                                          convert.frontend_state(fstate), buf, CAP, seg)
    assert bool(out_t.converged) == bool(out_j.converged) is True
    pj, pt = np.asarray(out_j.pose, np.float64), out_t.pose.numpy().astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 2e-3
    assert rot_angle(pt, pj) < 2e-3
