"""Port parity: keyframe persistence, the resume init and the map products
of funny_lidar_slam_torch against the JAX package.

- A keyframe store written by either package loads in the other: the
  timestamps, poses, clouds and features equal exactly, and the `poses.npy`
  sidecar overrides the npz poses.
- `Frontend.init_frame_at` on the same scan, segment, pose and velocity, in
  tight and KF fusion: the nav state to 1e-6 (relative to each field's
  largest entry: the prior information holds 1e12), the deskewed cloud to
  1e-5 m, the grid map's counts exactly and its points to 1e-5 m.
- `save_map` of the same host keyframes: both packages filter with the
  same C++ voxel filter (the JAX package's `native`, the port's copy), so
  `map.pcd` and every tile equal exactly, in the same order."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.io.pcd import read_pcd as jread_pcd
from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.maps import split_map as jsplit
from funny_lidar_slam_tpu.pipeline import frontend as jfe
from funny_lidar_slam_tpu.pipeline import keyframes as jkf
from funny_lidar_slam_tpu.pipeline import system as jsys_mod
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_torch.io.pcd import read_pcd
from funny_lidar_slam_torch.maps import split_map
from funny_lidar_slam_torch.pipeline import frontend as tfe
from funny_lidar_slam_torch.pipeline import keyframes as tkf
from funny_lidar_slam_torch.pipeline import system as tsys_mod
from funny_lidar_slam_torch.registration import matchers as tm

torch.set_num_threads(1)

CAP, SEG = 2048, 16
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192, map_capacity=8192,
           local_map_size=20, group_capacity=2048, map_layout="grid", grid_dims=(48, 48, 12))


def host_keyframes(kf_cls, n=5, seed=0, features=True):
    """`n` keyframes from host arrays: f32 poses along a 60 m arc (so the
    merged map spans tiles), clouds of varying size, features on all but
    the first."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pose = np.eye(4, dtype=np.float32)
        a = 0.3 * i
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, 3] = [15.0 * i - 10.0, 3.0 * i, 0.1 * i]
        cloud = rng.uniform(-20, 20, (500 + 37 * i, 3)).astype(np.float32)
        planar = corner = None
        if features and i > 0:
            planar = rng.uniform(-20, 20, (80 + i, 3)).astype(np.float32)
            corner = rng.uniform(-20, 20, (20 + i, 3)).astype(np.float32)
        out.append(kf_cls(i, 0.1 * i + 3.0, pose, cloud, planar, corner))
    return out


def assert_same_frames(got, ref, poses=None):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.kf_id == b.kf_id == i and a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.pose, b.pose if poses is None else poses[i])
        np.testing.assert_array_equal(a.cloud, b.cloud)
        for f in ("planar", "corner"):
            if getattr(b, f) is None:
                assert getattr(a, f) is None, (i, f)
            else:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_keyframe_store_loads_in_the_other_package(tmp_path, writer):
    """Written by one package (npz per keyframe, then a poses.npy sidecar
    after a pose rewrite), loaded by the other."""
    wmod, rmod = (jkf, tkf) if writer == "jax" else (tkf, jkf)
    store = wmod.KeyFrameStore(save_dir=str(tmp_path))
    frames = host_keyframes(wmod.KeyFrame)
    for kf in frames:
        store.add(kf)  # host keyframes are written at once
    assert sorted(os.listdir(tmp_path)) == [f"keyframe_{i}.npz" for i in range(5)]
    loaded = rmod.KeyFrameStore.load(str(tmp_path))
    assert_same_frames(loaded.frames, frames)

    new_poses = store.poses().copy()
    new_poses[:, :3, 3] += np.float32(0.25)
    store.set_poses(new_poses)
    store.flush_poses()
    loaded = rmod.KeyFrameStore.load(str(tmp_path))
    assert_same_frames(loaded.frames, frames, poses=new_poses)
    np.testing.assert_array_equal(loaded.poses(), new_poses)


def test_store_flushes_lazy_keyframes_after_one_copy(tmp_path):
    """A lazy keyframe is written by `flush` after `materialize_batch`, with
    the clouds the device held, masked."""
    store = tkf.KeyFrameStore(save_dir=str(tmp_path))
    pts = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    mask = torch.arange(10) % 3 != 0
    kf = tkf.KeyFrame(0, 1.5, np.eye(4), cloud_dev=(pts, mask))
    store.add(kf)
    assert not os.listdir(tmp_path)  # still lazy: nothing written yet
    tkf.materialize_batch([kf])
    store.flush(kf)
    z = np.load(tmp_path / "keyframe_0.npz")
    np.testing.assert_array_equal(z["cloud"], pts.numpy()[mask.numpy()])
    assert z["planar"].shape == (0, 3) and float(z["timestamp"]) == 1.5


@pytest.fixture(scope="module")
def resume_inputs():
    """A JAX system after its IMU warm-up, the segment of a scan in motion
    and that scan, padded."""
    ds = simulate(SimConfig(duration=4.3, points_per_scan=CAP, seed=3))
    jsys = jsys_mod.SlamSystem(jsys_mod.SystemConfig(
        matcher_config=jm.IcpConfig(**CFG), scan_capacity=CAP, imu_segment_capacity=SEG))
    period = ds.scans[1].t - ds.scans[0].t
    scan = ds.scans[-3]
    end = scan.t + period
    for k, t in enumerate(ds.imu_t):
        if t > end + 0.05:
            break
        jsys.push_imu(t, ds.imu_gyro[k], ds.imu_accel[k])
    seg = jsys.imu.get_segment(scan.t, end, SEG)
    assert seg is not None and jsys.imu.initialized
    pts, rts, mask = tsys_mod.pad_scan(scan.points, scan.rel_times - period, CAP)
    vel = np.array([0.9, -0.2, 0.05])
    return jsys.cfg.frontend.gravity, seg, pts, rts, mask, end, scan.gt_pose, vel


@pytest.mark.parametrize("fusion", [tfe.FUSION_TIGHT_OPT, tfe.FUSION_TIGHT_KF])
def test_init_frame_at_matches_jax(resume_inputs, fusion):
    gravity, seg, pts, rts, mask, end, pose, vel = resume_inputs
    jmat = jm.IcpMatcher(jm.IcpConfig(**CFG))
    jfront = jfe.Frontend(jmat, jfe.FrontendConfig(fusion_method=fusion, gravity=gravity))
    ms_j, fs_j, (dp_j, dm_j) = jfront.init_frame_at(
        jmat.create_state(), pose, jnp.asarray(pts), jnp.asarray(rts), jnp.asarray(mask), end,
        jsys_mod.to_device_segment(seg), velocity=vel)
    ms_j, fs_j, dp_j, dm_j = jax.device_get((ms_j, fs_j, dp_j, dm_j))

    tmat = tm.IcpMatcher(tm.IcpConfig(**CFG), device="cpu")
    tfront = tfe.Frontend(tmat, tfe.FrontendConfig(fusion_method=fusion, gravity=gravity))
    ms_t, fs_t, (dp_t, dm_t) = tfront.init_frame_at(tmat.create_state(), pose, pts, rts, mask,
                                                    end, seg, velocity=vel)

    for f in fs_t.nav._fields:
        ref = np.asarray(getattr(fs_j.nav, f), np.float64)
        got = getattr(fs_t.nav, f).numpy().astype(np.float64)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(np.abs(ref).max(), 1.0),
                                   err_msg=f)
    np.testing.assert_allclose(fs_t.nav.p.numpy(), pose[:3, 3], atol=1e-5)
    np.testing.assert_allclose(fs_t.nav.v.numpy(), vel, atol=1e-6)
    np.testing.assert_allclose(fs_t.last_pose.numpy(), np.asarray(fs_j.last_pose), atol=1e-6)
    np.testing.assert_array_equal(dm_t.numpy(), np.asarray(dm_j))
    np.testing.assert_allclose(dp_t.numpy(), np.asarray(dp_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ms_t.m.counts.numpy(), np.asarray(ms_j.m.counts))
    np.testing.assert_allclose(ms_t.m.tab.numpy(), np.asarray(ms_j.m.tab), atol=1e-5, rtol=0)
    assert int(ms_t.filled) == int(ms_j.filled) == 1


def test_save_map_matches_jax(tmp_path):
    """save_map(split=True) of the same host keyframes in both packages,
    with 20 m tiles so the map spans several."""
    jsys = jsys_mod.SlamSystem(jsys_mod.SystemConfig(matcher_config=jm.IcpConfig(**CFG)))
    tsys = tsys_mod.SlamSystem(tsys_mod.SystemConfig(matcher_config=tm.IcpConfig(**CFG)),
                               device="cpu")
    jsys.keyframes.frames = host_keyframes(jkf.KeyFrame)
    tsys.keyframes.frames = host_keyframes(tkf.KeyFrame)
    pj = jsys.save_map(str(tmp_path / "j"), voxel_size=0.5, split=True, tile_size=20.0)
    pt = tsys.save_map(str(tmp_path / "t"), voxel_size=0.5, split=True, tile_size=20.0)
    cj, _ = jread_pcd(pj)
    ct, _ = read_pcd(pt)
    assert len(cj) > 1000
    np.testing.assert_array_equal(ct, cj)
    tiles_j = jsplit.load_tile_indices(str(tmp_path / "j"))
    tiles_t = split_map.load_tile_indices(str(tmp_path / "t"))
    assert tiles_t == tiles_j and len(tiles_t) >= 3
    counts = []
    for ij in tiles_t:
        tile = split_map.load_tile(str(tmp_path / "t"), *ij)
        np.testing.assert_array_equal(tile, jsplit.load_tile(str(tmp_path / "j"), *ij))
        counts.append(len(tile))
    assert sum(counts) == len(ct)
