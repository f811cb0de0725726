"""Port parity of the small helpers: the consuming IMU `DataSynchronizer`,
the `Cloud` accessors and `ScanBundle`, the grid map's occupancy and owner
coords, `KeyFrame.materialize` and `system.to_device_segment`, each against
the JAX package on the same NumPy inputs. All are exact: they copy, count
or cast, and do no arithmetic. And the rotation distance the parity gates
use, `lie.chord_angle`, against the norm of the JAX `so3_log` (1e-6 rad in
f64) and exactly 0 between equal f32 rotations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core import lie as jlie
from funny_lidar_slam_tpu.core.cloud import Cloud as JCloud, ScanBundle as JScanBundle
from funny_lidar_slam_tpu.core.state import ImuSegment as JImuSegment
from funny_lidar_slam_tpu.imu.stream import DataSynchronizer as JSync, ImuStream as JStream
from funny_lidar_slam_tpu.maps import grid_map as jgrid
from funny_lidar_slam_tpu.pipeline import keyframes as jkf
from funny_lidar_slam_tpu.pipeline import system as jsystem
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core import lie
from funny_lidar_slam_torch.core.cloud import Cloud, ScanBundle
from funny_lidar_slam_torch.imu.stream import DataSynchronizer, ImuStream
from funny_lidar_slam_torch.maps import grid_map as tgrid
from funny_lidar_slam_torch.pipeline import keyframes as tkf
from funny_lidar_slam_torch.pipeline import system as tsystem

torch.set_num_threads(1)


def _fill(stream, n=50, dt=0.01):
    """tests/test_imu_stream.py's stream: 100 Hz, a ramp in the z gyro."""
    for i in range(n):
        stream.push(i * dt, [0.0, 0.0, 0.1 * i], [0.0, 0.0, 9.81])
    return stream


def test_data_synchronizer_matches_jax():
    """tests/test_imu_stream.py's sequence (0.10-0.20, 0.20-0.30, 0.30-0.40),
    then spans past the end and an empty one: the same segments and the
    same buffer after every call."""
    ts, js = _fill(ImuStream(require_static_init=False)), _fill(JStream(require_static_init=False))
    tsync, jsync = DataSynchronizer(ts), JSync(js)
    spans = [(0.10, 0.20), (0.20, 0.30), (0.30, 0.40), (0.40, 0.60), (0.45, 0.45),
             (0.40, 0.49)]
    got = 0
    for t0, t1 in spans:
        st, sj = tsync.get_segment(t0, t1, 32), jsync.get_segment(t0, t1, 32)
        assert (st is None) == (sj is None), (t0, t1)
        if st is not None:
            got += 1
            for f in JImuSegment._fields:
                np.testing.assert_array_equal(getattr(st, f), getattr(sj, f), err_msg=f)
        assert len(ts.t) == len(js.t), (t0, t1)
        np.testing.assert_array_equal(ts.t, js.t)
        np.testing.assert_array_equal(np.asarray(ts.gyro), np.asarray(js.gyro))
    assert got == 4 and len(ts.t) < 50  # consumed spans were popped


def test_data_synchronizer_keeps_the_bracketing_sample():
    s = _fill(ImuStream(require_static_init=False))
    seg = DataSynchronizer(s).get_segment(0.10, 0.205, 32)
    assert seg is not None and s.t[0] <= 0.205 <= s.t[1]
    assert len(s.t) == 50 - 20


def test_cloud_accessors():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    msk = rng.random(64) < 0.4
    ct, cj = Cloud(torch.as_tensor(pts), torch.as_tensor(msk)), JCloud(jnp.asarray(pts),
                                                                      jnp.asarray(msk))
    assert ct.capacity == cj.capacity == 64
    assert ct.count().dtype == torch.int32
    assert int(ct.count()) == int(cj.count()) == int(msk.sum())
    et, ej = Cloud.empty(16, device="cpu"), JCloud.empty(16)
    assert et.capacity == 16 and int(et.count()) == int(ej.count()) == 0
    assert et.points.dtype == torch.float32 and et.mask.dtype == torch.bool
    np.testing.assert_array_equal(et.points.numpy(), np.asarray(ej.points))
    e64 = Cloud.empty(4, torch.float64, device="cpu")
    assert e64.points.dtype == torch.float64 and e64.points.device.type == "cpu"


def test_cloud_empty_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Cloud.empty(8)


def test_scan_bundle_converts():
    rng = np.random.default_rng(1)

    def jcloud(n):
        return JCloud(jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
                      jnp.asarray(rng.random(n) < 0.5))

    seg = _fill(JStream(require_static_init=False)).get_segment(0.1, 0.2, 16)
    jb = JScanBundle(timestamp=jnp.asarray(12.5, jnp.float32), ordered=jcloud(32),
                     planar=jcloud(16), corner=jcloud(8), imu=jsystem.to_device_segment(seg))
    tb = convert.scan_bundle(jb)
    assert isinstance(tb, ScanBundle) and isinstance(tb.ordered, Cloud)
    assert tb.ordered.capacity == 32 and tb.corner.capacity == 8
    assert float(tb.timestamp) == 12.5
    for name in ("ordered", "planar", "corner"):
        for f in ("points", "mask"):
            a, b = getattr(getattr(tb, name), f), getattr(getattr(jb, name), f)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(getattr(tb, name).count()) == int(getattr(jb, name).count())
    for f in JImuSegment._fields:
        np.testing.assert_array_equal(getattr(tb.imu, f).numpy(), np.asarray(getattr(jb.imu, f)))


def test_grid_map_stats_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0.0, 30.0, (3000, 3)).astype(np.float32)
    pts[:, 2] /= 3.0
    msk = np.ones(len(pts), bool)
    mj = jgrid.insert(jgrid.create((32, 32, 8), 8), jnp.asarray(pts), jnp.asarray(msk), 1.0)
    mt = tgrid.insert(tgrid.create((32, 32, 8), 8), torch.as_tensor(pts),
                      torch.as_tensor(msk), 1.0)
    assert int(tgrid.num_occupied(tgrid.create((32, 32, 8), 8))) == 0
    n = int(tgrid.num_occupied(mt))
    assert n == int(jgrid.num_occupied(mj)) > 1000
    ct, lt = tgrid.stored_block_coords(mt)
    cj, lj = jgrid.stored_block_coords(mj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert 0 < int(lt.sum()) <= ct.shape[0] == 32 * 32 * 8
    # every claimed slot owns the block its points fall in
    blocks = {tuple(b) for b in np.floor(pts).astype(np.int64) >> 1}
    assert {tuple(b) for b in ct[lt].numpy()} <= blocks


def test_keyframe_materialize_matches_jax():
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=(n, 3)).astype(np.float32) for n in (40, 12, 24)]
    msks = [rng.random(len(a)) < 0.6 for a in arrs]
    kj = jkf.KeyFrame(0, 1.5, np.eye(4), cloud_dev=(jnp.asarray(arrs[0]), jnp.asarray(msks[0])),
                      feat_dev=tuple(jnp.asarray(x) for p in zip(arrs[1:], msks[1:]) for x in p))
    kt = tkf.KeyFrame(0, 1.5, np.eye(4),
                      cloud_dev=(torch.as_tensor(arrs[0]), torch.as_tensor(msks[0])),
                      feat_dev=tuple(torch.as_tensor(x) for p in zip(arrs[1:], msks[1:])
                                     for x in p))
    assert not kt.materialized
    kj.materialize()
    kt.materialize()
    assert kt.materialized and kj.materialized
    for f in ("_cloud", "_corner", "_planar"):
        a, b = getattr(kt, f), getattr(kj, f)
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(kt.cloud, arrs[0][msks[0]])
    kt.materialize()  # a no-op once materialized
    np.testing.assert_array_equal(kt.planar, arrs[2][msks[2]])


def test_to_device_segment_casts():
    seg = _fill(ImuStream(require_static_init=False)).get_segment(0.105, 0.205, 16)
    assert seg.t.dtype == np.float64
    tseg = tsystem.to_device_segment(seg, device="cpu")
    jseg = jsystem.to_device_segment(seg)
    for f in ("t", "gyro", "accel", "quat"):
        x = getattr(tseg, f)
        assert x.dtype == torch.float32 and x.device.type == "cpu", f
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(jseg, f)), err_msg=f)
    assert tseg.mask.dtype == torch.bool
    np.testing.assert_array_equal(tseg.mask.numpy(), np.asarray(jseg.mask))
    d64 = tsystem.to_device_segment(seg, torch.float64, "cpu")
    assert d64.t.dtype == torch.float64 and np.array_equal(d64.t.numpy(), seg.t)


def test_chord_angle_matches_jax_so3_log():
    rng = np.random.default_rng(5)
    va, vb = rng.normal(size=(2, 64, 3))
    ra, rb = lie.so3_exp(torch.from_numpy(va)), lie.so3_exp(torch.from_numpy(vb))
    rel = np.einsum("nji,njk->nik", ra.numpy(), rb.numpy())
    ref = np.linalg.norm(np.asarray(jlie.so3_log(jnp.asarray(rel))), axis=-1)  # x64 (conftest)
    assert ref.dtype == np.float64
    got = lie.chord_angle(ra, rb)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # poses take their rotation block; equal f32 rotations are 0 exactly
    poses = torch.eye(4, dtype=torch.float32).repeat(64, 1, 1)
    poses[:, :3, :3] = ra.float()
    assert float(lie.chord_angle(poses[0], poses[0].numpy())) == 0.0
    assert torch.equal(lie.chord_angle(poses, ra.float()), torch.zeros(64, dtype=torch.float64))
