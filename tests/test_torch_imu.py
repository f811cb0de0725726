"""Port parity: deskew, preintegration/predict and the host IMU stream and
simulator of funny_lidar_slam_torch against the JAX package, plus the
reference's golden preintegration matrices (the same ones
tests/test_preintegration.py holds the JAX package to)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funny_lidar_slam_tpu.core.state import ImuSegment as JSeg, NavState as JNav
from funny_lidar_slam_tpu.imu import preintegration as jpre
from funny_lidar_slam_tpu.imu.stream import ImuStream as JStream
from funny_lidar_slam_tpu.io import simulator as jsim
from funny_lidar_slam_tpu.lidar.deskew import deskew as jdeskew
from funny_lidar_slam_torch.core.state import ImuSegment as TSeg, NavState as TNav
from funny_lidar_slam_torch.imu import preintegration as tpre
from funny_lidar_slam_torch.imu.stream import ImuStream as TStream
from funny_lidar_slam_torch.io import simulator as tsim
from funny_lidar_slam_torch.lidar.deskew import deskew as tdeskew

from test_preintegration import (ACCEL_SIGMA, COV_TRUE, DP_DBA_TRUE, DP_DBG_TRUE,
                                 DR_DBG_TRUE, DV_DBA_TRUE, DV_DBG_TRUE, GYRO_SIGMA,
                                 make_constant_segment, rel_close)

torch.set_num_threads(1)


def _segment(n=12, cap=16, seed=0):
    """A padded IMU segment with a rotating orientation (f32 arrays)."""
    rng = np.random.default_rng(seed)
    t = 3.0 + np.arange(cap) * 0.01
    gyro = rng.normal(0, 0.3, (cap, 3))
    accel = np.array([0.2, -0.1, 9.81]) + rng.normal(0, 0.2, (cap, 3))
    ang = np.cumsum(np.full(cap, 0.02))
    quat = np.stack([np.cos(ang / 2), 0.1 * np.sin(ang / 2), 0.2 * np.sin(ang / 2),
                     np.sin(ang / 2)], 1)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    mask = np.arange(cap) < n
    return {k: v.astype(np.float32) for k, v in
            dict(t=t, gyro=gyro, accel=accel, quat=quat).items()} | {"mask": mask}


def _jseg(d):
    return JSeg(**{k: jnp.asarray(v) for k, v in d.items()})


def _tseg(d, dtype=torch.float32):
    return TSeg(**{k: torch.as_tensor(v) if k == "mask" else torch.as_tensor(v, dtype=dtype)
                   for k, v in d.items()})


def test_deskew_matches_jax():
    """f32 points at up to ~40 m: 2e-5 m absolute (a few f32 ulps)."""
    seg = _segment()
    rng = np.random.default_rng(1)
    pts = rng.uniform(-40, 40, (2048, 3)).astype(np.float32)
    rel = rng.uniform(-0.1, 0.0, 2048).astype(np.float32)
    mask = rng.uniform(size=2048) < 0.9
    t_l2i = np.eye(4, dtype=np.float32)
    t_l2i[:3, 3] = [0.1, -0.05, 0.2]
    ref = np.float32(3.1)
    pj, _ = jdeskew(jnp.asarray(pts), jnp.asarray(rel), jnp.asarray(mask),
                    jnp.asarray(ref), _jseg(seg), jnp.asarray(t_l2i))
    pt, mt = tdeskew(torch.as_tensor(pts), torch.as_tensor(rel), torch.as_tensor(mask),
                     torch.as_tensor(ref), _tseg(seg), torch.as_tensor(t_l2i))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(mt.numpy(), mask)


@pytest.mark.parametrize("n_valid", [12, 2])
def test_preintegrate_and_predict_match_jax(n_valid):
    """f32: deltas and Jacobians within 1e-5 absolute, covariance within
    1e-4 relative of its largest entry."""
    seg = _segment(n=n_valid)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.02, -0.03], np.float32)
    pj = jpre.preintegrate(_jseg(seg), jpre.PreintParams.from_std(0.01, 0.1, 1e-8),
                           jnp.asarray(bg), jnp.asarray(ba))
    pt = tpre.preintegrate(_tseg(seg), tpre.PreintParams.from_std(0.01, 0.1, 1e-8),
                           torch.as_tensor(bg), torch.as_tensor(ba))
    for f in jpre.PreintState._fields:
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        tol = 1e-4 * np.abs(b).max() if f == "cov" else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)

    rng = np.random.default_rng(2)
    nav = dict(r=np.eye(3), v=rng.normal(size=3), p=rng.normal(size=3) * 10, bg=bg, ba=ba,
               info=np.zeros((15, 15)), t=np.zeros(()))
    nav = {k: np.asarray(v, np.float32) for k, v in nav.items()}
    g = np.array([0.0, 0.0, -9.81], np.float32)
    nj = jpre.predict(pj, JNav(**{k: jnp.asarray(v) for k, v in nav.items()}), jnp.asarray(g))
    nt = tpre.predict(pt, TNav(**{k: torch.as_tensor(v) for k, v in nav.items()}),
                      torch.as_tensor(g))
    for f in ("r", "v", "p"):
        np.testing.assert_allclose(getattr(nt, f).numpy(), np.asarray(getattr(nj, f)),
                                   atol=1e-5, rtol=0, err_msg=f)


def _golden_segment(pad_to=None):
    s = make_constant_segment(pad_to=pad_to)
    return TSeg(**{k: torch.as_tensor(np.array(getattr(s, k))) for k in TSeg._fields})


def _golden_run(pad_to=None):
    params = tpre.PreintParams.from_std(GYRO_SIGMA, ACCEL_SIGMA, 0.0, dtype=torch.float64)
    zero = torch.zeros(3, dtype=torch.float64)
    return tpre.preintegrate(_golden_segment(pad_to), params, zero, zero)


def test_preintegration_golden_matrices():
    """The reference's golden values (test/preintegration_ut.cpp), f64, with
    the same Eigen isApprox tolerances as tests/test_preintegration.py."""
    out = _golden_run()
    assert rel_close(out.dr_dbg, DR_DBG_TRUE, 1e-3)
    assert rel_close(out.dp_dba, DP_DBA_TRUE, 1e-3)
    assert rel_close(out.dp_dbg, DP_DBG_TRUE, 1e-3)
    assert rel_close(out.dv_dba, DV_DBA_TRUE, 1e-3)
    assert rel_close(out.dv_dbg, DV_DBG_TRUE, 1e-3)
    assert rel_close(out.cov, COV_TRUE, 1e-9)
    assert abs(float(out.dt) - 1.01) < 1e-12


def test_preintegration_padding_is_ignored():
    ref, padded = _golden_run(), _golden_run(pad_to=112)
    for a, b in zip(ref, padded):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_simulator_and_imu_stream_match_jax():
    """The port's NumPy copies give identical data and segments."""
    cfg = dict(duration=3.2, points_per_scan=512, seed=5)
    dj = jsim.simulate(jsim.SimConfig(**cfg))
    dt = tsim.simulate(tsim.SimConfig(**cfg))
    assert len(dj.scans) == len(dt.scans) > 0
    np.testing.assert_array_equal(dt.imu_accel, dj.imu_accel)
    for a, b in zip(dt.scans, dj.scans):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.rel_times, b.rel_times)
    sj, st = JStream(), TStream()
    for i in range(len(dj.imu_t)):
        sj.push(dj.imu_t[i], dj.imu_gyro[i], dj.imu_accel[i])
        st.push(dt.imu_t[i], dt.imu_gyro[i], dt.imu_accel[i])
    np.testing.assert_array_equal(st.gravity, sj.gravity)
    a, b = st.get_segment(2.95, 3.05, 16), sj.get_segment(2.95, 3.05, 16)
    for f in TSeg._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
