"""Port parity: the error-state KF (fusion/eskf.py) of funny_lidar_slam_torch
against the JAX package: `predict` over a seeded segment with masked
samples, `update_pose`, and the frontend's TightCouplingKF step (ESKF
predict -> ICP over the dense grid -> ESKF update) from the JAX state
carried across with funny_lidar_slam_torch.convert.

Tolerances: predict and update in f32 within 1e-5 of every entry of the
mean (rotation matrix entries, m, m/s) and 1e-4 of the largest covariance
entry, relative; the frontend step
within 2e-3 m / 2e-3 rad (an f32 GN on each side, whose stopping decision
can land one iteration apart) and its covariance within 1e-2 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.lie import se3_exp, so3_exp as jso3_exp
from funny_lidar_slam_tpu.core.state import ImuSegment as JSeg, NavState as JNav
from funny_lidar_slam_tpu.fusion import eskf as jeskf
from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.pipeline.frontend import FrontendConfig as JFrontendConfig
from funny_lidar_slam_tpu.pipeline.system import SlamSystem as JSlam, SystemConfig as JSysCfg
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.state import ImuSegment as TSeg
from funny_lidar_slam_torch.fusion import eskf
from funny_lidar_slam_torch.pipeline import frontend as tfe
from funny_lidar_slam_torch.registration import matchers as tm

torch.set_num_threads(1)

GRAVITY = np.array([0.0, 0.0, -9.81], np.float32)


def rot_angle(a, b):
    dr = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))


def segment(cap=32, n=27, seed=0):
    """A padded IMU segment: n valid samples, one repeated timestamp (a
    zero-dt step, masked) and one hole in the mask."""
    rng = np.random.default_rng(seed)
    t = (5.0 + np.arange(cap) * 0.005).astype(np.float32)
    t[9] = t[8]
    gyro = rng.normal(0, 0.4, (cap, 3)).astype(np.float32)
    accel = (np.array([0.3, -0.2, 9.81]) + rng.normal(0, 0.3, (cap, 3))).astype(np.float32)
    quat = np.tile(np.array([1, 0, 0, 0], np.float32), (cap, 1))
    mask = np.arange(cap) < n
    mask[15] = False
    return dict(t=t, gyro=gyro, accel=accel, quat=quat, mask=mask)


def eskf_states(seed=1):
    """The same nav state and a random SPD covariance on both sides."""
    rng = np.random.default_rng(seed)
    r = np.asarray(jso3_exp(jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)), np.float32)
    nav = dict(r=r, v=rng.normal(0, 1, 3).astype(np.float32),
               p=rng.normal(0, 20, 3).astype(np.float32),
               bg=rng.normal(0, 0.01, 3).astype(np.float32),
               ba=rng.normal(0, 0.05, 3).astype(np.float32),
               info=np.zeros((15, 15), np.float32), t=np.float32(5.0))
    a = rng.normal(0, 1e-2, (15, 15))
    cov = (a @ a.T + np.diag(np.full(15, 1e-4))).astype(np.float32)
    js = jeskf.EskfState(JNav(**{k: jnp.asarray(v) for k, v in nav.items()}), jnp.asarray(cov))
    ts = eskf.EskfState(convert.nav_state(JNav(**nav)), torch.as_tensor(cov))
    return js, ts


def assert_eskf_close(ts, js, pos_tol, cov_rtol):
    nav_j = jax.device_get(js.nav)
    for f in ("r", "v", "p", "bg", "ba"):
        np.testing.assert_allclose(getattr(ts.nav, f).numpy(), np.asarray(getattr(nav_j, f)),
                                   rtol=0, atol=pos_tol, err_msg=f)
    ref = np.asarray(js.cov)
    np.testing.assert_allclose(ts.cov.numpy(), ref, rtol=0, atol=cov_rtol * np.abs(ref).max())


def test_predict_matches_jax():
    seg = segment()
    js, ts = eskf_states()
    pj = jeskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4)
    pt = eskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4)
    out_j = jeskf.predict(js, JSeg(**{k: jnp.asarray(v) for k, v in seg.items()}), pj, GRAVITY)
    out_t = eskf.predict(ts, TSeg(**{k: torch.as_tensor(v) for k, v in seg.items()}), pt,
                         GRAVITY)
    assert_eskf_close(out_t, out_j, 1e-5, 1e-4)
    # the platform moved and the covariance grew over the valid steps
    assert float(torch.linalg.vector_norm(out_t.nav.p - ts.nav.p)) > 0.05
    assert float(torch.trace(out_t.cov)) > float(torch.trace(ts.cov))


def test_update_pose_matches_jax():
    js, ts = eskf_states(seed=2)
    meas = np.asarray(se3_exp(jnp.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.015],
                                          jnp.float32)), np.float32)
    r0, p0 = np.asarray(js.nav.r), np.asarray(js.nav.p)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = r0 @ meas[:3, :3], p0 + meas[:3, 3]
    out_j = jeskf.update_pose(js, jnp.asarray(pose), 0.005, 0.01)
    out_t = eskf.update_pose(ts, torch.as_tensor(pose), 0.005, 0.01)
    assert_eskf_close(out_t, out_j, 1e-5, 1e-4)
    # the update moved the mean toward the measurement and shrank the cov
    assert (np.linalg.norm(out_t.nav.p.numpy() - pose[:3, 3])
            < np.linalg.norm(p0 - pose[:3, 3]))
    assert float(torch.trace(out_t.cov)) < float(torch.trace(ts.cov))


CAP, SEG = 2048, 16
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192,
           map_capacity=8192, local_map_size=20, group_capacity=2048,
           map_layout="grid", grid_dims=(48, 48, 12))


def test_kf_frontend_steps_match_jax():
    """The TightCouplingKF step, scan by scan after the static warm-up: the
    port starts every step from the JAX state (its nav info slot is the
    ESKF covariance) and consumes the same packed frame buffer."""
    kf = tfe.FUSION_TIGHT_KF
    ds = simulate(SimConfig(duration=4.3, points_per_scan=CAP, seed=3))
    jsys = JSlam(JSysCfg(matcher_config=jm.IcpConfig(**CFG),
                         frontend=JFrontendConfig(fusion_method=kf),
                         scan_capacity=CAP, imu_segment_capacity=SEG))
    port = tfe.Frontend(tm.IcpMatcher(tm.IcpConfig(**CFG), device="cpu"),
                        tfe.FrontendConfig(fusion_method=kf))
    period = ds.scans[1].t - ds.scans[0].t
    imu_idx, steps, moved = 0, 0, 0.0
    for scan in ds.scans:
        end = scan.t + period
        while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
            jsys.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
            imu_idx += 1
        if jsys.fstate is None:
            assert jsys.dispatch_scan(scan.t, end, scan.points, scan.rel_times)["init"]
            # the init frame puts the ESKF prior covariance in the info slot
            np.testing.assert_allclose(np.diag(np.asarray(jsys.fstate.nav.info))[3:6], 1e-2)
            continue
        mstate, fstate = jax.device_get((jsys.mstate, jsys.fstate))
        dseg = jsys.imu.get_segment(scan.t, end, SEG)
        pseg = jsys.imu.get_segment(jsys._last_scan_end, end, SEG)
        if dseg is None or pseg is None:
            break
        buf = jsys.frontend.pack_frame(scan.points, scan.rel_times - period, CAP, end,
                                       dseg, pseg)
        out_j = jsys.dispatch_scan(scan.t, end, scan.points, scan.rel_times)["out"]
        port.cfg.gravity = jsys.cfg.frontend.gravity
        _, fs_t, out_t = port.step_packed(convert.window_state(mstate),
                                          convert.frontend_state(fstate), buf, CAP, SEG)
        pj, pt = np.asarray(out_j.pose, np.float64), out_t.pose.numpy().astype(np.float64)
        assert bool(out_t.converged) == bool(out_j.converged) is True
        assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 2e-3, steps
        assert rot_angle(pt, pj) < 2e-3, steps
        cov_j = np.asarray(jsys.fstate.nav.info)
        np.testing.assert_allclose(fs_t.nav.info.numpy(), cov_j, rtol=0,
                                   atol=1e-2 * np.abs(cov_j).max())
        moved = max(moved, float(np.linalg.norm(pj[:3, 3] - np.asarray(fstate.nav.p))))
        steps += 1
    assert steps >= 12
    assert moved > 0.05  # the platform moved during the compared steps


def test_kf_init_from_pose_sets_covariance():
    """Localization's init: the KF frontend starts from the ESKF prior
    covariance in the info slot, as the JAX frontend does."""
    from funny_lidar_slam_tpu.pipeline.frontend import Frontend as JFrontend

    pose = np.asarray(se3_exp(jnp.asarray([1.0, 2.0, 0.5, 0.1, 0.0, 0.3], jnp.float32)),
                      np.float32)
    cfg = dict(fusion_method=tfe.FUSION_TIGHT_KF)
    fj = JFrontend(jm.IcpMatcher(jm.IcpConfig(**CFG)), JFrontendConfig(**cfg))
    ft = tfe.Frontend(tm.IcpMatcher(tm.IcpConfig(**CFG), device="cpu"),
                      tfe.FrontendConfig(**cfg))
    sj, st = fj.init_from_pose(pose, 3.0), ft.init_from_pose(pose, 3.0)
    np.testing.assert_array_equal(st.nav.info.numpy(), np.asarray(sj.nav.info))
    np.testing.assert_allclose(st.last_pose.numpy(), np.asarray(sj.last_pose), atol=1e-6)
