"""Port parity: the frontend step (deskew -> preintegration -> predict ->
ICP over the dense grid -> tight fusion) of funny_lidar_slam_torch against
the JAX package, step by step over simulator scans taken after the static
IMU warm-up, so the platform moves. Before every step the port starts
from the JAX state, carried across with funny_lidar_slam_torch.convert;
both consume the same packed frame buffer.

Tolerance per step: fused pose within 2e-3 m and 2e-3 rad of the JAX pose
(f32 GN and a 30-dof f32 LM on each side, whose stopping decisions can
land one iteration apart)."""

import jax
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.pipeline.frontend import FrontendConfig as JFrontendConfig
from funny_lidar_slam_tpu.pipeline.system import SlamSystem as JSlam, SystemConfig as JSysCfg
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.pipeline import frontend as tfe
from funny_lidar_slam_torch.registration import matchers as tm

torch.set_num_threads(1)

CAP, SEG = 2048, 16
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192,
           map_capacity=8192, local_map_size=20, group_capacity=2048,
           map_layout="grid", grid_dims=(48, 48, 12))


def rot_angle(a, b):
    dr = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("fusion", [tfe.FUSION_TIGHT_OPT, tfe.FUSION_LOOSE])
def test_frontend_steps_match_jax(fusion):
    ds = simulate(SimConfig(duration=4.3, points_per_scan=CAP, seed=3))
    jsys = JSlam(JSysCfg(matcher_config=jm.IcpConfig(**CFG),
                         frontend=JFrontendConfig(fusion_method=fusion),
                         scan_capacity=CAP, imu_segment_capacity=SEG))
    port = tfe.Frontend(tm.IcpMatcher(tm.IcpConfig(**CFG), device="cpu"),
                        tfe.FrontendConfig(fusion_method=fusion))
    period = ds.scans[1].t - ds.scans[0].t
    imu_idx, steps, moved = 0, 0, 0.0
    for scan in ds.scans:
        end = scan.t + period
        while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
            jsys.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
            imu_idx += 1
        if jsys.fstate is None:
            assert jsys.dispatch_scan(scan.t, end, scan.points, scan.rel_times)["init"]
            continue
        mstate, fstate = jax.device_get((jsys.mstate, jsys.fstate))
        dseg = jsys.imu.get_segment(scan.t, end, SEG)
        pseg = jsys.imu.get_segment(jsys._last_scan_end, end, SEG)
        if dseg is None or pseg is None:  # the IMU stream ends before the scan
            break
        buf = jsys.frontend.pack_frame(scan.points, scan.rel_times - period, CAP, end,
                                       dseg, pseg)
        out_j = jsys.dispatch_scan(scan.t, end, scan.points, scan.rel_times)["out"]

        port.cfg.gravity = jsys.cfg.frontend.gravity
        _, fs_t, out_t = port.step_packed(convert.window_state(mstate),
                                          convert.frontend_state(fstate), buf, CAP, SEG)
        pj = np.asarray(out_j.pose, np.float64)
        pt = out_t.pose.numpy().astype(np.float64)
        assert bool(out_t.converged) == bool(out_j.converged)
        assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 2e-3, steps
        assert rot_angle(pt, pj) < 2e-3, steps
        moved = max(moved, float(np.linalg.norm(pj[:3, 3] - np.asarray(fstate.nav.p))))
        steps += 1
    assert steps >= 14
    assert moved > 0.05  # the platform moved during the compared steps
