"""Port parity of the unpacked frontend step and of the frontend profile
tool.

- `Frontend.step` of the port against the JAX package's `Frontend.step`
  over the steady steps of a simulator run (the setup of
  tests/test_torch_frontend.py: 2,048 points, the dense grid, tight
  coupling), each starting from the JAX state carried across with
  funny_lidar_slam_torch.convert; both take the same host arrays.
  Tolerance per step: 2e-3 m and 2e-3 rad (f32 GN and LM on each side)
  and the same `converged` flag.
- The port's `step` against its `step_packed` from the same f32 inputs
  and state: the same arithmetic on the same values, so every output
  tensor and the next state are equal (`torch.equal`).
- Each stage of tools/profile_torch_frontend.py runs once on the CPU at
  2,048 points and gives finite outputs; the tool's entry point refuses to
  run without CUDA."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.pipeline import system as jsystem
from funny_lidar_slam_tpu.pipeline.frontend import FrontendConfig as JFrontendConfig
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.lie import chord_angle
from funny_lidar_slam_torch.pipeline import frontend as tfe
from funny_lidar_slam_torch.pipeline import system as tsystem
from funny_lidar_slam_torch.registration import matchers as tm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, SEG = 2048, 16
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192,
           map_capacity=8192, local_map_size=20, group_capacity=2048,
           map_layout="grid", grid_dims=(48, 48, 12))


def load_tool():
    path = os.path.join(ROOT, "tools", "profile_torch_frontend.py")
    spec = importlib.util.spec_from_file_location("profile_torch_frontend", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_step_matches_jax_step():
    ds = simulate(SimConfig(duration=4.3, points_per_scan=CAP, seed=3))
    jsys = jsystem.SlamSystem(jsystem.SystemConfig(
        matcher_config=jm.IcpConfig(**CFG), frontend=JFrontendConfig(),
        scan_capacity=CAP, imu_segment_capacity=SEG))
    port = tfe.Frontend(tm.IcpMatcher(tm.IcpConfig(**CFG), device="cpu"), tfe.FrontendConfig())
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
        dseg = jsys.imu.get_segment(scan.t, end, SEG)
        pseg = jsys.imu.get_segment(jsys._last_scan_end, end, SEG)
        if dseg is None or pseg is None:  # the IMU stream ends before the scan
            break
        pts, rts, mask = tsystem.pad_scan(scan.points, scan.rel_times - period, CAP)
        mstate, fstate = jax.device_get((jsys.mstate, jsys.fstate))
        jsys.mstate, jsys.fstate, out_j = jsys.frontend.step(
            jsys.mstate, jsys.fstate, pts, rts, mask, end, jsystem.to_device_segment(dseg),
            jsystem.to_device_segment(pseg))
        jsys._last_scan_end = end

        port.cfg.gravity = jsys.cfg.frontend.gravity
        _, _, out_t = port.step(convert.window_state(mstate), convert.frontend_state(fstate),
                                pts, rts, mask, end, dseg, pseg)
        pj = np.asarray(out_j.pose, np.float64)
        pt = out_t.pose.numpy().astype(np.float64)
        assert bool(out_t.converged) == bool(out_j.converged), steps
        assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 2e-3, steps
        assert float(chord_angle(pt, pj)) < 2e-3, steps
        moved = max(moved, float(np.linalg.norm(pj[:3, 3] - np.asarray(fstate.nav.p))))
        steps += 1
    assert steps >= 14
    assert moved > 0.05  # the platform moved during the compared steps


def _assert_trees_equal(a, b, where):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_trees_equal(x, y, f"{where}.{getattr(a, '_fields', range(99))[i]}")
    else:
        assert a == b, where


def test_step_equals_step_packed():
    ds = simulate(SimConfig(duration=4.3, points_per_scan=CAP, seed=3))
    slam = tsystem.SlamSystem(tsystem.SystemConfig(
        matcher_config=tm.IcpConfig(**CFG), scan_capacity=CAP, imu_segment_capacity=SEG),
        device="cpu")
    period = ds.scans[1].t - ds.scans[0].t
    imu_idx, steps = 0, 0
    for scan in ds.scans:
        end = scan.t + period
        while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
            slam.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
            imu_idx += 1
        if slam.fstate is None:
            slam.process_scan(scan.t, end, scan.points, scan.rel_times)
            continue
        dseg = slam.imu.get_segment(scan.t, end, SEG)
        pseg = slam.imu.get_segment(slam._last_scan_end, end, SEG)
        if dseg is None or pseg is None:
            break
        # the same f32 values on both paths: the packed buffer holds what
        # pad_scan and the segments' f32 casts hold
        rel = scan.rel_times - period
        pts, rts, mask = tsystem.pad_scan(scan.points, rel, CAP)
        buf = slam.frontend.pack_frame(scan.points, rel, CAP, end, dseg, pseg)
        fe = slam.frontend
        packed = fe.step_packed(slam.mstate, slam.fstate, buf, CAP, SEG)
        unpacked = fe.step(slam.mstate, slam.fstate, pts, rts, mask, end, dseg, pseg)
        _assert_trees_equal(unpacked, packed, f"step {steps}")
        slam.mstate, slam.fstate, _ = packed
        slam._last_scan_end = end
        steps += 1
    assert steps >= 14


@pytest.fixture(scope="module")
def tool_stages():
    tool = load_tool()
    slam, ds = tool.warmed_system(CAP, device="cpu")
    scan = ds.scans[len(ds.scans) - 4]
    return tool.build_stages(slam, scan, ds.scans[1].t - ds.scans[0].t)


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, np.ndarray):
        return [torch.from_numpy(tree)] if tree.dtype.kind == "f" else []
    if isinstance(tree, tuple):
        return [x for v in tree for x in _float_leaves(v)]
    return []


STAGES = ("full_step", "deskew", "preintegrate", "voxel_downsample_src", "query_knn_k1_direct",
          "query_knn_k1_grouped", "query_knn_k5_direct", "hg_point_to_point",
          "gn_matcher_match", "gn_uncached_direct", "tight_fuse", "window_add",
          "window_add_rebuild", "host_prep", "step_packed_device", "host_pack_frame",
          "step_plus_retire_fetch")


def test_tool_has_the_jax_tools_stages(tool_stages):
    assert tuple(tool_stages) == STAGES


@pytest.mark.parametrize("name", STAGES)
def test_tool_stage_runs_on_cpu(tool_stages, name):
    out = tool_stages[name]()
    if name.startswith("query_knn"):
        nbrs, d2, ok = out  # misses report inf distances
        assert ok.any() and torch.isfinite(d2[ok]).all() and torch.isfinite(nbrs[ok]).all()
        return
    leaves = _float_leaves(out)
    assert leaves, name
    for x in leaves:
        assert torch.isfinite(x).all(), name


def test_tool_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_tool().main([])
