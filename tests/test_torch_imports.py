"""Import guard of the port: every module of funny_lidar_slam_torch, the
port's tools (tools/profile_torch_*.py), bench_torch.py and chip_smoke.py
import without pulling in JAX, the JAX package, PyYAML or matplotlib (the
port runs where neither of the last two is installed); and the entry
points, the CLI and the multi-rank dry run included, refuse to run without
CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = r"""
import importlib, importlib.util, pkgutil, sys
import funny_lidar_slam_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for tool in ("profile_torch_frontend", "profile_torch_mapping", "profile_torch_gn",
             "profile_torch_loops", "profile_torch_gn_gates", "profile_torch_loam_frontend"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(tool)
import bench_torch
names.append("bench_torch")
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "funny_lidar_slam_tpu", "yaml",
                                    "matplotlib"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    # the package's 64 modules, the CLI and its readers (config, lidar/model,
    # io/{bag_export,bag_format,formats,pointcloud2,rosbag,viz}, native,
    # pipeline/{preprocess,run_slam}) and multi-device (backend/distributed,
    # parallel/{comm,dryrun,sharded_gn,sharded_map}) included, the two
    # profile tools and the bench
    assert n_modules >= 69


def test_entry_points_default_to_cuda():
    import torch

    from funny_lidar_slam_torch.backend.loop_closure import LoopCloser
    from funny_lidar_slam_torch.backend.pose_graph import PoseGraphBuilder
    from funny_lidar_slam_torch.core.cloud import Cloud
    from funny_lidar_slam_torch.imu.stream import ImuStream
    from funny_lidar_slam_torch.localization import LocalizationConfig, Localizer
    from funny_lidar_slam_torch.pipeline.system import (SlamSystem, SystemConfig,
                                                        to_device_segment)
    from funny_lidar_slam_torch.registration import matchers

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = SystemConfig(matcher_config=matchers.IcpConfig(map_layout="grid",
                                                         grid_dims=(8, 8, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        matchers.IcpMatcher(cfg.matcher_config)
    with pytest.raises(RuntimeError, match="CUDA"):
        Localizer(LocalizationConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        matchers.PointToPlaneMatcher(matchers.PointToPlaneConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        matchers.LoamFullMatcher(matchers.LoamFullConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        matchers.NdtMatcher(matchers.NdtConfig())
    loop_cfg = SystemConfig(matcher_config=cfg.matcher_config, enable_loopclosure=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(loop_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LoopCloser()
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseGraphBuilder().to_device()
    imu = ImuStream(require_static_init=False)
    for i in range(4):
        imu.push(0.01 * i, [0.0, 0.0, 0.0], [0.0, 0.0, 9.81])
    seg = imu.get_segment(0.0, 0.02, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_device_segment(seg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Cloud.empty(8)
    assert to_device_segment(seg, device="cpu").t.device.type == "cpu"
    assert SlamSystem(cfg, device="cpu").device.type == "cpu"
    assert SlamSystem(loop_cfg, device="cpu").loop_closer.device.type == "cpu"
    assert PoseGraphBuilder().to_device(device="cpu").poses.device.type == "cpu"
    assert Localizer(LocalizationConfig(), device="cpu").device.type == "cpu"


def test_cli_needs_cuda_unless_told_cpu(tmp_path):
    import torch

    from funny_lidar_slam_torch.pipeline import run_slam

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    args = ["--config", os.path.join(ROOT, "configs", "mapping", "config_turing_icp.yaml"),
            "--dataset", "synthetic", "--duration", "3.0", "--points-per-scan", "1024",
            "--max-scans", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        run_slam.main(args + ["--output", str(tmp_path / "cuda")])
    assert not (tmp_path / "cuda").exists()
    summary, runner = run_slam.main(args + ["--output", str(tmp_path / "cpu"), "--device", "cpu"])
    assert runner.device.type == "cpu" and summary["mode"] == "mapping"


def test_dryrun_needs_cuda_unless_told_cpu():
    """The multi-rank dry run: make_mesh and the entry point raise without
    CUDA; with --device cpu it runs two gloo ranks (worker processes, with
    a timeout) through every workload and its gates."""
    import torch

    from funny_lidar_slam_torch.parallel import comm, dryrun

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--world-size", "1", "--backend", "gloo"])
    summary = dryrun.main(["--world-size", "2", "--backend", "gloo", "--device", "cpu",
                           "--timeout", "300"])
    assert summary["size"] == 2 and summary["pose_graph_max_err_m"] < 0.25
    assert summary["sharded_map_t_err_m"] < 0.03 and summary["icp_t_err_m"] < 0.05
