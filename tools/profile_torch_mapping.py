"""Where the port's per-scan step spends its time on one GPU.

    python3 tools/profile_torch_mapping.py [--scans 12] [--path grid|block|localization]
        [--out build/profile_torch_mapping.json]
    python3 tools/profile_torch_mapping.py --path preset --config configs/mapping/X.yaml
        [--points 57600] [--segment-capacity 16]

Runs funny_lidar_slam_torch over the simulator on one of the paths that
chip_smoke.py drives (IcpOptimized + TightCouplingOptimization, 16384
points per scan): SlamSystem on the headline mapping config with the dense
grid (96, 96, 16) (`grid`) or the hashed block map, the IcpConfig default
(`block`), or the Localizer on the bench's localization config against the
simulator world (`localization`). `preset` runs SlamSystem on a mapping
preset's configuration, as the CLI builds it (without the keyframe store),
over `--points` points a scan passed through the preset's range and jump
filter, as the CLI's bag replay feeds them; `--segment-capacity`
overrides the preset's IMU segment capacity. It then profiles `--scans` steady scans
with torch.profiler. From the profiler's trace it reports the wall time per
scan, the device's busy time and idle share over the window, the device
time by kernel and the host time of each step phase (spans named after the
functions they wrap). Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (module, function) pairs wrapped in a profiler span: the phases of a step
PHASES = (
    ("pipeline.frontend", "deskew"),
    ("pipeline.frontend", "preintegrate"),
    ("pipeline.frontend", "predict"),
    ("pipeline.frontend", "tight_fuse"),
    ("registration.matchers", "voxel_downsample"),
    ("registration.matchers", "run_gn_ndt"),
    ("registration.matchers", "run_gn_icp_cand"),
    ("registration.matchers", "window_add"),
    ("registration.residuals", "group_by_voxel"),
    ("maps.grid_map", "gather_cover"),
    ("maps.block_map", "gather_cover"),
    ("maps.block_map", "insert"),
)


def _span(torch, name, fn):
    def wrapper(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapper


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def preset_filtered(cfg, scan):
    """A simulator scan through the preset's range and jump filter."""
    from funny_lidar_slam_torch.io.formats import RawScan
    from funny_lidar_slam_torch.pipeline.preprocess import range_and_jump_filter

    n = len(scan.points)
    raw = RawScan(scan.t, scan.points, np.zeros(n, np.float32), np.zeros(n, np.int32),
                  scan.rel_times)
    kept = range_and_jump_filter(raw, cfg.lidar_use_min_distance, cfg.lidar_use_max_distance,
                                 cfg.lidar_point_jump_span)
    return dataclasses.replace(scan, points=kept.points, rel_times=kept.rel_times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--path", choices=("grid", "block", "localization", "preset"),
                    default="grid")
    ap.add_argument("--config", help="--path preset: a mapping preset under configs/")
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--segment-capacity", type=int, default=None)
    ap.add_argument("--out", default="build/profile_torch_mapping.json")
    args = ap.parse_args()

    import importlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_mapping: CUDA is not available")
    from funny_lidar_slam_torch.config import load_config
    from funny_lidar_slam_torch.io.simulator import SimConfig, make_world, simulate
    from funny_lidar_slam_torch.localization import LocalizationConfig, Localizer
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
    from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
    from funny_lidar_slam_torch.registration import matchers

    cap = 16384
    ds = simulate(SimConfig(duration=10.0, points_per_scan=args.points, seed=7))
    if args.path == "preset":
        cfg = load_config(args.config)
        if args.segment_capacity:
            cfg.system.imu_segment_capacity = args.segment_capacity
        runner = SlamSystem(cfg.system)
        ds = dataclasses.replace(ds, scans=[preset_filtered(cfg, sc) for sc in ds.scans])
        run = runner.run_dataset
    elif args.path == "localization":
        runner = Localizer(LocalizationConfig(
            registration_mode="IcpOptimized",
            matcher_config=matchers.IcpConfig(
                source_capacity=cap, cloud_capacity=cap, merged_capacity=65536,
                map_capacity=65536, is_localization_mode=True),
            scan_capacity=cap, imu_segment_capacity=16, map_filter_size=0.4,
            local_map_size=80.0, local_map_boundary=20.0, local_map_capacity=65536))
        runner.set_global_map(make_world(seed=7))

        def run(dataset, **kw):
            return runner.run_dataset(dataset, ds.scans[0].gt_pose, **kw)
    else:
        layout = (dict(map_layout="grid", grid_dims=(96, 96, 16)) if args.path == "grid"
                  else dict(map_layout="block"))
        runner = SlamSystem(SystemConfig(
            registration_mode="IcpOptimized",
            matcher_config=matchers.IcpConfig(
                source_capacity=cap, cloud_capacity=cap, merged_capacity=65536,
                map_capacity=65536, local_map_size=20, **layout),
            frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
            scan_capacity=cap, imu_segment_capacity=16))
        run = runner.run_dataset

    for mod, fn in PHASES:
        m = importlib.import_module(f"funny_lidar_slam_torch.{mod}")
        setattr(m, fn, _span(torch, fn, getattr(m, fn)))

    # run every scan before the profiled window, then profile the last scans
    # with the IMU samples that the earlier scans did not consume
    n_warm = len(ds.scans) - args.scans
    run(ds, max_scans=n_warm)
    torch.cuda.synchronize()
    period = ds.scans[1].t - ds.scans[0].t
    i0 = int(np.searchsorted(ds.imu_t, ds.scans[n_warm - 1].t + period + 0.05, side="right"))
    tail = dataclasses.replace(ds, scans=ds.scans[n_warm:], imu_t=ds.imu_t[i0:],
                               imu_gyro=ds.imu_gyro[i0:], imu_accel=ds.imu_accel[i0:])
    done = len(runner.stats)
    launches0 = select.fused_select.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(tail)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = sum(1 for s in runner.stats[done:] if not s.get("init"))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_kernel = defaultdict(float)
    for e in dev:
        by_kernel[e["name"][:90]] += e["dur"]
    spans = defaultdict(float)
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]] += e["dur"]
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    report = {
        "device": torch.cuda.get_device_name(0),
        "path": args.path,
        "config": args.config,
        "points_per_scan": float(np.mean([len(sc.points) for sc in ds.scans])),
        "imu_segment_capacity": getattr(getattr(runner, "cfg", None),
                                        "imu_segment_capacity", None),
        "scans": steps,
        "wall_ms_per_scan": wall * 1e3 / steps,
        "device_busy_ms_per_scan": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "device_launches_per_scan": len(dev) / steps,
        "fused_select_launches": select.fused_select.launches - launches0,
        "host_span_ms_per_scan": {k: v / 1e3 / steps for k, v in
                                  sorted(spans.items(), key=lambda kv: -kv[1])},
        "device_ms_per_scan_by_kernel": {k: v / 1e3 / steps for k, v in top},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "device_ms_per_scan_by_kernel"}, indent=1))
    for name, ms in list(report["device_ms_per_scan_by_kernel"].items())[:12]:
        print(f"  {ms:9.4f} ms/scan  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
