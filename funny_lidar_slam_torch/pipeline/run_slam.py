"""CLI entry point (the app/lidar_slam_app.cpp + roslaunch equivalent): the
port's copy of the JAX package's pipeline/run_slam.py.

    python -m funny_lidar_slam_torch.pipeline.run_slam \\
        --config configs/mapping/config_M2DGR.yaml \\
        --dataset recording.bag --output out/ [--device cpu]

Runs mapping or localization per the config's slam_mode, writes the TUM
trajectory (common/save_file.h format), map products (map.pcd + tiles +
pose_graph.g2o), a PNG of the run where matplotlib is installed, and prints
one JSON summary line. `--dataset synthetic` drives the built-in simulator;
`--dataset <file.bag>` replays a ROS1 bag through the port's reader
(io/bag_format.py). It runs on `cuda` unless `--device cpu` is given, and
without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import MODE_LOCALIZATION, load_config, make_localization_config
from ..core.device import resolve_device
from ..io import rosbag, viz
from ..io.simulator import SimConfig, simulate
from ..io.trajectory import ate_rmse, write_tum
from ..localization import Localizer
from .keyframes import materialize_batch
from .preprocess import range_and_jump_filter
from .system import SlamSystem

RETIRE_BATCH = 8  # mapping scans in flight before a batched retire


def _feed_bag(system_or_localizer, cfg, bag_path: str, max_scans, init_pose=None):
    """Replay bag events into the pipeline with an IMU-coverage pending queue
    (PreProcessing::Run waits until IMU covers the scan,
    preprocessing.cpp:124-142)."""
    obj = system_or_localizer
    # mapping dispatches and retires in batches like run_dataset; localization
    # keeps the synchronous path (its local-map refresh decisions need the pose)
    can_pipeline = hasattr(obj, "dispatch_scan") and init_pose is None
    pending = []
    in_flight = []
    n_done = 0

    def drain():
        obj.retire_batch(in_flight)
        in_flight.clear()

    for ev in rosbag.read_bag(bag_path, cfg.lidar_topic, cfg.imu_topic,
                              cfg.lidar_model.lidar_type, cfg.lidar_point_time_scale,
                              cfg.lidar_model):
        if ev[0] == "imu":
            _, t, gyro, accel, quat = ev
            obj.push_imu(t, gyro, accel, quat)
        else:
            pending.append(range_and_jump_filter(
                ev[1], cfg.lidar_use_min_distance, cfg.lidar_use_max_distance,
                cfg.lidar_point_jump_span))
        while pending:
            scan = pending[0]
            end = scan.stamp + (float(scan.rel_times.max()) if len(scan.rel_times) else 0.0)
            if not obj.imu.initialized or not obj.imu.covers(scan.stamp, end):
                break
            pending.pop(0)
            if init_pose is not None and not obj.initialized:
                obj.try_init(init_pose, scan.stamp, end, scan.points, scan.rel_times)
            elif can_pipeline:
                p = obj.dispatch_scan(scan.stamp, end, scan.points, scan.rel_times)
                if p is not None:
                    in_flight.append(p)
                if len(in_flight) >= RETIRE_BATCH:
                    drain()
            else:
                obj.process_scan(scan.stamp, end, scan.points, scan.rel_times)
            n_done += 1
            if max_scans and n_done >= max_scans:
                drain()
                return
    drain()


def _gt_of(ds):
    return {round(t, 4): pose for t, pose in zip(ds.gt_times, ds.gt_poses)}


def _save_png(args, summary, runner, out, ds):
    """The per-run render (the offline stand-in for the reference's live RViz
    topics, system.cpp:723-845): trajectory against the truth, map, status."""
    viz_poses, gt_poses = out["poses"], None
    if ds is not None:
        gt = _gt_of(ds)
        # keep est/gt rows index-aligned: drop the est rows whose stamp has
        # no truth rather than only filtering gt
        pairs = [(p, gt[round(t, 4)]) for t, p in zip(out["times"], out["poses"])
                 if round(t, 4) in gt]
        if pairs:
            viz_poses = np.asarray([p for p, _ in pairs])
            gt_poses = np.asarray([g for _, g in pairs])
    map_pts = None
    kfs = getattr(runner, "keyframes", None)
    if kfs is not None and len(kfs):
        materialize_batch(kfs.frames)
        world = [kf.cloud[:: max(1, len(kf.cloud) // 4000)] @ kf.pose[:3, :3].T
                 + kf.pose[:3, 3] for kf in kfs.frames]
        map_pts = np.concatenate(world) if world else None
    return viz.save_run_png(
        os.path.join(args.output, "run.png"), viz_poses, gt_poses, map_pts,
        getattr(runner, "stats", None),
        title=f"{summary['mode']} — {os.path.basename(args.config)}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic' or a path to a ROS1 .bag")
    p.add_argument("--output", default="out")
    p.add_argument("--max-scans", type=int, default=None)
    p.add_argument("--duration", type=float, default=30.0,
                   help="synthetic dataset duration (s)")
    p.add_argument("--points-per-scan", type=int, default=16384)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--save-map", action="store_true")
    p.add_argument("--split-map", action="store_true")
    p.add_argument("--map-dir", default=None,
                   help="localization: map directory overriding the config")
    p.add_argument("--init-pose", type=float, nargs=16, default=None,
                   help="localization: row-major 4x4 init pose (map frame)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda, which must be available")
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI; prints the JSON summary line and returns (summary, the
    SlamSystem or Localizer of the run)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    os.makedirs(args.output, exist_ok=True)
    t_wall = time.perf_counter()

    ds = None
    if args.dataset == "synthetic":
        ds = simulate(SimConfig(duration=args.duration,
                                points_per_scan=args.points_per_scan, seed=args.seed))

    if cfg.slam_mode == MODE_LOCALIZATION:
        lcfg = make_localization_config(cfg)
        if args.map_dir:
            if os.path.isfile(os.path.join(args.map_dir, "tile_map_indices.txt")):
                lcfg.tile_map_dir, lcfg.map_path = args.map_dir, None
            else:
                lcfg.map_path = os.path.join(args.map_dir, "map.pcd")
                lcfg.tile_map_dir = None
        runner = Localizer(lcfg, device=device)
        init_pose = (np.asarray(args.init_pose).reshape(4, 4)
                     if args.init_pose else np.eye(4))
        if ds is not None:
            out = runner.run_dataset(ds, init_pose, args.max_scans)
        else:
            _feed_bag(runner, cfg, args.dataset, args.max_scans, init_pose)
            out = {"poses": np.asarray(runner.trajectory),
                   "times": np.asarray(runner.trajectory_t)}
        summary = {"mode": "localization", "frames": len(out["poses"]),
                   "initialized": runner.initialized}
    else:
        cfg.system.keyframe_save_dir = os.path.join(args.output, "keyframes")
        runner = SlamSystem(cfg.system, device=device)
        summary_ate = None
        if ds is not None:
            out = runner.run_dataset(ds, max_scans=args.max_scans, progress=True)
            gt = _gt_of(ds)
            aligned = np.asarray([gt[round(t, 4)] for t in out["times"]])
            if len(out["poses"]):
                summary_ate = ate_rmse(out["poses"], aligned, align=True)
        else:
            _feed_bag(runner, cfg, args.dataset, args.max_scans)
            out = {"poses": np.asarray(runner.trajectory),
                   "times": np.asarray(runner.trajectory_t),
                   "n_keyframes": len(runner.keyframes)}
        if args.save_map or args.split_map:
            runner.save_map(os.path.join(args.output, "map"), split=args.split_map)
        runner.graph.save_g2o(os.path.join(args.output, "pose_graph.g2o"))
        summary = {"mode": "mapping", "frames": len(out["poses"]),
                   "keyframes": out.get("n_keyframes", len(runner.keyframes)),
                   "loop_closures": len(runner.loop_results)}
        if summary_ate is not None:
            summary["ate_m"] = round(float(summary_ate), 4)

    if len(out["poses"]):
        write_tum(os.path.join(args.output, "trajectory_tum.txt"),
                  out["times"], out["poses"])
        summary["viz"] = _save_png(args, summary, runner, out, ds) if viz.available() else None
    summary["wall_s"] = round(time.perf_counter() - t_wall, 2)
    print(json.dumps(summary))
    return summary, runner


if __name__ == "__main__":
    main()
