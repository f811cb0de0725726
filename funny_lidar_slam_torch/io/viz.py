"""Per-run visualization artifact, a static PNG next to the trajectory file:
the port's copy of the JAX package's io/viz.py. matplotlib is optional: it
is imported inside `save_run_png` only, and `available()` says whether it
is installed.

The reference's primary observability is live RViz publishing
(src/slam/system.cpp:723-845: path, frame cloud, local/global map topics).
An offline pipeline has no ROS graph, so the equivalent artifact is a
rendered summary written at save time: estimated trajectory vs ground truth
(XY + z profile) over a downsampled map scatter, plus per-scan status.
"""

from __future__ import annotations

import importlib.util

import numpy as np


def available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def save_run_png(
    path: str,
    est_poses: np.ndarray,  # [K, 4, 4]
    gt_poses: np.ndarray | None = None,  # [K, 4, 4]
    map_points: np.ndarray | None = None,  # [M, 3]
    stats: list | None = None,  # per-scan stat dicts (SlamSystem.stats)
    title: str = "funny_lidar_slam_torch run",
    max_map_points: int = 200_000,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est_poses = np.asarray(est_poses)
    has_gt = gt_poses is not None and len(gt_poses)
    fig, axes = plt.subplots(
        1, 3 if stats else 2, figsize=(15 if stats else 11, 5))
    ax_xy, ax_z = axes[0], axes[1]

    if map_points is not None and len(map_points):
        mp = np.asarray(map_points)
        if len(mp) > max_map_points:
            mp = mp[:: len(mp) // max_map_points + 1]
        ax_xy.scatter(mp[:, 0], mp[:, 1], s=0.05, c="0.75", linewidths=0,
                      rasterized=True, label="map")

    if len(est_poses):
        p = est_poses[:, :3, 3]
        ax_xy.plot(p[:, 0], p[:, 1], "-", c="tab:blue", lw=1.2, label="estimate")
        ax_xy.plot(p[0, 0], p[0, 1], "o", c="tab:blue", ms=5)
        ax_z.plot(p[:, 2], c="tab:blue", lw=1.0, label="estimate z")
    if has_gt:
        g = np.asarray(gt_poses)[:, :3, 3]
        ax_xy.plot(g[:, 0], g[:, 1], "--", c="tab:orange", lw=1.0,
                   label="ground truth")
        ax_z.plot(g[:, 2], "--", c="tab:orange", lw=1.0, label="gt z")
        n = min(len(g), len(est_poses))
        err = np.linalg.norm(est_poses[:n, :3, 3] - g[:n], axis=1)
        ax_z2 = ax_z.twinx()
        ax_z2.plot(err, c="tab:red", lw=0.8, alpha=0.7)
        ax_z2.set_ylabel("position error [m]", color="tab:red")
    ax_xy.set_aspect("equal")
    ax_xy.set_xlabel("x [m]")
    ax_xy.set_ylabel("y [m]")
    ax_xy.legend(loc="best", fontsize=8)
    ax_xy.set_title(title)
    ax_z.set_xlabel("scan #")
    ax_z.set_ylabel("z [m]")
    ax_z.legend(loc="best", fontsize=8)
    ax_z.set_title("height / error profile")

    if stats:
        ax_s = axes[2]
        it = [s.get("iters", 0) for s in stats if not s.get("init")]
        nv = [s.get("num_valid", 0) for s in stats if not s.get("init")]
        ax_s.plot(it, c="tab:green", lw=0.8, label="GN gathers")
        ax_s2 = ax_s.twinx()
        ax_s2.plot(nv, c="tab:purple", lw=0.8, alpha=0.6)
        ax_s2.set_ylabel("valid correspondences", color="tab:purple")
        kf = [i for i, s in enumerate(stats) if s.get("keyframe")]
        for x in kf:
            ax_s.axvline(x, c="0.9", lw=0.5, zorder=0)
        ax_s.set_xlabel("scan #")
        ax_s.set_ylabel("GN gathers", color="tab:green")
        ax_s.set_title(f"per-scan status ({len(kf)} keyframes)")

    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
