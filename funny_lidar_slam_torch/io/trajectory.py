"""Trajectory export (TUM) and evaluation (ATE/RPE), NumPy: a copy of the
JAX package's io/trajectory.py; ATE is the acceptance metric of a run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lie import mat_to_quat, quat_to_mat


def write_tum(path: str, times, poses) -> None:
    """poses: [K, 4, 4]. TUM line: t x y z qx qy qz qw."""
    poses = np.asarray(poses, np.float64).reshape(-1, 4, 4)
    quats = mat_to_quat(torch.from_numpy(poses[:, :3, :3].copy())).numpy()  # [w, x, y, z]
    with open(path, "w") as f:
        for t, p, q in zip(times, poses, quats):
            f.write(
                f"{t:.6f} {p[0, 3]:.6f} {p[1, 3]:.6f} {p[2, 3]:.6f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (times [K], poses [K, 4, 4])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append([float(v) for v in line.split()])
    rows = np.asarray(rows, np.float64).reshape(-1, 8)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    quat = torch.from_numpy(rows[:, [7, 4, 5, 6]].copy())  # [w, x, y, z]
    poses[:, :3, :3] = quat_to_mat(quat).numpy()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses


def umeyama_alignment(est: np.ndarray, gt: np.ndarray):
    """SE(3) alignment (no scale) of est -> gt. Inputs [K, 3]."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / len(est)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    t = mu_g - r @ mu_e
    return r, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over positions. [K, 4, 4] inputs."""
    est = est_poses[:, :3, 3]
    gt = gt_poses[:, :3, 3]
    if align:
        r, t = umeyama_alignment(est, gt)
        est = est @ r.T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> float:
    """Relative pose error RMSE (translation) at frame offset `delta`."""
    errs = []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        errs.append(np.linalg.norm((np.linalg.inv(dg) @ de)[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))
