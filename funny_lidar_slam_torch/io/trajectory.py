"""Trajectory evaluation (ATE/RPE), NumPy: a copy of the JAX package's
io/trajectory.py metrics, which are the acceptance metric of a mapping run.
"""

from __future__ import annotations

import numpy as np


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
