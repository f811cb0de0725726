"""Loose coupling: take the matcher pose directly as the fused state
(pose from registration, velocity carried from the predict, no bias update)."""

from __future__ import annotations

import torch

from ..core.state import NavState


def fuse(predict_nav: NavState, lidar_pose: torch.Tensor) -> NavState:
    return predict_nav.with_pose(lidar_pose.to(predict_nav.r.dtype))
