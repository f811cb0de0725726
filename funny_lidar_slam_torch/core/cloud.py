"""Padded point-cloud containers (port of core/cloud.py): every scan is a
fixed-capacity tensor of points plus a validity mask."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Cloud(NamedTuple):
    points: torch.Tensor  # [N, 3]
    mask: torch.Tensor  # [N] bool


def transform_cloud(t_mat: torch.Tensor, c: Cloud) -> Cloud:
    """Rigid transform of a padded cloud."""
    return Cloud(c.points @ t_mat[:3, :3].T + t_mat[:3, 3], c.mask)
