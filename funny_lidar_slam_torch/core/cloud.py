"""Padded point-cloud containers (port of core/cloud.py): every scan is a
fixed-capacity tensor of points plus a validity mask; a `ScanBundle` is
one preprocessed scan with its IMU segment."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .state import ImuSegment


class Cloud(NamedTuple):
    points: torch.Tensor  # [N, 3]
    mask: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, device=None) -> "Cloud":
        """An all-invalid cloud on `device` (default: CUDA; raises without
        it)."""
        device = resolve_device(device)
        return Cloud(torch.zeros((capacity, 3), dtype=dtype, device=device),
                     torch.zeros(capacity, dtype=torch.bool, device=device))


def transform_cloud(t_mat: torch.Tensor, c: Cloud) -> Cloud:
    """Rigid transform of a padded cloud."""
    return Cloud(c.points @ t_mat[:3, :3].T + t_mat[:3, 3], c.mask)


class ScanBundle(NamedTuple):
    """One preprocessed scan: deskewed clouds and the covering IMU segment.
    `ordered` is the deskewed full cloud (downsampled for ICP/NDT modes);
    `planar`/`corner` are LOAM feature clouds (empty in the other modes)."""

    timestamp: torch.Tensor  # [] seconds
    ordered: Cloud
    planar: Cloud
    corner: Cloud
    imu: ImuSegment
