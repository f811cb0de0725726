"""Navigation-state containers (port of core/state.py).

State ordering convention: [R(3), V(3), P(3), bg(3), ba(3)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .lie import make_se3


class NavState(NamedTuple):
    """Single navigation state. All tensors may carry leading batch dims."""

    r: torch.Tensor  # [..., 3, 3] rotation body->world
    v: torch.Tensor  # [..., 3] velocity in world
    p: torch.Tensor  # [..., 3] position in world
    bg: torch.Tensor  # [..., 3] gyro bias
    ba: torch.Tensor  # [..., 3] accel bias
    info: torch.Tensor  # [..., 15, 15] prior information matrix
    t: torch.Tensor  # [...] timestamp, seconds

    @property
    def pose(self) -> torch.Tensor:
        return make_se3(self.r, self.p)

    @staticmethod
    def identity(dtype=torch.float32, device="cpu", batch: tuple = ()) -> "NavState":
        kw = dict(dtype=dtype, device=device)
        return NavState(
            r=torch.eye(3, **kw).expand(batch + (3, 3)).clone(),
            v=torch.zeros(batch + (3,), **kw),
            p=torch.zeros(batch + (3,), **kw),
            bg=torch.zeros(batch + (3,), **kw),
            ba=torch.zeros(batch + (3,), **kw),
            info=torch.zeros(batch + (15, 15), **kw),
            t=torch.zeros(batch, **kw),
        )

    def with_pose(self, t_mat: torch.Tensor) -> "NavState":
        return self._replace(r=t_mat[..., :3, :3], p=t_mat[..., :3, 3])


class ImuSegment(NamedTuple):
    """A padded span of IMU samples covering one lidar scan: fixed capacity,
    boundary samples interpolated, `mask` marks valid rows. The host stream
    fills it with NumPy arrays; the device step takes tensors."""

    t: torch.Tensor  # [..., N] seconds
    gyro: torch.Tensor  # [..., N, 3]
    accel: torch.Tensor  # [..., N, 3]
    quat: torch.Tensor  # [..., N, 4] orientation (w,x,y,z); identity if 6-axis
    mask: torch.Tensor  # [..., N] bool


def to_device_segment(seg: ImuSegment, dtype=torch.float32, device=None) -> ImuSegment:
    """A host segment (NumPy, from `ImuStream.get_segment`) as tensors on
    `device` (default: CUDA; raises without it): t, gyro, accel and quat
    cast to `dtype`, the mask to bool; one host->device copy a field."""
    device = resolve_device(device)
    return ImuSegment(*(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in (seg.t, seg.gyro, seg.accel, seg.quat)),
                      mask=torch.as_tensor(seg.mask, dtype=torch.bool, device=device))


def where_tree(cond, a, b):
    """torch.where over two NamedTuple trees of the same structure: a
    selection on the device in place of a branch on a host read."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return type(a)(*(where_tree(cond, x, y) for x, y in zip(a, b)))
