"""Motion deskew, rotation-only, vectorized (port of lidar/deskew.py).

Every point is moved into the scan-reference frame with
p' = q_ref^-1 * q(t) * (T_l2i * p), q(t) linearly interpolated between the
bracketing IMU orientation samples (one `searchsorted` + gather).
"""

from __future__ import annotations

import torch

from ..core.lie import quat_nlerp, quat_to_mat
from ..core.state import ImuSegment


def _bracket(seg_t, n_seg, t):
    """Index of the last sample with seg_t <= t, clamped to [0, n_seg-2]."""
    j = torch.searchsorted(seg_t, t, right=True) - 1
    return torch.minimum(torch.clamp(j, min=0), torch.clamp(n_seg - 2, min=0))


def deskew(
    points: torch.Tensor,  # [N, 3] lidar-frame points
    rel_times: torch.Tensor,  # [N] seconds relative to scan reference time
    mask: torch.Tensor,  # [N]
    ref_time: torch.Tensor,  # [] absolute scan reference time (s)
    segment: ImuSegment,  # IMU span covering the scan
    t_lidar_to_imu: torch.Tensor,  # [4, 4]
):
    """Returns (deskewed points [N, 3] in the IMU frame at ref_time, mask)."""
    dtype = points.dtype
    seg_t = torch.where(segment.mask, segment.t.to(dtype),
                        torch.full_like(segment.t, float("inf"), dtype=dtype))
    n_seg = segment.mask.sum()
    quat = segment.quat.to(dtype)

    def q_at(t):
        j = _bracket(seg_t, n_seg, t)
        t0, t1 = seg_t[j], seg_t[j + 1]
        r = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
        return quat_nlerp(quat[j], quat[j + 1], r)

    ref = ref_time.to(dtype).reshape(1)
    r_ref_inv = quat_to_mat(q_at(ref))[0].T

    r_t = quat_to_mat(q_at(ref + rel_times))  # [N, 3, 3]
    p_imu = points @ t_lidar_to_imu[:3, :3].T + t_lidar_to_imu[:3, 3]
    p_rot = torch.einsum("nij,nj->ni", r_t, p_imu)
    return p_rot @ r_ref_inv.T, mask
