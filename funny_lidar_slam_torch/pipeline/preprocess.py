"""Host-side scan preprocessing (non-LOAM branch of PreProcessing::Run,
src/slam/preprocessing.cpp:181-225), the port's copy of the JAX package's
pipeline/preprocess.py: min/max range filter and the point-jump subsample.
The voxel filter runs on the device inside each matcher's `_source`
(ops/voxel.voxel_downsample), and the LOAM feature branch inside the
frontend (loam/projection + loam/features)."""

from __future__ import annotations

import numpy as np

from ..io.formats import RawScan


def range_and_jump_filter(scan: RawScan, min_distance: float,
                          max_distance: float, jump_span: int = 1) -> RawScan:
    """Drop points outside [min, max] range, then keep every `jump_span`-th
    point (lidar_point_jump_span, preprocessing.cpp:186-205)."""
    r = np.linalg.norm(scan.points, axis=1)
    keep = (r >= min_distance) & (r <= max_distance)
    idx = np.flatnonzero(keep)
    if jump_span > 1:
        idx = idx[::jump_span]
    return RawScan(
        stamp=scan.stamp,
        points=scan.points[idx],
        intensity=scan.intensity[idx],
        ring=scan.ring[idx],
        rel_times=scan.rel_times[idx],
    )
