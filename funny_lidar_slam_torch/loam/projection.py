"""Range-image projection (port of loam/projection.py).

The first point (in scan order) landing in each (ring, column) cell of a
V x H range image wins it, by a scatter-min of point indices; winners are
compacted row-major into an ordered cloud with per-row start/end indices by
one stable argsort of the cell id, so the packed arrays match the JAX
package's slot for slot. Every shape is static.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LidarGeometry(NamedTuple):
    """Scan geometry (rings, columns, radians per column, range gate)."""

    n_rows: int  # vertical scans (rings)
    n_cols: int  # horizontal resolution
    horizontal_resolution: float  # radians per column
    min_distance: float = 1.0
    max_distance: float = 100.0

    @staticmethod
    def velodyne16():
        return LidarGeometry(16, 1800, 2.0 * math.pi / 1800)

    @staticmethod
    def velodyne32():
        return LidarGeometry(32, 1800, 2.0 * math.pi / 1800)

    @staticmethod
    def velodyne64():
        return LidarGeometry(64, 1800, 2.0 * math.pi / 1800)

    @staticmethod
    def ouster128():
        return LidarGeometry(128, 1024, 2.0 * math.pi / 1024)


class OrderedScan(NamedTuple):
    """Row-major compacted projection."""

    points: torch.Tensor  # [N, 3] compacted, row-major
    depth: torch.Tensor  # [N]
    col: torch.Tensor  # [N] int32 column index
    row: torch.Tensor  # [N] int32 ring index
    rel_time: torch.Tensor  # [N]
    mask: torch.Tensor  # [N]
    row_start: torch.Tensor  # [R] int32 first packed index of each row
    row_end: torch.Tensor  # [R] int32 one-past-last packed index


def project(points: torch.Tensor, ring: torch.Tensor, rel_times: torch.Tensor,
            mask: torch.Tensor, geom: LidarGeometry) -> OrderedScan:
    """Project a padded (deskewed) lidar-frame cloud [N, 3] with its ring
    ids [N], relative times [N] and mask [N] onto the range image."""
    n = points.shape[0]
    dev = points.device
    r_rows, r_cols = geom.n_rows, geom.n_cols
    depth = torch.linalg.vector_norm(points, dim=-1)

    # round half to even, as jnp.round
    col = torch.round(torch.atan2(points[:, 1], points[:, 0]) / geom.horizontal_resolution)
    col = col.to(torch.int32) + r_cols // 2
    col = torch.where(col >= r_cols, col - r_cols, col)
    ring = ring.to(torch.int32)

    valid = (mask & (depth >= geom.min_distance) & (depth <= geom.max_distance)
             & (ring >= 0) & (ring < r_rows) & (col >= 0) & (col < r_cols))

    cell = ring * r_cols + col
    n_cells = r_rows * r_cols

    # first point wins its cell: scatter-min of the point index
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    tgt = torch.where(valid, cell, n_cells).to(torch.int64)
    winner = torch.full((n_cells + 1,), n, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, tgt, idx, "amin", include_self=True)
    is_winner = valid & (winner[cell.clamp(0, n_cells - 1).to(torch.int64)] == idx)

    # row-major compaction: a stable sort of the winners by cell id
    big = n_cells + 1
    key = torch.where(is_winner, cell, big)
    order = torch.argsort(key, stable=True)
    packed_mask = is_winner[order]
    packed_cell = torch.where(packed_mask, cell[order], big)
    packed_row = torch.div(packed_cell, r_cols, rounding_mode="floor")

    row_ids = torch.arange(r_rows, dtype=torch.int32, device=dev)
    row_start = torch.searchsorted(packed_row, row_ids, side="left").to(torch.int32)
    row_end = torch.searchsorted(packed_row, row_ids, side="right").to(torch.int32)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return OrderedScan(
        points=points[order],
        depth=torch.where(packed_mask, depth[order], 0.0),
        col=torch.where(packed_mask, torch.remainder(packed_cell, r_cols), zero),
        row=torch.where(packed_mask, packed_row, zero).to(torch.int32),
        rel_time=rel_times[order],
        mask=packed_mask,
        row_start=row_start,
        row_end=row_end,
    )


def synth_rings(points: torch.Tensor, n_rows: int, lower_deg: float = -25.0,
                upper_deg: float = 15.0) -> torch.Tensor:
    """Ring index from the elevation angle, for sources without a ring
    channel: int32 [...] in [0, n_rows)."""
    elev = torch.rad2deg(torch.atan2(points[..., 2],
                                     torch.linalg.vector_norm(points[..., :2], dim=-1)))
    step = (upper_deg - lower_deg) / n_rows
    ring = torch.floor((elev - lower_deg) / step).to(torch.int32)
    return torch.clamp(ring, 0, n_rows - 1)
