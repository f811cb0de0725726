"""Shared block-layout helpers (port of the helpers of maps/block_map.py).

Voxels are grouped into 2x2x2 BLOCKS; the 3x3x3 stencil around any query
voxel is covered by exactly 8 neighbouring blocks (`_COVER`). A block row
stores its 8 voxel buckets as flat coordinate planes
[x(8*S) | y(8*S) | z(8*S)]; empty positions hold `_MISS` (1e30), whose
squared distance is +inf in f32, so the select needs no validity mask.

The hashed `BlockMap` itself is a later slice of the port; the dense grid
(`grid_map.py`) uses these helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.voxel import _INVALID_KEY, _first_of_run, voxel_coords

_MISS = 1e30

# the 8 block offsets covering the 3x3x3 voxel stencil of any query voxel
_COVER = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _block_of(coords: torch.Tensor):
    """Voxel coords -> (block coords, local voxel index 0..7). Arithmetic
    >> floors negatives; & takes the true parity bit."""
    bc = coords >> 1
    lb = coords & 1
    local = (lb[..., 0] << 2) | (lb[..., 1] << 1) | lb[..., 2]
    return bc, local


class _BlockGroups(NamedTuple):
    """One block-major sort yielding voxel AND block runs."""

    sorted_pts: torch.Tensor  # [n, 3]
    sorted_mask: torch.Tensor  # [n]
    sorted_coords: torch.Tensor  # [n, 3] int32 voxel coords
    local: torch.Tensor  # [n] local voxel index 0..7
    vox_rank: torch.Tensor  # [n] rank within the voxel run
    vox_start: torch.Tensor  # [n] start index of the voxel run
    blk_id: torch.Tensor  # [n] contiguous block-group id
    blk_is_rep: torch.Tensor  # [n] first point of its block run
    num_blocks: torch.Tensor  # []


def _group_block_major(points, mask, inv_voxel_size) -> _BlockGroups:
    """Sort points by a block-major packed key: the 3 local-voxel bits sit
    below the block bits, so equal-key runs are voxels and equal-(key>>3)
    runs are blocks. int64 key, stable sort (see ops/voxel.py)."""
    coords = voxel_coords(points, inv_voxel_size)
    bc, local = _block_of(coords)
    bmin = torch.where(mask[:, None], bc, torch.full_like(bc, 2**30)).amin(0)
    rel = (bc - bmin).to(torch.int64)
    rx = rel[:, 0].clamp(0, 511)
    ry = rel[:, 1].clamp(0, 1023)
    rz = rel[:, 2].clamp(0, 511)
    key = (((((rx << 10) | ry) << 9) | rz) << 3) | local.to(torch.int64)
    key = torch.where(mask, key, torch.full_like(key, _INVALID_KEY))

    n = points.shape[0]
    key_sorted, order = torch.sort(key, stable=True)
    sorted_mask = mask[order]
    new_vox = _first_of_run(key_sorted, sorted_mask)
    new_blk = _first_of_run(key_sorted >> 3, sorted_mask)

    idx = torch.arange(n, device=points.device)
    vox_start = torch.cummax(torch.where(new_vox, idx, torch.zeros_like(idx)), 0).values
    return _BlockGroups(
        sorted_pts=points[order],
        sorted_mask=sorted_mask,
        sorted_coords=coords[order],
        local=local[order],
        vox_rank=idx - vox_start,
        vox_start=vox_start,
        blk_id=torch.clamp(torch.cumsum(new_blk, 0) - 1, min=0),
        blk_is_rep=new_blk,
        num_blocks=new_blk.sum(dtype=torch.int32),
    )
