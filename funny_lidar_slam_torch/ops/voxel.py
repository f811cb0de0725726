"""Voxel grouping primitives (port of ops/voxel.py): the spatial hash,
sorting-based grouping and the centroid voxel-grid filter.

Deviations from the JAX package, all deliberate:
  * the packed sort key is int64 (torch has no CPU kernels for uint32
    shifts); the bit layout and the invalid key 0xFFFFFFFF are unchanged;
  * the sort is stable, so the order inside a voxel run is the input order;
  * the 32-bit hashes run in int64 lanes masked to 32 bits (`u32_mul`),
    bit for bit the JAX package's wrapping uint32 arithmetic.
All outputs are fixed-capacity padded tensors with masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_U32 = 0xFFFFFFFF

# Large-prime XOR hash constants (the reference's hash_function.h)
_P1, _P2, _P3 = 73856093, 471943, 83492791


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> its uint32 bit pattern, held in int64."""
    return x.to(torch.int64) & _U32


def u32_mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) held in int64. The constant is
    split into 16-bit halves so no product passes 2^48."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = u32_mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = u32_mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def voxel_coords(points: torch.Tensor, inv_voxel_size) -> torch.Tensor:
    """Points [..., 3] -> int32 voxel coords [..., 3] (floor convention)."""
    return torch.floor(points * inv_voxel_size).to(torch.int32)


def spatial_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Voxel coords [..., 3] -> int64 slot [...] in a power-of-2 table: the
    prime-XOR combine passed through fmix32, then masked."""
    assert table_size & (table_size - 1) == 0, "table_size must be a power of 2"
    c = u32(coords)
    h = u32_mul(c[..., 0], _P1) ^ u32_mul(c[..., 1], _P2) ^ u32_mul(c[..., 2], _P3)
    return fmix32(h) & (table_size - 1)


class VoxelGroups(NamedTuple):
    """Result of sorting points by voxel (all shapes static).

    order       [n]    permutation sorting valid points by voxel, invalid last
    sorted_pts  [n,3]  points[order]
    sorted_mask [n]    mask[order]
    group_id    [n]    0-based contiguous id of each sorted point's voxel
                       (invalid points share the id of the last group; mask!)
    rank        [n]    index of the point within its voxel group
    group_coords[n,3]  int32 voxel coords of each sorted point
    num_groups  []     number of distinct valid voxels
    """

    order: torch.Tensor
    sorted_pts: torch.Tensor
    sorted_mask: torch.Tensor
    group_id: torch.Tensor
    rank: torch.Tensor
    group_coords: torch.Tensor
    num_groups: torch.Tensor


_INVALID_KEY = 0xFFFFFFFF


def _first_of_run(key_sorted: torch.Tensor, sorted_mask: torch.Tensor) -> torch.Tensor:
    """True where a sorted key differs from its predecessor (and is valid)."""
    changed = key_sorted != torch.roll(key_sorted, 1)
    changed[0] = True
    return changed & sorted_mask


def group_by_voxel(points: torch.Tensor, mask: torch.Tensor, inv_voxel_size) -> VoxelGroups:
    """Sort points so same-voxel points are adjacent; compute group ids/ranks.

    One sort over a packed key: voxel coords relative to the batch minimum
    in (x:10, y:11, z:10) bit fields, invalid points pushed to the end."""
    n = points.shape[0]
    coords = voxel_coords(points, inv_voxel_size)
    cmin = torch.where(mask[:, None], coords, torch.full_like(coords, 2**30)).amin(0)
    rel = (coords - cmin).to(torch.int64)
    rx = rel[:, 0].clamp(0, 1023)
    ry = rel[:, 1].clamp(0, 2047)
    rz = rel[:, 2].clamp(0, 1023)
    key = (rx << 21) | (ry << 10) | rz
    key = torch.where(mask, key, torch.full_like(key, _INVALID_KEY))

    key_sorted, order = torch.sort(key, stable=True)
    sorted_pts = points[order]
    sorted_mask = mask[order]
    sorted_coords = coords[order]

    is_new = _first_of_run(key_sorted, sorted_mask)
    group_id = torch.clamp(torch.cumsum(is_new, 0) - 1, min=0)
    idx = torch.arange(n, device=points.device)
    seg_start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)), 0).values
    rank = idx - seg_start
    num_groups = is_new.sum(dtype=torch.int32)
    return VoxelGroups(order, sorted_pts, sorted_mask, group_id, rank,
                       sorted_coords, num_groups)


class PaddedCloud(NamedTuple):
    points: torch.Tensor  # [capacity, 3]
    mask: torch.Tensor  # [capacity] bool


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, voxel_size,
                     capacity: int) -> PaddedCloud:
    """Centroid voxel-grid filter: at most `capacity` voxel centroids, one
    per occupied voxel, in voxel-sorted order. Groups past `capacity` are
    dropped (they land in the discarded dump segment)."""
    g = group_by_voxel(points, mask, 1.0 / voxel_size)
    seg_id = torch.where(g.sorted_mask, g.group_id,
                         torch.full_like(g.group_id, capacity)).clamp(max=capacity)
    w = g.sorted_mask.to(points.dtype)
    sums = torch.zeros((capacity + 1, 3), dtype=points.dtype, device=points.device)
    sums.index_add_(0, seg_id, g.sorted_pts * w[:, None])
    counts = torch.zeros(capacity + 1, dtype=points.dtype, device=points.device)
    counts.index_add_(0, seg_id, w)
    centroids = sums[:capacity] / torch.clamp(counts[:capacity], min=1.0)[:, None]
    return PaddedCloud(centroids, counts[:capacity] > 0)
