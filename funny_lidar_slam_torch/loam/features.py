"""LOAM corner/planar feature extraction (port of loam/features.py).

  * roughness = (sum of the 10 packed neighbours - 10 * depth)^2, from
    wrap-around rolls over the compacted array;
  * invalid marks: occlusion (column step < 10 and depth jump > 0.3 masks
    5-6 neighbours) and parallel-beam points, as rolled seed masks;
  * per row, 6 angular blocks; corners are up to 20 highest-roughness valid
    points above the corner threshold, picked greedily with +-5 neighbour
    suppression: 20 sequential masked argmax picks over a [rows*6, L] block
    lattice, all blocks at once;
  * the planar cloud is every masked non-corner packed point. The JAX
    package does not use `planar_threshold`, and neither does the port.

The corner suppression masks a flat +-5 window inside the block, as the
JAX package does. Everything up to the corner mask is one kernel on CUDA
tensors (`ops/loam_features.py::corner_mask`, csrc/loam_features.cu) and
`corner_mask_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cloud import Cloud
from ..ops.loam_features import corner_mask
from .projection import OrderedScan


class FeatureConfig(NamedTuple):
    corner_threshold: float = 1.0
    planar_threshold: float = 0.1
    max_corners_per_block: int = 20
    blocks_per_row: int = 6
    occlusion_depth_jump: float = 0.3
    occlusion_col_diff: int = 10
    parallel_ratio: float = 0.02
    corner_capacity: int = 2048
    planar_capacity: int = 16384


def compute_roughness(scan: OrderedScan) -> torch.Tensor:
    """10-neighbour second difference squared over the packed sequence."""
    d = torch.where(scan.mask, scan.depth, 0.0)
    acc = -10.0 * d
    for k in range(1, 6):
        acc = acc + torch.roll(d, k) + torch.roll(d, -k)
    return acc * acc


def mark_valid(scan: OrderedScan, cfg: FeatureConfig) -> torch.Tensor:
    """Occlusion + parallel-beam invalidation."""
    d = scan.depth
    col = scan.col

    d_next = torch.roll(d, -1)
    near_cols = torch.abs(torch.roll(col, -1) - col) < cfg.occlusion_col_diff

    # occlusion: d[i] - d[i+1] > jump masks i-5..i; d[i+1] - d[i] > jump
    # masks i+1..i+6
    occ_a = near_cols & (d - d_next > cfg.occlusion_depth_jump) & scan.mask
    occ_b = near_cols & (d_next - d > cfg.occlusion_depth_jump) & scan.mask
    kill = torch.zeros_like(scan.mask)
    for k in range(0, 6):
        kill = kill | torch.roll(occ_a, -k)
    for k in range(1, 7):
        kill = kill | torch.roll(occ_b, k)
    # parallel beams: both side differences exceed 2 % of the depth
    diff1 = torch.abs(torch.roll(d, 1) - d)
    diff2 = torch.abs(torch.roll(d, -1) - d)
    parallel = (diff1 > cfg.parallel_ratio * d) & (diff2 > cfg.parallel_ratio * d)
    return scan.mask & ~kill & ~parallel


def corner_mask_plain(scan: OrderedScan, cfg: FeatureConfig) -> torch.Tensor:
    """The corner mask bool [N] of the packed scan: roughness, the valid
    marks, the row guard, the block lattice and the greedy picks, scattered
    back to packed indices and ANDed with the scan's mask. The plain
    version of csrc/loam_features.cu's kernel (`ops/loam_features.py::
    corner_mask` takes it for CPU tensors)."""
    n = scan.depth.shape[0]
    r_rows = scan.row_start.shape[0]
    nb = cfg.blocks_per_row
    dev = scan.depth.device
    i32 = dict(dtype=torch.int32, device=dev)

    rough = compute_roughness(scan)
    valid = mark_valid(scan, cfg)

    # row edge guard: the first 5 / last 6 packed points of a row are not usable
    idx = torch.arange(n, **i32)
    row = scan.row.to(torch.int64)
    valid = valid & (idx >= scan.row_start[row] + 5) & (idx < scan.row_end[row] - 6)

    # block lattice: block b of row r spans [start + b*len6, start + (b+1)*len6)
    len6 = torch.div(scan.row_end - scan.row_start - 11, nb, rounding_mode="floor")
    base = scan.row_start + 5
    block_row = torch.arange(r_rows, device=dev).repeat_interleave(nb)
    block_i = torch.arange(nb, **i32).repeat(r_rows)
    b_start = base[block_row] + block_i * len6[block_row]
    b_len = len6[block_row]

    l_max = max(int(n // (r_rows * nb)) + 2, 8)
    offs = torch.arange(l_max, **i32)
    gidx = b_start[:, None] + offs[None, :]  # [B, L] packed indices
    in_block = (offs[None, :] < b_len[:, None]) & (gidx < n)
    gidx_safe = torch.clamp(gidx, 0, n - 1).to(torch.int64)

    b_rough = torch.where(in_block, rough[gidx_safe], -1.0)
    pickable = in_block & valid[gidx_safe]

    # corner picks: 20 sequential masked argmax picks, all blocks at once
    # (torch.argmax returns the first maximum, as jnp.argmax does)
    corners = torch.zeros_like(pickable)
    for _ in range(cfg.max_corners_per_block):
        score = torch.where(pickable, b_rough, -1.0)
        p = torch.argmax(score, dim=1)  # [B]
        ok = torch.gather(score, 1, p[:, None])[:, 0] > cfg.corner_threshold
        corners = corners | ((offs[None, :] == p[:, None]) & ok[:, None])
        # suppress the pick's +-5 neighbourhood
        pickable = pickable & ~((torch.abs(offs[None, :] - p[:, None]) <= 5) & ok[:, None])

    # back to packed indices: only the picks are scattered (every write is
    # True, so repeated indices cannot race); the rest go to a spare slot
    corner_mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    corner_mask[torch.where(corners, gidx_safe, n)] = True
    return corner_mask[:n] & scan.mask


def extract_features(scan: OrderedScan, cfg: FeatureConfig):
    """Returns (corner Cloud, planar Cloud)."""
    corners = corner_mask(scan, cfg)
    planar_mask = scan.mask & ~corners
    return (_compact(scan.points, corners, cfg.corner_capacity),
            _compact(scan.points, planar_mask, cfg.planar_capacity))


def _compact(points: torch.Tensor, mask: torch.Tensor, capacity: int) -> Cloud:
    """Pack masked points to the front of a buffer of at most `capacity`
    rows, in their packed order (stable)."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:capacity]
    msk = mask[order]
    return Cloud(torch.where(msk[:, None], points[order], 0.0), msk)
