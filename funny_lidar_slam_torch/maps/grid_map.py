"""Dense modulo-addressed grid map (port of maps/grid_map.py).

Layout: a fixed (Dx, Dy, Dz) grid of 2x2x2-voxel blocks, slot =
((bx mod Dx)*Dy + (by mod Dy))*Dz + (bz mod Dz). Rows use the block plane
layout [x(8S) | y(8S) | z(8S)] (maps/block_map.py), so `gather_cover`
output feeds `ops.select.fused_select` directly.

Aliasing (the modulo wrap): blocks whose coords differ by a multiple of the
grid dims share a slot; the newest writer re-claims it. Stale points that
survive in an aliased slot are at least dims*2*voxel away from any query,
far past every correspondence gate.

Port notes: every JAX `mode="drop"` scatter is made explicit. Dropped slot
updates go to one spare row past the end of an extended copy (bc, age,
counts), tab rows are wiped by writing `_MISS` into the always-`_MISS` row
S instead of dropping, and point values go to one spare element past the
flat table. `insert` is functional: it returns new tensors and leaves the
input map untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .block_map import _COVER, _MISS, _center_policy, _group_block_major
from .voxel_hash import _nonzero_padded, _with_spare_row

_EMPTY = -(2**30)  # owner coord sentinel for unclaimed slots
_WIPE_BOUND = 4096  # eviction wipes at most this many slots per insert


class GridMap(NamedTuple):
    """Dense grid state. `bc` keeps the (Dx, Dy, Dz) shape so the grid dims
    are static-by-shape."""

    bc: torch.Tensor  # [Dx, Dy, Dz, 3] int32 owner block coord (EMPTY = unclaimed)
    counts: torch.Tensor  # [S, 8] int32 per-voxel occupancy
    tab: torch.Tensor  # [S + 1, 3*8*bucket] plane rows; row S = _MISS
    age: torch.Tensor  # [S] int32 epoch of last touch
    epoch: torch.Tensor  # [] int32

    @property
    def dims(self) -> tuple:
        return tuple(self.bc.shape[:3])

    @property
    def num_slots(self) -> int:
        d = self.bc.shape
        return d[0] * d[1] * d[2]

    @property
    def bucket_size(self) -> int:
        return self.tab.shape[1] // 24

    @property
    def plane(self) -> int:
        return self.tab.shape[1] // 3


def create(dims: tuple, bucket_size: int, dtype=torch.float32, device="cpu") -> GridMap:
    s = dims[0] * dims[1] * dims[2]
    row = 3 * 8 * bucket_size
    i32 = dict(dtype=torch.int32, device=device)
    return GridMap(
        bc=torch.full(tuple(dims) + (3,), _EMPTY, **i32),
        counts=torch.zeros((s, 8), **i32),
        tab=torch.full((s + 1, row), _MISS, dtype=dtype, device=device),
        age=torch.zeros(s, **i32),
        epoch=torch.zeros((), **i32),
    )


def slot_of(bc: torch.Tensor, dims: tuple) -> torch.Tensor:
    """Block coords [..., 3] -> int64 slot [...] by per-axis modulo (exact
    for negatives: torch.remainder takes the sign of the divisor)."""
    bc = bc.to(torch.int64)
    mx = torch.remainder(bc[..., 0], dims[0])
    my = torch.remainder(bc[..., 1], dims[1])
    mz = torch.remainder(bc[..., 2], dims[2])
    return (mx * dims[1] + my) * dims[2] + mz


def insert(m: GridMap, points: torch.Tensor, mask: torch.Tensor, inv_voxel_size,
           max_age: int = 0, center_policy: bool = False) -> GridMap:
    """Scatter-insert a padded point batch. The slot of each block is modulo
    arithmetic; a slot owned by a DIFFERENT block coord is re-claimed by the
    newest writer (counts reset, stale rows wiped). `max_age > 0`: slots
    untouched for more than max_age epochs are evicted and their rows wiped,
    at most `_WIPE_BOUND` slots per insert (the rest stay expired and are
    wiped by later inserts). `center_policy`: the iVox rule, which drops a
    point whose voxel already holds a point closer to the voxel center."""
    n = points.shape[0]
    dims = m.dims
    s_cap = m.num_slots
    s = m.bucket_size
    plane = m.plane
    row_w = 3 * plane
    dev = points.device

    bc_flat = m.bc.reshape(-1, 3)
    counts = m.counts
    # flat table plus one spare element that absorbs dropped point writes
    tab_flat = torch.empty((s_cap + 1) * row_w + 1, dtype=m.tab.dtype, device=dev)
    tab_flat[:-1].copy_(m.tab.reshape(-1))
    tab = tab_flat[:-1].view(s_cap + 1, row_w)

    epoch = m.epoch + 1
    if max_age > 0:
        expired = (bc_flat[:, 0] != _EMPTY) & ((epoch - m.age) > max_age)
        wiped = expired & (torch.cumsum(expired, 0) <= _WIPE_BOUND)
        tab.index_fill_(0, _nonzero_padded(wiped, _WIPE_BOUND, s_cap), _MISS)
        bc_flat = torch.where(wiped[:, None], torch.full_like(bc_flat, _EMPTY), bc_flat)
        counts = torch.where(wiped[:, None], torch.zeros_like(counts), counts)

    g = _group_block_major(points, mask, inv_voxel_size)

    rep_idx = _nonzero_padded(g.blk_is_rep, n, n - 1)
    rep_bc = (g.sorted_coords >> 1)[rep_idx]  # [n, 3]
    rep_valid = torch.arange(n, device=dev) < g.num_blocks

    rep_slot = slot_of(rep_bc, dims)  # [n]
    same = torch.all(bc_flat[rep_slot] == rep_bc, dim=-1)
    fresh = rep_valid & ~same  # empty OR aliased: re-claim
    spare = torch.full_like(rep_slot, s_cap)

    tgt = torch.where(rep_valid, rep_slot, spare)
    bc_new = _with_spare_row(bc_flat)
    bc_new[tgt] = rep_bc
    age_new = _with_spare_row(m.age)
    age_new[tgt] = epoch
    fresh_tgt = torch.where(fresh, rep_slot, spare)
    tab.index_fill_(0, fresh_tgt, _MISS)  # row S is _MISS already
    counts_base = _with_spare_row(counts)
    counts_base[fresh_tgt] = 0
    counts_base = counts_base[:s_cap]

    # per-point slot + in-bucket position
    pt_slot = rep_slot[g.blk_id]
    local = g.local.to(torch.int64)
    base_cnt = counts_base[pt_slot, local].to(torch.int64)
    pos = base_cnt + g.vox_rank
    pt_ok = g.sorted_mask & (pos < s)

    if center_policy:
        pt_ok, pos = _center_policy(g, tab[pt_slot], fresh[g.blk_id], pt_ok, base_cnt,
                                    inv_voxel_size, plane, s)

    lane0 = local * s + pos
    base_idx = pt_slot * row_w + lane0
    drop = torch.full_like(base_idx, (s_cap + 1) * row_w)
    idx3 = torch.cat([torch.where(pt_ok, base_idx + k * plane, drop) for k in range(3)])
    val3 = torch.cat([g.sorted_pts[:, k] for k in range(3)])
    tab_flat[idx3] = val3

    seg = torch.where(pt_ok, pt_slot * 8 + local,
                      torch.full_like(pt_slot, s_cap * 8))
    ins = torch.zeros(s_cap * 8 + 1, dtype=torch.int32, device=dev)
    ins.index_add_(0, seg, pt_ok.to(torch.int32))
    counts_new = torch.clamp(counts_base + ins[: s_cap * 8].view(s_cap, 8), max=s)

    return GridMap(bc_new[:s_cap].reshape(m.bc.shape), counts_new, tab,
                   age_new[:s_cap], epoch)


def gather_cover(m: GridMap, uniq_coords: torch.Tensor) -> torch.Tensor:
    """8-block stencil cover rows per unique query voxel, one data-row
    gather: [G, 3] -> [G, 8*row]. Empty slots return _MISS rows."""
    b0 = (uniq_coords - 1) >> 1
    boffs = torch.tensor(_COVER, dtype=b0.dtype, device=b0.device)
    bc = b0[:, None, :] + boffs[None, :, :]  # [G, 8, 3]
    rows = m.tab[slot_of(bc, m.dims)]  # [G, 8, row]
    return rows.reshape(uniq_coords.shape[0], -1)


def build(dims: tuple, bucket_size: int, points, mask, inv_voxel_size,
          dtype=torch.float32) -> GridMap:
    return insert(create(dims, bucket_size, dtype, points.device), points, mask,
                  inv_voxel_size)


def num_occupied(m: GridMap) -> torch.Tensor:
    """Occupied voxels of the grid."""
    return (m.counts > 0).sum(dtype=torch.int32)


def stored_block_coords(m: GridMap):
    """Owner block coords of every slot [S, 3] and which slots are claimed
    (a test helper)."""
    flat = m.bc.reshape(-1, 3)
    return flat, flat[:, 0] != _EMPTY
