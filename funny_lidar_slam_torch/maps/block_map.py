"""Hashed block map (port of maps/block_map.py): the `IcpConfig` default
layout, and the block-layout helpers the dense grid (`grid_map.py`) shares.

Voxels are grouped into 2x2x2 BLOCKS; the 3x3x3 stencil around any query
voxel is covered by exactly 8 neighbouring blocks (`_COVER`). A block row
stores its 8 voxel buckets as flat coordinate planes
[x(8*S) | y(8*S) | z(8*S)]; empty positions hold `_MISS` (1e30), whose
squared distance is +inf in f32, so the select needs no validity mask.

Blocks live in an open-addressing table of Cb slots (power of two) with
linear fingerprint probing: `fpwin[base]` is one [W] row per lookup.
Insertion sorts the batch block-major, takes one representative per block,
matches it against the probe window, and claims the first empty slot for
new blocks in scatter-min rounds. Age-based eviction (`max_age`) purges
blocks untouched for more than max_age epochs.

Port notes: fingerprints are uint32 bit patterns held in int64 (0 =
empty); every JAX `mode="drop"` scatter writes to an explicit spare row
instead; `jnp.nonzero(size=...)` is the sync-free `_nonzero_padded`; the
sort is stable (ops/voxel.py). `insert` is functional: it returns new
tensors and leaves the input map untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import select
from ..ops.voxel import _INVALID_KEY, _first_of_run, group_by_voxel, spatial_hash, voxel_coords
from .voxel_hash import (
    PROBE_WINDOW,
    _first_true,
    _nonzero_padded,
    _take,
    _window,
    _with_spare_row,
    fingerprint,
)

_MISS = 1e30

# the 8 block offsets covering the 3x3x3 voxel stencil of any query voxel
_COVER = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


class BlockMap(NamedTuple):
    """Hashed block-map state. tab has Cb+1 rows: row Cb is the constant
    _MISS row that missed lookups gather."""

    fp: torch.Tensor  # [Cb] int64 block fingerprint (uint32 bits, 0 = empty)
    fpwin: torch.Tensor  # [Cb, W] int64 probe-window view
    counts: torch.Tensor  # [Cb, 8] int32 per-voxel occupancy (insert-only)
    tab: torch.Tensor  # [Cb+1, 3*8*S] f32 plane rows: x(8S) | y(8S) | z(8S)
    age: torch.Tensor  # [Cb] int32 epoch of last touch
    epoch: torch.Tensor  # [] int32

    @property
    def block_capacity(self) -> int:
        return self.fp.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.tab.shape[1] // 24

    @property
    def plane(self) -> int:
        """Lanes per coordinate plane in a row (= 8 voxels * S)."""
        return self.tab.shape[1] // 3

    @property
    def occupied(self) -> torch.Tensor:
        return self.fp != 0


def create(capacity: int, bucket_size: int, dtype=torch.float32, device="cpu") -> BlockMap:
    """`capacity` is the VOXEL capacity; the block table gets capacity//2
    slots (at least 16)."""
    assert capacity & (capacity - 1) == 0, "capacity must be a power of 2"
    cb = max(capacity // 2, 16)
    i32 = dict(dtype=torch.int32, device=device)
    return BlockMap(
        fp=torch.zeros(cb, dtype=torch.int64, device=device),
        fpwin=torch.zeros((cb, PROBE_WINDOW), dtype=torch.int64, device=device),
        counts=torch.zeros((cb, 8), **i32),
        tab=torch.full((cb + 1, 3 * 8 * bucket_size), _MISS, dtype=dtype, device=device),
        age=torch.zeros(cb, **i32),
        epoch=torch.zeros((), **i32),
    )


def _block_of(coords: torch.Tensor):
    """Voxel coords -> (block coords, local voxel index 0..7). Arithmetic
    >> floors negatives; & takes the true parity bit."""
    bc = coords >> 1
    lb = coords & 1
    local = (lb[..., 0] << 2) | (lb[..., 1] << 1) | lb[..., 2]
    return bc, local


def _probe_blocks(m: BlockMap, bcoords: torch.Tensor, num_probes: int):
    """Linear fingerprint probing: (slots, match, empty), each [..., P]."""
    assert num_probes <= PROBE_WINDOW
    cb = m.block_capacity
    base = spatial_hash(bcoords, cb)
    fp = fingerprint(bcoords)
    offs = torch.arange(num_probes, device=bcoords.device)
    slots = (base[..., None] + offs) & (cb - 1)
    slot_fp = m.fpwin[base][..., :num_probes]
    return slots, slot_fp == fp[..., None], slot_fp == 0


def find_block_slots(m: BlockMap, bcoords: torch.Tensor, num_probes: int = 8) -> torch.Tensor:
    """int64 slot of each block coord, or -1. [..., 3] -> [...]."""
    slots, match, _ = _probe_blocks(m, bcoords, num_probes)
    return torch.where(match.any(-1), _take(slots, _first_true(match)), -1)


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


def _center_policy(g, rows, fresh_pt, pt_ok, base_cnt, inv_voxel_size, plane: int, s: int):
    """The iVox rule of `insert` (block and grid maps): keep a point only if
    its voxel is fresh or it is closer to the voxel center than every point
    its bucket holds (`rows`, the point's slot row after the fresh-slot
    wipe). Returns (pt_ok, pos), the survivors re-ranked within each voxel
    run (an exclusive prefix sum re-based at each voxel start)."""
    centers = (g.sorted_coords.to(g.sorted_pts.dtype) + 0.5) / inv_voxel_size
    d_new = torch.linalg.vector_norm(g.sorted_pts - centers, dim=-1)
    local = g.local.to(torch.int64)
    own = (torch.arange(plane, device=rows.device)[None, :] // s) == local[:, None]
    d_old2 = sum((rows[:, a * plane:(a + 1) * plane] - centers[:, a:a + 1]) ** 2
                 for a in range(3))
    d_old2 = torch.where(own, d_old2, float("inf"))
    pt_ok = pt_ok & (fresh_pt | ~(d_old2.amin(-1) <= d_new * d_new))
    keep = pt_ok.to(torch.int64)
    ex = torch.cumsum(keep, 0) - keep
    pos = base_cnt + ex - ex[g.vox_start]
    return pt_ok & (pos < s), pos


def insert(m: BlockMap, points: torch.Tensor, mask: torch.Tensor, inv_voxel_size,
           num_probes: int = 8, max_age: int = 0, center_policy: bool = False,
           claim_rounds: int = 3) -> BlockMap:
    """Scatter-insert a padded point batch at block granularity.

    `max_age > 0`: blocks untouched for more than max_age epochs are purged
    up front (fp and counts zeroed; their rows are wiped when a block
    reclaims the slot). `center_policy`: the iVox rule, which drops a point
    whose voxel already holds a point closer to the voxel center.
    `claim_rounds` scatter-min rounds let new blocks claim the first empty
    slot of their probe window; losers move on to their next empty slot."""
    n = points.shape[0]
    cb = m.block_capacity
    s = m.bucket_size
    plane = m.plane
    row_w = 3 * plane
    dev = points.device

    epoch = m.epoch + 1
    fp, fpwin, counts = m.fp, m.fpwin, m.counts
    if max_age > 0:
        expired = (fp != 0) & ((epoch - m.age) > max_age)
        fp = torch.where(expired, 0, fp)
        fpwin = _window(fp)
        counts = torch.where(expired[:, None], 0, counts)
    probe_map = m._replace(fpwin=fpwin)

    g = _group_block_major(points, mask, inv_voxel_size)

    # one representative (first point) per block run
    rep_idx = _nonzero_padded(g.blk_is_rep, n, n - 1)
    rep_bc = (g.sorted_coords >> 1)[rep_idx]  # [n, 3]
    rep_valid = torch.arange(n, device=dev) < g.num_blocks

    slots, match, empty = _probe_blocks(probe_map, rep_bc, num_probes)
    has_match = match.any(-1)
    assigned = torch.where(has_match, _take(slots, _first_true(match)), -1)

    # first-empty claim rounds: the lowest group id wins a contended slot
    need = rep_valid & ~has_match
    group_ids = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(min(claim_rounds, num_probes)):
        cand = _take(slots, _first_true(empty))
        cand_ok = need & empty.any(-1)
        tgt = torch.where(cand_ok, cand, cb)
        claim = torch.full((cb + 1,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, tgt, group_ids, "amin", include_self=True)
        won = cand_ok & (claim[cand] == group_ids)
        assigned = torch.where(won, cand, assigned)
        need = need & ~won
        taken = torch.zeros(cb + 1, dtype=torch.bool, device=dev)
        taken[torch.where(won, cand, cb)] = True
        empty = empty & ~taken[slots]

    fresh = (assigned >= 0) & ~has_match & rep_valid
    upd = (assigned >= 0) & rep_valid
    tgt = torch.where(upd, assigned, cb)
    fp_new = _with_spare_row(fp)
    fp_new[tgt] = fingerprint(rep_bc)
    fp_new = fp_new[:cb]
    age_new = _with_spare_row(m.age)
    age_new[tgt] = epoch
    # fresh slots: wipe stale bucket data to _MISS (row Cb is _MISS already)
    # and zero the counts BEFORE scattering this batch's points into them
    tab_flat = torch.empty((cb + 1) * row_w + 1, dtype=m.tab.dtype, device=dev)
    tab_flat[:-1].copy_(m.tab.reshape(-1))
    tab = tab_flat[:-1].view(cb + 1, row_w)
    tab.index_fill_(0, torch.where(fresh, assigned, cb), _MISS)
    counts_base = _with_spare_row(counts)
    counts_base[torch.where(fresh, assigned, cb)] = 0
    counts_base = counts_base[:cb]

    # per-point slot + in-bucket position
    pt_slot = assigned[g.blk_id]  # [n] (block-rep claim result)
    slot_safe = pt_slot.clamp(min=0)
    local = g.local.to(torch.int64)
    base_cnt = counts_base[slot_safe, local].to(torch.int64)
    pos = base_cnt + g.vox_rank
    pt_ok = g.sorted_mask & (pt_slot >= 0) & (pos < s)

    if center_policy:
        rows = tab[torch.where(pt_slot >= 0, pt_slot, cb)]  # [n, row_w]
        pt_ok, pos = _center_policy(g, rows, fresh[g.blk_id], pt_ok, base_cnt,
                                    inv_voxel_size, plane, s)

    # scatter the three coordinate planes in one flat scatter; dropped
    # points go to the spare element past the table
    base_idx = slot_safe * row_w + local * s + pos
    drop = torch.full_like(base_idx, (cb + 1) * row_w)
    idx3 = torch.cat([torch.where(pt_ok, base_idx + k * plane, drop) for k in range(3)])
    tab_flat[idx3] = torch.cat([g.sorted_pts[:, k] for k in range(3)])

    # counts update per (slot, local voxel)
    seg = torch.where(pt_ok, slot_safe * 8 + local, torch.full_like(slot_safe, cb * 8))
    ins = torch.zeros(cb * 8 + 1, dtype=torch.int32, device=dev)
    ins.index_add_(0, seg, pt_ok.to(torch.int32))
    counts_new = torch.clamp(counts_base + ins[: cb * 8].view(cb, 8), max=s)

    return BlockMap(fp_new, _window(fp_new), counts_new, tab, age_new[:cb], epoch)


def build(capacity: int, bucket_size: int, points: torch.Tensor, mask: torch.Tensor,
          inv_voxel_size, num_probes: int = 8) -> BlockMap:
    """Fresh map from a padded cloud. A one-shot build puts the whole load
    in one batch, so it runs the full probe window of claim rounds."""
    m = create(capacity, bucket_size, points.dtype, points.device)
    return insert(m, points, mask, inv_voxel_size, num_probes=num_probes,
                  claim_rounds=num_probes)


def gather_cover(m: BlockMap, uniq_coords: torch.Tensor, num_probes: int = 8) -> torch.Tensor:
    """8-block stencil cover rows per unique query voxel: [G, 3] ->
    [G, 8*row], 8 probe rows + 8 data rows each. Missed blocks gather the
    constant _MISS row."""
    b0 = (uniq_coords - 1) >> 1
    boffs = torch.tensor(_COVER, dtype=b0.dtype, device=b0.device)
    bc = b0[:, None, :] + boffs[None, :, :]  # [G, 8, 3]
    slot = find_block_slots(m, bc, num_probes)  # [G, 8]
    rows = m.tab[torch.where(slot >= 0, slot, m.block_capacity)]  # [G, 8, row]
    return rows.reshape(uniq_coords.shape[0], -1)


def gather_cover_any(m, uniq_coords: torch.Tensor, num_probes: int = 8) -> torch.Tensor:
    """Cover gather dispatched by map type: the hashed BlockMap or the
    dense GridMap."""
    from . import grid_map

    if isinstance(m, BlockMap):
        return gather_cover(m, uniq_coords, num_probes)
    if isinstance(m, grid_map.GridMap):
        return grid_map.gather_cover(m, uniq_coords)
    raise TypeError(f"no cover gather for {type(m).__name__}: block and grid maps only")


def query_knn(m, queries: torch.Tensor, inv_voxel_size, k: int = 5,
              stencil: str = "nearby26", num_probes: int = 8,
              group_capacity: int | None = None):
    """Batched k-NN over the block cover, with the exact reference stencil.
    Returns (neighbors [N,k,3], sq_dists [N,k], valid [N,k])."""
    px, py, pz, d2, valid, _ = query_knn_planes(m, queries, inv_voxel_size, k, num_probes,
                                                group_capacity, stencil)
    return torch.stack([px, py, pz], dim=-1), d2, valid


def query_knn_planes(m, queries: torch.Tensor, inv_voxel_size, k: int, num_probes: int = 8,
                     group_capacity: int | None = None, stencil: str = "nearby26"):
    """Plane-layout k-NN: (px, py, pz [N,k], d2 [N,k], valid [N,k], order)
    in the ORIGINAL query order. One cover row per unique query voxel, up to
    `group_capacity` (default N) voxels; queries of later voxels report
    nothing. The select is `select.fused_select` (the CUDA kernel on the
    card, its plain version on the CPU)."""
    n = queries.shape[0]
    dev = queries.device
    gcap = group_capacity or n
    gcap = -(-gcap // select.TQ) * select.TQ

    g = group_by_voxel(queries, torch.ones(n, dtype=torch.bool, device=dev), inv_voxel_size)
    rep_tgt = torch.where((g.rank == 0) & (g.group_id < gcap), g.group_id,
                          torch.full_like(g.group_id, gcap))
    uniq = torch.zeros((gcap + 1, 3), dtype=torch.int32, device=dev)
    uniq[rep_tgt] = g.group_coords  # row gcap absorbs dropped writes
    wnd = gather_cover_any(m, uniq[:gcap], num_probes)  # [gcap, 8*row]

    gid = torch.clamp(g.group_id, max=gcap - 1).to(torch.int32)
    kd2, kx, ky, kz = select.fused_select(wnd, gid, g.sorted_pts.contiguous(), k, m.plane,
                                          stencil=stencil, qvox=g.group_coords)
    valid = (kd2 < 1e18) & (g.group_id < gcap)[:, None]  # sentinels square past 1e18
    kd2 = torch.where(valid, kd2, float("inf"))

    # scatter back to the original query order
    def unsort(v, fill):
        out = torch.full((n, k), fill, dtype=v.dtype, device=dev)
        out[g.order] = v
        return out

    px, py, pz = (unsort(torch.where(valid, v, 0.0), 0.0) for v in (kx, ky, kz))
    return px, py, pz, unsort(kd2, float("inf")), unsort(valid, False), g.order


def num_occupied(m: BlockMap) -> torch.Tensor:
    """Occupied VOXELS (count > 0)."""
    return (m.counts > 0).sum(dtype=torch.int32)


def num_blocks(m: BlockMap) -> torch.Tensor:
    return m.occupied.sum(dtype=torch.int32)


def load_factor(m: BlockMap) -> torch.Tensor:
    """Occupied fraction of the BLOCK table (the claim-contention metric)."""
    return num_blocks(m) / m.block_capacity
