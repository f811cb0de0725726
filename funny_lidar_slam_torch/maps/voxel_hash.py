"""Voxel-hash point map (port of maps/voxel_hash.py): an open-addressing
table of `capacity` slots (power of two), each slot owning one voxel's
bucket of up to `bucket_size` points, probed linearly by a 32-bit voxel
fingerprint. The hashed block map (`block_map.py`) and the NDT map build
on its probing helpers.

`insert` sorts the batch by voxel, takes one representative per voxel,
matches it against the probe window (`fpwin[base]`, one [W] row per
lookup) and lets new voxels claim the first empty slot of their window in
scatter-min rounds; points land at bucket position `count + rank`, and
overflow beyond the bucket is dropped. `max_age` purges slots untouched for
more than max_age epochs; `center_policy` is the iVox selective-insert
rule. `query_knn` probes the stencil voxels around each query and takes the
k smallest distances among their buckets, per query or once per unique
query voxel (`group_capacity`).

Port notes: fingerprints are uint32 bit patterns held in int64 (0 = empty
slot), bit for bit the JAX package's; `jnp.nonzero(size=...)` is the
sync-free `_nonzero_padded`; the JAX `argmax` over bools is `_first_true`;
every `mode="drop"` write goes to a spare row that is sliced off; the
segment sum is `index_add_`; the voxel sort is stable (ops/voxel.py).
`insert` is functional: it returns new tensors and leaves the input map
untouched. `jax.lax.top_k` and `torch.topk` may order tied candidates
differently; `argmin` takes the first minimum in both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.voxel import fmix32, group_by_voxel, spatial_hash, u32, u32_mul, voxel_coords

# Stencil offsets of the reference's NearbyType: CENTER, NEARBY6, NEARBY18,
# NEARBY26.
_CENTER = [(0, 0, 0)]
_N6 = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]
_N18 = _N6 + [
    (1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
    (1, 0, 1), (-1, 0, 1), (1, 0, -1), (-1, 0, -1),
    (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1),
]
_N26 = _N18 + [
    (1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1),
    (-1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1),
]
STENCILS = {
    "center": _CENTER,
    "nearby6": _CENTER + _N6,
    "nearby18": _CENTER + _N18,
    "nearby26": _CENTER + _N26,
}

# second independent hash for the per-slot fingerprint (0 = empty slot)
_F1, _F2, _F3 = 2654435761, 805459861, 3674653429

# probe-window width: probing reads one [W] row of `fpwin` per lookup;
# callers may raise num_probes up to W without a layout change
PROBE_WINDOW = 16


def fingerprint(coords: torch.Tensor) -> torch.Tensor:
    """Nonzero 32-bit fingerprint of int coords [..., 3], as int64: the
    multiply-add combine passed through fmix32, with the low bit set."""
    c = u32(coords)
    h = (u32_mul(c[..., 0], _F1) + u32_mul(c[..., 1], _F2) + u32_mul(c[..., 2], _F3)) & 0xFFFFFFFF
    return fmix32(h) | 1


def _window(arr: torch.Tensor, width: int = PROBE_WINDOW) -> torch.Tensor:
    """[C] -> [C, W] with out[i, j] = arr[(i + j) mod C], as one gather."""
    c = arr.shape[0]
    idx = (torch.arange(c, device=arr.device)[:, None]
           + torch.arange(width, device=arr.device)[None, :]) % c
    return arr[idx]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (`jnp.argmax` on a bool array)."""
    w = mask.shape[-1]
    first = torch.where(mask, torch.arange(w, device=mask.device), w).amin(-1)
    return torch.where(first < w, first, 0)


def _take(slots: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(slots, -1, idx[..., None])[..., 0]


def _nonzero_padded(flag: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """`jnp.nonzero(flag, size=size, fill_value=fill)[0]` without a host sync:
    the indices of the first `size` true entries, padded with `fill`."""
    n = flag.shape[0]
    rank = torch.cumsum(flag, 0) - 1
    tgt = torch.where(flag & (rank < size), rank, torch.full_like(rank, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=flag.device)
    out.scatter_(0, tgt, torch.arange(n, device=flag.device))
    out[size] = fill
    return out[:size]


def _with_spare_row(x: torch.Tensor) -> torch.Tensor:
    """Copy of x with one extra trailing row that absorbs dropped writes."""
    return torch.cat([x, torch.zeros_like(x[:1])])


class VoxelHashMap(NamedTuple):
    """Voxel-hash map state."""

    fp: torch.Tensor  # [C] int64 voxel fingerprint (uint32 bits, 0 = empty)
    fpwin: torch.Tensor  # [C, W] int64 probe-window view: fpwin[i, j] = fp[(i+j)%C]
    count: torch.Tensor  # [C] int32 valid points in bucket (<= S)
    points: torch.Tensor  # [C, S, 3] bucket points (world frame)
    age: torch.Tensor  # [C] int32 epoch of last touch
    epoch: torch.Tensor  # [] int32 current epoch (bumped per insert)

    @property
    def capacity(self) -> int:
        return self.fp.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.points.shape[1]

    @property
    def occupied(self) -> torch.Tensor:
        return self.fp != 0


def create(capacity: int, bucket_size: int, dtype=torch.float32, device="cpu") -> VoxelHashMap:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of 2"
    i32 = dict(dtype=torch.int32, device=device)
    return VoxelHashMap(
        fp=torch.zeros(capacity, dtype=torch.int64, device=device),
        fpwin=torch.zeros((capacity, PROBE_WINDOW), dtype=torch.int64, device=device),
        count=torch.zeros(capacity, **i32),
        points=torch.zeros((capacity, bucket_size, 3), dtype=dtype, device=device),
        age=torch.zeros(capacity, **i32),
        epoch=torch.zeros((), **i32),
    )


def _probe_slots(m: VoxelHashMap, coords: torch.Tensor, num_probes: int):
    """Linear fingerprint probing of voxel coords [..., 3]: ([..., P]
    candidate slots, [..., P] key-match mask, [..., P] empty mask)."""
    assert num_probes <= PROBE_WINDOW, "num_probes exceeds the fpwin width"
    base = spatial_hash(coords, m.capacity)
    fp = fingerprint(coords)
    offs = torch.arange(num_probes, device=coords.device)
    slots = (base[..., None] + offs) & (m.capacity - 1)
    slot_fp = m.fpwin[base][..., :num_probes]  # one [W] row per lookup
    return slots, slot_fp == fp[..., None], slot_fp == 0


def find_slots(m: VoxelHashMap, coords: torch.Tensor, num_probes: int = 8) -> torch.Tensor:
    """int64 slot of each voxel coord, or -1. [..., 3] -> [...]."""
    slots, match, _ = _probe_slots(m, coords, num_probes)
    return torch.where(match.any(-1), _take(slots, _first_true(match)), -1)


def insert(m: VoxelHashMap, points: torch.Tensor, mask: torch.Tensor, inv_voxel_size,
           num_probes: int = 8, max_age: int = 0, center_policy: bool = False) -> VoxelHashMap:
    """Scatter-insert a padded point batch.

    `max_age > 0`: slots untouched for more than max_age epochs are purged
    up front (fp and count zeroed), so expired voxels neither match nor
    block claims. `center_policy`: the iVox rule, which drops a point whose
    voxel already holds a point closer to the voxel center (per batch: the
    bucket as it stood before this insert). New voxels claim the first
    empty slot of their window in min(3, num_probes) scatter-min rounds."""
    n = points.shape[0]
    cap = m.capacity
    s = m.bucket_size
    dev = points.device

    epoch = m.epoch + 1
    fp, fpwin, count = m.fp, m.fpwin, m.count
    if max_age > 0:
        expired = (fp != 0) & ((epoch - m.age) > max_age)
        fp = torch.where(expired, 0, fp)
        fpwin = _window(fp)
        count = torch.where(expired, 0, count)
    g = group_by_voxel(points, mask, inv_voxel_size)

    # one representative (first point) per voxel group
    rep_idx = _nonzero_padded((g.rank == 0) & g.sorted_mask, n, n - 1)
    rep_coords = g.group_coords[rep_idx]  # [n, 3] (garbage beyond num_groups)
    rep_valid = torch.arange(n, device=dev) < g.num_groups

    slots, match, empty = _probe_slots(m._replace(fpwin=fpwin), rep_coords, num_probes)
    has_match = match.any(-1)
    assigned = torch.where(has_match, _take(slots, _first_true(match)), -1)

    # first-empty claim rounds: the lowest group id wins a contended slot,
    # losers move on to their next empty slot
    need = rep_valid & ~has_match
    group_ids = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(min(3, num_probes)):
        cand = _take(slots, _first_true(empty))
        cand_ok = need & empty.any(-1)
        tgt = torch.where(cand_ok, cand, cap)
        claim = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, tgt, group_ids, "amin", include_self=True)
        won = cand_ok & (claim[cand] == group_ids)
        assigned = torch.where(won, cand, assigned)
        need = need & ~won
        taken = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        taken[torch.where(won, cand, cap)] = True
        empty = empty & ~taken[slots]

    # slot metadata of the winners; fresh slots restart their bucket
    fresh = (assigned >= 0) & ~has_match & rep_valid
    tgt = torch.where((assigned >= 0) & rep_valid, assigned, cap)
    fp_new = _with_spare_row(fp)
    fp_new[tgt] = fingerprint(rep_coords)
    fp_new = fp_new[:cap]
    age_new = _with_spare_row(m.age)
    age_new[tgt] = epoch
    count_base = _with_spare_row(count)
    count_base[torch.where(fresh, assigned, cap)] = 0
    count_base = count_base[:cap]

    # per-point slot and bucket position = count + rank
    pt_slot = assigned[g.group_id]  # [n]
    slot_safe = pt_slot.clamp(min=0)
    base_cnt = count_base[slot_safe].to(torch.int64)
    pos = base_cnt + g.rank
    pt_ok = g.sorted_mask & (pt_slot >= 0) & (pos < s)

    if center_policy:
        centers = (g.group_coords.to(points.dtype) + 0.5) / inv_voxel_size
        d_new = torch.linalg.vector_norm(g.sorted_pts - centers, dim=-1)
        bvalid = torch.arange(s, device=dev)[None, :] < base_cnt[:, None]
        d_old = torch.linalg.vector_norm(m.points[slot_safe] - centers[:, None, :], dim=-1)
        d_old = torch.where(bvalid, d_old, float("inf"))
        closer_exists = d_old.amin(-1) <= d_new
        pt_ok = pt_ok & (fresh[g.group_id] | ~closer_exists)
        # re-rank the survivors within each voxel run: an exclusive prefix
        # sum re-based at each run start
        keep = pt_ok.to(torch.int64)
        ex = torch.cumsum(keep, 0) - keep
        seg_start = torch.arange(n, device=dev) - g.rank
        pos = base_cnt + ex - ex[seg_start]
        pt_ok = pt_ok & (pos < s)

    flat_idx = torch.where(pt_ok, slot_safe * s + pos, cap * s)
    points_flat = _with_spare_row(m.points.reshape(cap * s, 3))
    points_flat[flat_idx] = torch.where(pt_ok[:, None], g.sorted_pts, 0.0)
    points_new = points_flat[:cap * s].view(cap, s, 3)

    # new counts: old + inserted per slot
    ins = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    ins.index_add_(0, torch.where(pt_ok, pt_slot, cap), pt_ok.to(torch.int32))
    count_new = torch.clamp(count_base + ins[:cap], max=s)
    return VoxelHashMap(fp_new, _window(fp_new), count_new, points_new, age_new[:cap], epoch)


def build(capacity: int, bucket_size: int, points: torch.Tensor, mask: torch.Tensor,
          inv_voxel_size, num_probes: int = 8) -> VoxelHashMap:
    """Fresh map from a padded cloud (the kd-tree rebuild's counterpart)."""
    m = create(capacity, bucket_size, points.dtype, points.device)
    return insert(m, points, mask, inv_voxel_size, num_probes=num_probes)


def _knn(cand_pts: torch.Tensor, d2: torch.Tensor, k: int):
    """The k smallest of d2 [N, M] with their points [N, M, 3]: (nbrs
    [N,k,3], d2 [N,k]). k = 1 takes the first minimum."""
    if k == 1:
        idx = torch.argmin(d2, dim=1, keepdim=True)
        knn_d2 = torch.gather(d2, 1, idx)
    else:
        knn_d2, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return torch.gather(cand_pts, 1, idx[..., None].expand(-1, -1, 3)), knn_d2


def _stencil_buckets(m: VoxelHashMap, vox: torch.Tensor, offsets: torch.Tensor,
                     num_probes: int):
    """Bucket points and validity of the stencil voxels around each voxel
    of vox [G, 3]: ([G, V*S, 3], [G, V*S])."""
    g, v, s = vox.shape[0], offsets.shape[0], m.bucket_size
    slot = find_slots(m, vox[:, None, :] + offsets[None, :, :], num_probes)  # [G, V]
    slot_safe = slot.clamp(min=0)
    bcnt = torch.where(slot >= 0, m.count[slot_safe], 0)
    valid = torch.arange(s, device=vox.device)[None, None, :] < bcnt[:, :, None]
    return m.points[slot_safe].reshape(g, v * s, 3), valid.reshape(g, v * s)


def query_knn(m: VoxelHashMap, queries: torch.Tensor, inv_voxel_size, k: int = 5,
              stencil: str = "nearby18", num_probes: int = 8,
              group_capacity: int | None = None):
    """Batched k-nearest neighbours by stencil gather + top-k (the iVox
    GetClosestPoint): probe the stencil voxels around each query's voxel,
    gather their buckets, take the k smallest distances.

    By default per query; `group_capacity` runs the stencil lookup once per
    unique query voxel instead, and queries of voxels past the capacity
    report no neighbours. Returns (neighbors [N,k,3], sq_dists [N,k],
    valid [N,k])."""
    n = queries.shape[0]
    dev = queries.device
    offsets = torch.tensor(STENCILS[stencil], dtype=torch.int32, device=dev)  # [V, 3]

    if group_capacity is None:
        cand_pts, cand_valid = _stencil_buckets(m, voxel_coords(queries, inv_voxel_size),
                                                offsets, num_probes)
        d2 = torch.sum((cand_pts - queries[:, None, :]) ** 2, dim=-1)
        d2 = torch.where(cand_valid, d2, float("inf"))
        nbrs, knn_d2 = _knn(cand_pts, d2, k)
        return nbrs, knn_d2, torch.isfinite(knn_d2)

    gcap = group_capacity
    g = group_by_voxel(queries, torch.ones(n, dtype=torch.bool, device=dev), inv_voxel_size)
    # one representative voxel coord per group; row gcap absorbs the rest
    rep_tgt = torch.where((g.rank == 0) & (g.group_id < gcap), g.group_id,
                          torch.full_like(g.group_id, gcap))
    uniq = torch.zeros((gcap + 1, 3), dtype=torch.int32, device=dev)
    uniq[rep_tgt] = g.group_coords
    flat_pts, flat_valid = _stencil_buckets(m, uniq[:gcap], offsets, num_probes)

    # per-query candidate set: one row gather by the group id
    gid = torch.clamp(g.group_id, max=gcap - 1)
    cand_pts = flat_pts[gid]  # [N, V*S, 3]
    cand_valid = flat_valid[gid] & (g.group_id < gcap)[:, None]
    diff = cand_pts - g.sorted_pts[:, None, :]
    d2 = torch.where(cand_valid, torch.sum(diff * diff, dim=-1), float("inf"))
    nbrs, knn_d2 = _knn(cand_pts, d2, k)

    # scatter back to the original query order
    nbrs_out = torch.zeros((n, k, 3), dtype=queries.dtype, device=dev)
    nbrs_out[g.order] = nbrs
    d2_out = torch.full((n, k), float("inf"), dtype=knn_d2.dtype, device=dev)
    d2_out[g.order] = knn_d2
    return nbrs_out, d2_out, torch.isfinite(d2_out)


def num_occupied(m: VoxelHashMap) -> torch.Tensor:
    return m.occupied.sum(dtype=torch.int32)


def load_factor(m: VoxelHashMap) -> torch.Tensor:
    """Occupied fraction of the table. Above ~0.6, linear probing with the
    default num_probes=8 starts dropping inserts: size `capacity` so the
    steady-state map stays below that, or raise num_probes (<= PROBE_WINDOW)."""
    return num_occupied(m) / m.capacity
