"""Incremental NDT voxel map (port of maps/ndt_map.py): per-voxel Gaussian
statistics on the probing scheme of the voxel hash.

Each slot keeps running moment accumulators (count, mean, the sum of
centered outer products M2) and the cached regularized inverse covariance.
A batch insert sorts the points by voxel, takes the batch moments per voxel
in two passes (mean, then M2 about the batch mean) and merges them into the
slot by Chan's parallel update, so every term stays centered and accurate
in f32 far from the origin.

Conventions of the JAX package, kept: covariance is M2/(n-1); the
eigenvalue floor is Tikhonov regularization inv(sigma + max(1e-3 lam_max,
1e-6) I); one-point voxels get info = 1e2 I; capacity eviction is age
based (`max_age`).

Port notes: fingerprints are uint32 bit patterns held in int64 (0 = empty
slot); `jnp.nonzero(size=...)` is the sync-free `_nonzero_padded`; the
JAX `argmax` over bools is `_first_true`; every `mode="drop"` write goes to
a spare row `cap` that is sliced off; the segment sums are `index_add_`,
whose repeated-index adds run in no fixed order on the card. `insert` is
functional: it returns new tensors and leaves the input map untouched.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.lin3 import inv3, sym3_eigvalsh
from ..ops.voxel import group_by_voxel, spatial_hash, voxel_coords
from .voxel_hash import (
    PROBE_WINDOW,
    _first_true,
    _nonzero_padded,
    _take,
    _window,
    _with_spare_row,
    fingerprint,
)


class NdtMap(NamedTuple):
    fp: torch.Tensor  # [C] int64 voxel fingerprint (uint32 bits, 0 = empty slot)
    fpwin: torch.Tensor  # [C, W] int64 probe-window view
    count: torch.Tensor  # [C] points accumulated
    mean: torch.Tensor  # [C, 3]
    m2: torch.Tensor  # [C, 3, 3] sum of centered outer products
    info: torch.Tensor  # [C, 3, 3] cached inverse covariance
    estimated: torch.Tensor  # [C] bool (enough points for a Gaussian)
    age: torch.Tensor  # [C] int32 epoch of the last update
    epoch: torch.Tensor  # [] int32

    @property
    def capacity(self) -> int:
        return self.fp.shape[0]

    @property
    def occupied(self) -> torch.Tensor:
        return self.fp != 0


def create(capacity: int, dtype=torch.float32, device="cpu") -> NdtMap:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of 2"
    f = dict(dtype=dtype, device=device)
    return NdtMap(
        fp=torch.zeros(capacity, dtype=torch.int64, device=device),
        fpwin=torch.zeros((capacity, PROBE_WINDOW), dtype=torch.int64, device=device),
        count=torch.zeros(capacity, **f),
        mean=torch.zeros((capacity, 3), **f),
        m2=torch.zeros((capacity, 3, 3), **f),
        info=torch.zeros((capacity, 3, 3), **f),
        estimated=torch.zeros(capacity, dtype=torch.bool, device=device),
        age=torch.zeros(capacity, dtype=torch.int32, device=device),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )


def _probe(m: NdtMap, coords: torch.Tensor, num_probes: int):
    """Linear fingerprint probing: (slots, match, empty), each [..., P],
    from one row of the probe-window view per lookup."""
    assert num_probes <= PROBE_WINDOW
    base = spatial_hash(coords, m.capacity)
    fp = fingerprint(coords)
    offs = torch.arange(num_probes, device=coords.device)
    slots = (base[..., None] + offs) & (m.capacity - 1)
    slot_fp = m.fpwin[base][..., :num_probes]
    return slots, slot_fp == fp[..., None], slot_fp == 0


def _regularized_info(sigma: torch.Tensor, n: torch.Tensor, min_points: float):
    """(info, estimated): inv(sigma + max(1e-3 lam_max, 1e-6) I), or 1e2 I
    for a voxel of at most one point; estimated when n > min_points."""
    eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
    eps = torch.clamp(1e-3 * sym3_eigvalsh(sigma)[..., 2], min=1e-6)
    info = inv3(sigma + eps[..., None, None] * eye)
    info = torch.where((n <= 1.0)[..., None, None], 1.0e2 * eye, info)
    return info, n > min_points


def insert(m: NdtMap, points: torch.Tensor, mask: torch.Tensor, inv_voxel_size,
           num_probes: int = 8, max_age: int = 0, min_points: int = 5,
           max_points: int = 50, estimate_all=False, claim_rounds: int = 3) -> NdtMap:
    """Merge a padded point batch into the per-voxel Gaussian statistics.

    `estimate_all` (a bool or a bool tensor, so a caller switches it per
    scan without a host read) marks every touched voxel estimated whatever
    its count: the first scan and the frozen map of localization.
    `max_points` stops updating estimated voxels that hold more points.
    `max_age > 0` lets a new voxel claim a slot untouched for more than
    max_age epochs. `claim_rounds` scatter-min rounds let new voxels claim
    the first empty slot of their probe window."""
    epoch = m.epoch + 1
    cap = m.capacity
    n = points.shape[0]
    dtype, dev = points.dtype, points.device

    g = group_by_voxel(points, mask, inv_voxel_size)

    # batch moments per voxel group, two passes: the mean, then M2 about it
    seg = torch.where(g.sorted_mask, g.group_id, torch.full_like(g.group_id, n))
    w = g.sorted_mask.to(dtype)
    cnt = torch.zeros(n + 1, dtype=dtype, device=dev).index_add_(0, seg, w)[:n]
    s1 = torch.zeros((n + 1, 3), dtype=dtype, device=dev).index_add_(
        0, seg, g.sorted_pts * w[:, None])[:n]
    bmean = s1 / torch.clamp(cnt, min=1.0)[:, None]
    centered = (g.sorted_pts - bmean[torch.clamp(g.group_id, max=n - 1)]) * w[:, None]
    bm2 = torch.zeros((n + 1, 3, 3), dtype=dtype, device=dev).index_add_(
        0, seg, centered[:, :, None] * centered[:, None, :])[:n]

    idx = torch.arange(n, device=dev)
    rep_valid = (idx < g.num_groups) & (cnt > 0)
    rep_idx = _nonzero_padded((g.rank == 0) & g.sorted_mask, n, n - 1)
    rep_coords = g.group_coords[rep_idx]

    # slot lookup and claim (the block_map.insert scheme)
    slots, match, empty = _probe(m, rep_coords, num_probes)
    if max_age > 0:
        empty = empty | ((epoch - m.age[slots]) > max_age)
    has_match = match.any(-1)
    assigned = torch.where(has_match, _take(slots, _first_true(match)), -1)

    need = rep_valid & ~has_match
    group_ids = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(min(claim_rounds, num_probes)):
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

    fresh = (assigned >= 0) & ~has_match & rep_valid
    upd = (assigned >= 0) & rep_valid
    slot_safe = torch.clamp(assigned, min=0)

    # pooled accumulators; a fresh slot starts from zero
    zero = torch.zeros((), dtype=dtype, device=dev)
    old_n = torch.where(fresh, zero, m.count[slot_safe])
    old_mean = torch.where(fresh[:, None], zero, m.mean[slot_safe])
    old_m2 = torch.where(fresh[:, None, None], zero, m.m2[slot_safe])
    saturated = (old_n > max_points) & m.estimated[slot_safe] & ~fresh
    do_merge = upd & ~saturated

    # Chan's parallel merge
    tot = old_n + cnt
    safe_tot = torch.clamp(tot, min=1.0)
    delta = bmean - old_mean
    new_mean = old_mean + delta * (cnt / safe_tot)[:, None]
    new_m2 = old_m2 + bm2 + (old_n * cnt / safe_tot)[:, None, None] * (
        delta[:, :, None] * delta[:, None, :])

    sigma = new_m2 / torch.clamp(tot - 1.0, min=1.0)[:, None, None]
    info, est_cnt = _regularized_info(sigma, tot, float(min_points))
    estimated = est_cnt | (torch.as_tensor(estimate_all, device=dev) & (tot > 0))

    def put(arr, at, val):
        out = _with_spare_row(arr)
        out[at] = val.to(arr.dtype)
        return out[:cap]

    at_upd = torch.where(upd, assigned, cap)
    at_merge = torch.where(do_merge, assigned, cap)
    fp_new = put(m.fp, at_upd, fingerprint(rep_coords))
    return NdtMap(
        fp=fp_new, fpwin=_window(fp_new), count=put(m.count, at_merge, tot),
        mean=put(m.mean, at_merge, new_mean), m2=put(m.m2, at_merge, new_m2),
        info=put(m.info, at_merge, info), estimated=put(m.estimated, at_merge, estimated),
        age=put(m.age, at_upd, epoch.expand(n)), epoch=epoch)


# the 7-voxel stencil of the reference NDT: the voxel and its 6 face neighbours
NDT_STENCIL = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, -1), (0, 0, 1)]


@functools.lru_cache(maxsize=None)
def _stencil(device: torch.device) -> torch.Tensor:
    """NDT_STENCIL on `device`, copied there once (a copy from the host
    waits for the device's queue)."""
    return torch.tensor(NDT_STENCIL, dtype=torch.int32, device=device)


def _stencil_lookup(m: NdtMap, coords: torch.Tensor, num_probes: int):
    """(mean [..., 7, 3], info [..., 7, 3, 3], valid [..., 7]) of the
    stencil voxels around int32 voxel coords [..., 3]."""
    sten = _stencil(coords.device)
    slots, match, _ = _probe(m, coords[..., None, :] + sten, num_probes)
    found = match.any(-1)
    slot = torch.where(found, _take(slots, _first_true(match)), 0)
    return m.mean[slot], m.info[slot], found & m.estimated[slot]


def query_stencil(m: NdtMap, queries: torch.Tensor, inv_voxel_size, num_probes: int = 8,
                  group_capacity: int | None = None):
    """The 7-neighbourhood Gaussians of each query point: (mean [N,7,3],
    info [N,7,3,3], valid [N,7]).

    Direct per-point lookup by default; with `group_capacity`, one stencil
    lookup per unique query voxel (up to that many voxels; queries of later
    voxels report nothing), scattered back to the query order."""
    n = queries.shape[0]
    if group_capacity is None:
        return _stencil_lookup(m, voxel_coords(queries, inv_voxel_size), num_probes)

    gcap, dev = group_capacity, queries.device
    g = group_by_voxel(queries, torch.ones(n, dtype=torch.bool, device=dev), inv_voxel_size)
    rep_tgt = torch.where((g.rank == 0) & (g.group_id < gcap), g.group_id,
                          torch.full_like(g.group_id, gcap))
    uniq = torch.zeros((gcap + 1, 3), dtype=torch.int32, device=dev)
    uniq[rep_tgt] = g.group_coords  # row gcap absorbs dropped writes
    g_mean, g_info, g_valid = _stencil_lookup(m, uniq[:gcap], num_probes)

    gid = torch.clamp(g.group_id, max=gcap - 1)
    in_range = g.group_id < gcap
    mean = torch.zeros((n, 7, 3), dtype=queries.dtype, device=dev)
    info = torch.zeros((n, 7, 3, 3), dtype=queries.dtype, device=dev)
    valid = torch.zeros((n, 7), dtype=torch.bool, device=dev)
    mean[g.order] = g_mean[gid]
    info[g.order] = g_info[gid]
    valid[g.order] = g_valid[gid] & in_range[:, None]
    return mean, info, valid


def num_occupied(m: NdtMap) -> torch.Tensor:
    return m.occupied.sum(dtype=torch.int32)


def num_estimated(m: NdtMap) -> torch.Tensor:
    return (m.occupied & m.estimated).sum(dtype=torch.int32)
