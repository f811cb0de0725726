"""Port parity: maps/grid_map.py of funny_lidar_slam_torch against the JAX
package's dense grid map. Both sides run the same insert sequences from the
same NumPy inputs; slot bookkeeping (owner coords, counts, ages, epoch) must
be identical and each (slot, voxel) bucket must hold the same set of
points (exact: inserts copy coordinates, they do no arithmetic on them)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funny_lidar_slam_tpu.maps import grid_map as jgrid
from funny_lidar_slam_torch.maps import grid_map as tgrid

torch.set_num_threads(1)

DIMS = (32, 32, 8)  # 64 x 64 x 16 m at 1 m voxels


def scene(n, seed, lo=0.0, hi=30.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pts[:, 2] *= 10.0 / (hi - lo)
    return pts


def padded(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    msk = np.zeros(cap, bool)
    out[: len(pts)] = pts[:cap]
    msk[: len(pts)] = True
    return out, msk


def assert_same_map(mt, mj):
    for f in ("bc", "counts", "age", "epoch"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)),
                                      err_msg=f)
    s, plane = mj.bucket_size, mj.plane
    tj, tt = np.asarray(mj.tab), mt.tab.numpy()
    assert tt.shape == tj.shape
    np.testing.assert_array_equal(tt[-1], tj[-1])  # the _MISS row
    cnt = np.asarray(mj.counts)
    for slot, loc in zip(*np.nonzero(cnt)):
        sets = []
        for tab in (tt, tj):
            lanes = loc * s + np.arange(cnt[slot, loc])
            pts = np.stack([tab[slot, a * plane + lanes] for a in range(3)], 1)
            sets.append(sorted(map(tuple, pts)))
        assert sets[0] == sets[1], (slot, loc)


def both_insert(mt, mj, pts, cap, max_age=0, center_policy=False, inv=1.0):
    p, m = padded(pts, cap)
    mj = jgrid.insert(mj, jnp.asarray(p), jnp.asarray(m), inv, max_age=max_age,
                      center_policy=center_policy)
    mt = tgrid.insert(mt, torch.as_tensor(p), torch.as_tensor(m), inv, max_age=max_age,
                      center_policy=center_policy)
    return mt, mj


def test_build_with_bucket_overflow():
    """Dense points (many voxels over the 8-point bucket) in one build."""
    pts = scene(6000, 0, 0.0, 12.0)
    mt, mj = both_insert(tgrid.create(DIMS, 8), jgrid.create(DIMS, 8), pts, 8192)
    assert int((np.asarray(mj.counts) == 8).sum()) > 10  # overflow happened
    assert_same_map(mt, mj)


def test_incremental_inserts_with_age_eviction():
    """A window sliding across the grid with max_age=2: re-touched slots keep
    their points, untouched ones are evicted and wiped."""
    mt, mj = tgrid.create(DIMS, 8), jgrid.create(DIMS, 8)
    for k in range(6):
        pts = scene(1500, 10 + k, 4.0 * k, 4.0 * k + 20.0)
        mt, mj = both_insert(mt, mj, pts, 2048, max_age=2)
        assert_same_map(mt, mj)


def test_bounded_eviction_wipe():
    """More than 4096 expired slots in one insert: only the first 4096 are
    wiped, the rest stay expired until a later insert (both sides)."""
    mt, mj = both_insert(tgrid.create(DIMS, 2), jgrid.create(DIMS, 2),
                         scene(40000, 1, 0.0, 64.0), 40960)
    assert int((np.asarray(mj.bc)[..., 0] != jgrid._EMPTY).sum()) > 4096
    far = np.array([[200.5, 200.5, 3.5]], np.float32)
    for _ in range(4):
        mt, mj = both_insert(mt, mj, far, 128, max_age=1)
        assert_same_map(mt, mj)


def test_aliased_block_is_reclaimed():
    """A block exactly dims*2 voxels away shares the slot; the newest writer
    re-claims it and the old rows are wiped."""
    a = np.array([[5.2, 5.3, 2.1], [5.7, 5.1, 2.9]], np.float32)
    b = a + np.array([[DIMS[0] * 2.0, 0, 0]], np.float32)
    mt, mj = both_insert(tgrid.create(DIMS, 8), jgrid.create(DIMS, 8), a, 128)
    mt, mj = both_insert(mt, mj, b, 128)
    assert_same_map(mt, mj)


@pytest.mark.parametrize("with_far", [False, True])
def test_gather_cover_matches_jax(with_far):
    pts = scene(3000, 3)
    mt, mj = both_insert(tgrid.create(DIMS, 8), jgrid.create(DIMS, 8), pts, 4096)
    rng = np.random.default_rng(4)
    q = np.floor(scene(300, 5)).astype(np.int32)
    if with_far:  # negative and aliased coordinates
        q = q + rng.integers(-200, 200, q.shape).astype(np.int32)
    wj = np.asarray(jgrid.gather_cover(mj, jnp.asarray(q)))
    wt = tgrid.gather_cover(mt, torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(wt, wj)


@pytest.mark.parametrize("max_age", [0, 2])
def test_center_policy_inserts_match_jax(max_age):
    """The iVox rule (PointToPlane_IVOX's opt-in grid layout): overlapping
    scans at the 0.5 m voxel, where a point enters an occupied voxel only if
    it is closer to the voxel center than the voxel's points. The same
    buckets, and some points were refused."""
    mt, mj = tgrid.create(DIMS, 8), jgrid.create(DIMS, 8)
    for k in range(5):
        pts = scene(3000, 20 + k, 2.0 * k, 2.0 * k + 12.0)
        mt, mj = both_insert(mt, mj, pts, 4096, max_age=max_age, center_policy=True, inv=2.0)
        assert_same_map(mt, mj)
    plain = jgrid.create(DIMS, 8)
    for k in range(5):
        p, m = padded(scene(3000, 20 + k, 2.0 * k, 2.0 * k + 12.0), 4096)
        plain = jgrid.insert(plain, jnp.asarray(p), jnp.asarray(m), 2.0, max_age=max_age)
    assert int(np.asarray(mj.counts).sum()) < int(np.asarray(plain.counts).sum())
