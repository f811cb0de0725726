"""Port parity: maps/voxel_hash.py (the voxel-hash point map) and the
point-to-point residuals over it of funny_lidar_slam_torch against the JAX
package, on the same NumPy inputs (mirroring tests/test_maps.py).

Map state: fingerprints, probe windows, counts, ages and epoch identical;
each slot's bucket holds the same set of points where its count is below
the bucket size S, and a subset of that voxel's inputs where it is full
(which points survive an overflow depends on the sort order, and the port
sorts stably). Queries: valid counts equal, sorted d2 to 1e-6 (top-k may
order ties differently), and every returned point reproduces its d2.
Normal equations: h and g to 1e-4 of their largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core import lie as jlie
from funny_lidar_slam_tpu.maps import block_map as jbm
from funny_lidar_slam_tpu.maps import voxel_hash as jvh
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.maps import block_map as tbm
from funny_lidar_slam_torch.maps import voxel_hash as tvh
from funny_lidar_slam_torch.registration import residuals as tres

torch.set_num_threads(1)


def random_cloud(n, scale=10.0, seed=0, n_valid=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    mask = np.ones(n, dtype=bool)
    if n_valid is not None:
        mask[n_valid:] = False
        pts[n_valid:] = 1e6  # poison
    return pts, mask


def surface_scene(n=3000, seed=0, extent=16.0):
    """Walls and a floor: the structured occupancy of a LiDAR map."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, n)
    pts = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    pts[kinds == 0, 2] = 0.0
    pts[kinds == 1, 1] = np.round(pts[kinds == 1, 1] / 8.0) * 8.0
    pts[kinds == 2, 0] = np.round(pts[kinds == 2, 0] / 8.0) * 8.0
    return pts


def assert_same_map(mt, mj, inputs):
    """Bookkeeping exact; bucket sets exact below S, a subset of the inputs
    when full. `inputs` are all points inserted so far."""
    np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
    np.testing.assert_array_equal(mt.fpwin.numpy(), np.asarray(mj.fpwin).astype(np.int64))
    for f in ("count", "age", "epoch"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)),
                                      err_msg=f)
    s = mj.bucket_size
    pt, pj = mt.points.numpy(), np.asarray(mj.points)
    known = set(map(tuple, inputs))
    cnt = np.asarray(mj.count) * (np.asarray(mj.fp) != 0)
    for slot in np.nonzero(cnt)[0]:
        sets = [sorted(map(tuple, p[slot, :cnt[slot]])) for p in (pt, pj)]
        if cnt[slot] < s:
            assert sets[0] == sets[1], slot
        else:
            assert set(sets[0]) <= known, slot


def build_both(pts, mask, capacity, bucket, **kw):
    mj = jvh.build(capacity, bucket, jnp.asarray(pts), jnp.asarray(mask), 1.0, **kw)
    mt = tvh.build(capacity, bucket, torch.as_tensor(pts), torch.as_tensor(mask), 1.0, **kw)
    return mt, mj


def insert_both(mt, mj, pts, mask, **kw):
    mj = jvh.insert(mj, jnp.asarray(pts), jnp.asarray(mask), 1.0, **kw)
    mt = tvh.insert(mt, torch.as_tensor(pts), torch.as_tensor(mask), 1.0, **kw)
    return mt, mj


def test_build_matches_jax():
    pts, mask = random_cloud(3000, scale=8.0, seed=3, n_valid=2800)
    mt, mj = build_both(pts, mask, 4096, 8)
    assert_same_map(mt, mj, pts[:2800])
    assert int(tvh.num_occupied(mt)) == int(jvh.num_occupied(mj)) > 1000
    assert float(tvh.load_factor(mt)) == pytest.approx(float(jvh.load_factor(mj)))
    assert np.abs(mt.points.numpy()).max() < 1e5  # poison never enters the table


def test_convert_carries_the_jax_map():
    pts, mask = random_cloud(1500, scale=6.0, seed=4)
    mt, mj = build_both(pts, mask, 2048, 8)
    mc = convert.voxel_hash_map(mj)
    for f in tvh.VoxelHashMap._fields:
        assert getattr(mc, f).dtype == getattr(mt, f).dtype, f
    assert_same_map(mc, mj, pts)


def test_incremental_insert_matches_jax():
    pts1, m1 = random_cloud(1500, scale=6.0, seed=1)
    pts2, m2 = random_cloud(1500, scale=6.0, seed=2, n_valid=1200)
    mt, mj = build_both(pts1, m1, 2048, 8)
    mt, mj = insert_both(mt, mj, pts2, m2)
    assert_same_map(mt, mj, np.concatenate([pts1, pts2[:1200]]))


def test_age_eviction_matches_jax():
    pts1, mk = random_cloud(200, scale=3.0, seed=7)
    mt, mj = build_both(pts1, mk, 1024, 4)
    seen = [pts1]
    for i in range(5):
        pts_i = pts1 + np.float32(100.0 + 10 * i)
        seen.append(pts_i)
        mt, mj = insert_both(mt, mj, pts_i, mk, max_age=2)
        assert_same_map(mt, mj, np.concatenate(seen))
    # the first batches were purged: only the last three remain occupied
    assert int(tvh.num_occupied(mt)) == int(jvh.num_occupied(mj))
    _, d2, ok = tvh.query_knn(mt, torch.as_tensor(pts1 + np.float32(140.0))[:5], 1.0, k=1)
    assert ok.all() and np.allclose(d2.numpy()[:, 0], 0.0, atol=1e-6)
    _, _, ok = tvh.query_knn(mt, torch.as_tensor(pts1[:5]), 1.0, k=1)
    assert not ok.any()


def test_center_policy_matches_jax():
    """A dense batch into a populated map under the iVox rule; and two
    points in one voxel, where the later, farther one is dropped."""
    pts1, m1 = random_cloud(1500, scale=4.0, seed=12)
    pts2, m2 = random_cloud(1500, scale=4.0, seed=13)
    mt, mj = build_both(pts1, m1, 1024, 4)
    mt, mj = insert_both(mt, mj, pts2, m2, center_policy=True)
    assert_same_map(mt, mj, np.concatenate([pts1, pts2]))

    center = np.array([[0.5, 0.5, 0.5]], np.float32)
    far = np.array([[0.05, 0.05, 0.05]], np.float32)
    mt, mj = tvh.create(256, 4), jvh.create(256, 4)
    for p in (center, far):
        mt, mj = insert_both(mt, mj, p, np.ones(1, bool), center_policy=True)
    assert_same_map(mt, mj, np.concatenate([center, far]))
    assert int(mt.count.sum()) == 1


def test_find_slots_matches_jax():
    pts, mask = random_cloud(2000, scale=8.0, seed=5)
    mt, mj = build_both(pts, mask, 4096, 8)
    rng = np.random.default_rng(6)
    c = rng.integers(-10, 10, (2048, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tvh.find_slots(mt, torch.as_tensor(c)).numpy(),
        np.asarray(jvh.find_slots(mj, jnp.asarray(c))))


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("group_capacity", [None, 512])
def test_query_knn_matches_jax(k, group_capacity):
    """Direct and grouped paths; the grouped capacity cuts some voxels."""
    pts = surface_scene(3000, seed=8)
    mt, mj = build_both(pts, np.ones(len(pts), bool), 4096, 8)
    rng = np.random.default_rng(9)
    q = (pts[rng.integers(0, len(pts), 1024)]
         + rng.normal(0, 0.3, (1024, 3))).astype(np.float32)
    kw = dict(k=k, stencil="nearby26", group_capacity=group_capacity)
    nj, d2j, okj = (np.asarray(a) for a in jvh.query_knn(mj, jnp.asarray(q), 1.0, **kw))
    nt, d2t, okt = (a.numpy() for a in tvh.query_knn(mt, torch.as_tensor(q), 1.0, **kw))
    np.testing.assert_array_equal(okt, okj)
    st, sj = np.sort(np.where(okt, d2t, np.inf), 1), np.sort(np.where(okj, d2j, np.inf), 1)
    np.testing.assert_allclose(st[okt], sj[okj], rtol=1e-6, atol=1e-6)
    d2r = ((nt - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2r[okt], d2t[okt], rtol=1e-5, atol=1e-6)
    if k == 1:  # argmin takes the first minimum in both
        np.testing.assert_allclose(nt[okt], nj[okj], atol=1e-6)
    assert okt[:, 0].mean() > 0.5


def _posed_source(pts, t_v):
    """The map points seen from a pose displaced by se3_exp(t_v)."""
    t_true = np.asarray(jlie.se3_exp(jnp.asarray(t_v, jnp.float32)))
    return ((pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)


@pytest.mark.parametrize("layout", ["voxel_hash", "block_map"])
def test_point_to_point_hg_matches_jax(layout):
    """One-shot gather + linearize at a displaced pose, on both map types
    (the block map's gather is fused_select's plain version here)."""
    pts = surface_scene(3000, seed=10)
    mask = np.ones(len(pts), bool)
    src = _posed_source(pts, [0.12, -0.1, 0.05, 0.02, -0.01, 0.03])
    mod_j, mod_t = (jvh, tvh) if layout == "voxel_hash" else (jbm, tbm)
    mj = mod_j.build(8192, 8, jnp.asarray(pts), jnp.asarray(mask), 1.0)
    mt = mod_t.build(8192, 8, torch.as_tensor(pts), torch.as_tensor(mask), 1.0)
    t0 = np.eye(4, dtype=np.float32)
    hj = jres.point_to_point_hg(jnp.asarray(t0), jnp.asarray(src), jnp.asarray(mask), mj,
                                1.0, 1.0, "nearby26", 8)
    ht = tres.point_to_point_hg(torch.as_tensor(t0), torch.as_tensor(src),
                                torch.as_tensor(mask), mt, 1.0, 1.0, "nearby26", 8)
    assert int(ht.num_valid) == int(hj.num_valid) > 2000
    for f in ("h", "g"):
        a, b = getattr(ht, f).numpy(), np.asarray(getattr(hj, f))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=f)
    np.testing.assert_allclose(float(ht.total_res), float(hj.total_res), rtol=1e-4)


def test_gather_candidates_on_voxel_hash_matches_jax():
    pts = surface_scene(2000, seed=11)
    mask = np.ones(len(pts), bool)
    src = _posed_source(pts, [0.05, 0.02, -0.03, 0.0, 0.01, -0.02])
    mj = jvh.build(4096, 8, jnp.asarray(pts), jnp.asarray(mask), 1.0)
    mt = tvh.build(4096, 8, torch.as_tensor(pts), torch.as_tensor(mask), 1.0)
    t0 = np.eye(4, dtype=np.float32)
    cj = jres.gather_candidates(jnp.asarray(t0), jnp.asarray(src), jnp.asarray(mask), mj,
                                1.0, 4, "nearby26", 8)
    ct = tres.gather_candidates(torch.as_tensor(t0), torch.as_tensor(src),
                                torch.as_tensor(mask), mt, 1.0, 4, "nearby26", 8)
    okj, okt = np.asarray(cj.valid), ct.valid.numpy()
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(ct.src.numpy(), np.asarray(cj.src))
    hj = jres.point_to_point_hg_cand(jnp.asarray(t0), cj, 1.0)
    ht = tres.point_to_point_hg_cand(torch.as_tensor(t0), ct, 1.0)
    for f in ("h", "g"):
        a, b = getattr(ht, f).numpy(), np.asarray(getattr(hj, f))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=f)
