"""Port parity: maps/block_map.py (the hashed block map) of
funny_lidar_slam_torch against the JAX package, mirroring
tests/test_block_map.py on the same NumPy inputs.

Map state: fingerprints, ages, epoch and counts must be identical; each
(slot, voxel) bucket holds the same set of points where its count is below
the bucket size S, and a subset of that voxel's input points where it is
full (which points survive an overflow depends on the sort order, and the
port sorts stably). Queries: sorted d2 within the select tie window
(rtol 2e-4), and every returned coordinate reproduces its d2."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funny_lidar_slam_tpu.maps import block_map as jbm
from funny_lidar_slam_tpu.maps import voxel_hash as jvh
from funny_lidar_slam_tpu.ops import voxel as jvox
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.maps import block_map as tbm
from funny_lidar_slam_torch.maps import voxel_hash as tvh
from funny_lidar_slam_torch.ops import voxel as tvox

torch.set_num_threads(1)

_TIE_RTOL = 2e-4


def random_cloud(n, scale=10.0, seed=0, n_valid=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    mask = np.ones(n, dtype=bool)
    if n_valid is not None:
        mask[n_valid:] = False
        pts[n_valid:] = 1e6  # poison
    return pts, mask


def inserted_points(m):
    """All live points stored in a block map (either package), NumPy [M, 3]."""
    s, plane = m.bucket_size, m.plane
    live = np.asarray(m.fp) != 0
    tab = np.asarray(m.tab)[:-1][live]
    nb = tab.shape[0]
    cnt = np.asarray(m.counts)[live]
    pts = np.stack([tab[:, a * plane:(a + 1) * plane].reshape(nb, 8, s) for a in range(3)], -1)
    valid = (np.arange(s)[None, None, :] < cnt[:, :, None]) & (np.abs(pts[..., 0]) < 1e18)
    return pts[valid]


def assert_same_map(mt, mj, inputs):
    """Bookkeeping exact; bucket sets exact below S, a subset of the voxel's
    inputs when full. `inputs` are all points inserted so far."""
    np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
    np.testing.assert_array_equal(mt.fpwin.numpy(), np.asarray(mj.fpwin).astype(np.int64))
    for f in ("counts", "age", "epoch"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)),
                                      err_msg=f)
    s, plane = mj.bucket_size, mj.plane
    tj, tt = np.asarray(mj.tab), mt.tab.numpy()
    assert tt.shape == tj.shape
    np.testing.assert_array_equal(tt[-1], tj[-1])  # the _MISS row
    known = set(map(tuple, inputs))
    cnt = np.asarray(mj.counts)
    live = np.asarray(mj.fp) != 0
    for slot, loc in zip(*np.nonzero(cnt * live[:, None])):
        lanes = loc * s + np.arange(cnt[slot, loc])
        sets = [sorted(map(tuple, np.stack([tab[slot, a * plane + lanes] for a in range(3)], 1)))
                for tab in (tt, tj)]
        if cnt[slot, loc] < s:
            assert sets[0] == sets[1], (slot, loc)
        else:
            assert set(sets[0]) <= known, (slot, loc)


def build_both(pts, mask, capacity, bucket, **kw):
    mj = jbm.build(capacity, bucket, jnp.asarray(pts), jnp.asarray(mask), 1.0, **kw)
    mt = tbm.build(capacity, bucket, torch.as_tensor(pts), torch.as_tensor(mask), 1.0, **kw)
    return mt, mj


def query_both(mt, mj, q, k, **kw):
    nj, d2j, okj = jbm.query_knn(mj, jnp.asarray(q), 1.0, k=k, **kw)
    nt, d2t, okt = tbm.query_knn(mt, torch.as_tensor(q), 1.0, k=k, **kw)
    return (nt.numpy(), d2t.numpy(), okt.numpy()), tuple(np.asarray(a) for a in (nj, d2j, okj))


def assert_query_parity(out_t, out_j, q):
    (nt, d2t, okt), (_, d2j, okj) = out_t, out_j
    np.testing.assert_array_equal(okt.sum(1), okj.sum(1))
    st, sj = np.sort(np.where(okt, d2t, np.inf), 1), np.sort(np.where(okj, d2j, np.inf), 1)
    fin = np.isfinite(sj)
    np.testing.assert_array_equal(np.isfinite(st), fin)
    np.testing.assert_allclose(st[fin], sj[fin], rtol=_TIE_RTOL, atol=1e-9)
    d2r = ((nt - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2r[okt], d2t[okt], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", ["spatial_hash", "fingerprint"])
def test_hashes_bit_exact(fn):
    """uint32 wrap-around in int64 lanes: negative coords, |coords| <= 2^20."""
    rng = np.random.default_rng(1)
    c = rng.integers(-2**20, 2**20 + 1, (4096, 3)).astype(np.int32)
    c[:4] = [[2**20, 2**20, 2**20], [-2**20, -2**20, -2**20], [0, 0, 0], [-1, -1, -1]]
    if fn == "spatial_hash":
        for size in (16, 1 << 15):
            ref = np.asarray(jvox.spatial_hash(jnp.asarray(c), size)).astype(np.int64)
            np.testing.assert_array_equal(tvox.spatial_hash(torch.as_tensor(c), size).numpy(), ref)
    else:
        ref = np.asarray(jvh.fingerprint(jnp.asarray(c))).astype(np.int64)
        got = tvh.fingerprint(torch.as_tensor(c)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got & 1).all() and (got >= 0).all() and (got < 2**32).all()


def test_insert_stores_all_points():
    pts, mask = random_cloud(2000, scale=8.0, seed=3, n_valid=1800)
    mt, mj = build_both(pts, mask, 4096, 8)
    assert_same_map(mt, mj, pts[:1800])
    ins = inserted_points(mt)
    assert len(ins) >= 1700  # bucket overflow may drop a handful
    d = np.min(np.sum((ins[:200, None, :] - pts[None, :1800, :]) ** 2, -1), axis=1)
    assert np.max(d) < 1e-9
    assert np.max(np.abs(ins)) < 1e5  # poison never enters the table


def test_knn1_matches_oracle():
    pts, mask = random_cloud(2000, scale=8.0, seed=3, n_valid=1800)
    mt, mj = build_both(pts, mask, 4096, 8)
    queries = pts[:50] + np.random.default_rng(4).normal(0, 0.2, (50, 3)).astype(np.float32)
    out_t, out_j = query_both(mt, mj, queries, 1)
    assert_query_parity(out_t, out_j, queries)
    ins = inserted_points(mt)
    for i, q in enumerate(queries):
        assert out_t[2][i, 0]
        assert abs(out_t[1][i, 0] - np.min(np.sum((ins - q) ** 2, axis=-1))) < 1e-5


def test_knn5_matches_oracle_and_voxel_hash():
    pts, mask = random_cloud(3000, scale=6.0, seed=5)
    mt, mj = build_both(pts, mask, 4096, 16)
    queries = pts[100:140]
    out_t, out_j = query_both(mt, mj, queries, 5)
    assert_query_parity(out_t, out_j, queries)
    d2 = out_t[1]
    ins = inserted_points(mt)
    for i, q in enumerate(queries):
        od2 = np.sort(np.sum((ins - q) ** 2, axis=-1))[:5]
        assert np.allclose(np.sort(d2[i]), od2, atol=1e-5)
    # the block cover is a superset of nearby26: at least as close as the
    # JAX package's per-voxel hash
    mv = jvh.build(4096, 16, jnp.asarray(pts), jnp.asarray(mask), 1.0)
    _, d2v, _ = jvh.query_knn(mv, jnp.asarray(queries), 1.0, k=5, stencil="nearby26")
    assert np.all(np.sort(d2)[:, 0] <= np.sort(np.asarray(d2v))[:, 0] + 1e-5)


def test_group_capacity_truncation():
    pts, mask = random_cloud(512, scale=6.0, seed=8)
    mt, mj = build_both(pts, mask, 1024, 8)
    out_t, out_j = query_both(mt, mj, pts, 1, group_capacity=8)
    ok = out_t[2]
    np.testing.assert_array_equal(ok, out_j[2])
    assert ok[:, 0].sum() >= 8  # the in-capacity groups report neighbors
    assert not ok[:, 0].all()  # beyond-capacity groups report none


def test_incremental_insert_accumulates():
    pts1, m1 = random_cloud(500, scale=5.0, seed=6)
    pts2 = pts1 + np.float32(20.0)  # disjoint region
    mt, mj = build_both(pts1, m1, 2048, 8)
    n1 = int(tbm.num_occupied(mt))
    mj = jbm.insert(mj, jnp.asarray(pts2), jnp.asarray(m1), 1.0)
    mt = tbm.insert(mt, torch.as_tensor(pts2), torch.as_tensor(m1), 1.0)
    assert_same_map(mt, mj, np.concatenate([pts1, pts2]))
    assert int(tbm.num_occupied(mt)) == int(jbm.num_occupied(mj)) > n1
    assert int(tbm.num_blocks(mt)) == int(jbm.num_blocks(mj))
    assert float(tbm.load_factor(mt)) == pytest.approx(float(jbm.load_factor(mj)))
    for q in (pts1[:10], pts2[:10]):
        _, d2, ok = tbm.query_knn(mt, torch.as_tensor(q), 1.0, k=1)
        assert ok.all()
        assert np.allclose(d2.numpy()[:, 0], 0, atol=1e-6)


def test_age_eviction_reclaims_and_wipes():
    pts1, mk = random_cloud(200, scale=3.0, seed=7)
    mt, mj = build_both(pts1, mk, 1024, 4)
    seen = [pts1]
    for i in range(5):
        pts_i = pts1 + np.float32(100.0 + 10 * i)
        seen.append(pts_i)
        mj = jbm.insert(mj, jnp.asarray(pts_i), jnp.asarray(mk), 1.0, max_age=2)
        mt = tbm.insert(mt, torch.as_tensor(pts_i), torch.as_tensor(mk), 1.0, max_age=2)
        assert_same_map(mt, mj, np.concatenate(seen))
    _, d2, ok = tbm.query_knn(mt, torch.as_tensor(pts1 + np.float32(140.0))[:5], 1.0, k=1)
    assert ok.all()
    assert np.allclose(d2.numpy()[:, 0], 0.0, atol=1e-6)
    # stale data from before eviction never surfaces
    assert inserted_points(mt).min() > 100.0 - 3.5


def test_center_policy_keeps_closest():
    """Two points in one voxel: the later, farther one is dropped."""
    center = np.array([[0.5, 0.5, 0.5]], np.float32)
    far = np.array([[0.05, 0.05, 0.05]], np.float32)
    mk = np.ones(1, bool)
    mj, mt = jbm.create(256, 4), tbm.create(256, 4)
    for p in (center, far):
        mj = jbm.insert(mj, jnp.asarray(p), jnp.asarray(mk), 1.0, center_policy=True)
        mt = tbm.insert(mt, torch.as_tensor(p), torch.as_tensor(mk), 1.0, center_policy=True)
    assert_same_map(mt, mj, np.concatenate([center, far]))
    ins = inserted_points(mt)
    assert len(ins) == 1 and np.allclose(ins[0], center[0])


def test_center_policy_batch_matches_jax():
    """A dense batch into a populated map under the iVox rule."""
    pts1, m1 = random_cloud(1500, scale=4.0, seed=12)
    pts2, m2 = random_cloud(1500, scale=4.0, seed=13)
    mt, mj = build_both(pts1, m1, 1024, 4)
    mj = jbm.insert(mj, jnp.asarray(pts2), jnp.asarray(m2), 1.0, center_policy=True)
    mt = tbm.insert(mt, torch.as_tensor(pts2), torch.as_tensor(m2), 1.0, center_policy=True)
    assert_same_map(mt, mj, np.concatenate([pts1, pts2]))


def test_plane_query_matches_assembled():
    pts, mask = random_cloud(800, scale=5.0, seed=9)
    mt, mj = build_both(pts, mask, 2048, 8)
    q = pts[:64]
    nbrs, d2, ok = tbm.query_knn(mt, torch.as_tensor(q), 1.0, k=4)
    px, py, pz, d2p, okp, order = tbm.query_knn_planes(mt, torch.as_tensor(q), 1.0, 4)
    np.testing.assert_array_equal(nbrs[..., 0].numpy(), px.numpy())
    np.testing.assert_array_equal(d2.numpy(), d2p.numpy())
    np.testing.assert_array_equal(ok.numpy(), okp.numpy())
    *_, order_j = jbm.query_knn_planes(mj, jnp.asarray(q), 1.0, 4)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    out_t, out_j = query_both(mt, mj, q, 4)
    assert_query_parity(out_t, out_j, q)


def test_find_slots_and_gather_cover_match_jax():
    """Probe results and cover rows, bit for bit, for hit, missed and
    negative block coords; the converted JAX map gives the same rows."""
    pts, mask = random_cloud(3000, scale=12.0, seed=10)
    mt, mj = build_both(pts, mask, 2048, 8)
    rng = np.random.default_rng(11)
    q = np.floor(pts[:300]).astype(np.int32)
    q[150:] += rng.integers(-40, 40, (150, 3)).astype(np.int32)
    bc = q >> 1
    np.testing.assert_array_equal(tbm.find_block_slots(mt, torch.as_tensor(bc)).numpy(),
                                  np.asarray(jbm.find_block_slots(mj, jnp.asarray(bc))))
    wj = np.asarray(jbm.gather_cover(mj, jnp.asarray(q)))
    np.testing.assert_array_equal(tbm.gather_cover(mt, torch.as_tensor(q)).numpy(), wj)
    np.testing.assert_array_equal(
        tbm.gather_cover_any(convert.block_map(mj), torch.as_tensor(q)).numpy(), wj)
    assert (wj >= 1e29).all(1).any()  # some covers miss every block
