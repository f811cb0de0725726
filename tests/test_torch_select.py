"""Port parity: ops/select.py (`fused_select_plain`, and the wrapper on CPU
tensors) against the JAX package's `fused_select_xla`, the path its own
CPU tests take, under the contract the TPU lane holds the Pallas kernel to
(tests_tpu/test_pallas_parity.py::_assert_parity): equal valid counts per
row, sorted d2 within the tie window rtol 2e-4, and every returned
coordinate reproducing its d2 (rtol 1e-4, atol 1e-5)."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funny_lidar_slam_tpu.maps import block_map as jbm
from funny_lidar_slam_tpu.maps import grid_map as jgrid
from funny_lidar_slam_tpu.ops import pallas_select
from funny_lidar_slam_tpu.ops.voxel import group_by_voxel
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.maps import block_map as tbm
from funny_lidar_slam_torch.ops import cuda_build, select
from funny_lidar_slam_torch.registration import residuals as tres

torch.set_num_threads(1)

_TIE_RTOL = 2e-4
DIMS = (32, 32, 8)


def surface_cloud(n, seed, extent=24.0):
    """Structured surface points (walls + floor): realistic voxel occupancy."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, n)
    pts = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    pts[kinds == 0, 2] = 0.0
    pts[kinds == 1, 1] = np.round(pts[kinds == 1, 1] / 8.0) * 8.0
    pts[kinds == 2, 0] = np.round(pts[kinds == 2, 0] / 8.0) * 8.0
    return pts


def inputs(map_pts, queries, gcap=None):
    """fused_select inputs from a JAX grid map, as NumPy arrays, exactly as
    the JAX gather_candidates builds them; plus the stored map points."""
    cap = 1 << int(np.ceil(np.log2(len(map_pts))))
    mpts = np.zeros((cap, 3), np.float32)
    mpts[: len(map_pts)] = map_pts
    m = jgrid.build(DIMS, 8, jnp.asarray(mpts), jnp.arange(cap) < len(map_pts), 1.0)
    n = len(queries)
    gcap = -(-(gcap or n) // 128) * 128
    g = group_by_voxel(jnp.asarray(queries), jnp.ones(n, bool), 1.0)
    rep = jnp.where((g.rank == 0) & (g.group_id < gcap), g.group_id, gcap)
    uniq = jnp.zeros((gcap, 3), jnp.int32).at[rep].set(g.group_coords, mode="drop")
    wnd = jgrid.gather_cover(m, uniq)
    gid = jnp.minimum(g.group_id, gcap - 1).astype(jnp.int32)
    arrays = [np.array(a) for a in (wnd, gid, g.sorted_pts, g.group_coords)]
    return arrays, stored_points(m)


def stored_points(m):
    s, plane = m.bucket_size, m.plane
    tab = np.asarray(m.tab)[:-1]
    cnt = np.asarray(m.counts)
    nb = tab.shape[0]
    pts = np.stack([tab[:, a * plane:(a + 1) * plane].reshape(nb, 8, s) for a in range(3)], -1)
    valid = (np.arange(s)[None, None, :] < cnt[:, :, None]) & (np.abs(pts[..., 0]) < 1e18)
    return pts[valid]


def run_both(arrays, k, stencil):
    wnd, gid, qs, qvox = arrays
    out_j = pallas_select.fused_select_xla(jnp.asarray(wnd), jnp.asarray(gid), jnp.asarray(qs),
                                           k, 64, stencil=stencil, qvox=jnp.asarray(qvox))
    out_t = select.fused_select_plain(*(torch.as_tensor(a) for a in (wnd, gid, qs)), k, 64,
                                      stencil=stencil, qvox=torch.as_tensor(qvox))
    return [o.numpy() for o in out_t], [np.asarray(o) for o in out_j]


def assert_parity(out_t, out_j, qs):
    d2t, d2j = out_t[0], out_j[0]
    ft, fj = d2t < 1e18, d2j < 1e18
    np.testing.assert_array_equal(ft.sum(1), fj.sum(1))
    st = np.sort(np.where(ft, d2t, np.inf), axis=1)
    sj = np.sort(np.where(fj, d2j, np.inf), axis=1)
    fin = np.isfinite(st)
    np.testing.assert_allclose(st[fin], sj[fin], rtol=_TIE_RTOL, atol=1e-9)
    for out, f in ((out_t, ft), (out_j, fj)):
        with np.errstate(over="ignore"):  # sentinel coordinates square to inf
            d2r = ((out[1] - qs[:, 0:1]) ** 2 + (out[2] - qs[:, 1:2]) ** 2
                   + (out[3] - qs[:, 2:3]) ** 2)
        np.testing.assert_allclose(d2r[f], out[0][f], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stencil", ["nearby26", "nearby18", "nearby6", "center"])
def test_plain_matches_jax_xla(stencil):
    arrays, _ = inputs(surface_cloud(12000, 0), surface_cloud(1024, 1))
    out_t, out_j = run_both(arrays, 16, stencil)
    assert_parity(out_t, out_j, arrays[2])
    assert (out_t[0] < 1e18).any()


def test_adversarial_ties_and_sentinels():
    """Exact duplicate map points (3-way ties), all-sentinel rows for queries
    over empty space, queries on voxel corners."""
    rng = np.random.default_rng(3)
    base = surface_cloud(1000, 2, extent=10.0)
    q_hit = base[rng.choice(len(base), 512)] + rng.normal(0, 0.05, (512, 3)).astype(np.float32)
    q_empty = rng.uniform(500.0, 600.0, (256, 3)).astype(np.float32)
    q_edge = np.round(rng.uniform(0, 10.0, (256, 3))).astype(np.float32)
    arrays, _ = inputs(np.repeat(base, 3, axis=0), np.concatenate([q_hit, q_empty, q_edge]))
    out_t, out_j = run_both(arrays, 8, "nearby26")
    assert_parity(out_t, out_j, arrays[2])
    assert (out_t[0] >= 1e18).sum() == (out_j[0] >= 1e18).sum() > 0


def test_k1_against_brute_force():
    arrays, stored = inputs(surface_cloud(8000, 5, extent=16.0), surface_cloud(512, 6, 16.0))
    out_t, _ = run_both(arrays, 1, "nearby26")
    qs, d2 = arrays[2], out_t[0][:, 0]
    vox_q, vox_m = np.floor(qs).astype(np.int64), np.floor(stored).astype(np.int64)
    for i in range(0, len(qs), 7):
        within = (np.abs(vox_m - vox_q[i]) <= 1).all(1)
        if not within.any():
            assert d2[i] >= 1e18
            continue
        ref = ((stored[within] - qs[i]) ** 2).sum(1).min()
        assert abs(d2[i] - ref) < 1e-4, (i, d2[i], ref)


def test_wrapper_takes_plain_path_on_cpu():
    """CPU tensors go to the plain version: identical output, no launch."""
    arrays, _ = inputs(surface_cloud(4000, 7), surface_cloud(256, 8))
    t = [torch.as_tensor(a) for a in arrays]
    before = select.fused_select.launches
    got = select.fused_select(*t[:3], 16, 64, stencil="nearby18", qvox=t[3])
    ref = select.fused_select_plain(*t[:3], 16, 64, stencil="nearby18", qvox=t[3])
    assert select.fused_select.launches == before == 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        select.fused_select(*t[:3], 16, 64, stencil="nearby18", qvox=None)


def test_wrapper_never_falls_back_off_the_cpu():
    """Tensors that are not on the CPU never take the plain version: on a
    device other than CUDA the wrapper raises, and without a CUDA toolkit
    the kernel's build raises instead of returning a library."""
    meta = [torch.empty(s, dtype=d, device="meta") for s, d in
            (((128, 1536), torch.float32), ((256,), torch.int32),
             ((256, 3), torch.float32), ((256, 3), torch.int32))]
    with pytest.raises(ValueError, match="CUDA"):
        select.fused_select(*meta[:3], 16, 64, qvox=meta[3])
    if cuda_build.lib_path("fused_select").exists() or shutil.which("nvcc"):
        pytest.skip("a built kernel library or nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.library("fused_select")
    assert select.fused_select.launches == 0


@pytest.mark.parametrize("stencil", ["nearby26", "nearby18", "nearby6", "center"])
def test_invalid_entries_trail_each_row(stencil):
    """In both fused_select_plain and fused_select_xla, every entry after a
    row's first d2 >= 1e18 is also >= 1e18. The kernel ends its rounds once
    only +inf keys are left (d2 >= 1e18), so that early end changes neither
    the count nor the values of a row's valid entries."""
    rng = np.random.default_rng(4)
    base = surface_cloud(1000, 2, extent=10.0)
    q_hit = base[rng.choice(len(base), 384)] + rng.normal(0, 0.05, (384, 3)).astype(np.float32)
    q_empty = rng.uniform(500.0, 600.0, (128, 3)).astype(np.float32)
    arrays, _ = inputs(base, np.concatenate([q_hit, q_empty]))
    out_t, out_j = run_both(arrays, 16, stencil)
    for d2 in (out_t[0], out_j[0]):
        invalid = d2 >= 1e18
        assert (invalid[:, :-1] <= invalid[:, 1:]).all()
        n_valid = (~invalid).sum(1)
        assert (n_valid == 0).any() and ((n_valid > 0) & (n_valid < 16)).any()
    np.testing.assert_array_equal((out_t[0] < 1e18).sum(1), (out_j[0] < 1e18).sum(1))


def _spy(seen, side, fn):
    """fn, recording the gid it is called with under seen[side]."""
    def wrapped(cand_tab, gid, *args, **kwargs):
        seen[side] = np.array(gid)
        return fn(cand_tab, gid, *args, **kwargs)
    return wrapped


@pytest.mark.parametrize("caller", ["gather_candidates", "query_knn_planes"])
def test_callers_pass_monotone_gid_equal_to_jax(monkeypatch, caller):
    """The gid the port's callers hand to fused_select does not decrease
    (the kernel stages a block's rows as one range from its first and last
    query's group) and equals the one the JAX callers hand to theirs, with
    masked queries and a group capacity below the number of groups."""
    seen = {}
    monkeypatch.setattr(select, "fused_select", _spy(seen, "torch", select.fused_select))
    monkeypatch.setattr(pallas_select, "fused_select_xla",
                        _spy(seen, "jax", pallas_select.fused_select_xla))
    rng = np.random.default_rng(9)
    map_pts = surface_cloud(4096, 10)
    queries = surface_cloud(1024, 11) + rng.normal(0, 0.1, (1024, 3)).astype(np.float32)
    if caller == "gather_candidates":
        mask = rng.random(1024) < 0.8
        mj = jgrid.build(DIMS, 8, jnp.asarray(map_pts), jnp.ones(4096, bool), 1.0)
        eye = np.eye(4, dtype=np.float32)
        jres.gather_candidates(jnp.asarray(eye), jnp.asarray(queries), jnp.asarray(mask), mj,
                               1.0, 8, group_capacity=256)
        tres.gather_candidates(torch.as_tensor(eye), torch.as_tensor(queries),
                               torch.as_tensor(mask), convert.any_map(mj), 1.0, 8,
                               group_capacity=256)
    else:
        mj = jbm.build(4096, 8, jnp.asarray(map_pts), jnp.ones(4096, bool), 1.0)
        jbm.query_knn_planes(mj, jnp.asarray(queries), 1.0, 4, group_capacity=256)
        tbm.query_knn_planes(convert.any_map(mj), torch.as_tensor(queries), 1.0, 4,
                             group_capacity=256)
    gid_t, gid_j = seen["torch"], seen["jax"]
    assert gid_t.dtype == np.int32 and gid_t.shape == (1024,)
    assert (np.diff(gid_t) >= 0).all() and gid_t.max() == 255
    np.testing.assert_array_equal(gid_t, gid_j.astype(np.int32))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_wrapper_raises_on_misaligned_cand_tab(offset):
    """The kernel stages cover rows by bulk copy, which needs a 16-byte
    aligned source: the wrapper raises on an offset view of cand_tab (a
    meta tensor, so no card is needed) and launches nothing."""
    flat = torch.empty(128 * 1536 + offset, device="meta")
    tab = flat[offset:].view(128, 1536)
    assert tab.is_contiguous() and tab.data_ptr() % 16
    gid, qpts, qvox = (torch.empty(s, dtype=d, device="meta") for s, d in
                       (((256,), torch.int32), ((256, 3), torch.float32),
                        ((256, 3), torch.int32)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        select.fused_select(tab, gid, qpts, 16, 64, qvox=qvox)
    assert select.fused_select.launches == 0
