"""Port parity: the incremental NDT map (maps/ndt_map.py), the NDT residuals
and NdtMatcher of funny_lidar_slam_torch against the JAX package, plus the
port's mirrors of the JAX package's NDT map tests (tests/test_maps.py:132-207)
and of its NDT registration test (tests/test_registration.py:194).

Tolerances: fingerprints, counts, the estimated flags, ages and epochs are
exact; means to 1e-5 relative; M2 to 1e-3 relative of its largest entry and
the cached inverse covariances to 1e-2 relative of theirs (the inverse of a
covariance floored at a condition number of 1e3 amplifies the f32 rounding
of the moment sums, which add in a different order on each side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.cloud import Cloud as JCloud
from funny_lidar_slam_tpu.core.lie import se3_exp
from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.maps import ndt_map as jndt
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.cloud import Cloud as TCloud
from funny_lidar_slam_torch.maps import ndt_map
from funny_lidar_slam_torch.registration import matchers as tm
from funny_lidar_slam_torch.registration import residuals as tres

from test_registration import T_SMALL_V, room_scene

torch.set_num_threads(1)


def tt(a):
    return torch.as_tensor(np.asarray(a))


def assert_map_matches(mt, mj):
    mj = jax.device_get(mj)
    np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
    np.testing.assert_array_equal(mt.fpwin.numpy(), np.asarray(mj.fpwin).astype(np.int64))
    for f in ("count", "estimated", "age", "epoch"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)),
                                      err_msg=f)
    for f, rtol in (("mean", 1e-5), ("m2", 1e-3), ("info", 1e-2)):
        ref = np.asarray(getattr(mj, f))
        np.testing.assert_allclose(getattr(mt, f).numpy(), ref, rtol=0,
                                   atol=rtol * max(np.abs(ref).max(), 1.0), err_msg=f)


# --- mirrors of tests/test_maps.py -------------------------------------------

def test_ndt_stats_match_numpy():
    rng = np.random.default_rng(8)
    centers = np.array([[0.5, 0.5, 0.5], [3.5, 0.5, 0.5], [0.5, 3.5, 0.5]], np.float32)
    pts = np.concatenate([c + rng.normal(0, 0.05, (20, 3)).astype(np.float32)
                          for c in centers])
    m = ndt_map.insert(ndt_map.create(256), tt(pts), torch.ones(60, dtype=torch.bool), 1.0,
                       min_points=5)
    occ = m.occupied.numpy()
    assert occ.sum() == 3
    means = m.mean.numpy()[occ]
    assert np.allclose(sorted(m.count.numpy()[occ]), [20, 20, 20])
    oracle = np.stack([pts[i * 20:(i + 1) * 20].mean(0) for i in range(3)])
    assert np.allclose(means[np.lexsort(means.T)], oracle[np.lexsort(oracle.T)], atol=1e-5)
    assert m.estimated.numpy()[occ].all()
    sl = np.where(occ)[0][0]
    k = int(np.argmin(np.linalg.norm(oracle - m.mean.numpy()[sl], axis=1)))
    sigma = np.cov(pts[k * 20:(k + 1) * 20].T)
    reg = sigma + max(1e-3 * np.linalg.eigvalsh(sigma)[-1], 1e-6) * np.eye(3)
    assert np.allclose(m.info.numpy()[sl], np.linalg.inv(reg), rtol=2e-2, atol=1e-1)


def test_ndt_incremental_merge():
    rng = np.random.default_rng(9)
    cluster = (np.array([0.5, 0.5, 0.5]) + rng.normal(0, 0.1, (40, 3))).astype(np.float32)
    mask20 = torch.ones(20, dtype=torch.bool)
    m = ndt_map.create(128)
    m = ndt_map.insert(m, tt(cluster[:20]), mask20, 1.0, min_points=5)
    m = ndt_map.insert(m, tt(cluster[20:]), mask20, 1.0, min_points=5)
    count = m.count.numpy()
    sl = np.where(m.occupied.numpy() & (count > 0))[0]
    assert count[sl].sum() == 40
    big = sl[np.argmax(count[sl])]
    vox = np.floor(m.mean.numpy()[big]).astype(int)
    members = cluster[(np.floor(cluster).astype(int) == vox).all(1)]
    assert np.allclose(m.mean.numpy()[big], members.mean(0), atol=1e-5)
    centered = members - members.mean(0)
    assert np.allclose(m.m2.numpy()[big], centered.T @ centered, atol=1e-3)


def test_ndt_estimate_all_single_point():
    m = ndt_map.insert(ndt_map.create(64), torch.tensor([[0.5, 0.5, 0.5]]),
                       torch.ones(1, dtype=torch.bool), 1.0, estimate_all=torch.tensor(True))
    sl = np.where(m.occupied.numpy())[0][0]
    assert bool(m.estimated[sl])
    assert np.allclose(m.info.numpy()[sl], 100.0 * np.eye(3))


def test_ndt_query_stencil():
    rng = np.random.default_rng(10)
    pts = (np.array([0.5, 0.5, 0.5]) + rng.normal(0, 0.1, (30, 3))).astype(np.float32)
    m = ndt_map.insert(ndt_map.create(128), tt(pts), torch.ones(30, dtype=torch.bool), 1.0,
                       min_points=5)
    _, _, valid = ndt_map.query_stencil(m, torch.tensor([[0.6, 0.4, 0.5], [10.0, 10.0, 10.0]]),
                                        1.0)
    assert valid[0, 0] and not valid[1].any()


# --- parity with the JAX package ---------------------------------------------

def scene_batches(seed=0, n=4096, shift=40.0):
    """Surface-like clouds far from the origin (the f32 regime of a mapped
    scene), three batches that overlap and move, 10 % masked."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    pts[: n // 2, 2] = rng.normal(0, 0.05, n // 2)  # a floor
    pts += np.float32(shift)
    mask = rng.uniform(size=n) < 0.9
    return [(pts + np.float32(0.7 * i), mask) for i in range(3)]


@pytest.mark.parametrize("max_age", [0, 1])
def test_insert_matches_jax(max_age):
    """Three inserts (the first with estimate_all, as a first scan) into a
    small table, so the probe windows fill and claims contend; with
    max_age=1 older slots are reclaimed."""
    kw = dict(max_age=max_age, min_points=4, max_points=30)
    mj, mt = jndt.create(4096), ndt_map.create(4096)
    for i, (pts, mask) in enumerate(scene_batches()):
        mj = jndt.insert(mj, jnp.asarray(pts), jnp.asarray(mask), 0.5, estimate_all=i == 0, **kw)
        mt = ndt_map.insert(mt, tt(pts), tt(mask), 0.5, estimate_all=torch.tensor(i == 0), **kw)
        assert_map_matches(mt, mj)
    assert int(ndt_map.num_occupied(mt)) > 1500
    assert 0 < int(ndt_map.num_estimated(mt)) < int(ndt_map.num_occupied(mt))


@pytest.mark.parametrize("group_capacity", [None, 1024])
def test_query_stencil_matches_jax(group_capacity):
    """Both lookup paths from the same converted map: the same valid flags,
    and means and infos equal where valid (they are gathers of one table)."""
    pts, mask = scene_batches()[0]
    mj = jndt.insert(jndt.create(8192), jnp.asarray(pts), jnp.asarray(mask), 0.5, min_points=3)
    mt = convert.ndt_map(jax.device_get(mj))
    rng = np.random.default_rng(3)
    q = pts[rng.choice(len(pts), 3000)] + rng.normal(0, 0.4, (3000, 3)).astype(np.float32)
    mean_j, info_j, valid_j = (np.asarray(a) for a in jndt.query_stencil(
        mj, jnp.asarray(q), 0.5, group_capacity=group_capacity))
    mean_t, info_t, valid_t = ndt_map.query_stencil(mt, tt(q), 0.5,
                                                    group_capacity=group_capacity)
    np.testing.assert_array_equal(valid_t.numpy(), valid_j)
    assert valid_j.sum() > 3000
    np.testing.assert_array_equal(mean_t.numpy()[valid_j], mean_j[valid_j])
    np.testing.assert_array_equal(info_t.numpy()[valid_j], info_j[valid_j])


@pytest.fixture(scope="module")
def sim():
    return simulate(SimConfig(duration=4.2, points_per_scan=4096, max_range=30.0, seed=3))


NDT = dict(voxel_size=2.0, source_filter_size=0.3, source_capacity=4096, map_capacity=16384,
           min_points_in_voxel=4, min_effective_pts=50, res_outlier_thresh=30.0)


def clouds(points, cap=4096):
    pts = np.zeros((cap, 3), np.float32)
    pts[: len(points)] = points[:cap]
    mask = np.arange(cap) < len(points)
    return JCloud(jnp.asarray(pts), jnp.asarray(mask)), TCloud(tt(pts), tt(mask))


@pytest.fixture(scope="module")
def ndt_scene(sim):
    """A JAX NDT map seeded from scan 0 at its true pose, scan 12 and a
    perturbed guess of its pose."""
    s0, s1 = sim.scans[0], sim.scans[12]
    jmat = jm.NdtMatcher(jm.NdtConfig(**NDT))
    state = jmat.add_first(jmat.create_state(), clouds(s0.points)[0], s0.gt_pose)
    pert = np.asarray(se3_exp(jnp.asarray([0.08, -0.06, 0.03, 0.004, -0.003, 0.01],
                                          jnp.float32)))
    return jax.device_get(state), s1, (s1.gt_pose @ pert).astype(np.float32)


def test_ndt_hg_matches_jax(ndt_scene):
    """ndt_corr + ndt_hg_corr at the perturbed pose: the same valid count,
    and H, g and the residual sum within 1e-3 of their largest entries."""
    state, s1, t_init = ndt_scene
    cj, ct = clouds(s1.points)
    hj = jres.ndt_hg(jnp.asarray(t_init), cj.points, cj.mask, state.m, 0.5, 30.0)
    ht = tres.ndt_hg(tt(t_init), ct.points, ct.mask, convert.ndt_map(state.m), 0.5, 30.0)
    assert int(ht.num_valid) == int(hj.num_valid) > 1000
    for f in ("h", "g", "total_res"):
        ref = np.asarray(getattr(hj, f))
        np.testing.assert_allclose(getattr(ht, f).numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max(), err_msg=f)


def test_ndt_match_matches_jax(ndt_scene):
    """One NdtMatcher.match from the same state and guess: the same
    convergence and gathers, the pose within 1e-3 m / 1e-3 rad, and the map
    after the insert within a few voxels (the final poses differ in the
    last bits, so a point on a voxel face may land on either side)."""
    state, s1, t_init = ndt_scene
    cj, ct = clouds(s1.points)
    sj, rj = jm.NdtMatcher(jm.NdtConfig(**NDT)).match(jax.tree.map(jnp.asarray, state), cj,
                                                      t_init)
    st, rt = tm.NdtMatcher(tm.NdtConfig(**NDT), device="cpu").match(
        convert.matcher_state(state), ct, t_init)
    assert bool(rt.converged) == bool(rj.converged) is True
    assert int(rt.iters) == int(rj.iters)
    assert abs(int(rt.num_valid) - int(rj.num_valid)) <= 5
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 1e-3
    assert rot_angle(pt, pj) < 1e-3
    nj, nt = int(np.sum(np.asarray(sj.m.fp) != 0)), int(ndt_map.num_occupied(st.m))
    assert nt > int(np.sum(state.m.fp != 0)) and abs(nt - nj) <= 3
    assert abs(float(st.m.count.sum()) - float(np.asarray(sj.m.count).sum())) <= 10
    assert not bool(st.first_scan) and not bool(sj.first_scan)


def test_ndt_set_map_and_fitness_match_jax(sim):
    """Localization's map swap (every voxel estimated) on the same cloud,
    then fitness of a scan at its true pose: the map as in
    test_insert_matches_jax, the fitness within 1e-4 relative."""
    cfg = dict(NDT, is_localization_mode=True)
    jmat, tmat = jm.NdtMatcher(jm.NdtConfig(**cfg)), tm.NdtMatcher(tm.NdtConfig(**cfg),
                                                                   device="cpu")
    s = sim.scans[5]
    world = s.points @ s.gt_pose[:3, :3].T + s.gt_pose[:3, 3]
    mj_cloud, mt_cloud = clouds(world, 8192)
    sj = jmat.set_map(jmat.create_state(), mj_cloud)
    st = tmat.set_map(tmat.create_state(), mt_cloud)
    assert_map_matches(st.m, sj.m)
    assert bool(st.first_scan) and bool(sj.first_scan)
    assert int(ndt_map.num_estimated(st.m)) == int(ndt_map.num_occupied(st.m))
    cj, ct = clouds(sim.scans[6].points)
    pose = sim.scans[6].gt_pose.astype(np.float32)
    fj, ft = float(jmat.fitness(sj, cj, pose, 2.0)), float(tmat.fitness(st, ct, pose, 2.0))
    assert np.isfinite(fj) and 0 < fj < 1.0
    assert ft == pytest.approx(fj, rel=1e-4)


def rot_angle(a, b):
    dr = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))


def test_ndt_recovers_transform():
    """The port's mirror of tests/test_registration.py:194 (the same room,
    config, offset and gates)."""
    pts = room_scene(spacing=0.1, noise=0.02)
    cfg = tm.NdtConfig(voxel_size=1.0, source_filter_size=0.3, source_capacity=8192,
                       map_capacity=16384, min_points_in_voxel=3, res_outlier_thresh=50.0,
                       position_converge_thresh=0.002, rotation_converge_thresh=0.002)
    t_true = np.asarray(se3_exp(jnp.asarray(T_SMALL_V, jnp.float32)), np.float64)
    src = ((pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)
    m = tm.NdtMatcher(cfg, device="cpu")
    s = m.add_first(m.create_state(), clouds(pts, 16384)[1], torch.eye(4))
    _, res = m.match(s, clouds(src, 16384)[1], torch.eye(4))
    est = res.t_mat.numpy().astype(np.float64)
    assert bool(res.converged)
    assert np.linalg.norm(est[:3, 3] - t_true[:3, 3]) < 0.05 and rot_angle(est, t_true) < 0.02
