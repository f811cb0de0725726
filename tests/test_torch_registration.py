"""Port parity: registration (residuals.gather_candidates on the dense grid
and on the hashed block map, the candidate-cache linearization,
gn.run_gn_corr, IcpMatcher.match, fitness_score and both window_add
policies) of funny_lidar_slam_torch against the JAX package, starting both
from the same map state carried across with funny_lidar_slam_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.cloud import Cloud as JCloud
from funny_lidar_slam_tpu.core.lie import se3_exp
from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.cloud import Cloud as TCloud
from funny_lidar_slam_torch.registration import matchers as tm
from funny_lidar_slam_torch.registration import residuals as tres

torch.set_num_threads(1)

CAP = 2048
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192,
           map_capacity=8192, local_map_size=20, group_capacity=2048,
           map_layout="grid", grid_dims=(48, 48, 12))


BLOCK_CFG = dict(CFG, map_layout="block")


@pytest.fixture(scope="module")
def dataset():
    return simulate(SimConfig(duration=4.2, points_per_scan=CAP, seed=11))


def make_scene(ds, cfg):
    """A map seeded from one simulator scan at its true pose, and a later
    scan with its true pose and a perturbed initial guess."""
    s0, s1 = ds.scans[0], ds.scans[12]
    jmat = jm.IcpMatcher(jm.IcpConfig(**cfg))
    state = jmat.add_first(jmat.create_state(), cloud(s0.points, jnp), s0.gt_pose)
    pert = np.asarray(se3_exp(jnp.asarray([0.08, -0.06, 0.03, 0.004, -0.003, 0.01],
                                          jnp.float32)))
    t_init = (s1.gt_pose @ pert).astype(np.float32)
    return jax.device_get(state), s1, t_init


@pytest.fixture(scope="module")
def scene(dataset):
    return make_scene(dataset, CFG)


@pytest.fixture(scope="module")
def block_scene(dataset):
    return make_scene(dataset, BLOCK_CFG)


def cloud(points, lib):
    pts = np.zeros((CAP, 3), np.float32)
    pts[: len(points)] = points[:CAP]
    mask = np.arange(CAP) < len(points)
    if lib is jnp:
        return JCloud(jnp.asarray(pts), jnp.asarray(mask))
    return TCloud(torch.as_tensor(pts), torch.as_tensor(mask))


@pytest.mark.parametrize("stencil", ["nearby26", "nearby6"])
def test_gather_candidates_and_linearization(scene, stencil):
    """Same rows (stable voxel sort on both sides), same valid counts, sorted
    candidate distances within the select tie window, and the normal
    equations of the re-selected NN within 1e-3 relative."""
    check_gather_and_linearization(scene, stencil)


@pytest.mark.parametrize("stencil", ["nearby26", "nearby18"])
def test_gather_candidates_block_map(block_scene, stencil):
    """The same contract on the hashed block map (probe + data rows)."""
    check_gather_and_linearization(block_scene, stencil)


def check_gather_and_linearization(scene, stencil):
    state, s1, t_init = scene
    src = cloud(s1.points, np)
    src_j = cloud(s1.points, jnp)
    cj = jres.gather_candidates(jnp.asarray(t_init), src_j.points, src_j.mask, state.m,
                                1.0, 16, stencil, 8, group_capacity=2048)
    mt = convert.any_map(state.m)
    ct = tres.gather_candidates(torch.as_tensor(t_init), src.points, src.mask, mt, 1.0, 16,
                                stencil, 8, group_capacity=2048)
    np.testing.assert_array_equal(ct.src.numpy(), np.asarray(cj.src))
    np.testing.assert_array_equal(ct.src_mask.numpy(), np.asarray(cj.src_mask))
    np.testing.assert_array_equal(ct.valid.numpy().sum(1), np.asarray(cj.valid).sum(1))
    pt = transform(t_init, ct.src.numpy())

    def d2(c):
        d = ((np.asarray(c.px) - pt[:, :1]) ** 2 + (np.asarray(c.py) - pt[:, 1:2]) ** 2
             + (np.asarray(c.pz) - pt[:, 2:]) ** 2)
        return np.sort(np.where(np.asarray(c.valid), d, np.inf), axis=1)

    a, b = d2(ct), d2(cj)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=2e-4, atol=1e-6)

    hj = jres.point_to_point_hg_cand(jnp.asarray(t_init), cj, 1.0)
    ht = tres.point_to_point_hg_cand(torch.as_tensor(t_init), ct, 1.0)
    assert int(ht.num_valid) == int(hj.num_valid) > 100
    for f in ("h", "g", "total_res"):
        ref = np.asarray(getattr(hj, f))
        np.testing.assert_allclose(getattr(ht, f).numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max(), err_msg=f)


def transform(t, p):
    return p @ t[:3, :3].T + t[:3, 3]


def test_icp_match_matches_jax(scene):
    """One IcpMatcher.match from the same state and initial guess: final
    pose within 1e-3 m / 1e-3 rad of the JAX result, the same convergence
    and gather count, and the same map afterwards (owner coords and counts)."""
    state, s1, t_init = scene
    jmat = jm.IcpMatcher(jm.IcpConfig(**CFG))
    sj, rj = jmat.match(jax.tree.map(jnp.asarray, state), cloud(s1.points, jnp), t_init)
    tmat = tm.IcpMatcher(tm.IcpConfig(**CFG), device="cpu")
    st, rt = tmat.match(convert.window_state(state), cloud(s1.points, np), t_init)
    assert bool(rt.converged) == bool(rj.converged) is True
    assert int(rt.iters) == int(rj.iters)
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 1e-3
    dr = pt[:3, :3].T @ pj[:3, :3]
    assert np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)) < 1e-3
    np.testing.assert_array_equal(st.m.bc.numpy(), np.asarray(sj.m.bc))
    np.testing.assert_array_equal(st.m.counts.numpy(), np.asarray(sj.m.counts))


@pytest.mark.parametrize("layout", ["block", "grid"])
def test_fitness_matches_jax(request, layout):
    """fitness_score at the true pose and at a pose 0.5 m off: the mean
    squared NN distance within 1e-4 relative, the K=1 query at gcap = N."""
    state, s1, _ = request.getfixturevalue("block_scene" if layout == "block" else "scene")
    src_j, src_t = cloud(s1.points, jnp), cloud(s1.points, np)
    m_t = convert.any_map(state.m)
    for off in (0.0, 0.5):
        pose = s1.gt_pose.astype(np.float32).copy()
        pose[0, 3] += off
        fj = float(jres.fitness_score(jnp.asarray(pose), src_j.points, src_j.mask, state.m,
                                      1.0, 4.0))
        ft = float(tres.fitness_score(torch.as_tensor(pose), src_t.points, src_t.mask, m_t,
                                      1.0, 4.0))
        assert np.isfinite(fj) and ft == pytest.approx(fj, rel=1e-4)
    fit_j = jm.IcpMatcher(jm.IcpConfig(**BLOCK_CFG)).fitness(
        jax.tree.map(jnp.asarray, state), src_j, s1.gt_pose, 2.0)
    fit_t = tm.IcpMatcher(tm.IcpConfig(**BLOCK_CFG), device="cpu").fitness(
        convert.window_state(state), src_t, s1.gt_pose, 2.0)
    if layout == "block":
        assert float(fit_t) == pytest.approx(float(fit_j), rel=1e-4)


def assert_same_block_map(mt, mj):
    """Bookkeeping exact; buckets below the bucket size hold the same point
    sets (which points survive an overflow depends on the sort order)."""
    np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
    for f in ("counts", "age", "epoch"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)))
    cnt, s, plane = np.asarray(mj.counts), mj.bucket_size, mj.plane
    tj, tt = np.asarray(mj.tab), mt.tab.numpy()
    for slot, loc in zip(*np.nonzero(cnt * (np.asarray(mj.fp) != 0)[:, None])):
        lanes = loc * s + np.arange(cnt[slot, loc])
        sets = [sorted(map(tuple, np.stack([t[slot, a * plane + lanes] for a in range(3)], 1)))
                for t in (tt, tj)]
        assert sets[0] == sets[1] or cnt[slot, loc] == s, (slot, loc)


@pytest.mark.parametrize("incremental", [True, False])
def test_window_add_policies_match_jax(dataset, incremental):
    """Four window_add calls on the hashed block map from the same clouds:
    the incremental insert (claim_rounds=2, max_age eviction) and the
    rebuild of the merged ring (window of 3 clouds, so the ring wraps)."""
    cfg = dict(BLOCK_CFG, incremental_map=incremental, local_map_size=3)
    jmat = jm.IcpMatcher(jm.IcpConfig(**cfg))
    tmat = tm.IcpMatcher(tm.IcpConfig(**cfg), device="cpu")
    sj, st = jmat.create_state(), tmat.create_state()
    window = 3 if incremental else 0
    for k in (0, 4, 9, 14):
        scan = dataset.scans[k]
        pose = scan.gt_pose.astype(np.float32)
        world = transform(pose, scan.points).astype(np.float32)
        wj, wt = cloud(world, jnp), cloud(world, np)
        sj = jm.window_add(sj, wj, jnp.asarray(pose), 0.4, 1.0, 8192, 8, window_size=window)
        st = tm.window_add(st, wt, torch.as_tensor(pose), 0.4, 1.0, 8192, 8,
                           window_size=window)
        assert_same_block_map(st.m, sj.m)
        for f in ("head", "filled", "window_mask"):
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
        np.testing.assert_allclose(st.window_pts.numpy(), np.asarray(sj.window_pts),
                                   rtol=0, atol=1e-5)
