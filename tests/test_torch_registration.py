"""Port parity: registration (residuals.gather_candidates, the candidate-cache
linearization, gn.run_gn_corr and IcpMatcher.match) of funny_lidar_slam_torch
against the JAX package, starting both from the same map state carried
across with funny_lidar_slam_torch.convert."""

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


@pytest.fixture(scope="module")
def scene():
    """A map seeded from one simulator scan at its true pose, and a later
    scan with its true pose and a perturbed initial guess."""
    ds = simulate(SimConfig(duration=4.2, points_per_scan=CAP, seed=11))
    s0, s1 = ds.scans[0], ds.scans[12]
    jmat = jm.IcpMatcher(jm.IcpConfig(**CFG))
    state = jmat.add_first(jmat.create_state(), cloud(s0.points, jnp), s0.gt_pose)
    pert = np.asarray(se3_exp(jnp.asarray([0.08, -0.06, 0.03, 0.004, -0.003, 0.01],
                                          jnp.float32)))
    t_init = (s1.gt_pose @ pert).astype(np.float32)
    return jax.device_get(state), s1, t_init


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
    state, s1, t_init = scene
    src = cloud(s1.points, np)
    src_j = cloud(s1.points, jnp)
    cj = jres.gather_candidates(jnp.asarray(t_init), src_j.points, src_j.mask, state.m,
                                1.0, 16, stencil, 8, group_capacity=2048)
    mt = convert.grid_map(state.m)
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
