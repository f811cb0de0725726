"""Port parity: the backend of funny_lidar_slam_torch (the SE(3) functions
of core/lie.py, backend/pose_graph.py, backend/loop_closure.py and the
plain registration.gn.run_gn) against the JAX package on the same inputs,
plus the port's mirrors of tests/test_backend.py.

Tolerances: the SE(3) functions f32 1e-5, f64 1e-10 (same closed forms,
different op order); edge residuals and Jacobians 1e-5 in f32; `optimize`
f64 poses 1e-8 of the JAX ones, f32 2e-3 m / 1e-3 rad (25 GN steps through
an f32 Cholesky of an equilibrated 384x384 system); the builder's arrays
exactly; .g2o numbers 1e-6; the NDT run_gn pose 1e-3 m / 1e-3 rad; the
loop verification 0.01 m between packages and fitnesses within 20 %."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.backend import loop_closure as jlc
from funny_lidar_slam_tpu.backend import pose_graph as jpg
from funny_lidar_slam_tpu.core import lie as jlie
from funny_lidar_slam_tpu.maps import ndt_map as jndt
from funny_lidar_slam_tpu.pipeline.keyframes import KeyFrame as JKeyFrame
from funny_lidar_slam_tpu.registration import gn as jgn
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.backend import loop_closure as tlc
from funny_lidar_slam_torch.backend import pose_graph as tpg
from funny_lidar_slam_torch.core import lie as tlie
from funny_lidar_slam_torch.maps import ndt_map as tndt
from funny_lidar_slam_torch.pipeline.keyframes import KeyFrame as TKeyFrame
from funny_lidar_slam_torch.registration import gn as tgn
from funny_lidar_slam_torch.registration import residuals as tres

from test_backend import circle_poses, room, rz
from test_registration import T_SMALL_V, room_scene

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "f64": (np.float64, jnp.float64, torch.float64, 1e-10)}


def tangents(n=256, seed=0, np_dtype=np.float64):
    """[translation, rotation] tangents with rotation norms < pi - 0.1."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1.0, (n, 6))
    rot = v[:, 3:]
    norm = np.linalg.norm(rot, axis=1, keepdims=True)
    v[:, 3:] = rot / norm * np.minimum(norm, np.pi - 0.1)
    v[0] = 0.0  # the small-angle branches
    v[1, 3:] = 1e-9
    return v.astype(np_dtype)


def both(jfn, tfn, *arrays, jd, td):
    j = np.asarray(jfn(*(jnp.asarray(a, jd) for a in arrays)))
    t = tfn(*(torch.as_tensor(np.array(a), dtype=td) for a in arrays)).numpy()
    return j, t


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", ["se3_exp", "se3_jl", "se3_jr", "se3_log", "se3_adj",
                                  "so3_vee", "quat_slerp"])
def test_se3_and_quat_functions(name, dt):
    npd, jd, td, tol = DTYPES[dt]
    v = tangents(np_dtype=npd)
    mats = np.asarray(jlie.se3_exp(jnp.asarray(v, jd)))
    if name in ("se3_exp", "se3_jl", "se3_jr"):
        args = (v,)
    elif name in ("se3_log", "se3_adj"):
        args = (mats,)
    elif name == "so3_vee":
        args = (np.asarray(jlie.so3_hat(jnp.asarray(v[:, 3:], jd))),)
    else:
        q0 = np.asarray(jlie.mat_to_quat(jnp.asarray(mats[:, :3, :3])))
        t = np.random.default_rng(1).uniform(0, 1, len(v)).astype(npd)
        args = (q0, q0[::-1].copy(), t)
    j, t = both(getattr(jlie, name), getattr(tlie, name), *args, jd=jd, td=td)
    np.testing.assert_allclose(t, j, atol=tol, rtol=0)


def test_quat_slerp_endpoints():
    """The port's mirror of tests/test_lie.py:173-182."""
    qa = tlie.mat_to_quat(tlie.so3_exp(torch.zeros(3, dtype=torch.float64)))
    qb = tlie.mat_to_quat(tlie.so3_exp(torch.tensor([np.pi / 2, 0.0, 0.0], dtype=torch.float64)))
    for t, ref in ((0.0, qa), (1.0, qb)):
        q = tlie.quat_slerp(qa, qb, torch.tensor(t, dtype=torch.float64))
        np.testing.assert_allclose(q.numpy(), ref.numpy(), atol=1e-9)
    qm = tlie.quat_slerp(qa, qb, torch.tensor(0.5, dtype=torch.float64))
    ref = tlie.so3_exp(torch.tensor([np.pi / 4, 0.0, 0.0], dtype=torch.float64))
    np.testing.assert_allclose(tlie.quat_to_mat(qm).numpy(), ref.numpy(), atol=1e-9)


# --- pose graph ---------------------------------------------------------------

def noisy_circle(builder_cls, seed=0, n=60, k_cap=64, e_cap=128):
    """tests/test_backend.py:29-51: a drifting odometry chain around a
    60-pose circle and one strong loop edge with the true relative pose."""
    rng = np.random.default_rng(seed)
    gt = circle_poses(n)
    b = builder_cls(k_cap=k_cap, e_cap=e_cap)
    acc = gt[0].copy()
    b.add_vertex(acc)
    for k in range(1, n):
        noise = np.eye(4)
        noise[:3, 3] = rng.normal(0, 0.02, 3)
        noise[:3, :3] = rz(rng.normal(0, 0.005))
        acc = acc @ (np.linalg.inv(gt[k - 1]) @ gt[k]) @ noise
        b.add_vertex(acc)
    b.add_edge(n - 1, 0, np.linalg.inv(gt[n - 1]) @ gt[0], (1e4, 1e4, 1e4, 1e6, 1e6, 1e6))
    return b, gt


def builder_arrays(b):
    return {f: getattr(b, f) for f in ("poses", "pose_mask", "edge_i", "edge_j", "edge_meas",
                                       "edge_info", "edge_mask", "n_vertices", "n_edges",
                                       "k_cap", "e_cap")}


def test_builder_matches_jax_with_growth():
    """The same calls, past both capacities (vertices 4 -> 64, edges 4 ->
    64), with and without odometry measurements: every array equal."""
    rng = np.random.default_rng(3)
    bj, bt = jpg.PoseGraphBuilder(k_cap=4, e_cap=4), tpg.PoseGraphBuilder(k_cap=4, e_cap=4)
    prev = np.eye(4)
    for k in range(40):
        pose = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6))))
        odom = None if k % 3 == 0 else np.linalg.inv(prev) @ pose
        for b in (bj, bt):
            assert b.add_vertex(pose, odom) == k
        prev = pose
        if k % 7 == 6:
            for b in (bj, bt):
                b.add_edge(k, k - 5, np.linalg.inv(pose), (1e2, 1e2, 1e2, 1e4, 1e4, 1e4))
    aj, at = builder_arrays(bj), builder_arrays(bt)
    assert at["k_cap"] == 64 and at["e_cap"] == 64
    for f in aj:
        np.testing.assert_array_equal(at[f], aj[f], err_msg=f)
        assert np.asarray(at[f]).dtype == np.asarray(aj[f]).dtype, f
    poses = np.asarray(jpg.optimize(bj.to_device(jnp.float32), iterations=2).poses)
    for b in (bj, bt):
        b.set_poses(poses)
    np.testing.assert_array_equal(bt.poses, bj.poses)


def test_edge_residuals_match_jax():
    b, _ = noisy_circle(jpg.PoseGraphBuilder)
    gj = b.to_device(jnp.float32)
    gt = convert.pose_graph(jax_numpy(gj))
    assert gt.poses.dtype == torch.float32 and gt.edge_i.dtype == torch.int32
    for j, t in zip(jpg._edge_residuals(gj), tpg._edge_residuals(gt)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def jax_numpy(g):
    return type(g)(*(np.asarray(a) for a in g))


def pose_errors(a, b):
    """Max translation (m) and rotation (rad) differences of [K, 4, 4]
    poses; the rotation as |Ra - Rb|_F / sqrt(2), the small-angle measure
    (an arccos of the trace would read the f32 poses' departure from
    orthonormality, ~1e-7, as 4e-4 rad)."""
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    dr = np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2)) / np.sqrt(2.0)
    return dt.max(), dr.max()


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_optimize_circle_matches_jax(dt):
    """optimize on the 60-pose noisy circle, 25 iterations: f64 poses within
    1e-8 of the JAX ones, f32 within 2e-3 m / 1e-3 rad; the port alone meets
    tests/test_backend.py's three gates."""
    _, jd, td, _ = DTYPES[dt]
    b, gt = noisy_circle(tpg.PoseGraphBuilder)
    jb, _ = noisy_circle(jpg.PoseGraphBuilder)
    drift_before = np.linalg.norm(b.poses[59][:3, 3] - gt[59][:3, 3])
    pj = np.asarray(jpg.optimize(jb.to_device(jd), iterations=25).poses, np.float64)[:60]
    g = tpg.optimize(b.to_device(td, device="cpu"), iterations=25)
    out = g.poses.numpy().astype(np.float64)[:60]
    assert g.poses.dtype == td
    if dt == "f64":
        np.testing.assert_allclose(out, pj, atol=1e-8, rtol=0)
    else:
        dpos, drot = pose_errors(out, pj)
        assert dpos < 2e-3 and drot < 1e-3, (dpos, drot)
    assert np.linalg.norm(out[59][:3, 3] - gt[59][:3, 3]) < drift_before * 0.5
    rel = np.linalg.inv(out[59]) @ out[0]
    loop_rel = np.linalg.inv(gt[59]) @ gt[0]
    assert np.linalg.norm(rel[:3, 3] - loop_rel[:3, 3]) < 1e-2
    assert np.mean(np.linalg.norm(out[:, :3, 3] - gt[:, :3, 3], axis=1)) < 0.5


def test_optimize_leaves_vertex_zero_and_unused_vertices():
    b, _ = noisy_circle(tpg.PoseGraphBuilder)
    g0 = b.to_device(torch.float64, device="cpu")
    g = tpg.optimize(g0, iterations=3)
    np.testing.assert_array_equal(g.poses[0].numpy(), g0.poses[0].numpy())
    np.testing.assert_array_equal(g.poses[60:].numpy(), g0.poses[60:].numpy())


def parse_g2o(path):
    rows = []
    with open(path) as f:
        for line in f:
            tag, *nums = line.split()
            rows.append((tag, np.asarray(nums, np.float64)))
    return rows


def test_save_g2o_matches_jax(tmp_path):
    bj, _ = noisy_circle(jpg.PoseGraphBuilder)
    bt, _ = noisy_circle(tpg.PoseGraphBuilder)
    bj.save_g2o(str(tmp_path / "j.g2o"))
    bt.save_g2o(str(tmp_path / "t.g2o"))
    rj, rt = parse_g2o(tmp_path / "j.g2o"), parse_g2o(tmp_path / "t.g2o")
    assert [r[0] for r in rt] == [r[0] for r in rj]
    assert sum(r[0] == "VERTEX_SE3:QUAT" for r in rt) == 60
    assert sum(r[0] == "EDGE_SE3:QUAT" for r in rt) == 60
    for (_, a), (_, b) in zip(rt, rj):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


# --- loop closure -------------------------------------------------------------

def test_detect_by_distance_matches_jax():
    """tests/test_backend.py:66-78's inputs, and every keyframe as the
    current one: identical candidates."""
    kw = dict(skip_near_loopclosure=10, skip_near_keyframe=100)
    cj, ct = jlc.LoopClosureConfig(**kw), tlc.LoopClosureConfig(**kw)
    poses = circle_poses(126, radius=20.0)
    poses = np.concatenate([poses, poses[:10]])
    far = poses.copy()
    far[130, :3, 3] = [500, 500, 0]
    cases = [(poses, cur, -100) for cur in range(len(poses))]
    cases += [(poses, 130, 125), (far, 130, -100)]
    found = 0
    for p, cur, last in cases:
        got = tlc.detect_by_distance(p, cur, last, ct)
        assert got == jlc.detect_by_distance(p, cur, last, cj), cur
        found += got is not None
    assert found > 0
    assert tlc.detect_by_distance(poses, 130, -100, ct) is not None
    assert tlc.detect_by_distance(poses, 130, 125, ct) is None
    assert tlc.detect_by_distance(far, 130, -100, ct) is None


def test_run_gn_ndt_matches_jax():
    """The plain run_gn with ndt_hg (the verification's NDT stage) on a
    seeded room from a perturbed guess: the same gathers and convergence,
    the pose within 1e-3 m / 1e-3 rad of the JAX one. (A single 1 m stage
    does not reach the truth here in either package; the verification's
    cascade keeps a stage only where it improves the fitness.)"""
    pts = room_scene(spacing=0.15, noise=0.02)
    n = len(pts)
    t_true = np.asarray(jlie.se3_exp(jnp.asarray(T_SMALL_V, jnp.float32)), np.float64)
    src = ((pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)
    cap = 16384
    pad = np.zeros((cap, 3), np.float32)
    tgt_p, src_p = pad.copy(), pad.copy()
    tgt_p[:n], src_p[:n] = pts, src
    mask = np.arange(cap) < n
    cfg = dict(max_iters=20, rotation_eps=1e-3, position_eps=1e-3, use_stall_check=False)
    mj = jndt.insert(jndt.create(cap), jnp.asarray(tgt_p), jnp.asarray(mask), 1.0, min_points=3,
                     estimate_all=True, claim_rounds=8)
    mt = tndt.insert(tndt.create(cap), torch.from_numpy(tgt_p), torch.from_numpy(mask), 1.0,
                     min_points=3, estimate_all=True, claim_rounds=8)
    rj = jgn.run_gn(lambda t: jres.ndt_hg(t, jnp.asarray(src_p), jnp.asarray(mask), mj, 1.0,
                                          30.0),
                    jnp.eye(4, dtype=jnp.float32), jgn.GNConfig(update=jgn.UPDATE_NDT, **cfg))
    rt = tgn.run_gn(lambda t: tres.ndt_hg(t, torch.from_numpy(src_p), torch.from_numpy(mask),
                                          mt, 1.0, 30.0),
                    torch.eye(4), tgn.GNConfig(update=tgn.UPDATE_NDT, **cfg))
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.iters) == int(rj.iters)
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    dpos, drot = pose_errors(pt[None], pj[None])
    assert dpos < 1e-3 and drot < 1e-3, (dpos, drot)


VERIFY_CFG = dict(candidate_left=0, candidate_right=0, current_left=0, submap_capacity=16384,
                  source_capacity=8192, map_capacity=32768, ndt_resolutions=(4.0, 2.0),
                  fitness_threshold=1.5)


def drifted_room():
    """tests/test_backend.py:92-121: the candidate keyframe holds the room
    in the world frame, the current one in its own frame, and its pose has
    drifted by (0.6, -0.4, 0.1) m."""
    world = room()
    true_pose = np.eye(4)
    true_pose[:3, 3] = [1.0, 0.5, 0.2]
    true_pose[:3, :3] = rz(0.05)
    inv_t = np.linalg.inv(true_pose)
    local = (world @ inv_t[:3, :3].T + inv_t[:3, 3]).astype(np.float32)
    drifted = true_pose.copy()
    drifted[:3, 3] += [0.6, -0.4, 0.1]
    return world, local, true_pose, np.stack([np.eye(4), drifted])


def test_verify_candidate_matches_jax(monkeypatch):
    monkeypatch.setenv("FLS_AOT_CACHE", "0")  # plain jit: no executable cache on disk
    world, local, true_pose, poses = drifted_room()
    fj = [JKeyFrame(0, 0.0, np.eye(4), world), JKeyFrame(1, 1.0, true_pose, local)]
    ft = [TKeyFrame(0, 0.0, np.eye(4), world), TKeyFrame(1, 1.0, true_pose, local)]
    rj = jlc.verify_candidate(fj, poses, 1, 0, jlc.LoopClosureConfig(**VERIFY_CFG))
    rt = tlc.verify_candidate(ft, poses, 1, 0, tlc.LoopClosureConfig(**VERIFY_CFG),
                              device="cpu")
    assert rj is not None and rt is not None, "a package rejected a true loop"
    assert (rt.current_id, rt.candidate_id) == (1, 0)
    tj, tt = poses[0] @ rj.delta_pose, poses[0] @ rt.delta_pose
    for t in (tj, tt):
        assert np.linalg.norm(t[:3, 3] - true_pose[:3, 3]) < 0.1, t
    assert np.linalg.norm(tt[:3, 3] - tj[:3, 3]) < 0.01
    assert rt.fitness < 0.5 and rj.fitness < 0.5
    assert rt.fitness == pytest.approx(rj.fitness, rel=0.2)


def test_loop_closer_throttles_and_accepts():
    """LoopCloser on the drifted room: no candidate inside the index gap,
    then an accepted loop that arms the throttle."""
    world, local, true_pose, poses = drifted_room()
    frames = [TKeyFrame(0, 0.0, np.eye(4), world), TKeyFrame(1, 1.0, true_pose, local)]
    cfg = tlc.LoopClosureConfig(skip_near_loopclosure=1, skip_near_keyframe=0,
                                near_neighbor_distance=5.0, **VERIFY_CFG)
    closer = tlc.LoopCloser(cfg, device="cpu")
    assert closer.try_close(frames, poses, 0) is None  # nothing older than itself
    res = closer.try_close(frames, poses, 1)
    assert res is not None and res.candidate_id == 0 and closer.last_loop_id == 1
    assert closer.try_close(frames, poses, 1) is None  # throttled


def test_convert_pose_graph_roundtrip():
    b, _ = noisy_circle(tpg.PoseGraphBuilder)
    g = b.to_device(torch.float32, device="cpu")
    back = convert.pose_graph(convert.to_numpy(g))
    for a, c in zip(g, back):
        assert torch.equal(a, c)


def test_figure8_simulation_matches_jax():
    """The port's copy of the simulator's figure-8 (chip phase 13's
    trajectory) gives the JAX package's dataset exactly."""
    from funny_lidar_slam_tpu.io import simulator as jsim
    from funny_lidar_slam_torch.io import simulator as tsim

    kw = dict(amp_x=18.0, amp_y=9.0, omega=0.35, z_amp=0.3, z_freq=0.5)
    cfg = dict(duration=3.2, points_per_scan=512, seed=11)
    dj = jsim.simulate(jsim.SimConfig(**cfg), traj=jsim.Figure8Trajectory(**kw))
    dt = tsim.simulate(tsim.SimConfig(**cfg), traj=tsim.Figure8Trajectory(**kw))
    for name in ("imu_t", "imu_gyro", "imu_accel", "gt_times", "gt_poses"):
        np.testing.assert_array_equal(getattr(dt, name), getattr(dj, name))
    assert len(dt.scans) == len(dj.scans) > 0
    for sj, st in zip(dj.scans, dt.scans):
        assert st.t == sj.t
        np.testing.assert_array_equal(st.points, sj.points)
        np.testing.assert_array_equal(st.rel_times, sj.rel_times)
