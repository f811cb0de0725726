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


# --- the LOAM family: sym3, the plane/line linearizations, the LOAM update,
# --- PointToPlaneMatcher and LoamFullMatcher -----------------------------

from funny_lidar_slam_tpu.ops import lin3 as jlin  # noqa: E402
from funny_lidar_slam_tpu.registration import gn as jgn  # noqa: E402
from funny_lidar_slam_torch.ops import lin3 as tlin  # noqa: E402
from funny_lidar_slam_torch.registration import gn as tgn  # noqa: E402


def five_point_covariances(rng, n):
    """Covariances of 5-point sets shaped like lines, planes and blobs, at
    scales from 1 cm to 1 m, plus exact repeated roots."""
    shapes = rng.integers(0, 3, n)
    pts = rng.normal(0, 1, (n, 5, 3))
    pts[shapes == 0, :, 1:] *= 0.05  # lines
    pts[shapes == 1, :, 2] *= 0.05  # planes
    rot = np.linalg.qr(rng.normal(0, 1, (n, 3, 3)))[0]
    pts = np.einsum("nij,nkj->nki", rot, pts) * rng.uniform(0.01, 1.0, (n, 1, 1))
    c = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("nka,nkb->nab", c, c) / 5.0
    cov[:8] = np.eye(3) * rng.uniform(0.1, 2.0, (8, 1, 1))  # triple roots
    cov[8:16] = np.diag([0.3, 0.3, 1.0])  # a double root below the largest
    return cov.astype(np.float32)


def test_sym3_matches_jax():
    """sym3_eigvalsh: the largest eigenvalue to 1e-5 relative; the smaller
    two to 2e-4 of the largest, which is as close as the f32 closed form
    gets to the true values in either package (arccos near +-1 loses the
    small roots of line-shaped covariances). sym3_principal_eigvec, wherever
    the largest eigenvalue is separated (gap > 1 % of it: otherwise the
    direction is not defined): to 1e-5 with the same sign where the 12
    power iterations converged, and to 1e-4 where the fixed start vector
    (1, 1, 1)/sqrt(3) is nearly orthogonal to the answer and they did not
    (both packages then return the same unconverged vector)."""
    cov = five_point_covariances(np.random.default_rng(21), 4096)
    lj = np.asarray(jlin.sym3_eigvalsh(jnp.asarray(cov)))
    lt = tlin.sym3_eigvalsh(torch.as_tensor(cov)).numpy()
    l64 = np.linalg.eigvalsh(cov.astype(np.float64))
    np.testing.assert_allclose(lt[:, 2], lj[:, 2], rtol=1e-5, atol=0)
    tol = np.broadcast_to(2e-4 * lj[:, 2:] + 1e-12, lj.shape)
    for got in (lt, lj):  # both packages, against each other and the truth
        np.testing.assert_array_less(np.abs(got - lj), tol)
        np.testing.assert_array_less(np.abs(got - l64), tol)
    np.testing.assert_array_equal(lt[:8], lj[:8])  # triple roots: the diagonal
    vj = np.asarray(jlin.sym3_principal_eigvec(jnp.asarray(cov)))
    vt = tlin.sym3_principal_eigvec(torch.as_tensor(cov)).numpy()
    sep = (lj[:, 2] - lj[:, 1]) > 1e-2 * lj[:, 2]
    true = np.linalg.eigh(cov.astype(np.float64))[1][..., 2]
    conv = sep & (np.abs(np.sum(vj * true, 1)) > 0.999)
    assert sep.sum() > 3000 and conv.sum() > 0.7 * sep.sum()
    np.testing.assert_allclose(vt[conv], vj[conv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(vt[sep], vj[sep], rtol=0, atol=1e-4)


@pytest.mark.parametrize("update", ["icp", "loam", "ndt"])
def test_apply_update_matches_jax(update):
    """The three update conventions (ICP [t, r] right, LOAM [r, t] left, NDT
    [r, t] right) from the same pose and step, to 1e-6."""
    rng = np.random.default_rng(3)
    t0 = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32)))
    for _ in range(8):
        dx = rng.normal(0, 0.1, 6).astype(np.float32)
        tj = np.asarray(jgn.apply_update(jnp.asarray(t0), jnp.asarray(dx), update))
        tt = tgn.apply_update(torch.as_tensor(t0), torch.as_tensor(dx), update).numpy()
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-6)
        # and the LOAM convention multiplies on the LEFT
        if update == "loam":
            r = np.asarray(jax.scipy.linalg.expm(jnp.asarray(hat(dx[:3]))))
            np.testing.assert_allclose(tt[:3, :3], r @ t0[:3, :3], rtol=0, atol=1e-5)
        t0 = tt


def hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float32)


def surface_cands(rng, n, m, kind, extent=1.5):
    """A candidate cache of `m` points per source point, near a plane or a
    line through the transformed source point, with 10 % of the lanes
    invalid and continuous coordinates (no distance ties). Source points lie
    1 to `extent` m from the origin. Each point draws one of two classes, so
    that every gate decides far from its threshold: a clean surface (noise 3
    or 10 mm, the point up to 5 cm off it) or a broken one (plane: a crease
    of two planes 60 degrees apart, the point 0.4-0.5 m off; line: an
    isotropic 30 cm blob)."""
    t_mat = np.asarray(se3_exp(jnp.asarray([0.4, -0.3, 0.1, 0.02, -0.01, 0.03],
                                           jnp.float32)))
    d = rng.normal(0, 1, (n, 3))
    src = (d / np.linalg.norm(d, axis=1, keepdims=True)
           * rng.uniform(1.0, extent, (n, 1))).astype(np.float32)
    p_t = src @ t_mat[:3, :3].T + t_mat[:3, 3]
    # the normal leans at most 30 degrees off the point's direction, so no
    # plane passes near the origin (where A x = -1 cannot hold it)
    lean = rng.normal(0, 1, (n, 3))
    w = p_t / np.linalg.norm(p_t, axis=1, keepdims=True)
    lean -= np.sum(lean * w, 1, keepdims=True) * w
    w = w + 0.577 * lean / np.linalg.norm(lean, axis=1, keepdims=True)
    frame = np.linalg.qr(np.stack([w, rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3))],
                                  -1))[0]
    w, u, v = (frame[:, None, :, k] for k in range(3))
    a, b = rng.uniform(-0.5, 0.5, (2, n, m, 1))
    broken = rng.random((n, 1, 1)) < 0.4
    off = np.where(broken, rng.uniform(0.4, 0.5, (n, 1, 1)), rng.uniform(-0.05, 0.05, (n, 1, 1)))
    if kind == "plane":
        bent = np.where(b > 0, 0.5 * b * w + 0.866 * b * v, b * v)  # the crease
        q = p_t[:, None] + off * w + a * u + np.where(broken, bent, b * v)
        noise = rng.choice([0.003, 0.01], (n, 1, 1))
    else:
        q = p_t[:, None] + off * v + a * u
        noise = np.where(broken, 0.3, rng.choice([0.003, 0.01], (n, 1, 1)))
    q = q + rng.normal(0, 1, q.shape) * noise
    valid = rng.random((n, m)) > 0.1
    q = np.where(valid[..., None], q, 0.0).astype(np.float32)
    src_mask = rng.random(n) > 0.05
    valid &= src_mask[:, None]
    cand = tres.CandSet(*(torch.as_tensor(x) for x in (q[..., 0], q[..., 1], q[..., 2],
                                                        valid, src, src_mask)))
    return t_mat.astype(np.float32), cand


@pytest.mark.parametrize("kind", ["plane", "line"])
def test_surface_hg_cand_matches_jax(kind):
    """point_to_plane_hg_cand / point_to_line_hg_cand on a tie-free
    candidate cache at two poses: the same gate decisions (num_valid equal),
    and H and the residual sum to 1e-4 of their largest entry (lines) or
    5e-4 (planes: the fitted normals differ in their fourth digit, see
    test_fit_plane_5nn_matches_jax), g to the same share of the residual
    sum. The points lie within 1.5 m of the origin, where the f32 plane fit
    is well conditioned."""
    rng = np.random.default_rng(31 if kind == "plane" else 32)
    t_mat, cand = surface_cands(rng, 2048, 16, kind)
    cj = jres.CandSet(*(jnp.asarray(x.numpy()) for x in cand))
    if kind == "plane":
        fj = lambda t: jres.point_to_plane_hg_cand(t, cj, 0.1, 1.0)  # noqa: E731
        ft = lambda t: tres.point_to_plane_hg_cand(t, cand, 0.1, 1.0)  # noqa: E731
    else:
        fj = lambda t: jres.point_to_line_hg_cand(t, cj, 3.0, 1.0)  # noqa: E731
        ft = lambda t: tres.point_to_line_hg_cand(t, cand, 3.0, 1.0)  # noqa: E731
    pert = np.asarray(se3_exp(jnp.asarray([0.02, 0.01, -0.01, 0.002, 0.001, -0.003],
                                          jnp.float32)))
    for t in (t_mat, (t_mat @ pert).astype(np.float32)):
        hj, ht = fj(jnp.asarray(t)), ft(torch.as_tensor(t))
        assert int(ht.num_valid) == int(hj.num_valid)
        assert 200 < int(hj.num_valid) < 1800  # the gates cut both ways
        tol = 5e-4 if kind == "plane" else 1e-4
        for f in ("h", "g", "total_res"):
            ref = np.asarray(getattr(hj, f))
            # g sums signed terms that cancel near the optimum: its scale is
            # the residual sum (|J| < 2 within 1.5 m)
            scale = float(hj.total_res) if f == "g" else np.abs(ref).max()
            np.testing.assert_allclose(getattr(ht, f).numpy(), ref, rtol=0, atol=tol * scale,
                                       err_msg=f)


def plane_gates_f64(nbrs, ok, thresh):
    """fit_plane_5nn's gate, solved in f64."""
    a = nbrs.astype(np.float64) * ok[..., None]
    coef = np.linalg.solve(np.einsum("nka,nkb->nab", a, a) + 1e-9 * np.eye(3),
                           -a.sum(1)[..., None])[..., 0]
    resid = np.abs(np.einsum("nka,na->nk", nbrs, coef) + 1.0) / np.linalg.norm(
        coef, axis=-1, keepdims=True)
    return np.all(ok & (resid <= thresh), -1)


@pytest.mark.parametrize("extent", [1.5, 20.0])
def test_fit_plane_5nn_matches_jax(extent):
    """The plane fit itself. It inverts A^T A of world coordinates in f32 by
    the adjugate, as the JAX package does. Within 1.5 m of the origin that is
    well conditioned: gates equal, anchors exact, normals to 1e-3. (Not
    closer: XLA on the CPU accumulates A^T A as a chain of fused
    multiply-adds, PyTorch rounds each product, and the adjugate amplifies
    that last bit to 1e-4-1e-3 in about 1 % of the normals.) At 20 m
    the determinant cancels: each package decides about 10 % of the fits
    differently from an f64 solve, so the port is held to the JAX
    package's own error (no more disagreements with f64, plus 5 %) and to
    at most 5 % of the fits decided differently from it."""
    rng = np.random.default_rng(33)
    _, cand = surface_cands(rng, 2048, 5, "plane", extent)
    nbrs = np.stack([cand.px.numpy(), cand.py.numpy(), cand.pz.numpy()], -1)
    ok = cand.valid.numpy()
    nj, qj, vj = jres.fit_plane_5nn(jnp.asarray(nbrs), jnp.asarray(ok), 0.1)
    nt, qt, vt = tres.fit_plane_5nn(torch.as_tensor(nbrs), torch.as_tensor(ok), 0.1)
    vj, vt = np.asarray(vj), vt.numpy()
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert 300 < vj.sum() < 1900
    if extent < 10.0:
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_allclose(nt.numpy()[vj], np.asarray(nj)[vj], rtol=0, atol=1e-3)
        return
    v64 = plane_gates_f64(nbrs, ok, 0.1)
    assert (vj != v64).sum() > 50  # the f32 fit is fragile here, in both packages
    assert (vt != v64).sum() <= 1.05 * (vj != v64).sum() + 0.05 * len(vj)
    assert (vt != vj).sum() <= 0.05 * len(vj)


# mirrors of tests/test_registration.py:131-193 on the port

def room_scene(spacing=0.25, size=8.0, noise=0.0, seed=0):
    """Floor and two walls, shifted off the origin (the plane fit's A x = -1
    cannot hold a plane through the origin)."""
    rng = np.random.default_rng(seed)
    g = np.arange(0.1, size, spacing, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    zero = np.zeros(xx.size)
    pts = np.concatenate([np.stack([xx.ravel(), yy.ravel(), zero], 1),
                          np.stack([xx.ravel(), zero, yy.ravel()], 1),
                          np.stack([zero, xx.ravel(), yy.ravel()], 1)]).astype(np.float32)
    if noise:
        pts += rng.normal(0, noise, pts.shape).astype(np.float32)
    return pts + np.asarray([3.0, 4.0, 5.0], np.float32)


def edge_scene(spacing=0.05, size=8.0, noise=0.0, seed=0):
    """The room's three edges, as lines of points."""
    g = np.arange(0.1, size, spacing, dtype=np.float32)
    z = np.zeros_like(g)
    pts = np.concatenate([np.stack([g, z, z], 1), np.stack([z, g, z], 1),
                          np.stack([z, z, g], 1)]).astype(np.float32)
    if noise:
        pts += np.random.default_rng(seed).normal(0, noise, pts.shape).astype(np.float32)
    return pts


T_SMALL_V = np.array([0.08, -0.05, 0.04, 0.01, 0.02, -0.015])


def as_cloud(pts, cap, lib=np):
    out = np.zeros((cap, 3), np.float32)
    out[: len(pts)] = pts[:cap]
    mask = np.arange(cap) < len(pts)
    if lib is jnp:
        return JCloud(jnp.asarray(out), jnp.asarray(mask))
    return TCloud(torch.as_tensor(out), torch.as_tensor(mask))


def t_small():
    return np.asarray(se3_exp(jnp.asarray(T_SMALL_V, jnp.float32)))


def body(pts, t_true):
    """World points seen from the pose t_true: T_true^-1 * pts."""
    return ((pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)


def pose_err(t_est, t_true):
    """(translation m, rotation rad) of t_est^-1 t_true."""
    d = np.linalg.inv(np.asarray(t_est, np.float64)) @ np.asarray(t_true, np.float64)
    return (np.linalg.norm(d[:3, 3]),
            np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))


P2PLANE_IVOX = dict(mode="ivox", source_capacity=4096, map_capacity=16384, bucket_size=8,
                    ivox_voxel_size=0.5, stencil="nearby18")
P2PLANE_WINDOW = dict(mode="window", source_capacity=4096, cloud_capacity=4096,
                      merged_capacity=8192, map_capacity=8192, local_map_size=5,
                      map_filter_size=0.25, ivox_voxel_size=0.5, stencil="nearby18")
LOAM_FULL = dict(corner_capacity=1024, planar_capacity=4096, merged_capacity=8192,
                 map_capacity=8192, nn_voxel_size=0.5, corner_filter_size=0.1,
                 planar_filter_size=0.25, point_search_thresh=1.0)


@pytest.mark.parametrize("cfg,tol", [(P2PLANE_IVOX, (0.02, 0.005)),
                                     (P2PLANE_WINDOW, (0.03, 0.01))],
                         ids=["ivox", "window"])
def test_point_to_plane_recovers_transform(cfg, tol):
    pts = room_scene()
    t_true = t_small()
    m = tm.PointToPlaneMatcher(tm.PointToPlaneConfig(**cfg), device="cpu")
    s = m.add_first(m.create_state(), as_cloud(pts, 4096), np.eye(4))
    s, res = m.match(s, as_cloud(body(pts, t_true), 4096), np.eye(4))
    tp, rp = pose_err(res.t_mat.numpy(), t_true)
    assert bool(res.converged)
    assert tp < tol[0] and rp < tol[1], (tp, rp)


def test_loam_full_recovers_transform():
    """corr_every=1 and no skip: the reference's search-every-iteration
    semantics (the noise-free grid makes the cached schedule tie-bound)."""
    planar, corner = room_scene(), edge_scene()
    t_true = t_small()
    m = tm.LoamFullMatcher(tm.LoamFullConfig(**LOAM_FULL, corr_every=1,
                                             regather_skip_dist=0.0), device="cpu")
    s = m.add_first(m.create_state(), as_cloud(corner, 1024), as_cloud(planar, 4096),
                    np.eye(4))
    s, res = m.match(s, as_cloud(body(corner, t_true), 1024),
                     as_cloud(body(planar, t_true), 4096), np.eye(4))
    tp, rp = pose_err(res.t_mat.numpy(), t_true)
    assert bool(res.converged)
    assert tp < 0.03 and rp < 0.01, (tp, rp)


MATCHERS = {
    "ivox": (jm.PointToPlaneMatcher, tm.PointToPlaneMatcher, jm.PointToPlaneConfig,
             tm.PointToPlaneConfig, P2PLANE_IVOX),
    "ivox_grid": (jm.PointToPlaneMatcher, tm.PointToPlaneMatcher, jm.PointToPlaneConfig,
                  tm.PointToPlaneConfig, dict(P2PLANE_IVOX, map_layout="grid",
                                              grid_dims=(16, 16, 12))),
    "window": (jm.PointToPlaneMatcher, tm.PointToPlaneMatcher, jm.PointToPlaneConfig,
               tm.PointToPlaneConfig, P2PLANE_WINDOW),
    "loam_full": (jm.LoamFullMatcher, tm.LoamFullMatcher, jm.LoamFullConfig,
                  tm.LoamFullConfig, LOAM_FULL),
}


def noisy_problem(kind, lib, near=False):
    """Noisy scenes (no distance ties): the map clouds and the source clouds
    seen from t_small(), as the matcher's add_first/match arguments. `near`:
    a 2 m room 0.6-1 m off the origin, where the f32 plane fit is well
    conditioned; else the 8 m room of tests/test_registration.py."""
    t_true = t_small()
    if near:
        planar = room_scene(spacing=0.07, size=2.0, noise=0.003, seed=1) - np.asarray(
            [2.4, 3.2, 4.0], np.float32)
        corner = edge_scene(size=2.0, noise=0.0015, seed=2)
    else:
        planar = room_scene(noise=0.01, seed=1)
        corner = edge_scene(noise=0.005, seed=2)
    clouds = [(planar, 4096)]
    if kind == "loam_full":
        clouds.insert(0, (corner, 1024))
    world = [as_cloud(p, c, lib) for p, c in clouds]
    src = [as_cloud(body(p, t_true), c, lib) for p, c in clouds]
    return world, src, t_true


def match_both(kind, near):
    """One match on each side from the same map state (the JAX add_first,
    carried across with convert.matcher_state) and the same guess."""
    jcls, tcls, jcfg, tcfg, cfg = MATCHERS[kind]
    jmat, tmat = jcls(jcfg(**cfg)), tcls(tcfg(**cfg), device="cpu")
    world_j, src_j, t_true = noisy_problem(kind, jnp, near)
    _, src_t, _ = noisy_problem(kind, np, near)
    sj = jmat.add_first(jmat.create_state(), *world_j, jnp.eye(4))
    st = convert.matcher_state(jax.device_get(sj))
    _, rj = jmat.match(sj, *src_j, jnp.eye(4))
    _, rt = tmat.match(st, *src_t, np.eye(4, dtype=np.float32))
    assert bool(rt.converged) == bool(rj.converged) is True
    assert int(rt.iters) == int(rj.iters)
    return rt, rj, t_true


@pytest.mark.parametrize("kind", ["window", "loam_full"])
def test_loam_match_matches_jax(kind):
    """PointToPlane_KdTree and LoamFull_KdTree, one match each on the near
    room: the poses within 1e-3 m and 1e-3 rad of the JAX result, the same
    convergence and gather count, valid plane matches within 2 %."""
    rt, rj, t_true = match_both(kind, near=True)
    tp, rp = pose_err(rt.t_mat.numpy(), np.asarray(rj.t_mat))
    assert tp < 1e-3 and rp < 1e-3, (tp, rp)
    assert abs(int(rt.num_valid) - int(rj.num_valid)) <= 0.02 * int(rj.num_valid)
    assert pose_err(rt.t_mat.numpy(), t_true)[0] < 0.02


@pytest.mark.parametrize("kind", ["ivox", "ivox_grid"])
def test_ivox_match_matches_jax(kind):
    """PointToPlane_IVOX on the 8 m room of tests/test_registration.py, on
    both map layouts. At 0.5 m voxels few points of a bucket survive the
    center policy, so each plane fit spans 4-13 m coordinates at a spread of
    a few decimetres, and its f32 adjugate decides most of the gates by
    rounding, in both packages (the JAX package's fused program keeps about
    20 % more of them than its own unfused ops do). So this holds the poses
    within 2e-3 m and 1e-3 rad, a fifth of the GN's 1 cm exit step, and the
    valid counts within 30 %."""
    rt, rj, t_true = match_both(kind, near=False)
    tp, rp = pose_err(rt.t_mat.numpy(), np.asarray(rj.t_mat))
    assert tp < 2e-3 and rp < 1e-3, (tp, rp)
    assert abs(int(rt.num_valid) - int(rj.num_valid)) <= 0.3 * int(rj.num_valid)
    assert pose_err(rt.t_mat.numpy(), t_true)[0] < 0.01


@pytest.mark.parametrize("kind", sorted(MATCHERS))
def test_loam_add_first_fitness_and_set_map_match_jax(kind):
    """add_first builds the same map (block bookkeeping and bucket sets),
    `fitness` at the true and at a shifted pose agrees to 1e-4 relative,
    and `set_map` builds the same map from one cloud."""
    jcls, tcls, jcfg, tcfg, cfg = MATCHERS[kind]
    jmat, tmat = jcls(jcfg(**cfg)), tcls(tcfg(**cfg), device="cpu")
    world_j, src_j, t_true = noisy_problem(kind, jnp)
    world_t, src_t, _ = noisy_problem(kind, np)
    sj = jmat.add_first(jmat.create_state(), *world_j, jnp.eye(4))
    st = tmat.add_first(tmat.create_state(), *world_t, np.eye(4, dtype=np.float32))

    def maps(s):
        if kind == "loam_full":
            return [s.corner.m, s.planar.m]
        return [s.w.m] if kind == "window" else [s.m]

    for mt_, mj_ in zip(maps(st), maps(sj)):
        if kind == "ivox_grid":
            np.testing.assert_array_equal(mt_.counts.numpy(), np.asarray(mj_.counts))
        else:
            assert_same_block_map(mt_, mj_)
    for off in (0.0, 0.3):
        pose = t_true.astype(np.float32).copy()
        pose[0, 3] += off
        fj = float(jmat.fitness(sj, src_j[-1], pose))
        ft = float(tmat.fitness(st, src_t[-1], pose))
        assert np.isfinite(fj) and ft == pytest.approx(fj, rel=1e-4)
    sj, st = jmat.set_map(sj, world_j[-1]), tmat.set_map(st, world_t[-1])
    for mt_, mj_ in zip(maps(st), maps(sj)):
        if kind == "ivox_grid":
            np.testing.assert_array_equal(mt_.counts.numpy(), np.asarray(mj_.counts))
        else:
            assert_same_block_map(mt_, mj_)


@pytest.mark.parametrize("kind", ["plane", "line"])
def test_one_shot_surface_hg_matches_jax(kind):
    """point_to_plane_hg / point_to_line_hg (gather by query_knn, fit and
    linearize at one pose) on the near room's LoamFull maps, carried across
    from the JAX add_first. Lines: the same valid count, H to 1e-4 of its
    largest entry and g to that share of the residual sum. Planes: the
    room's 5-neighbour patches span a decimetre 1-3 m from the origin, where
    the f32 adjugate already flips a few gates (see
    test_fit_plane_5nn_matches_jax), so valid counts within 0.5 % and H, g
    to 1e-2."""
    jmat = jm.LoamFullMatcher(jm.LoamFullConfig(**LOAM_FULL))
    world, src_j, t_true = noisy_problem("loam_full", jnp, near=True)
    _, src_t, _ = noisy_problem("loam_full", np, near=True)
    sj = jmat.add_first(jmat.create_state(), *world, jnp.eye(4))
    st = convert.matcher_state(jax.device_get(sj))
    pose = t_true.astype(np.float32)
    if kind == "plane":
        mj, mt, cj, ct, fj, ft = (sj.planar.m, st.planar.m, src_j[1], src_t[1],
                                  jres.point_to_plane_hg, tres.point_to_plane_hg)
        thresh, tol, count_tol = 0.1, 1e-2, 5e-3
    else:
        mj, mt, cj, ct, fj, ft = (sj.corner.m, st.corner.m, src_j[0], src_t[0],
                                  jres.point_to_line_hg, tres.point_to_line_hg)
        thresh, tol, count_tol = 3.0, 1e-4, 0.0
    hj = fj(jnp.asarray(pose), cj.points, cj.mask, mj, 2.0, thresh, 1.0)
    ht = ft(torch.as_tensor(pose), ct.points, ct.mask, mt, 2.0, thresh, 1.0)
    assert int(hj.num_valid) > 100
    assert abs(int(ht.num_valid) - int(hj.num_valid)) <= count_tol * int(hj.num_valid)
    for f in ("h", "g", "total_res"):
        ref = np.asarray(getattr(hj, f))
        scale = float(hj.total_res) if f == "g" else np.abs(ref).max()
        np.testing.assert_allclose(getattr(ht, f).numpy(), ref, rtol=0, atol=tol * scale,
                                   err_msg=f)
