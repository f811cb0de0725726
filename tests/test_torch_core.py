"""Port parity: core/lie.py, ops/voxel.py and ops/lin3.py of
funny_lidar_slam_torch against the JAX package on the same inputs.

Inputs are made with NumPy from a seed and handed to both. Tolerances:
f64 1e-10 (same closed forms, different op order), f32 2e-5 absolute on
unit-scale outputs (a few ulps of float32 through a handful of ops)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funny_lidar_slam_tpu.core import lie as jlie
from funny_lidar_slam_tpu.ops import lin3 as jlin3
from funny_lidar_slam_tpu.ops import voxel as jvoxel
from funny_lidar_slam_torch.core import lie as tlie
from funny_lidar_slam_torch.ops import lin3 as tlin3
from funny_lidar_slam_torch.ops import voxel as tvoxel

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "f64": (np.float64, jnp.float64, torch.float64, 1e-10)}


def _vecs(n, scale, seed, np_dtype):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, scale, (n, 3)).astype(np_dtype)
    v[0] = 0.0  # exact zero: the small-angle branch
    v[1] = 1e-9  # below the Taylor threshold
    return v


def _both(jfn, tfn, *arrays, jd, td):
    j = np.asarray(jfn(*(jnp.asarray(a, jd) for a in arrays)))
    t = tfn(*(torch.as_tensor(np.array(a), dtype=td) for a in arrays)).numpy()
    return j, t


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", ["so3_hat", "so3_exp", "so3_jr", "so3_jr_inv"])
def test_so3_vector_functions(name, dt):
    npd, jd, td, tol = DTYPES[dt]
    v = _vecs(64, 0.8, 0, npd)
    j, t = _both(getattr(jlie, name), getattr(tlie, name), v, jd=jd, td=td)
    np.testing.assert_allclose(t, j, atol=tol, rtol=0)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_so3_log_roundtrip_and_rpy(dt):
    npd, jd, td, tol = DTYPES[dt]
    v = _vecs(64, 0.8, 1, npd)
    r = np.asarray(jlie.so3_exp(jnp.asarray(v, jd)))
    j, t = _both(jlie.so3_log, tlie.so3_log, r, jd=jd, td=td)
    np.testing.assert_allclose(t, j, atol=10 * tol, rtol=0)
    j, t = _both(jlie.rotation_to_rpy, tlie.rotation_to_rpy, r, jd=jd, td=td)
    np.testing.assert_allclose(t, j, atol=10 * tol, rtol=0)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_quaternion_functions(dt):
    npd, jd, td, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    q0 = rng.normal(size=(32, 4)).astype(npd)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q1 = rng.normal(size=(32, 4)).astype(npd)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    s = rng.uniform(0, 1, 32).astype(npd)
    for jf, tf, args in ((jlie.quat_to_mat, tlie.quat_to_mat, (q0,)),
                         (jlie.quat_mul, tlie.quat_mul, (q0, q1)),
                         (jlie.quat_conj, tlie.quat_conj, (q0,)),
                         (jlie.quat_nlerp, tlie.quat_nlerp, (q0, q1, s))):
        j, t = _both(jf, tf, *args, jd=jd, td=td)
        np.testing.assert_allclose(t, j, atol=tol, rtol=0)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_se3_make_and_inverse(dt):
    npd, jd, td, tol = DTYPES[dt]
    v = _vecs(16, 0.5, 3, npd)
    r = np.asarray(jlie.so3_exp(jnp.asarray(v, jd)))
    p = np.random.default_rng(3).normal(0, 5, (16, 3)).astype(npd)
    j, t = _both(jlie.make_se3, tlie.make_se3, r, p, jd=jd, td=td)
    np.testing.assert_array_equal(t, j)
    j, t = _both(jlie.se3_inv, tlie.se3_inv, j, jd=jd, td=td)
    np.testing.assert_allclose(t, j, atol=10 * tol, rtol=0)


def test_marginalize_f32():
    """Schur complement of a random SPD 30x30 with the magnitudes of the
    fusion prior; relative tolerance 1e-3 of the largest entry (an f32 SVD
    pseudo-inverse on both sides)."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(30, 30))
    scale = np.exp(rng.uniform(np.log(1e2), np.log(1e6), 30))
    h = ((a @ a.T + 30 * np.eye(30)) * np.sqrt(scale)[:, None] * np.sqrt(scale)[None, :])
    h = h.astype(np.float32)
    j = np.asarray(jlie.marginalize(jnp.asarray(h, jnp.float32), 0, 14))
    t = tlie.marginalize(torch.as_tensor(h), 0, 14).numpy()
    np.testing.assert_allclose(t, j, atol=1e-3 * np.abs(j).max(), rtol=0)
    assert np.all(t[:15] == 0) and np.all(t[:, :15] == 0)


def test_inv3_and_solve6_damped():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(20, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tlin3.inv3(torch.as_tensor(a)).numpy(),
                               np.asarray(jlin3.inv3(jnp.asarray(a))), rtol=1e-4, atol=1e-4)
    j = rng.normal(size=(200, 6)).astype(np.float32)
    h = j.T @ j
    g = rng.normal(size=6).astype(np.float32)
    x_j = np.asarray(jlin3.solve6_damped(jnp.asarray(h), jnp.asarray(g)))
    x_t = tlin3.solve6_damped(torch.as_tensor(h), torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-6)


def _cloud(n, seed, extent=6.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    pts[: n // 4] = np.round(pts[: n // 4])  # points exactly on voxel faces
    mask = rng.uniform(size=n) < 0.8
    return pts, mask


def test_group_by_voxel_matches_jax():
    """Both sorts are stable on this input (XLA's CPU sort preserves the
    index order of equal keys), so the permutation itself must agree."""
    pts, mask = _cloud(3000, 6)
    gj = jvoxel.group_by_voxel(jnp.asarray(pts), jnp.asarray(mask), 1.0)
    gt = tvoxel.group_by_voxel(torch.as_tensor(pts), torch.as_tensor(mask), 1.0)
    assert int(gt.num_groups) == int(gj.num_groups)
    valid = np.asarray(gj.sorted_mask)
    np.testing.assert_array_equal(gt.sorted_mask.numpy(), valid)
    for f in ("order", "group_id", "rank", "group_coords", "sorted_pts"):
        np.testing.assert_array_equal(getattr(gt, f).numpy()[valid],
                                      np.asarray(getattr(gj, f))[valid], err_msg=f)


@pytest.mark.parametrize("capacity", [4096, 256])
def test_voxel_downsample_matches_jax(capacity):
    """Centroids row by row in the shared voxel order (1e-6 m: the same
    points summed in one order); capacity 256 < groups exercises the
    dropped-group path."""
    pts, mask = _cloud(3000, 7)
    dj = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.5, capacity)
    dt = tvoxel.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask), 0.5, capacity)
    mj = np.asarray(dj.mask)
    np.testing.assert_array_equal(dt.mask.numpy(), mj)
    np.testing.assert_allclose(dt.points.numpy()[mj], np.asarray(dj.points)[mj], atol=1e-6)
