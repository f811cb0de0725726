"""Port parity: the region-sharded map with halo exchange
(parallel/sharded_map.py) and the data-parallel ICP step
(parallel/sharded_gn.py) of funny_lidar_slam_torch against the JAX
package: at one rank in process against a 1-device JAX mesh, and at four
gloo ranks (subprocesses, each with a timeout) against a 4-device JAX mesh
over the virtual CPU devices.

Tolerances: `tile_owner` and `in_region_or_halo` exactly; each rank's map
bookkeeping (fingerprints, counts) exactly on the low-load scene of
tests/test_distributed_backend.py (no overfull voxel, no lost claim);
poses 1e-4 (the JAX test's tolerance: the same per-point contributions
summed in another order). The halo bound is a real assertion here: the
blocks stored over all ranks lie within [1, 3] x the blocks of one
replicated map of the same points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.backend.distributed import make_mesh as jax_mesh
from funny_lidar_slam_tpu.maps import voxel_hash as jvh
from funny_lidar_slam_tpu.parallel import sharded_gn as jsgn
from funny_lidar_slam_tpu.parallel import sharded_map as jsm
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.lie import se3_exp
from funny_lidar_slam_torch.maps import block_map as tbm
from funny_lidar_slam_torch.maps import voxel_hash as tvh
from funny_lidar_slam_torch.ops.lin3 import solve6_damped
from funny_lidar_slam_torch.parallel import comm
from funny_lidar_slam_torch.parallel import sharded_gn as tsgn
from funny_lidar_slam_torch.parallel import sharded_map as tsm
from funny_lidar_slam_torch.registration.gn import UPDATE_ICP, apply_update
from funny_lidar_slam_torch.registration.residuals import point_to_point_hg

from test_torch_distributed import run_ranks

torch.set_num_threads(1)

# tests/test_distributed_backend.py's low-load scene: no bucket overflow,
# block table well under 0.3 load
CFG = dict(tile_size=8.0, voxel_size=1.0, map_capacity=32768)
T_TRUE = [0.12, -0.1, 0.05, 0.02, -0.01, 0.03]
RESIDUALS = ("point_to_point", "point_to_plane")


def scene():
    rng = np.random.default_rng(1)
    map_pts = np.concatenate([rng.uniform(0, 40.0, (6144, 2)),
                              rng.uniform(0, 8.0, (6144, 1))], axis=1).astype(np.float32)
    t_true = se3_exp(torch.tensor(T_TRUE)).numpy()
    src = ((map_pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)
    return map_pts, src, t_true


def plane_scene():
    """A floor and two walls within 2 m of the origin, none through it,
    where the f32 plane fits (n.p = -1) are well conditioned (ROADMAP
    Queue 3), on a 0.5 m grid (at most 4 points a voxel), for the
    point-to-plane step. It spans the four tiles around the origin."""
    g = np.arange(-1.45, 1.5, 0.5, dtype=np.float32)
    h = np.arange(-0.95, 0.6, 0.5, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    ll, hh = np.meshgrid(g, h)
    pts = np.concatenate([
        np.stack([xx.ravel(), yy.ravel(), np.full(xx.size, -1.2)], 1),
        np.stack([ll.ravel(), np.full(ll.size, 1.3), hh.ravel()], 1),
        np.stack([np.full(ll.size, 1.3), ll.ravel(), hh.ravel()], 1)]).astype(np.float32)
    t_true = se3_exp(torch.tensor(T_TRUE)).numpy()
    return pts, ((pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)


# The point-to-plane step runs one iteration: the JAX sharded_gn_step applies
# the ICP update ([t, r]) to the point-to-plane solution ([r, t]) and so
# does not converge (ROADMAP Queue 3); the port keeps that update.


def jax_run(n_dev):
    """The JAX package's sharded map, GN steps and ICP step on n_dev devices."""
    map_pts, src, _ = scene()
    mesh = jax_mesh(jax.devices()[:n_dev])
    cfg = jsm.ShardedMapConfig(**CFG)
    msk = jnp.ones(len(map_pts), bool)
    sm = jsm.insert_sharded(mesh, cfg)(jsm.create_sharded(mesh, cfg), jnp.asarray(map_pts), msk)
    eye = jnp.eye(4, dtype=jnp.float32)
    out = {"map": jax.device_get(sm), "occ": np.asarray(jsm.shard_occupancy(sm))}
    step = jsm.sharded_gn_step(mesh, cfg, max_corr_dist_sq=1.0, iters=8)
    out["point_to_point"] = np.asarray(step(sm, jnp.asarray(src), msk, eye))
    plane_pts, plane_src = (jnp.asarray(a) for a in plane_scene())
    pmsk = jnp.ones(len(plane_pts), bool)
    sm = jsm.insert_sharded(mesh, cfg)(jsm.create_sharded(mesh, cfg), plane_pts, pmsk)
    step = jsm.sharded_gn_step(mesh, cfg, max_corr_dist_sq=1.0, iters=1,
                               residual="point_to_plane")
    out["point_to_plane"] = np.asarray(step(sm, plane_src, pmsk, eye))
    vh = jvh.build(16384, 8, jnp.asarray(map_pts), msk, 1.0)
    icp = jsgn.sharded_icp_step(jsgn.make_mesh(jax.devices()[:n_dev]), max_corr_dist_sq=1.0,
                                inv_voxel_size=1.0, iters=8)
    out["icp"] = np.asarray(icp(vh, jnp.asarray(src), msk, eye))
    return out


def port_run(mesh):
    """The port's counterpart of `jax_run` on this rank of `mesh`."""
    map_pts, src, _ = scene()
    cfg = tsm.ShardedMapConfig(**CFG)
    pts, s = torch.as_tensor(map_pts), torch.as_tensor(src)
    msk = torch.ones(len(map_pts), dtype=torch.bool)
    m = tsm.insert_sharded(mesh, cfg)(tsm.create_sharded(mesh, cfg), pts, msk)
    eye = torch.eye(4)
    out = {"fp": m.fp.numpy(), "counts": m.counts.numpy(),
           "occ": tsm.shard_occupancy(mesh, m).numpy()}
    out["point_to_point"] = tsm.sharded_gn_step(mesh, cfg, max_corr_dist_sq=1.0, iters=8)(
        m, s, msk, eye).numpy()
    plane_pts, plane_src = (torch.as_tensor(a) for a in plane_scene())
    pmsk = torch.ones(len(plane_pts), dtype=torch.bool)
    m_plane = tsm.insert_sharded(mesh, cfg)(tsm.create_sharded(mesh, cfg), plane_pts, pmsk)
    step = tsm.sharded_gn_step(mesh, cfg, max_corr_dist_sq=1.0, iters=1,
                               residual="point_to_plane")
    out["point_to_plane"] = step(m_plane, plane_src, pmsk, eye).numpy()
    vh = tvh.build(16384, 8, pts, msk, 1.0)
    out["icp"] = tsgn.sharded_icp_step(mesh, 1.0, 1.0, iters=8)(vh, s, msk, eye).numpy()
    return out


_RANK = r"""
import jax
jax.config.update("jax_platforms", "cpu")  # the test module imports the JAX package
sys.path.insert(0, "{tests}")
from test_torch_sharded_map import port_run

result = port_run(mesh)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """Four gloo ranks of the port, and the JAX package on 4 devices."""
    import os

    tests = os.path.dirname(os.path.abspath(__file__))
    ranks = run_ranks(tmp_path_factory.mktemp("ranks"), 4, _RANK.format(tests=tests))
    return ranks, jax_run(4)


@pytest.fixture(scope="module")
def one():
    return port_run(comm.make_mesh(device="cpu")), jax_run(1)


def replicated_step(iters=8):
    """The replicated baseline: the same GN body over one full map."""
    map_pts, src, _ = scene()
    msk = torch.ones(len(map_pts), dtype=torch.bool)
    m = tbm.build(CFG["map_capacity"], 8, torch.as_tensor(map_pts), msk, 1.0)
    t, s = torch.eye(4), torch.as_tensor(src)
    for _ in range(iters):
        hg = point_to_point_hg(t, s, msk, m, 1.0, 1.0, "nearby26", 8)
        t = apply_update(t, solve6_damped(hg.h, hg.g), UPDATE_ICP)
    return t.numpy(), int(tbm.num_blocks(m))


@pytest.mark.parametrize("n_dev", [1, 3, 4, 8])
def test_tile_owner_matches_jax(n_dev):
    """int32 wrap-around: coordinates up to +-1e5 m, tile edges, and the
    point whose hash is INT_MIN (abs(INT_MIN) wraps to itself)."""
    rng = np.random.default_rng(n_dev)
    pts = rng.uniform(-1e5, 1e5, (20000, 3)).astype(np.float32)
    pts[:1000, :2] = np.round(pts[:1000, :2] / 8.0) * 8.0  # on tile edges
    pts[1000:2000] = rng.uniform(-40, 40, (1000, 3))
    pts[2000] = [-(2.0 ** 31) * 8.0, 0.0, 0.0]  # tx = INT_MIN, ty = 0: hash INT_MIN
    ref = np.asarray(jsm.tile_owner(jnp.asarray(pts), 8.0, n_dev))
    got = tsm.tile_owner(torch.as_tensor(pts), 8.0, n_dev)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref[1000:2000])) == set(range(n_dev))


def test_in_region_or_halo_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-60, 60, (20000, 3)).astype(np.float32)
    halo = tsm.stencil_halo(tsm.ShardedMapConfig(**CFG))
    assert halo == jsm.stencil_halo(jsm.ShardedMapConfig(**CFG))
    hits = []
    for dev in range(4):
        ref = np.asarray(jsm.in_region_or_halo(jnp.asarray(pts), dev, 8.0, halo, 4))
        got = tsm.in_region_or_halo(torch.as_tensor(pts), dev, 8.0, halo, 4).numpy()
        np.testing.assert_array_equal(got, ref)
        hits.append(got)
    owner = tsm.tile_owner(torch.as_tensor(pts), 8.0, 4).numpy()
    hits = np.stack(hits)
    assert hits[owner, np.arange(len(pts))].all()  # a point is in its owner's region
    # and in the halo of the tiles its +-2 m square meets: 1 tile for a
    # quarter of the points, 2 for half, 4 for a quarter, some of one owner
    assert 1.0 < hits.sum(0).mean() <= 2.25


def test_one_rank_matches_jax(one):
    """At one rank the map is the replicated one: its blocks equal the JAX
    map's, and every pose equals the JAX pose."""
    port, ref = one
    mj = convert.sharded_block_map(ref["map"], 0)
    np.testing.assert_array_equal(port["fp"], mj.fp.numpy())
    np.testing.assert_array_equal(port["counts"], mj.counts.numpy())
    np.testing.assert_array_equal(port["occ"], ref["occ"])
    for key in RESIDUALS + ("icp",):
        np.testing.assert_allclose(port[key], ref[key], atol=1e-4, err_msg=key)


def test_rank_maps_match_jax(four):
    """Each rank holds the JAX device's blocks, and every rank returns the
    same occupancy vector, equal to the JAX shard_occupancy."""
    ranks, ref = four
    for r, port in enumerate(ranks):
        mj = convert.sharded_block_map(ref["map"], r)
        np.testing.assert_array_equal(port["fp"], mj.fp.numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(port["counts"], mj.counts.numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(port["occ"], ref["occ"])
        assert port["occ"][r] == int((port["fp"] != 0).sum())


def test_halo_bound(four):
    """Blocks live on every rank, and the halo duplicates a bounded share:
    the replicated map's blocks <= the sum over ranks <= 3x them."""
    ranks, _ = four
    occ = ranks[0]["occ"]
    _, full = replicated_step(iters=0)
    assert (occ > 0).sum() >= 4, occ
    assert full <= occ.sum() <= 3 * full, (occ, full)


@pytest.mark.parametrize("residual", RESIDUALS)
def test_sharded_gn_matches_jax(four, residual):
    ranks, ref = four
    for port in ranks:
        np.testing.assert_array_equal(port[residual], ranks[0][residual])
    np.testing.assert_allclose(ranks[0][residual], ref[residual], atol=1e-4)


def test_sharded_gn_matches_replicated_and_truth(four):
    ranks, _ = four
    t_rep, _ = replicated_step()
    t_sh = ranks[0]["point_to_point"]
    np.testing.assert_allclose(t_sh, t_rep, atol=1e-4)
    np.testing.assert_allclose(t_sh[:3, 3], scene()[2][:3, 3], atol=0.03)


def test_sharded_icp_matches_jax(four):
    ranks, ref = four
    for port in ranks:
        np.testing.assert_array_equal(port["icp"], ranks[0]["icp"])
    np.testing.assert_allclose(ranks[0]["icp"], ref["icp"], atol=1e-4)
    np.testing.assert_allclose(ranks[0]["icp"][:3, 3], scene()[2][:3, 3], atol=0.03)
