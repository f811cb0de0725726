"""Port parity: the distributed pose-graph backend (backend/distributed.py)
and the noisy-circle graph (io/simulator.py) of funny_lidar_slam_torch
against the JAX package, at one rank in process and at four gloo ranks in
subprocesses (each with a timeout) against a JAX mesh of the same size over
the virtual CPU devices; the port's counterparts of
tests/test_distributed_backend.py and tests/test_multihost.py.

Tolerances: the graph builders' arrays exactly (the same NumPy code);
`_edge_blocks` 1e-6 of each H block's largest entry and 1e-4 of each b
block's (b = J^T Lambda e, and the f32 residual e = Log(...) of products of
poses 10 m from the origin cancels to ~1e-5 of itself); poses 2e-3 m (the
JAX tests' tolerance: an f32 PCG whose sums run in another order); ranks
of one run agree bit for bit."""

import multiprocessing
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.backend import distributed as jdist
from funny_lidar_slam_tpu.io import simulator as jsim
from funny_lidar_slam_torch.backend import distributed as tdist
from funny_lidar_slam_torch.backend import pose_graph as tpg
from funny_lidar_slam_torch.io import simulator as tsim
from funny_lidar_slam_torch.parallel import comm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = {"circle40": {}, "north_star": dict(n=1000, k_cap=1024, e_cap=2048, radius=150.0,
                                              extra_loops=600)}

# the head of every rank's script: argv = rank, world size, init method, out dir
RANK_PRELUDE = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from funny_lidar_slam_torch.parallel.comm import make_mesh
mesh = make_mesh(device="cpu")
"""
RANK_EPILOGUE = r"""
np.savez(f"{out}/rank{rank}.npz", **result)
dist.destroy_process_group()
print(f"rank {rank} OK", flush=True)
"""


def run_ranks(tmp_path, world, body, timeout=240):
    """Run `body` (Python source that fills a dict `result` of arrays,
    after RANK_PRELUDE) in `world` gloo ranks on the CPU, each a process
    with a timeout; returns each rank's `result`."""
    worker = tmp_path / "rank.py"
    worker.write_text(RANK_PRELUDE + body + RANK_EPILOGUE)
    init = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(world), init,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank of {world} timed out after {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} OK" in out, f"rank {r} failed:\n{out}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def jax_optimize(n_dev, kw, **opt):
    b, gt = jsim.noisy_circle_graph(**kw)
    mesh = jdist.make_mesh(jax.devices()[:n_dev])
    return np.asarray(jdist.sharded_optimize(mesh, b.to_device(), **opt).poses)[: b.n_vertices]


def position_error(poses, gt):
    return np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1).max()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_noisy_circle_graph_matches_jax(name):
    bj, gtj = jsim.noisy_circle_graph(**GRAPHS[name])
    bt, gtt = tsim.noisy_circle_graph(**GRAPHS[name])
    np.testing.assert_array_equal(gtt, gtj)
    assert (bt.n_vertices, bt.n_edges, bt.k_cap, bt.e_cap) == \
        (bj.n_vertices, bj.n_edges, bj.k_cap, bj.e_cap)
    for f in ("poses", "pose_mask", "edge_i", "edge_j", "edge_meas", "edge_info", "edge_mask"):
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_edge_blocks_match_jax():
    b, _ = tsim.noisy_circle_graph()
    g = b.to_device(device="cpu")
    rng = np.random.default_rng(0)
    poses = b.poses.copy()
    poses[:40, :3, 3] += rng.normal(0, 0.1, (40, 3)).astype(np.float32)
    gj = jsim.noisy_circle_graph()[0].to_device()
    out_j = jdist._edge_blocks(gj, jnp.asarray(poses))
    out_t = tdist._edge_blocks(g, torch.as_tensor(poses))
    for name, a, bj in zip(("h_ii", "h_ij", "h_jj", "b_i", "b_j"), out_t, out_j):
        bj = np.asarray(bj)
        scale = np.abs(bj).reshape(len(bj), -1).max(1)
        err = np.abs(a.numpy() - bj).reshape(len(bj), -1).max(1)
        rtol = 1e-6 if name.startswith("h") else 1e-4
        assert (err <= rtol * np.maximum(scale, 1.0)).all(), (name, err.max())


def test_pcg_masked_loop_matches_while_loop():
    """The masked CG with host reads every 16 iterations ends where JAX's
    early-exit while_loop ends, on a system that converges in a few dozen
    iterations."""
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (48, 48))
    h = (a @ a.T / 48 + np.eye(48)).astype(np.float32)
    b = rng.normal(0, 1, 48).astype(np.float32)
    pre = np.diag(1.0 / np.diag(h)).astype(np.float32)
    xj = jdist._solve_pcg(lambda x: jnp.asarray(h) @ x, lambda r: jnp.asarray(pre) @ r,
                          jnp.asarray(b), 200, rtol=1e-3)
    ht, pt = torch.as_tensor(h), torch.as_tensor(pre)
    mesh = comm.make_mesh(device="cpu")
    xt, iters = tdist._solve_pcg(mesh, lambda x: ht @ x, lambda r: pt @ r,
                                 torch.as_tensor(b), 200, rtol=1e-3)
    assert 0 < int(iters) < 200
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h @ xt.numpy(), b, atol=2e-3 * np.abs(b).max())


def test_sharded_optimize_one_rank_matches_jax_and_dense():
    b, gt = tsim.noisy_circle_graph()
    g = b.to_device(device="cpu")
    mesh = comm.make_mesh(device="cpu")
    iters = []
    out = tdist.sharded_optimize(mesh, g, iterations=15, cg_iters_out=iters)
    est = out.poses.numpy()[: b.n_vertices]
    assert len(iters) == 15 and all(0 < int(i) <= 64 for i in iters)
    np.testing.assert_allclose(est[:, :3, 3], jax_optimize(1, {}, iterations=15)[:, :3, 3],
                               atol=2e-3)
    dense = tpg.optimize(g, iterations=15).poses.numpy()[: b.n_vertices]
    np.testing.assert_allclose(est[:, :3, 3], dense[:, :3, 3], atol=2e-3)
    assert position_error(est, gt) < 2e-3


def test_sharded_optimize_north_star_one_rank():
    """1,000 keyframes and 1,600 edges, 15 GN iterations of up to 512 CG
    iterations: the JAX test's 0.25 m gate (the dense solve would factor a
    6,144 x 6,144 system)."""
    b, gt = tsim.noisy_circle_graph(**GRAPHS["north_star"])
    assert b.n_edges >= 1500
    out = tdist.sharded_optimize(comm.make_mesh(device="cpu"), b.to_device(device="cpu"),
                                 iterations=15, cg_iterations=512)
    assert position_error(out.poses.numpy()[: b.n_vertices], gt) < 0.25


def test_capacity_must_divide_mesh():
    b, _ = tsim.noisy_circle_graph(e_cap=126)
    four = comm.Mesh(None, 0, 4, torch.device("cpu"))  # the assert fires before any collective
    with pytest.raises(AssertionError, match="edge capacity"):
        tdist.sharded_optimize(four, b.to_device(device="cpu"), iterations=1)
    b, _ = tsim.noisy_circle_graph(k_cap=66)
    with pytest.raises(AssertionError, match="vertex capacity"):
        tdist.sharded_optimize(four, b.to_device(device="cpu"), iterations=1)


_OPTIMIZE_RANK = r"""
from funny_lidar_slam_torch.backend.distributed import sharded_optimize
from funny_lidar_slam_torch.io.simulator import noisy_circle_graph

b, gt = noisy_circle_graph(n=40, seed=0)
iters = []
out_g = sharded_optimize(mesh, b.to_device(device="cpu"), iterations=15, cg_iters_out=iters)
result = dict(poses=out_g.poses.numpy()[:40], cg=np.array([int(i) for i in iters]))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_optimize_gloo_ranks(tmp_path, world):
    """Edges over `world` gloo ranks: every rank returns the same poses, bit
    for bit (the counterpart of test_multihost.py); they match the JAX
    solve on a mesh of as many devices and the port's dense optimize."""
    res = run_ranks(tmp_path, world, _OPTIMIZE_RANK)
    for r in res[1:]:
        np.testing.assert_array_equal(r["poses"], res[0]["poses"])
        np.testing.assert_array_equal(r["cg"], res[0]["cg"])
    est = res[0]["poses"]
    np.testing.assert_allclose(est[:, :3, 3],
                               jax_optimize(world, {}, iterations=15)[:, :3, 3], atol=2e-3)
    b, gt = tsim.noisy_circle_graph()
    dense = tpg.optimize(b.to_device(device="cpu"), iterations=15).poses.numpy()[:40]
    np.testing.assert_allclose(est[:, :3, 3], dense[:, :3, 3], atol=2e-3)
    assert position_error(est, gt) < 2e-3


def test_dryrun_fails_on_a_failed_or_late_worker(tmp_path):
    """The dry run raises when its workers fail or outlast the timeout,
    and stops every worker either way."""
    from funny_lidar_slam_torch.parallel import dryrun

    data = dryrun.scene_data("dryrun")
    data["cfg"]["map_capacity"] = 1000  # not a power of two: every rank raises
    with pytest.raises(RuntimeError, match="failed|exited"):
        dryrun.spawn(2, "gloo", "cpu", data, str(tmp_path), timeout=120)
    with pytest.raises(TimeoutError):
        dryrun.spawn(2, "gloo", "cpu", dryrun.scene_data("dryrun"), str(tmp_path), timeout=1)
    assert not multiprocessing.active_children()
