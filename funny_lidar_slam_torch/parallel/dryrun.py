"""Multi-rank dry run of the port (the counterpart of the JAX package's
`dryrun_multichip`): the three multi-device workloads over P ranks of
torch.distributed, each rank a process.

    python -m funny_lidar_slam_torch.parallel.dryrun --world-size P \
        --backend {nccl,gloo} [--device cpu] [--scene {dryrun,sim}]

Workloads, every rank on the same replicated inputs:
  * pose graph: `sharded_optimize` of the 1,000-keyframe noisy circle
    (15 GN iterations of up to 512 CG iterations), max position error
    < 0.25 m;
  * region-sharded map: `insert_sharded` of the map points in chunks, then
    `sharded_gn_step` (point to point, 8 iterations) of the displaced
    source from the identity; transform error < 0.03 m, at least min(4, P)
    shards occupied, and the blocks over all ranks within [1, 3] x those
    of one replicated `block_map.build` of the same points;
  * `sharded_icp_step` (8 iterations) of the same source over a
    `voxel_hash.build` of the map points: finite, error < 0.05 m.
Scene `dryrun` is the JAX dry run's map (3,072 random points in a
32 x 32 x 6 m box); `sim` is the simulator's world (`make_world(seed=7)`,
160,080 points) and one 16,384-point scan of the 10 s run in world
coordinates (`world_frame_scan`), each source displaced by the dry run's
transform.

Each worker calls `init_process_group` on a free local port with a
timeout and writes its results to `rank<r>.json`; the parent reads them all,
checks the gates and that every rank returned the same poses, and exits
non-zero if a worker failed or timed out or a gate failed. Without CUDA it
raises unless given `--device cpu`. NCCL takes one rank per card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..backend.distributed import sharded_optimize
from ..core.device import resolve_device
from ..core.lie import se3_exp, so3_exp, so3_log
from ..io.simulator import SimConfig, make_world, noisy_circle_graph, simulate
from ..maps import block_map, voxel_hash
from ..ops import cuda_build, select
from . import sharded_map as smap
from .comm import Mesh, make_mesh
from .sharded_gn import sharded_icp_step

NORTH_STAR_GRAPH = dict(n=1000, k_cap=1024, e_cap=2048, radius=150.0, extra_loops=600)
T_TRUE = (0.1, -0.08, 0.04, 0.02, -0.01, 0.02)  # the JAX dry run's displacement
INSERT_CHUNK = 65536
SCAN = 30  # the scan of the 10 s simulator run that `sim` matches
SCENES = ("dryrun", "sim")


def world_frame_scan(scans, i: int) -> np.ndarray:
    """Scan i in world coordinates, its motion distortion undone: each point
    is taken from the sensor pose at the middle of its 1/32 time bin (the
    simulator's), interpolated between the poses at the scan's start (scan
    i-1's end) and end."""
    s, t0, t1 = scans[i], scans[i - 1].gt_pose, scans[i].gt_pose
    period = scans[i].t - scans[i - 1].t
    f = (np.clip((s.rel_times / period * 32).astype(int), 0, 31) + 0.5) / 32
    r0, r1 = (torch.as_tensor(t[:3, :3], dtype=torch.float64) for t in (t0, t1))
    rot = r0 @ so3_exp(torch.as_tensor(f)[:, None] * so3_log(r0.T @ r1))  # [N, 3, 3]
    pos = t0[:3, 3] + f[:, None] * (t1[:3, 3] - t0[:3, 3])
    pts = torch.einsum("nij,nj->ni", rot, torch.as_tensor(s.points, dtype=torch.float64))
    return (pts.numpy() + pos).astype(np.float32)


def scene_data(scene: str) -> dict:
    """The map points, the displaced source, the true transform and the
    sharded map's configuration of a scene (NumPy; made from seeds)."""
    t_true = se3_exp(torch.tensor(T_TRUE, dtype=torch.float32)).numpy()
    if scene == "dryrun":
        rng = np.random.default_rng(2)
        world = np.concatenate([rng.uniform(0, 32.0, (3072, 2)),
                                rng.uniform(0, 6.0, (3072, 1))], axis=1).astype(np.float32)
        scan, cfg, vh_cap = world, smap.ShardedMapConfig(map_capacity=16384), 16384
    elif scene == "sim":
        world = make_world(seed=7)
        scan = world_frame_scan(simulate(SimConfig(duration=10.0, points_per_scan=16384,
                                                   seed=7)).scans, SCAN)
        cfg, vh_cap = smap.ShardedMapConfig(map_capacity=32768), 65536
    else:
        raise ValueError(f"unknown scene {scene!r}: {SCENES}")
    src = ((scan - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)
    return dict(world=world, src=src, t_true=t_true, cfg=cfg._asdict(), vh_capacity=vh_cap)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(result, ms) of fn() on the host clock, synchronized."""
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t) * 1e3


def device_idle_share(dev, fn):
    """Runs fn() and returns 1 - (device-busy time / wall time) under
    torch.profiler: the busy time is the union of the traced device events;
    None when the trace holds none (or on the CPU, where fn runs
    unprofiled)."""
    if dev.type != "cuda":
        fn()
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(dev, fn)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return 1.0 - busy / 1e3 / wall if spans else None


def allreduce_ms(mesh: Mesh, numel: int, reps: int = 50) -> float:
    """ms of one `dist.all_reduce` of `numel` f32 on the mesh's device (the
    CG matvec's collective at numel = 6K), median of `reps`."""
    x = torch.ones(numel, dtype=torch.float32, device=mesh.device)
    times = []
    for _ in range(reps + 1):
        times.append(_timed(mesh.device, lambda: dist.all_reduce(x, group=mesh.group))[1])
    return float(np.median(times[1:]))


def pose_graph_workload(mesh: Mesh, profile: bool = False) -> dict:
    b, gt = noisy_circle_graph(**NORTH_STAR_GRAPH)
    g = b.to_device(device=mesh.device)
    select.fused_select.launches = 0
    cg = []
    out, ms = _timed(mesh.device, lambda: sharded_optimize(
        mesh, g, iterations=15, cg_iterations=512, cg_iters_out=cg))
    launches = select.fused_select.launches
    poses = out.poses.cpu().numpy()[: b.n_vertices]
    res = {"keyframes": b.n_vertices, "edges": b.n_edges, "ms": ms, "launches": launches,
           "max_err_m": float(np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1).max()),
           "cg_iters": [int(i) for i in cg], "checksum": float(np.abs(poses).sum())}
    if profile:  # the idle share of one GN iteration of 64 CG iterations (every rank runs it)
        res["idle_share_1gn"] = device_idle_share(mesh.device, lambda: sharded_optimize(
            mesh, g, iterations=1, cg_iterations=64))
    return res


class _FirstGather:
    """Stands as `select.fused_select` while entered and keeps a copy of
    the first call's inputs, forwarding every call (the wrapper then counts
    its launches here; they are handed back on exit)."""

    def __enter__(self):
        self.orig, self.call, self.launches = select.fused_select, None, 0
        select.fused_select = self
        return self

    def __call__(self, *a, **kw):
        if self.call is None:
            self.call = ([x.clone() if torch.is_tensor(x) else x for x in a],
                         {"stencil": kw["stencil"], "qvox": kw["qvox"].clone()})
        return self.orig(*a, **kw)

    def __exit__(self, *exc):
        select.fused_select = self.orig
        self.orig.launches += self.launches


def sharded_map_workload(mesh: Mesh, data: dict, capture: str | None = None) -> dict:
    """Insert in chunks, then the sharded GN step; `capture` (a path) saves
    the step's first fused_select call and this rank's map there."""
    dev = mesh.device
    cfg = smap.ShardedMapConfig(**data["cfg"])
    world = torch.as_tensor(data["world"], device=dev)
    src = torch.as_tensor(data["src"], device=dev)
    select.fused_select.launches = 0
    insert = smap.insert_sharded(mesh, cfg)
    m = smap.create_sharded(mesh, cfg)
    insert_ms = []
    for lo in range(0, len(world), INSERT_CHUNK):
        chunk = world[lo:lo + INSERT_CHUNK]
        m, ms = _timed(dev, lambda: insert(m, chunk, torch.ones(len(chunk), dtype=torch.bool,
                                                                   device=dev)))
        insert_ms.append(ms)
    occ = smap.shard_occupancy(mesh, m).cpu().numpy()
    full = block_map.build(cfg.map_capacity, cfg.bucket_size, world,
                           torch.ones(len(world), dtype=torch.bool, device=dev),
                           1.0 / cfg.voxel_size, num_probes=cfg.num_probes)
    step = smap.sharded_gn_step(mesh, cfg, max_corr_dist_sq=1.0, iters=8)
    msk = torch.ones(len(src), dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)
    if capture:
        with _FirstGather() as probe:
            t = step(m, src, msk, eye)
        (wnd, gid, qs, k, plane), kw = probe.call
        torch.save({"wnd": wnd.cpu(), "gid": gid.cpu(), "qs": qs.cpu(), "k": k, "plane": plane,
                    **{key: v.cpu() if torch.is_tensor(v) else v for key, v in kw.items()},
                    "map": {f: getattr(m, f).cpu() for f in m._fields}}, capture)
    else:
        t = step(m, src, msk, eye)
    _, gn_ms = _timed(dev, lambda: step(m, src, msk, eye))
    t = t.cpu().numpy()
    return {"occupancy": occ.tolist(), "replicated_blocks": int(block_map.num_blocks(full)),
            "load_factor": float(block_map.load_factor(m)), "insert_ms": insert_ms,
            "gn_ms": gn_ms, "launches": select.fused_select.launches, "pose": t.tolist(),
            "t_err_m": float(np.linalg.norm(t[:3, 3] - data["t_true"][:3, 3]))}


def icp_workload(mesh: Mesh, data: dict) -> dict:
    dev = mesh.device
    world = torch.as_tensor(data["world"], device=dev)
    src = torch.as_tensor(data["src"], device=dev)
    select.fused_select.launches = 0
    vh, build_ms = _timed(dev, lambda: voxel_hash.build(
        data["vh_capacity"], 8, world, torch.ones(len(world), dtype=torch.bool, device=dev), 1.0))
    step = sharded_icp_step(mesh, max_corr_dist_sq=1.0, inv_voxel_size=1.0, iters=8)
    msk = torch.ones(len(src), dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)
    t = step(vh, src, msk, eye)
    _, ms = _timed(dev, lambda: step(vh, src, msk, eye))
    t = t.cpu().numpy()
    return {"build_ms": build_ms, "ms": ms, "launches": select.fused_select.launches,
            "load_factor": float(voxel_hash.load_factor(vh)), "finite": bool(np.isfinite(t).all()),
            "pose": t.tolist(), "t_err_m": float(np.linalg.norm(t[:3, 3] - data["t_true"][:3, 3]))}


def run_workloads(mesh: Mesh, data: dict, profile: bool = False,
                  capture: str | None = None, parity: dict | None = None) -> dict:
    """The three workloads on this rank, and the all_reduce's time at the
    CG vector's size. `parity`: a second scene whose sharded map runs too
    (`sharded_map_parity`), one with no overfull voxel, where the sharded
    GN pose equals the replicated one up to the order of the sums."""
    res = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
           "backend": dist.get_backend(mesh.group) if dist.is_initialized() else None,
           "sharded_map": sharded_map_workload(mesh, data, capture=capture),
           "icp": icp_workload(mesh, data),
           "pose_graph": pose_graph_workload(mesh, profile=profile)}
    if parity is not None:
        res["sharded_map_parity"] = sharded_map_workload(mesh, parity)
    res["allreduce_ms"] = (allreduce_ms(mesh, 6 * NORTH_STAR_GRAPH["k_cap"])
                           if dist.is_initialized() else None)
    return res


def check(results: list) -> dict:
    """The gates over every rank's results (raises AssertionError); returns
    a summary."""
    r0 = results[0]
    size = r0["size"]
    for r in results[1:]:  # the replicated outputs agree on every rank
        assert r["pose_graph"]["checksum"] == r0["pose_graph"]["checksum"], "pose graphs differ"
        for w in ("sharded_map", "icp", "sharded_map_parity"):
            assert r.get(w, {}).get("pose") == r0.get(w, {}).get("pose"), \
                f"{w} poses differ between ranks"
        assert r["sharded_map"]["occupancy"] == r0["sharded_map"]["occupancy"]
    pg, sm, icp = r0["pose_graph"], r0["sharded_map"], r0["icp"]
    assert pg["max_err_m"] < 0.25, f"1k-keyframe solve max error {pg['max_err_m']:.4f} m"
    occ, full = np.asarray(sm["occupancy"]), sm["replicated_blocks"]
    assert (occ > 0).sum() >= min(4, size), f"map blocks on too few shards: {occ}"
    assert full <= occ.sum() <= 3 * full, f"halo bound: {occ.sum()} blocks against {full}"
    for w in ("sharded_map", "sharded_map_parity"):
        err = r0.get(w, {}).get("t_err_m", 0.0)
        assert err < 0.03, f"{w} GN missed the transform by {err:.4f} m"
    assert icp["finite"] and icp["t_err_m"] < 0.05, f"sharded ICP error {icp['t_err_m']}"
    assert pg["launches"] == 0 and icp["launches"] == 0, "fused_select outside the map path"
    if r0["device"].startswith("cuda"):  # CPU tensors take fused_select's plain version
        assert all(r["sharded_map"]["launches"] > 0 for r in results), "no fused_select launch"
    return {"size": size, "pose_graph_max_err_m": pg["max_err_m"],
            "sharded_map_t_err_m": sm["t_err_m"], "icp_t_err_m": icp["t_err_m"],
            "occupancy": sm["occupancy"], "replicated_blocks": full}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, size, backend, device, port, data, out_dir, timeout, profile, capture,
            parity):
    if device == "cpu":  # the ranks share the host's cores; their ops are small
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(device=None if device == "cuda" else device)
        res = run_workloads(mesh, data, profile=profile,
                            capture=capture if rank == 0 else None, parity=parity)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def spawn(world_size: int, backend: str, device: str, data: dict, out_dir: str,
          timeout: float = 600.0, profile: bool = False, capture: str | None = None,
          parity: dict | None = None) -> list:
    """Run `run_workloads` in `world_size` worker processes (spawned; rank
    0 captures) and return each rank's results. Raises if a
    worker fails or the run takes longer than `timeout` seconds; every
    worker is stopped either way."""
    if backend == "nccl" and (device != "cuda" or world_size > torch.cuda.device_count()):
        raise ValueError("nccl takes one rank per CUDA card")
    if device == "cuda":  # build the kernel once, before the workers load it
        cuda_build.build_all(["fused_select"])
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world_size, backend, device, port, data,
                                                out_dir, timeout, profile, capture, parity))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"dry-run worker(s) {failed} failed "
                                   f"(exit codes {[procs[r].exitcode for r in failed]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"dry run took longer than {timeout} s")
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"dry-run workers exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    results = []
    for r in range(world_size):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--scene", choices=SCENES, default="dryrun")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type  # raises without CUDA unless told cpu
    data = scene_data(args.scene)
    with tempfile.TemporaryDirectory() as out_dir:
        results = spawn(args.world_size, args.backend, device, data, out_dir, args.timeout)
    summary = check(results)
    print(json.dumps({"scene": args.scene, "backend": args.backend, "device": device,
                      **summary, "ranks": results}))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
