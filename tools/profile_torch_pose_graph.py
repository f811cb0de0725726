"""The plain version of the pose graph's `optimize` on the figure-8's
graphs, its time split by stage.

    python3 tools/profile_torch_pose_graph.py [--reps N]

Runs the bench's Figure8_Loop config (chip_smoke.py phase 13's run: the
figure-8 simulator run, hashed ICP, loop closure) on the plain version
(`backend/pose_graph.py::optimize_plain`, the dense [6K, 6K] route that
`pose_graph_gn` replaced on the card) with every optimize captured, then
splits each captured call into its five stages with CUDA events around
each stage of each iteration (`staged_plain`, a copy of its body with a
mark after each stage; tests/test_torch_pose_graph_gn.py holds it bit-equal
to optimize_plain): assembly (the edge residuals, the four scatters and
b), gating and equilibration, `cholesky_ex`, `cholesky_solve`, the update;
each stage's device ms summed over the iterations, median of --reps runs,
beside the synchronized host ms of one whole call. The kernel is held to
the plain version and timed beside it by chip_smoke.py phase 24. Prints
one JSON line with the card line. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("assembly", "gating_equilibration", "cholesky_ex", "cholesky_solve", "update")


def staged_plain(g, iterations: int = 15, damping: float = 1e-6, mark=lambda stage: None):
    """backend/pose_graph.py::optimize_plain's body, op for op, with
    `mark(stage)` called after each of STAGES in every iteration."""
    import torch

    from funny_lidar_slam_torch.backend.pose_graph import _edge_residuals
    from funny_lidar_slam_torch.core.lie import se3_exp

    k = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    lam = g.edge_info * g.edge_mask.to(dtype)[:, None]
    free = g.pose_mask.clone()
    free[0] = False
    d = free.to(dtype).repeat_interleave(6)
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)

    poses = g.poses
    for _ in range(iterations):
        e, j_i, j_j = _edge_residuals(g._replace(poses=poses))
        jtl_i = j_i.transpose(-1, -2) * lam[:, None, :]
        jtl_j = j_j.transpose(-1, -2) * lam[:, None, :]
        h = torch.zeros((k, k, 6, 6), dtype=dtype, device=dev)
        h.index_put_((ei, ei), jtl_i @ j_i, accumulate=True)
        h.index_put_((ei, ej), jtl_i @ j_j, accumulate=True)
        h.index_put_((ej, ei), jtl_j @ j_i, accumulate=True)
        h.index_put_((ej, ej), jtl_j @ j_j, accumulate=True)
        b = torch.zeros((k, 6), dtype=dtype, device=dev)
        b.index_add_(0, ei, torch.einsum("eab,eb->ea", jtl_i, e))
        b.index_add_(0, ej, torch.einsum("eab,eb->ea", jtl_j, e))
        mark("assembly")
        h = h.permute(0, 2, 1, 3).reshape(k * 6, k * 6)
        h = h * d[:, None] * d[None, :]
        h.diagonal().add_(1.0 - d)
        b = b.reshape(k * 6) * d
        dj = torch.rsqrt(torch.clamp(torch.diagonal(h), min=1e-12))
        hs = h * dj[:, None] * dj[None, :]
        hs.diagonal().add_(damping)
        mark("gating_equilibration")
        chol, info = torch.linalg.cholesky_ex(hs)
        chol = torch.where(info == 0, chol, nan)
        mark("cholesky_ex")
        dx = dj * torch.cholesky_solve((-(b * dj))[:, None], chol)[:, 0]
        mark("cholesky_solve")
        poses = torch.where(free[:, None, None], se3_exp(dx.reshape(k, 6)) @ poses, poses)
        mark("update")
    return g._replace(poses=poses)


def stage_split(torch, g, iterations: int = 15) -> dict:
    """{stage: device ms summed over the iterations} of one staged_plain
    call: a CUDA event after each stage, each stage timed from the event
    before it."""
    marks = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    staged_plain(g, iterations, mark=mark)
    torch.cuda.synchronize()
    out = dict.fromkeys(STAGES, 0.0)
    prev = start
    for stage, ev in marks:
        out[stage] += prev.elapsed_time(ev)
        prev = ev
    return out


def wall_ms(torch, fn) -> float:
    """Synchronized host ms of one call."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def run_figure8(torch):
    """The figure-8 run on the plain version, every optimize captured:
    (system, LoopProbe)."""
    import bench_torch as bench
    import chip_smoke
    from funny_lidar_slam_torch.backend import pose_graph
    from funny_lidar_slam_torch.io.simulator import simulate
    from funny_lidar_slam_torch.pipeline import system

    sim_cfg, traj = bench.figure8_sim(16384)
    ds = simulate(sim_cfg, traj=traj)
    slam = chip_smoke.figure8_system()
    saved, system.pg_optimize = system.pg_optimize, pose_graph.optimize_plain
    try:
        with chip_smoke.LoopProbe(torch) as probe:
            slam.run_dataset(ds)
            torch.cuda.synchronize()
    finally:
        system.pg_optimize = saved
    return slam, probe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pose_graph: CUDA is not available")
    sys.path.insert(0, HERE)
    import bench_torch as bench
    from funny_lidar_slam_torch.backend import pose_graph

    slam, probe = run_figure8(torch)
    res = {"card": bench.card_line(), "device": torch.cuda.get_device_name(0),
           "loops": [(r.current_id, r.candidate_id, r.fitness) for r in slam.loop_results],
           "run_optimize_ms": probe.optimize_ms, "graphs": []}
    for g, a, kw in probe.graphs:
        iterations = a[0] if a else kw.get("iterations", 15)
        row = {"vertices": int(g.pose_mask.sum()), "capacity": g.poses.shape[0],
               "edges": int(g.edge_mask.sum()), "iterations": iterations}
        staged_plain(g, iterations)  # warm-up
        splits = [stage_split(torch, g, iterations) for _ in range(args.reps)]
        row["split_ms"] = {s: float(np.median([sp[s] for sp in splits])) for s in STAGES}
        row["split_turns"] = {s: [sp[s] for sp in splits] for s in STAGES}
        row["plain_ms"] = float(np.median([wall_ms(torch, lambda: pose_graph.optimize_plain(
            g, iterations)) for _ in range(args.reps)]))
        res["graphs"].append(row)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
