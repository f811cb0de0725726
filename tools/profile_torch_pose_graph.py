"""The pose graph's `optimize` on the figure-8's graphs, the dry run's and
a 4,000-keyframe session's, its time split by stage.

    python3 tools/profile_torch_pose_graph.py [--reps N] [--plain] [--parent DIR]

Runs the bench's Figure8_Loop config (chip_smoke.py phase 13's run: the
figure-8 simulator run, hashed ICP, loop closure) with every optimize
captured, adds the dry run's 1,000-keyframe graph (parallel/dryrun.py's
NORTH_STAR_GRAPH) and chip_smoke.LONG_SESSION_GRAPH (too large for the
kernel's shared-memory copies), and for each graph launches the kernel built with
-DFLS_STAGE_CLOCKS (csrc/pose_graph.cu with csrc/stage_clock.cuh) from its
C entry point: the SM cycles of its thread 0 in each of PG_STAGES (the
symbolic phase once a call; the edges and assembly, the factorization, the
two substitutions and the update summed over the iterations; each stage
ends at a block barrier), median of --reps launches, each also in ms at
the card's largest SM clock (nvidia-smi `clocks.max.sm`), beside the
device ms of the plain build (`pose_graph_gn`, CUDA events, chip_smoke.
time_ms) and whether the profiling build's poses equal the plain build's
bit for bit. With --parent DIR, also a parent checkout's kernel (its
csrc/pose_graph.cu built with nvcc, launched from its C entry point, of
the same signature, with its own ops/pose_graph.py::scratch_sizes) and
this checkout's, timed in turns (parent, change, change, parent; one call a
turn at the dry run's graph, where the parent's kernel takes seconds; not
at the long session's), with the largest pose difference between the
two. With --plain, also the
plain version (`backend/pose_graph.py::
optimize_plain`, the dense [6K, 6K] route) split into its five stages with
CUDA events (`staged_plain`, a copy of its body with a mark after each
stage; tests/test_torch_pose_graph_gn.py holds it bit-equal to
optimize_plain), beside the synchronized host ms of one whole call. Prints
one JSON line with the card line. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("assembly", "gating_equilibration", "cholesky_ex", "cholesky_solve", "update")
# csrc/pose_graph.cu's PG_* stage clocks, in their order: the symbolic phase
# (the order, then the tree and L's pattern), once a call; the edges, the
# assembly, the factorization with the forward substitution (`factor` and
# the four f_* parts of it: the first team's diagonal sum, factor and y_j,
# panels, and the wait at each level's barrier), the back substitution and
# the update, summed over the iterations
PG_STAGES = ("order", "tree", "edges", "assembly", "factor", "substitute", "update",
             "f_diag", "f_chol", "f_panel", "f_wait")
# the five figures of the split: {figure: the PG_STAGES it sums}
FIGURES = {"symbolic": ("order", "tree"), "edges_assembly": ("edges", "assembly"),
           "factorization": ("factor", "f_diag", "f_chol", "f_panel", "f_wait"),
           "substitution": ("substitute",), "update": ("update",)}
STAGED = ("-DFLS_STAGE_CLOCKS",)
CLOCKS = 16  # kStageClocks of csrc/stage_clock.cuh


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


def kernel_stages(torch, lib, g, iterations: int = 15, damping: float = 1e-6) -> tuple:
    """One launch of `lib`'s pose_graph_gn_launch (a -DFLS_STAGE_CLOCKS
    build) on graph `g`, with room for the clocks after the float scratch:
    ({stage: thread 0's SM cycles}, the poses)."""
    from funny_lidar_slam_torch.ops import pose_graph as ops

    tensors = ops._checked_graph(g)
    k, e = g.poses.shape[0], g.edge_i.shape[0]
    n_float, n_int = ops.scratch_sizes(k, e)
    dev = g.poses.device
    fs = torch.zeros(n_float + CLOCKS, dtype=torch.float32, device=dev)
    ints = torch.empty(n_int, dtype=torch.int32, device=dev)
    out = torch.empty_like(g.poses)
    err = lib.pose_graph_gn_launch(*(t.data_ptr() for t in tensors), out.data_ptr(),
                                   fs.data_ptr(), ints.data_ptr(), fs.numel(), n_int, k, e,
                                   int(iterations), float(damping),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_graph_gn (stage clocks) launch failed: CUDA error {err}")
    cycles = fs[n_float:n_float + len(PG_STAGES)].tolist()
    return dict(zip(PG_STAGES, cycles)), out


def parent_scratch_sizes(root: str):
    """A checkout's ops/pose_graph.py::scratch_sizes, taken from its source
    (with EDGE_FLOATS, all it needs), without importing its package."""
    import ast

    path = os.path.join(root, "funny_lidar_slam_torch", "ops", "pose_graph.py")
    tree = ast.parse(open(path).read())
    keep = [n for n in tree.body if (isinstance(n, ast.FunctionDef) and n.name == "scratch_sizes")
            or (isinstance(n, ast.Assign)
                and [getattr(t, "id", None) for t in n.targets] == ["EDGE_FLOATS"])]
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns["scratch_sizes"]


def parent_kernel(root: str):
    """A parent checkout's pose_graph_gn: its csrc/pose_graph.cu built with
    this checkout's nvcc flags, launched with its own scratch sizes.
    Returns call(torch, g, iterations) -> poses."""
    import ctypes

    from funny_lidar_slam_torch.ops import cuda_build
    from funny_lidar_slam_torch.ops import pose_graph as ops

    out = os.path.join(HERE, "build", "kernels", "libpose_graph-parent.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
                    os.path.join(root, "funny_lidar_slam_torch", "csrc", "pose_graph.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(out).pose_graph_gn_launch
    fn.argtypes, fn.restype = cuda_build.SIGNATURES["pose_graph"]["pose_graph_gn_launch"]
    sizes = parent_scratch_sizes(root)

    def call(torch, g, iterations):
        k, e = g.poses.shape[0], g.edge_i.shape[0]
        n_float, n_int = sizes(k, e)
        fs = torch.empty(n_float, dtype=torch.float32, device=g.poses.device)
        ints = torch.empty(n_int, dtype=torch.int32, device=g.poses.device)
        out = torch.empty_like(g.poses)
        err = fn(*(t.data_ptr() for t in ops._checked_graph(g)), out.data_ptr(), fs.data_ptr(),
                 ints.data_ptr(), n_float, n_int, k, e, int(iterations), 1e-6,
                 torch.cuda.current_stream(g.poses.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's pose_graph_gn launch failed: CUDA error {err}")
        return out

    return call


def max_sm_mhz() -> float:
    """The card's largest SM clock, MHz (nvidia-smi `clocks.max.sm`)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def wall_ms(torch, fn) -> float:
    """Synchronized host ms of one call."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def run_figure8(torch):
    """The figure-8 run, every optimize captured: (system, LoopProbe)."""
    import bench_torch as bench
    import chip_smoke
    from funny_lidar_slam_torch.io.simulator import simulate

    sim_cfg, traj = bench.figure8_sim(16384)
    ds = simulate(sim_cfg, traj=traj)
    slam = chip_smoke.figure8_system()
    with chip_smoke.LoopProbe(torch) as probe:
        slam.run_dataset(ds)
        torch.cuda.synchronize()
    return slam, probe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true",
                    help="also split the plain version's time by stage")
    ap.add_argument("--parent", help="a parent checkout, its kernel timed in turns with this one")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_pose_graph: CUDA is not available")
    sys.path.insert(0, HERE)
    import bench_torch as bench
    import chip_smoke
    from funny_lidar_slam_torch.backend import pose_graph
    from funny_lidar_slam_torch.ops import cuda_build
    from funny_lidar_slam_torch.ops import pose_graph as ops
    from funny_lidar_slam_torch.parallel.dryrun import NORTH_STAR_GRAPH
    from funny_lidar_slam_torch.io.simulator import noisy_circle_graph

    staged = cuda_build.variant("pose_graph", STAGED)
    parent = parent_kernel(os.path.abspath(args.parent)) if args.parent else None
    slam, probe = run_figure8(torch)
    mhz = max_sm_mhz()
    res = {"card": bench.card_line(), "device": torch.cuda.get_device_name(0),
           "sm_clock_max_mhz": mhz,
           "loops": [(r.current_id, r.candidate_id, r.fitness) for r in slam.loop_results],
           "run_optimize_ms": probe.optimize_ms, "graphs": []}
    graphs = [(f"figure-8 optimize {i}", g, a[0] if a else kw.get("iterations", 15))
              for i, (g, a, kw) in enumerate(probe.graphs)]
    dry = noisy_circle_graph(**NORTH_STAR_GRAPH)[0].to_device(torch.float32, device="cuda")
    graphs.append(("dry run, 1,000 keyframes", dry, 15))
    long = noisy_circle_graph(**chip_smoke.LONG_SESSION_GRAPH)[0]
    graphs.append(("long session, 4,000 keyframes", long.to_device(torch.float32, device="cuda"),
                   15))
    for label, g, iterations in graphs:
        st = chip_smoke.pose_graph_structure(g)
        row = {"label": label, "vertices": int(g.pose_mask.sum()), "capacity": g.poses.shape[0],
               "edges": int(g.edge_mask.sum()), "iterations": iterations,
               "height": st["height"], **st["nested_dissection"],
               "natural_order": st["natural"]}
        ref = ops.pose_graph_gn(g, iterations).poses
        turns = []
        for _ in range(args.reps):
            cycles, out = kernel_stages(torch, staged, g, iterations)
            turns.append(cycles)
        torch.cuda.synchronize()
        row["staged_equal"] = bool(torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref)))
        row["stage_cycles"] = {s: float(np.median([t[s] for t in turns])) for s in PG_STAGES}
        row["stage_ms_at_max_clock"] = {s: c / (mhz * 1e3) for s, c in row["stage_cycles"].items()}
        row["figure_ms_at_max_clock"] = {f: sum(row["stage_ms_at_max_clock"][s] for s in parts)
                                         for f, parts in FIGURES.items()}
        row["stage_turns"] = {s: [t[s] for t in turns] for s in PG_STAGES}
        row["kernel_ms"] = chip_smoke.time_ms(torch, lambda: ops.pose_graph_gn(g, iterations),
                                              args.reps)
        if parent is not None and g.poses.shape[0] <= 1024:
            reps = 1 if g.poses.shape[0] > 512 else args.reps
            calls = {"parent": lambda: parent(torch, g, iterations),
                     "change": lambda: ops.pose_graph_gn(g, iterations)}
            row["parent_turns_ms"] = chip_smoke.in_turns(
                lambda fn: chip_smoke.time_ms(torch, fn, reps), calls,
                ["parent", "change", "change", "parent"])
            row["parent_vs_change"] = chip_smoke.graph_pose_diff(parent(torch, g, iterations),
                                                                 ref)
        if args.plain and g.poses.shape[0] <= 1024:
            staged_plain(g, iterations)  # warm-up
            splits = [stage_split(torch, g, iterations) for _ in range(args.reps)]
            row["plain_split_ms"] = {s: float(np.median([sp[s] for sp in splits]))
                                     for s in STAGES}
            row["plain_ms"] = float(np.median([wall_ms(torch, lambda: pose_graph.optimize_plain(
                g, iterations)) for _ in range(args.reps)]))
        res["graphs"].append(row)
        print(f"[profile-pose-graph] {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
