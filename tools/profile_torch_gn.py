"""GN iterations, gathers, host reads, CUDA launches and the GN span a scan,
on one of the bench's mapping configs, for the port in a given checkout.

    python3 tools/profile_torch_gn.py [--root DIR]
        [--mode IcpOptimized|PointToPlane_IVOX|PointToPlane_KdTree|LoamFull_KdTree|
                IncrementalNDT]

Runs funny_lidar_slam_torch from DIR (default: this checkout) over the 10 s
simulator run (seed 7), 16,384 points a scan, on the config of `--mode`:
IcpOptimized (the default) is chip_smoke.py's phase-4 headline (dense grid
(96, 96, 16), TightCouplingOptimization); the LOAM modes and IncrementalNDT
are the bench's configs of phases 7-10 (`bench_torch.mode_config`). A
warm-up run, a counted run, two timed runs, a traced run and a profiled
run:
  * the counted run reads, per scan, the GN iterations (linearizations),
    the gathers and the GN's host reads. On a checkout whose matcher runs
    a round driver (`gn.run_gn_icp_cand` for ICP, `gn.run_gn_plane_cand` /
    `gn.run_gn_loam_cand` for the LOAM modes, `gn.run_gn_ndt` for NDT, one
    round a match): the kernel carry's iteration count around each rounds
    call and the driver's `_host_read` calls (the map-insertion gate is in
    them). On an earlier one, which runs the loop on the host
    (`run_gn_corr`): the calls of the row linearization
    (`point_to_point_hg_cand`, `point_to_plane_hg_cand`, once an iteration
    on every LOAM path, or NDT's `ndt_hg_corr`), one host read each; its
    map-insertion gate reads once more a mapping scan after the loop
    (`post_loop_reads_per_scan`; NDT's insert reads nothing);
  * the traced run puts CUDA events around the GN driver (ms a scan);
  * the profiled run counts the CUDA kernel launches (the runtime's and
    the driver's launch calls) a scan under torch.profiler, in all and
    inside the GN driver (the host side of a `record_function` range
    around it).
With `--verify` it runs the bench's Figure8_Loop config instead (the
figure-8 simulator run, hashed ICP, loop closure; `bench_torch.
figure8_config`) once and reports each loop verification's synchronized
ms, the refine's synchronized ms, and the GN iterations and host reads
inside the verifications: an NDT stage through `run_gn_ndt` and the
refine through `run_gn_plane_map` read once, a loop through `run_gn` (an
earlier checkout's refine, and an even earlier one's NDT stages) once an
iteration.
Prints one JSON line. Needs CUDA; imports nothing of JAX. To compare a
change with its parent on one card: `git archive <parent> | tar -x -C
_archive/parent`, then run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MODES = ("IcpOptimized", "PointToPlane_IVOX", "PointToPlane_KdTree", "LoamFull_KdTree",
         "IncrementalNDT")
# the round driver of each mode, and its rounds wrapper
DRIVERS = {"IcpOptimized": ("run_gn_icp_cand", "icp_gn_rounds"),
           "PointToPlane_IVOX": ("run_gn_plane_cand", "plane_gn_rounds"),
           "PointToPlane_KdTree": ("run_gn_plane_cand", "plane_gn_rounds"),
           "LoamFull_KdTree": ("run_gn_loam_cand", "loam_gn_rounds"),
           "IncrementalNDT": ("run_gn_ndt", "ndt_gn_rounds")}
# the host loop's linearization on a checkout without the mode's driver
HOST_ROWS = {"IcpOptimized": "point_to_point_hg_cand", "IncrementalNDT": "ndt_hg_corr"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _steady_fps(stats) -> float:
    trs = [s["tr"] for s in stats if not s.get("init")]
    half = np.diff(trs[len(trs) // 2:])
    return float(len(half) / half.sum()) if len(half) and half.sum() > 0 else 0.0


def _patch(saved):
    for mod, attr, fn in saved:
        setattr(mod, attr, fn)


def verify_profile(root, torch, bench) -> dict:
    """The figure-8 with loop closure once: each verification's
    synchronized ms, its GN loops' iterations and host reads."""
    from funny_lidar_slam_torch.backend import loop_closure as lc
    from funny_lidar_slam_torch.io.simulator import simulate
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    sim_cfg, traj = bench.figure8_sim(16384)
    ds = simulate(sim_cfg, traj=traj)
    loops, rows, refine_ms = [], [], []  # the current verification's; one row each
    saved = [(lc, k, getattr(lc, k)) for k in ("verify_candidate", "run_gn", "run_gn_ndt",
                                               "run_gn_plane_map") if hasattr(lc, k)]
    refine = "run_gn_plane_map" if hasattr(lc, "run_gn_plane_map") else "run_gn"

    def counted(fn, one_read, timed=False):
        def wrapper(*a, **kw):
            if timed:
                torch.cuda.synchronize()
                t = time.perf_counter()
            res = fn(*a, **kw)
            its = int(res.iters)
            if timed:
                refine_ms.append((time.perf_counter() - t) * 1e3)
            loops.append((its, 1 if one_read else its))
            return res
        return wrapper

    def verify(*a, fn=lc.verify_candidate, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t) * 1e3, "accepted": res is not None,
                     "refine_ms": sum(refine_ms), "gn_iterations": [i for i, _ in loops],
                     "gn_host_reads": sum(r for _, r in loops)})
        loops.clear()
        refine_ms.clear()
        return res

    lc.verify_candidate = verify
    if hasattr(lc, "run_gn"):  # an earlier checkout's refine: a read an iteration
        lc.run_gn = counted(lc.run_gn, False, refine == "run_gn")
    if hasattr(lc, "run_gn_ndt"):
        lc.run_gn_ndt = counted(lc.run_gn_ndt, True)
    if hasattr(lc, "run_gn_plane_map"):
        lc.run_gn_plane_map = counted(lc.run_gn_plane_map, True, True)
    try:
        slam = SlamSystem(bench.figure8_config(16384))
        t = time.perf_counter()
        slam.run_dataset(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        _patch(saved)
    ms = [r["ms"] for r in rows]
    refine = [r["refine_ms"] for r in rows]
    return {"root": root, "verify": True, "ndt_on_device": hasattr(lc, "run_gn_ndt"),
            "refine_on_device": hasattr(lc, "run_gn_plane_map"),
            "verifications": rows, "loops_accepted": len(slam.loop_results),
            "verify_ms_median": float(np.median(ms)) if ms else None,
            "refine_ms_median": float(np.median(refine)) if refine else None,
            "verify_ms_max": float(np.max(ms)) if ms else None,
            "gn_host_reads_per_verification": (float(np.mean([r["gn_host_reads"] for r in rows]))
                                               if rows else None),
            "steady_fps": _steady_fps(slam.stats), "wall_s": wall,
            "device": torch.cuda.get_device_name(0), "card": bench.card_line()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--mode", default="IcpOptimized", choices=MODES)
    ap.add_argument("--verify", action="store_true",
                    help="the figure-8 with loop closure: verification ms and GN reads")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import bench_torch as bench
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.pipeline.system import SlamSystem
    from funny_lidar_slam_torch.registration import gn, matchers

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_gn: CUDA is not available")
    if args.verify:
        out = verify_profile(args.root, torch, bench)
        print(json.dumps(out))
        return out
    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))
    icp = args.mode == "IcpOptimized"

    def make():
        return SlamSystem(bench.headline_config(16384, "TightCouplingOptimization") if icp
                          else bench.mode_config(args.mode, 16384))

    make().run_dataset(ds)
    torch.cuda.synchronize()

    driver_name, rounds_name = DRIVERS[args.mode]
    on_device = hasattr(gn, driver_name)
    its, reads = [0], [0]
    if on_device:
        from funny_lidar_slam_torch.ops import gn_loop

        o = gn_loop.OFFSET["it"]
        saved = [(gn, rounds_name, getattr(gn, rounds_name)), (gn, "_host_read", gn._host_read)]

        def rounds(carry, *a, fn=getattr(gn, rounds_name)):
            it0 = int(carry[o])
            status = fn(carry, *a)
            its[0] += int(carry[o]) - it0
            return status

        def read(flags, fn=gn._host_read):
            reads[0] += 1
            return fn(flags)

        setattr(gn, rounds_name, rounds)
        gn._host_read = read
    else:
        driver_name = "run_gn_corr"
        row = HOST_ROWS.get(args.mode, "point_to_plane_hg_cand")
        saved = [(matchers, row, getattr(matchers, row))]

        def linearize(*a, fn=getattr(matchers, row)):
            its[0] += 1
            reads[0] += 1
            return fn(*a)

        setattr(matchers, row, linearize)
    try:
        slam = make()
        slam.run_dataset(ds)
        torch.cuda.synchronize()
    finally:
        _patch(saved)
    steps = [s for s in slam.stats if not s.get("init")]

    walls, fps = [], []
    for _ in range(2):
        timed = make()
        t = time.perf_counter()
        timed.run_dataset(ds)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        fps.append(_steady_fps(timed.stats))

    driver, events = getattr(matchers, driver_name), []

    def traced(*a, **kw):
        b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        b.record()
        out = driver(*a, **kw)
        e.record()
        events.append((b, e))
        return out

    setattr(matchers, driver_name, traced)
    try:
        slam = make()
        slam.run_dataset(ds)
        torch.cuda.synchronize()
    finally:
        setattr(matchers, driver_name, driver)
    n = sum(1 for s in slam.stats if not s.get("init"))

    def ranged(*a, **kw):
        with record_function("gn_driver"):
            return driver(*a, **kw)

    setattr(matchers, driver_name, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            slam_p = make()
            slam_p.run_dataset(ds)
            torch.cuda.synchronize()
    finally:
        setattr(matchers, driver_name, driver)
    evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in evs if e.name == "gn_driver"]
    starts = np.sort([e.time_range.start for e in evs if e.name in LAUNCH_CALLS])
    inside = sum(int(np.searchsorted(starts, hi) - np.searchsorted(starts, lo))
                 for lo, hi in spans)
    n_p = sum(1 for s in slam_p.stats if not s.get("init"))

    out = {"root": args.root, "mode": args.mode, "gn_on_device": on_device,
           "driver": driver_name, "steps": len(steps),
           "gn_iterations_per_scan": its[0] / len(steps),
           "gathers_per_scan": sum(s["iters"] for s in steps) / len(steps),
           "gn_host_reads_per_scan": reads[0] / len(steps),
           "post_loop_reads_per_scan": 0 if on_device or args.mode == "IncrementalNDT" else 1,
           "cuda_launches_per_scan": len(starts) / n_p,
           "gn_cuda_launches_per_scan": inside / n_p,
           "wall_s": walls, "steady_fps": fps,
           "gn_span_ms_per_scan": sum(b.elapsed_time(e) for b, e in events) / n,
           "device": torch.cuda.get_device_name(0), "card": bench.card_line()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
