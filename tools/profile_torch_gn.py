"""GN iterations, gathers and host reads a scan on chip_smoke.py's phase-4
grid config, for the port in a given checkout.

    python3 tools/profile_torch_gn.py [--root DIR]

Runs funny_lidar_slam_torch from DIR (default: this checkout) on the
headline mapping config (IcpOptimized + TightCouplingOptimization, the
dense grid (96, 96, 16), 16,384 points a scan) over the 10 s simulator run
(seed 7): a warm-up run, a counted run, two timed runs and a traced run.
The counted run reads, per scan, the GN iterations (the linearizations),
the gathers and the GN's host reads: on a checkout whose IcpMatcher runs
`gn.run_gn_icp_cand`, the kernel carry's iteration count around each
`icp_gn_rounds` call and the driver's `_host_read` calls (the insert gate
is in them); on an earlier one, the calls of `point_to_point_hg_cand`, one
host read each (its insert gate reads once more a scan, not counted). The
traced run puts CUDA events around the GN driver (ms a scan). Prints one
JSON line. Needs CUDA; imports nothing of JAX. To compare a change with its
parent on one card: `git archive <parent> | tar -x -C _archive/parent`, then
run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _steady_fps(stats) -> float:
    trs = [s["tr"] for s in stats if not s.get("init")]
    half = np.diff(trs[len(trs) // 2:])
    return float(len(half) / half.sum()) if len(half) and half.sum() > 0 else 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import bench_torch as bench
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.pipeline.system import SlamSystem
    from funny_lidar_slam_torch.registration import gn, matchers

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_gn: CUDA is not available")
    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))

    def make():
        return SlamSystem(bench.headline_config(16384, "TightCouplingOptimization"))

    make().run_dataset(ds)
    torch.cuda.synchronize()

    on_device = hasattr(gn, "run_gn_icp_cand")
    its, reads = [0], [0]
    if on_device:
        from funny_lidar_slam_torch.ops import gn_loop

        o = gn_loop.OFFSET["it"]
        saved = [(gn, "icp_gn_rounds", gn.icp_gn_rounds), (gn, "_host_read", gn._host_read)]

        def rounds(carry, *a, fn=gn.icp_gn_rounds):
            it0 = int(carry[o])
            status = fn(carry, *a)
            its[0] += int(carry[o]) - it0
            return status

        def read(flags, fn=gn._host_read):
            reads[0] += 1
            return fn(flags)

        gn.icp_gn_rounds, gn._host_read = rounds, read
    else:
        saved = [(matchers, "point_to_point_hg_cand", matchers.point_to_point_hg_cand)]

        def linearize(*a, fn=matchers.point_to_point_hg_cand):
            its[0] += 1
            reads[0] += 1
            return fn(*a)

        matchers.point_to_point_hg_cand = linearize
    try:
        slam = make()
        slam.run_dataset(ds)
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    steps = [s for s in slam.stats if not s.get("init")]

    walls, fps = [], []
    for _ in range(2):
        timed = make()
        t = time.perf_counter()
        timed.run_dataset(ds)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        fps.append(_steady_fps(timed.stats))

    name = "run_gn_icp_cand" if on_device else "run_gn_corr"
    driver, events = getattr(matchers, name), []

    def traced(*a, **kw):
        b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        b.record()
        out = driver(*a, **kw)
        e.record()
        events.append((b, e))
        return out

    setattr(matchers, name, traced)
    try:
        slam = make()
        slam.run_dataset(ds)
        torch.cuda.synchronize()
    finally:
        setattr(matchers, name, driver)
    n = sum(1 for s in slam.stats if not s.get("init"))
    out = {"root": args.root, "gn_on_device": on_device, "steps": len(steps),
           "gn_iterations_per_scan": its[0] / len(steps),
           "gathers_per_scan": sum(s["iters"] for s in steps) / len(steps),
           "gn_host_reads_per_scan": reads[0] / len(steps), "wall_s": walls, "steady_fps": fps,
           "gn_span_ms_per_scan": sum(b.elapsed_time(e) for b, e in events) / n,
           "device": torch.cuda.get_device_name(0), "card": bench.card_line()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
