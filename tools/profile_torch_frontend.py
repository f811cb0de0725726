"""Per-stage timing of the port's frontend step on one GPU.

    python3 tools/profile_torch_frontend.py [--points 16384] [--trace DIR]

The port of tools/profile_frontend.py, on its configuration: a 4.5 s
simulator run (16,384 points a scan, seed 7), IcpOptimized on the hashed
block map (the IcpConfig default layout; map 65,536, window 20) with
TightCouplingOptimization. SlamSystem warms up over all but the last two
scans; then each stage of the step is timed in isolation on scan len - 4,
from the warmed state, under the JAX tool's stage names: the unpacked
`Frontend.step` (`full_step`, inputs already on the card, the same f32
values as the packed frame), deskew, preintegration, the source voxel
filter, the k-NN queries, one H/g evaluation, the matcher's GN and the GN
without the candidate cache, the tight fusion, the window insert
(incremental and rebuild policies), and the host feed (`host_prep`,
`host_pack_frame`) beside the packed step (`step_packed_device`, one
host->device copy of the frame) and the packed step with its result row
fetched (`step_plus_retire_fetch`). `live_frame_wall` is the warm-up
run's retire interval over its second half.

Each stage is timed with the host clock around `n` calls after warm-up,
ending in `torch.cuda.synchronize()`: the step reads flags on the host,
so a device-event time would hide those waits. Beside each stage the
report gives the `fused_select` launches a call. `--trace DIR` writes a
torch.profiler chrome trace of five `full_step` calls. Needs CUDA (no CPU
fallback); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# runnable as `python3 tools/profile_torch_frontend.py` from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

POINTS = 16384  # points a scan
DURATION, SEED = 4.5, 7  # the simulator run
SEG = 32  # IMU segment capacity (the SystemConfig default)
WARMUP = 3  # untimed calls before each stage's timed ones
# stages timed with fewer calls (the JAX tool's counts)
CALLS = {"window_add": 10, "window_add_rebuild": 10, "host_prep": 50,
         "host_pack_frame": 50, "step_plus_retire_fetch": 20}


def system_config(points: int):
    """The JAX tool's configuration at `points` points a scan."""
    from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
    from funny_lidar_slam_torch.pipeline.system import SystemConfig
    from funny_lidar_slam_torch.registration import matchers

    mcfg = matchers.IcpConfig(source_capacity=points, cloud_capacity=points,
                              merged_capacity=65536, map_capacity=65536, local_map_size=20)
    return SystemConfig(registration_mode="IcpOptimized", matcher_config=mcfg,
                        frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
                        scan_capacity=points)


def warmed_system(points: int, device=None):
    """SlamSystem on `system_config(points)` run over all but the last two
    scans of the simulator run. Returns (slam, dataset)."""
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    ds = simulate(SimConfig(duration=DURATION, points_per_scan=points, seed=SEED))
    slam = SlamSystem(system_config(points), device=device)
    slam.run_dataset(ds, max_scans=len(ds.scans) - 2)
    if slam.fstate is None:
        raise RuntimeError("the pipeline did not initialize")
    return slam, ds


def build_stages(slam, scan, period: float) -> dict:
    """{stage name: callable} over `scan` from the system's current state,
    on the system's device. The callables return their outputs; the host
    stages return host arrays."""
    from funny_lidar_slam_torch.core.cloud import Cloud
    from funny_lidar_slam_torch.fusion.tight import fuse as tight_fuse
    from funny_lidar_slam_torch.imu.preintegration import predict, preintegrate
    from funny_lidar_slam_torch.lidar.deskew import deskew
    from funny_lidar_slam_torch.ops.voxel import voxel_downsample
    from funny_lidar_slam_torch.pipeline.system import pad_scan, to_device_segment
    from funny_lidar_slam_torch.registration import matchers
    from funny_lidar_slam_torch.registration.gn import run_gn
    from funny_lidar_slam_torch.registration.residuals import point_to_point_hg, query_knn_any

    fe, dev = slam.frontend, slam.device
    mcfg, cap = slam.cfg.matcher_config, slam.cfg.scan_capacity
    mstate, fstate = slam.mstate, slam.fstate
    scan_end = scan.t + period
    # the rel times the packed frame holds (f64 difference, then f32), so
    # `full_step` and `step_packed_device` step the same values
    pts, rts, mask = pad_scan(scan.points, scan.rel_times - period, cap)

    def segments():
        return (slam.imu.get_segment(scan.t, scan_end, SEG),
                slam.imu.get_segment(scan.t - period, scan_end, SEG))

    dseg_np, pseg_np = segments()
    dseg, pseg = to_device_segment(dseg_np, device=dev), to_device_segment(pseg_np, device=dev)
    pts, rts, mask = fe._tensor(pts), fe._tensor(rts), fe._tensor(mask, torch.bool)
    ref_t = fe._tensor(scan_end)
    inv, gap2 = 1.0 / mcfg.nn_voxel_size, mcfg.max_correspond_distance ** 2
    src = voxel_downsample(pts, mask, mcfg.source_filter_size, mcfg.source_capacity)
    m, t0, nav = mstate.m, fstate.nav.pose, fstate.nav
    grav = fe._tensor(slam.cfg.frontend.gravity)
    pre_v = preintegrate(pseg, fe.params, nav.bg, nav.ba)
    pred_v = predict(pre_v, nav, grav)

    def hg(t):
        return point_to_point_hg(t, src.points, src.mask, m, inv, gap2, mcfg.stencil,
                                 mcfg.num_probes)

    def knn(k, stencil, group_capacity=None):
        return lambda: query_knn_any(m, src.points, inv, k, stencil, mcfg.num_probes,
                                     group_capacity)

    def pack():
        return fe.pack_frame(scan.points, scan.rel_times - period, cap, scan_end, *segments())

    buf = pack()

    def retire():
        out = fe.step_packed(mstate, fstate, buf, cap, SEG)[2]
        return out.packed.cpu().numpy()

    stages = {
        "full_step": lambda: fe.step(mstate, fstate, pts, rts, mask, scan_end, dseg, pseg),
        "deskew": lambda: deskew(pts, rts, mask, ref_t, dseg, fe.t_l2i),
        "preintegrate": lambda: preintegrate(pseg, fe.params, nav.bg, nav.ba),
        "voxel_downsample_src": lambda: voxel_downsample(pts, mask, mcfg.source_filter_size,
                                                         mcfg.source_capacity),
        "query_knn_k1_direct": knn(1, mcfg.stencil),
        "query_knn_k1_grouped": knn(1, mcfg.stencil, mcfg.group_capacity or None),
        "query_knn_k5_direct": knn(5, "nearby18"),
        "hg_point_to_point": lambda: hg(t0),
        # the live registration: the cached two-loop GN, grouped gathers
        "gn_matcher_match": lambda: slam.matcher.match(mstate, Cloud(pts, mask), t0),
        # the reference semantics: a direct gather every iteration
        "gn_uncached_direct": lambda: run_gn(hg, t0, slam.matcher.gn_cfg._replace(corr_every=1)),
        "tight_fuse": lambda: tight_fuse(nav, pre_v, t0, pred_v, slam.cfg.frontend.gravity,
                                         slam.cfg.frontend.fusion),
        "window_add": lambda: matchers.window_add(
            mstate, Cloud(src.points, src.mask), t0, mcfg.map_filter_size, inv,
            mcfg.merged_capacity, mcfg.num_probes, window_size=matchers._window_size(mcfg)),
    }
    if mcfg.incremental_map:  # the superseded full-rebuild policy, for the record
        ws_full = matchers.window_create(mcfg.local_map_size, mcfg.cloud_capacity,
                                         mcfg.map_capacity, mcfg.bucket_size, device=dev)
        stages["window_add_rebuild"] = lambda: matchers.window_add(
            ws_full, Cloud(src.points, src.mask), t0, mcfg.map_filter_size, inv,
            mcfg.merged_capacity, mcfg.num_probes)
    stages.update({
        "host_prep": lambda: (pad_scan(scan.points, scan.rel_times, cap),
                              slam.imu.get_segment(scan.t, scan_end, SEG)),
        "step_packed_device": lambda: fe.step_packed(mstate, fstate, buf, cap, SEG),
        "host_pack_frame": pack,
        "step_plus_retire_fetch": retire,
    })
    return stages


def timeit(fn, n: int) -> tuple:
    """(seconds a call, fused_select launches a call): host clock around
    `n` calls after WARMUP, ending in a device synchronize."""
    from funny_lidar_slam_torch.ops import select

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    before = select.fused_select.launches
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / n
    return dt, (select.fused_select.launches - before) / n


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def profile(points: int = POINTS, trace: str | None = None, log=print) -> dict:
    """Run the profile on the card; returns the report."""
    from funny_lidar_slam_torch.core.device import resolve_device

    device = resolve_device(None)  # raises without CUDA
    slam, ds = warmed_system(points, device)
    scan = ds.scans[len(ds.scans) - 4]
    period = ds.scans[1].t - ds.scans[0].t
    stages = build_stages(slam, scan, period)

    secs, launches = {}, {}
    for name, fn in stages.items():
        secs[name], launches[name] = timeit(fn, n=CALLS.get(name, 20))
        log(f"  {name}: {secs[name] * 1e3:.3f} ms, {launches[name]:g} fused_select launches")
    # the live loop's retire interval over the warm-up run's second half
    trs = [s["tr"] for s in slam.stats if "tr" in s and not s.get("init")]
    if len(trs) > 12:
        half = np.diff(trs[len(trs) // 2:])
        kept = half[half < 5.0]
        secs["live_frame_wall"] = float(kept.sum() / max(len(kept), 1))
    gathers = int(stages["gn_matcher_match"]()[1].iters)

    if trace:
        os.makedirs(trace, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                stages["full_step"]()
            torch.cuda.synchronize()
        path = os.path.join(trace, "profile_torch_frontend.json")
        prof.export_chrome_trace(path)
        log(f"trace written to {path}")

    return {
        "device": torch.cuda.get_device_name(0), "card": card_line(),
        "points": points, "scan_index": len(ds.scans) - 4,
        "ms": {k: v * 1e3 for k, v in sorted(secs.items(), key=lambda kv: -kv[1])},
        "fused_select_launches": launches,
        "gn_gathers_at_profile": gathers,
        "est_fps_full_step": 1.0 / secs["full_step"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=POINTS)
    ap.add_argument("--trace", default=None, help="write a torch.profiler chrome trace here")
    args = ap.parse_args(argv)
    report = profile(args.points, args.trace)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
