"""The LOAM front end's device spans and CUDA launches a scan, on one of the
bench's LOAM mapping configs, for the port in a given checkout; with
`--parent`, a parent checkout and this one in turns on one card.

    python3 tools/profile_torch_loam_frontend.py [--root DIR] [--mode MODE] [--out FILE]
    python3 tools/profile_torch_loam_frontend.py --parent DIR [--mode MODE] [--out FILE]

Runs funny_lidar_slam_torch from DIR (default: this checkout) over the 10 s
simulator run (seed 7), 16,384 points a scan, on the bench's config of MODE
(`bench_torch.mode_config`; default PointToPlane_IVOX, chip_smoke.py's
phase 7): a warm-up run, then
  * a traced run (chip_smoke.traced_run): CUDA-event spans, device ms a
    scan, around the front end's stages: `Frontend._process` (the whole
    LOAM front end of a scan), `project`, `extract_features`, its
    `corner_mask` where the checkout has one (else the
    corner selection is extract_features less the compactions), the two
    `_compact`s (one span) and the planar `voxel_downsample`;
  * a profiled run (torch.profiler): the CUDA launch calls a scan in all
    and inside each stage (a record_function range around it), the CUDA
    runtime calls by name, the ATen operator calls, and the device's busy
    ms a scan beside the wall ms (chip_smoke.profiled).
With `--parent DIR` it runs itself in a subprocess for DIR, this
checkout, this checkout and DIR, in that order, on one card, and prints
the four results with each side's medians. Prints one JSON line (also
written to FILE) with the card's name and `nvidia-smi` power limit. Needs
CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOAM_MODES = ("PointToPlane_IVOX", "PointToPlane_KdTree", "LoamFull_KdTree")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def stages(fe, features) -> list:
    """[(owner, attribute, span)] of the front end's stages in this checkout."""
    out = [(fe.Frontend, "_process", "front_end"), (fe, "project", "project"),
           (fe, "extract_features", "extract_features"), (features, "_compact", "compact"),
           (fe, "voxel_downsample", "planar_filter")]
    if not hasattr(features, "corner_mask"):  # a checkout before the corner kernel
        return out
    return out + [(features, "corner_mask", "corner_mask")]


def profile(root: str, mode: str) -> dict:
    """The spans and launch counts of the port in `root` (see the module
    docstring)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    import bench_torch as bench
    import chip_smoke
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.loam import features
    from funny_lidar_slam_torch.pipeline import frontend as fe
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_loam_frontend: CUDA is not available")
    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))

    def make():
        return SlamSystem(bench.mode_config(mode, 16384))

    make().run_dataset(ds)  # kernel builds and loads, the allocator
    torch.cuda.synchronize()
    patches = stages(fe, features)
    spans, traced_wall = chip_smoke.traced_run(torch, ds, make, patches)

    def ranged(name, fn):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for (owner, attr, name), (_, _, fn) in zip(patches, saved):
        setattr(owner, attr, ranged(name, fn))
    box = {}
    try:
        def run():
            box["slam"] = make()
            box["slam"].run_dataset(ds)

        prof, wall_ms, busy_ms = chip_smoke.profiled(torch, run)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    steps = sum(1 for s in box["slam"].stats if not s.get("init"))  # as traced_run counts
    evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    starts = np.sort([e.time_range.start for e in evs if e.name in LAUNCH_CALLS])
    inside = {}
    for _, _, name in patches:
        ranges = [(e.time_range.start, e.time_range.end) for e in evs if e.name == name]
        inside[name] = {"calls": len(ranges), "launches_per_call": sum(
            int(np.searchsorted(starts, hi) - np.searchsorted(starts, lo))
            for lo, hi in ranges) / max(len(ranges), 1)}
    runtime = {e.key: e.count / steps for e in prof.key_averages() if e.key.startswith("cuda")}
    aten = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    out = {"root": os.path.abspath(root), "mode": mode, "steps": steps,
           "span_ms_per_scan": spans, "traced_wall_s": traced_wall,
           "launches_per_scan": len(starts) / steps, "stage_launches": inside,
           "runtime_calls_per_scan": runtime, "aten_ops_per_scan": aten / steps,
           "profiled_wall_ms_per_scan": wall_ms / steps,
           "device_busy_ms_per_scan": busy_ms / steps if busy_ms is not None else None,
           "device": torch.cuda.get_device_name(0), "card": bench.card_line()}
    if "corner_mask" not in spans:  # the parent: the selection is what the compactions leave
        out["corner_selection_ms_per_scan"] = spans["extract_features"] - spans["compact"]
    else:
        out["corner_selection_ms_per_scan"] = spans["corner_mask"]
    return out


def in_turns(parent: str, mode: str) -> dict:
    """This tool for the parent, this checkout, this checkout and the
    parent, each in its own process."""
    turns = []
    for side, root in (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                               "--mode", mode], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{side} ({root}) failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"[{side}] {time.perf_counter() - t:.1f} s: {json.dumps(res)}")
        turns.append((side, res))

    def median(side, get):
        return float(np.median([get(r) for s, r in turns if s == side]))

    keys = sorted({k for _, r in turns for k in r["span_ms_per_scan"]})
    summary = {side: {"span_ms_per_scan": {k: median(side, lambda r, k=k: r["span_ms_per_scan"]
                                                      .get(k, float("nan"))) for k in keys},
                      "launches_per_scan": median(side, lambda r: r["launches_per_scan"]),
                      "front_end_launches_per_call": median(
                          side, lambda r: r["stage_launches"]["front_end"]["launches_per_call"]),
                      "extract_features_launches_per_call": median(
                          side, lambda r: r["stage_launches"]["extract_features"]
                          ["launches_per_call"]),
                      "corner_selection_ms_per_scan": median(
                          side, lambda r: r["corner_selection_ms_per_scan"])}
               for side in ("parent", "change")}
    return {"mode": mode, "order": [s for s, _ in turns], "turns": [r for _, r in turns],
            "median": summary, "device": turns[0][1]["device"], "card": turns[0][1]["card"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--mode", default=LOAM_MODES[0], choices=LOAM_MODES)
    ap.add_argument("--parent", default=None, help="a parent checkout, run in turns with this one")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    out = in_turns(args.parent, args.mode) if args.parent else profile(args.root, args.mode)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
