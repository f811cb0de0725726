"""How chip_smoke.py's GN gates (`gn_compare`, `stepwise_compare`) hold the
LOAM GN kernels over many captures, where the phases see one: the
rank-deficient edge case of phase 21 on every IVOX first round, and the
gate on every captured call over repeated LOAM mapping runs.

    python3 tools/profile_torch_gn_gates.py [--rows 100] [--captures 2] [--seconds 300]
                                            [--starved-captures 6] [--starved-calls 4]
                                            [--out FILE]

Each capture runs a bench mapping config over the 10 s simulator run (seed
7, 16,384 points a scan) under chip_smoke.LoopCapture; the captures differ
from run to run.

  1. `--captures` runs of PointToPlane_IVOX. On each first round, N
     (`--rows`) rows spread evenly over its candidate set
     (`LOAM_RANK_DEFICIENT`'s construction, of which a few pass their
     plane fit): the whole call, kernel against plain version, with the
     phase's earlier gate (the same status, iterations and gathers,
     num_valid within 1 %, the pose within 0.05 m: `whole_call_gate`); the
     plain version against its float64-sums run on the same call, the same
     distances (how far the reference parts from itself there); and the
     gate now: the whole call's counters and a finite pose, and each
     iteration within `RANK_DEFICIENT_STEP_TOL` of one plain iteration from
     the same pose (`stepwise_compare`).
  2. For `--seconds`, runs of PointToPlane_IVOX, PointToPlane_KdTree and
     LoamFull_KdTree in turn: every captured call through `gn_compare` as
     phase 21 takes it; the calls held by the whole call (to the plain
     version or its float64-sums run), those held step by step instead,
     and those neither holds.
  3. `--starved-captures` runs each of PointToPlane_IVOX and LoamFull_KdTree:
     on `--starved-calls` first rounds of each (the last, as phase 21
     takes it, and others spread evenly), the starved edge case (min_valid
     above the rows, so that only the stall test ends the call): the whole
     call against the plain version and its float64-sums run (how often the
     counters part from both: phase 21's former gate), and the gate now
     (`chip_smoke.starved_compare`): the status and a finite pose, and
     each iteration with its stall test from the kernel's own pose and
     step norms (`stepwise_compare` with `stall`).

Prints a line a capture of part 1 and a mode of part 2, and one JSON line
last (also written to FILE). Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOAM_MAPPING = ("PointToPlane_IVOX", "PointToPlane_KdTree", "LoamFull_KdTree")


def capture(torch, cs, ds, mode) -> list:
    """[(kernel, args)] of every LOAM GN call of one mapping run of `mode`."""
    cs.LOAM_CAPTURES.pop(mode, None)
    with cs.LoopCapture(mode, loops=False):
        cs.bench_system(mode).run_dataset(ds)
    torch.cuda.synchronize()
    return cs.LOAM_CAPTURES[mode]


def rank_deficient(torch, cs, args) -> dict:
    """Part 1 on one subset's call."""
    from funny_lidar_slam_torch.ops import gn_loop

    kind = "plane_gn_rounds"
    r = cs.gn_compare(torch, args, kind)
    c64 = args[0].clone()
    with cs.float64_sums():
        gn_loop.plane_gn_rounds_plain(c64, *args[1:])
    v64 = gn_loop.result_views(c64)
    nv64, nv_plain = int(v64.num_valid), int(r["carry_p"][-2])
    steps = cs.stepwise_compare(torch, args, r, kind, cs.RANK_DEFICIENT_STEP_TOL)
    return {"valid_rows": nv_plain, "counters": {f: r[f] for f in ("status", "it", "gathers")},
            "counters64": r.get("counters64"), "finite": r["finite"],
            "whole_call_gate": r["same"] and r["nv_rel"] <= 0.01 and r["dp"] <= 0.05,
            "kernel_vs_plain_dp": r["dp"],
            "plain_vs_float64_dp": cs.pose_diff(r["t_p"], v64.t_mat)[0],
            "plain_vs_float64_nv_rel": abs(nv_plain - nv64) / max(nv64, 1),
            "stepwise": steps, "held": steps["held"] and r["same"] and r["finite"]}


def starved(torch, cs, kind, args) -> dict:
    """Part 3 on one first round's call."""
    n = sum(c.px.shape[0] for c in args[1:1 + cs.GN_SETS[kind]])
    call = cs.gn_with_cfg(args, min_valid=n + 1)
    r = cs.gn_compare(torch, call, kind)
    step = cs.starved_compare(torch, call, r, kind)
    return {"counters": {f: r[f] for f in ("status", "it", "gathers")},
            "counters64": r.get("counters64"), "dp": r["dp"], "finite": r["finite"],
            "whole_call_gate": r["same"] and r["close"] and r["finite"],
            "counters_part": not r["same"], "stepwise": step, "held": step["held"]}


def quantiles(np, values) -> list:
    return [float(np.quantile(values, p)) for p in (0.5, 0.95, 1)] if values else []


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100)
    ap.add_argument("--captures", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--starved-captures", type=int, default=6)
    ap.add_argument("--starved-calls", type=int, default=4)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_gn_gates.py needs a CUDA device")
    import chip_smoke as cs
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))
    out = {"rank_deficient": {"rows": a.rows, "captures": []}, "captured_calls": {}}
    for k in range(a.captures):
        calls = [rank_deficient(torch, cs, (c[0], cs.gn_rows(torch, c[1], a.rows), *c[2:]))
                 for c in cs.first_rounds(capture(torch, cs, ds, LOAM_MAPPING[0]),
                                          "plane_gn_rounds")]
        summary = {
            "first_rounds": len(calls),
            "valid_rows": [min(c["valid_rows"] for c in calls),
                           max(c["valid_rows"] for c in calls)],
            "whole_call_gate_held": sum(c["whole_call_gate"] for c in calls),
            "plain_vs_float64_within_0.05_m_and_1_pct": sum(
                c["plain_vs_float64_dp"] <= 0.05 and c["plain_vs_float64_nv_rel"] <= 0.01
                for c in calls),
            "held": sum(c["held"] for c in calls),
            "chains_bit_equal": sum(c["stepwise"]["chain_bit_equal"] for c in calls),
            "kernel_vs_plain_dp": quantiles(np, [c["kernel_vs_plain_dp"] for c in calls]),
            "plain_vs_float64_dp": quantiles(np, [c["plain_vs_float64_dp"] for c in calls]),
            **{f"step_{f}": quantiles(np, [c["stepwise"][f] for c in calls])
               for f in ("nv_rel", "res_rel", "dp", "da")},
            "not_held": [{f: c[f] for f in ("counters", "counters64", "finite", "stepwise")}
                         for c in calls if not c["held"]]}
        print(f"rank-deficient capture {k}: " + json.dumps(summary), flush=True)
        out["rank_deficient"]["captures"].append(summary)

    t_calls, runs = time.perf_counter(), 0
    by_mode = {m: {"captures": 0, "calls": 0, "same": 0, "whole_call": 0, "step_by_step": [],
                   "not_held": []} for m in LOAM_MAPPING}
    while time.perf_counter() - t_calls < a.seconds:
        mode = LOAM_MAPPING[runs % len(LOAM_MAPPING)]
        runs += 1
        m = by_mode[mode]
        m["captures"] += 1
        for kind, args in capture(torch, cs, ds, mode):
            r = cs.gn_compare(torch, args, kind)
            m["calls"] += 1
            m["same"] += r["same"]
            if not r["same"]:
                continue
            seen = {f: r[f] for f in ("dp", "da", "nv_rel", "res_rel", "dp64", "da64",
                                      "stepwise") if f in r}
            if not r["finite"] or r["dp"] > 0.05:  # phase 21's other gates
                m["not_held"].append(seen)
                continue
            if "stepwise" not in r:  # held by the whole call, else step by step
                m["whole_call"] += 1
            else:
                m["step_by_step" if r["close"] else "not_held"].append(seen)
    for mode, m in by_mode.items():
        print(f"captured calls, {mode}: " + json.dumps(m), flush=True)
    out["captured_calls"] = by_mode

    kinds = {"plane_gn_rounds": LOAM_MAPPING[0], "loam_gn_rounds": LOAM_MAPPING[2]}
    part3 = {kind: [] for kind in kinds}
    for k in range(a.starved_captures):
        for kind, mode in kinds.items():
            rounds = cs.first_rounds(capture(torch, cs, ds, mode), kind)
            pick = sorted({len(rounds) - 1, *np.linspace(0, len(rounds) - 1, a.starved_calls)
                           .round().astype(int).tolist()})[-a.starved_calls:]
            for i in pick:
                res = starved(torch, cs, kind, rounds[i])
                res.update(capture=k, first_round=i, last=i == len(rounds) - 1)
                part3[kind].append(res)
                print(f"starved {kind}, capture {k}, first round {i}: " + json.dumps(res),
                      flush=True)
    out["starved"] = {kind: {
        "calls": len(rs), "last_first_rounds": sum(r["last"] for r in rs),
        "counters_part": sum(r["counters_part"] for r in rs),
        "whole_call_gate_failed": sum(not r["whole_call_gate"] for r in rs),
        "held": sum(r["held"] for r in rs),
        "chains_bit_equal": sum(r["stepwise"]["chain_bit_equal"] for r in rs),
        "stall_end_held": sum(r["stepwise"]["stall_end_held"] for r in rs),
        "ended_on_stall": sum(r["stepwise"]["ended_on_stall"] for r in rs),
        "decisions_parted": sum(r["stepwise"]["decisions_parted"] for r in rs),
        "decisions_off_band": sum(r["stepwise"]["decisions_off_band"] for r in rs),
        "steps": sum(r["stepwise"]["steps"] for r in rs),
        "iterations_kernel": quantiles(np, [r["counters"]["it"][0] for r in rs]),
        "it_kernel_minus_plain": quantiles(np, [r["counters"]["it"][0] - r["counters"]["it"][1]
                                                for r in rs]),
        "whole_call_dp": quantiles(np, [r["dp"] for r in rs]),
        **{f"step_{f}": quantiles(np, [r["stepwise"][f] for r in rs])
           for f in ("nv_rel", "res_rel", "dp", "da")},
        "step_norm_diff_rot": quantiles(np, [r["stepwise"]["norm_diff"][0] for r in rs]),
        "step_norm_diff_pos": quantiles(np, [r["stepwise"]["norm_diff"][1] for r in rs]),
        "not_held": [r for r in rs if not r["held"]][:5]} for kind, rs in part3.items()}
    print("starved: " + json.dumps(out["starved"]), flush=True)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
