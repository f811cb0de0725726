"""Time the step's loop kernels, `tight_fuse` (csrc/tight_fuse.cu),
`preintegrate` and `eskf_predict` (csrc/imu_scan.cu), on captured and
synthetic inputs, for this checkout's kernels and, with `--parent DIR`, a
parent checkout's kernels, in turns on one card; or, with `--gn`, the GN
kernels; or, with `--corners`, the LOAM corner kernel.

    python3 tools/profile_torch_loops.py [--parent DIR] [--stages] [--out FILE]
    python3 tools/profile_torch_loops.py --gn [--parent DIR] [--stages] [--out FILE]
    python3 tools/profile_torch_loops.py --corners [--parent DIR] [--repeats 3] [--out FILE]

Captures the arguments of every `preintegrate`, `eskf.predict` and
`tight.fuse` call of three runs of the port on the card: chip_smoke.py's
phase-4 grid config (IcpOptimized + TightCouplingOptimization, 16,384
points a scan, 16 IMU slots, 12 LM iterations) and phase 11's (the same
with TightCouplingKF) over the 10 s simulator run (seed 7), and the M2DGR
preset (configs/mapping/config_M2DGR.yaml: 57,600 points, 64 slots, 20 LM
iterations) over a 6 s run. On the last call of each it times:

  * `tight_fuse` at the grid call with `iterations` 0 (set-up, the
    posterior, the marginalization and the PSD projection alone), 1 and
    12, and at the M2DGR call with 20;
  * `preintegrate` at the grid call (16 slots), the M2DGR call (64) and a
    64-slot segment with every slot valid (chip_smoke.loop_edge_cases);
  * `eskf_predict` at the KF call (16 slots) and a 64-slot segment with
    every slot valid.

Each case is timed two ways, each the median device ms of one call over
50 calls queued behind a device sleep (chip_smoke.time_ms): the wrapper
(`ops/recurrences.py`: packing, output allocation and the launch) and the
bare launch on a buffer packed beforehand. With `--parent`, the parent's
`imu_scan.cu` and `tight_fuse.cu` (same C entry points and layouts) are
built beside this checkout's and the two libraries alternate in turns
(parent, change, change, parent) on the same inputs; each case also
reports the largest difference between the two outputs and whether they
are equal. Every case is held against the plain version too. With
`--stages`, this checkout's two sources are also built with
-DFLS_STAGE_CLOCKS (csrc/stage_clock.cuh) and each case is run once more
on that build, which writes the SM cycles its thread 0 spent in each stage
after the output (`stage_cycles`, beside nvidia-smi's SM clocks). Prints
ptxas's registers, spills and shared memory of each build, and one JSON
line last (also written to FILE). Needs CUDA; imports nothing of JAX.

`--gn` times the GN kernels of csrc/gn_loop.cu instead: `icp_gn_rounds`
(`icp_gn_kernel`), `plane_gn_rounds` and `loam_gn_rounds`
(`loam_gn_kernel`) and `ndt_gn_rounds` (`ndt_gn_kernel`). It captures
every call of the round drivers (chip_smoke.LoopCapture) in runs of the
grid headline config and the bench's PointToPlane_IVOX,
PointToPlane_KdTree, LoamFull_KdTree and IncrementalNDT mapping configs
over the 10 s simulator run (16,384 points a scan), of the Turing
ICP preset (configs/mapping/config_turing_icp.yaml) over the same run at
28,800 points and of the M2DGR preset over a 6 s run (57,600 points), and
the NDT stages of the loop verifications of the bench's Figure8_Loop run
(chip_smoke.figure8_system, 212 scans). On each path it replays every
call on each build (the status, iterations and gathers each gives, and
the largest pose difference from the parent's) and times the path's last
first round and its call with the most iterations (on the figure-8, each
of the first verification's four NDT stages): the median device ms of
one wrapper call over 50, queued
behind a device sleep, each from its own copy of the carry, in turns
(parent, change, change, parent), with ms per iteration. It also replays
chip_smoke.py's phase-20 and phase-21 edge cases (`icp_edge_cases` on the
grid's first round, `loam_edge_cases` on the captured IVOX and LoamFull
first rounds) and phase 22's (`ndt_edge_cases` on the last NDT call) on
each build: whether each gives the parent's carry bit for bit, and its
pose difference from the parent's and from the plain version's. The
parent's `gn_loop.cu` has the same C entry points, or lacks
`ndt_gn_launch` (a parent from before the NDT kernel): its NDT rows then
give the change alone; a parent whose `ndt_gn_launch` takes the map's
fingerprints `fp` [C] where this one takes its probe windows `fpwin` [C,
16] and a slot cache (the kernel that walked each window slot by slot) is
handed `fp` there and no cache (`ndt_launch`). NDT is also run and timed
on this checkout's build given no slot cache (`change_no_kept_slots`:
every iteration looks up afresh, the same result), so the turns are
parent, change, no kept slots, no kept slots, change, parent. With
`--stages`, this checkout's `gn_loop.cu` built with -DFLS_STAGE_CLOCKS runs
each timed call once more and reports rank 0's SM cycles an iteration in
each stage of the kernel (the K_* enum: set-up, thread 0's rows, its
block's sum, the wait at the cluster barrier, the distributed shared memory
sum, the serial end and begin of an iteration, the last barrier), NDT's
with and without kept slots.

`--corners` times the LOAM corner kernel of csrc/loam_features.cu
(`loam_corners_launch`) instead: this checkout's build, a build of the
same source with -DFLS_CORNER_KEYS_IN_SMEM (`smem_keys`: warp 0's pick
keys in shared memory at every l_max, where the launcher keeps them in
registers up to 512 lanes) and, with `--parent`, the parent's. Every
build's corner mask must equal corner_mask_plain's bit for bit on
chip_smoke.feature_edge_cases and at the two timed shapes:
  * bench: the "bench" edge case (16,384 slots, 16 rows of 900 columns,
    172 lanes a block);
  * m2dgr: the last scan of a 1 s simulator run at 57,600 points (seed 7),
    padded to 65,536 slots as the M2DGR preset's capacity pads it, on 32
    rows of 1,800 columns (343 lanes a block).
At each shape it runs phase 23's timing (chip_smoke.feature_timing: the
wrapper, the bare launch, each other build's bare launch, the plain
version and one empty launch, in turns, with the bound) `--repeats` times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M2DGR = os.path.join("configs", "mapping", "config_M2DGR.yaml")
TURING = os.path.join("configs", "mapping", "config_turing_icp.yaml")
LIBS = ("imu_scan", "tight_fuse")
# the stage clocks of csrc/imu_scan.cu's and csrc/tight_fuse.cu's C_* enums
STAGES = {"preintegrate": ("init", "slots", "prefix", "blocks", "serial", "output"),
          "eskf_predict": ("init", "slots", "prefix", "blocks", "serial", "output"),
          "tight_fuse": ("setup", "factors", "lam_j", "h", "eliminate", "substitute",
                         "trial", "solve_wait", "jacobi_marg", "products", "jacobi_psd",
                         "output")}
CLOCKS = 16  # kStageClocks of csrc/stage_clock.cuh


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def capture_calls(torch, system_config, ds, device="cuda") -> dict:
    """{"preintegrate": [args], "eskf_predict": [args], "tight_fuse": [args]}
    of every call the frontend step makes in one `run_dataset`, cloned on
    their device."""
    from funny_lidar_slam_torch.fusion import eskf
    from funny_lidar_slam_torch.pipeline import frontend as fe
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    import chip_smoke

    hooks = {"preintegrate": (fe, "preintegrate"), "eskf_predict": (eskf, "predict"),
             "tight_fuse": (fe, "tight_fuse")}
    calls = {name: [] for name in hooks}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in hooks.items()}

    def wrap(name):
        def fn(*args):
            calls[name].append(chip_smoke.clone_tree(args))
            return saved[name](*args)
        return fn

    for name, (mod, attr) in hooks.items():
        setattr(mod, attr, wrap(name))
    try:
        SlamSystem(system_config, device=device).run_dataset(ds)
    finally:
        for name, (mod, attr) in hooks.items():
            setattr(mod, attr, saved[name])
    if device != "cpu":
        torch.cuda.synchronize()
    return calls


def build_variant(root: str, tag: str, names=LIBS) -> dict:
    """nvcc of the sources `names` of the checkout at `root` (a parent) with
    this checkout's flags into build/kernels/<tag>/, one process each, all
    started together: {name: (library path, nvcc output)}."""
    from funny_lidar_slam_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(root, "funny_lidar_slam_torch", "csrc", f"{name}.cu")
        lib = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{text}")
        built[name] = (str(lib), text)
    return built


def load(name: str, path: str) -> ctypes.CDLL:
    from funny_lidar_slam_torch.ops import cuda_build

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in cuda_build.SIGNATURES[name].items():
        if not hasattr(lib, fn):  # an entry point a parent lacks
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def use_libs(libs: dict) -> None:
    """Make `libs` ({name: library}) the libraries the wrappers call."""
    from funny_lidar_slam_torch.ops import cuda_build

    cuda_build._loaded.update({(name, ()): lib for name, lib in libs.items()})


def bare_launch(torch, kind, args, extra_out=0):
    """A function that launches the kernel of the library loaded now on a
    buffer packed here once (no packing, no allocation a call), and its
    output buffer (`extra_out` floats longer than the layout's)."""
    from funny_lidar_slam_torch.ops import cuda_build, recurrences as rec

    if kind == "preintegrate":
        buf, slots, has_init = rec.pack_preintegrate(*args)
        layout, extra = rec.PREINT_STATE, (slots, has_init)
        lib, fn = "imu_scan", "preintegrate_launch"
    elif kind == "eskf_predict":
        state, seg, params, g = args
        buf = rec.pack_eskf(state.nav, state.cov, seg, params)
        layout, extra = rec.ESKF_OUT, (int(seg.t.shape[0]), *rec._host3("eskf_predict", g))
        lib, fn = "imu_scan", "eskf_predict_launch"
    else:
        last, pre, pose, pred, g, cfg = args
        buf = rec.pack_tight(last, pre, pose, pred)
        layout = rec.TIGHT_OUT
        extra = (*rec._host3("tight_fuse", g), int(cfg.iterations),
                 float(cfg.lidar_rotation_std) ** 2, float(cfg.lidar_position_std) ** 2,
                 float(cfg.gyro_rw_std) ** 2, float(cfg.acc_rw_std) ** 2)
        lib, fn = "tight_fuse", "tight_fuse_launch"
    out = torch.zeros(rec._size(layout) + extra_out, dtype=torch.float32, device=buf.device)
    launch = getattr(cuda_build.library(lib), fn)
    stream = torch.cuda.current_stream(buf.device).cuda_stream

    def run():
        err = launch(buf.data_ptr(), out.data_ptr(), *extra, stream)
        assert err == 0, f"{fn}: CUDA error {err}"
    return run, out


def flat_output(torch, kind, args):
    from funny_lidar_slam_torch.fusion import eskf
    from funny_lidar_slam_torch.ops import recurrences as rec

    if kind == "eskf_predict":
        out = eskf.predict(*args)
        out = (out.nav.r, out.nav.v, out.nav.p, out.cov)
    else:
        out = rec.preintegrate(*args) if kind == "preintegrate" else rec.tight_fuse(*args)
    return torch.cat([o.reshape(-1).float() for o in out])


GN_PATHS = ("grid", "PointToPlane_IVOX", "PointToPlane_KdTree", "LoamFull_KdTree",
            "IncrementalNDT", "turing", "m2dgr", "figure8")
NDT_STAGES = 4  # the NDT stages of a loop verification's cascade
def capture_gn(torch, cs, bench) -> dict:
    """{path: [(kernel, args)]} of every GN round-driver call in one run of
    each of GN_PATHS (chip_smoke.LoopCapture), cloned on the card."""
    from funny_lidar_slam_torch.config import load_config
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))
    runs = {"grid": (cs.grid_system, ds)}
    runs.update({mode: (lambda mode=mode: SlamSystem(bench.mode_config(mode, 16384)), ds)
                 for mode in GN_PATHS[1:5]})
    runs["turing"] = (lambda: SlamSystem(load_config(os.path.join(ROOT, TURING)).system),
                      simulate(SimConfig(duration=10.0, points_per_scan=28800, seed=7)))
    runs["m2dgr"] = (lambda: SlamSystem(load_config(os.path.join(ROOT, M2DGR)).system),
                     simulate(SimConfig(duration=6.0, points_per_scan=57600, seed=7)))
    sim_cfg, traj = bench.figure8_sim(16384)
    runs["figure8"] = (cs.figure8_system, simulate(sim_cfg, traj=traj))
    for key, (make, data) in runs.items():
        with cs.LoopCapture(key, loops=False):
            make().run_dataset(data)
        torch.cuda.synchronize()
    out = {key: [("icp_gn_rounds", a) for a in cs.GN_CAPTURES[key]] + cs.LOAM_CAPTURES[key]
           + [("ndt_gn_rounds", a) for a in cs.NDT_CAPTURES[key]] for key in runs}
    # the figure-8's loop verifications: their NDT cascade stages alone
    out["figure8"] = [("ndt_gn_rounds", a) for a in cs.NDT_CAPTURES["figure8"]]
    return out


# the builds whose ndt_gn_launch takes fp [C] as its third pointer, and
# that entry point's argument types there (no slot cache)
FP_BUILDS: set = set()
FP_NDT_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] * 5 + [
    ctypes.c_void_p]
# this checkout's build with NDT given no slot cache: every iteration looks
# up afresh, so its turns against "change" time the kept slots
NO_KEPT_SLOTS = "change_no_kept_slots"


def takes_fp(root: str) -> bool:
    """Whether the checkout at `root` has an ndt_gn_launch whose map
    argument is the fingerprints `fp` [C] rather than the windows `fpwin`."""
    import re

    text = open(os.path.join(root, "funny_lidar_slam_torch", "csrc", "gn_loop.cu")).read()
    params = re.search(r'extern "C" int ndt_gn_launch\(([^)]*)\)', text)
    return bool(params) and re.search(r"\bconst long long\* fp\b", params.group(1)) is not None


def ndt_launch(torch, lib, carry, call, fp: bool = False, keep_slots: bool = True):
    """ndt_gn_launch of the build `lib` on a captured ndt_gn_rounds call's
    inputs with `carry`, its arguments built here as the wrapper builds
    them: with `fp`, the map's fingerprints `fp` [C] where the windows
    `fpwin` go and no slot cache (a build in FP_BUILDS); without
    `keep_slots`, a null slot cache. Returns the carry."""
    from funny_lidar_slam_torch.ops import gn_loop

    _, src, mask, m, inv, thresh, _, cfg, *rest = call
    tensors = gn_loop._checked_ndt_inputs(carry, src, mask, m)
    if fp:
        tensors[2] = m.fp.contiguous()
    elif keep_slots:
        tensors.append(torch.empty((src.shape[0], 12), dtype=torch.int32, device=carry.device))
    ptrs = [t.data_ptr() for t in tensors] + ([] if fp or keep_slots else [None])
    err = lib.ndt_gn_launch(*ptrs, src.shape[0], m.fpwin.shape[0], int(rest[0] if rest else 8),
                            *gn_loop._loop_args(cfg, schedule=False), float(inv), float(thresh),
                            torch.cuda.current_stream(carry.device).cuda_stream)
    assert err == 0, f"ndt_gn_launch: CUDA error {err}"
    return carry


def run_build(torch, v, lib, kind, carry, call):
    """`kind` on `carry` with a captured call's other inputs on the build
    `lib` (version `v`): NDT through `ndt_launch`, the others through their
    wrapper with `lib` as the gn_loop library it calls. Returns the carry."""
    from funny_lidar_slam_torch.ops import cuda_build, gn_loop

    if kind == "ndt_gn_rounds":
        return ndt_launch(torch, lib, carry, call, fp=v in FP_BUILDS,
                          keep_slots=v != NO_KEPT_SLOTS)
    cuda_build._loaded[("gn_loop", ())] = lib
    getattr(gn_loop, kind)(carry, *call[1:])
    return carry


def builds_of(versions: dict, kind: str) -> dict:
    """The builds that have `kind`'s entry point (a parent from before the
    NDT kernel lacks ndt_gn_launch); NDT's also this checkout's without
    kept slots."""
    if kind != "ndt_gn_rounds":
        return dict(versions)
    builds = {v: lib for v, lib in versions.items() if hasattr(lib, "ndt_gn_launch")}
    builds[NO_KEPT_SLOTS] = versions["change"]
    return builds


def rows_of(cs, kind, call) -> list:
    """The rows of a captured call: each candidate set's, or NDT's source."""
    if kind == "ndt_gn_rounds":
        return [call[1].shape[0]]
    return [c.px.shape[0] for c in call[1:1 + cs.GN_SETS[kind]]]


def gn_edge_cases(torch, cs, captured, versions) -> dict:
    """chip_smoke.py's phase-20 and phase-21 edge cases on the captured
    grid, IVOX and LoamFull first rounds, replayed on each build: {case:
    {build: whether its carry is the parent's bit for bit, its pose
    difference from the parent's and from the plain version's}}."""
    from funny_lidar_slam_torch.ops import gn_loop

    icp_args = cs.first_rounds(captured["grid"], "icp_gn_rounds")[-1]
    plane_args = cs.first_rounds(captured["PointToPlane_IVOX"], "plane_gn_rounds")[-1]
    loam_args = cs.first_rounds(captured["LoamFull_KdTree"], "loam_gn_rounds")[-1]
    cases = [(name, "icp_gn_rounds", args) for name, args in cs.icp_edge_cases(torch, icp_args)]
    cases += cs.loam_edge_cases(torch, plane_args, loam_args)
    ndt_calls = [a for k, a in captured["IncrementalNDT"] if k == "ndt_gn_rounds"]
    its = []
    for a in ndt_calls:  # the plain version's iterations of each call
        c = a[0].clone()
        gn_loop.ndt_gn_rounds_plain(c, *a[1:])
        its.append(int(c[gn_loop.OFFSET["it"]]))
    longest = ndt_calls[int(np.argmax(its))]
    cases += [(name, "ndt_gn_rounds", args)
              for name, args in cs.ndt_edge_cases(torch, ndt_calls[-1], longest)]
    out = {}
    for name, kind, args in cases:
        plain = args[0].clone()
        getattr(gn_loop, f"{kind}_plain")(plain, *args[1:])
        carries = {v: run_build(torch, v, lib, kind, args[0].clone(), args)
                   for v, lib in builds_of(versions, kind).items()}
        ref = carries.get("parent", carries["change"])
        row = {}
        for v, c in carries.items():
            dp, da = cs.pose_diff(gn_loop.result_views(c).t_mat, gn_loop.result_views(ref).t_mat)
            pp, pa = cs.pose_diff(gn_loop.result_views(c).t_mat, gn_loop.result_views(plain).t_mat)
            row[v] = {"bit_equal_to_parent": bool(torch.equal(c, ref)), "dp_vs_parent": dp,
                      "da_vs_parent": da, "dp_vs_plain": pp, "da_vs_plain": pa,
                      "same_counters_as_parent": c[gn_loop.OFFSET["it"]:].tolist()
                      == ref[gn_loop.OFFSET["it"]:].tolist()}
        out[name] = row
    log(f"[gn] edge cases: {json.dumps(out)}")
    return out


def gn_main(args, torch, cs, bench) -> dict:
    """--gn: the GN kernels of the builds, in turns on captured calls."""
    from funny_lidar_slam_torch.ops import cuda_build, gn_loop

    t0 = time.perf_counter()
    logs = cuda_build.build_all(["gn_loop"], [cs.STAGED_GN] if args.stages else [])
    versions = {"change": cuda_build.library("gn_loop")}
    ptxas = {"change": cs.ptxas_report(logs[("gn_loop", ())])}
    staged = None
    if args.stages:
        staged = cuda_build.variant(*cs.STAGED_GN)
        ptxas["stages"] = cs.ptxas_report(logs[cs.STAGED_GN])
    if args.parent:
        root = os.path.abspath(args.parent)
        (path, text), = build_variant(root, "parent", ("gn_loop",)).values()
        versions["parent"] = load("gn_loop", path)
        ptxas["parent"] = cs.ptxas_report(text)
        if takes_fp(root):
            FP_BUILDS.add("parent")
            versions["parent"].ndt_gn_launch.argtypes = FP_NDT_ARGTYPES
    log(f"[gn] built in {time.perf_counter() - t0:.1f} s; ptxas {json.dumps(ptxas)}")
    blocks = {k: gn_loop.cluster_blocks(k) for k in gn_loop.CLUSTER_KIND}
    t0 = time.perf_counter()
    captured = capture_gn(torch, cs, bench)
    log(f"[gn] captured {({k: len(v) for k, v in captured.items()})} calls in "
        f"{time.perf_counter() - t0:.1f} s")
    order = ["parent", "change", "change", "parent"] if args.parent else ["change", "change"]
    ndt_order = ["parent", "change", NO_KEPT_SLOTS, NO_KEPT_SLOTS, "change", "parent"]
    o = gn_loop.OFFSET
    result = {"device": torch.cuda.get_device_name(0), "card": bench.card_line(),
              "ptxas": ptxas, "cluster_blocks": blocks, "order": order, "ndt_order": ndt_order,
              "paths": {}}

    for key, calls in captured.items():
        kind = calls[0][0]
        assert all(k == kind for k, _ in calls), f"[gn] {key}: two kernels"
        calls = [a for _, a in calls]
        builds = builds_of(versions, kind)
        outs = {v: [run_build(torch, v, lib, kind, a[0].clone(), a) for a in calls]
                for v, lib in builds.items()}
        its = [int(c[o["it"]]) - int(a[0][o["it"]]) for c, a in zip(outs["change"], calls)]
        row = {"kernel": kind, "calls": len(calls), "iterations": int(sum(its)), "versions": {}}
        for v, carries in outs.items():
            same = [c[o["it"]:].tolist() == p[o["it"]:].tolist()
                    for c, p in zip(carries, outs.get("parent", outs["change"]))]
            diffs = [cs.pose_diff(gn_loop.result_views(c).t_mat, gn_loop.result_views(p).t_mat)
                     for c, p in zip(carries, outs.get("parent", outs["change"]))]
            row["versions"][v] = {
                "same_counters_as_parent": sum(same) / len(same),
                "bit_equal_to_change": all(torch.equal(c, d)
                                           for c, d in zip(carries, outs["change"])),
                "max_dp_vs_parent_m": max(d[0] for d in diffs),
                "max_da_vs_parent_rad": max(d[1] for d in diffs)}
        first = [i for i, a in enumerate(calls) if int(a[0][o["it"]]) == 0][-1]
        most = max(range(len(calls)), key=lambda i: its[i])
        shapes = [("first_round", first), ("most_iterations", most)]
        if key == "figure8":  # the first verification's cascade, stage by stage
            shapes = [(f"cascade_stage_{k}_inv_{float(calls[k][4]):g}", k)
                      for k in range(min(NDT_STAGES, len(calls)))]
        row["shapes"] = {}
        for label, i in shapes:
            call = calls[i]
            ms = {}
            for v in (v for v in (ndt_order if kind == "ndt_gn_rounds" else order)
                      if v in builds):
                pool, used = call[0].repeat(64, 1), [0]

                def run(call=call, pool=pool, used=used, v=v):
                    carry = pool[used[0]]
                    used[0] += 1
                    return run_build(torch, v, builds[v], kind, carry, call)

                ms.setdefault(v, []).append(cs.time_ms(torch, run, 50))
            n = rows_of(cs, kind, call)
            med = {v: float(np.median(t)) for v, t in ms.items()}
            row["shapes"][label] = {
                "rows": n, "iterations": its[i], "ms": ms, "ms_median": med,
                "ms_per_iteration": {v: t / max(its[i], 1) for v, t in med.items()}}
            if staged:
                row["shapes"][label]["stage_cycles_per_iteration"] = cs.gn_stage_cycles(
                    torch, staged, kind, call)
                if kind == "ndt_gn_rounds":
                    row["shapes"][label]["stage_cycles_per_iteration_no_kept_slots"] = \
                        cs.gn_stage_cycles(torch, staged, kind, call, keep_slots=False)
        log(f"[gn] {key}: {json.dumps(row)}")
        result["paths"][key] = row
    result["edge_cases"] = gn_edge_cases(torch, cs, captured, versions)
    cuda_build._loaded[("gn_loop", ())] = versions["change"]
    result["empty_launch_ms"] = [cs.time_ms(torch, lambda: torch.cuda._sleep(0), 50)
                                 for _ in range(2)]
    result["sm_clocks_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a parent checkout whose kernel sources to time beside")
    ap.add_argument("--stages", action="store_true",
                    help="also run a build with per-stage cycle counters (either mode)")
    ap.add_argument("--gn", action="store_true",
                    help="time the GN kernels (csrc/gn_loop.cu) instead")
    ap.add_argument("--corners", action="store_true",
                    help="time the LOAM corner kernel (csrc/loam_features.cu) instead")
    ap.add_argument("--repeats", type=int, default=3, help="--corners: timing repeats a shape")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import bench_torch as bench
    import chip_smoke as cs
    from funny_lidar_slam_torch.config import load_config
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_loops: CUDA is not available")
    card = bench.card_line()
    log(f"[loops] {torch.cuda.get_device_name(0)} | {card}")
    if args.gn or args.corners:
        result = gn_main(args, torch, cs, bench) if args.gn else corners_main(args, torch, cs)
        result["card"] = card
        write(result, args.out)
        return result
    t0 = time.perf_counter()
    logs = cuda_build.build_all(LIBS)
    versions = {"change": {name: cuda_build.library(name) for name in LIBS}}
    ptxas = {"change": {name: cs.ptxas_report(text) for (name, _), text in logs.items()}}
    if args.parent:
        built = build_variant(os.path.abspath(args.parent), "parent")
        versions["parent"] = {name: load(name, path) for name, (path, _) in built.items()}
        ptxas["parent"] = {name: cs.ptxas_report(text) for name, (_, text) in built.items()}
    staged = None
    if args.stages:
        flags = ("-DFLS_STAGE_CLOCKS",)
        built = cuda_build.build_all([], [(name, flags) for name in LIBS])
        staged = {name: cuda_build.variant(name, flags) for name in LIBS}
        ptxas["stages"] = {name: cs.ptxas_report(built[(name, flags)]) for name in LIBS}
    log(f"[loops] built in {time.perf_counter() - t0:.1f} s; ptxas {json.dumps(ptxas)}")

    t0 = time.perf_counter()
    grid = capture_calls(torch, bench.headline_config(16384, "TightCouplingOptimization"),
                         simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7)))
    kf = capture_calls(torch, bench.headline_config(16384, "TightCouplingKF"),
                       simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7)))
    m2dgr = capture_calls(torch, load_config(os.path.join(ROOT, M2DGR)).system,
                          simulate(SimConfig(duration=6.0, points_per_scan=57600, seed=7)))
    log(f"[loops] captured {len(grid['tight_fuse'])} grid and {len(m2dgr['tight_fuse'])} "
        f"M2DGR fuse calls and {len(kf['eskf_predict'])} KF predict calls in "
        f"{time.perf_counter() - t0:.1f} s")
    fuse_grid, fuse_m2dgr = grid["tight_fuse"][-1], m2dgr["tight_fuse"][-1]
    edge = dict(cs.loop_edge_cases(torch, grid["preintegrate"][-1], fuse_grid,
                                   kf["eskf_predict"][-1]))
    cases = {
        "tight_fuse_grid_it0": ("tight_fuse", cs.with_iterations(fuse_grid, 0)),
        "tight_fuse_grid_it1": ("tight_fuse", cs.with_iterations(fuse_grid, 1)),
        "tight_fuse_grid_it12": ("tight_fuse", cs.with_iterations(fuse_grid, 12)),
        "tight_fuse_m2dgr_it20": ("tight_fuse", cs.with_iterations(fuse_m2dgr, 20)),
        "preintegrate_grid_16": ("preintegrate", grid["preintegrate"][-1]),
        "preintegrate_m2dgr_64": ("preintegrate", m2dgr["preintegrate"][-1]),
        "preintegrate_all_valid_64": edge["preintegrate_all_valid_64"],
        "eskf_predict_kf_16": ("eskf_predict", kf["eskf_predict"][-1]),
        "eskf_predict_all_valid_64": edge["eskf_predict_all_valid_64"],
    }
    order = ["parent", "change", "change", "parent"] if args.parent else ["change", "change"]
    result = {"device": torch.cuda.get_device_name(0), "card": card, "ptxas": ptxas,
              "cases": {}}
    for name, (kind, cargs) in cases.items():
        row = {"kind": kind}
        outs = {}
        for v, libs in versions.items():
            use_libs(libs)
            outs[v] = flat_output(torch, kind, cargs)
            errs = cs.loop_compare(torch, kind, cargs)
            row[f"{v}_vs_plain"] = {k: errs[k] for k in errs if k not in ("ok", "close")}
        if "parent" in outs:
            d = (outs["change"] - outs["parent"]).abs()
            row["change_vs_parent_max"] = float(d.max())
            row["change_vs_parent_equal"] = bool(torch.equal(outs["change"], outs["parent"]))
        if kind == "tight_fuse":
            from funny_lidar_slam_torch.ops import recurrences as rec

            o = rec._size(rec.TIGHT_OUT) - 3
            row["lm_iterations"] = {v: float(x[o]) for v, x in outs.items()}
            row["sweeps"] = {v: x[o + 1:].tolist() for v, x in outs.items()}
        else:
            seg = cargs[0] if kind == "preintegrate" else cargs[1]
            row["slots"] = int(seg.t.shape[0])
            row["valid_slots"] = cs.valid_slots(seg)
        wrapper, bare = {}, {}
        for v in order:
            use_libs(versions[v])
            fn = cs.loop_entry(kind)[0]
            wrapper.setdefault(v, []).append(cs.time_ms(torch, lambda: fn(*cargs), 50))
            bare.setdefault(v, []).append(cs.time_ms(torch, bare_launch(torch, kind, cargs)[0],
                                                     50))
        row["wrapper_ms"], row["bare_ms"] = wrapper, bare
        if staged:
            use_libs(staged)
            run, out = bare_launch(torch, kind, cargs, CLOCKS)
            run()
            run()
            torch.cuda.synchronize()
            cycles = out[-CLOCKS:].tolist()
            row["stage_cycles"] = {**dict(zip(STAGES[kind], cycles)), "total": sum(cycles)}
        row["wrapper_ms_median"] = {v: float(np.median(t)) for v, t in wrapper.items()}
        row["bare_ms_median"] = {v: float(np.median(t)) for v, t in bare.items()}
        log(f"[loops] {name}: {json.dumps(row)}")
        result["cases"][name] = row
    use_libs(versions["change"])
    floor = [cs.time_ms(torch, lambda: torch.cuda._sleep(0), 50) for _ in range(2)]
    result["empty_launch_ms"] = floor
    result["sm_clocks_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    write(result, args.out)
    return result


M2DGR_SLOTS = 65536
SMEM_KEYS = ("loam_features", ("-DFLS_CORNER_KEYS_IN_SMEM",))


def m2dgr_scan(torch):
    """The M2DGR shape: 57,600 simulated points padded to 65,536 slots,
    projected on 32 rows of 1,800 columns."""
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.loam.features import FeatureConfig
    from funny_lidar_slam_torch.loam.projection import LidarGeometry, project, synth_rings

    scan = simulate(SimConfig(duration=1.0, static_warmup=0.2, points_per_scan=57600,
                              seed=7)).scans[-1]
    n = len(scan.points)
    pts = torch.zeros((M2DGR_SLOTS, 3), dtype=torch.float32, device="cuda")
    pts[:n] = torch.as_tensor(scan.points.astype(np.float32), device="cuda")
    rel = torch.zeros(M2DGR_SLOTS, dtype=torch.float32, device="cuda")
    rel[:n] = torch.as_tensor(scan.rel_times.astype(np.float32), device="cuda")
    mask = torch.arange(M2DGR_SLOTS, device="cuda") < n
    geom = LidarGeometry(32, 1800, 2 * np.pi / 1800, 1.5, 50.0)
    return project(pts, synth_rings(pts, 32), rel, mask, geom), FeatureConfig()


def corners_main(args, torch, cs) -> dict:
    """--corners: the LOAM corner kernel's builds, checked and timed."""
    from funny_lidar_slam_torch.ops import cuda_build

    logs = cuda_build.build_all(["loam_features"], [SMEM_KEYS])
    builds = {"change": cuda_build.library("loam_features"),
              "smem_keys": cuda_build.variant(*SMEM_KEYS)}
    ptxas = {"change": cs.ptxas_report(logs[("loam_features", ())]),
             "smem_keys": cs.ptxas_report(logs[SMEM_KEYS])}
    if args.parent:
        (path, text), = build_variant(os.path.abspath(args.parent), "parent",
                                      ("loam_features",)).values()
        builds["parent"] = load("loam_features", path)
        ptxas["parent"] = cs.ptxas_report(text)
    log(f"[corners] ptxas {json.dumps(ptxas)}")
    cases = cs.feature_edge_cases(torch)
    shapes = {"bench": next((scan, cfg) for name, scan, cfg in cases if name == "bench"),
              "m2dgr": m2dgr_scan(torch)}
    parity = {}
    try:
        for name, scan, cfg in cases + [(f"{k} shape", *v) for k, v in shapes.items()]:
            parity[name] = {}
            for b, lib in builds.items():
                use_libs({"loam_features": lib})
                parity[name][b] = cs.feature_parity(torch, scan, cfg, f"{name}, {b}")["equal"]
            assert all(parity[name].values()), f"{name}: a build parts from the plain version"
    finally:
        use_libs({"loam_features": builds["change"]})
    others = {b: lib for b, lib in builds.items() if b != "change"}
    timed = {label: [cs.feature_timing(torch, scan, cfg, f"{label}, repeat {k}", others)
                     for k in range(args.repeats)] for label, (scan, cfg) in shapes.items()}
    summary = {label: {f: [r[f] for r in rs] for f in rs[0] if f != "turns"}
               for label, rs in timed.items()}
    return {"mode": "corners", "builds": sorted(builds), "ptxas": ptxas, "parity": parity,
            "shapes": summary, "turns": {k: [r["turns"] for r in rs] for k, rs in timed.items()},
            "device": torch.cuda.get_device_name(0)}


def write(result: dict, out=None):
    """The result as one JSON line on stdout (and in `out`)."""
    line = json.dumps(result)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
