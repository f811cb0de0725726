#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (funny_lidar_slam_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. device: requires CUDA; prints `nvidia-smi` name and power limit;
  2. build: compiles every CUDA kernel of the port from csrc/ with nvcc,
     one process per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the mapping path's shapes (fused_select: N=16384 queries, Gp=8192
     cover rows, plane=64, K=16), plus the adversarial tie/sentinel case
     and K=1 against a brute-force oracle; times the kernel, the plain
     version and one PyTorch library call, and computes the bound;
  4. end to end: the port's SlamSystem on the headline mapping config
     (IcpOptimized + TightCouplingOptimization, dense grid (96,96,16),
     16384 points per scan) over a 10 s simulated run; every kernel launch
     count is zeroed just before the run and read just after it;
  5. prints the per-kernel JSON line, the card line and the result line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TIE_RTOL = 2e-4  # lane-epsilon tie window of the selection key


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- helpers
def surface_cloud(n, seed, extent=24.0):
    """Structured surface points (walls + floor): realistic voxel occupancy."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, n)
    pts = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    pts[kinds == 0, 2] = 0.0
    pts[kinds == 1, 1] = np.round(pts[kinds == 1, 1] / 8.0) * 8.0
    pts[kinds == 2, 0] = np.round(pts[kinds == 2, 0] / 8.0) * 8.0
    return pts


def select_inputs(torch, map_pts, queries, qmask=None, dims=(96, 96, 16), gcap=8192,
                  dev="cuda"):
    """Build a grid map from `map_pts` and the fused_select inputs for
    `queries` (valid where `qmask`), exactly as residuals.gather_candidates
    does."""
    from funny_lidar_slam_torch.maps import grid_map
    from funny_lidar_slam_torch.ops.voxel import group_by_voxel

    cap = len(map_pts)
    m = grid_map.build(dims, 8, torch.as_tensor(map_pts, device=dev),
                       torch.ones(cap, dtype=torch.bool, device=dev), 1.0)
    q = torch.as_tensor(queries, device=dev)
    n = q.shape[0]
    qmask = (torch.ones(n, dtype=torch.bool, device=dev) if qmask is None
             else torch.as_tensor(qmask, device=dev))
    g = group_by_voxel(q, qmask, 1.0)
    rep = torch.where((g.rank == 0) & (g.group_id < gcap), g.group_id,
                      torch.full_like(g.group_id, gcap))
    uniq = torch.zeros((gcap + 1, 3), dtype=torch.int32, device=dev)
    uniq[rep] = g.group_coords
    wnd = grid_map.gather_cover(m, uniq[:gcap])
    gid = torch.clamp(g.group_id, max=gcap - 1).to(torch.int32)
    return m, (wnd, gid, g.sorted_pts.contiguous(), g.group_coords)


def stored_points(m):
    """All live points stored in a grid map, as NumPy [M, 3]."""
    s, plane = m.bucket_size, m.plane
    tab = m.tab[:-1].cpu().numpy()
    cnt = m.counts.cpu().numpy()
    nb = tab.shape[0]
    pts = np.stack([tab[:, a * plane:(a + 1) * plane].reshape(nb, 8, s) for a in range(3)], -1)
    valid = (np.arange(s)[None, None, :] < cnt[:, :, None]) & (np.abs(pts[..., 0]) < 1e18)
    return pts[valid]


def assert_parity(out_k, out_p, qs):
    """The TPU parity contract: equal valid counts per row; sorted d2 within
    the tie window; every returned coordinate reproduces its d2. Returns the
    max |d2 kernel - d2 plain| over sorted valid entries."""
    d2k, d2p = out_k[0], out_p[0]
    fk, fp = d2k < 1e18, d2p < 1e18
    np.testing.assert_array_equal(fk.sum(1), fp.sum(1))
    sk = np.sort(np.where(fk, d2k, np.inf), axis=1)
    sp = np.sort(np.where(fp, d2p, np.inf), axis=1)
    fin = np.isfinite(sk)
    np.testing.assert_allclose(sk[fin], sp[fin], rtol=TIE_RTOL, atol=1e-9)
    for out, f in ((out_k, fk), (out_p, fp)):
        with np.errstate(over="ignore"):  # sentinel coordinates square to inf
            d2r = ((out[1] - qs[:, 0:1]) ** 2 + (out[2] - qs[:, 1:2]) ** 2
                   + (out[3] - qs[:, 2:3]) ** 2)
        np.testing.assert_allclose(d2r[f], out[0][f], rtol=1e-4, atol=1e-5)
    return float(np.max(np.abs(sk[fin] - sp[fin]))) if fin.any() else 0.0


def run_both(torch, select, inputs, k, stencil):
    args = (*inputs[:3], k, 64)
    kw = dict(stencil=stencil, qvox=inputs[3])
    out_k = select.fused_select(*args, **kw)
    torch.cuda.synchronize()
    out_p = select.fused_select_plain(*args, **kw)
    torch.cuda.synchronize()
    return ([o.cpu().numpy() for o in out_k], [o.cpu().numpy() for o in out_p],
            inputs[2].cpu().numpy())


def time_ms(torch, fn, reps):
    """Median device ms of one call of `fn` over `reps` calls.

    The calls are queued behind a device-side sleep, with a CUDA event
    between each two, so the device runs them back to back and an event
    pair brackets one call's device time, not the host's Python time. If
    the device catches up with the host (a call that waits for the device
    inside), each call runs alone between its own two events instead."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(300_000_000)  # ~0.2 s of device time to queue behind
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    caught_up = ev[0].query()
    torch.cuda.synchronize()
    if not caught_up:
        return float(np.median([a.elapsed_time(b) for a, b in zip(ev, ev[1:])]))
    log("[time] the device caught up with the host: timing one call at a time")
    times = []
    for a, b in zip(ev, ev[1:]):
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def steady_fps(stats) -> float:
    """Retired frames per second over the second half of the run."""
    trs = [s["tr"] for s in stats if not s.get("init")]
    half = np.diff(trs[len(trs) // 2:])
    return float(len(half) / half.sum()) if len(half) and half.sum() > 0 else 0.0


# ----------------------------------------------------------------- phases
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


def phase_build():
    from funny_lidar_slam_torch.ops import cuda_build

    t = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {sorted(logs)} in {time.perf_counter() - t:.1f} s")
    for name, out in logs.items():  # ptxas: registers, shared memory, spills
        log(f"[build] {name}: {out.strip()}")


def phase_kernels(torch):
    from funny_lidar_slam_torch.io.simulator import SimConfig, make_world
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.ops.voxel import voxel_downsample

    # main-path inputs: a local map of the simulator world at 0.5 m and one
    # 16384-point scan filtered at 0.4 m into the 16384-point source
    rng = np.random.default_rng(7)
    world = make_world(7)
    center = np.array([20.0, 0.0, 1.5], np.float32)
    near = world[np.linalg.norm(world - center, axis=1) < SimConfig().max_range]
    mpts = torch.as_tensor(near, device="cuda")
    mds = voxel_downsample(mpts, torch.ones(len(near), dtype=torch.bool, device="cuda"),
                           0.5, len(near))
    map_pts = mds.points[mds.mask].cpu().numpy()
    scan = near[rng.choice(len(near), 16384, replace=False)] + rng.normal(
        0, 0.05, (16384, 3)).astype(np.float32)
    sds = voxel_downsample(torch.as_tensor(scan, device="cuda"),
                           torch.ones(16384, dtype=torch.bool, device="cuda"), 0.4, 16384)
    m, inputs = select_inputs(torch, map_pts, sds.points, sds.mask)
    wnd, gid, qs_t, qvox = inputs
    log(f"[kernels] map {len(map_pts)} pts, queries {sds.points.shape[0]} "
        f"({int(sds.mask.sum())} valid), cover rows {tuple(wnd.shape)}")

    max_err = 0.0
    _, sinp = select_inputs(torch, surface_cloud(40000, 0), surface_cloud(16384, 1))
    for stencil in select.STENCILS:
        out_k, out_p, qs = run_both(torch, select, inputs, 16, stencil)
        max_err = max(max_err, assert_parity(out_k, out_p, qs))
        out_k, out_p, qs = run_both(torch, select, sinp, 16, stencil)
        max_err = max(max_err, assert_parity(out_k, out_p, qs))
        log(f"[kernels] fused_select {stencil}: parity ok")

    # adversarial: bit-identical duplicate map points (3-way exact ties),
    # queries on empty regions (all-sentinel rows) and on voxel corners
    base = surface_cloud(2000, 2, extent=10.0)
    q_hit = base[rng.choice(len(base), 8192)] + rng.normal(0, 0.05, (8192, 3)).astype(np.float32)
    q_empty = rng.uniform(500.0, 600.0, (4096, 3)).astype(np.float32)
    q_edge = np.round(rng.uniform(0, 10.0, (4096, 3))).astype(np.float32)
    _, ainp = select_inputs(torch, np.repeat(base, 3, axis=0),
                            np.concatenate([q_hit, q_empty, q_edge]))
    out_k, out_p, qs = run_both(torch, select, ainp, 8, "nearby26")
    max_err = max(max_err, assert_parity(out_k, out_p, qs))
    # rows are in sorted order; over empty space a query finds only sentinel
    # lanes or points of an aliased slot, at least a grid period away
    far = qs[:, 0] >= 500.0
    assert far.sum() == 4096 and (out_k[0][far] >= 1e4).all(), "empty-region rows matched"
    log("[kernels] fused_select ties/sentinels: parity ok")

    # K=1 against a brute-force oracle over the stored points (sampled rows)
    km, kinp = select_inputs(torch, surface_cloud(20000, 5, 16.0), surface_cloud(16384, 6, 16.0))
    out_k, _, qs = run_both(torch, select, kinp, 1, "nearby26")
    stored = stored_points(km)
    vox_q, vox_m = np.floor(qs).astype(np.int64), np.floor(stored).astype(np.int64)
    for i in range(0, len(qs), 97):
        within = (np.abs(vox_m - vox_q[i]) <= 1).all(1)
        if not within.any():
            assert out_k[0][i, 0] >= 1e18
            continue
        d2 = ((stored[within] - qs[i]) ** 2).sum(1).min()
        assert abs(out_k[0][i, 0] - d2) < 1e-4, (i, out_k[0][i, 0], d2)
    log("[kernels] fused_select k=1 vs brute force: ok")

    # times at the main-path shape
    k, plane, n = 16, 64, qs_t.shape[0]
    args, kw = (wnd, gid, qs_t, k, plane), dict(stencil="nearby26", qvox=qvox)
    before = select.fused_select.launches
    ms = time_ms(torch, lambda: select.fused_select(*args, **kw), 50)
    plain_ms = time_ms(torch, lambda: select.fused_select_plain(*args, **kw), 10)
    px, py, pz = select._planes(wnd[gid.long()], plane)
    d2 = (px - qs_t[:, 0:1]) ** 2 + (py - qs_t[:, 1:2]) ** 2 + (pz - qs_t[:, 2:3]) ** 2
    d2 = torch.where(select._stencil_mask(d2.shape[1], qvox, plane, "nearby26"), d2,
                     torch.full_like(d2, float("inf")))
    library_ms = time_ms(torch, lambda: torch.topk(d2, k, dim=1, largest=False), 50)
    select.fused_select.launches = before  # comparison launches do not count

    lanes = 8 * plane
    rows = int(torch.unique(gid).numel())
    nbytes = rows * wnd.shape[1] * 4 + n * (3 * 4 + 3 * 4 + 4) + 4 * n * k * 4
    ops = n * lanes * (12 + k)  # 8 for d2, 4 for the key, k compares per lane
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    entry = {
        "name": "fused_select", "route": "cuda",
        "source": "funny_lidar_slam_torch/csrc/fused_select.cu",
        "replaces": "funny_lidar_slam_tpu/ops/pallas_select.py:164",
        "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": library_ms, "parity": "ok",
        "library_call": "torch.topk over the precomputed masked [N,512] d2 "
                        "(partial yardstick: no single PyTorch call gathers, masks and selects)",
        "rows_read": rows, "bytes": nbytes, "ops": ops,
    }
    log(f"[kernels] fused_select N={n} Gp={wnd.shape[0]} rows_read={rows}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, topk {library_ms:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), max_abs_err {max_err:g}")
    return entry


def phase_e2e(torch):
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.io.trajectory import ate_rmse, rpe_rmse
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.pipeline import frontend as fe_mod
    from funny_lidar_slam_torch.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
    from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
    from funny_lidar_slam_torch.registration import matchers

    cap = 16384
    t = time.perf_counter()
    ds = simulate(SimConfig(duration=10.0, points_per_scan=cap, seed=7))
    log(f"[e2e] simulated {len(ds.scans)} scans in {time.perf_counter() - t:.1f} s")

    def system():
        return SlamSystem(SystemConfig(
            registration_mode="IcpOptimized",
            matcher_config=matchers.IcpConfig(
                source_capacity=cap, cloud_capacity=cap, merged_capacity=65536,
                map_capacity=65536, local_map_size=20, map_layout="grid",
                grid_dims=(96, 96, 16)),
            frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
            scan_capacity=cap, imu_segment_capacity=16))

    # warm-up run over a few scans (kernel load, allocator), then the run
    system().run_dataset(ds, max_scans=8)
    torch.cuda.synchronize()
    slam = system()
    select.fused_select.launches = 0
    t = time.perf_counter()
    out = slam.run_dataset(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = select.fused_select.launches

    est = out["poses"]
    gt_map = {round(ti, 4): p for ti, p in zip(ds.gt_times, ds.gt_poses)}
    gt = np.asarray([gt_map[round(ti, 4)] for ti in out["times"]])
    n_tracked = len(est)
    assert n_tracked >= 40, f"too few tracked scans: {n_tracked}"
    assert np.isfinite(est).all(), "non-finite poses"
    ate, rpe = ate_rmse(est, gt), rpe_rmse(est, gt)
    assert ate < 0.10, f"ATE {ate:.4f} m"
    assert launches > 0, "the main path did not launch fused_select"
    steps = sum(1 for s in slam.stats if not s.get("init"))
    fps = steady_fps(slam.stats)

    # per-phase spans from CUDA events, on a second (traced) run of the same
    # scans; its wall time less the untraced one is the tracing overhead
    spans: dict = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            b, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            b.record()
            r = fn(*a, **kw)
            e.record()
            spans.setdefault(name, []).append((b, e))
            return r
        return wrapper

    saved = {k: getattr(fe_mod, k) for k in ("deskew", "preintegrate", "tight_fuse")}
    saved_m = {k: getattr(matchers, k) for k in ("run_gn_corr", "window_add")}
    fe_mod.deskew = timed("deskew+preint", saved["deskew"])
    fe_mod.preintegrate = timed("deskew+preint", saved["preintegrate"])
    fe_mod.tight_fuse = timed("fusion", saved["tight_fuse"])
    matchers.run_gn_corr = timed("gn", saved_m["run_gn_corr"])
    matchers.window_add = timed("insert", saved_m["window_add"])
    try:
        prof = system()
        t = time.perf_counter()
        prof.run_dataset(ds)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    finally:
        for k, v in saved.items():
            setattr(fe_mod, k, v)
        for k, v in saved_m.items():
            setattr(matchers, k, v)
    n_prof = sum(1 for s in prof.stats if not s.get("init"))
    phase_ms = {k: sum(b.elapsed_time(e) for b, e in v) / n_prof for k, v in spans.items()}

    res = {"tracked": n_tracked, "scans": len(ds.scans), "ate_m": ate, "rpe_m": rpe,
           "steady_fps": fps, "wall_s": wall, "traced_wall_s": traced_wall, "steps": steps,
           "fused_select_launches": launches, "launches_per_scan": launches / steps,
           "phase_ms_per_scan": phase_ms, "keyframes": out["n_keyframes"]}
    log("[e2e] " + json.dumps(res))
    return launches, res


def main() -> int:
    import torch

    card = phase_device(torch)
    sys.path.insert(0, HERE)
    phase_build()
    entry = phase_kernels(torch)
    launches, _ = phase_e2e(torch)
    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
