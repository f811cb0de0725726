#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (funny_lidar_slam_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. device: requires CUDA; prints `nvidia-smi` name and power limit;
  2. build: compiles every CUDA kernel of the port from csrc/ with nvcc,
     one process per source, all started together, and reads ptxas's
     registers, spills and shared memory per kernel;
  3. kernels: fused_select against its plain PyTorch version on the card:
     synthetic covers with sentinel lanes and exact ties at planes 8, 16,
     32 and 128, and with shuffled and strided (non-monotone or
     wide-range) gids; the grid mapping path's shapes (N=16384 queries,
     Gp=8192 cover rows, plane=64, K=16), plus the adversarial
     tie/sentinel case and K=1 against a brute-force oracle; times the
     kernel, the plain version and one PyTorch library call in
     interleaved turns, computes the bound, and runs the K sweep (K = 1,
     2, 4, 8, 16); the build's registers, shared memory and resident
     warps per plane;
  3b. probes: the platform probes' entry point (ops/probes.run, the port's
     tools/pallas_smoke.py) with the launch counts zeroed just before it
     and read just after; row_gather_loop and dma_rows against their plain
     version (exact) at B = 1, 7, 513, 1025 and rows of 128-3072 floats,
     with clamped indices, at the cover-row shape and where every dma_rows
     block reuses each ring slot, row_gather_vector there too and at D =
     130 and on a misaligned table (its element-wise route), scale2
     against x * 2 at n = 1 to 16,386 (with and without a tail); then each
     probe kernel against its plain version (exact) at the TPU probes'
     shapes, timed in interleaved turns
     (kernel, library, plain, floor, floor, plain, library, kernel; twice)
     against the plain version, one PyTorch call and the launch floor (one
     empty launch, torch.cuda._sleep(0)), with bounds; and both row gathers
     and index_select at the cover-row shape (tab [8192, 1536] f32, 6,433
     sorted distinct rows), L2 flushed before each call and back to back;
  3c. fused_select on hashed-map inputs: a block map built from the
     simulator world in the localization crop, one scan's queries; all
     four stencils at K=16 and the fitness shape (K=1, Gp=N), K=1 against
     brute force, and the count of all-miss cover rows; both shapes timed
     in turns, and the K sweep;
  4. grid mapping end to end: the port's SlamSystem on the headline config
     (IcpOptimized + TightCouplingOptimization, dense grid (96,96,16),
     16384 points per scan) over a 10 s simulated run, then a traced
     second run for per-phase spans (the GN span: run_gn_icp_cand);
  5. hashed mapping end to end: the same run on the IcpConfig default
     layout (the hashed block map), the bench's figure-8 config without
     loop closure;
  6. localization end to end: the Localizer against the frozen simulator
     world on the same run (the bench's localization config);
  3d. fused_select on the LOAM paths' inputs, captured from the first
     gather of PointToPlane_IVOX (planar queries, nearby18, 0.5 m hashed
     map) and of LoamFull_KdTree (corner queries, N=2048 and Gp=8192, and
     planar queries, nearby26) on the simulator run: parity at K=16, at the
     fitness shape (K=1, Gp=N) and K=1 against brute force over the map's
     stored points, each shape timed in turns with its bound;
  7-9. LOAM-geometry mapping end to end on the same run, one phase each:
     PointToPlane_IVOX, PointToPlane_KdTree and LoamFull_KdTree on the
     bench's configs (range-image projection and corner/planar features,
     TightCouplingOptimization);
  10. IncrementalNDT mapping end to end on the bench's NDT config (2 m
     voxel Gaussians, tight coupling): it launches no fused_select (its
     stencil lookup runs inside ndt_gn_rounds, the NDT GN loop kernel), and
     the phase checks that it launched none; one ndt_gn_rounds launch and
     one GN host read a match;
  11. TightCouplingKF mapping on phase 4's grid config (ESKF predict, no
     preintegration, ESKF pose update), then a traced second run with
     phase 4's spans beside the KF's (deskew, ESKF predict, GN, ESKF
     update, insert);
  12a-d. localization over PointToPlane_IVOX, PointToPlane_KdTree,
     LoamFull_KdTree and IncrementalNDT: phase 6's crop config with each
     mode's bench config (the LOAM modes with the bench's lidar geometry);
  13. mapping with loop closure on the bench's Figure8_Loop config (24 s,
     hashed ICP, the pose graph): loops, keyframe ATE, the synchronized
     time of every verification (split into keyframe fetch, host merge and
     device cascade) and of every pose-graph optimize (each graph kept for
     phase 24; pose_graph_gn launched once a loop), the GN host reads of
     every verification (one an NDT stage and one for the refine: 5) and
     every refine call kept for phase 25 (one plane_map_gn_rounds launch a
     verification, no K=5 fused_select inside one); then fused_select at
     the first refine's start-pose gather (K=5, rebuilt from the kept call)
     and the first verification's fitness (K=1) inputs against its plain
     version and brute force, timed in turns, and that cascade replayed
     stage by stage (one ndt_gn_rounds launch and one host read an NDT
     stage, one plane_map_gn_rounds launch and one read for the refine)
     and under torch.profiler;
  14. kill and resume: phase 4's grid config with a keyframe store, half
     the run scan by scan, SlamSystem.resume, the rest; then save_map of
     phase 13's system, read back with its tiles;
  15. the CLI (`run_slam.main`, in process) on three unmodified presets,
     each over a bag the port's bag_export wrote from a 10 s simulator run
     (seed 7) under the preset's topics, at its LiDAR's points a scan:
     15a M2DGR mapping (PointToPlane_IVOX, tight coupling, loop closure
     on, 57,600 points) with --save-map, and fused_select at its first
     gather against its plain version and brute force, timed in turns;
     15b Turing ICP mapping (the "None" LiDAR model, loose coupling, 28,800
     points) with --split-map; 15c Turing ICP localization on 15b's tiles
     from the identity; each under tests/test_bag_path.py's gates, with bag
     write and read s and the host preprocess ms a scan;
  16. multi-device (parallel/dryrun.py's workloads at the simulator's
     size): the 1,000-keyframe pose graph by sharded_optimize, the
     region-sharded map of make_world(seed=7) (insert_sharded in chunks of
     65,536, then sharded_gn_step of one displaced 16,384-point scan) and
     sharded_icp_step over a voxel_hash.build of the same world; 16a one
     NCCL rank in this process, 16b four gloo ranks on CUDA tensors, worker
     processes on this card; the JAX dry run's gates (< 0.25 m, < 0.03 m,
     >= 4 shards, the halo bound), the 4-rank pose against the 1-rank one
     (1e-4 on the JAX dry run's map, which runs beside; reported on the
     world, whose overfull voxels keep rank-dependent points), and
     fused_select at each run's first sharded gather against its plain
     version and brute force, timed in turns;
  17. the unpacked step and the per-stage profile: 17a phase 4's grid config
     warmed over 24 scans, then 8 scans each fed from the same state and
     the same f32 inputs to `Frontend.step` (one host->device copy an
     array) and to `step_packed` (one copy of the packed frame): pose
     within 1e-4 m and 1e-4 rad, the same `converged`, equal fused_select
     launches; both timed over those scans in turns (packed, unpacked,
     unpacked, packed; twice) with a synchronized host clock, and the
     first scan on each under torch.profiler (CUDA runtime calls and ATen
     ops counted); fused_select at the unpacked step's first gather
     against its plain version and brute force, timed in turns; 17b
     tools/profile_torch_frontend.py's `profile` in process at its full
     configuration, its report on one line;
  18. the bench: `python3 bench_torch.py` in its own process at
     BENCH_BUDGET_S=0 (the grid headline once over the bench's 14 s run, the
     other six sections skipped), its JSON line gated (rc 0, no partial or
     error, >= 100 frames, ATE < 0.10 m, fused_select launched);
  19. the device loops: preintegrate, eskf_predict and tight_fuse (csrc/
     imu_scan.cu, csrc/tight_fuse.cu) against their plain versions on every
     call captured from phase 4's grid run, phase 11's KF run and 15a's
     M2DGR run (1e-5 absolute on deltas and states, 1e-4 of the largest
     entry on covariances and Jacobians; tight_fuse within 2e-3 m and 2e-3
     rad and 1e-2 of the largest information entry on every call, within
     1e-4 m and 1e-5 rad with the plain version's LM iteration count on at
     least 95 %, the distributions printed), and on the synthetic edge
     cases of `loop_edge_cases` (preintegrate and eskf_predict each with
     every sample masked, one valid slot, slots of dt <= 0 between valid
     ones, a chained second segment, 64 slots all valid; tight_fuse at 0
     and 1 LM iterations); no ptxas spills in preintegrate_kernel,
     eskf_predict_kernel or tight_fuse_kernel; the three entry points on
     device inputs under torch.cuda.set_sync_debug_mode("error"); each
     kernel timed in turns beside its plain version and one empty launch
     at the bench's shape (16 slots, 12 LM iterations) and M2DGR's (64
     slots, 20; eskf_predict at 64 slots all valid), tight_fuse also at the
     bench's call with 0 and 1 LM iterations, with its bound and its ptxas
     registers, stack frame and shared memory;
  20. the ICP GN loop: icp_gn_rounds (csrc/gn_loop.cu, the JAX
     `run_gn_corr` while_loop over cached candidates, one launch a gather
     round) against its plain version on every call captured in untimed
     runs beside phases 4 (grid), 11 (KF), 6 (ICP localization) and 15b
     (Turing mapping): the same status, iterations and gathers on >= 95 %
     of a path's calls, and there the pose within 1e-4 m and 1e-5 rad,
     num_valid within 1 %, total_res within 1e-3 relative (or, where a
     gate flipped by one ulp of the pose parts the call's end from both
     plain runs, each iteration so from the same pose); GN iterations a
     match; one thread block cluster of R >= 8 blocks (R and the rows per
     rank printed), two launches on every captured first round bit-equal,
     no ptxas spills; synthetic edge cases (a starved set, every lane
     invalid, N 100, N 5,003, M 12, max_iters 2; collinear sources held to
     status and counts); the any-M kernel bit-equal on misaligned planes;
     the launch under set_sync_debug_mode("error"); timed at the headline
     shape (N 16,384, M 16) and the captured call with the most iterations
     beside its plain version and one empty launch, with its bound and its
     ptxas registers and shared memory;
  21. the LOAM GN loops: plane_gn_rounds and loam_gn_rounds (csrc/gn_loop.cu
     loam_gn_kernel, the same while_loop over the point-to-plane and the
     LoamFull line + plane candidate sets) against their plain versions on
     every call captured in untimed runs beside phases 7-9, 12a-c and 15a,
     with phase 20's gates (where the two float32 runs part, the pose held
     to the plain version with float64 sums, the kernel's one deviation);
     each kernel one thread block cluster of R >= 8 blocks (R and the rows
     per rank, from the launcher's split, printed), two launches on every
     captured first round bit-equal; synthetic edge cases (every lane
     invalid, tied lanes, max_iters 2, M 12, N 100, N 5,003, 60 corner + 40
     planar rows, more corner than planar rows, no corner rows; a
     rank-deficient N 100 held to its counters and each iteration from the
     same pose; a starved set, which only the stall test ends, held to its
     status and each iteration, its stall test included, from the same pose
     and step norms); the any-M kernels
     bit-equal on misaligned planes; both under set_sync_debug_mode("error"); no ptxas
     spills in any GN kernel; each timed at IVOX's and LoamFull's first
     round beside its plain version and one empty launch, with its bound;
  22. the NDT GN loop: ndt_gn_rounds (csrc/gn_loop.cu ndt_gn_kernel, the
     JAX while_loop with ndt_corr + ndt_hg_corr as its body: the stencil
     lookup in the NDT map's hash table and the Mahalanobis rows inside
     every iteration, the whole loop one launch) against its plain version
     on every call captured in untimed runs beside phases 10 and 12d and in
     a replay of phase 13's first cascade, with phase 20's gates (where the
     two float32 runs part, the pose held to the plain version with float64
     sums, `float64_sums`); one thread block cluster of R >= 8 blocks (R and
     the rows a rank printed), every captured call launched twice
     bit-equal, no ptxas spills; edge cases (N 100, N 5,003, every row
     masked, non-finite info, num_probes 8 and 16, max_iters 2); the
     launch under set_sync_debug_mode("error"); timed at the bench shape
     and at each of the cascade's four stages beside its plain version and
     one empty launch, with its bound from the bytes and the operations;
  23. (run after phase 18, before 19) the LOAM corner selection:
     corner_mask (csrc/loam_features.cu
     loam_corners_kernel, the JAX feature extraction up to the corner mask
     with its lax.scan of 20 masked argmax picks, one launch a scan: a
     block an angular block, its window staged in shared memory, a thread
     a lane, the picks as two warp reductions a pick)
     against corner_mask_plain, bit for bit, on every call captured in the
     untimed runs beside phases 7-9, 12a-c and 15a (where a call parts,
     each parting point with its roughness and the gap to its row's
     nearest) and on the CPU tests' edge cases (`feature_cases`: the bench,
     32- and 64-row geometries, short and empty rows, every point masked,
     tied roughness, wrap-around at 0 and N-1, threshold -2, 1 and 40
     corners a block); no ptxas spills; the launch under
     set_sync_debug_mode("error"); timed at the bench's and M2DGR's shapes
     beside its plain version and one empty launch, with its bound;
  24. the pose graph's GN loop: pose_graph_gn (csrc/pose_graph.cu
     pose_graph_gn_kernel, the JAX optimize's fori_loop of 15 GN steps in
     one launch of one block, over the free vertices alone, factored by
     6x6 vertex blocks with the unwritten ones skipped) against
     optimize_plain and a float64 plain run on every graph phase 13
     optimized, the CPU tests' graphs (pose_graph_builders: circles with 1
     and 8 loops, 2 vertices, 1 vertex, a graph grown past its capacity, a
     used vertex with no edge, a failing factorization) and the dry run's
     1,000-keyframe graph: NaN at the same vertices, the fixed vertices bit
     for bit, the poses within 2e-3 m / 1e-3 rad of the float64 run or no
     farther than 1.5x the float32 plain run; timed against the plain
     version in turns at the figure-8's graphs (device and synchronized
     host ms), with its bound;
  25. the loop closure's refine: plane_map_gn_rounds (csrc/gn_loop.cu
     plane_map_gn_kernel, the JAX run_gn(point_to_plane_hg) while_loop with
     the block map's 5-NN lookup inside every iteration, the whole loop one
     launch of one thread block cluster) against its plain version on
     every refine call of phase 13's figure-8 run and of its cascade
     replay (its 5 nearest taken by a stable sort, the kernel's order:
     `exact_select`), with phase 22's gates (where the counters still part
     after the float64-sums run, each iteration from the kernel's pose, its
     stall and convergence tests included: stepwise_compare(stall=True)),
     every call
     launched twice bit-equal; edge cases (the CPU tests' drifted room on
     the card, the room on voxel faces, a starved call, every row masked,
     every cover block missed, max_iters 1); no ptxas spills; the launch
     under set_sync_debug_mode("error"); timed at the figure-8's first
     refine beside its plain version, the host-loop route (run_gn over
     point_to_plane_hg) and one empty launch, with its bound and rank 0's
     stage clocks;
and prints the per-kernel JSON line, the card line and the result line.
Every path (3b, 4-18) runs with the kernel launch counts zeroed just
before it and read just after it (phase 18 inside the bench's process,
which counts fused_select only); every path that steps the frontend checks
the device-loop kernels' launches against its steps: one preintegrate and
one tight_fuse a step under TightCouplingOptimization, one eskf_predict a
step under TightCouplingKF, none under LooseCoupling (the Turing CLI
preset); and each GN kernel once a gather round of its driver on the
paths of its matcher (icp_gn_rounds: ICP; plane_gn_rounds: IVOX, KdTree;
loam_gn_rounds: LoamFull), never on the others, ndt_gn_rounds once an
NDT match and once an NDT stage of every loop-closure verification and
plane_map_gn_rounds once a verification, on any path (the mapping phases
gate the GN host reads a scan, one a round, equal to the gathers a scan,
and on NDT to the matches), the host-loop GN (run_gn_corr) on none but
the profile tool's own stage of it, and corner_mask
once a LOAM front-end call (Frontend._process), none on a path without a
lidar geometry, and pose_graph_gn once an accepted loop (check_launches;
phase 13's figure-8 and the CLI's loop-closing presets), none elsewhere.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

import bench_torch as bench

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


def cover_inputs(torch, m, queries, qmask=None, gcap=8192, dev="cuda"):
    """The fused_select inputs for `queries` (valid where `qmask`) over a
    block or grid map, exactly as residuals.gather_candidates builds them."""
    from funny_lidar_slam_torch.maps import block_map
    from funny_lidar_slam_torch.ops.voxel import group_by_voxel

    q = torch.as_tensor(queries, device=dev)
    n = q.shape[0]
    qmask = (torch.ones(n, dtype=torch.bool, device=dev) if qmask is None
             else torch.as_tensor(qmask, device=dev))
    g = group_by_voxel(q, qmask, 1.0)
    rep = torch.where((g.rank == 0) & (g.group_id < gcap), g.group_id,
                      torch.full_like(g.group_id, gcap))
    uniq = torch.zeros((gcap + 1, 3), dtype=torch.int32, device=dev)
    uniq[rep] = g.group_coords
    wnd = block_map.gather_cover_any(m, uniq[:gcap])
    gid = torch.clamp(g.group_id, max=gcap - 1).to(torch.int32)
    return wnd, gid, g.sorted_pts.contiguous(), g.group_coords


def select_inputs(torch, map_pts, queries, qmask=None, dims=(96, 96, 16), gcap=8192,
                  dev="cuda"):
    """Build a grid map from `map_pts` and the fused_select inputs for
    `queries` (valid where `qmask`)."""
    from funny_lidar_slam_torch.maps import grid_map

    cap = len(map_pts)
    m = grid_map.build(dims, 8, torch.as_tensor(map_pts, device=dev),
                       torch.ones(cap, dtype=torch.bool, device=dev), 1.0)
    return m, cover_inputs(torch, m, queries, qmask, gcap, dev)


def stored_points(m):
    """All live points stored in a grid or block map, as NumPy [M, 3]."""
    s, plane = m.bucket_size, m.plane
    tab = m.tab[:-1].cpu().numpy()
    cnt = m.counts.cpu().numpy()
    if hasattr(m, "fp"):  # block map: purged and empty slots hold no live points
        cnt = cnt * (m.fp != 0).cpu().numpy()[:, None]
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


def run_both(torch, select, inputs, k, stencil, plane=64):
    args = (*inputs[:3], k, plane)
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


def time_cold_ms(torch, fn, reps, flush):
    """Median device ms of one call of `fn` over `reps` calls, each made
    after `flush()` (which evicts the L2) with only the call between its
    two events; the calls are queued behind a device-side sleep."""
    flush()  # warm-up: a first call's allocation would wait for the device
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(300_000_000)
    for a, b in pairs:
        flush()
        a.record()
        fn()
        b.record()
    assert not pairs[0][0].query(), "the device caught up with the host"
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def in_turns(timer, calls: dict, order) -> dict:
    """Time `calls` ({name: fn}) in the given order of turns (e.g. kernel,
    library, library, kernel) with `timer(fn)`: {name: [ms of each turn]}."""
    out: dict = {}
    for name in order:
        out.setdefault(name, []).append(timer(calls[name]))
    return out


def versus(mine, theirs) -> str:
    """Whether one set of turn times is slower or faster than another
    beyond the spread of the turns, or within it."""
    if min(mine) > max(theirs):
        return "slower"
    if max(mine) < min(theirs):
        return "faster"
    return "within the spread"


def steady_fps(stats) -> float:
    """Retired frames per second over the second half of the run."""
    trs = [s["tr"] for s in stats if not s.get("init")]
    half = np.diff(trs[len(trs) // 2:])
    return float(len(half) / half.sum()) if len(half) and half.sum() > 0 else 0.0


# ----------------------------------------------------------------- phases
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = bench.card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


def kernel_name(symbol: str) -> str:
    """The last name of a mangled kernel symbol, with its int and bool
    template arguments: `_ZN..19fused_select_kernelILi16EEEv..` ->
    `fused_select_kernel<16>`, `..14loam_gn_kernelILb1ELi16EEEv..` ->
    `loam_gn_kernel<true, 16>`."""
    rest, names = re.sub(r"^_ZN?", "", symbol), []
    while m := re.match(r"(\d+)", rest):
        size = int(m.group(1))
        names.append(rest[m.end():m.end() + size])
        rest = rest[m.end() + size:]
    args = re.match(r"I((?:L[bi]-?\d+E)+)E", rest)
    vals = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([bi])(-?\d+)E", args.group(1))] if args else []
    return (names[-1] if names else symbol) + (f"<{', '.join(vals)}>" if vals else "")


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack_frame_bytes,
    static_smem_bytes}} from nvcc's -Xptxas=-v output; the spill and stack
    line counts only under the entry function's own "Function properties"
    (not a device function's, such as a double sin's slow path)."""
    report, name, entry, own = {}, None, None, False
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, entry = kernel_name(m.group(1)), m.group(1)
            report[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0,
                            "stack_frame_bytes": 0, "static_smem_bytes": 0}
        elif m := re.search(r"Function properties for (\S+)", line):
            own = m.group(1) == entry
        elif name and own and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                              line)):
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            if sf := re.search(r"(\d+) bytes stack frame", line):
                report[name]["stack_frame_bytes"] = int(sf.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                report[name]["static_smem_bytes"] = int(sm.group(1))
    return report


# the GN kernels built with stage clocks (csrc/stage_clock.cuh), for phase 22
STAGED_GN = ("gn_loop", ("-DFLS_STAGE_CLOCKS",))


def phase_build() -> dict:
    """Builds every kernel source, and STAGED_GN beside; returns the ptxas
    report of each (the staged build's under "gn_loop -DFLS_STAGE_CLOCKS")."""
    from funny_lidar_slam_torch.ops import cuda_build

    t = time.perf_counter()
    logs = {" ".join((name, *defines)): out
            for (name, defines), out in cuda_build.build_all(variants=[STAGED_GN]).items()}
    log(f"[build] {sorted(logs)} in {time.perf_counter() - t:.1f} s")
    for name, out in logs.items():  # ptxas: registers, shared memory, spills
        log(f"[build] {name}: {out.strip()}")
    return {name: ptxas_report(out) for name, out in logs.items()}


def select_resources(select, report: dict) -> dict:
    """fused_select's build at each plane: registers and spills (ptxas),
    the dynamic shared memory a block stages (8 cover rows of 96*plane
    bytes) and the blocks and warps resident on an SM (the runtime's
    occupancy calculator)."""
    out = {}
    for plane in (8, 16, 32, 64, 128):
        blocks = select.resident_blocks(plane)
        out[str(plane)] = {**report.get(f"fused_select_kernel<{plane // 4}>", {}),
                           "dynamic_smem_bytes": 8 * 96 * plane,
                           "resident_blocks": blocks, "resident_warps": 8 * blocks}
    log(f"[kernels] fused_select resources by plane: {out}")
    return out


def grid_select_inputs(torch, rng):
    """The grid path's fused_select inputs: a local map of the simulator
    world at 0.5 m and one 16384-point scan filtered at 0.4 m into the
    16384-point source (N=16384, Gp=8192, plane 64)."""
    from funny_lidar_slam_torch.io.simulator import SimConfig, make_world
    from funny_lidar_slam_torch.ops.voxel import voxel_downsample

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
    _, inputs = select_inputs(torch, map_pts, sds.points, sds.mask)
    log(f"[kernels] map {len(map_pts)} pts, queries {sds.points.shape[0]} "
        f"({int(sds.mask.sum())} valid), cover rows {tuple(inputs[0].shape)}")
    return inputs


def synthetic_cover(torch, rng, plane, n, gid_kind):
    """fused_select inputs on a random cover table at `plane`: 1-3 queries
    a group, a third of the lanes sentinels (1e30), every 7th lane a copy
    of its neighbour (exact d2 ties), every 16th row all sentinels, queries
    inside the window. `gid_kind`: "monotone" (the callers' gids),
    "shuffled" (a permutation of them) or "strided" (gid = 3q, so a
    block's rows span more than it stages)."""
    sizes = rng.integers(1, 4, n)
    gid = np.repeat(np.arange(n), sizes)[:n].astype(np.int32)
    if gid_kind == "shuffled":
        gid = rng.permutation(gid)
    elif gid_kind == "strided":
        gid = (3 * np.arange(n)).astype(np.int32)
    gp = int(gid.max()) + 1
    tab = rng.uniform(0.0, 4.0, (gp, 8, 3, plane)).astype(np.float32)
    tab[..., 3::7] = tab[..., 2::7][..., :tab[..., 3::7].shape[-1]]
    tab[rng.random((gp, 8, 1, plane)).repeat(3, 2) < 1 / 3] = 1e30
    tab[::16] = 1e30
    qs = rng.uniform(0.5, 3.5, (n, 3)).astype(np.float32)
    qvox = rng.integers(-50, 50, (n, 3)).astype(np.int32)
    return [torch.as_tensor(a, device="cuda") for a in
            (tab.reshape(gp, 24 * plane), gid, qs, qvox)]


def synthetic_parity(torch, select) -> float:
    """fused_select against its plain version on synthetic covers: planes
    8, 16, 32 and 128 with monotone gids, and plane 8 and 64 with shuffled
    and strided gids (the queries whose rows the block did not stage).
    Returns the max |d2| difference."""
    rng = np.random.default_rng(13)
    cases = [(p, "monotone") for p in (8, 16, 32, 128)]
    cases += [(p, kind) for p in (8, 64) for kind in ("shuffled", "strided")]
    max_err = 0.0
    for plane, kind in cases:
        inputs = synthetic_cover(torch, rng, plane, 4099, kind)
        for k, stencil in ((16, "nearby26"), (5, "nearby6")):
            out_k, out_p, qs = run_both(torch, select, inputs, k, stencil, plane)
            max_err = max(max_err, assert_parity(out_k, out_p, qs))
        log(f"[kernels] fused_select plane {plane}, {kind} gid: parity ok")
    return max_err


def phase_kernels(torch):
    from funny_lidar_slam_torch.ops import select

    rng = np.random.default_rng(7)
    inputs = grid_select_inputs(torch, rng)
    wnd, gid, qs_t, qvox = inputs

    max_err = synthetic_parity(torch, select)
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

    # times at the main-path shape, and the K sweep
    timing = select_timing(torch, select, inputs, 16)
    sweep = k_sweep(torch, select, inputs)
    entry = {
        "name": "fused_select", "route": "cuda",
        "source": "funny_lidar_slam_torch/csrc/fused_select.cu",
        "replaces": "funny_lidar_slam_tpu/ops/pallas_select.py:164",
        "launches": 0, "max_abs_err": max_err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"], "parity": "ok",
        "library_call": "torch.topk over the precomputed masked [N,512] d2 "
                        "(partial yardstick: no single PyTorch call gathers, masks and selects)",
        "rows_read": timing["rows_read"], "bytes": timing["bytes"], "ops": timing["ops"],
        "turns": timing["turns"], "vs_library": timing["vs_library"],
        "vs_plain": timing["vs_plain"], "k_sweep": {"grid": sweep},
    }
    log(f"[kernels] fused_select N={qs_t.shape[0]} Gp={wnd.shape[0]} "
        f"rows_read={timing['rows_read']}: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, topk {timing['library_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}), max_abs_err {max_err:g}; "
        f"kernel {timing['vs_library']} than topk; turns {timing['turns']}")
    log(f"[kernels] fused_select grid K sweep: {sweep}")
    return entry


TURNS = ["kernel", "library", "plain", "plain", "library", "kernel"] * 2
SWEEP_K = (1, 2, 4, 8, 16)


def select_timing(torch, select, inputs, k, stencil="nearby26", plane=64):
    """Device ms of fused_select, its plain version and torch.topk over the
    precomputed masked d2 at these inputs, in interleaved turns, and the
    bound: the cover rows this run reads (each once), the queries and the
    outputs over the memory rate, or 8 + 4 + k operations per lane over the
    f32 rate."""
    wnd, gid, qs_t, qvox = inputs
    args, kw = (wnd, gid, qs_t, k, plane), dict(stencil=stencil, qvox=qvox)
    before = select.fused_select.launches
    px, py, pz = select._planes(wnd[gid.long()], plane)
    d2 = (px - qs_t[:, 0:1]) ** 2 + (py - qs_t[:, 1:2]) ** 2 + (pz - qs_t[:, 2:3]) ** 2
    d2 = torch.where(select._stencil_mask(d2.shape[1], qvox, plane, stencil), d2,
                     torch.full_like(d2, float("inf")))
    turns = in_turns(lambda f: time_ms(torch, f, 30),
                     {"kernel": lambda: select.fused_select(*args, **kw),
                      "library": lambda: torch.topk(d2, k, dim=1, largest=False),
                      "plain": lambda: select.fused_select_plain(*args, **kw)}, TURNS)
    select.fused_select.launches = before  # comparison launches do not count
    ms, plain_ms, library_ms = (float(np.median(turns[c])) for c in ("kernel", "plain", "library"))

    n, lanes = qs_t.shape[0], 8 * plane
    rows = int(torch.unique(gid).numel())
    nbytes = rows * wnd.shape[1] * 4 + n * (3 * 4 + 3 * 4 + 4) + 4 * n * k * 4
    ops = n * lanes * (12 + k)  # 8 for d2, 4 for the key, k compares per lane
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "rows_read": rows, "bytes": nbytes, "ops": ops, "n": n, "gp": wnd.shape[0], "k": k,
            "turns": turns, "vs_library": versus(turns["kernel"], turns["library"]),
            "vs_plain": versus(turns["kernel"], turns["plain"])}


def k_sweep(torch, select, inputs, stencil="nearby26", plane=64) -> dict:
    """The kernel's device ms at K = 1, 2, 4, 8, 16 on these inputs, in two
    turns (K rising, then falling), and the least-squares line through the
    medians: ms = base_ms + per_round_ms * K."""
    wnd, gid, qs_t, qvox = inputs
    before = select.fused_select.launches
    calls = {k: (lambda k=k: select.fused_select(wnd, gid, qs_t, k, plane, stencil=stencil,
                                                 qvox=qvox)) for k in SWEEP_K}
    turns = in_turns(lambda f: time_ms(torch, f, 50), calls,
                     list(SWEEP_K) + list(reversed(SWEEP_K)))
    select.fused_select.launches = before
    ms = {k: float(np.median(v)) for k, v in turns.items()}
    per_round, base = np.polyfit(list(SWEEP_K), [ms[k] for k in SWEEP_K], 1)
    return {"ms": {str(k): v for k, v in ms.items()},
            "turns": {str(k): v for k, v in turns.items()},
            "base_ms": float(base), "per_round_ms": float(per_round)}


def gather_bytes(tab, idx) -> int:
    """Bytes a row gather must move: each distinct row read once, each
    output row written once, the indices read once."""
    uniq = int(idx.unique().numel())
    return (uniq + idx.numel()) * tab.shape[1] * 4 + idx.numel() * 4


def probe_exactness(torch, probes) -> int:
    """row_gather_loop, row_gather_vector and dma_rows against
    row_gather_plain, with torch.equal, at ragged B, clamped indices, the
    cover-row shape and ring reuse (row_gather_vector also at D = 130 and
    on a misaligned table, its element-wise route); scale2 against x * 2 at
    sizes with and without a tail. Raises on the first difference; returns
    the number of checks."""
    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tables = {d: torch.randn((c, d), generator=gen, device="cuda")
              for c, d in ((4096, 128), (4096, 132), (8192, 1536), (2048, 3072))}

    def ids(c, b, lo=0, hi=None):
        return torch.as_tensor(rng.integers(lo, c if hi is None else hi, b).astype(np.int32),
                               device="cuda")

    cases = [(f"D={d} B={b}", tab, ids(tab.shape[0], b))
             for d, tab in tables.items() for b in (1, 7, 513, 1025)]
    for d in (128, 1536):  # negative and out-of-range indices, and the int32 extremes
        c = tables[d].shape[0]
        idx = ids(c, 1025, -2 * c, 2 * c)
        idx[:2] = torch.tensor([-2 ** 31, 2 ** 31 - 1], dtype=torch.int32)
        cases.append((f"D={d} B=1025 clamped", tables[d], idx))
    cases.append(("cover rows D=1536 B=6433", tables[1536],
                  torch.as_tensor(probes.cover_index(8192, 6433), device="cuda")))
    # ring reuse: dma_rows' grid has at most 8 blocks per SM at 512-B rows
    # and 2 at 12-KB rows (probes.cu), and each block an even share of the
    # rows, so at these B every block uses each of its 8 slots 3 times or more
    dma_reuse = [("reuse D=128", tables[128], ids(4096, 24 * 8 * sms + 7)),
                 ("reuse D=3072", tables[3072], ids(2048, 24 * 2 * sms + 5))]
    odd = torch.randn((4096, 130), generator=gen, device="cuda")
    shifted = torch.randn(4096 * 128 + 1, generator=gen, device="cuda")[1:].view(4096, 128)
    vector_only = [("D=130 B=1025", odd, ids(4096, 1025)),
                   ("D=128 misaligned B=513", shifted, ids(4096, 513, -9, 5000))]
    extra = {probes.dma_rows: dma_reuse, probes.row_gather_vector: vector_only}
    n = 0
    for fn in (probes.row_gather_loop, probes.row_gather_vector, probes.dma_rows):
        for what, tab, idx in cases + extra.get(fn, []):
            out_k, out_p = fn(tab, idx), probes.row_gather_plain(tab, idx)
            torch.cuda.synchronize()
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{fn.__name__} differs from row_gather_plain at {what}")
            n += 1
    for size in (1, 3, 4, 5, 1023, 1029, 8 * 128, 4096 * 4 + 2):
        x = torch.randn(size, generator=gen, device="cuda")
        out_k = probes.scale2(x)
        torch.cuda.synchronize()
        if not torch.equal(out_k, x * 2):
            raise AssertionError(f"scale2 differs from x * 2 at n = {size}")
        n += 1
    log(f"[probes] row_gather_loop, row_gather_vector and dma_rows equal row_gather_plain and "
        f"scale2 equals x * 2 exactly in {n} checks (D 128/130/132/1536/3072, B 1/7/513/1025, "
        f"clamped, cover rows, a misaligned table, ring reuse at B {dma_reuse[0][2].numel()} "
        f"and {dma_reuse[1][2].numel()} on {sms} SMs; scale2 at n 1 to 16,386)")
    return n


def cover_row_timing(torch, probes) -> dict:
    """Both redesigned row gathers, index_select and the plain version at the
    cover-row shape: tab [8192, 1536] f32 (the grid path's Gp and cover width
    at plane 64), 6,433 sorted distinct rows (the grid mapping run's count).
    Cold: the L2 is evicted by a 256 MB read before every call, so every
    row comes from device memory; back to back: the calls run one after the
    other with no flush, and the L2 keeps what it keeps of the 50 MB table."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    tab = torch.randn((8192, 1536), generator=gen, device="cuda")
    idx = torch.as_tensor(probes.cover_index(8192, 6433), device="cuda")
    junk = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")  # 256 MB
    calls = {"row_gather_loop": lambda: probes.row_gather_loop(tab, idx),
             "dma_rows": lambda: probes.dma_rows(tab, idx),
             "index_select": lambda: torch.index_select(tab, 0, idx),
             "plain": lambda: probes.row_gather_plain(tab, idx)}
    order = ["row_gather_loop", "dma_rows", "index_select", "plain",
             "plain", "index_select", "dma_rows", "row_gather_loop"]
    cold = in_turns(lambda fn: time_cold_ms(torch, fn, 20, lambda: junk.sum()), calls, order)
    warm = in_turns(lambda fn: time_ms(torch, fn, 50), calls, order)
    nbytes = gather_bytes(tab, idx)
    res = {"shape": [list(tab.shape), [idx.numel()]], "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "cold_ms": {k: float(np.median(v)) for k, v in cold.items()},
           "cold_turns": cold,
           "back_to_back_ms": {k: float(np.median(v)) for k, v in warm.items()},
           "back_to_back_turns": warm}
    for k in calls:
        log(f"[probes] cover rows {k}: cold {res['cold_ms'][k]:.5f} ms "
            f"({nbytes / res['cold_ms'][k] / 1e9:.3f} TB/s), back to back "
            f"{res['back_to_back_ms'][k]:.5f} ms, turns {cold[k]} / {warm[k]}")
    log(f"[probes] cover rows: {nbytes} B, bound {res['bound_ms']:.5f} ms (bytes)")
    return res


def phase_probes(torch):
    """The probes' own entry point, counted; the two redesigned gathers'
    exactness at ragged and reusing shapes; then each kernel against its
    plain version, timed in interleaved turns against the plain version and
    one PyTorch call, with bounds; and the cover-row shape. Returns the five
    JSON entries."""
    from funny_lidar_slam_torch.ops import probes

    for p in probes.PROBES:
        p.launches = 0
    probes.run("cuda")  # checks each output against the TPU probe's expression
    torch.cuda.synchronize()
    launches = {p.__name__: p.launches for p in probes.PROBES}
    assert all(v > 0 for v in launches.values()), f"a probe did not launch: {launches}"

    checks = probe_exactness(torch, probes)
    lines = {"scale2": 12, "row_gather_loop": 27, "row_gather_vector": 63,
             "lane_gather": 87, "dma_rows": 112}
    inputs = probes.probe_inputs("cuda", seed=1)
    # the launch floor: one empty PyTorch launch, timed in the same turns
    order = ["kernel", "library", "plain", "floor", "floor", "plain", "library", "kernel"] * 2
    entries = []
    for fn in probes.PROBES:
        name = fn.__name__
        args = inputs[name]
        if name == "scale2":
            (x,) = args
            plain, library = probes.scale2_plain, (lambda x=x: x * 2)
            call, nbytes, ops = "x * 2", 2 * x.numel() * 4, x.numel()
        elif name == "lane_gather":
            x, idx = args
            idx64 = idx.long()
            plain, library = probes.lane_gather_plain, (lambda: torch.gather(x, 1, idx64))
            uniq = int(torch.unique(idx64 + x.shape[1] * torch.arange(
                x.shape[0], device=x.device)[:, None]).numel())
            call, nbytes, ops = "torch.gather(x, 1, idx)", uniq * 4 + 2 * idx.numel() * 4, 0
        else:
            tab, idx = args
            plain, library = probes.row_gather_plain, (lambda: torch.index_select(tab, 0, idx))
            call, nbytes, ops = "torch.index_select(tab, 0, idx)", gather_bytes(tab, idx), 0
        out_k, out_p = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p), f"{name}: the kernel differs from its plain version"
        turns = in_turns(lambda f: time_ms(torch, f, 200),
                         {"kernel": lambda: fn(*args), "plain": lambda: plain(*args),
                          "library": library, "floor": lambda: torch.cuda._sleep(0)}, order)
        ms, plain_ms, library_ms, floor_ms = (float(np.median(turns[k]))
                                              for k in ("kernel", "plain", "library", "floor"))
        bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        entries.append({
            "name": name, "route": "cuda",
            "source": "funny_lidar_slam_torch/csrc/probes.cu",
            "replaces": f"tools/pallas_smoke.py:{lines[name]}",
            "launches": launches[name], "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": library_ms, "parity": "exact", "library_call": call,
            "bytes": nbytes, "shapes": [list(a.shape) for a in args],
            "turns": turns, "vs_library": versus(turns["kernel"], turns["library"]),
            "floor_ms": floor_ms, "vs_floor": versus(turns["kernel"], turns["floor"]),
        })
        log(f"[probes] {name} {[tuple(a.shape) for a in args]}: kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, {call} {library_ms:.5f} ms, empty launch {floor_ms:.5f} ms, "
            f"bound {entries[-1]['bound_ms']:.6f} ms (bytes), exact; kernel "
            f"{entries[-1]['vs_library']} than the library call, "
            f"{entries[-1]['vs_floor']} than the empty launch; turns {turns}")
    cover = cover_row_timing(torch, probes)
    for e in entries:
        if e["name"] in ("scale2", "row_gather_vector"):
            e.update(exact_checks=checks)
        if e["name"] in ("row_gather_loop", "dma_rows"):
            e.update(exact_checks=checks, cover_rows={
                "ms": cover["cold_ms"][e["name"]], "library_ms": cover["cold_ms"]["index_select"],
                "plain_ms": cover["cold_ms"]["plain"], "bound_ms": cover["bound_ms"],
                "back_to_back_ms": cover["back_to_back_ms"][e["name"]],
                "back_to_back_library_ms": cover["back_to_back_ms"]["index_select"],
                "shape": cover["shape"]})
    for p in probes.PROBES:  # the JSON line reports the entry point's counts
        p.launches = launches[p.__name__]
    return entries


def world_frame_scan(torch, scan, cap=16384):
    """One simulated scan in the world frame at its true pose, padded."""
    pts = np.zeros((cap, 3), np.float32)
    n = min(len(scan.points), cap)
    r, t = scan.gt_pose[:3, :3], scan.gt_pose[:3, 3]
    pts[:n] = (scan.points[:n] @ r.T + t).astype(np.float32)
    return torch.as_tensor(pts, device="cuda"), torch.as_tensor(np.arange(cap) < n, device="cuda")


def hashed_select_inputs(torch, ds):
    """fused_select's hashed block-map inputs: the localization crop of the
    simulator world filtered at 0.4 m, and scan 30's queries. Returns the
    map, the K=16 inputs (Gp=8192), the fitness inputs (K=1, Gp=N, every
    query valid) and the cover-row counts."""
    from funny_lidar_slam_torch.io.pcd import voxel_downsample_np
    from funny_lidar_slam_torch.io.simulator import make_world
    from funny_lidar_slam_torch.maps import block_map
    from funny_lidar_slam_torch.ops.voxel import voxel_downsample

    world = voxel_downsample_np(make_world(seed=7), 0.4)
    center = np.array([20.0, 0.0, 1.5])
    crop = world[np.all(np.abs(world - center) <= 40.0, axis=1)]
    cap = 65536
    mpts = np.zeros((cap, 3), np.float32)
    mpts[: len(crop)] = crop
    m = block_map.build(cap, 8, torch.as_tensor(mpts, device="cuda"),
                        torch.as_tensor(np.arange(cap) < len(crop), device="cuda"), 1.0)
    pts, msk = world_frame_scan(torch, ds.scans[30])
    src = voxel_downsample(pts, msk, 0.4, 16384)
    n = src.points.shape[0]
    inputs = cover_inputs(torch, m, src.points, src.mask, gcap=8192)
    fit_inputs = cover_inputs(torch, m, src.points, None, gcap=n)  # fitness: all N, gcap = N
    ngroups = int(torch.unique(inputs[1]).numel())  # cover rows the queries use
    miss_rows = int((inputs[0][:ngroups] >= 1e29).all(1).sum())
    blocks = inputs[0][:ngroups].reshape(ngroups, 8, -1)
    miss_blocks = int((blocks >= 1e29).all(2).sum())
    log(f"[hashed] map {len(crop)} pts, {int(block_map.num_blocks(m))} blocks, load "
        f"{float(block_map.load_factor(m)):.3f}; queries {n} ({int(src.mask.sum())} valid), "
        f"{ngroups} cover rows used: {miss_rows} all-miss rows, {miss_blocks} of "
        f"{8 * ngroups} blocks missed")
    counts = {"all_miss_rows": miss_rows, "cover_rows": ngroups, "missed_blocks": miss_blocks}
    return m, inputs, fit_inputs, counts


def phase_hashed_select(torch, ds):
    """fused_select on hashed block-map inputs (`hashed_select_inputs`):
    parity at every stencil, the fitness shape, K=1 against brute force,
    times in turns at both shapes, and the K sweep at K=16's inputs."""
    from funny_lidar_slam_torch.ops import select

    m, inputs, fit_inputs, counts = hashed_select_inputs(torch, ds)
    n = fit_inputs[2].shape[0]
    max_err = 0.0
    for stencil in select.STENCILS:
        out_k, out_p, qs = run_both(torch, select, inputs, 16, stencil)
        max_err = max(max_err, assert_parity(out_k, out_p, qs))
        log(f"[hashed] fused_select K=16 {stencil}: parity ok")
    out_k, out_p, qs = run_both(torch, select, fit_inputs, 1, "nearby26")
    max_err = max(max_err, assert_parity(out_k, out_p, qs))
    log(f"[hashed] fused_select K=1 Gp={n}: parity ok")

    stored = stored_points(m)
    vox_q, vox_m = np.floor(qs).astype(np.int64), np.floor(stored).astype(np.int64)
    checked = 0
    for i in range(0, len(qs), 61):
        within = (np.abs(vox_m - vox_q[i]) <= 1).all(1)
        if not within.any():
            assert out_k[0][i, 0] >= 1e18, (i, out_k[0][i, 0])
            continue
        d2 = ((stored[within] - qs[i]) ** 2).sum(1).min()
        assert abs(out_k[0][i, 0] - d2) < 1e-4, (i, out_k[0][i, 0], d2)
        checked += 1
    log(f"[hashed] fused_select K=1 vs brute force: ok ({checked} rows with neighbours)")

    shapes = {"hashed_k16": select_timing(torch, select, inputs, 16),
              "hashed_fitness_k1": select_timing(torch, select, fit_inputs, 1)}
    for key, t in shapes.items():
        log(f"[hashed] fused_select {key} N={t['n']} Gp={t['gp']} rows_read={t['rows_read']}: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, topk "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"kernel {t['vs_library']} than topk; turns {t['turns']}")
    sweep = k_sweep(torch, select, inputs)
    log(f"[hashed] fused_select K sweep: {sweep}")
    return {"max_abs_err": max_err, **counts, "shapes": shapes, "k_sweep": sweep}


def capture_first_gather(torch, ds, mode):
    """Init and the first steps of `mode` on the simulator run, recording
    the state the first match starts from, the fused_select calls of that
    match, and then the matcher's fitness (K=1, Gp=N) on that state, the
    match's planar cloud and guess. Returns (state, match calls, fitness
    call); each call is ((cand_tab, gid, qpts, k, plane), {stencil, qvox})."""
    from funny_lidar_slam_torch.ops import select

    slam = bench_system(mode)
    orig_sel, orig_match = select.fused_select, slam.matcher.match
    first, calls, recording = {}, [], [False]

    def sel(*a, **kw):
        if recording[0]:
            calls.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a),
                          {"stencil": kw["stencil"], "qvox": kw["qvox"].clone()}))
        return orig_sel(*a, **kw)

    def match(s, *args):
        if first:
            return orig_match(s, *args)
        first.update(state=s, args=args)
        recording[0] = True
        try:
            return orig_match(s, *args)
        finally:
            recording[0] = False

    sel.launches = 0
    select.fused_select, slam.matcher.match = sel, match
    try:
        slam.run_dataset(ds, max_scans=3)
        assert first, f"[{mode}] no scan was matched"
        n_match = len(calls)
        recording[0] = True
        slam.matcher.fitness(first["state"], first["args"][-2], first["args"][-1])
        recording[0] = False
    finally:
        select.fused_select = orig_sel
    torch.cuda.synchronize()
    return first["state"], calls[:n_match], calls[n_match]


def stencil_within(d, stencil):
    """Which voxel offsets |d| [M, 3] lie in `stencil` (ops/select.py)."""
    within = (d <= 1).all(1)
    if stencil == "nearby18":
        return within & ~(d == 1).all(1)
    if stencil == "nearby6":
        return within & (d.sum(1) <= 1)
    if stencil == "center":
        return (d == 0).all(1)
    return within


def brute_force_k1(out_d2, inputs, stored, inv, stencil, step):
    """K=1 results against brute force over the map's stored points, on
    every `step`-th sorted row whose cover row is its own voxel's (masked
    rows and rows past the group capacity borrow another group's cover).
    Returns the number of rows compared that had a neighbour."""
    _, gid_t, qs_t, qvox_t = inputs
    gid, qs, qvox = gid_t.cpu().numpy(), qs_t.cpu().numpy(), qvox_t.cpu().numpy()
    first_of = {g: i for i, g in reversed(list(enumerate(gid.tolist())))}
    vox_m = np.floor(stored.astype(np.float32) * np.float32(inv)).astype(np.int64)
    checked = 0
    for i in range(0, len(qs), step):
        if not (qvox[i] == qvox[first_of[gid[i]]]).all():
            continue
        within = stencil_within(np.abs(vox_m - qvox[i]), stencil)
        if not within.any():
            assert out_d2[i, 0] >= 1e18, (i, out_d2[i, 0])
            continue
        d2 = ((stored[within] - qs[i]) ** 2).sum(1).min()
        assert abs(out_d2[i, 0] - d2) < 1e-4, (i, out_d2[i, 0], d2)
        checked += 1
    return checked


def phase_loam_select(torch, ds):
    """fused_select on the LOAM paths' own inputs (`capture_first_gather`):
    the first gather of PointToPlane_IVOX (planar queries, nearby18, the
    0.5 m hashed map) and of LoamFull_KdTree (corner queries N=2048 over
    Gp=8192 cover rows, then planar queries, nearby26), and each matcher's
    fitness shape (K=1, Gp=N). Each against the plain version at its K and
    at K=1 against brute force, then timed in turns with its bound."""
    from funny_lidar_slam_torch.ops import select

    shapes, max_err, checked = {}, 0.0, {}
    for mode, names in (("PointToPlane_IVOX", ["ivox_planar"]),
                        ("LoamFull_KdTree", ["loam_corner", "loam_planar"])):
        state, gathers, fit_call = capture_first_gather(torch, ds, mode)
        if mode == "PointToPlane_IVOX":
            maps, fit_map = [(state.m, 2.0)], (state.m, 2.0)
        else:
            maps = [(state.corner.m, 1.0), (state.planar.m, 1.0)]
            fit_map = maps[1]
        assert len(gathers) >= len(names), f"[{mode}] {len(gathers)} gathers captured"
        cases = list(zip(names, gathers, maps)) + [(names[-1] + "_fitness", fit_call, fit_map)]
        for name, ((wnd, gid, qs, k, plane), kw), (m, inv) in cases:
            inputs, stencil = (wnd, gid, qs, kw["qvox"]), kw["stencil"]
            out_k, out_p, qs_np = run_both(torch, select, inputs, k, stencil, plane)
            max_err = max(max_err, assert_parity(out_k, out_p, qs_np))
            if k != 1:
                out_k, out_p, qs_np = run_both(torch, select, inputs, 1, stencil, plane)
                max_err = max(max_err, assert_parity(out_k, out_p, qs_np))
            checked[name] = brute_force_k1(out_k[0], inputs, stored_points(m), inv, stencil,
                                           max(1, qs.shape[0] // 2000))
            assert checked[name] > 0, f"[{name}] no row had a neighbour"
            t = select_timing(torch, select, inputs, k, stencil, plane)
            shapes[name] = t
            log(f"[loam-select] {name} N={t['n']} Gp={t['gp']} K={k} {stencil} rows_read="
                f"{t['rows_read']}: parity ok, K=1 vs brute force ok ({checked[name]} rows); "
                f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, topk "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
                f"kernel {t['vs_library']} than topk; turns {t['turns']}")
    return {"max_abs_err": max_err, "shapes": shapes, "brute_force_rows": checked}


def phase_loam_mapping(torch, ds, mode):
    """One LOAM-family path end to end (phases 7-9): the bench's config of
    `mode` under the mapping gates, and the keyframes' feature clouds."""
    slam, res = mapping_run(torch, ds, mode, lambda: bench_system(mode),
                            gn_capture=mode)  # an untimed run first: phase 21's inputs
    kfs = slam.keyframes.frames
    with_feat = sum(1 for kf in kfs if kf.planar is not None and len(kf.planar) > 0)
    # the init frame is keyframe 0 and carries no features
    assert with_feat >= len(kfs) - 1, f"[{mode}] {with_feat} of {len(kfs)} keyframes with features"
    res.update(keyframes_with_features=with_feat,
               mean_corner_points=float(np.mean([len(kf.corner) for kf in kfs[1:]] or [0])),
               mean_planar_points=float(np.mean([len(kf.planar) for kf in kfs[1:]] or [0])))
    log(f"[{mode}] " + json.dumps(res))
    return res["fused_select_launches"], res


def gt_pairs(ds, out):
    """(estimated poses, true poses) at the trajectory's times."""
    gt_map = {round(ti, 4): p for ti, p in zip(ds.gt_times, ds.gt_poses)}
    pairs = [(p, gt_map[round(ti, 4)]) for ti, p in zip(out["times"], out["poses"])
             if round(ti, 4) in gt_map]
    return np.asarray([a for a, _ in pairs]), np.asarray([b for _, b in pairs])


def bench_system(mode, cap=16384):
    """The port's SlamSystem on the bench's config of `mode` (bench.py:296-330)."""
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    return SlamSystem(bench.mode_config(mode, cap))


def check_launches(tag, launches, expect_select, loops=0):
    """fused_select launched on a path that gathers through it, and never on
    one that does not (NDT's stencil lookup runs inside ndt_gn_rounds); and
    pose_graph_gn once an accepted loop (`loops`; None where the path ran
    in another process), its launches kept in POSE_GRAPH_LAUNCHES."""
    from funny_lidar_slam_torch.ops import pose_graph

    if expect_select:
        assert launches > 0, f"[{tag}] the path did not launch fused_select"
    else:
        assert launches == 0, f"[{tag}] the path launched fused_select {launches} times"
    if loops is not None:
        n = pose_graph.pose_graph_gn.launches
        assert n == loops, f"[{tag}] pose_graph_gn launched {n} times for {loops} loops"
        POSE_GRAPH_LAUNCHES[tag] = n


def zero_counts():
    """Every kernel wrapper's launch count set to 0, just before a path,
    the GN driver's count of gather rounds and the callers' counts."""
    from funny_lidar_slam_torch.ops import (gn_loop, loam_features, pose_graph, recurrences,
                                            select)
    from funny_lidar_slam_torch.registration import gn

    select.fused_select.launches = 0
    for fn in recurrences.KERNELS + gn_loop.KERNELS + loam_features.KERNELS + pose_graph.KERNELS:
        fn.launches = 0
    for driver in gn.ROUND_DRIVERS.values():
        driver.rounds = 0
    for k in GN_CALLERS:
        GN_CALLERS[k] = 0
    HOST_LOOP_CALLS["run_gn_corr"] = 0
    FEATURE_CALLS["process"] = 0


# the callers of the GN loops that gather inside since zero_counts:
# NdtMatcher.match calls, the NDT stages of the loop closure's cascades
# (each cascade's resolutions) and the cascades (one refine each)
GN_CALLERS = {"matches": 0, "cascade_stages": 0, "cascades": 0}


def count_gn_callers():
    """Wraps NdtMatcher.match and loop_closure._verify_cascade once for the
    run, each call counted in GN_CALLERS: ndt_gn_rounds must launch once a
    match and once a cascade stage, plane_map_gn_rounds once a cascade
    (`gn_launches`)."""
    from funny_lidar_slam_torch.backend import loop_closure
    from funny_lidar_slam_torch.registration import matchers

    match, cascade = matchers.NdtMatcher.match, loop_closure._verify_cascade

    def counted_match(self, *a, **kw):
        GN_CALLERS["matches"] += 1
        return match(self, *a, **kw)

    def counted_cascade(cfg, *a, **kw):
        GN_CALLERS["cascade_stages"] += len(cfg.ndt_resolutions)
        GN_CALLERS["cascades"] += 1
        return cascade(cfg, *a, **kw)

    matchers.NdtMatcher.match = counted_match
    loop_closure._verify_cascade = counted_cascade


# the host-loop GN's calls since zero_counts (`run_gn_corr`, and `run_gn`
# over it): no path of the port runs it on the card
HOST_LOOP_CALLS = {"run_gn_corr": 0}


def count_host_loops():
    """Wraps registration/gn.py's run_gn_corr once for the run, each call
    counted in HOST_LOOP_CALLS (run_gn looks it up at call time)."""
    from funny_lidar_slam_torch.registration import gn

    host_loop = gn.run_gn_corr

    def counted(*a, **kw):
        HOST_LOOP_CALLS["run_gn_corr"] += 1
        return host_loop(*a, **kw)

    gn.run_gn_corr = counted


# the LOAM front end's calls since zero_counts (Frontend._process: the
# projection, the feature extraction and the planar filter of one scan)
FEATURE_CALLS = {"process": 0}


def count_feature_calls():
    """Wraps Frontend._process once for the run, each call counted in
    FEATURE_CALLS: corner_mask must launch once a call (`feature_launches`)."""
    from funny_lidar_slam_torch.pipeline.frontend import Frontend

    process = Frontend._process

    def counted(self, *a, **kw):
        FEATURE_CALLS["process"] += 1
        return process(self, *a, **kw)

    Frontend._process = counted


# path -> launches of the device-loop kernels in it (read just after it)
LOOP_LAUNCHES: dict = {}
# path -> corner_mask launches in it (read just after it)
FEATURE_LAUNCHES: dict = {}
# path -> GN kernel launches in it, all four kernels (read just after it)
GN_LAUNCHES: dict = {}
# path -> {GN kernel: launches}
GN_LAUNCHES_BY_KERNEL: dict = {}


def gn_kernel_of(matcher):
    """The name of the GN rounds kernel a matcher's driver launches."""
    from funny_lidar_slam_torch.registration import matchers

    for cls, name in ((matchers.IcpMatcher, "icp_gn_rounds"),
                      (matchers.PointToPlaneMatcher, "plane_gn_rounds"),
                      (matchers.LoamFullMatcher, "loam_gn_rounds"),
                      (matchers.NdtMatcher, "ndt_gn_rounds")):
        if isinstance(matcher, cls):
            return name
    return None


def gn_launches(tag, kernel, host_loops: bool = False) -> int:
    """The GN kernels' launches of the path just run, recorded and checked:
    no call of the host-loop GN (`run_gn_corr`, `run_gn`) unless
    `host_loops` (the profile tool's `gn_uncached_direct` stage, which
    times that loop on purpose as the JAX tool's stage does);
    each kernel once a gather round of its driver (one host read each);
    icp/plane/loam_gn_rounds > 0 for the path's own kernel (`kernel`) and
    none for the others; ndt_gn_rounds exactly once an NDT match and once
    an NDT stage of the loop closure's cascades (GN_CALLERS), > 0 on the
    NDT paths; plane_map_gn_rounds exactly once a cascade (the refine), so
    none on a path that verified no loop. Returns the path's launches."""
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.registration import gn

    counts = {}
    matches, stages = GN_CALLERS["matches"], GN_CALLERS["cascade_stages"]
    cascades = GN_CALLERS["cascades"]
    host = HOST_LOOP_CALLS["run_gn_corr"]
    assert host_loops or host == 0, f"[{tag}] the host-loop GN ran {host} times"
    assert (matches > 0) == (kernel == "ndt_gn_rounds"), f"[{tag}] {matches} NDT matches"
    for fn in gn_loop.KERNELS:
        n, rounds = fn.launches, gn.ROUND_DRIVERS[fn.__name__].rounds
        assert n == rounds, f"[{tag}] {fn.__name__} launched {n} times in {rounds} rounds"
        if fn is gn_loop.ndt_gn_rounds:
            assert n == matches + stages, \
                f"[{tag}] ndt_gn_rounds launched {n} times for {matches} matches and {stages} " \
                f"cascade stages"
        elif fn is gn_loop.plane_map_gn_rounds:
            assert n == cascades, \
                f"[{tag}] plane_map_gn_rounds launched {n} times for {cascades} cascades"
        else:
            assert (n > 0) == (fn.__name__ == kernel), \
                f"[{tag}] {fn.__name__} launched {n} times (the path's GN kernel: {kernel})"
        counts[fn.__name__] = n
    GN_LAUNCHES_BY_KERNEL[tag] = counts
    GN_LAUNCHES[tag] = sum(counts.values())
    return GN_LAUNCHES[tag]


def loop_launches(tag, stats, frontend) -> dict:
    """The device-loop kernels' launches of the path just run, recorded and
    checked against its steps (`stats` rows without "init"): one
    preintegrate and one tight_fuse a step under TightCouplingOptimization,
    one eskf_predict a step under TightCouplingKF, none under
    LooseCoupling; and the GN kernels' (`gn_launches`)."""
    from funny_lidar_slam_torch.ops import recurrences
    from funny_lidar_slam_torch.pipeline import frontend as fe

    fusion = frontend.cfg.fusion_method
    counts = {fn.__name__: fn.launches for fn in recurrences.KERNELS}
    steps = sum(1 for s in stats if not s.get("init"))
    tight, kf = fusion == fe.FUSION_TIGHT_OPT, fusion == fe.FUSION_TIGHT_KF
    expect = {"preintegrate": steps * tight, "eskf_predict": steps * kf,
              "tight_fuse": steps * tight}
    assert counts == expect, f"[{tag}] device-loop launches {counts}, expected {expect}"
    assert steps > 0, f"[{tag}] no step"
    LOOP_LAUNCHES[tag] = counts
    gn_launches(tag, gn_kernel_of(frontend.matcher))
    feature_launches(tag, frontend)
    return counts


def feature_launches(tag, frontend) -> int:
    """The LOAM corner kernel's launches of the path just run, recorded and
    checked: exactly one a LOAM front-end call (FEATURE_CALLS), > 0 on a
    path with a lidar geometry and none on the others."""
    from funny_lidar_slam_torch.ops import loam_features

    n, calls = loam_features.corner_mask.launches, FEATURE_CALLS["process"]
    assert n == calls, f"[{tag}] corner_mask launched {n} times in {calls} LOAM front-end calls"
    assert (n > 0) == (frontend.cfg.lidar_geometry is not None), \
        f"[{tag}] corner_mask launched {n} times (lidar geometry: {frontend.cfg.lidar_geometry})"
    FEATURE_LAUNCHES[tag] = n
    return n


def clone_tree(x):
    """Tensors cloned (on their device) through nested tuples."""
    if hasattr(x, "clone"):
        return x.clone()
    if isinstance(x, tuple):
        items = [clone_tree(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


# "grid" / "kf" / "m2dgr" -> [(kernel, args)] of the step's device-loop calls
LOOP_CAPTURES: dict = {}
# the same keys -> {kernel: launches while capturing}
LOOP_CAPTURE_LAUNCHES: dict = {}
# "grid" / "localization" / "turing" -> [args] of the ICP driver's
# icp_gn_rounds calls (carry before the call, candidates, radius, config,
# max_corr_dist_sq), and the launches while capturing
GN_CAPTURES: dict = {}
GN_CAPTURE_LAUNCHES: dict = {}
# the same keys, and "IVOX" / "KdTree" / "LoamFull" (phases 7-9),
# "localization <mode>" (12a-c) -> [(kernel, args)] of the LOAM drivers'
# plane_gn_rounds / loam_gn_rounds calls, and {kernel: launches while
# capturing}
LOAM_CAPTURES: dict = {}
LOAM_CAPTURE_LAUNCHES: dict = {}
LOAM_GN_KERNELS = ("plane_gn_rounds", "loam_gn_rounds")
# "ndt" (phase 10), "localization IncrementalNDT" (12d), "figure8-cascade"
# (phase 13's first cascade, replayed) -> [args] of run_gn_ndt's
# ndt_gn_rounds calls (carry before the call, source, mask, the map, inv,
# outlier_thresh, radius, config, num_probes), and the launches meanwhile
NDT_CAPTURES: dict = {}
NDT_CAPTURE_LAUNCHES: dict = {}
# "figure8" (phase 13's run, each verification's refine, kept by LoopProbe)
# and "figure8-cascade" (its first cascade, replayed) -> [args] of
# run_gn_plane_map's plane_map_gn_rounds calls (carry before the call,
# source, mask, the block map by reference, inv, plane_thresh,
# max_search_dist_sq, radius, config, stencil, num_probes), and the launches
# meanwhile
REFINE_CAPTURES: dict = {}
REFINE_CAPTURE_LAUNCHES: dict = {}
# every key -> [(OrderedScan, FeatureConfig)] of the corner_mask calls (the
# scan's depth, col, row, mask and row bounds cloned; no points), and the
# launches meanwhile: only the LOAM paths (FEATURE_PATHS) make any
FEATURE_CAPTURES: dict = {}
FEATURE_CAPTURE_LAUNCHES: dict = {}


def refine_capture(sink: list, rounds):
    """`rounds` (plane_map_gn_rounds) wrapped so that each call's arguments
    go to `sink`: the carry, source and mask cloned, the block map by
    reference (a BlockMap's tensors are never written in place, insert makes
    new ones)."""
    def wrapper(carry, src, mask, *rest):
        sink.append((carry.clone(), src.clone(), mask.clone(), *rest))
        return rounds(carry, src, mask, *rest)
    return wrapper


class LoopCapture:
    """While active, records the arguments (cloned) of every preintegrate,
    eskf.predict and tight fuse call of the frontend step under `key`
    (with `loops`), of every icp_gn_rounds call of the ICP driver, of
    every plane_gn_rounds / loam_gn_rounds call of the LOAM drivers, of
    every ndt_gn_rounds call of run_gn_ndt (the map by reference: an
    NdtMap's tensors are never written in place, insert makes new ones) and
    of every plane_map_gn_rounds call of run_gn_plane_map (`refine_capture`),
    and the kernels' launches meanwhile. The clones cost time a step, so a
    capture runs outside every timed or counted run."""

    def __init__(self, key, loops=True):
        self.key = key
        self.calls = LOOP_CAPTURES.setdefault(key, []) if loops else None
        self.gn_calls = GN_CAPTURES.setdefault(key, [])
        self.loam_calls = LOAM_CAPTURES.setdefault(key, [])
        self.ndt_calls = NDT_CAPTURES.setdefault(key, [])
        self.refine_calls = REFINE_CAPTURES.setdefault(key, [])
        self.feature_calls = FEATURE_CAPTURES.setdefault(key, [])

    def __enter__(self):
        from funny_lidar_slam_torch.fusion import eskf
        from funny_lidar_slam_torch.loam import features
        from funny_lidar_slam_torch.ops import gn_loop, loam_features, recurrences
        from funny_lidar_slam_torch.pipeline import frontend as fe
        from funny_lidar_slam_torch.registration import gn

        self.start = {fn.__name__: fn.launches for fn in recurrences.KERNELS}
        self.gn_start = gn_loop.icp_gn_rounds.launches
        self.loam_start = {k: getattr(gn_loop, k).launches for k in LOAM_GN_KERNELS}
        self.ndt_start = gn_loop.ndt_gn_rounds.launches

        self.saved = [(fe, "preintegrate", "preintegrate"), (eskf, "predict", "eskf_predict"),
                      (fe, "tight_fuse", "tight_fuse")] if self.calls is not None else []
        self.saved = [(mod, attr, kind, getattr(mod, attr)) for mod, attr, kind in self.saved]
        for mod, attr, kind, fn in self.saved:
            def wrapper(*args, kind=kind, fn=fn):
                self.calls.append((kind, clone_tree(args)))
                return fn(*args)
            setattr(mod, attr, wrapper)
        rounds = gn.icp_gn_rounds

        def gn_wrapper(*args):
            self.gn_calls.append(clone_tree(args))
            return rounds(*args)

        self.saved.append((gn, "icp_gn_rounds", "icp_gn_rounds", rounds))
        gn.icp_gn_rounds = gn_wrapper
        for kind in LOAM_GN_KERNELS:
            fn = getattr(gn, kind)

            def loam_wrapper(*args, kind=kind, fn=fn):
                self.loam_calls.append((kind, clone_tree(args)))
                return fn(*args)

            self.saved.append((gn, kind, kind, fn))
            setattr(gn, kind, loam_wrapper)
        ndt_rounds = gn.ndt_gn_rounds

        def ndt_wrapper(carry, src, mask, m, *rest):
            self.ndt_calls.append((carry.clone(), src.clone(), mask.clone(), m, *rest))
            return ndt_rounds(carry, src, mask, m, *rest)

        self.saved.append((gn, "ndt_gn_rounds", "ndt_gn_rounds", ndt_rounds))
        gn.ndt_gn_rounds = ndt_wrapper
        self.refine_start = gn_loop.plane_map_gn_rounds.launches
        self.saved.append((gn, "plane_map_gn_rounds", "plane_map_gn_rounds",
                           gn.plane_map_gn_rounds))
        gn.plane_map_gn_rounds = refine_capture(self.refine_calls, gn.plane_map_gn_rounds)
        corners = features.corner_mask
        self.feature_start = loam_features.corner_mask.launches

        def feature_wrapper(scan, cfg):
            kept = scan._replace(points=None, rel_time=None)
            self.feature_calls.append((clone_tree(kept), cfg))
            return corners(scan, cfg)

        self.saved.append((features, "corner_mask", "corner_mask", corners))
        features.corner_mask = feature_wrapper
        return self

    def __exit__(self, *exc):
        from funny_lidar_slam_torch.ops import gn_loop, loam_features, recurrences

        for mod, attr, _, fn in self.saved:
            setattr(mod, attr, fn)
        if self.calls is not None:
            counts = LOOP_CAPTURE_LAUNCHES.setdefault(self.key, {})
            for fn in recurrences.KERNELS:
                name = fn.__name__
                counts[name] = counts.get(name, 0) + fn.launches - self.start[name]
        GN_CAPTURE_LAUNCHES[self.key] = (GN_CAPTURE_LAUNCHES.get(self.key, 0)
                                         + gn_loop.icp_gn_rounds.launches - self.gn_start)
        counts = LOAM_CAPTURE_LAUNCHES.setdefault(self.key, {})
        for k in LOAM_GN_KERNELS:
            counts[k] = counts.get(k, 0) + getattr(gn_loop, k).launches - self.loam_start[k]
        NDT_CAPTURE_LAUNCHES[self.key] = (NDT_CAPTURE_LAUNCHES.get(self.key, 0)
                                          + gn_loop.ndt_gn_rounds.launches - self.ndt_start)
        REFINE_CAPTURE_LAUNCHES[self.key] = (REFINE_CAPTURE_LAUNCHES.get(self.key, 0)
                                             + gn_loop.plane_map_gn_rounds.launches
                                             - self.refine_start)
        FEATURE_CAPTURE_LAUNCHES[self.key] = (FEATURE_CAPTURE_LAUNCHES.get(self.key, 0)
                                              + loam_features.corner_mask.launches
                                              - self.feature_start)


def mapping_run(torch, ds, tag, make, warm_scans=8, expect_select=True, capture=None,
                gn_capture=None):
    """Warm-up over a few scans, then the counted run of `make()` with the
    mapping gates: >= 40 tracked scans, finite poses, ATE < 0.10 m,
    fused_select launched (or, with `expect_select=False`, not), the
    device-loop kernels launched once a step as the fusion method asks;
    with `capture`, the warm-up runs every scan and keeps its device-loop
    and GN inputs under that key (with `gn_capture`, its GN inputs only),
    so the counted run stays the bare main path. The GN host reads a scan:
    one a gather round (ICP, LOAM) or one a match (NDT, whose kernel makes
    every iteration's gather itself)."""
    from funny_lidar_slam_torch.io.trajectory import ate_rmse, rpe_rmse
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.registration import gn

    if capture or gn_capture:  # kernel load and allocator, and phase 19-21's inputs
        with LoopCapture(capture or gn_capture, loops=bool(capture)):
            make().run_dataset(ds)
        torch.cuda.synchronize()
    elif warm_scans:  # kernel load and allocator, then the run
        make().run_dataset(ds, max_scans=warm_scans)
        torch.cuda.synchronize()
    slam = make()
    zero_counts()
    t = time.perf_counter()
    out = slam.run_dataset(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = select.fused_select.launches
    loop_counts = loop_launches(tag, slam.stats, slam.frontend)
    reads = sum(d.rounds for d in gn.ROUND_DRIVERS.values())  # one host read a round

    est, gt = gt_pairs(ds, out)
    n_tracked = len(out["poses"])
    assert n_tracked >= 40, f"[{tag}] too few tracked scans: {n_tracked}"
    assert np.isfinite(est).all(), f"[{tag}] non-finite poses"
    ate, rpe = ate_rmse(est, gt), rpe_rmse(est, gt)
    assert ate < 0.10, f"[{tag}] ATE {ate:.4f} m"
    check_launches(tag, launches, expect_select, len(getattr(slam, "loop_results", ())))
    steps = sum(1 for s in slam.stats if not s.get("init"))
    gathers = [s["iters"] for s in slam.stats if "iters" in s]
    res = {"tracked": n_tracked, "scans": len(ds.scans), "ate_m": ate, "rpe_m": rpe,
           "steady_fps": steady_fps(slam.stats), "wall_s": wall, "steps": steps,
           "gathers_per_scan": float(np.mean(gathers)),
           "fused_select_launches": launches, "launches_per_scan": launches / steps,
           "loop_launches": loop_counts, "keyframes": out["n_keyframes"],
           "gn_kernel_launches": GN_LAUNCHES[tag]}
    res["gn_host_reads_per_scan"] = reads / steps
    if gn_kernel_of(slam.frontend.matcher) == "ndt_gn_rounds":  # one launch a match
        res["gn_iterations_per_scan"] = sum(gathers) / steps  # each one a gather
        assert reads == GN_LAUNCHES[tag] == GN_CALLERS["matches"] == len(gathers), \
            f"[{tag}] {reads} GN host reads, {GN_LAUNCHES[tag]} launches for " \
            f"{GN_CALLERS['matches']} matches ({len(gathers)} scans matched)"
    else:  # one host read a gather round
        assert reads == GN_LAUNCHES[tag] == sum(gathers), \
            f"[{tag}] {reads} GN host reads, {GN_LAUNCHES[tag]} launches for {sum(gathers)} gathers"
    return slam, res


def traced_run(torch, ds, make, patches):
    """A second (traced) run of `make()` over the same scans with CUDA-event
    spans around the functions `patches` names ([(module, attribute, span)];
    calls of one span add up). Returns ({span: device ms per scan}, wall s);
    the wall time less the untraced run's is the tracing overhead."""
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

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for (mod, attr, name), (_, _, fn) in zip(patches, saved):
        setattr(mod, attr, timed(name, fn))
    try:
        prof = make()
        t = time.perf_counter()
        prof.run_dataset(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    n = sum(1 for s in prof.stats if not s.get("init"))
    return {k: sum(b.elapsed_time(e) for b, e in v) / n for k, v in spans.items()}, wall


def grid_system(fusion="TightCouplingOptimization"):
    """The headline config (bench.py:312-315): the dense grid (96, 96, 16)."""
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    return SlamSystem(bench.headline_config(16384, fusion))


def phase_e2e(torch, ds):
    from funny_lidar_slam_torch.pipeline import frontend as fe_mod
    from funny_lidar_slam_torch.registration import matchers

    _, res = mapping_run(torch, ds, "e2e", grid_system, capture="grid")
    phase_ms, traced_wall = traced_run(torch, ds, grid_system, [
        (fe_mod, "deskew", "deskew+preint"), (fe_mod, "preintegrate", "deskew+preint"),
        (fe_mod, "tight_fuse", "fusion"), (matchers, "run_gn_icp_cand", "gn"),
        (matchers, "window_add", "insert")])
    res.update(traced_wall_s=traced_wall, phase_ms_per_scan=phase_ms)
    log("[e2e] " + json.dumps(res))
    return res["fused_select_launches"], res


def phase_ndt_mapping(torch, ds):
    """IncrementalNDT on the bench's config (phase 10): the mapping gates,
    no fused_select launch, one ndt_gn_rounds launch and one GN host read a
    match, and the map's occupied and estimated voxels; an untimed run
    first keeps phase 22's inputs."""
    from funny_lidar_slam_torch.maps import ndt_map

    slam, res = mapping_run(torch, ds, "ndt", lambda: bench_system("IncrementalNDT"),
                            expect_select=False, gn_capture="ndt")
    m = slam.mstate.m
    res.update(occupied_voxels=int(ndt_map.num_occupied(m)),
               estimated_voxels=int(ndt_map.num_estimated(m)), map_epoch=int(m.epoch))
    log("[ndt-mapping] " + json.dumps(res))
    return res["fused_select_launches"], res


def phase_kf_mapping(torch, ds, grid_spans):
    """TightCouplingKF on the grid headline config (phase 11), then a traced
    run whose spans print beside phase 4's (`grid_spans`)."""
    from funny_lidar_slam_torch.fusion import eskf
    from funny_lidar_slam_torch.pipeline import frontend as fe_mod
    from funny_lidar_slam_torch.registration import matchers

    def make():
        return grid_system(fe_mod.FUSION_TIGHT_KF)

    _, res = mapping_run(torch, ds, "kf", make, capture="kf")
    phase_ms, traced_wall = traced_run(torch, ds, make, [
        (fe_mod, "deskew", "deskew"), (eskf, "predict", "eskf_predict"),
        (matchers, "run_gn_icp_cand", "gn"), (eskf, "update_pose", "eskf_update"),
        (matchers, "window_add", "insert")])
    res.update(traced_wall_s=traced_wall, phase_ms_per_scan=phase_ms,
               grid_tight_phase_ms_per_scan=grid_spans)
    log("[kf-mapping] " + json.dumps(res))
    log(f"[kf-mapping] ms per scan, KF: {json.dumps(phase_ms)}; tight (phase 4): "
        f"{json.dumps(grid_spans)}")
    return res["fused_select_launches"], res


def phase_hashed_mapping(torch, ds):
    """The figure-8 bench config without loop closure, on the IcpConfig
    default layout: the hashed block map with incremental block inserts."""
    from funny_lidar_slam_torch.maps import block_map
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    slam, res = mapping_run(torch, ds, "hashed", lambda: SlamSystem(bench.mapping_config()))
    m = slam.mstate.m
    assert isinstance(m, block_map.BlockMap)
    res.update(map_blocks=int(block_map.num_blocks(m)),
               map_load=float(block_map.load_factor(m)), map_epoch=int(m.epoch))
    log("[hashed-mapping] " + json.dumps(res))
    return res["fused_select_launches"], res


def phase_localization(torch, ds, mode="IcpOptimized"):
    """The bench's localization config (bench.py:202-214) against the frozen
    simulator world, initialized at the first scan's true pose: phase 6 with
    IcpOptimized, phases 12a-d with the bench's config of another mode."""
    from funny_lidar_slam_torch.io.simulator import make_world
    from funny_lidar_slam_torch.io.trajectory import ate_rmse, rpe_rmse
    from funny_lidar_slam_torch.localization import Localizer
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.registration import gn

    tag = "localization" if mode == "IcpOptimized" else f"localization {mode}"
    world = make_world(seed=7)
    with LoopCapture(tag, loops=False):  # an untimed run first: phase 20-22's GN inputs
        cap = Localizer(bench.localization_config(16384, mode))
        cap.set_global_map(world)
        cap.run_dataset(ds, ds.scans[0].gt_pose)
    torch.cuda.synchronize()
    loc = Localizer(bench.localization_config(16384, mode))
    loc.set_global_map(world)
    zero_counts()
    t = time.perf_counter()
    out = loc.run_dataset(ds, ds.scans[0].gt_pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = select.fused_select.launches
    loop_counts = loop_launches(tag, loc.stats, loc.frontend)
    reads = sum(d.rounds for d in gn.ROUND_DRIVERS.values())  # one host read a round
    if mode == "IncrementalNDT":  # one launch and one read a match, the init's too
        assert reads == GN_LAUNCHES[tag] == GN_CALLERS["matches"] > 0, \
            f"[{tag}] {reads} GN host reads, {GN_LAUNCHES[tag]} launches for " \
            f"{GN_CALLERS['matches']} matches"

    est, gt = gt_pairs(ds, out)
    assert loc.initialized, f"[{tag}] the init did not pass its fitness gate"
    assert len(est) >= 40, f"[{tag}] too few tracked scans: {len(est)}"
    assert np.isfinite(est).all(), f"[{tag}] non-finite poses"
    ate = ate_rmse(est, gt, align=True)
    assert ate < 0.10, f"[{tag}] ATE {ate:.4f} m"
    check_launches(tag, launches, mode != "IncrementalNDT")

    # what one map refresh costs: set_map on the last crop, host clock
    # around a synchronized build, median of 5
    crop = loc._pad_map(loc._crop_local(loc._map_center))
    refresh = []
    for _ in range(5):
        t = time.perf_counter()
        loc.matcher.set_map(loc.mstate, crop)
        torch.cuda.synchronize()
        refresh.append((time.perf_counter() - t) * 1e3)
    steps = len(loc.stats)
    res = {"tracked": len(est), "scans": len(ds.scans), "ate_m": ate,
           "ate_unaligned_m": ate_rmse(est, gt, align=False),
           "rpe_m": rpe_rmse(est, gt),
           "steady_fps": steady_fps(loc.stats), "wall_s": wall, "steps": steps,
           "gathers_per_scan": float(np.mean([s["iters"] for s in loc.stats])),
           "map_refreshes": loc.map_refreshes, "refresh_ms": float(np.median(refresh)),
           "local_map_points": int(crop.mask.sum()), "fused_select_launches": launches,
           "launches_per_scan": launches / max(steps, 1), "loop_launches": loop_counts,
           "gn_kernel_launches": GN_LAUNCHES[tag], "gn_host_reads_per_scan": reads / max(steps, 1)}
    log(f"[{tag}] " + json.dumps(res))
    return launches, res


def figure8_system():
    """The bench's Figure8_Loop config (bench.py:238-255): the hashed ICP
    mapping config with loop closure on (the figure-8's tighter index
    gates, the LoopClosureConfig defaults otherwise)."""
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    return SlamSystem(bench.figure8_config(16384))


def keyframe_ate(ds, slam):
    """ATE of the keyframe poses (after the pose-graph optimizations)."""
    from funny_lidar_slam_torch.io.trajectory import ate_rmse

    out = {"times": [f.timestamp for f in slam.keyframes.frames],
           "poses": list(slam.keyframes.poses())}
    est, gt = gt_pairs(ds, out)
    return ate_rmse(est, gt, align=True)


class LoopProbe:
    """Instruments one loop-closure run: a synchronized host clock and the
    fused_select launches (counted apart) around every verification and
    every pose-graph optimize, and the GN iterations and host reads of each
    verification (one read an NDT stage, whose whole loop is one
    ndt_gn_rounds launch, and one for the point-to-plane refine, one
    plane_map_gn_rounds launch); each verification's time is split into the
    keyframe fetch, the host merge of the submaps and the device cascade.
    Every refine call's arguments go to REFINE_CAPTURES[`key`]
    (`refine_capture`: a clone of the source and mask a verification).
    During the first verification it keeps the block map the cascade
    builds, the cascade's inputs, and the inputs of its first K=1
    fused_select call (the fitness); a K=5 call there (the refine's gather
    before the kernel took it) is kept too, and phase 13 requires none."""

    def __init__(self, torch, key="figure8"):
        from funny_lidar_slam_torch.backend import loop_closure
        from funny_lidar_slam_torch.maps import block_map
        from funny_lidar_slam_torch.ops import gn_loop, select
        from funny_lidar_slam_torch.pipeline import system
        from funny_lidar_slam_torch.registration import gn

        self.torch, self.select, self.block_map = torch, select, block_map
        self.lc, self.system, self.gn_loop, self.key = loop_closure, system, gn_loop, key
        self.verifications, self.optimize_ms, self.captured = [], [], {}
        self.graphs = []  # every optimize's inputs (clones) and its other arguments
        self.map = self.cascade_args = None
        # the current verification's GN loops: (iterations (a tensor), host reads)
        self.gn_iters = []
        self.parts = {"fetch_ms": [], "merge_ms": [], "cascade_ms": []}
        self.saved = [(loop_closure, "verify_candidate", loop_closure.verify_candidate),
                      (system, "pg_optimize", system.pg_optimize),
                      (loop_closure, "run_gn_plane_map", loop_closure.run_gn_plane_map),
                      (loop_closure, "materialize_batch", loop_closure.materialize_batch),
                      (loop_closure, "_merge_submap", loop_closure._merge_submap),
                      (loop_closure, "_verify_cascade", loop_closure._verify_cascade),
                      (loop_closure, "run_gn_ndt", loop_closure.run_gn_ndt),
                      (gn, "plane_map_gn_rounds", gn.plane_map_gn_rounds)]

    def __enter__(self):
        ((lc, _, verify), (system, _, optimize), (_, _, run_refine), (_, _, fetch),
         (_, _, merge), (_, _, cascade), (_, _, run_gn_ndt), (gn, _, rounds)) = self.saved
        self.refine_start = self.gn_loop.plane_map_gn_rounds.launches
        gn.plane_map_gn_rounds = refine_capture(REFINE_CAPTURES.setdefault(self.key, []), rounds)
        lc.verify_candidate = self._verify(verify)
        system.pg_optimize = self._kept(self._timed(optimize, self.optimize_ms))
        lc.materialize_batch = self._timed(fetch, self.parts["fetch_ms"])
        lc._merge_submap = self._timed(merge, self.parts["merge_ms"])
        timed_cascade = self._timed(cascade, self.parts["cascade_ms"])

        def kept_cascade(*a):
            if self.cascade_args is None:
                self.cascade_args = (a[0], tuple(x.clone() for x in a[1:]))
            return timed_cascade(*a)
        lc._verify_cascade = kept_cascade

        def counted(run):  # an NDT stage or the refine: one launch, one read
            def wrapper(*a, **kw):
                res = run(*a, **kw)
                self.gn_iters.append((res.iters, 1))
                return res
            return wrapper
        lc.run_gn_plane_map = counted(run_refine)
        lc.run_gn_ndt = counted(run_gn_ndt)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        REFINE_CAPTURE_LAUNCHES[self.key] = (self.gn_loop.plane_map_gn_rounds.launches
                                             - self.refine_start)

    def _timed(self, fn, sink):
        def wrapper(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    def _kept(self, fn):
        def optimize(g, *a, **kw):
            self.graphs.append((type(g)(*(t.clone() for t in g)), a, kw))
            return fn(g, *a, **kw)
        return optimize

    def _verify(self, verify):
        def wrapper(frames, poses, current_id, candidate_id, cfg, device=None):
            sel = self.select
            outer, sel.fused_select.launches = sel.fused_select.launches, 0
            first = not self.verifications
            if first:
                orig_sel, orig_build = sel.fused_select, self.block_map.build
                sel.fused_select = self._recorder(orig_sel)
                self.block_map.build = self._keep_map(orig_build)
            ms = []
            try:
                res = self._timed(verify, ms)(frames, poses, current_id, candidate_id, cfg,
                                             device)
            finally:
                if first:
                    orig_sel.launches = sel.fused_select.launches
                    sel.fused_select, self.block_map.build = orig_sel, orig_build
                inside = sel.fused_select.launches
                sel.fused_select.launches = outer + inside
            self.verifications.append({
                "current_id": current_id, "candidate_id": candidate_id, "ms": ms[0],
                "accepted": res is not None, "fitness": None if res is None else res.fitness,
                "fused_select_launches": inside,
                "gn_iterations": [int(i) for i, _ in self.gn_iters],
                "gn_host_reads": sum(r for _, r in self.gn_iters),
                **{k: float(sum(v)) for k, v in self.parts.items()}})
            self.gn_iters.clear()
            for v in self.parts.values():
                v.clear()
            return res
        return wrapper

    def _recorder(self, fn):
        torch = self.torch

        def rec(*a, **kw):
            key = {5: "loop_refine_k5", 1: "loop_fitness_k1"}.get(a[3])
            if key and key not in self.captured:
                self.captured[key] = (tuple(x.clone() if torch.is_tensor(x) else x for x in a),
                                      {"stencil": kw["stencil"], "qvox": kw["qvox"].clone()})
            return fn(*a, **kw)
        rec.launches = 0
        return rec

    def _keep_map(self, fn):
        def build(*a, **kw):
            self.map = fn(*a, **kw)
            return self.map
        return build


def phase_figure8(torch):
    """Phase 13: mapping with loop closure on the bench's Figure-8 config,
    its gates, then fused_select held against its plain version at the first
    verification's refine (K=5) and fitness (K=1) inputs."""
    from funny_lidar_slam_torch.io.simulator import simulate
    from funny_lidar_slam_torch.io.trajectory import ate_rmse, rpe_rmse
    from funny_lidar_slam_torch.ops import select

    t = time.perf_counter()
    sim_cfg, traj = bench.figure8_sim(16384)
    ds = simulate(sim_cfg, traj=traj)
    log(f"[figure8] simulated {len(ds.scans)} scans in {time.perf_counter() - t:.1f} s")
    slam = figure8_system()
    zero_counts()
    with LoopProbe(torch) as probe:
        t = time.perf_counter()
        out = slam.run_dataset(ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = select.fused_select.launches
    loop_counts = loop_launches("figure8", slam.stats, slam.frontend)

    est, gt = gt_pairs(ds, out)
    period = ds.scans[1].t - ds.scans[0].t
    after_warmup = sum(1 for sc in ds.scans if sc.t + period >= out["times"][0] - 1e-6)
    n_tracked = len(out["poses"])
    loops = slam.loop_results
    kf_ate = keyframe_ate(ds, slam)
    verify_ms = [v["ms"] for v in probe.verifications]
    res = {"tracked": n_tracked, "scans": len(ds.scans), "scans_after_warmup": after_warmup,
           "ate_m": ate_rmse(est, gt), "kf_ate_m": kf_ate, "rpe_m": rpe_rmse(est, gt),
           "steady_fps": steady_fps(slam.stats), "wall_s": wall,
           "keyframes": len(slam.keyframes), "vertices": slam.graph.n_vertices,
           "edges": slam.graph.n_edges, "verifications": len(probe.verifications),
           "loops_accepted": len(loops),
           "loops": [{"current_id": r.current_id, "candidate_id": r.candidate_id,
                      "fitness": r.fitness} for r in loops],
           "verify_ms_median": float(np.median(verify_ms)) if verify_ms else None,
           "verify_ms_max": float(np.max(verify_ms)) if verify_ms else None,
           "optimize_ms": probe.optimize_ms, "fused_select_launches": launches,
           "loop_launches": loop_counts,
           "fused_select_launches_in_verifications": sum(
               v["fused_select_launches"] for v in probe.verifications),
           "verify_gn_iterations": sum(sum(v["gn_iterations"]) for v in probe.verifications),
           "verify_gn_host_reads": sum(v["gn_host_reads"] for v in probe.verifications),
           "verification_log": probe.verifications}
    log("[figure8] " + json.dumps(res))
    assert np.isfinite(est).all(), "[figure8] non-finite poses"
    assert n_tracked >= 0.95 * after_warmup, f"[figure8] {n_tracked} of {after_warmup} tracked"
    assert loops, "[figure8] no loop accepted"
    for r in loops:
        assert r.fitness < 1.5 and r.current_id - r.candidate_id > 40, f"[figure8] loop {r}"
    assert kf_ate < 0.5, f"[figure8] keyframe ATE {kf_ate:.4f} m"
    check_launches("figure8", launches, True, len(loops))
    # the refine: one plane_map_gn_rounds launch and one host read a
    # verification, beside one each NDT stage, and no K=5 fused_select
    stages = len(probe.cascade_args[0].ndt_resolutions)
    reads = [v["gn_host_reads"] for v in probe.verifications]
    refines = REFINE_CAPTURES["figure8"]
    assert reads == [stages + 1] * len(reads), f"[figure8] GN host reads a verification {reads}"
    assert REFINE_CAPTURE_LAUNCHES["figure8"] == len(refines) == len(reads) \
        == GN_LAUNCHES_BY_KERNEL["figure8"]["plane_map_gn_rounds"] > 0, \
        f"[figure8] {REFINE_CAPTURE_LAUNCHES['figure8']} refine launches, {len(refines)} " \
        f"refine calls, {len(reads)} verifications"
    assert "loop_refine_k5" not in probe.captured, "[figure8] a verification ran a K=5 gather"
    res["refine_launches"] = len(refines)
    PG_GRAPHS[:] = probe.graphs
    res["pose_graph_gn_launches"] = POSE_GRAPH_LAUNCHES["figure8"]
    res["select"] = loop_select(torch, probe)
    res["cascade"] = cascade_breakdown(torch, probe)
    return slam, launches, res


def refine_gather_inputs(torch, args) -> tuple:
    """The fused_select call (positional arguments, keywords) of the K=5
    gather that a refine call (`args`, plane_map_gn_rounds' arguments) makes
    at its start pose when it runs the plain version: point_to_plane_corr
    at that pose on the call's source and block map, its fused_select call
    recorded (and launched)."""
    from funny_lidar_slam_torch.ops import gn_loop, select
    from funny_lidar_slam_torch.registration import residuals

    carry, src, mask, m, inv, thresh, max_d2, _, _, stencil, probes = args
    kept, fn = [], select.fused_select

    def record(*a, **kw):
        kept.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a),
                     {"stencil": kw["stencil"], "qvox": kw["qvox"].clone()}))
        return fn(*a, **kw)

    record.launches = 0  # the wrapper counts into select.fused_select: not a path's launch
    select.fused_select = record
    try:
        residuals.point_to_plane_corr(gn_loop.result_views(carry).t_mat, src, mask, m, inv,
                                      thresh, max_d2, stencil, probes)
    finally:
        select.fused_select = fn
    assert len(kept) == 1 and kept[0][0][3] == 5, [k[0][3] for k in kept]
    return kept[0]


def loop_select(torch, probe) -> dict:
    """fused_select at the first verification's inputs (N = Gp = 16384 over
    the cascade's 131,072-capacity block map, nearby26): the refine's gather
    at its start pose (built from the captured refine call,
    `refine_gather_inputs`: the refine itself gathers inside its kernel) at
    K=5 and K=1, the fitness call at K=1, each against the plain version,
    K=1 against brute force over the map's stored points; both shapes timed
    in turns with the bound and torch.topk."""
    from funny_lidar_slam_torch.ops import select

    assert set(probe.captured) == {"loop_fitness_k1"}, sorted(probe.captured)
    probe.captured["loop_refine_k5"] = refine_gather_inputs(torch, REFINE_CAPTURES["figure8"][0])
    stored = stored_points(probe.map)
    shapes, max_err, checked = {}, 0.0, {}
    for name, ((wnd, gid, qs, k, plane), kw) in sorted(probe.captured.items()):
        inputs, stencil = (wnd, gid, qs, kw["qvox"]), kw["stencil"]
        out_k, out_p, qs_np = run_both(torch, select, inputs, k, stencil, plane)
        max_err = max(max_err, assert_parity(out_k, out_p, qs_np))
        if k != 1:
            out_k, out_p, qs_np = run_both(torch, select, inputs, 1, stencil, plane)
            max_err = max(max_err, assert_parity(out_k, out_p, qs_np))
        checked[name] = brute_force_k1(out_k[0], inputs, stored, 1.0, stencil,
                                       max(1, qs.shape[0] // 2000))
        assert checked[name] > 0, f"[{name}] no row had a neighbour"
        t = select_timing(torch, select, inputs, k, stencil, plane)
        shapes[name] = t
        log(f"[figure8-select] {name} N={t['n']} Gp={t['gp']} K={k} {stencil} rows_read="
            f"{t['rows_read']}: parity ok, K=1 vs brute force ok ({checked[name]} rows); "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, topk "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"kernel {t['vs_library']} than topk; turns {t['turns']}")
    return {"max_abs_err": max_err, "shapes": shapes, "brute_force_rows": checked,
            "map_points": len(stored)}


def profiled(torch, run):
    """(profiler, wall ms, device-busy ms) of `run()` under torch.profiler:
    the busy time is the union of the traced device events; None when the
    trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return prof, wall, (busy / 1e3 if spans else None)


def device_busy_ms(torch, run) -> tuple:
    """(wall ms, device-busy ms) of `run()` under torch.profiler."""
    return profiled(torch, run)[1:]


def runtime_calls(torch, run) -> dict:
    """Wall and device-busy ms of `run()` under torch.profiler, its CUDA
    runtime calls by name (launches, copies, synchronizations: count and
    host ms) and its ATen operator calls (count, host ms)."""
    prof, wall, busy = profiled(torch, run)
    events = prof.key_averages()
    calls = {e.key: {"count": e.count, "host_ms": e.self_cpu_time_total / 1e3}
             for e in events if e.key.startswith("cuda")}
    aten = [e for e in events if e.key.startswith("aten::")]
    return {"wall_ms": wall, "busy_ms": busy, "runtime": calls,
            "aten_ops": sum(e.count for e in aten),
            "aten_host_ms": sum(e.self_cpu_time_total for e in aten) / 1e3}


def cascade_breakdown(torch, probe) -> dict:
    """The first verification's device cascade replayed on its captured
    inputs: once under LoopCapture (phase 22's NDT inputs and phase 25's
    refine input), then its synchronized ms, then one replay with a
    synchronized clock around each stage kind (voxel filters, block map,
    NDT map create and load, the NDT stages' GN loops, one ndt_gn_rounds
    launch and one host read each, the refine's, one plane_map_gn_rounds
    launch and one host read, fitness calls), then one under torch.profiler
    for the device's busy share."""
    from funny_lidar_slam_torch.maps import block_map, ndt_map
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.registration import gn

    lc = probe.lc
    cfg, args = probe.cascade_args

    def run():
        return lc._verify_cascade(cfg, *args)

    with LoopCapture("figure8-cascade", loops=False):
        run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3

    stages, iters = {}, []

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            n, ms = stages.get(name, (0, 0.0))
            stages[name] = (n + 1, ms + (time.perf_counter() - t) * 1e3)
            if hasattr(out, "iters"):
                iters.append(int(out.iters))
            return out
        return wrapper

    saved = [(m, a, getattr(m, a)) for m, a in (
        (lc, "voxel_downsample"), (block_map, "build"), (ndt_map, "create"),
        (ndt_map, "insert"), (lc, "run_gn_ndt"), (lc, "run_gn_plane_map"),
        (lc, "fitness_score"))]
    kernels, drivers = (gn_loop.ndt_gn_rounds, gn_loop.plane_map_gn_rounds), \
        (gn.run_gn_ndt, gn.run_gn_plane_map)
    before = [f.launches for f in kernels] + [d.rounds for d in drivers]
    try:
        for m, a, fn in saved:
            setattr(m, a, timed(a, fn))
        run()
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    launched, refine_launched, read, refine_read = (
        now - was for now, was in zip([f.launches for f in kernels] + [d.rounds for d in drivers],
                                      before))
    try:
        prof_wall, busy = device_busy_ms(torch, run)
    except RuntimeError as e:  # without CUPTI tracing the split is unmeasured, not a fault
        log(f"[figure8-cascade] torch.profiler failed ({e}): device busy time not measured")
        prof_wall, busy = None, None
    ndt_n, ndt_ms = stages["run_gn_ndt"]
    gn_n, gn_ms = stages["run_gn_plane_map"]
    stages_n = len(cfg.ndt_resolutions)
    res = {"cascade_ms": wall_ms, "stages": {k: {"calls": n, "ms": ms}
                                             for k, (n, ms) in stages.items()},
           "gn_iterations": iters, "ndt_gn_launches": launched,
           "refine_launches": refine_launched, "host_reads": read + refine_read,
           "ndt_host_reads": read, "refine_host_reads": refine_read,
           "refine_iterations": sum(iters[ndt_n:]), "refine_ms": gn_ms,
           "ndt_ms_per_iteration": ndt_ms / max(sum(iters[:ndt_n]), 1),
           "refine_ms_per_iteration": gn_ms / max(sum(iters[ndt_n:]), 1),
           "profiled_ms": prof_wall, "device_busy_ms": busy,
           "device_idle_share": None if busy is None else 1.0 - busy / prof_wall}
    log("[figure8-cascade] " + json.dumps(res))
    # one launch and one host read an NDT stage, and one of each for the refine
    assert ndt_n == launched == read == stages_n, \
        f"[figure8-cascade] {ndt_n} NDT stages ({launched} launches, {read} reads) of {stages_n}"
    assert gn_n == refine_launched == refine_read == 1 and res["host_reads"] == stages_n + 1, \
        f"[figure8-cascade] {gn_n} refines, {refine_launched} launches, {refine_read} reads"
    return res


def phase_resume_and_map(torch, ds, fig8_slam):
    """Phase 14: the grid config with a keyframe store fed the first half
    of the run scan by scan, then SlamSystem.resume fed the rest, under
    tests/test_resume.py's gates; then save_map(split=True) of phase 13's
    system, read back, its tiles covering every point."""
    import tempfile

    from funny_lidar_slam_torch.io.pcd import read_pcd
    from funny_lidar_slam_torch.io.trajectory import ate_rmse
    from funny_lidar_slam_torch.maps import split_map
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.pipeline.system import SlamSystem

    period = ds.scans[1].t - ds.scans[0].t

    def feed(slam, lo, hi):
        t_hi = ds.scans[hi - 1].t + period + 0.05 if hi < len(ds.scans) else np.inf
        for k in range(len(ds.imu_t)):
            if ds.imu_t[k] > t_hi:
                break
            slam.push_imu(ds.imu_t[k], ds.imu_gyro[k], ds.imu_accel[k])
        for sc in ds.scans[lo:hi]:
            slam.process_scan(sc.t, sc.t + period, sc.points, sc.rel_times)

    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cfg = bench.mapping_config(16384, map_layout="grid", grid_dims=bench.GRID_DIMS,
                                   system=dict(keyframe_save_dir=os.path.join(tmp, "keyframes")))
        half = len(ds.scans) // 2
        zero_counts()
        t = time.perf_counter()
        a = SlamSystem(cfg)
        feed(a, 0, half)
        n_kf_a, poses_a, times_a = len(a.keyframes), list(a.trajectory), list(a.trajectory_t)
        stats_a = list(a.stats)
        del a  # "kill"
        b = SlamSystem.resume(cfg)
        assert len(b.keyframes) == n_kf_a >= 2 and b.graph.n_vertices == n_kf_a, \
            f"[resume] {len(b.keyframes)} keyframes, {b.graph.n_vertices} vertices, {n_kf_a} saved"
        feed(b, half, len(ds.scans))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = select.fused_select.launches
        loop_counts = loop_launches("resume", stats_a + b.stats, b.frontend)
        est, gt = gt_pairs(ds, {"times": times_a + list(b.trajectory_t),
                                "poses": poses_a + list(b.trajectory)})
        ate = ate_rmse(est, gt, align=True)
        d0 = float(np.linalg.norm(b.trajectory[0][:3, 3]
                                  - b.keyframes.frames[n_kf_a - 1].pose[:3, 3]))
        res = {"keyframes_saved": n_kf_a, "keyframes_after": len(b.keyframes),
               "tracked_before": len(poses_a), "tracked_after": len(b.trajectory), "ate_m": ate,
               "resume_jump_m": d0, "wall_s": wall, "fused_select_launches": launches,
               "loop_launches": loop_counts}
        assert len(b.trajectory) >= 10, f"[resume] {len(b.trajectory)} scans after the resume"
        assert ate < 0.4, f"[resume] combined ATE {ate:.4f} m"
        assert d0 < 2.5, f"[resume] the resume jumped {d0:.2f} m"
        check_launches("resume", launches, True)

        map_dir = os.path.join(tmp, "map")
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = fig8_slam.save_map(map_dir, split=True)
        map_ms = (time.perf_counter() - t) * 1e3
        pts, _ = read_pcd(path)
        tiles = split_map.load_tile_indices(map_dir)
        tiled = [split_map.load_tile(map_dir, *ij) for ij in tiles]
        assert len(pts) > 0 and np.isfinite(pts).all(), "[save_map] empty or non-finite map"
        assert sum(len(p) for p in tiled) == len(pts), "[save_map] tiles miss points"
        for (gx, gy), p in zip(tiles, tiled):
            assert (split_map.tile_index_of(p[:, :2]) == [gx, gy]).all(), "[save_map] tile"
        res.update(map_points=len(pts), map_tiles=len(tiles), save_map_ms=map_ms,
                   map_keyframes=len(fig8_slam.keyframes))
    log("[resume+map] " + json.dumps(res))
    return launches, res


# ------------------------------------------------------- phase 15: the CLI
CLI_SIM = dict(duration=10.0, seed=7)  # each bag: a 10 s simulator run
CLI_M2DGR = os.path.join("configs", "mapping", "config_M2DGR.yaml")
CLI_TURING_MAPPING = os.path.join("configs", "mapping", "config_turing_icp.yaml")
CLI_TURING_LOCALIZATION = os.path.join("configs", "localization", "config_turing_icp.yaml")


def cli_bag(preset, points, path):
    """A bag written by the port's bag_export from a 10 s simulator run at
    `points` a scan under the preset's own topics, then read back once
    apart from any run: (dataset, {bag write s, read s, preprocess ms a
    scan, points a scan before and after the filter})."""
    from funny_lidar_slam_torch.config import load_config
    from funny_lidar_slam_torch.io import bag_export, rosbag
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.pipeline.preprocess import range_and_jump_filter

    cfg = load_config(os.path.join(HERE, preset))
    ds = simulate(SimConfig(points_per_scan=points, **CLI_SIM))
    t = time.perf_counter()
    bag_export.dataset_to_bag(ds, path, lidar_topic=cfg.lidar_topic, imu_topic=cfg.imu_topic)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    scans = [ev[1] for ev in rosbag.read_bag(path, cfg.lidar_topic, cfg.imu_topic,
                                             cfg.lidar_model.lidar_type,
                                             cfg.lidar_point_time_scale, cfg.lidar_model)
             if ev[0] == "scan"]
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    kept = [range_and_jump_filter(s, cfg.lidar_use_min_distance, cfg.lidar_use_max_distance,
                                  cfg.lidar_point_jump_span) for s in scans]
    pre_ms = (time.perf_counter() - t) * 1e3 / len(scans)
    assert len(scans) == len(ds.scans), f"[cli] {len(scans)} of {len(ds.scans)} scans read"
    return ds, {"bag_mb": os.path.getsize(path) / 1e6, "bag_write_s": write_s,
                "bag_read_s": read_s, "preprocess_ms_per_scan": pre_ms,
                "points_per_scan": float(np.mean([len(s.points) for s in ds.scans])),
                "points_per_scan_read": float(np.mean([len(s.points) for s in scans])),
                "points_per_scan_kept": float(np.mean([len(s.points) for s in kept]))}


def cli_run(torch, tag, ds, out_dir, argv):
    """One in-process `run_slam.main(argv)` with the launch counts zeroed
    just before and read just after, under tests/test_bag_path.py's gates
    (>= 40 frames, every TUM stamp within 0.06 s of a truth stamp, ATE
    < 0.3 m against the nearest-stamp truth) and fused_select launched
    (each preset's matcher gathers through it)."""
    from funny_lidar_slam_torch.io.trajectory import ate_rmse, read_tum, rpe_rmse
    from funny_lidar_slam_torch.ops import select
    from funny_lidar_slam_torch.pipeline import run_slam

    zero_counts()
    t = time.perf_counter()
    summary, runner = run_slam.main(argv + ["--output", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = select.fused_select.launches
    loop_counts = loop_launches(tag, runner.stats, runner.frontend)

    times, poses = read_tum(os.path.join(out_dir, "trajectory_tum.txt"))
    idx = np.abs(ds.gt_times[None, :] - times[:, None]).argmin(1)
    stamp_err = float(np.abs(ds.gt_times[idx] - times).max())
    gt = ds.gt_poses[idx]
    res = {"frames": len(poses), "scans": len(ds.scans), "stamp_err_s": stamp_err,
           "ate_m": ate_rmse(poses, gt, align=True), "rpe_m": rpe_rmse(poses, gt),
           "steady_fps": steady_fps(runner.stats), "wall_s": wall,
           "fused_select_launches": launches, "loop_launches": loop_counts, "summary": summary}
    assert len(poses) >= 40, f"[{tag}] too few frames: {len(poses)}"
    assert np.isfinite(poses).all(), f"[{tag}] non-finite poses"
    assert stamp_err < 0.06, f"[{tag}] a TUM stamp is {stamp_err:.3f} s from the truth"
    assert res["ate_m"] < 0.3, f"[{tag}] ATE {res['ate_m']:.4f} m"
    check_launches(tag, launches, True, len(getattr(runner, "loop_results", ())))
    return runner, res


class FirstGather:
    """Records the first fused_select call of a run and the state of the
    PointToPlane match it belongs to, forwarding every call. While the probe
    is entered it stands as `select.fused_select`, so the wrapper counts its
    launches into the probe's `launches`."""

    def __init__(self, torch):
        from funny_lidar_slam_torch.ops import select
        from funny_lidar_slam_torch.registration import matchers

        self.torch, self.select, self.cls = torch, select, matchers.PointToPlaneMatcher
        self.call, self.state, self.launches = None, None, 0

    def __call__(self, *a, **kw):
        if self.call is None:
            self.call = (tuple(x.clone() if self.torch.is_tensor(x) else x for x in a),
                         {"stencil": kw["stencil"], "qvox": kw["qvox"].clone()})
        return self.orig_sel(*a, **kw)

    def __enter__(self):
        self.orig_sel, self.orig_match = self.select.fused_select, self.cls.match
        probe = self

        def match(matcher, s, *args):
            if probe.state is None:
                probe.state = (s, matcher.inv)
            return probe.orig_match(matcher, s, *args)

        self.select.fused_select, self.cls.match = self, match
        return self

    def __exit__(self, *exc):
        self.select.fused_select, self.cls.match = self.orig_sel, self.orig_match


def cli_select(torch, probe) -> dict:
    """fused_select at the CLI's first gather (M2DGR's IVOX planar queries):
    parity at its K and at K=1, K=1 against brute force over the map's
    stored points, timed in turns with its bound and torch.topk."""
    from funny_lidar_slam_torch.ops import select

    (wnd, gid, qs, k, plane), kw = probe.call
    state, inv = probe.state
    inputs, stencil = (wnd, gid, qs, kw["qvox"]), kw["stencil"]
    out_k, out_p, qs_np = run_both(torch, select, inputs, k, stencil, plane)
    max_err = assert_parity(out_k, out_p, qs_np)
    out_k, out_p, qs_np = run_both(torch, select, inputs, 1, stencil, plane)
    max_err = max(max_err, assert_parity(out_k, out_p, qs_np))
    checked = brute_force_k1(out_k[0], inputs, stored_points(state.m), inv, stencil,
                             max(1, qs.shape[0] // 2000))
    assert checked > 0, "[cli-select] no row had a neighbour"
    t = select_timing(torch, select, inputs, k, stencil, plane)
    log(f"[cli-select] m2dgr_ivox_planar N={t['n']} Gp={t['gp']} K={k} {stencil} rows_read="
        f"{t['rows_read']}: parity ok, K=1 vs brute force ok ({checked} rows); kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, topk {t['library_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); kernel {t['vs_library']} than "
        f"topk; turns {t['turns']}")
    return {"max_abs_err": max_err, "shapes": {"m2dgr_ivox_planar": t},
            "brute_force_rows": checked}


def phase_cli(torch):
    """Phase 15: the port's CLI (`run_slam.main`) on three unmodified presets,
    each over a bag the port's bag_export wrote from a 10 s simulator run
    (seed 7) at the preset LiDAR's points a scan: 15a M2DGR mapping
    (PointToPlane_IVOX, tight coupling, 57,600 points), with fused_select
    held at its first gather; 15b Turing ICP mapping (the "None" LiDAR
    model, loose coupling, 28,800 points) with a split map; 15c Turing ICP
    localization on 15b's tiles from the identity. 15a runs a second time,
    untimed, to keep its device-loop inputs for phase 19, and 15b its GN
    inputs for phase 20."""
    import tempfile

    from funny_lidar_slam_torch.maps import split_map
    from funny_lidar_slam_torch.pipeline import run_slam

    by_path, paths = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        bag = os.path.join(tmp, "m2dgr.bag")
        ds, io_a = cli_bag(CLI_M2DGR, 32 * 1800, bag)
        out_a = os.path.join(tmp, "m2dgr")
        argv = ["--config", os.path.join(HERE, CLI_M2DGR), "--dataset", bag, "--save-map"]
        with FirstGather(torch) as probe:  # the run's launches count
            _, res = cli_run(torch, "cli_m2dgr", ds, out_a, argv)
        with LoopCapture("m2dgr"):  # a second, untimed run: phase 19's inputs
            run_slam.main(argv + ["--output", os.path.join(tmp, "m2dgr_capture")])
        torch.cuda.synchronize()
        for product in ("map/map.pcd", "pose_graph.g2o"):
            assert os.path.exists(os.path.join(out_a, product)), f"[cli_m2dgr] no {product}"
        by_path["cli_m2dgr"] = res["fused_select_launches"]
        paths["cli_m2dgr"] = {**res, **io_a}
        select_res = cli_select(torch, probe)

        bag = os.path.join(tmp, "turing.bag")
        ds, io_b = cli_bag(CLI_TURING_MAPPING, 16 * 1800, bag)
        out_b = os.path.join(tmp, "turing_mapping")
        argv = ["--config", os.path.join(HERE, CLI_TURING_MAPPING), "--dataset", bag]
        _, res = cli_run(torch, "cli_turing_mapping", ds, out_b,
                         argv + ["--save-map", "--split-map"])
        with LoopCapture("turing", loops=False):  # untimed again: phase 20's GN inputs
            run_slam.main(argv + ["--output", os.path.join(tmp, "turing_capture")])
        torch.cuda.synchronize()
        tiles = split_map.load_tile_indices(os.path.join(out_b, "map"))
        assert tiles, "[cli_turing_mapping] no tiles written"
        assert os.path.exists(os.path.join(out_b, "pose_graph.g2o")), \
            "[cli_turing_mapping] no pose_graph.g2o"
        res["map_tiles"] = len(tiles)
        by_path["cli_turing_mapping"] = res["fused_select_launches"]
        paths["cli_turing_mapping"] = {**res, **io_b}

        out_c = os.path.join(tmp, "turing_localization")
        _, res = cli_run(torch, "cli_turing_localization", ds, out_c, [
            "--config", os.path.join(HERE, CLI_TURING_LOCALIZATION), "--dataset", bag,
            "--map-dir", os.path.join(out_b, "map"),
            "--init-pose", *[str(v) for v in np.eye(4).ravel()]])
        assert res["summary"]["initialized"] is True, "[cli_turing_localization] no init"
        by_path["cli_turing_localization"] = res["fused_select_launches"]
        paths["cli_turing_localization"] = res
    for tag, res in paths.items():
        log(f"[{tag}] " + json.dumps(res))
    log(f"[cli] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return by_path, paths, select_res


# ------------------------------------------------ phase 16: multi-device
def sharded_select(torch, tag, capture) -> dict:
    """fused_select at one rank's first gather of the sharded GN step (all
    N = Gp queries of the replicated scan over the rank's region+halo map):
    parity with the plain version, K=1 against brute force over the rank's
    stored points, the all-miss cover-row share, timed in turns with its
    bound and torch.topk."""
    from funny_lidar_slam_torch.maps.block_map import BlockMap
    from funny_lidar_slam_torch.ops import select

    c = torch.load(capture)
    inputs = tuple(c[key].cuda() for key in ("wnd", "gid", "qs", "qvox"))
    k, plane, stencil = c["k"], c["plane"], c["stencil"]
    out_k, out_p, qs_np = run_both(torch, select, inputs, k, stencil, plane)
    max_err = assert_parity(out_k, out_p, qs_np)
    stored = stored_points(BlockMap(**c["map"]))
    checked = brute_force_k1(out_k[0], inputs, stored, 1.0, stencil,
                             max(1, qs_np.shape[0] // 2000))
    assert checked > 0, f"[{tag}] no row had a neighbour"
    rows = int(torch.unique(inputs[1]).numel())
    miss = int((inputs[0][:rows] >= 1e29).all(1).sum())
    t = select_timing(torch, select, inputs, k, stencil, plane)
    t.update(all_miss_rows=miss, cover_rows=rows, brute_force_rows=checked,
             map_points=len(stored))
    log(f"[{tag}-select] N={t['n']} Gp={t['gp']} K={k} {stencil} rows_read={rows} "
        f"({miss} all-miss, {miss / rows:.3f}): parity ok, K=1 vs brute force ok ({checked} "
        f"rows over {len(stored)} stored points); kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, topk {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}); kernel {t['vs_library']} than topk; turns {t['turns']}")
    return {"max_abs_err": max_err, "shape": t}


def log_ranks(tag, results):
    for r in results:
        sm, icp, pg = r["sharded_map"], r["icp"], r["pose_graph"]
        log(f"[{tag}] rank {r['rank']}/{r['size']} {r['backend']} on {r['device']}: occupancy "
            f"{sm['occupancy']} (replicated build {sm['replicated_blocks']} blocks), load "
            f"{sm['load_factor']:.4f}, insert ms {[round(x, 3) for x in sm['insert_ms']]}, GN "
            f"step {sm['gn_ms']:.2f} ms, error {sm['t_err_m']:.6f} m, fused_select "
            f"{sm['launches']}; ICP build {icp['build_ms']:.2f} ms, step {icp['ms']:.2f} ms, "
            f"error {icp['t_err_m']:.6f} m, load {icp['load_factor']:.4f}; pose graph "
            f"{pg['keyframes']} keyframes / {pg['edges']} edges, {pg['ms']:.1f} ms, max error "
            f"{pg['max_err_m']:.4f} m, CG iterations {pg['cg_iters']}, idle share of one GN "
            f"iteration (64 CG) {pg.get('idle_share_1gn')}; all_reduce of 6K f32 "
            f"{r['allreduce_ms']:.4f} ms; the dry run's map: occupancy "
            f"{r['sharded_map_parity']['occupancy']}, GN error "
            f"{r['sharded_map_parity']['t_err_m']:.6f} m")


def phase_multidevice(torch):
    """Phase 16: the multi-device workloads of `parallel/dryrun.py` at the
    simulator's size (the 1,000-keyframe pose graph, the region-sharded map
    of make_world(seed=7) and the sharded ICP step over one displaced
    16,384-point scan): 16a one NCCL rank in this process (FileStore),
    16b four gloo ranks on CUDA tensors in four worker processes on this
    card; gates of the JAX dry run, and fused_select at each run's first
    sharded gather."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from funny_lidar_slam_torch.parallel import comm, dryrun

    t_phase = time.perf_counter()
    data, parity = dryrun.scene_data("sim"), dryrun.scene_data("dryrun")
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        t = time.perf_counter()
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            one = [dryrun.run_workloads(comm.make_mesh(), data, profile=True,
                                        capture=os.path.join(tmp, "gather1.pt"), parity=parity)]
        finally:
            dist.destroy_process_group()
        one_s = time.perf_counter() - t
        s1 = dryrun.check(one)
        log_ranks("multidevice-1rank", one)
        t = time.perf_counter()
        # no profile here: a gloo all_reduce of a CUDA tensor takes ~7 ms among
        # four processes on one card, and the solve makes ~8,200 of them
        four = dryrun.spawn(4, "gloo", "cuda", data, tmp, timeout=600,
                            capture=os.path.join(tmp, "gather4.pt"), parity=parity)
        four_s = time.perf_counter() - t
        s4 = dryrun.check(four)
        log_ranks("multidevice-4rank", four)
        diff, pdiff = (float(np.abs(np.asarray(four[0][w]["pose"])
                                    - np.asarray(one[0][w]["pose"])).max())
                       for w in ("sharded_map", "sharded_map_parity"))
        log(f"[multidevice] sharded GN pose, 4 ranks against 1: max |diff| {pdiff:.3e} on the "
            f"JAX dry run's map, {diff:.3e} on the simulator's world")
        assert pdiff < 1e-4, f"[multidevice] the 4-rank pose is {pdiff:.3e} from the 1-rank one"
        if diff >= 1e-4:  # the parity boundary of parallel/sharded_map.py (ROADMAP Queue 3)
            log("[multidevice] on the simulator's world, voxels hold more points than the "
                "bucket, and which of them a rank keeps depends on its halo mask")
        sel = {"sharded_gn_1rank_k1": sharded_select(torch, "multidevice-1rank",
                                                     os.path.join(tmp, "gather1.pt")),
               "sharded_gn_4rank_k1": sharded_select(torch, "multidevice-4rank",
                                                     os.path.join(tmp, "gather4.pt"))}
    by_path = {"sharded_map_gn_1rank": one[0]["sharded_map"]["launches"],
               "sharded_map_gn_4rank": sum(r["sharded_map"]["launches"] for r in four),
               "sharded_icp_1rank": one[0]["icp"]["launches"],
               "sharded_icp_4rank": sum(r["icp"]["launches"] for r in four),
               "pose_graph_pcg_1rank": one[0]["pose_graph"]["launches"],
               "pose_graph_pcg_4rank": sum(r["pose_graph"]["launches"] for r in four)}
    res = {"1rank": {**s1, "wall_s": one_s}, "4rank": {**s4, "wall_s": four_s},
           "pose_4rank_vs_1rank": diff, "pose_4rank_vs_1rank_dryrun_map": pdiff,
           "nccl_allreduce_ms": one[0]["allreduce_ms"],
           "gloo_allreduce_ms": [r["allreduce_ms"] for r in four]}
    log("[multidevice] " + json.dumps(res))
    log(f"[multidevice] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return by_path, res, sel


def step_inputs(slam, ds, scan):
    """One scan's f32 inputs for both feeds: the padded scan, the ref time,
    the two IMU segments cast to f32, and the packed buffer of the same
    values."""
    from funny_lidar_slam_torch.core.state import ImuSegment
    from funny_lidar_slam_torch.pipeline.system import pad_scan

    period = ds.scans[1].t - ds.scans[0].t
    end, seg_cap = scan.t + period, slam.cfg.imu_segment_capacity
    segs = [slam.imu.get_segment(t0, end, seg_cap) for t0 in (scan.t, slam._last_scan_end)]
    assert all(g is not None for g in segs), "[unpacked-step] the IMU does not cover the scan"
    segs = [ImuSegment(*(np.asarray(a, np.float32) for a in g[:4]), mask=g.mask) for g in segs]
    rel = scan.rel_times - period
    pts, rts, mask = pad_scan(scan.points, rel, slam.cfg.scan_capacity)
    buf = slam.frontend.pack_frame(scan.points, rel, slam.cfg.scan_capacity, end, *segs)
    return end, (pts, rts, mask, end, *segs), buf


UNPACKED_WARM_SCANS, UNPACKED_STEPS = 24, 8  # phase 17a: scans run, then compared


def phase_unpacked_step(torch, ds):
    """Phase 17a: `Frontend.step` (one host->device copy an array) against
    `step_packed` (one copy of the packed frame) on phase 4's grid config:
    after UNPACKED_WARM_SCANS scans, UNPACKED_STEPS scans each fed to both
    from the same state with the same f32 inputs; gates: pose within 1e-4 m
    and 1e-4 rad, the same `converged`, equal fused_select launches. The
    packed result advances the run. Then both are timed over those scans in turns
    (packed, unpacked, unpacked, packed; twice) with a synchronized host
    clock, the first scan runs on each under torch.profiler, and
    fused_select is held against its plain version and brute force at the
    unpacked step's first gather."""
    from funny_lidar_slam_torch.core.lie import chord_angle
    from funny_lidar_slam_torch.ops import gn_loop, recurrences, select
    from funny_lidar_slam_torch.registration import gn

    slam = grid_system()
    slam.run_dataset(ds, max_scans=UNPACKED_WARM_SCANS)
    assert sum(1 for st in slam.stats if not st.get("init")) >= 8, "[unpacked-step] not steady"
    fe, cap = slam.frontend, slam.cfg.scan_capacity
    seg_cap = slam.cfg.imu_segment_capacity
    period = ds.scans[1].t - ds.scans[0].t
    imu_idx = int(np.searchsorted(ds.imu_t, ds.scans[UNPACKED_WARM_SCANS - 1].t + period + 0.05,
                                  side="right"))
    cases, diffs, launches = [], [], {"packed": 0, "unpacked": 0}
    loop_counts = {"packed": {}, "unpacked": {}}
    gn_counts = {"packed": 0, "unpacked": 0}
    for scan in ds.scans[UNPACKED_WARM_SCANS:UNPACKED_WARM_SCANS + UNPACKED_STEPS]:
        end = scan.t + period
        while imu_idx < len(ds.imu_t) and ds.imu_t[imu_idx] <= end + 0.05:
            slam.push_imu(ds.imu_t[imu_idx], ds.imu_gyro[imu_idx], ds.imu_accel[imu_idx])
            imu_idx += 1
        end, args, buf = step_inputs(slam, ds, scan)
        state = (slam.mstate, slam.fstate)
        outs = {}
        for kind, run in (("packed", lambda: fe.step_packed(*state, buf, cap, seg_cap)),
                          ("unpacked", lambda: fe.step(*state, *args))):
            zero_counts()
            outs[kind] = run()
            torch.cuda.synchronize()
            launches[kind] += select.fused_select.launches
            assert gn_loop.icp_gn_rounds.launches == gn.run_gn_icp_cand.rounds > 0, \
                f"[unpacked-step] {kind}: icp_gn_rounds launched " \
                f"{gn_loop.icp_gn_rounds.launches} times in {gn.run_gn_icp_cand.rounds} rounds"
            gn_counts[kind] += gn_loop.icp_gn_rounds.launches
            for fn in recurrences.KERNELS:
                loop_counts[kind][fn.__name__] = (loop_counts[kind].get(fn.__name__, 0)
                                                  + fn.launches)
        (ms, fs, op), (_, _, ou) = outs["packed"], outs["unpacked"]
        pp, pu = (o.pose.cpu().numpy().astype(np.float64) for o in (op, ou))
        assert bool(op.converged) == bool(ou.converged), "[unpacked-step] converged differs"
        diffs.append((float(np.linalg.norm(pp[:3, 3] - pu[:3, 3])), float(chord_angle(pp, pu))))
        assert diffs[-1][0] < 1e-4 and diffs[-1][1] < 1e-4, f"[unpacked-step] {diffs[-1]}"
        cases.append((state, args, buf))
        slam.mstate, slam.fstate, slam._last_scan_end = ms, fs, end
    assert launches["packed"] == launches["unpacked"] > 0, f"[unpacked-step] {launches}"
    one_a_step = {"preintegrate": len(cases), "eskf_predict": 0, "tight_fuse": len(cases)}
    assert loop_counts["packed"] == loop_counts["unpacked"] == one_a_step, \
        f"[unpacked-step] {loop_counts}"
    LOOP_LAUNCHES["frontend_step_unpacked"] = loop_counts["unpacked"]
    assert gn_counts["packed"] == gn_counts["unpacked"], f"[unpacked-step] {gn_counts}"
    GN_LAUNCHES["frontend_step_unpacked"] = gn_counts["unpacked"]
    GN_LAUNCHES_BY_KERNEL["frontend_step_unpacked"] = {
        "icp_gn_rounds": gn_counts["unpacked"], "plane_gn_rounds": 0, "loam_gn_rounds": 0}

    def feed(kind, cases=cases):
        for state, args, buf in cases:
            if kind == "packed":
                fe.step_packed(*state, buf, cap, seg_cap)
            else:
                fe.step(*state, *args)

    def host_ms(fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / len(cases)

    before = select.fused_select.launches
    turns = in_turns(host_ms, {kind: (lambda kind=kind: feed(kind)) for kind in launches},
                     ["packed", "unpacked", "unpacked", "packed"] * 2)
    # where the feeds differ: the first scan on each under the profiler
    # (which slows a step of ~10,000 launches several times over)
    calls = {kind: runtime_calls(torch, lambda kind=kind: feed(kind, cases[:1]))
             for kind in launches}
    select.fused_select.launches = before  # timing launches do not count

    # fused_select at the unpacked step's first gather (from the first case)
    state, args, _ = cases[0]
    with FirstGather(torch) as probe:
        fe.step(*state, *args)
        torch.cuda.synchronize()
    (wnd, gid, qs, k, plane), kw = probe.call
    inputs, stencil = (wnd, gid, qs, kw["qvox"]), kw["stencil"]
    max_err = 0.0
    for kk in (k, 1):
        out_k, out_p, qs_np = run_both(torch, select, inputs, kk, stencil, plane)
        max_err = max(max_err, assert_parity(out_k, out_p, qs_np))
    checked = brute_force_k1(out_k[0], inputs, stored_points(state[0].m), 1.0, stencil,
                             max(1, qs.shape[0] // 2000))
    assert checked > 0, "[unpacked-step] no row had a neighbour"
    t = select_timing(torch, select, inputs, k, stencil, plane)
    med = {kind: float(np.median(v)) for kind, v in turns.items()}
    res = {"steps": len(cases), "warm_scans": UNPACKED_WARM_SCANS,
           "pose_max_diff_m": max(d[0] for d in diffs),
           "rot_max_diff_rad": max(d[1] for d in diffs),
           "launches_packed": launches["packed"], "launches_unpacked": launches["unpacked"],
           "packed_ms_per_scan": med["packed"], "unpacked_ms_per_scan": med["unpacked"],
           "unpacked_minus_packed_ms": med["unpacked"] - med["packed"],
           "unpacked_vs_packed": versus(turns["unpacked"], turns["packed"]), "turns_ms": turns,
           "profiled_scan": calls, "fused_select_launches": launches["unpacked"],
           "gn_kernel_launches": gn_counts}
    for name, key in (("launch_calls", "cudaLaunchKernel"), ("copy_calls", "cudaMemcpyAsync"),
                      ("sync_calls", "cudaStreamSynchronize")):
        res[name] = {kind: c["runtime"].get(key, {}).get("count", 0) for kind, c in calls.items()}
    log("[unpacked-step] " + json.dumps(res))
    log(f"[unpacked-step] grid_first_gather N={t['n']} Gp={t['gp']} K={k} {stencil} "
        f"rows_read={t['rows_read']}: parity ok, K=1 vs brute force ok ({checked} rows); "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, topk {t['library_ms']:.4f} "
        f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); turns {t['turns']}")
    return res, {"max_abs_err": max_err, "shapes": {"unpacked_step_first_gather": t},
                 "brute_force_rows": checked}


def phase_profile_frontend(torch):
    """Phase 17b: tools/profile_torch_frontend.py's `profile` in process at
    its full configuration, counted as one path; its report on one line."""
    import importlib.util

    from funny_lidar_slam_torch.ops import recurrences, select

    spec = importlib.util.spec_from_file_location(
        "profile_torch_frontend", os.path.join(HERE, "tools", "profile_torch_frontend.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    zero_counts()
    t = time.perf_counter()
    report = tool.profile(log=lambda *a: log("[profile-frontend]", *a))
    wall = time.perf_counter() - t
    launches = select.fused_select.launches
    check_launches("profile-frontend", launches, True)
    loop_counts = {fn.__name__: fn.launches for fn in recurrences.KERNELS}
    assert loop_counts["preintegrate"] > 0 and loop_counts["tight_fuse"] > 0, \
        f"[profile-frontend] {loop_counts}"
    LOOP_LAUNCHES["profile_frontend"] = loop_counts
    gn_launches("profile-frontend", "icp_gn_rounds", host_loops=True)
    log(f"[profile-frontend] the host-loop GN ran {HOST_LOOP_CALLS['run_gn_corr']} times "
        f"(the tool's gn_uncached_direct stage)")
    ms = report["ms"]
    assert set(tool.CALLS) | {"full_step", "live_frame_wall"} <= set(ms), sorted(ms)
    assert all(np.isfinite(v) and v > 0 for v in ms.values()), ms
    assert report["fused_select_launches"]["full_step"] > 0, report["fused_select_launches"]
    log("[profile-frontend] " + json.dumps(report))
    return launches, {"wall_s": wall, "fused_select_launches": launches,
                      "full_step_ms": ms["full_step"],
                      "step_packed_device_ms": ms["step_packed_device"],
                      "est_fps_full_step": report["est_fps_full_step"]}


def phase_bench(torch):
    """Phase 18: `python3 bench_torch.py` as its own process with
    BENCH_BUDGET_S=0 (bench.py's knob: the headline runs once, the other six
    sections go to `skipped`); its last stdout line parsed and gated: rc 0,
    no `partial`, no `error`, the headline's frames >= 100 of the 14 s run,
    ATE < 0.10 m, an RPE, fps > 0, fused_select launched (counted by the
    bench around its run), and the device named as this card."""
    t = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py")], cwd=HERE,
                         env=dict(os.environ, BENCH_BUDGET_S="0"), capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t
    for x in out.stderr.strip().splitlines()[-20:]:
        log(f"[bench] {x}")
    assert out.returncode == 0, f"[bench] rc {out.returncode}"
    text = out.stdout.strip().splitlines()[-1]
    log(f"[bench] {text}")
    line = json.loads(text)
    assert "partial" not in line, line["partial"]
    assert all("error" not in r for r in line["per_mode"].values()), line["per_mode"]
    assert line["skipped"] == list(bench.MODES[1:]) + ["Localization", "Figure8_Loop"], \
        line["skipped"]
    head = line["per_mode"]["IcpOptimized"]
    assert head["frames"] >= 100, f"[bench] {head['frames']} frames"
    assert head["ate_m"] < 0.10, f"[bench] ATE {head['ate_m']} m"
    assert head["rpe_m"] >= 0 and head["fps"] > 0 and line["value"] == head["fps"], head
    check_launches("bench", head["fused_select_launches"], True, None)
    assert line["device"] == torch.cuda.get_device_name(0), line["device"]
    log(f"[bench] phase 18 took {wall:.1f} s")
    return head["fused_select_launches"], {
        **{k: head[k] for k in ("fps", "ate_m", "rpe_m", "frames", "excluded_deltas")},
        "bench_wall_s": line["bench_wall_s"], "wall_s": wall,
        "fused_select_launches": head["fused_select_launches"]}


# ------------------------------------------------ phase 19: device loops
LOOP_SOURCES = {
    "preintegrate": ("funny_lidar_slam_torch/csrc/imu_scan.cu",
                     "funny_lidar_slam_tpu/imu/preintegration.py:185"),
    "eskf_predict": ("funny_lidar_slam_torch/csrc/imu_scan.cu",
                     "funny_lidar_slam_tpu/fusion/eskf.py:100"),
    "tight_fuse": ("funny_lidar_slam_torch/csrc/tight_fuse.cu",
                   "funny_lidar_slam_tpu/fusion/tight.py:293"),
}
# kSweeps of tight_fuse.cu: an eigensolve that rotated in every sweep stopped unconverged
TIGHT_SWEEPS = 12
LOOP_SYMBOLS = {"preintegrate": ("imu_scan", "preintegrate_kernel"),
                "eskf_predict": ("imu_scan", "eskf_predict_kernel"),
                "tight_fuse": ("tight_fuse", "tight_fuse_kernel")}
# the shapes timed: the bench's (phase 4 grid and phase 11 KF, 16 slots,
# 12 LM iterations) and M2DGR's (64 slots, 20 iterations); eskf_predict also
# on the 64-slot segment of `loop_edge_cases` with every slot valid
LOOP_TIMED = {"preintegrate": ("grid", "m2dgr"), "eskf_predict": ("kf", "all_valid_64"),
              "tight_fuse": ("grid", "m2dgr")}
# besides: tight_fuse at the grid call with the LM iteration budget cut to
# 0 (set-up, posterior, marginalization and projection alone) and to 1
LOOP_TIMED_ITERATIONS = (0, 1)
# the loop kernels that keep their chains in registers: ptxas may report no spills
LOOP_NO_SPILLS = ("preintegrate", "eskf_predict", "tight_fuse")


def valid_slots(seg) -> int:
    """Slots of a segment that move the state (both samples valid, dt > 0)."""
    t = seg.t.float()
    ok = seg.mask[1:] & seg.mask[:-1] & (t[1:] > t[:-1])
    return int(ok.sum())


def loop_entry(kind):
    """(the entry point a step calls, its plain version) of a device loop."""
    from funny_lidar_slam_torch.fusion import eskf, tight
    from funny_lidar_slam_torch.imu import preintegration as pi

    return {"preintegrate": (pi.preintegrate, pi.preintegrate_plain),
            "eskf_predict": (eskf.predict, eskf.predict_plain),
            "tight_fuse": (tight.fuse, tight.fuse_plain)}[kind]


def synthetic_segment(torch, device, slots, seed, mask=None, t=None):
    """A float32 IMU segment on `device`: stamps 5 ms apart from 5.0 s (or
    `t`), gyro N(0, 0.4) rad/s, accel (0.3, -0.2, 9.81) + N(0, 0.3) m/s^2
    from a NumPy generator of `seed`, every sample valid (or `mask`)."""
    from funny_lidar_slam_torch.core.state import ImuSegment

    rng = np.random.default_rng(seed)
    t = (5.0 + np.arange(slots) * 0.005).astype(np.float32) if t is None else t
    mask = np.ones(slots, bool) if mask is None else mask
    arrays = (t, rng.normal(0, 0.4, (slots, 3)).astype(np.float32),
              (np.array([0.3, -0.2, 9.81]) + rng.normal(0, 0.3, (slots, 3))).astype(np.float32),
              np.tile(np.array([1, 0, 0, 0], np.float32), (slots, 1)))
    return ImuSegment(*(torch.as_tensor(a, device=device) for a in arrays),
                      mask=torch.as_tensor(mask, device=device))


def with_iterations(fuse_args, n):
    """A tight fuse call's arguments with the LM iteration budget `n`."""
    return fuse_args[:5] + (fuse_args[5]._replace(iterations=n),)


def loop_edge_cases(torch, pre_args, fuse_args, eskf_args) -> list:
    """[(name, (kind, args))]: the synthetic edge cases of the loop
    kernels, with the noise, biases, fusion inputs and ESKF state of the
    captured calls `pre_args` (preintegrate), `fuse_args` (tight fuse) and
    `eskf_args` (eskf.predict), on their device: `preintegrate` and
    `eskf_predict` each over 16 slots with every sample masked, with one
    valid slot, with slots of dt <= 0 (a repeated and a decreasing stamp)
    between valid ones, a second segment chained on the state of a first
    (preintegrate's has_init; the plain version's state, the same for
    both), and 64 slots all valid; `tight_fuse` at 0 LM iterations (set-up
    and the tail alone) and at 1."""
    from funny_lidar_slam_torch.fusion import eskf
    from funny_lidar_slam_torch.imu import preintegration as pi

    _, params, bg, ba = pre_args[:4]
    state, _, eparams, gravity = eskf_args
    dev, n = bg.device, 16
    one = np.zeros(n, bool)
    one[5:7] = True
    t_bad = (5.0 + np.arange(n) * 0.005).astype(np.float32)
    t_bad[6] = t_bad[5]  # dt = 0 in slot 5
    t_bad[9] = t_bad[8] - np.float32(0.002)  # dt < 0 in slot 8
    first = synthetic_segment(torch, dev, n, 41)
    second = synthetic_segment(torch, dev, n, 42, t=(5.0 + (n + np.arange(n)) * 0.005
                                                     ).astype(np.float32))
    init = pi.preintegrate_plain(first, params, bg, ba)
    segments = {"all_masked": synthetic_segment(torch, dev, n, 43, mask=np.zeros(n, bool)),
                "one_valid_slot": synthetic_segment(torch, dev, n, 44, mask=one),
                "nonpositive_dt": synthetic_segment(torch, dev, n, 45, t=t_bad),
                "chained": second,
                "all_valid_64": synthetic_segment(torch, dev, 64, 46)}

    cases = []
    for name, seg in segments.items():
        extra = (init,) if name == "chained" else ()
        cases.append((f"preintegrate_{name}", ("preintegrate", (seg, params, bg, ba, *extra))))
    for name, seg in segments.items():
        s = eskf.predict_plain(state, first, eparams, gravity) if name == "chained" else state
        cases.append((f"eskf_predict_{name}", ("eskf_predict", (s, seg, eparams, gravity))))
    return cases + [
        ("tight_fuse_it0", ("tight_fuse", with_iterations(fuse_args, 0))),
        ("tight_fuse_it1", ("tight_fuse", with_iterations(fuse_args, 1))),
    ]


# (residual rows, state columns its Jacobian blocks touch) of the six
# factors of fusion/tight.py: the prior, lidar rotation, lidar position,
# preintegration, the gyro and accel bias random walks
TIGHT_FACTORS = ((15, 15), (3, 3), (3, 3), (9, 24), (3, 6), (3, 6))


def tight_ops(iterations) -> int:
    """Operations `fuse_plain` needs for `iterations` LM iterations, counted
    from the reference's steps (not the kernel's): the 9x9 preintegration
    information (2 n^3); an assembly at the start, one an iteration and one
    at the optimum, each ~1,400 for the residuals and their 3x3 Jacobian
    blocks plus, a factor of m rows over c columns, lam J (2 m^2 c), one
    triangle of J^T lam J (m c (c+1)), lam e, b and the cost; an iteration's
    Jacobi scaling, 30x30 LU (2 n^3 / 3), two triangular solves and trial
    state; the tail's two 15x15 eigendecompositions (9 n^3 each), the
    pseudo-inverse and the PSD projection (one triangle of V w V^T each),
    h_km pinv (2 n^3) and its product with h_mk (one triangle)."""
    assembly = 1_400 + sum(2 * m * m * c + m * c * (c + 1) + 2 * m * m + 2 * m * c + 2 * m
                           for m, c in TIGHT_FACTORS)
    n, k = 30, 15
    solve = 2 * n * n + 2 * n ** 3 // 3 + 2 * n * n + 4 * n + 300
    tail = 2 * 9 * k ** 3 + 3 * k * k * (k + 1) + 2 * k ** 3 + 3 * k * k
    return 2 * 9 ** 3 + (iterations + 2) * assembly + iterations * solve + tail


# the operations of one ESKF slot that moves the state, by F's blocks
# (csrc/imu_scan.cu, part 4; a 3x3 product is 27 multiplies and 18 adds):
# F cov, then (F cov) F^T, each a block row (column) of five at a time:
# block 0 rs^T X and -dt X (45 + 18), block 1 A X + X + B X (2 x 45 + 18),
# block 2 dt X + X (18), blocks 3-4 copies; + Q dt (12 multiplies, 12 adds)
MM3 = 45
ESKF_COV_OPS = 2 * 5 * ((MM3 + 18) + (2 * MM3 + 18) + 18) + 24
# F's blocks: hat(acc) dt (6), -r hat(acc) dt (45), -r dt (9); the mean:
# r acc + g (18), r rs (45), v and p (24); the slot's inputs: midpoints
# less the biases (18), w dt (3), dt (1), Exp (~40)
ESKF_SLOT_OPS = ESKF_COV_OPS + (6 + MM3 + 9) + (18 + MM3 + 24) + (18 + 3 + 1 + 40)


def loop_cost(kind, args, iterations) -> tuple:
    """(bytes, operations) the call needs: its packed inputs read once and
    its outputs written once; the operations of the slots that move the
    state (preintegrate: A cov A^T, B Sigma B^T and the 3x3 updates, ~4,900
    a slot; ESKF: F cov F^T by F's nonzero blocks and the mean,
    ESKF_SLOT_OPS) or of the reference's LM iterations and tail
    (`tight_ops`)."""
    from funny_lidar_slam_torch.ops import recurrences as rec

    if kind == "preintegrate":
        seg, _, _, _ = args[:4]
        s = seg.t.shape[0]
        return (15 + 8 * s + rec._size(rec.PREINT_STATE)) * 4, valid_slots(seg) * 4_900
    if kind == "eskf_predict":
        s = args[1].t.shape[0]
        return (258 + 8 * s + rec._size(rec.ESKF_OUT)) * 4, valid_slots(args[1]) * ESKF_SLOT_OPS
    return (425 + rec._size(rec.TIGHT_OUT)) * 4, tight_ops(iterations)


def fuse_plain_counted(args) -> tuple:
    """(`fuse_plain(*args)`, the LM iterations it ran): each iteration
    applies its step once."""
    from funny_lidar_slam_torch.fusion import tight

    n, orig = [0], tight._apply_dx

    def counted(s, dx):
        n[0] += 1
        return orig(s, dx)

    tight._apply_dx = counted
    try:
        return tight.fuse_plain(*args), n[0]
    finally:
        tight._apply_dx = orig


def loop_compare(torch, kind, args) -> dict:
    """The kernel against its plain version on one captured call: the
    errors the gates read (absolute on the states, relative to the
    largest entry on covariances, Jacobians and the information)."""
    from funny_lidar_slam_torch.core.lie import chord_angle
    from funny_lidar_slam_torch.fusion import eskf, tight
    from funny_lidar_slam_torch.imu import preintegration as pi
    from funny_lidar_slam_torch.ops import recurrences as rec

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def ab(a, b):
        return float((a - b).abs().max())

    if kind == "preintegrate":
        k, p = pi.preintegrate(*args), pi.preintegrate_plain(*args)
        out = {"abs": max(ab(getattr(k, f), getattr(p, f)) for f in ("d_r", "d_v", "d_p", "dt")),
               "rel": max(rel(getattr(k, f), getattr(p, f))
                          for f in ("cov", "dr_dbg", "dv_dbg", "dv_dba", "dp_dbg", "dp_dba"))}
        out["ok"] = out["abs"] < 1e-5 and out["rel"] < 1e-4
        return out
    if kind == "eskf_predict":
        k, p = eskf.predict(*args), eskf.predict_plain(*args)
        out = {"abs": max(ab(getattr(k.nav, f), getattr(p.nav, f)) for f in ("r", "v", "p")),
               "rel": rel(k.cov, p.cov)}
        out["ok"] = out["abs"] < 1e-5 and out["rel"] < 1e-4
        return out
    r, v, pos, bg, ba, info, its, sweeps = rec.tight_fuse(*args)
    ref, n = fuse_plain_counted(args)
    out = {"dp": ab(pos, ref.p), "da": float(chord_angle(r, ref.r)), "dv": ab(v, ref.v),
           "dbg": ab(bg, ref.bg), "dba": ab(ba, ref.ba),
           "abs": max(ab(a, b) for a, b in ((r, ref.r), (v, ref.v), (pos, ref.p),
                                            (bg, ref.bg), (ba, ref.ba))),
           "rel": rel(info, ref.info), "iterations": int(its), "plain_iterations": n,
           "sweeps": [int(x) for x in sweeps.tolist()]}
    # v, bg and ba are the next step's prior and preintegration biases: held
    # at 1e-3 (m/s, rad/s, m/s^2), and at 1e-4 for a close call
    out["ok"] = (out["dp"] < 2e-3 and out["da"] < 2e-3 and out["rel"] < 1e-2
                 and max(out["dv"], out["dbg"], out["dba"]) < 1e-3
                 and max(out["sweeps"]) < TIGHT_SWEEPS)
    out["close"] = (out["dp"] < 1e-4 and out["da"] < 1e-5 and int(its) == n
                    and max(out["dv"], out["dbg"], out["dba"]) < 1e-4)
    return out


def phase_device_loops(torch, report) -> list:
    """Phase 19: the three device-loop kernels against their plain versions
    on every call captured from phase 4's grid run, phase 11's KF run and
    15a's M2DGR run, and on the synthetic edge cases of `loop_edge_cases`;
    the launches of every path; the ptxas report (no spills in preintegrate
    and tight_fuse); each kernel timed beside its plain version and one
    empty launch at the bench's and M2DGR's shapes, in turns, with its
    bound, and tight_fuse also at 0 and 1 LM iterations; the three entry
    points under torch.cuda.set_sync_debug_mode("error"). Returns the three
    JSON entries."""
    from funny_lidar_slam_torch.fusion import eskf, tight
    from funny_lidar_slam_torch.imu import preintegration as pi
    from funny_lidar_slam_torch.ops import recurrences as rec

    t_phase = time.perf_counter()
    for kind in LOOP_NO_SPILLS:
        lib, sym = LOOP_SYMBOLS[kind]
        res = report.get(lib, {}).get(sym)
        assert res and res["registers"], f"[device-loops] no ptxas report for {sym}: {res}"
        assert res["spill_stores"] == 0 and res["spill_loads"] == 0, \
            f"[device-loops] {sym} spills: {res}"
    saved = {fn.__name__: fn.launches for fn in rec.KERNELS}  # comparisons do not count
    pre_args = next(a for k, a in LOOP_CAPTURES["grid"] if k == "preintegrate")
    fuse_args = next(a for k, a in LOOP_CAPTURES["grid"] if k == "tight_fuse")
    kf_args = next(a for k, a in LOOP_CAPTURES["kf"] if k == "eskf_predict")
    edge, edge_args = {}, {}
    for name, (kind, args) in loop_edge_cases(torch, pre_args, fuse_args, kf_args):
        edge_args[name] = args
        edge[name] = loop_compare(torch, kind, args)
        assert edge[name]["ok"], f"[device-loops] edge case {name}: {edge[name]}"
    log(f"[device-loops] {len(edge)} edge cases within tolerance: {json.dumps(edge)}")
    results: dict = {}
    for key, calls in LOOP_CAPTURES.items():
        seen = {}
        for kind, args in calls:
            seen[kind] = seen.get(kind, 0) + 1
            results.setdefault(kind, {}).setdefault(key, []).append(
                loop_compare(torch, kind, args))
        launched = {k: v for k, v in LOOP_CAPTURE_LAUNCHES[key].items() if v}
        assert launched == seen, f"[device-loops] {key}: captured {seen}, launched {launched}"
    torch.cuda.synchronize()
    for kind, by_key in results.items():
        for key, rows in by_key.items():
            bad = [i for i, r in enumerate(rows) if not r["ok"]]
            assert not bad, f"[device-loops] {kind} {key}: calls {bad} out of tolerance: " \
                f"{[rows[i] for i in bad[:3]]}"
            summary = {f: [float(np.quantile([r[f] for r in rows], q)) for q in (0.5, 0.95, 1)]
                       for f in rows[0] if f not in ("ok", "close", "iterations",
                                                     "plain_iterations", "sweeps")}
            if kind == "tight_fuse":
                close = sum(r["close"] for r in rows) / len(rows)
                same_its = sum(r["iterations"] == r["plain_iterations"] for r in rows) / len(rows)
                summary.update(close_share=close, same_iterations_share=same_its,
                               iterations=[r["iterations"] for r in rows],
                               jacobi_sweeps_max=max(max(r["sweeps"]) for r in rows),
                               jacobi_sweeps=[r["sweeps"] for r in rows])
                assert close >= 0.95, f"[device-loops] tight_fuse {key}: {close:.3f} close"
            log(f"[device-loops] {kind} {key}: {len(rows)} calls within tolerance; "
                f"median / p95 / max {json.dumps(summary)}")

    # the three entry points on device inputs may not wait for the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pi.preintegrate(*pre_args)
        eskf.predict(*kf_args)
        tight.fuse(*fuse_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[device-loops] preintegrate, eskf.predict and tight.fuse ran under "
        "set_sync_debug_mode('error')")

    order = ["kernel", "plain", "floor", "floor", "plain", "kernel"]
    entries = []
    for kind, keys in LOOP_TIMED.items():
        kernel, plain = loop_entry(kind)
        shapes = {}
        timed = [(key, edge_args[f"{kind}_{key}"] if key == "all_valid_64"
                  else [a for k, a in LOOP_CAPTURES[key] if k == kind][-1]) for key in keys]
        if kind == "tight_fuse":
            timed += [(f"{keys[0]}_it{n}", with_iterations(timed[0][1], n))
                      for n in LOOP_TIMED_ITERATIONS]
        for key, args in timed:
            reps = {"kernel": 50, "plain": 3, "floor": 50}
            turns = in_turns(lambda f: time_ms(torch, f[0], f[1]),
                             {"kernel": (lambda: kernel(*args), reps["kernel"]),
                              "plain": (lambda: plain(*args), reps["plain"]),
                              "floor": (lambda: torch.cuda._sleep(0), reps["floor"])}, order)
            ms = {c: float(np.median(v)) for c, v in turns.items()}
            its = int(rec.tight_fuse(*args)[6]) if kind == "tight_fuse" else 0
            nbytes, ops = loop_cost(kind, args, its)
            bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            slots = (args[0] if kind == "preintegrate" else args[1]).t.shape[0] \
                if kind != "tight_fuse" else None
            shapes[key] = {"ms": ms["kernel"], "plain_ms": ms["plain"], "floor_ms": ms["floor"],
                           "bound_ms": max(bound_bytes, bound_ops),
                           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
                           "bytes": nbytes, "ops": ops, "slots": slots,
                           "lm_iterations": its if kind == "tight_fuse" else None,
                           "turns": turns, "vs_plain": versus(turns["kernel"], turns["plain"])}
            log(f"[device-loops] {kind} at the {key} shape (slots {slots}, LM iterations "
                f"{its if kind == 'tight_fuse' else '-'}): kernel {ms['kernel']:.4f} ms, plain "
                f"{ms['plain']:.2f} ms, empty launch {ms['floor']:.5f} ms, bound "
                f"{shapes[key]['bound_ms']:.6f} ms ({shapes[key]['bound_by']}); turns {turns}")
        lib, sym = LOOP_SYMBOLS[kind]
        resources = report.get(lib, {}).get(sym, {})
        log(f"[device-loops] {kind} ptxas: {resources}")
        rows = [r for by_key in results[kind].values() for r in by_key]
        rows += [e for n, e in edge.items() if n.startswith(kind)]
        first = shapes[keys[0]]
        entries.append({
            "name": kind, "route": "cuda", "source": LOOP_SOURCES[kind][0],
            "replaces": LOOP_SOURCES[kind][1],
            "launches": sum(v[kind] for v in LOOP_LAUNCHES.values()),
            "max_abs_err": max(r["abs"] for r in rows),
            "max_rel_err_cov_or_info": max(r["rel"] for r in rows),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None, "floor_ms": first["floor_ms"],
            "shape": keys[0], "shapes": shapes, "calls_compared": len(rows),
            "edge_cases": {n: e for n, e in edge.items() if n.startswith(kind)},
            "launches_by_path": {p: v[kind] for p, v in LOOP_LAUNCHES.items() if v[kind]},
            "resources": resources})
    for fn in rec.KERNELS:
        fn.launches = saved[fn.__name__]
    log(f"[device-loops] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# ----------------------------------------- phase 20: the ICP GN loop kernel
GN_SOURCE = ("funny_lidar_slam_torch/csrc/gn_loop.cu", "funny_lidar_slam_tpu/registration/gn.py:232")
GN_SAME_SHARE = 0.95  # calls with the plain version's status, iterations and gathers


# each GN kernel's candidate sets in its arguments (after the carry)
GN_SETS = {"icp_gn_rounds": 1, "plane_gn_rounds": 1, "loam_gn_rounds": 2}


def gn_cost(args, iterations, kind="icp_gn_rounds") -> tuple:
    """(bytes, operations, bytes read by the kernel) of one call: each input
    read once (px, py, pz [N, M] f32, valid [N, M] u8, src [N, 3] f32 of
    each set, the carry and radius) and the carry written once. Operations
    an iteration: ICP ~9 a lane (d2, the compare) and ~80 a row (J, J^T J,
    J^T r, |r|); LOAM ~10 a lane (d2, the five-slot insertion) and, on each
    row with five valid lanes, ~250 for a plane row (A^T A, the adjugate,
    five residuals, J J^T) or ~500 for a line row (the covariance, the
    closed-form eigenvalues, 12 power steps, J J^T). The kernel itself
    reads the candidates once an iteration: the third number."""
    from funny_lidar_slam_torch.ops import gn_loop

    sets = args[1:1 + GN_SETS[kind]]
    once = sum(c.px.shape[0] * c.px.shape[1] * 13 + c.px.shape[0] * 12 for c in sets)
    nbytes = once + 4 * (2 * gn_loop.CARRY_SIZE + 1)
    if kind == "icp_gn_rounds":
        n, m = sets[0].px.shape
        ops = n * m * 9 + n * 80
    else:
        row_ops = (250,) if kind == "plane_gn_rounds" else (500, 250)  # corner set first
        ops = sum(c.px.numel() * 10 + int((c.valid.sum(1) >= 5).sum()) * k
                  for c, k in zip(sets, row_ops))
    return nbytes, iterations * ops, iterations * once


GN_POSE_TOL = (1e-4, 1e-5)  # m, rad (chord)


def pose_diff(a, b) -> tuple:
    """(largest translation difference, chord angle) of two poses."""
    from funny_lidar_slam_torch.core.lie import chord_angle

    return float((a.double() - b.double())[:3, 3].abs().max()), float(chord_angle(a, b))


def gn_compare(torch, args, kind="icp_gn_rounds") -> dict:
    """A GN kernel (`kind`) against its plain version on one captured call,
    each from its own copy of the carry. The pose is held to the plain
    version's; where the two part by more than GN_POSE_TOL, it is held to a
    float64 run of the plain version on the same call instead (`dp64`,
    `da64`): the float32 normal equations (condition ~1e3) leave the plain
    version itself up to ~1e-4 m from the float64 pose. For the LOAM and
    NDT kernels that run (float64 sums, `float64_sums`) also holds
    num_valid and the residual sum, and its status, iterations and gathers
    count as the plain version's (`same`) where the float32 run's differ.
    Where the kernel's counters are the plain version's but its end parts
    from both runs, each of its iterations is held to one plain iteration
    from the same pose instead (`stepwise_compare`, the same tolerances)."""
    from funny_lidar_slam_torch.ops import gn_loop

    kernel, plain = getattr(gn_loop, kind), getattr(gn_loop, f"{kind}_plain")
    carry = args[0]
    ck, cp = carry.clone(), carry.clone()
    kernel(ck, *args[1:])
    plain(cp, *args[1:])
    o = gn_loop.OFFSET
    ik, ip = ck[o["it"]:].tolist(), cp[o["it"]:].tolist()
    vk, vp = gn_loop.result_views(ck), gn_loop.result_views(cp)
    names = ("status", "it", "gathers")
    out = {f: (ck[o[f]].item(), cp[o[f]].item()) for f in names}
    out["dp"], out["da"] = pose_diff(vk.t_mat, vp.t_mat)
    out.update(
        same=all(ck[o[f]].item() == cp[o[f]].item() for f in names),
        nv_rel=abs(int(vk.num_valid) - int(vp.num_valid)) / max(int(vp.num_valid), 1),
        res_rel=abs(float(vk.total_res) - float(vp.total_res))
        / max(abs(float(vp.total_res)), 1e-30),
        iterations=ik[0] - int(carry[o["it"]]), first=int(carry[o["it"]]) == 0,
        finite=bool(torch.isfinite(vk.t_mat).all()), carry_k=ik, carry_p=ip,
        t_k=vk.t_mat, t_p=vp.t_mat)
    pose_ok = out["dp"] < GN_POSE_TOL[0] and out["da"] < GN_POSE_TOL[1]
    if not pose_ok:  # the float64 reference of the same call
        c64 = carry.clone()
        if kind == "icp_gn_rounds":
            cand, radius = args[1], args[2]
            plain(c64, cand._replace(px=cand.px.double(), py=cand.py.double(),
                                     pz=cand.pz.double(), src=cand.src.double()),
                  radius.double(), *args[3:])
        else:  # float32 fits, float64 sums: an all-float64 run decides other gates
            with float64_sums():
                plain(c64, *args[1:])
        v64 = gn_loop.result_views(c64)
        out["dp64"], out["da64"] = pose_diff(vk.t_mat, v64.t_mat)
        out["plain_dp64"], out["plain_da64"] = pose_diff(vp.t_mat, v64.t_mat)
        pose_ok = out["dp64"] < GN_POSE_TOL[0] and out["da64"] < GN_POSE_TOL[1]
        if kind != "icp_gn_rounds":  # the counts and the residual sum held there too
            out["nv_rel"] = (abs(int(vk.num_valid) - int(v64.num_valid))
                             / max(int(v64.num_valid), 1))
            out["res_rel"] = (abs(float(vk.total_res) - float(v64.total_res))
                              / max(abs(float(v64.total_res)), 1e-30))
            # and the loop's counters: a threshold (the stall test) that the
            # float32 sums cross some iterations before the float64 ones
            # (a starved set's slow drift) ends the two plain runs apart
            out["counters64"] = [c64[o[f]].item() for f in names]
            out["same"] = out["same"] or all(ck[o[f]].item() == c64[o[f]].item()
                                             for f in names)
    out["close"] = pose_ok and out["nv_rel"] <= 0.01 and out["res_rel"] < 1e-3
    if out["same"] and not out["close"]:
        # one ulp of the pose after an iteration can flip a gate (a plane
        # fit, the near reject) at the next and move the call's end from
        # both plain runs by more than GN_POSE_TOL: such a call is held
        # iteration by iteration, each to one plain iteration from the pose
        # the kernel reached
        out["stepwise"] = stepwise_compare(torch, args, out, kind)
        out["close"] = out["stepwise"]["held"]
    return out


class float64_sums:
    """While active, the plain versions' scalar-row reductions
    (`residuals._reduce_scalar`: the point-to-plane and point-to-line rows'
    H, g and residual sum) and NDT's (`residuals._reduce_vec3`: each pair's
    J^T lam J, J^T lam e and e^T lam e) sum float32 terms in float64 and
    round the sums to float32, as the LOAM and NDT kernels do; the rows and
    each pair's terms stay float32. The reference for a LOAM or NDT call
    where the two float32 runs part: its plane fits and its NDT gates
    decide in float32 as the kernels' do."""

    def __enter__(self):
        import torch

        from funny_lidar_slam_torch.registration import residuals

        self.saved = residuals._reduce_scalar
        self.saved_vec3 = residuals._reduce_vec3

        def reduce_vec3_64(j, r, lam, valid):  # float32 terms a pair, float64 sums
            w = valid.to(j.dtype)
            lj = torch.einsum("nab,nbk->nak", lam, j) * w[:, None, None]
            h = (j[:, :, :, None] * lj[:, :, None, :]).sum(1)
            g = (lj * r[:, :, None]).sum(1)
            res = torch.einsum("na,nab,nb->n", r, lam, r) * w
            return residuals.HG(h.double().sum(0).float(), (-g.double().sum(0)).float(),
                                valid.sum(dtype=torch.int32), res.double().sum().float())

        residuals._reduce_vec3 = reduce_vec3_64

        def reduce64(j, r, valid):  # float32 products, float64 sums
            jw = j * valid.to(j.dtype)[:, None]
            return residuals.HG(
                (jw[:, :, None] * j[:, None, :]).double().sum(0).float(),
                (-(jw * r[:, None]).double().sum(0)).float(), valid.sum(dtype=torch.int32),
                (torch.abs(r) * valid.to(r.dtype)).double().sum().float())

        residuals._reduce_scalar = reduce64
        return self

    def __exit__(self, *exc):
        from funny_lidar_slam_torch.registration import residuals

        residuals._reduce_scalar = self.saved
        residuals._reduce_vec3 = self.saved_vec3


def gn_turns(torch, args, kind, extra=None) -> tuple:
    """A GN kernel (`kind`) timed on one captured call beside its plain
    version, the calls of `extra` ({name: (fn, reps)}) and one empty
    launch, in turns (kernel, plain, extra, floor, floor, extra reversed,
    plain, kernel), each kernel or plain call from its own copy of the
    carry: (the turns, the median ms of each)."""
    from funny_lidar_slam_torch.ops import gn_loop

    pools = {k: args[0].repeat(512, 1) for k in ("kernel", "plain")}
    used = {"kernel": 0, "plain": 0}
    fns = {"kernel": getattr(gn_loop, kind), "plain": getattr(gn_loop, f"{kind}_plain")}
    extra = extra or {}

    def call(which):
        carry = pools[which][used[which]]
        used[which] += 1
        return fns[which](carry, *args[1:])

    turns = in_turns(lambda f: time_ms(torch, f[0], f[1]),
                     {"kernel": (lambda: call("kernel"), 50), "plain": (lambda: call("plain"), 3),
                      "floor": (lambda: torch.cuda._sleep(0), 50), **extra},
                     ["kernel", "plain", *extra, "floor", "floor", *reversed(extra), "plain",
                      "kernel"])
    assert max(used.values()) <= 512, used
    return turns, {c: float(np.median(v)) for c, v in turns.items()}


def gn_timing(torch, args, label, kind="icp_gn_rounds") -> dict:
    """`gn_turns` with the call's bound."""
    turns, ms = gn_turns(torch, args, kind)
    n = [c.px.shape[0] for c in args[1:1 + GN_SETS[kind]]]
    n, m = (n[0] if len(n) == 1 else n), args[1].px.shape[1]
    its = gn_compare(torch, args, kind)["iterations"]
    nbytes, ops, reread = gn_cost(args, its, kind)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    out = {"ms": ms["kernel"], "plain_ms": ms["plain"], "floor_ms": ms["floor"],
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bound_ms_reading_each_iteration": reread / HBM_BYTES_PER_S * 1e3,
           "n": n, "m": m, "iterations": its, "bytes": nbytes, "ops": ops, "turns": turns,
           "vs_plain": versus(turns["kernel"], turns["plain"])}
    log(f"[gn-loop] {kind} at the {label} shape (N {n}, M {m}, {its} iterations): "
        f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.2f} ms, empty launch "
        f"{out['floor_ms']:.5f} ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']}; the "
        f"candidates read once an iteration: {out['bound_ms_reading_each_iteration']:.6f} "
        f"ms); turns {turns}")
    return out


# ------------------------------------------- the GN kernels' edge cases
def gn_with_cfg(args, **kw):
    """A GN call's arguments with its GNConfig's fields `kw` replaced."""
    i = next(k for k, a in enumerate(args) if hasattr(a, "max_iters"))
    return (*args[:i], args[i]._replace(**kw), *args[i + 1:])


def gn_with_sets(args, kind, fn):
    """A GN call's arguments with `fn` applied to each candidate set."""
    k = GN_SETS[kind]
    return (args[0], *(fn(c) for c in args[1:1 + k]), *args[1 + k:])


def gn_dead(torch, c):
    """The set with every lane invalid."""
    return c._replace(valid=torch.zeros_like(c.valid))


def gn_lanes12(c):
    """The set's first 12 lanes (the any-M kernels)."""
    return c._replace(**{f: getattr(c, f)[:, :12].contiguous()
                         for f in ("px", "py", "pz", "valid")})


def gn_rows(torch, c, n, among=None):
    """n rows spread evenly over the set (or over the rows `among` marks)."""
    pool = (torch.arange(c.px.shape[0], device=c.px.device) if among is None
            else torch.nonzero(among).flatten())
    idx = pool[torch.linspace(0, len(pool) - 1, n, device=c.px.device).round().long()]
    return c._replace(**{f: getattr(c, f).index_select(0, idx) for f in c._fields})


# the ICP edge case whose H is rank-deficient (every source point on one
# line: the rotation about it is unobservable), held as LOAM_RANK_DEFICIENT
# and to where its pose places the line (`line_points_diff`)
ICP_RANK_DEFICIENT = "icp_gn_rounds collinear sources"


def line_points_diff(src, t_a, t_b) -> float:
    """The largest distance between the source points placed by pose t_a
    and by t_b: ICP_RANK_DEFICIENT's observable part of their difference
    (a rotation about the line moves none of its points)."""
    placed = [src @ t[:3, :3].T + t[:3, 3] for t in (t_a, t_b)]
    return float((placed[0] - placed[1]).norm(dim=1).max())


def icp_edge_cases(torch, args) -> list:
    """[(name, args)] on a captured ICP first round (the headline call): a
    starved set (min_valid above its rows), every lane invalid, N 100 and N
    5,003 rows spread over the set (below one 256-row tile, and no multiple
    of a tile or of R), M 12 (the any-M kernel), max_iters 2, and
    ICP_RANK_DEFICIENT: 600 source points on a line through the set's
    first point, each with one valid lane 1 cm off its world point at the
    carry's pose."""
    from funny_lidar_slam_torch.ops import gn_loop

    kind, cand = "icp_gn_rounds", args[1]
    n = cand.px.shape[0]
    line = gn_rows(torch, cand, 600)
    t_mat = gn_loop.result_views(args[0]).t_mat
    steps = torch.linspace(-8.0, 8.0, 600, device=cand.src.device)[:, None]
    src = (line.src[:1] + steps * torch.tensor([0.8, 0.6, 0.0], device=cand.src.device)).contiguous()
    world = src @ t_mat[:3, :3].T + t_mat[:3, 3] + 0.01
    lane0 = torch.zeros_like(line.valid)
    lane0[:, 0] = True
    collinear = line._replace(
        src=src, valid=lane0,
        **{f: torch.where(lane0, world[:, k:k + 1], getattr(line, f)).contiguous()
           for k, f in enumerate(("px", "py", "pz"))})
    return [(f"{kind} starved", gn_with_cfg(args, min_valid=n + 1)),
            (f"{kind} every lane invalid", gn_with_sets(args, kind, lambda c: gn_dead(torch, c))),
            (f"{kind} N 100", (args[0], gn_rows(torch, cand, 100), *args[2:])),
            (f"{kind} N 5003", (args[0], gn_rows(torch, cand, 5003), *args[2:])),
            (f"{kind} M 12", gn_with_sets(args, kind, gn_lanes12)),
            (f"{kind} max_iters 2", gn_with_cfg(args, max_iters=2)),
            (ICP_RANK_DEFICIENT, (args[0], collinear, *args[2:]))]


def phase_gn_loop(torch, report) -> dict:
    """Phase 20: icp_gn_rounds (csrc/gn_loop.cu `icp_gn_kernel<16|0>`, one
    thread block cluster of R blocks a call) against its plain version on
    every call captured from untimed runs of phase 4 (grid), phase 11 (KF),
    phase 6 (ICP localization) and 15b (the Turing CLI); gates: the same
    status, iterations and gathers on >= 95 % of a path's calls, and on
    those the pose within 1e-4 m and 1e-5 rad (chord) of the plain version's
    or, where the two float32 poses part by more, of a float64 run of the
    plain version (`gn_compare`), num_valid within 1 %, total_res within
    1e-3 relative, or, where the end parts from both, each iteration so
    from the same pose (`stepwise_compare`); every call's pose finite and
    within 0.05 m; the launches
    while capturing equal to the calls captured; every captured first round
    launched twice with the same carry bit for bit (`bit_equal_replays`).
    R is printed (>= 8 for both variants) with the rows a rank (the
    launcher's own split, `gn_loop.rank_rows`); ptxas may report no spills
    in either variant. Then, on the headline call (a grid match's first
    round, N = 16,384, M = 16): the launch under
    set_sync_debug_mode("error"); the any-M kernel bit-equal to the M = 16
    one on misaligned planes; the edge cases of `icp_edge_cases` (the
    starved set, every lane invalid, N 100, N 5,003, M 12, max_iters 2) with
    the same gates, and ICP_RANK_DEFICIENT held to status, iterations,
    gathers and num_valid with a finite pose within 0.05 m that places the
    line's points within 1e-4 m of the plain version's; the kernel
    timed beside its plain version and one empty launch, with its bound,
    there and on the captured call with the most iterations. Returns the
    JSON entry."""
    from funny_lidar_slam_torch.ops import gn_loop

    t_phase = time.perf_counter()
    kind = "icp_gn_rounds"
    resources = {k: v for k, v in report.get("gn_loop", {}).items()
                 if k.startswith("icp_gn_kernel")}
    assert sorted(resources) == ["icp_gn_kernel<0>", "icp_gn_kernel<16>"], \
        f"[gn-loop] ptxas report {sorted(resources)}"
    for name, res in resources.items():
        assert res["registers"] and res["spill_stores"] == 0 and res["spill_loads"] == 0, \
            f"[gn-loop] {name} spills: {res}"
    blocks = gn_loop.cluster_blocks(kind)
    assert blocks >= 8 and gn_loop.cluster_blocks(kind, vec=False) >= 8, blocks
    log(f"[gn-loop] icp_gn_kernel launches one cluster of R = {blocks} blocks; ptxas {resources}")
    saved = gn_loop.icp_gn_rounds.launches  # comparisons do not count
    by_key, rows_all, replayed = {}, [], []
    for key, calls in GN_CAPTURES.items():
        if not calls:
            continue
        assert GN_CAPTURE_LAUNCHES[key] == len(calls), \
            f"[gn-loop] {key}: {len(calls)} calls captured, {GN_CAPTURE_LAUNCHES[key]} launched"
        rows = [gn_compare(torch, args) for args in calls]
        rows_all += rows
        replayed += [(key, args, r["iterations"]) for args, r in zip(calls, rows)]
        same = sum(r["same"] for r in rows) / len(rows)
        bad = [i for i, r in enumerate(rows) if (r["same"] and not r["close"])
               or not r["finite"] or r["dp"] > 0.05]
        matches = sum(r["first"] for r in rows)
        summary = {"calls": len(rows), "matches": matches, "same_share": same,
                   "held_to_float64": [{k: r[k] for k in ("dp", "da", "dp64", "da64",
                                                          "plain_dp64", "plain_da64")}
                                       for r in rows if "dp64" in r],
                   "held_step_by_step": [r["stepwise"] for r in rows if "stepwise" in r],
                   "iterations_per_match": sum(r["iterations"] for r in rows) / max(matches, 1),
                   "rounds_per_match": len(rows) / max(matches, 1),
                   **{f: [float(np.quantile([r[f] for r in rows], q)) for q in (0.5, 0.95, 1)]
                      for f in ("dp", "da", "nv_rel", "res_rel")},
                   "differing": [{k: r[k] for k in ("status", "it", "gathers", "dp", "da")}
                                 for r in rows if not r["same"]][:5]}
        # two launches on every first round: the same carry bit for bit
        summary["first_rounds_bit_equal"] = bit_equal_replays(
            torch, kind, [a for a, r in zip(calls, rows) if r["first"]])
        by_key[key] = summary
        log(f"[gn-loop] {key}: " + json.dumps(summary))
        assert not bad, f"[gn-loop] {key}: calls {bad} out of tolerance: " \
            f"{[rows[i] for i in bad[:3]]}"
        assert same >= GN_SAME_SHARE, f"[gn-loop] {key}: {same:.3f} of calls agree"
    assert "grid" in by_key, "[gn-loop] no grid call captured"

    # the headline shape: the first round of the last grid match
    args = [a for a in GN_CAPTURES["grid"] if int(a[0][gn_loop.OFFSET["it"]]) == 0][-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gn_loop.icp_gn_rounds(args[0].clone(), *args[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[gn-loop] icp_gn_rounds ran under set_sync_debug_mode('error')")
    # the any-M kernel (icp_gn_kernel<0>): the headline call with px 4 bytes
    # off its 16-byte alignment (the same arithmetic: bit-equal carries)
    carry, cand = args[0], args[1]
    px = torch.empty(cand.px.numel() + 1, dtype=cand.px.dtype, device=cand.px.device)
    px = px[1:].view(cand.px.shape).copy_(cand.px)
    c16, c0 = carry.clone(), carry.clone()
    gn_loop.icp_gn_rounds(c16, *args[1:])
    gn_loop.icp_gn_rounds(c0, cand._replace(px=px), *args[2:])
    assert torch.equal(c16, c0), "[gn-loop] the any-M kernel differs on misaligned planes"
    edge = {}
    for name, eargs in icp_edge_cases(torch, args):
        r = gn_compare(torch, eargs)
        edge[name] = {k: r[k] for k in ("status", "it", "gathers", "dp", "da", "nv_rel", "res_rel",
                                        "same", "close", "dp64", "da64", "stepwise") if k in r}
        edge[name]["rows"] = eargs[1].px.shape[0]
        held = r["close"]
        if name == ICP_RANK_DEFICIENT:  # the line's points stay put along H's null space
            edge[name]["dx_line"] = line_points_diff(eargs[1].src, r["t_k"], r["t_p"])
            held = (r["nv_rel"] <= 0.01 and r["dp"] <= 0.05
                    and edge[name]["dx_line"] < GN_POSE_TOL[0])
        assert r["same"] and held and r["finite"], f"[gn-loop] edge case {name}: {r}"
    log(f"[gn-loop] icp_gn_kernel<0> bit-equal to <16> on misaligned planes; {len(edge)} edge "
        f"cases within tolerance: {json.dumps(edge)}")
    n_rows = cand.px.shape[0]
    split = gn_loop.rank_rows(n_rows, blocks)
    assert sum(split) == n_rows, f"[gn-loop] the ranks take {split} of {n_rows} rows"
    log(f"[gn-loop] {n_rows} rows over R = {blocks} ranks: {split}")
    head = gn_timing(torch, args, "headline")
    # and the captured call that ran the most iterations
    key, args, _ = max(replayed, key=lambda r: r[2])
    most = gn_timing(torch, args, f"most iterations ({key})")
    for shape in (head, most):
        shape["ms_per_iteration"] = shape["ms"] / max(shape["iterations"], 1)
    gn_loop.icp_gn_rounds.launches = saved
    log(f"[gn-loop] phase 20 took {time.perf_counter() - t_phase:.1f} s")
    close = [r for r in rows_all if r["same"]]
    held64 = [r for r in rows_all if "dp64" in r]
    return {"name": kind, "route": "cuda", "source": GN_SOURCE[0],
            "replaces": GN_SOURCE[1],
            "launches": sum(v[kind] for v in GN_LAUNCHES_BY_KERNEL.values()),
            "max_abs_err": max(r["dp"] for r in close),
            "max_rot_err_rad": max(r["da"] for r in close),
            "held_to_float64": len(held64),
            "max_abs_err_vs_float64_where_held": max((r["dp64"] for r in held64), default=None),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")},
            "library_ms": None, "shapes": {"headline": head, "most_iterations": most},
            "launches_by_path": {p: v[kind] for p, v in GN_LAUNCHES_BY_KERNEL.items() if v[kind]},
            "calls_compared": len(rows_all), "by_path": by_key, "edge_cases": edge,
            "cluster_blocks": blocks,
            "rows_per_rank": {"rows": n_rows, "max": max(split), "min": min(split)},
            "resources": resources}


# --------------------------------- phase 21: the LOAM matchers' GN loop kernels
LOAM_GN_PATHS = {  # capture key -> the GN kernel its matcher's driver launches
    **{m: "loam_gn_rounds" if m.startswith("LoamFull") else "plane_gn_rounds"
       for m in bench.LOAM_MODES},
    **{f"localization {m}": "loam_gn_rounds" if m.startswith("LoamFull")
       else "plane_gn_rounds" for m in bench.LOAM_MODES},
    "m2dgr": "plane_gn_rounds"}


def first_rounds(calls, kind):
    """The captured calls of `kind` that start a match (the carry's it 0)."""
    from funny_lidar_slam_torch.ops import gn_loop

    return [a for k, a in calls if k == kind and int(a[0][gn_loop.OFFSET["it"]]) == 0]


# an edge case whose H is rank-deficient (100 rows spread over IVOX's whole
# set, of which 0-11 pass their plane fit): the damped float32 solve leaves
# each step along H's near-null directions to rounding, the next
# iteration's plane fits follow the pose, and over a call's 10 iterations
# the kernel and the plain version, like the plain version and its
# float64-sums run, can end 0.3 m and several rows apart (PERF.md, section 6).
# So the whole call is held to its status, iterations and gathers and a
# finite pose, and each of its iterations to one plain iteration from the
# same pose (`stepwise_compare`), the pose within the whole call's former
# 0.05 m: a step on such an H is itself decided to a few mm by rounding
LOAM_RANK_DEFICIENT = "plane_gn_rounds N 100 over the set"
RANK_DEFICIENT_STEP_TOL = (0.05, float("inf"))


# the starved edge cases (min_valid above the rows): only the stall test can
# end such a call, and it compares successive step norms with stall_eps, so
# the iteration it ends on, and with it the pose, is decided by rounding
# once the norms drift within a few ulps of stall_eps: the kernel and both
# plain runs (float32 and float64 sums) can end tens of iterations apart
# (PERF.md, section 6). So the whole call is held to its status and a
# finite pose, and each iteration, from the pose and step norms the
# kernel's previous one left, to one plain iteration (`stepwise_compare`
# with `stall`): pose, num_valid and total_res within phase 20's
# tolerances, the step norms within STALL_NORM_TOL, every stall decision
# the plain step's except where the plain step's |rn - last_rot| or |pn -
# last_pos| lies within STALL_NORM_TOL of stall_eps, the chain bit-equal to
# the whole call, and its first stall on the call's last iteration
# (`starved_compare`)
LOAM_STARVED = ("plane_gn_rounds starved", "loam_gn_rounds starved")
# rad and m: ~30x the largest step-norm difference seen over 8,881 starved
# steps (PERF.md, section 6), 1 % of stall_eps (1e-4)
STALL_NORM_TOL = 1e-6


def stepwise_compare(torch, args, r, kind, tol=GN_POSE_TOL, stall=False) -> dict:
    """A GN kernel's call on `args` (`r`: its `gn_compare`) taken one
    iteration at a time: from the carry's pose and then from the pose each
    one-iteration kernel call (max_iters 1) leaves, one kernel iteration
    beside one plain iteration. Returns the worst step's num_valid and
    residual-sum differences (relative) and pose difference, whether the
    chain of the call's iterations ends on its pose bit for bit (a step
    depends on the pose alone), and whether the steps are held: within 1 %,
    1e-3 and `tol` (m, rad), the chain bit-equal.

    With `stall`, each step also starts from the step norms (last_rot,
    last_pos) that the kernel's last exact step left, so that its stall
    test decides as the whole call's iteration did. A step is exact, as in
    the loop, where it is the call's first (its gather) or the pose it
    starts from lies inside the trust region of the call's first pose
    (`trust_region_moved`); only exact steps test for a stall and leave
    their norms. On exact steps the kernel's and the plain step's norms
    (`norm_diff`, held to STALL_NORM_TOL) and stall decisions are compared:
    a decision may part (`decisions_parted`) only where the plain step's
    |rn - last_rot| or |pn - last_pos| lies within STALL_NORM_TOL of
    stall_eps, or, on a step with min_valid rows, its rn or pn within
    STALL_NORM_TOL of rotation_eps or position_eps, where one rounding can
    flip it (`decisions_off_band` counts the others, and must be 0). The
    chain's first stop (`first_stall`: done, by the stall test or, with
    enough rows, by convergence) must fall on the call's last iteration
    where the call ended done, and nowhere where it did not."""
    from funny_lidar_slam_torch.ops import gn_loop

    kernel, plain = getattr(gn_loop, kind), getattr(gn_loop, f"{kind}_plain")
    one = gn_with_cfg(args, max_iters=1)
    o = gn_loop.OFFSET
    at = slice(o["t_mat"], o["t_mat"] + 16)
    norms = slice(o["last_rot"], o["last_pos"] + 1)
    carry = args[0].clone()
    worst = {"nv_rel": 0.0, "res_rel": 0.0, "dp": 0.0, "da": 0.0}
    norm_diff, parted, off_band, first_stall = [0.0, 0.0], 0, 0, None
    i_cfg = next(k for k, a in enumerate(args) if hasattr(a, "max_iters"))
    radius, cfg = args[i_cfg - 1], args[i_cfg]  # the radius comes just before the config
    t_gather = gn_loop.result_views(args[0]).t_mat.clone()
    for k in range(r["iterations"]):
        exact = k == 0 or cfg.skip_regather_dist <= 0.0 or not bool(gn_loop.trust_region_moved(
            gn_loop.result_views(carry).t_mat, t_gather, radius, cfg.skip_regather_dist))
        ck, cp = carry.clone(), carry.clone()
        kernel(ck, *one[1:])
        plain(cp, *one[1:])
        vk, vp = gn_loop.result_views(ck), gn_loop.result_views(cp)
        dp, da = pose_diff(vk.t_mat, vp.t_mat)
        step = {"nv_rel": abs(int(vk.num_valid) - int(vp.num_valid)) / max(int(vp.num_valid), 1),
                "res_rel": abs(float(vk.total_res) - float(vp.total_res))
                / max(abs(float(vp.total_res)), 1e-30), "dp": dp, "da": da}
        worst = {k: v if step[k] <= v else step[k] for k, v in worst.items()}  # NaN stays
        if stall and exact:
            last, pk, pp = (c.view(torch.float32)[norms].double() for c in (carry, ck, cp))
            rot_pos = (pk - pp).abs().tolist()
            norm_diff = [v if d <= v else d for v, d in zip(norm_diff, rot_pos)]  # NaN stays
            stop_k, stop_p = bool(ck[o["done"]]), bool(cp[o["done"]])
            if stop_k != stop_p:  # excused only where the plain step's test is on its edge
                parted += 1
                edge = ((pp - last).abs() - cfg.stall_eps).abs() <= STALL_NORM_TOL
                # or, with enough valid rows, where its convergence test is
                eps = torch.tensor([cfg.rotation_eps, cfg.position_eps], dtype=pp.dtype,
                                   device=pp.device)
                conv_edge = (int(vp.num_valid) >= cfg.min_valid
                             and bool(((pp - eps).abs() <= STALL_NORM_TOL).any()))
                off_band += not ((cfg.use_stall_check and bool(edge.any())) or conv_edge)
            if stop_k and first_stall is None:
                first_stall = k + 1
            carry[norms] = ck[norms]
        carry[at] = ck[at]
    chain = torch.equal(gn_loop.result_views(carry).t_mat, r["t_k"])
    held = (chain and worst["nv_rel"] <= 0.01 and worst["res_rel"] < 1e-3
            and worst["dp"] < tol[0] and worst["da"] < tol[1])
    out = {**worst, "steps": r["iterations"], "chain_bit_equal": chain, "held": held}
    if stall:
        # the call ended on its stall test: done and not converged; the chain
        # stops first (done, by the stall or the convergence test) on the
        # call's last iteration where the call ended done, nowhere else
        c = r["carry_k"]  # it, gathers, since, force, done, converged, ...
        on_stall = bool(c[4]) and not c[5]
        ends = first_stall == (r["iterations"] if c[4] else None)
        out.update(norm_diff=norm_diff, decisions_parted=parted, decisions_off_band=off_band,
                   first_stall=first_stall, ended_on_stall=on_stall, stall_end_held=ends)
        out["held"] = (held and ends and off_band == 0
                       and norm_diff[0] <= STALL_NORM_TOL and norm_diff[1] <= STALL_NORM_TOL)
    return out


def starved_compare(torch, args, r, kind) -> dict:
    """LOAM_STARVED's gate on a call (`r`: its `gn_compare`): the kernel's
    status the plain version's (or its float64-sums run's), a finite pose,
    and `stepwise_compare` with `stall` held."""
    step = stepwise_compare(torch, args, r, kind, stall=True)
    status = r["status"][0] in (r["status"][1], r.get("counters64", [None])[0])
    return {**step, "status_held": status, "held": step["held"] and status and r["finite"]}


def loam_edge_cases(torch, plane_args, loam_args) -> list:
    """[(name, kind, args)] on a captured first round of each kernel: a
    starved set (min_valid above its rows), every lane invalid, every row's
    first two lanes an exact duplicate (tied d2), a corner set of N 0 beside
    the full planar set, max_iters 2; and the any-M kernels (<false, 0>,
    <true, 0>) at M = 12."""
    with_cfg, with_sets, lanes12 = gn_with_cfg, gn_with_sets, gn_lanes12

    def dead(c):
        return gn_dead(torch, c)

    def rows(c, n, among=None):
        return gn_rows(torch, c, n, among)

    def tied(c):
        out = {f: getattr(c, f).clone() for f in ("px", "py", "pz", "valid")}
        for t in out.values():
            t[:, 1] = t[:, 0]
        return c._replace(**out)

    def fitted(args, c, thresh, max_d2):  # the rows whose plane fit passes at the carry's pose
        from funny_lidar_slam_torch.ops import gn_loop
        from funny_lidar_slam_torch.registration import residuals

        _, nbrs, d2, ok = residuals._select_knn(gn_loop.result_views(args[0]).t_mat, c, 5)
        return residuals.fit_plane_5nn(nbrs, ok & (d2 <= max_d2), thresh)[2]

    cases = []
    for kind, args in (("plane_gn_rounds", plane_args), ("loam_gn_rounds", loam_args)):
        n = sum(c.px.shape[0] for c in args[1:1 + GN_SETS[kind]])
        cases += [(f"{kind} starved", kind, with_cfg(args, min_valid=n + 1)),
                  (f"{kind} every lane invalid", kind, with_sets(args, kind, dead)),
                  (f"{kind} tied lanes", kind, with_sets(args, kind, tied)),
                  (f"{kind} max_iters 2", kind, with_cfg(args, max_iters=2)),
                  (f"{kind} M 12", kind, with_sets(args, kind, lanes12))]
    # the cluster's split: fewer rows than one block's threads, a row count
    # that is no multiple of a tile (256) or of R, more corner than planar
    # rows. The small planar subsets are drawn from the rows whose plane fit
    # passes at the carry's pose, so that the 6x6 system has full rank and
    # the pose gates apply; LOAM_RANK_DEFICIENT's case (100 rows spread over
    # IVOX's whole set, of which few pass) is held step by step
    corner, planar = loam_args[1], loam_args[2]
    fit_p = fitted(plane_args, plane_args[1], plane_args[4], plane_args[5])
    fit_l = fitted(loam_args, planar, loam_args[6], loam_args[7])
    cases += [("plane_gn_rounds N 100", "plane_gn_rounds",
               (plane_args[0], rows(plane_args[1], 100, fit_p), *plane_args[2:])),
              (LOAM_RANK_DEFICIENT, "plane_gn_rounds",
               (plane_args[0], rows(plane_args[1], 100), *plane_args[2:])),
              ("plane_gn_rounds N 5003", "plane_gn_rounds",
               (plane_args[0], rows(plane_args[1], 5003), *plane_args[2:])),
              ("loam_gn_rounds N 60 + 40", "loam_gn_rounds",
               (loam_args[0], rows(corner, 60), rows(planar, 40, fit_l), *loam_args[3:])),
              ("loam_gn_rounds corner rows above planar", "loam_gn_rounds",
               (loam_args[0], corner, rows(planar, corner.px.shape[0] // 4, fit_l),
                *loam_args[3:]))]
    cases.append(("loam_gn_rounds no corner rows", "loam_gn_rounds",
                  (loam_args[0], rows(corner, 0), *loam_args[2:])))
    return cases


def bit_equal_replays(torch, kind, calls) -> int:
    """Each call of `calls` launched twice from copies of its carry; raises
    unless the two carries agree bit for bit. Returns the calls checked."""
    from funny_lidar_slam_torch.ops import gn_loop

    fn = getattr(gn_loop, kind)
    for args in calls:
        a, b = args[0].clone(), args[0].clone()
        fn(a, *args[1:])
        fn(b, *args[1:])
        assert torch.equal(a, b), f"[gn] {kind}: two launches differ: {a.tolist()} {b.tolist()}"
    return len(calls)


def phase_loam_gn(torch, report) -> list:
    """Phase 21: plane_gn_rounds and loam_gn_rounds (csrc/gn_loop.cu
    `loam_gn_kernel<false|true, 16|0>`, the JAX `run_gn_corr` while_loop
    over the point-to-plane and LoamFull candidate sets, one launch a
    gather round) against their plain versions on every call captured in
    untimed runs beside phases 7-9 (mapping), 12a-c (localization) and 15a
    (the M2DGR preset), with phase 20's gates: the same status, iterations
    and gathers on >= 95 % of a path's calls, and there the pose within
    1e-4 m and 1e-5 rad of the plain version's, or, where the two float32
    runs part by more, of the plain version with float64 sums
    (`float64_sums`: the kernel's one deviation, its fits still float32),
    which then also decides num_valid (within 1 %), total_res (within 1e-3
    relative) and, where the float32 run's differ, the status, iterations
    and gathers (`gn_compare`), or, where the kernel's end parts from both
    runs, each of its iterations so from the same pose
    (`stepwise_compare`); every call's pose
    finite and within 0.05 m; the launches while capturing equal to the
    calls captured. Each kernel launches one thread block cluster of R
    blocks (printed; R >= 8 for every variant; the rows per rank from the
    launcher's own split, `gn_loop.rank_rows`) and runs twice on every
    captured first round with the same carry bit for bit. Then the
    synthetic edge cases (`loam_edge_cases`, the cluster's split among them:
    N 100, N 5,003, 60 corner + 40 planar rows, more corner than planar
    rows, the small planar subsets of rows whose fit passes; and
    LOAM_RANK_DEFICIENT, held to status, iterations, gathers and a finite
    pose, and each iteration, from the pose the kernel's previous one left,
    to one plain iteration: num_valid within 1 %, total_res within 1e-3
    relative, the pose within 0.05 m, and the chain of one-iteration calls
    on the whole call's pose bit for bit; LOAM_STARVED, held to its status
    and a finite pose, and each iteration as LOAM_RANK_DEFICIENT's, with
    phase 20's pose tolerance, from the step norms the kernel's previous one
    left too, its stall test's norms within STALL_NORM_TOL, its stall
    decisions the plain step's off the test's edge, and the chain's first
    stall on the call's last iteration), the LoamFull
    kernel with no corner rows bit-equal to the plane kernel, the
    any-M kernels bit-equal to the M = 16 ones on misaligned planes, each
    wrapper under set_sync_debug_mode("error"), no ptxas spills in any GN
    kernel, and each kernel timed beside its plain version and one empty
    launch at the bench's planar shape (PointToPlane_IVOX's first round) and
    LoamFull's (corner + planar), and at the captured call with the most
    iterations. Returns the two JSON entries."""
    from funny_lidar_slam_torch.ops import gn_loop

    t_phase = time.perf_counter()
    blocks = {kind: gn_loop.cluster_blocks(kind) for kind in LOAM_GN_KERNELS}
    for kind, r in blocks.items():  # the any-M kernel's cluster too
        assert r >= 8 and gn_loop.cluster_blocks(kind, vec=False) >= 8
    log(f"[loam-gn] loam_gn_kernel launches one cluster of R blocks: R = "
        f"{blocks['plane_gn_rounds']} (plane), {blocks['loam_gn_rounds']} (LoamFull)")
    resources = {k: v for k, v in report.get("gn_loop", {}).items()
                 if k.startswith(("icp_gn_kernel", "loam_gn_kernel"))}
    assert len(resources) == 6, f"[loam-gn] ptxas report {sorted(resources)}"
    for name, res in resources.items():
        assert res["registers"] and res["spill_stores"] == 0 and res["spill_loads"] == 0, \
            f"[loam-gn] {name} spills: {res}"
    saved = {k: getattr(gn_loop, k).launches for k in LOAM_GN_KERNELS}  # comparisons do not count
    by_kernel = {k: {} for k in LOAM_GN_KERNELS}
    rows_all = {k: [] for k in LOAM_GN_KERNELS}
    replayed = {k: [] for k in LOAM_GN_KERNELS}
    for key, kernel in LOAM_GN_PATHS.items():
        calls = LOAM_CAPTURES.get(key, [])
        launched = {k: v for k, v in LOAM_CAPTURE_LAUNCHES.get(key, {}).items() if v}
        assert launched == {kernel: len(calls)} and calls, \
            f"[loam-gn] {key}: {len(calls)} calls captured, launched {launched}"
        assert all(k == kernel for k, _ in calls), f"[loam-gn] {key}: another kernel ran"
        rows = [gn_compare(torch, args, kernel) for _, args in calls]
        rows_all[kernel] += rows
        replayed[kernel] += [(key, args, r["iterations"]) for (_, args), r in zip(calls, rows)]
        same = sum(r["same"] for r in rows) / len(rows)
        bad = [i for i, r in enumerate(rows) if (r["same"] and not r["close"])
               or not r["finite"] or r["dp"] > 0.05]
        matches = sum(r["first"] for r in rows)
        summary = {"kernel": kernel, "calls": len(rows), "matches": matches, "same_share": same,
                   "held_to_float64": sum("dp64" in r for r in rows),
                   "held_step_by_step": [r["stepwise"] for r in rows if "stepwise" in r],
                   "iterations_per_match": sum(r["iterations"] for r in rows) / max(matches, 1),
                   "rounds_per_match": len(rows) / max(matches, 1),
                   **{f: [float(np.quantile([r[f] for r in rows], q)) for q in (0.5, 0.95, 1)]
                      for f in ("dp", "da", "nv_rel", "res_rel")},
                   "differing": [{k: r[k] for k in ("status", "it", "gathers", "dp", "da")}
                                 for r in rows if not r["same"]][:5]}
        # two launches on every first round: the same carry bit for bit
        summary["first_rounds_bit_equal"] = bit_equal_replays(
            torch, kernel, [a for (_, a), r in zip(calls, rows) if r["first"]])
        by_kernel[kernel][key] = summary
        log(f"[loam-gn] {key}: " + json.dumps(summary))
        assert not bad, f"[loam-gn] {key}: calls {bad} out of tolerance: " \
            f"{[rows[i] for i in bad[:3]]}"
        assert same >= GN_SAME_SHARE, f"[loam-gn] {key}: {same:.3f} of calls agree"

    ivox = LOAM_CAPTURES[bench.LOAM_MODES[0]]
    full = LOAM_CAPTURES["LoamFull_KdTree"]
    plane_args = first_rounds(ivox, "plane_gn_rounds")[-1]
    loam_args = first_rounds(full, "loam_gn_rounds")[-1]
    edge = {}
    for name, kind, args in loam_edge_cases(torch, plane_args, loam_args):
        r = gn_compare(torch, args, kind)
        edge[name] = {k: r[k] for k in ("status", "it", "gathers", "dp", "da", "nv_rel", "res_rel",
                                        "same", "close", "dp64", "da64", "stepwise") if k in r}
        held, same = r["close"], r["same"]
        if name == LOAM_RANK_DEFICIENT:  # each step held, the whole call to its counters
            edge[name]["stepwise"] = stepwise_compare(torch, args, r, kind,
                                                      RANK_DEFICIENT_STEP_TOL)
            held = edge[name]["stepwise"]["held"]
        elif name in LOAM_STARVED:  # each step and its stall test held, the call to its status
            edge[name]["stepwise"] = starved_compare(torch, args, r, kind)
            held = same = edge[name]["stepwise"]["held"]
        assert same and held and r["finite"], f"[loam-gn] edge case {name}: {edge[name]}"
    # no corner rows: the LoamFull kernel gives the plane kernel's carry bit for bit
    _, kind, args = loam_edge_cases(torch, plane_args, loam_args)[-1]
    ca, cb = args[0].clone(), args[0].clone()
    gn_loop.loam_gn_rounds(ca, *args[1:])
    gn_loop.plane_gn_rounds(cb, *args[2:5], *args[6:])  # no line_ratio
    assert torch.equal(ca, cb), "[loam-gn] no corner rows: the two kernels differ"
    # the any-M kernels on misaligned planes: bit-equal to the M = 16 ones
    for kind, args in (("plane_gn_rounds", plane_args), ("loam_gn_rounds", loam_args)):
        k, fn = GN_SETS[kind], getattr(gn_loop, kind)
        sets = []
        for c in args[1:1 + k]:
            px = torch.empty(c.px.numel() + 1, dtype=c.px.dtype, device=c.px.device)
            sets.append(c._replace(px=px[1:].view(c.px.shape).copy_(c.px)))
        c16, c0 = args[0].clone(), args[0].clone()
        fn(c16, *args[1:])
        fn(c0, *sets, *args[1 + k:])
        assert torch.equal(c16, c0), f"[loam-gn] {kind}: the any-M kernel differs"
    log(f"[loam-gn] {len(edge)} edge cases within tolerance, no corner rows bit-equal to the "
        f"plane kernel, the any-M kernels bit-equal on misaligned planes: {json.dumps(edge)}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gn_loop.plane_gn_rounds(plane_args[0].clone(), *plane_args[1:])
        gn_loop.loam_gn_rounds(loam_args[0].clone(), *loam_args[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[loam-gn] plane_gn_rounds and loam_gn_rounds ran under set_sync_debug_mode('error')")

    entries = []
    for kind, args, label in (("plane_gn_rounds", plane_args, "PointToPlane_IVOX first round"),
                              ("loam_gn_rounds", loam_args, "LoamFull_KdTree first round")):
        head = gn_timing(torch, args, label, kind)
        key, most_args, _ = max(replayed[kind], key=lambda r: r[2])
        most = gn_timing(torch, most_args, f"most iterations ({key})", kind)
        for shape in (head, most):
            shape["ms_per_iteration"] = shape["ms"] / max(shape["iterations"], 1)
        n_rows = sum(c.px.shape[0] for c in args[1:1 + GN_SETS[kind]])
        split = gn_loop.rank_rows(n_rows, blocks[kind])
        assert sum(split) == n_rows, f"[loam-gn] {kind}: the ranks take {split} of {n_rows} rows"
        log(f"[loam-gn] {kind}: {n_rows} rows over R = {blocks[kind]} ranks: {split}")
        res = {k: v for k, v in resources.items()
               if k.startswith(f"loam_gn_kernel<{'true' if kind == 'loam_gn_rounds' else 'false'}")}
        log(f"[loam-gn] {kind} ptxas {res}")
        close = [r for r in rows_all[kind] if r["same"]]
        held64 = [r for r in rows_all[kind] if "dp64" in r]
        by_path = {p: v[kind] for p, v in GN_LAUNCHES_BY_KERNEL.items() if v.get(kind)}
        entries.append({
            "name": kind, "route": "cuda", "source": GN_SOURCE[0], "replaces": GN_SOURCE[1],
            "launches": sum(by_path.values()),
            "max_abs_err": max(r["dp"] for r in close),
            "max_rot_err_rad": max(r["da"] for r in close),
            "held_to_float64": len(held64),
            "max_abs_err_vs_float64_where_held": max((r["dp64"] for r in held64),
                                                     default=None),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")},
            "library_ms": None, "shapes": {"first_round": head, "most_iterations": most},
            "launches_by_path": by_path, "calls_compared": len(rows_all[kind]),
            "by_path": by_kernel[kind],
            "edge_cases": {n: e for n, e in edge.items() if n.startswith(kind)},
            "cluster_blocks": blocks[kind],
            "rows_per_rank": {"rows": n_rows, "max": max(split), "min": min(split)},
            "resources": res})
    for k, n in saved.items():
        getattr(gn_loop, k).launches = n
    log(f"[loam-gn] phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# the stage clocks of csrc/gn_loop.cu's K_* enum, and kStageClocks of
# csrc/stage_clock.cuh (the floats a profiling build writes after the carry)
GN_STAGES = ("setup", "rows", "block_sum", "cluster_wait", "dsmem_sum", "serial", "exit")
GN_CLOCKS = 16


def gn_stage_cycles(torch, lib, kind, call, keep_slots: bool = True) -> dict:
    """One launch of `kind` (a GN wrapper's name) from the C entry point of
    `lib`, a -DFLS_STAGE_CLOCKS build of csrc/gn_loop.cu, on a copy of the
    call's carry with room for the clocks after it: {stage: rank 0's SM
    cycles an iteration}. NDT without `keep_slots` gets no slot cache, so
    its rows look up afresh every iteration."""
    from funny_lidar_slam_torch.ops import gn_loop

    carry = call[0]
    big = torch.zeros(gn_loop.CARRY_SIZE + GN_CLOCKS, dtype=torch.int32, device=carry.device)
    big[:gn_loop.CARRY_SIZE] = carry
    stream = torch.cuda.current_stream(carry.device).cuda_stream
    if kind == "plane_map_gn_rounds":
        _, src, mask, m, inv, thresh, max_d2, _, cfg, _, probes = call
        ptrs = [t.data_ptr() for t in gn_loop._checked_refine_inputs(carry, src, mask, m)]
        ptrs[4] = big.data_ptr()  # the carry, after the source and the map
        err = lib.plane_map_gn_launch(*ptrs, src.shape[0], m.fpwin.shape[0], int(probes),
                                      m.bucket_size, *gn_loop._loop_args(cfg, schedule=False),
                                      float(inv), float(max_d2), float(thresh), stream)
    elif kind == "ndt_gn_rounds":
        _, src, mask, m, inv, thresh, _, cfg, *rest = call
        args = gn_loop._ndt_launch_args(carry, src, mask, m)
        ptrs = [t.data_ptr() for t in args]
        ptrs[6] = big.data_ptr()  # the carry, after the source and the map
        if not keep_slots:
            ptrs[7] = None
        err = lib.ndt_gn_launch(*ptrs, src.shape[0], m.fpwin.shape[0],
                                int(rest[0] if rest else 8),
                                *gn_loop._loop_args(cfg, schedule=False), float(inv),
                                float(thresh), stream)
    else:
        k = 2 if kind == "loam_gn_rounds" else 1
        sets, radius, cfg = call[1:1 + k], call[1 + k], call[2 + k]
        ptrs = [t.data_ptr() for t in gn_loop._checked_inputs(carry, sets[0], radius, *sets[1:],
                                                               name=kind)]
        ptrs[5 * k] = big.data_ptr()  # the carry, after each set's five tensors
        n, m = sets[0].px.shape
        if kind == "icp_gn_rounds":
            err = lib.icp_gn_launch(*ptrs, n, m, *gn_loop._loop_args(cfg), float(call[4]),
                                    stream)
        elif kind == "plane_gn_rounds":
            _, _, _, _, plane_thresh, max_d2 = call
            err = lib.plane_gn_launch(*ptrs, n, m, *gn_loop._loop_args(cfg), float(max_d2),
                                      float(plane_thresh), stream)
        else:
            _, _, _, _, _, line_ratio, plane_thresh, max_d2 = call
            err = lib.loam_gn_launch(*ptrs, n, sets[1].px.shape[0], m, *gn_loop._loop_args(cfg),
                                     float(max_d2), float(plane_thresh), float(line_ratio),
                                     stream)
    assert err == 0, f"{kind}: CUDA error {err}"
    torch.cuda.synchronize()
    its = max(int(big[gn_loop.OFFSET["it"]]) - int(carry[gn_loop.OFFSET["it"]]), 1)
    cycles = big[gn_loop.CARRY_SIZE:].view(torch.float32).tolist()
    return {name: c / its for name, c in zip(GN_STAGES, cycles)}


# -------------------------------------------- phase 22: the NDT GN loop kernel
NDT_GN_PATHS = ("ndt", "localization IncrementalNDT", "figure8-cascade")
# the least work of the function, counted by the structure of J = [a | I]:
# a row: the transform and its voxel (~20); each of its 7 voxels: the hash,
# fingerprint and probe compares (~40); a valid pair: e (3), lam e and e^T
# lam e (20), lsum += lam (9), esum += lam^T e (18), the count and the
# residual (2); a row with one valid pair or more, J's structure applied
# once to its sums: a = -R hat(s) (27), lam a (45), the r-r block a^T (lam
# a) (36, symmetric), the r-t block a^T lsum (54), the t-t block lsum (6,
# symmetric), g = [a^T esum; esum] (21), the count and the residual (2)
NDT_ROW_OPS, NDT_VOXEL_OPS = 20, 40
NDT_PAIR_OPS, NDT_FOLD_OPS = 3 + 20 + 9 + 18 + 2, 27 + 45 + 36 + 54 + 6 + 21 + 2


def ndt_cost(torch, args) -> tuple:
    """(bytes, operations, iterations) of one ndt_gn_rounds call. The bytes:
    each input read once, as far as this call's data needs it (the source
    and its mask, the 8-byte fingerprints of the slots the lookups probe at
    the start pose, up to each voxel's first match, a mean, an info and a
    flag for each distinct slot found), the carry read and written; the
    mask is read for every row, the 12-byte source row only where it is
    unmasked. The
    operations: each iteration's rows, voxels, valid pairs and rows with a
    valid pair, counted by the plain version at the pose of each
    iteration."""
    from funny_lidar_slam_torch.maps import ndt_map
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.ops.voxel import voxel_coords
    from funny_lidar_slam_torch.registration import residuals

    carry, src, mask, m, inv, thresh, radius, cfg, *rest = args
    probes = rest[0] if rest else 8
    t0 = gn_loop.result_views(carry).t_mat
    p = residuals._transform_fixed(t0, src)[mask]
    coords = voxel_coords(p, inv)[:, None, :] + ndt_map._stencil(p.device)
    slots, match, _ = ndt_map._probe(m, coords.reshape(-1, 3), probes)
    first = torch.where(match.any(-1), match.int().argmax(-1), probes - 1)
    probed = slots[torch.arange(probes, device=p.device)[None, :] <= first[:, None]]
    found = slots[match & (torch.cumsum(match.int(), -1) == 1)]
    nbytes = (src.shape[0] + 12 * int(mask.sum()) + 8 * int(torch.unique(probed).numel())
              + 49 * int(torch.unique(found).numel()) + 4 * (2 * gn_loop.CARRY_SIZE + 1))
    pairs, hg = [], gn_loop.ndt_hg

    def counted(t_mat, src, src_mask, m, inv, thresh, num_probes=8):
        """The plain version's linearization (`ndt_hg`), once an iteration:
        (its valid pairs, its rows with a valid pair)."""
        corr = residuals.ndt_corr(t_mat, src, src_mask, m, inv, thresh, num_probes)
        pairs.append((int(corr.valid.sum()), int(corr.valid.any(-1).sum())))
        return residuals.ndt_hg_corr(t_mat, src, corr)

    gn_loop.ndt_hg = counted
    try:
        gn_loop.ndt_gn_rounds_plain(carry.clone(), *args[1:])
    finally:
        gn_loop.ndt_hg = hg
    rows = int(mask.sum())
    ops = sum(rows * (NDT_ROW_OPS + 7 * NDT_VOXEL_OPS) + n * NDT_PAIR_OPS + k * NDT_FOLD_OPS
              for n, k in pairs)
    return nbytes, ops, len(pairs)


def ndt_timing(torch, args, label) -> dict:
    """`gn_turns` of ndt_gn_rounds with the call's bound (`ndt_cost`)."""
    turns, ms = gn_turns(torch, args, "ndt_gn_rounds")
    nbytes, ops, its = ndt_cost(torch, args)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    out = {"ms": ms["kernel"], "plain_ms": ms["plain"], "floor_ms": ms["floor"],
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "n": args[1].shape[0], "rows": int(args[2].sum()), "capacity": args[3].fp.shape[0],
           "inv": float(args[4]), "iterations": its, "bytes": nbytes, "ops": ops,
           "ms_per_iteration": ms["kernel"] / max(its, 1), "turns": turns,
           "vs_plain": versus(turns["kernel"], turns["plain"])}
    log(f"[ndt-gn] ndt_gn_rounds at the {label} shape (N {out['n']}, {out['rows']} rows, C "
        f"{out['capacity']}, {its} iterations): kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.2f} ms, empty launch {out['floor_ms']:.5f} ms, bound "
        f"{out['bound_ms']:.6f} ms ({out['bound_by']}); turns {turns}")
    return out


def one_call(r) -> bool:
    """A `gn_compare` row of ndt_gn_rounds ran its whole loop in the call:
    DONE, one gather an iteration."""
    from funny_lidar_slam_torch.ops import gn_loop

    return r["status"][0] == gn_loop.DONE and r["it"][0] == r["gathers"][0]


def ndt_hand_map(torch, m, voxels, slots, cap: int, offsets):
    """A map of capacity `cap` built by hand, fp and fpwin set directly (no
    insert): voxel i of `voxels` [V, 3] with the Gaussian of m's slot
    slots[i], at the first free slot (base_i + k) mod cap for k in
    `offsets` (window offsets below 8, tried in that order; a voxel with
    none free is left out)."""
    from funny_lidar_slam_torch.maps import ndt_map
    from funny_lidar_slam_torch.maps.voxel_hash import _window, fingerprint
    from funny_lidar_slam_torch.ops.voxel import spatial_hash

    taken, src, dst = set(), [], []
    for i, b in enumerate(spatial_hash(voxels, cap).tolist()):
        k = next((k for k in offsets if (b + k) % cap not in taken), None)
        if k is not None:
            taken.add((b + k) % cap)
            src.append(i)
            dst.append((b + k) % cap)
    src_i = torch.tensor(src, device=m.fp.device)
    at, at_m = torch.tensor(dst, device=m.fp.device), slots[src_i]
    out = ndt_map.create(cap, device=m.fp.device)._replace(epoch=m.epoch.clone())
    fp = out.fp.clone()
    fp[at] = fingerprint(voxels[src_i])
    fields = {f: getattr(out, f).clone() for f in ("count", "mean", "m2", "info", "estimated",
                                                   "age")}
    for f, t in fields.items():
        t[at] = getattr(m, f)[at_m]
    return out._replace(fp=fp, fpwin=_window(fp), **fields)


def ndt_edge_cases(torch, args, longest) -> list:
    """[(name, args)] on the bench shape's call: N 100 and N 5,003 rows
    spread over the source (below one 256-row tile, and no multiple of a
    tile or of R), every row masked, the info of a sixth of the slots the
    source's stencils find set to inf or NaN (an under-populated voxel's
    inverted covariance), num_probes 8 and 16 on a crowded map (the source
    at the start pose inserted with 16 probes into no more slots than it
    has voxels, so that lookups find voxels in slots 9-16 of their window,
    which 8 probes miss); two maps built by hand (`ndt_hand_map`) from the
    voxels the source's stencils find at the start pose: the 14 found most
    often in 16 slots, each at the last free slot of its window, so that
    windows wrap past slot 15; and every found voxel in as many slots as
    the bench map, each at offset 2 of its window where that is free, so
    that empty slots lie before the match; and max_iters 2 on the call
    `longest` (one that ran more iterations than that)."""
    from funny_lidar_slam_torch.maps import ndt_map
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.ops.voxel import voxel_coords
    from funny_lidar_slam_torch.registration import residuals

    carry, src, mask, m, inv, thresh, radius, cfg, *rest = args
    tail = (inv, thresh, radius, cfg)

    def rows(n):
        pool = torch.nonzero(mask).flatten()
        idx = pool[torch.linspace(0, len(pool) - 1, n, device=src.device).round().long()]
        return src.index_select(0, idx).contiguous(), mask.index_select(0, idx).contiguous()

    t0 = gn_loop.result_views(carry).t_mat
    p = residuals._transform_fixed(t0, src)[mask]
    coords = voxel_coords(p, inv)[:, None, :] + ndt_map._stencil(p.device)
    slots, match, _ = ndt_map._probe(m, coords.reshape(-1, 3), 8)
    hit = torch.unique(slots[match & (torch.cumsum(match.int(), -1) == 1)])
    bad = hit[torch.randperm(len(hit), generator=torch.Generator().manual_seed(0))[:len(hit) // 6]
              .to(hit.device)]
    info = m.info.clone()
    info[bad[0::2], 0, 0] = float("inf")
    info[bad[1::2], 1, 2] = float("nan")
    voxels = int(torch.unique(voxel_coords(p, inv), dim=0).shape[0])
    crowded = ndt_map.insert(ndt_map.create(1 << (voxels.bit_length() - 1), device=p.device),
                             p, torch.ones(len(p), dtype=torch.bool, device=p.device), inv,
                             num_probes=16, estimate_all=True, claim_rounds=16)
    _, match16, _ = ndt_map._probe(crowded, coords.reshape(-1, 3), 16)
    deep = int((match16[:, 8:].any(-1) & ~match16[:, :8].any(-1)).sum())
    log(f"[ndt-gn] crowded map: {voxels} voxels, {crowded.fp.shape[0]} slots; {deep} of "
        f"{match16.shape[0]} stencil lookups match only in slots 9-16")
    assert deep > 0, "[ndt-gn] the crowded map's lookups never reach slots 9-16"
    found = match.any(-1)
    first = slots.gather(-1, match.int().argmax(-1, keepdim=True))[:, 0]
    seen, at, hits = torch.unique(coords.reshape(-1, 3)[found], dim=0, return_inverse=True,
                                  return_counts=True)
    slot_of = torch.zeros(len(seen), dtype=torch.int64, device=p.device)
    slot_of[at] = first[found]
    top = torch.argsort(hits, descending=True, stable=True)[:14]
    wrapped = ndt_hand_map(torch, m, seen[top], slot_of[top], 16, range(7, -1, -1))
    gapped = ndt_hand_map(torch, m, seen, slot_of, m.fp.shape[0], (2, 3, 4, 5, 6, 7))

    def window_stats(hand, vox):
        """The voxels `hand`'s lookups find, those whose window wraps
        before the match, and those with an empty slot before it."""
        sl, mt, em = ndt_map._probe(hand, vox, 8)
        k = mt.int().argmax(-1, keepdim=True)
        hit = mt.any(-1)
        wrap = hit & (sl.gather(-1, k)[:, 0] < sl[:, 0])
        gap = hit & (em & (torch.arange(8, device=em.device) < k)).any(-1)
        return int(hit.sum()), int(wrap.sum()), int(gap.sum()), wrap

    n_hit, n_wrap, _, wrap = window_stats(wrapped, seen[top])
    log(f"[ndt-gn] wrapping map: {n_hit} voxels in 16 slots, {n_wrap} behind the wrap past "
        f"slot 15, found {int(hits[top][wrap].sum())} times at the start pose")
    assert n_wrap > 0, "[ndt-gn] no window of the hand-built map wraps"
    n_hit, _, gap, _ = window_stats(gapped, seen)
    log(f"[ndt-gn] gapped map: {n_hit} of {len(seen)} voxels, {gap} behind an empty slot")
    assert gap > 0.9 * len(seen), "[ndt-gn] few of the gapped map's matches follow an empty slot"
    return [("ndt_gn_rounds N 100", (carry, *rows(100), m, *tail, 8)),
            ("ndt_gn_rounds N 5003", (carry, *rows(5003), m, *tail, 8)),
            ("ndt_gn_rounds every row masked", (carry, src, torch.zeros_like(mask), m, *tail, 8)),
            ("ndt_gn_rounds non-finite info", (carry, src, mask, m._replace(info=info), *tail, 8)),
            ("ndt_gn_rounds num_probes 8", (carry, src, mask, crowded, *tail, 8)),
            ("ndt_gn_rounds num_probes 16", (carry, src, mask, crowded, *tail, 16)),
            ("ndt_gn_rounds probe windows wrap", (carry, src, mask, wrapped, *tail, 8)),
            ("ndt_gn_rounds empty slot before the match", (carry, src, mask, gapped, *tail, 8)),
            ("ndt_gn_rounds max_iters 2",
             (*longest[:7], longest[7]._replace(max_iters=2), *longest[8:]))]


def phase_ndt_gn(torch, report) -> dict:
    """Phase 22: ndt_gn_rounds (csrc/gn_loop.cu `ndt_gn_kernel`, one thread
    block cluster of R blocks a call, the whole NDT loop with its stencil
    lookup inside) against its plain version on every call captured in
    untimed runs beside phases 10 (NDT mapping) and 12d (NDT localization)
    and in a replay of phase 13's first cascade (its four NDT stages), with
    phase 20's gates: the same status, iterations and gathers on >= 95 % of
    a path's calls, and there the pose within 1e-4 m and 1e-5 rad (chord)
    of the plain version's or, where the two float32 poses part by more, of
    the plain version with float64 sums, num_valid within 1 %, total_res
    within 1e-3 relative (`gn_compare`; where the end parts from both, each
    iteration so from the same pose); every call's pose finite and
    within 0.05 m, every call DONE with as many gathers as iterations; the
    launches while capturing equal to the calls captured; every captured
    call (each a first round) launched twice bit-equal; R >= 8 printed with
    the rows a rank; no ptxas spills. Then, on the bench shape (phase 10's
    last call): the edge cases of `ndt_edge_cases` with the same gates; the
    launch under set_sync_debug_mode("error"); the kernel timed beside its
    plain version and one empty launch, with its bound, there and at each
    of the cascade's four stages, and there the stage clocks (rank 0's SM
    cycles an iteration in each stage, from STAGED_GN's build). Returns the
    JSON entry."""
    from funny_lidar_slam_torch.ops import cuda_build, gn_loop

    t_phase = time.perf_counter()
    kind = "ndt_gn_rounds"
    resources = {k: v for k, v in report.get("gn_loop", {}).items()
                 if k.startswith("ndt_gn_kernel")}
    assert list(resources) == ["ndt_gn_kernel"], f"[ndt-gn] ptxas report {sorted(resources)}"
    for name, res in resources.items():
        assert res["registers"] and res["spill_stores"] == 0 and res["spill_loads"] == 0, \
            f"[ndt-gn] {name} spills: {res}"
    blocks = gn_loop.cluster_blocks(kind)
    assert blocks >= 8, blocks
    log(f"[ndt-gn] ndt_gn_kernel launches one cluster of R = {blocks} blocks; ptxas {resources}")
    saved = gn_loop.ndt_gn_rounds.launches  # comparisons do not count
    by_key, rows_all, replayed = {}, [], []
    for key in NDT_GN_PATHS:
        calls = NDT_CAPTURES.get(key, [])
        assert calls and NDT_CAPTURE_LAUNCHES[key] == len(calls), \
            f"[ndt-gn] {key}: {len(calls)} calls captured, {NDT_CAPTURE_LAUNCHES.get(key)} launched"
        rows = [gn_compare(torch, args, kind) for args in calls]
        rows_all += rows
        replayed += [(args, r["iterations"]) for args, r in zip(calls, rows)]
        same = sum(r["same"] for r in rows) / len(rows)
        bad = [i for i, r in enumerate(rows) if (r["same"] and not r["close"])
               or not r["finite"] or r["dp"] > 0.05 or not one_call(r)]
        summary = {"calls": len(rows), "same_share": same,
                   "held_to_float64": [{k: r[k] for k in ("dp", "da", "dp64", "da64",
                                                          "plain_dp64", "plain_da64")}
                                       for r in rows if "dp64" in r],
                   "held_step_by_step": [r["stepwise"] for r in rows if "stepwise" in r],
                   "iterations_per_match": sum(r["iterations"] for r in rows) / len(rows),
                   **{f: [float(np.quantile([r[f] for r in rows], q)) for q in (0.5, 0.95, 1)]
                      for f in ("dp", "da", "nv_rel", "res_rel")},
                   "differing": [{k: r[k] for k in ("status", "it", "gathers", "dp", "da")}
                                 for r in rows if not r["same"]][:5]}
        summary["first_rounds_bit_equal"] = bit_equal_replays(torch, kind, calls)
        by_key[key] = summary
        log(f"[ndt-gn] {key}: " + json.dumps(summary))
        assert not bad, f"[ndt-gn] {key}: calls {bad} out of tolerance: " \
            f"{[rows[i] for i in bad[:3]]}"
        assert same >= GN_SAME_SHARE, f"[ndt-gn] {key}: {same:.3f} of calls agree"
    args = NDT_CAPTURES["ndt"][-1]  # the bench shape: phase 10's last match
    longest = max(replayed, key=lambda r: r[1])[0]  # the captured call of the most iterations
    edge = {}
    for name, eargs in ndt_edge_cases(torch, args, longest):
        r = gn_compare(torch, eargs, kind)
        edge[name] = {k: r[k] for k in ("status", "it", "gathers", "dp", "da", "nv_rel", "res_rel",
                                        "same", "close", "dp64", "da64", "stepwise") if k in r}
        edge[name]["rows"] = int(eargs[2].sum())
        assert r["same"] and r["close"] and r["finite"] and one_call(r), \
            f"[ndt-gn] edge case {name}: {r}"
    masked = edge["ndt_gn_rounds every row masked"]
    assert masked["dp"] == 0.0 and masked["da"] == 0.0, f"[ndt-gn] every row masked: {masked}"
    assert edge["ndt_gn_rounds max_iters 2"]["it"] == (2, 2), edge["ndt_gn_rounds max_iters 2"]
    log(f"[ndt-gn] {len(edge)} edge cases within tolerance: {json.dumps(edge)}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gn_loop.ndt_gn_rounds(args[0].clone(), *args[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[ndt-gn] ndt_gn_rounds ran under set_sync_debug_mode('error')")
    n_rows = args[1].shape[0]
    split = gn_loop.rank_rows(n_rows, blocks)
    assert sum(split) == n_rows, f"[ndt-gn] the ranks take {split} of {n_rows} rows"
    log(f"[ndt-gn] {n_rows} rows over R = {blocks} ranks: {split}")
    head = ndt_timing(torch, args, "bench (phase 10's last match)")
    stages = {}
    for k, sargs in enumerate(NDT_CAPTURES["figure8-cascade"]):
        stages[f"cascade_stage_{k}_inv_{float(sargs[4]):g}"] = ndt_timing(
            torch, sargs, f"cascade stage {k}")
    staged = cuda_build.variant(*STAGED_GN)  # rank 0's SM cycles in each stage
    for (label, shape), sargs in zip({"bench": head, **stages}.items(),
                                     [args] + NDT_CAPTURES["figure8-cascade"]):
        cycles = gn_stage_cycles(torch, staged, kind, sargs)
        shape["stage_cycles_per_iteration"] = cycles
        shape["rows_share"] = cycles["rows"] / max(sum(cycles.values()), 1.0)
        log(f"[ndt-gn] {label}: SM cycles an iteration by stage {json.dumps(cycles)}; "
            f"thread 0's rows {shape['rows_share']:.3f} of the iteration")
    gn_loop.ndt_gn_rounds.launches = saved
    log(f"[ndt-gn] phase 22 took {time.perf_counter() - t_phase:.1f} s")
    close = [r for r in rows_all if r["same"]]
    held64 = [r for r in rows_all if "dp64" in r]
    by_path = {p: v[kind] for p, v in GN_LAUNCHES_BY_KERNEL.items() if v.get(kind)}
    return {"name": kind, "route": "cuda", "source": GN_SOURCE[0], "replaces": GN_SOURCE[1],
            "launches": sum(by_path.values()),
            "max_abs_err": max(r["dp"] for r in close),
            "max_rot_err_rad": max(r["da"] for r in close),
            "held_to_float64": len(held64),
            "max_abs_err_vs_float64_where_held": max((r["dp64"] for r in held64), default=None),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms")},
            "library_ms": None, "shapes": {"bench": head, **stages},
            "launches_by_path": by_path, "calls_compared": len(rows_all), "by_path": by_key,
            "edge_cases": edge, "cluster_blocks": blocks,
            "rows_per_rank": {"rows": n_rows, "max": max(split), "min": min(split)},
            "resources": resources}


# ------------------------------------------------ phase 23: LOAM features
FEATURE_SOURCE = ("funny_lidar_slam_torch/csrc/loam_features.cu",
                  "funny_lidar_slam_tpu/loam/features.py:133")
# the capture keys of the paths with a lidar geometry: phases 7-9, 12a-c, 15a
FEATURE_PATHS = bench.LOAM_MODES + tuple(f"localization {m}" for m in bench.LOAM_MODES) \
    + ("m2dgr",)
# the bench's lidar geometry (rows, columns, min and max distance)
FEATURE_BENCH = (16, 900, 1.5, 50.0)
# rows of the short-rows case: the points kept of each ring (0: an empty row;
# fewer than 11: a row without a block; 11-16: blocks of no lane)
SHORT_ROWS = (0, 1, 5, 10, 11, 12, 16, 17, 18, 23, 29, 30, 60, 200, 0, 400)


def _sim_case(points, rel_times, rows, mask=None) -> dict:
    """Projection inputs of a simulated scan: ring ids from the elevation
    (the port's synth_rings on the CPU), every point masked in unless
    `mask` says otherwise."""
    import torch

    from funny_lidar_slam_torch.loam.projection import synth_rings

    ring = synth_rings(torch.as_tensor(points), rows).numpy()
    return dict(points=points, ring=ring, rel_times=rel_times,
                mask=np.ones(len(points), bool) if mask is None else mask)


def _wrap_case() -> dict:
    """A scan with no padding: 16 rows of 64 columns, rows 0-14 full and
    row 15 at columns 0-8, so packed index N-1 is a real point next to
    index 0 (columns 8 and 0); depth jumps at both: d[0] = 30 m, d[N-1] =
    5 m. The wrap-around decides lane 5 of row 0: its roughness reads
    d[0], and the occlusion seed at N-1 (d[0] - d[N-1] > 0.3) marks 0..5."""
    rows, cols = 16, 64
    rc = [(r, c) for r in range(rows) for c in range(cols if r < rows - 1 else 9)]
    ring = np.array([r for r, _ in rc], np.int32)
    col = np.array([c for _, c in rc], np.float64)
    rng = np.random.default_rng(23)
    d = 10.0 + np.sin(col / 10.0 + ring) + rng.normal(0.0, 0.01, len(rc))
    d[rng.choice(np.arange(12, len(rc) - 12), 40, replace=False)] += 4.0  # occlusion marks
    d[0], d[-1] = 30.0, 5.0
    az = (col - cols // 2) * (2 * np.pi / cols)
    points = np.stack([d * np.cos(az), d * np.sin(az), np.zeros_like(d)], 1).astype(np.float32)
    return dict(points=points, ring=ring, rel_times=np.zeros(len(rc), np.float32),
                mask=np.ones(len(rc), bool))


def feature_cases() -> list:
    """The corner selection's edge cases, the CPU tests' and phase 23's
    (every variant of the kernel: 8 and 16 keys a lane in registers, keys
    in shared memory above 512 lanes):
    [(name, geometry (rows, columns, min, max distance), projection inputs
    {points, ring, rel_times, mask} as numpy, a depth edit (depth, mask) ->
    depth applied to the projected scan or None, FeatureConfig fields)].
    Built from the port's simulator (numpy), seed 7."""
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate

    ds = simulate(SimConfig(duration=1.0, static_warmup=0.2, points_per_scan=16384, seed=7))
    scan = ds.scans[-1]
    pts, rts = scan.points.astype(np.float32), scan.rel_times.astype(np.float32)
    wide = simulate(SimConfig(duration=1.0, static_warmup=0.2, points_per_scan=57600,
                              seed=7)).scans[-1]
    bench16 = _sim_case(pts, rts, 16)
    ring = bench16["ring"]
    keep = np.zeros(len(pts), bool)
    for r, k in enumerate(SHORT_ROWS):
        keep[np.flatnonzero(ring == r)[:k]] = True
    short = _sim_case(pts, rts, 16, keep)
    quantized = lambda d, m: np.where(m, np.round(d), 0.0).astype(np.float32)  # noqa: E731
    flat = lambda d, m: np.where(m, 12.5, 0.0).astype(np.float32)  # noqa: E731
    return [
        ("bench", FEATURE_BENCH, bench16, None, {}),
        ("bench max_corners 1", FEATURE_BENCH, bench16, None, {"max_corners_per_block": 1}),
        ("bench max_corners 40", FEATURE_BENCH, bench16, None, {"max_corners_per_block": 40}),
        ("bench threshold -2", FEATURE_BENCH, bench16, None, {"corner_threshold": -2.0}),
        ("32x1800 at 8192 points", (32, 1800, 1.5, 50.0),
         _sim_case(pts[::2].copy(), rts[::2].copy(), 32), None, {}),
        ("64x1800", (64, 1800, 1.5, 50.0), _sim_case(pts, rts, 64), None, {}),
        ("short and empty rows", FEATURE_BENCH, short, None, {}),
        ("short and empty rows threshold -2", FEATURE_BENCH, short, None,
         {"corner_threshold": -2.0}),
        ("all masked", FEATURE_BENCH, dict(bench16, mask=np.zeros(len(pts), bool)), None, {}),
        ("equal depths", FEATURE_BENCH, bench16, flat, {"corner_threshold": -0.5}),
        ("quantized depths", FEATURE_BENCH, bench16, quantized, {}),
        ("wrap-around at 0 and N-1", (16, 64, 1.5, 50.0), _wrap_case(), None, {}),
        # 602 lanes a block: the kernel keeps the picks' keys in shared memory
        ("16x900 at 57600 points", FEATURE_BENCH,
         _sim_case(wide.points.astype(np.float32), wide.rel_times.astype(np.float32), 16),
         None, {}),
    ]


def feature_edge_cases(torch, device="cuda") -> list:
    """`feature_cases` projected by the port on `device`: [(name, OrderedScan,
    FeatureConfig)]."""
    from funny_lidar_slam_torch.loam.features import FeatureConfig
    from funny_lidar_slam_torch.loam.projection import LidarGeometry, project

    out = []
    for name, (rows, cols, lo, hi), inp, edit, cfg in feature_cases():
        geom = LidarGeometry(rows, cols, 2 * np.pi / cols, lo, hi)
        t = {k: torch.as_tensor(v, device=device) for k, v in inp.items()}
        scan = project(t["points"], t["ring"], t["rel_times"], t["mask"], geom)
        if edit is not None:
            depth = edit(scan.depth.cpu().numpy(), scan.mask.cpu().numpy())
            scan = scan._replace(depth=torch.as_tensor(depth, device=device))
        out.append((name, scan, FeatureConfig(**cfg)))
    return out


def feature_parity(torch, scan, cfg, label) -> dict:
    """The kernel's corner mask (`corner_mask`) against corner_mask_plain on
    the same tensors, bit for bit. Where they part, logs each parting point
    (which side picked it, its roughness and the gap to the nearest other
    roughness of its row). Returns {equal, corners, parted}."""
    from funny_lidar_slam_torch.loam import features
    from funny_lidar_slam_torch.ops import loam_features

    k = loam_features.corner_mask(scan, cfg)
    p = features.corner_mask_plain(scan, cfg)
    parted = torch.nonzero(k != p).flatten().tolist()
    if parted:
        rough = features.compute_roughness(scan).cpu().numpy()
        rs, re_ = scan.row_start.cpu().numpy(), scan.row_end.cpu().numpy()
        row, kk = scan.row.cpu().numpy(), k.cpu().numpy()
        for i in parted[:20]:
            others = np.delete(rough[rs[row[i]]:re_[row[i]]], i - rs[row[i]]) \
                if rs[row[i]] <= i < re_[row[i]] else rough[[]]
            gap = float(np.min(np.abs(others - rough[i]))) if len(others) else None
            log(f"[loam-features] {label}: point {i} (row {row[i]}) picked by the "
                f"{'kernel' if kk[i] else 'plain version'} only; roughness {float(rough[i])!r}, "
                f"gap to its row's nearest {gap!r}")
    return {"equal": not parted, "corners": int(p.sum()), "parted": len(parted),
            "max_abs_err": float(bool(parted))}


def feature_timing(torch, scan, cfg, label, builds=None) -> dict:
    """The wrapper (`corner_mask`: the output's fill and the launch), the
    bare launch into a zeroed output, the plain version and one empty
    launch (torch.cuda._sleep(0)), each the median device ms of one call
    (`time_ms`), in turns; with the bound: depth, col, row (4 B a point)
    and the mask (1 B) read once, the row bounds (8 B a row) and the corner
    mask (1 B a point) written once, at 3.35 TB/s. `builds` ({name: a
    library with loam_corners_launch}: another build of the kernel) adds
    each build's bare launch to the same turns (`{name}_ms`, and `vs_{name}`:
    this build's launch against it)."""
    from funny_lidar_slam_torch.loam import features
    from funny_lidar_slam_torch.ops import cuda_build, loam_features

    n, rows = scan.depth.shape[0], scan.row_start.shape[0]
    tensors = loam_features._checked(scan, cfg)
    out = torch.zeros(n, dtype=torch.bool, device=scan.depth.device)
    args = (*(t.data_ptr() for t in tensors), out.data_ptr(), n, rows, cfg.blocks_per_row,
            loam_features.lanes(n, rows, cfg.blocks_per_row), cfg.max_corners_per_block,
            cfg.occlusion_col_diff, cfg.occlusion_depth_jump, cfg.parallel_ratio,
            cfg.corner_threshold, torch.cuda.current_stream().cuda_stream)

    def bare(lib):
        return lambda: lib.loam_corners_launch(*args)

    others = dict(builds or {})
    calls = {"kernel": lambda: loam_features.corner_mask(scan, cfg),
             "launch": bare(cuda_build.library("loam_features")),
             **{name: bare(lib) for name, lib in others.items()},
             "plain": lambda: features.corner_mask_plain(scan, cfg),
             "floor": lambda: torch.cuda._sleep(0)}
    order = ["kernel", "launch", *others, "plain", "floor"]
    turns = in_turns(lambda fn: time_ms(torch, fn, 20), calls, order + order[::-1])
    nbytes = n * (4 + 4 + 4 + 1) + rows * 8 + n
    res = {"points": n, "rows": rows, "lanes": loam_features.lanes(n, rows, cfg.blocks_per_row),
           "ms": float(np.median(turns["kernel"])), "launch_ms": float(np.median(turns["launch"])),
           "plain_ms": float(np.median(turns["plain"])),
           "floor_ms": float(np.median(turns["floor"])), "turns": turns, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "vs_plain": versus(turns["kernel"], turns["plain"])}
    for name in others:
        res[f"{name}_ms"] = float(np.median(turns[name]))
        res[f"vs_{name}"] = versus(turns["launch"], turns[name])
    log(f"[loam-features] {label}: " + json.dumps(res))
    return res


def phase_loam_features(torch, report) -> dict:
    """Phase 23: the LOAM corner selection (csrc/loam_features.cu
    `loam_corners_kernel`, wrapper ops/loam_features.py::corner_mask) against
    corner_mask_plain, bit for bit, on every call captured in the untimed
    runs beside phases 7-9, 12a-c and 15a (FEATURE_PATHS; every other
    capture holds none) and on `feature_edge_cases`; the launches while
    capturing equal to the calls captured; the launches of every path (one
    a LOAM front-end call, `feature_launches`); no ptxas spills; the launch
    under set_sync_debug_mode("error"); timed at the bench shape (phase 7's
    last call) and M2DGR's (15a's last) beside its plain version and one
    empty launch, with its bound. Returns the JSON entry."""
    from funny_lidar_slam_torch.ops import loam_features

    t_phase = time.perf_counter()
    resources = {k: v for k, v in report.get("loam_features", {}).items()
                 if k.startswith("loam_corners_kernel")}
    assert sorted(resources) == [f"loam_corners_kernel<{k}>" for k in (0, 16, 8)], \
        f"[loam-features] ptxas report {resources}"
    for name, res in resources.items():
        assert res["registers"] and res["spill_stores"] == 0 and res["spill_loads"] == 0, \
            f"[loam-features] {name} spills: {res}"
    log(f"[loam-features] ptxas {json.dumps(resources)}")
    kernel = loam_features.corner_mask
    saved = kernel.launches  # comparisons do not count
    by_key, rows_all = {}, []
    for key, calls in FEATURE_CAPTURES.items():
        launched = FEATURE_CAPTURE_LAUNCHES.get(key, 0)
        assert launched == len(calls), f"[loam-features] {key}: {len(calls)} calls captured, " \
            f"{launched} launched"
        assert bool(calls) == (key in FEATURE_PATHS), \
            f"[loam-features] {key}: {len(calls)} calls captured"
        if not calls:
            continue
        rows = [feature_parity(torch, scan, cfg, f"{key} call {i}")
                for i, (scan, cfg) in enumerate(calls)]
        rows_all += rows
        parted = [i for i, r in enumerate(rows) if not r["equal"]]
        scan = calls[-1][0]
        by_key[key] = {"calls": len(rows), "points": scan.depth.shape[0],
                       "masked_in": int(scan.mask.sum()),
                       "corners_per_call": float(np.mean([r["corners"] for r in rows]))}
        log(f"[loam-features] {key}: " + json.dumps(by_key[key]))
        assert not parted, f"[loam-features] {key}: calls {parted[:10]} part from the plain version"
    assert set(by_key) == set(FEATURE_PATHS), f"[loam-features] captured {sorted(by_key)}"
    edge = {}
    for name, scan, cfg in feature_edge_cases(torch):
        edge[name] = feature_parity(torch, scan, cfg, f"edge case {name}")
        assert edge[name]["equal"], f"[loam-features] edge case {name}: {edge[name]}"
    assert edge["all masked"]["corners"] == 0 and edge["bench"]["corners"] > 0, edge
    log(f"[loam-features] {len(edge)} edge cases bit-equal: {json.dumps(edge)}")
    scan, cfg = FEATURE_CAPTURES[bench.LOAM_MODES[0]][-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel(scan, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[loam-features] corner_mask ran under set_sync_debug_mode('error')")
    shapes = {"bench": feature_timing(torch, scan, cfg, "bench (phase 7's last call)"),
              "m2dgr": feature_timing(torch, *FEATURE_CAPTURES["m2dgr"][-1],
                                      "M2DGR (15a's last call)")}
    kernel.launches = saved
    log(f"[loam-features] phase 23 took {time.perf_counter() - t_phase:.1f} s")
    head = shapes["bench"]
    by_path = {p: n for p, n in FEATURE_LAUNCHES.items() if n}
    return {"name": "loam_corners", "route": "cuda", "source": FEATURE_SOURCE[0],
            "replaces": FEATURE_SOURCE[1], "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows_all + list(edge.values())),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
                                    "launch_ms")},
            "library_ms": None, "shapes": shapes, "launches_by_path": by_path,
            "calls_compared": len(rows_all), "by_path": by_key, "edge_cases": edge,
            "resources": resources}


# ------------------------------------------------- phase 24: the pose graph
PG_SOURCE = ("funny_lidar_slam_torch/csrc/pose_graph.cu",
             "funny_lidar_slam_tpu/backend/pose_graph.py:133")
PG_TOL = (2e-3, 1e-3)  # m, rad (chord): tests/test_torch_backend.py's f32 tolerance
PG_RATIO = 1.5  # or no farther from the float64 run than 1.5x the float32 plain run
PG_GRAPHS: list = []  # phase 13's optimize inputs (LoopProbe.graphs), in call order
POSE_GRAPH_LAUNCHES: dict = {}  # path -> pose_graph_gn launches (check_launches)


def pose_graph_builders(dry_run: bool = False) -> dict:
    """The CPU tests' graphs (tests/test_torch_pose_graph_gn.py), each the
    port's PoseGraphBuilder, from numpy and a seed: the 60-pose noisy circle
    in k_cap 64 with 1 and 8 extra loops (io/simulator.noisy_circle_graph);
    2 vertices (one free, its odometry edge to vertex 0 disagreeing with its
    pose); 1 vertex (none free); 70 vertices from k_cap 64 (the builder
    grows it to 128) with two loop edges; a 40-pose circle with a used
    vertex that no edge touches; a 60-pose circle whose last loop edge's
    information is negated, so its factorization fails. With `dry_run`,
    also the dry run's 1,000-keyframe graph (parallel/dryrun.py:
    k_cap 1024, radius 150 m, 600 extra loops)."""
    from funny_lidar_slam_torch.backend.pose_graph import PoseGraphBuilder
    from funny_lidar_slam_torch.core.lie import se3_exp
    from funny_lidar_slam_torch.io.simulator import noisy_circle_graph

    import torch

    rng = np.random.default_rng(24)

    def noisy(pose, sigma=0.05):
        v = torch.as_tensor(rng.normal(0, sigma, 6), dtype=torch.float64)
        return pose @ se3_exp(v).numpy()

    out = {f"circle 60, {x} loops": noisy_circle_graph(n=60, seed=0, k_cap=64, e_cap=128,
                                                      extra_loops=x)[0] for x in (1, 8)}
    b = PoseGraphBuilder(k_cap=4, e_cap=4)
    b.add_vertex(np.eye(4))
    b.add_vertex(noisy(np.eye(4), 0.5))
    b.poses[1] = noisy(b.poses[1])
    out["2 vertices"] = b
    b = PoseGraphBuilder(k_cap=4, e_cap=4)
    b.add_vertex(noisy(np.eye(4)))
    out["1 vertex"] = b
    b, gt, acc = PoseGraphBuilder(k_cap=64, e_cap=64), [], np.eye(4)
    for k in range(70):
        a = 2 * np.pi * k / 70
        t = np.eye(4)
        t[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        t[:2, 3] = [12 * np.cos(a), 12 * np.sin(a)]
        acc = t if k == 0 else noisy(acc @ np.linalg.inv(gt[-1]) @ t, 0.02)
        gt.append(t)
        b.add_vertex(acc)
    for i, j in ((69, 0), (52, 17)):
        b.add_edge(i, j, np.linalg.inv(gt[i]) @ gt[j], (1e2,) * 3 + (1e4,) * 3)  # the system's
    out["70 vertices grown from k_cap 64"] = b
    b, _ = noisy_circle_graph(n=40, seed=2, k_cap=64, e_cap=128, extra_loops=2)
    b.pose_mask[45] = True
    b.poses[45] = noisy(np.eye(4), 3.0)
    b.n_vertices = 46
    out["a used vertex with no edge"] = b
    b, _ = noisy_circle_graph(n=60, seed=1, k_cap=64, e_cap=128, extra_loops=3)
    b.edge_info[b.n_edges - 1] *= -1
    out["failing factorization"] = b
    if dry_run:
        from funny_lidar_slam_torch.parallel.dryrun import NORTH_STAR_GRAPH

        out["dry run, 1,000 keyframes"] = noisy_circle_graph(**NORTH_STAR_GRAPH)[0]
    return out


def pose_graph_structure(g) -> dict:
    """What csrc/pose_graph.cu's factorization touches on graph `g` (any
    device): the free vertices n_f, the edges it linearizes, and, over the
    compact system with its fill, the blocks of L below the diagonal, the
    panel blocks (one a column's written block) and the block updates
    (L_ik L_jk^T, i >= j > k) of one iteration."""
    mask = g.pose_mask.cpu().numpy().copy()
    mask[0] = False
    k = len(mask)
    cidx = np.full(k, -1)
    cidx[mask] = np.arange(mask.sum())
    nf = int(mask.sum())
    ei, ej = g.edge_i.cpu().numpy(), g.edge_j.cpu().numpy()
    inside = (ei >= 0) & (ei < k) & (ej >= 0) & (ej < k) & g.edge_mask.cpu().numpy()
    ci, cj = cidx[np.where(inside, ei, 0)], cidx[np.where(inside, ej, 0)]
    used = inside & ((ci >= 0) | (cj >= 0))
    both = used & (ci >= 0) & (cj >= 0) & (ci != cj)
    s = np.zeros((nf, nf), bool)
    s[np.maximum(ci[both], cj[both]), np.minimum(ci[both], cj[both])] = True
    panel = pairs = 0
    for c in range(nf):
        rows = np.flatnonzero(s[c + 1:, c]) + c + 1
        panel += len(rows)
        pairs += len(rows) * (len(rows) + 1) // 2
        if len(rows) > 1:
            s[np.ix_(rows, rows)] |= np.tril(np.ones((len(rows),) * 2, bool), -1)
    return {"free_vertices": nf, "edges": int(used.sum()), "blocks_below_diagonal": int(s.sum()),
            "panel_blocks": panel, "block_updates": pairs,
            "incident_entries": int((ci[used] >= 0).sum() + (cj[used] >= 0).sum())}


# operations (an FMA 2) an iteration: an edge's residual, Jr^-1, J (the 3x3
# products of the Q block and Adj) and h, g; a 6x6 Cholesky; a panel block
# (6 rows of 15 FMA and 6 divisions); a block update (216 FMA); each written
# block's equilibration (72) and its two substitution products (2 x 36 FMA);
# an incident entry's sums (36 + 6, and 36 more below the diagonal); a free
# vertex's update (se3_exp and a 4x4 product)
PG_EDGE_OPS, PG_CHOL_OPS, PG_PANEL_OPS, PG_UPDATE_OPS = 1400, 182, 216, 432
PG_BLOCK_OPS, PG_ENTRY_OPS, PG_VERTEX_OPS = 72 + 144, 78, 250


def pose_graph_cost(g, iterations: int = 15) -> tuple:
    """(bytes, operations) one optimize of `g` needs on the kernel's route:
    the graph read once (poses 64 B, pose_mask 1 B; an edge's ends, measure,
    information and mask 97 B) and the poses written once; the operations
    of `iterations` iterations over pose_graph_structure's blocks."""
    st = pose_graph_structure(g)
    k, e = g.poses.shape[0], g.edge_i.shape[0]
    nbytes = k * (64 + 1 + 64) + e * 97
    per_it = (st["edges"] * PG_EDGE_OPS + st["free_vertices"] * (PG_CHOL_OPS + PG_VERTEX_OPS)
              + st["panel_blocks"] * PG_PANEL_OPS + st["block_updates"] * PG_UPDATE_OPS
              + (st["blocks_below_diagonal"] + st["free_vertices"]) * PG_BLOCK_OPS
              + st["incident_entries"] * PG_ENTRY_OPS)
    return nbytes, iterations * per_it, st


def graph_pose_diff(a, b) -> tuple:
    """(largest translation distance m, largest chord angle rad) between two
    [K, 4, 4] pose sets, in float64."""
    from funny_lidar_slam_torch.core.lie import chord_angle

    a, b = a.double(), b.double()
    if a.shape[0] == 0:
        return 0.0, 0.0
    return (float((a[:, :3, 3] - b[:, :3, 3]).norm(dim=1).max()),
            float(chord_angle(a, b.to(a.device)).max()))


def pose_graph_compare(torch, g, label, iterations: int = 15) -> dict:
    """pose_graph_gn against optimize_plain on graph `g` (float32, on the
    card), both against a float64 plain run: NaN at the same vertices in
    all three; elsewhere the kernel within PG_TOL of the float64 poses, or
    no farther from them than PG_RATIO x the float32 plain run; the fixed
    vertices (0 and the unused) bit for bit the input. Also the
    synchronized host ms of the kernel's call (`kernel_ms`)."""
    from funny_lidar_slam_torch.backend import pose_graph
    from funny_lidar_slam_torch.ops import pose_graph as ops

    torch.cuda.synchronize()
    t = time.perf_counter()
    kernel = ops.pose_graph_gn(g, iterations).poses
    torch.cuda.synchronize()
    kernel_ms = (time.perf_counter() - t) * 1e3
    plain = pose_graph.optimize_plain(g, iterations).poses
    g64 = type(g)(*(t.double() if t.is_floating_point() else t for t in g))
    ref = pose_graph.optimize_plain(g64, iterations).poses
    torch.cuda.synchronize()
    nan = [torch.isnan(p).flatten(1).any(1) for p in (kernel, plain, ref)]
    assert torch.equal(nan[0], nan[1]) and torch.equal(nan[0], nan[2]), \
        f"[pose-graph] {label}: NaN at {[int(n.sum()) for n in nan]} vertices"
    ok = ~nan[0]
    fixed = ~g.pose_mask.clone()
    fixed[0] = True
    assert torch.equal(kernel[fixed], g.poses[fixed]), f"[pose-graph] {label}: a fixed vertex moved"
    dk, dp = graph_pose_diff(kernel[ok], ref[ok]), graph_pose_diff(plain[ok], ref[ok])
    row = {"label": label, "vertices": int(g.pose_mask.sum()), "capacity": g.poses.shape[0],
           "edges": int(g.edge_mask.sum()), "nan_vertices": int(nan[0].sum()),
           "kernel_ms": kernel_ms, "kernel_vs_f64": dk, "plain_vs_f64": dp,
           "kernel_vs_plain": graph_pose_diff(kernel[ok], plain[ok]),
           "max_abs_err": float((kernel[ok] - plain[ok]).abs().max()) if ok.any() else 0.0}
    within = dk[0] < PG_TOL[0] and dk[1] < PG_TOL[1]
    near = dk[0] <= PG_RATIO * dp[0] and dk[1] <= PG_RATIO * dp[1]
    assert within or near, f"[pose-graph] {label}: {row}"
    log(f"[pose-graph] {label}: " + json.dumps(row))
    return row


def pose_graph_timing(torch, g, label, iterations: int = 15) -> dict:
    """pose_graph_gn and optimize_plain at graph `g`: device ms (`time_ms`)
    and synchronized host ms a call (the `optimize_ms` of phase 13), each
    timed in turns (kernel, plain, floor, floor, plain, kernel; twice; the
    floor one empty launch), with the bound."""
    from funny_lidar_slam_torch.backend import pose_graph
    from funny_lidar_slam_torch.ops import pose_graph as ops

    def wall(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    calls = {"kernel": lambda: ops.pose_graph_gn(g, iterations),
             "plain": lambda: pose_graph.optimize_plain(g, iterations),
             "floor": lambda: torch.cuda._sleep(0)}
    order = ["kernel", "plain", "floor", "floor", "plain", "kernel"] * 2
    dev = in_turns(lambda fn: time_ms(torch, fn, 10), calls, order)
    host = in_turns(wall, {k: calls[k] for k in ("kernel", "plain")},
                    ["kernel", "plain", "plain", "kernel"] * 2)
    nbytes, ops_n, st = pose_graph_cost(g, iterations)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_n / F32_OPS_PER_S * 1e3
    res = {"label": label, **st, "ms": float(np.median(dev["kernel"])),
           "plain_ms": float(np.median(dev["plain"])), "floor_ms": float(np.median(dev["floor"])),
           "optimize_ms": float(np.median(host["kernel"])),
           "plain_optimize_ms": float(np.median(host["plain"])),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes": nbytes, "operations": ops_n, "device_turns": dev, "host_turns": host,
           "vs_plain": versus(dev["kernel"], dev["plain"])}
    log(f"[pose-graph] {label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"empty launch {res['floor_ms']:.5f} ms (device); optimize {res['optimize_ms']:.3f} ms "
        f"against the plain {res['plain_optimize_ms']:.3f} ms (host, synchronized); bound "
        f"{res['bound_ms']:.6f} ms ({res['bound_by']}); turns {json.dumps(dev)} / "
        f"{json.dumps(host)}")
    return res


def phase_pose_graph(torch, report) -> dict:
    """Phase 24: the pose graph's GN loop (csrc/pose_graph.cu
    `pose_graph_gn_kernel`, wrapper ops/pose_graph.py::pose_graph_gn, the
    JAX `optimize`'s fori_loop in one launch over the free vertices) against
    optimize_plain on the card, with a float64 plain run as the reference
    (`pose_graph_compare`), on phase 13's graphs (every optimize of the
    figure-8), the CPU tests' graphs and the dry run's 1,000-keyframe
    graph; timed in turns at the figure-8's graphs; the launches of every
    path (one an accepted loop, `check_launches`). Returns the JSON entry."""
    from funny_lidar_slam_torch.ops import pose_graph as ops

    t_phase = time.perf_counter()
    resources = report.get("pose_graph", {}).get("pose_graph_gn_kernel")
    assert resources and resources["registers"], f"[pose-graph] ptxas report {report.get('pose_graph')}"
    log(f"[pose-graph] ptxas {json.dumps(resources)}")
    kernel = ops.pose_graph_gn
    saved = kernel.launches  # comparisons do not count
    assert PG_GRAPHS, "[pose-graph] phase 13 captured no optimize"
    rows = [pose_graph_compare(torch, g, f"figure-8 optimize {i}", *a, **kw)
            for i, (g, a, kw) in enumerate(PG_GRAPHS)]
    for name, b in pose_graph_builders(dry_run=True).items():
        t = time.perf_counter()
        rows.append(pose_graph_compare(torch, b.to_device(torch.float32, device="cuda"), name))
        log(f"[pose-graph] {name} compared in {time.perf_counter() - t:.1f} s")
    failing = [r for r in rows if r["label"] == "failing factorization"]
    assert failing and failing[0]["nan_vertices"] == failing[0]["vertices"] - 1, failing
    shapes = {f"figure-8 optimize {i}": pose_graph_timing(torch, g, f"figure-8 optimize {i}",
                                                          *a, **kw)
              for i, (g, a, kw) in enumerate(PG_GRAPHS)}
    kernel.launches = saved
    log(f"[pose-graph] phase 24 took {time.perf_counter() - t_phase:.1f} s")
    head = shapes[max(shapes, key=lambda k: shapes[k]["free_vertices"])]
    return {"name": "pose_graph_gn", "route": "cuda", "source": PG_SOURCE[0],
            "replaces": PG_SOURCE[1], "launches": sum(POSE_GRAPH_LAUNCHES.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
                                    "optimize_ms", "plain_optimize_ms")},
            "library_ms": None, "shapes": shapes, "launches_by_path": dict(POSE_GRAPH_LAUNCHES),
            "compared": rows, "resources": resources}


# ------------------------------------- phase 25: the loop closure's refine
REFINE_SOURCE = ("funny_lidar_slam_torch/csrc/gn_loop.cu",
                 "funny_lidar_slam_tpu/backend/loop_closure.py:159-169")
REFINE_PATHS = ("figure8", "figure8-cascade")
# the least work of an iteration, counted as the kernel takes it: a row's
# transform and voxel (~20) and each of its 8 cover blocks' hash,
# fingerprint and probe compares (~40); a stencil lane of a found block, its
# d2 and the compare with the fifth (~10); a row with five points within
# the gate, its plane fit, gates and J J^T (~250, as gn_cost's plane row)
REFINE_ROW_OPS, REFINE_BLOCK_OPS, REFINE_LANE_OPS, REFINE_PLANE_OPS = 20, 40, 10, 250


def refine_lookup(torch, m, p, inv, probes) -> tuple:
    """The kernel's lookup for rows at world points p [R, 3] (the cover of
    each row's voxel, block_map.gather_cover): the cover's slots [R, 8] (-1
    where a block is missed), the nearby26 stencil over the cover's local
    voxels [R, 8, 8], and the slots the windows probe up to each first
    match (flat)."""
    from funny_lidar_slam_torch.maps import block_map
    from funny_lidar_slam_torch.ops.voxel import voxel_coords

    v = voxel_coords(p, inv)
    cover = torch.tensor(block_map._COVER, dtype=v.dtype, device=v.device)
    bc = ((v - 1) >> 1)[:, None, :] + cover[None]
    slots, match, _ = block_map._probe_blocks(m, bc.reshape(-1, 3), probes)
    first = torch.where(match.any(-1), match.int().argmax(-1), probes - 1)
    probed = slots[torch.arange(probes, device=p.device)[None, :] <= first[:, None]]
    loc = torch.arange(8, device=v.device, dtype=v.dtype)
    w = 2 * cover[:, None, :] + torch.stack([loc >> 2, (loc >> 1) & 1, loc & 1], -1)[None]
    sten = ((w[None] - (2 - (v & 1))[:, None, None, :]).abs() <= 1).all(-1)
    return block_map.find_block_slots(m, bc, probes), sten, probed


def refine_cost(torch, args) -> tuple:
    """(bytes, operations, iterations) of one plane_map_gn_rounds call. The
    bytes: each input read once, as far as this call's data needs it at its
    start pose (the mask, the 12-byte source rows that are unmasked, the
    8-byte fingerprints the windows probe, the x, y and z of each stencil
    voxel of a found block, 12 S bytes), the carry read and written. The
    operations: each iteration's rows, cover blocks, stencil lanes of found
    blocks and rows with five points within the gate, counted at the pose of
    each iteration of the plain version with the kernel's select
    (`exact_select`), so over the kernel's iterations."""
    from funny_lidar_slam_torch.maps import block_map
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.registration import residuals

    carry, src, mask, m, inv, thresh, max_d2, _, _, stencil, probes = args
    s = m.bucket_size
    p = residuals._transform_fixed(gn_loop.result_views(carry).t_mat, src)[mask]
    found, sten, probed = refine_lookup(torch, m, p, inv, probes)
    hit = sten & (found >= 0)[:, :, None]
    pairs = torch.unique((found[:, :, None] * 8 + torch.arange(8, device=p.device))[hit])
    rows = int(mask.sum())
    nbytes = (src.shape[0] + 12 * rows + 8 * int(torch.unique(probed).numel())
              + 12 * s * int(pairs.numel()) + 4 * (2 * gn_loop.CARRY_SIZE + 1))
    counts, hg = [], gn_loop.point_to_plane_hg

    def counted(t_mat, src, src_mask, m, inv, thresh, max_d2, stencil="nearby26",
                num_probes=8):
        """The plain version's linearization, once an iteration: (its
        stencil lanes of found blocks, its rows with five points)."""
        q = residuals._transform_fixed(t_mat, src)[src_mask]
        f, st, _ = refine_lookup(torch, m, q, inv, num_probes)
        _, d2, _ = block_map.query_knn(m, q, inv, k=5, num_probes=num_probes)
        counts.append((int((st & (f >= 0)[:, :, None]).sum()) * s,
                       int((d2[:, 4] <= max_d2).sum())))
        return hg(t_mat, src, src_mask, m, inv, thresh, max_d2, stencil, num_probes)

    gn_loop.point_to_plane_hg = counted
    try:
        with exact_select():
            gn_loop.plane_map_gn_rounds_plain(carry.clone(), *args[1:])
    finally:
        gn_loop.point_to_plane_hg = hg
    ops = sum(rows * (REFINE_ROW_OPS + 8 * REFINE_BLOCK_OPS) + lanes * REFINE_LANE_OPS
              + planes * REFINE_PLANE_OPS for lanes, planes in counts)
    return nbytes, ops, len(counts)


class exact_select:
    """While active, `select.fused_select` is a plain k-nearest select: the
    cover row's lanes' d2 as fused_select_plain takes them, the stencil,
    then the k nearest by a stable sort, ties to the lower lane (lax.top_k's
    order, the JAX package's on the CPU, which plane_map_gn_kernel
    repeats). The fused_select kernel orders lanes by d2 (1 + 2e-7 j) +
    1e-30 j (the TPU kernel's key), so where two d2 lie within ~1e-4
    relative it may take another k-th: on the figure-8's first refine one
    row of 3,715 parted so (chip call 2). Phase 25 holds the refine kernel
    to its plain version with this select."""

    def __enter__(self):
        import torch

        from funny_lidar_slam_torch.ops import select

        self.saved = select.fused_select

        def exact(cand_tab, gid, qpts, k, plane, stencil="nearby26", qvox=None):
            wnd = cand_tab[gid.to(torch.int64).clamp(0, cand_tab.shape[0] - 1)]
            x, y, z = select._planes(wnd, plane)
            d2 = ((x - qpts[:, 0:1]) ** 2 + (y - qpts[:, 1:2]) ** 2
                  + (z - qpts[:, 2:3]) ** 2)
            d2 = torch.where(select._stencil_mask(d2.shape[1], qvox, plane, stencil), d2,
                             torch.full_like(d2, float("inf")))
            kd2, idx = torch.sort(d2, dim=1, stable=True)
            idx = idx[:, :k]
            return (kd2[:, :k], *(torch.gather(v, 1, idx) for v in (x, y, z)))

        exact.launches = 0
        select.fused_select = exact
        return self

    def __exit__(self, *exc):
        from funny_lidar_slam_torch.ops import select

        select.fused_select = self.saved


def refine_compare(torch, args) -> dict:
    """plane_map_gn_rounds against its plain version on one call, the plain
    version's 5 nearest taken in the kernel's order (`exact_select`):
    `gn_compare` (the float64-sums run first where the float32 runs part);
    where the counters still part, each iteration from the kernel's pose,
    its stall and convergence tests included
    (`stepwise_compare(stall=True)`). `held` says whether the call passed."""
    kind = "plane_map_gn_rounds"
    with exact_select():
        r = gn_compare(torch, args, kind)
        if not r["same"]:
            r["stepwise"] = stepwise_compare(torch, args, r, kind, stall=True)
    r["held"] = r["close"] if r["same"] else r["stepwise"]["held"]
    return r


def room_points() -> np.ndarray:
    """tests/test_backend.py's room: three orthogonal 12 m planes of 0.2 m
    spacing, offset by (2, 3, 4)."""
    g = np.arange(0.1, 12.0, 0.2, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    pts = np.concatenate([
        np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], 1),
        np.stack([xx.ravel(), np.zeros(xx.size), yy.ravel()], 1),
        np.stack([np.zeros(xx.size), xx.ravel(), yy.ravel()], 1),
    ]).astype(np.float32) + np.float32([2, 3, 4])
    return pts


def refine_room(torch, shift, device="cuda") -> tuple:
    """The CPU tests' drifted room on the card (tests/test_torch_refine_gn_loop.py,
    tests/test_torch_backend.py::drifted_room): the room in the world frame
    as the target of a block map (8,192 voxels, buckets of 8), the same room
    in the frame of the true pose (0.05 rad about z, (1, 0.5, 0.2) m) as the
    source, both padded to 10,880 rows; the refine's arguments from the true
    pose moved by `shift` m."""
    from funny_lidar_slam_torch.maps import block_map
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.registration import gn

    world = room_points()
    c, s_ = np.cos(0.05), np.sin(0.05)
    true = np.eye(4)
    true[:3, :3] = [[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]]
    true[:3, 3] = [1.0, 0.5, 0.2]
    inv_t = np.linalg.inv(true)
    local = (world @ inv_t[:3, :3].T + inv_t[:3, 3]).astype(np.float32)
    start = true.copy()
    start[:3, 3] += shift

    def padded(pts):
        out = torch.zeros((10880, 3), dtype=torch.float32, device=device)
        out[:len(pts)] = torch.from_numpy(pts).to(device)
        return out, torch.arange(10880, device=device) < len(pts)

    tgt, tmask = padded(world)
    src, mask = padded(local)
    m = block_map.build(8192, 8, tgt, tmask, 1.0)
    cfg = gn.GNConfig(max_iters=20, rotation_eps=1e-4, position_eps=1e-4, update=gn.UPDATE_LOAM,
                      use_stall_check=True)
    carry = gn_loop.init_carry(torch.tensor(start, dtype=torch.float32, device=device))
    return carry, src, mask, m, 1.0, 0.3, 4.0, None, cfg, "nearby26", 8


def refine_edge_cases(torch, args, device="cuda") -> list:
    """[(name, args)]: the CPU tests' drifted room (its start pose puts
    every point at z = 5.0, a voxel face, in exact arithmetic) and the room
    moved (0.9, 0.9, 0.9) m from the true pose instead (x, y and z on faces);
    then on the figure-8's first refine call: a starved call (min_valid
    above its rows), every row masked, a start pose 1 km away (every cover
    block missed) and max_iters 1."""
    from funny_lidar_slam_torch.ops import gn_loop

    carry, src, mask, m, *tail = args
    cfg = tail[4]
    far = gn_loop.result_views(carry).t_mat.clone()
    far[:3, 3] += 1000.0
    return [("plane_map_gn_rounds drifted room", refine_room(torch, (0.6, -0.4, 0.1), device)),
            ("plane_map_gn_rounds room on voxel faces",
             refine_room(torch, (0.9, 0.9, 0.9), device)),
            ("plane_map_gn_rounds starved",
             (carry, src, mask, m, *tail[:4], cfg._replace(min_valid=int(mask.sum()) + 1),
              *tail[5:])),
            ("plane_map_gn_rounds every row masked",
             (carry, src, torch.zeros_like(mask), m, *tail)),
            ("plane_map_gn_rounds every block missed",
             (gn_loop.init_carry(far), src, mask, m, *tail)),
            ("plane_map_gn_rounds max_iters 1",
             (carry, src, mask, m, *tail[:4], cfg._replace(max_iters=1), *tail[5:]))]


def on_faces(torch, args) -> int:
    """The unmasked rows of a refine call whose point at the start pose
    (taken as the kernel takes it) lies on a voxel face on some axis."""
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.registration import residuals

    carry, src, mask, m, inv = args[:5]
    p = residuals._transform_fixed(gn_loop.result_views(carry).t_mat, src)[mask] * inv
    return int((p == torch.floor(p)).any(-1).sum())


def refine_timing(torch, args, label) -> dict:
    """plane_map_gn_rounds on one call timed in turns (`gn_turns`: kernel,
    plain, host loop, floor, floor, host loop, plain, kernel) beside its
    plain version, the host-loop route the port took before (`run_gn` over
    point_to_plane_hg, one read an iteration) and one empty launch; with
    the call's bound (`refine_cost`)."""
    from funny_lidar_slam_torch.ops import gn_loop
    from funny_lidar_slam_torch.registration import gn, residuals

    carry, src, mask, m, inv, thresh, max_d2, _, cfg, stencil, probes = args
    t0 = gn_loop.result_views(carry).t_mat.clone()

    def host_loop():
        return gn.run_gn(lambda t: residuals.point_to_plane_hg(t, src, mask, m, inv, thresh,
                                                               max_d2, stencil, probes),
                         t0, cfg)

    turns, ms = gn_turns(torch, args, "plane_map_gn_rounds", {"host_loop": (host_loop, 3)})
    nbytes, ops, its = refine_cost(torch, args)
    # each route's own iterations: the plain version and the host loop select
    # through the fused_select kernel, whose key can end the loop elsewhere
    routes = {"kernel": gn_loop.plane_map_gn_rounds, "plain": gn_loop.plane_map_gn_rounds_plain}
    its_of = {}
    for name, fn in routes.items():
        c = carry.clone()
        fn(c, *args[1:])
        its_of[name] = int(c[gn_loop.OFFSET["it"]])
    its_of["host_loop"] = int(host_loop().iters)
    assert its_of["kernel"] == its, f"[refine-gn] the bound counted {its} iterations: {its_of}"
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    out = {"ms": ms["kernel"], "plain_ms": ms["plain"], "host_loop_ms": ms["host_loop"],
           "floor_ms": ms["floor"], "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "n": src.shape[0], "rows": int(mask.sum()), "capacity": m.fp.shape[0],
           "iterations": its_of, "bytes": nbytes, "ops": ops,
           **{f"{k}_ms_per_iteration": ms[k] / max(n, 1) for k, n in its_of.items()},
           "turns": turns, "vs_host_loop": versus(turns["kernel"], turns["host_loop"])}
    log(f"[refine-gn] plane_map_gn_rounds at the {label} shape (N {out['n']}, {out['rows']} "
        f"rows, Cb {out['capacity']}, iterations {its_of}): kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.2f} ms, host loop {out['host_loop_ms']:.2f} ms, empty launch "
        f"{out['floor_ms']:.5f} ms, bound {out['bound_ms']:.6f} ms ({out['bound_by']}); "
        f"turns {turns}")
    return out


def phase_refine_gn(torch, report) -> dict:
    """Phase 25: plane_map_gn_rounds (csrc/gn_loop.cu `plane_map_gn_kernel`,
    one thread block cluster of R blocks a call, the loop closure's whole
    point-to-plane refine with the block map's 5-NN lookup inside every
    iteration) against its plain version (its 5 nearest in the kernel's
    order, `exact_select`) on every refine call of phase 13's figure-8 run
    and of its cascade replay (`refine_compare`: the
    pose within 1e-4 m and 1e-5 rad of the plain version's or of its
    float64-sums run, num_valid within 1 %, total_res within 1e-3; where
    the counters part, each iteration from the kernel's pose with its stall
    and convergence tests), every call DONE with as many gathers as
    iterations, its pose finite and within 0.05 m, and launched twice
    bit-equal; the launches while capturing equal to the calls captured;
    R >= 8 with the rows a rank; no ptxas spills. Then the edge cases of
    `refine_edge_cases` with the same gates (every row masked and every
    block missed: num_valid 0 and the pose unchanged); the launch under
    set_sync_debug_mode("error"); the kernel timed at the figure-8 shape (its
    first refine call) beside its plain version, the host-loop route and
    one empty launch, with its bound, and rank 0's stage clocks there.
    Returns the JSON entry."""
    from funny_lidar_slam_torch.ops import cuda_build, gn_loop

    t_phase = time.perf_counter()
    kind = "plane_map_gn_rounds"
    resources = {k: v for k, v in report.get("gn_loop", {}).items()
                 if k.startswith("plane_map_gn_kernel")}
    assert list(resources) == ["plane_map_gn_kernel"], f"[refine-gn] ptxas {sorted(resources)}"
    res = resources["plane_map_gn_kernel"]
    assert res["registers"] and res["spill_stores"] == 0 and res["spill_loads"] == 0, \
        f"[refine-gn] plane_map_gn_kernel spills: {res}"
    blocks = gn_loop.cluster_blocks(kind)
    assert blocks >= 8, blocks
    log(f"[refine-gn] plane_map_gn_kernel launches one cluster of R = {blocks} blocks; ptxas "
        f"{resources}")
    saved = gn_loop.plane_map_gn_rounds.launches  # comparisons do not count
    by_key, rows_all = {}, []
    for key in REFINE_PATHS:
        calls = REFINE_CAPTURES.get(key, [])
        assert calls and REFINE_CAPTURE_LAUNCHES[key] == len(calls), \
            f"[refine-gn] {key}: {len(calls)} calls captured, " \
            f"{REFINE_CAPTURE_LAUNCHES.get(key)} launched"
        rows = [refine_compare(torch, args) for args in calls]
        rows_all += rows
        bad = [i for i, r in enumerate(rows) if not r["held"] or not r["finite"]
               or r["dp"] > 0.05 or not one_call(r)]
        summary = {"calls": len(rows), "same_share": sum(r["same"] for r in rows) / len(rows),
                   "iterations": [r["iterations"] for r in rows],
                   "held_to_float64": [{k: r[k] for k in ("dp", "da", "dp64", "da64",
                                                          "plain_dp64", "plain_da64")}
                                       for r in rows if "dp64" in r],
                   "held_step_by_step": [r["stepwise"] for r in rows if "stepwise" in r],
                   **{f: [float(np.quantile([r[f] for r in rows], q)) for q in (0.5, 1)]
                      for f in ("dp", "da", "nv_rel", "res_rel")},
                   "differing": [{k: r[k] for k in ("status", "it", "gathers", "dp", "da")}
                                 for r in rows if not r["same"]]}
        summary["bit_equal"] = bit_equal_replays(torch, kind, calls)
        by_key[key] = summary
        log(f"[refine-gn] {key}: " + json.dumps(summary))
        assert not bad, f"[refine-gn] {key}: calls {bad} out of tolerance: " \
            f"{[{k: v for k, v in rows[i].items() if k not in ('t_k', 't_p')} for i in bad[:3]]}"
    args = REFINE_CAPTURES["figure8"][0]  # the figure-8 shape: its first refine
    edge = {}
    for name, eargs in refine_edge_cases(torch, args):
        r = refine_compare(torch, eargs)
        edge[name] = {k: r[k] for k in ("status", "it", "gathers", "dp", "da", "nv_rel",
                                        "res_rel", "same", "held", "dp64", "da64", "stepwise")
                      if k in r}
        edge[name].update(rows=int(eargs[2].sum()), on_faces=on_faces(torch, eargs),
                          num_valid=r["carry_k"][6],  # it, gathers, ..., num_valid, status
                          bit_equal=bit_equal_replays(torch, kind, [eargs]))
        assert r["held"] and r["finite"] and one_call(r), f"[refine-gn] edge case {name}: " \
            f"{ {k: v for k, v in r.items() if k not in ('t_k', 't_p')} }"
    for name in ("plane_map_gn_rounds every row masked", "plane_map_gn_rounds every block missed"):
        e = edge[name]
        assert e["dp"] == 0.0 and e["da"] == 0.0 and e["num_valid"] == 0, f"[refine-gn] {name}: {e}"
    assert edge["plane_map_gn_rounds max_iters 1"]["it"] == (1, 1)
    assert edge["plane_map_gn_rounds room on voxel faces"]["on_faces"] > 100, edge
    log(f"[refine-gn] {len(edge)} edge cases held: {json.dumps(edge)}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gn_loop.plane_map_gn_rounds(args[0].clone(), *args[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[refine-gn] plane_map_gn_rounds ran under set_sync_debug_mode('error')")
    n_rows = args[1].shape[0]
    split = gn_loop.rank_rows(n_rows, blocks)
    assert sum(split) == n_rows, f"[refine-gn] the ranks take {split} of {n_rows} rows"
    head = refine_timing(torch, args, "figure-8 (its first refine)")
    cycles = gn_stage_cycles(torch, cuda_build.variant(*STAGED_GN), kind, args)
    head["stage_cycles_per_iteration"] = cycles
    head["rows_share"] = cycles["rows"] / max(sum(cycles.values()), 1.0)
    log(f"[refine-gn] SM cycles an iteration by stage {json.dumps(cycles)}; thread 0's rows "
        f"{head['rows_share']:.3f} of the iteration")
    gn_loop.plane_map_gn_rounds.launches = saved
    log(f"[refine-gn] phase 25 took {time.perf_counter() - t_phase:.1f} s")
    held64 = [r for r in rows_all if "dp64" in r]
    by_path = {p: v[kind] for p, v in GN_LAUNCHES_BY_KERNEL.items() if v.get(kind)}
    return {"name": kind, "route": "cuda", "source": REFINE_SOURCE[0],
            "replaces": REFINE_SOURCE[1], "launches": sum(by_path.values()),
            "max_abs_err": max(r["dp"] for r in rows_all),
            "max_rot_err_rad": max(r["da"] for r in rows_all),
            "held_to_float64": len(held64),
            "held_step_by_step": sum("stepwise" in r for r in rows_all),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
                                    "host_loop_ms")},
            "library_ms": None, "shapes": {"figure8": head}, "launches_by_path": by_path,
            "calls_compared": len(rows_all), "by_path": by_key, "edge_cases": edge,
            "cluster_blocks": blocks,
            "rows_per_rank": {"rows": n_rows, "max": max(split), "min": min(split)},
            "resources": resources}


def main() -> int:
    import torch

    card = phase_device(torch)
    sys.path.insert(0, HERE)
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate

    report = phase_build()
    count_gn_callers()
    count_feature_calls()
    count_host_loops()
    entry = phase_kernels(torch)
    from funny_lidar_slam_torch.ops import select

    entry["resources"] = select_resources(select, report.get("fused_select", {}))
    probe_entries = phase_probes(torch)
    t = time.perf_counter()
    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))
    log(f"[sim] simulated {len(ds.scans)} scans in {time.perf_counter() - t:.1f} s")
    hashed = phase_hashed_select(torch, ds)
    loam = phase_loam_select(torch, ds)
    by_path, paths = {}, {}
    by_path["grid_mapping"], grid = phase_e2e(torch, ds)
    by_path["hashed_mapping"] = phase_hashed_mapping(torch, ds)[0]
    by_path["localization"] = phase_localization(torch, ds)[0]
    for mode in bench.LOAM_MODES:
        by_path[mode], paths[mode] = phase_loam_mapping(torch, ds, mode)
    by_path["ndt_mapping"], paths["ndt_mapping"] = phase_ndt_mapping(torch, ds)
    by_path["kf_mapping"], paths["kf_mapping"] = phase_kf_mapping(
        torch, ds, grid["phase_ms_per_scan"])
    for mode in bench.LOAM_MODES + ("IncrementalNDT",):
        key = f"localization_{mode}"
        by_path[key], paths[key] = phase_localization(torch, ds, mode)
    fig8_slam, by_path["figure8_loopclosure"], fig8 = phase_figure8(torch)
    paths["figure8_loopclosure"] = fig8
    by_path["resume"], paths["resume"] = phase_resume_and_map(torch, ds, fig8_slam)
    del fig8_slam
    cli_by_path, cli_paths, cli_sel = phase_cli(torch)
    by_path.update(cli_by_path)
    paths.update(cli_paths)
    md_by_path, paths["multidevice"], md_sel = phase_multidevice(torch)
    by_path.update(md_by_path)
    t = time.perf_counter()
    paths["frontend_step_unpacked"], step_sel = phase_unpacked_step(torch, ds)
    by_path["frontend_step_unpacked"] = paths["frontend_step_unpacked"]["fused_select_launches"]
    by_path["profile_frontend"], paths["profile_frontend"] = phase_profile_frontend(torch)
    log(f"[phase17] took {time.perf_counter() - t:.1f} s")
    by_path["bench_headline"], paths["bench_headline"] = phase_bench(torch)
    feature_entry = phase_loam_features(torch, report)  # phase 23: 7-9, 12a-c and 15a's captures
    loop_entries = phase_device_loops(torch, report)
    gn_entry = phase_gn_loop(torch, report)
    loam_gn_entries = phase_loam_gn(torch, report)
    ndt_gn_entry = phase_ndt_gn(torch, report)
    pose_graph_entry = phase_pose_graph(torch, report)
    refine_entry = phase_refine_gn(torch, report)
    summary = ("ate_m", "rpe_m", "steady_fps", "wall_s", "tracked", "gathers_per_scan",
               "keyframes_with_features", "kf_ate_m", "loops_accepted", "verifications",
               "verify_ms_median", "verify_ms_max", "optimize_ms",
               "fused_select_launches_in_verifications", "resume_jump_m", "map_points",
               "save_map_ms", "frames", "bag_write_s", "bag_read_s", "preprocess_ms_per_scan",
               "gn_host_reads_per_scan", "gn_iterations_per_scan", "verify_gn_host_reads",
               "1rank", "4rank", "pose_4rank_vs_1rank", "pose_4rank_vs_1rank_dryrun_map",
               "nccl_allreduce_ms", "gloo_allreduce_ms", "pose_max_diff_m",
               "rot_max_diff_rad", "packed_ms_per_scan", "unpacked_ms_per_scan",
               "unpacked_minus_packed_ms", "unpacked_vs_packed", "launch_calls",
               "copy_calls", "sync_calls",
               "full_step_ms", "step_packed_device_ms", "est_fps_full_step", "fps",
               "excluded_deltas", "bench_wall_s")
    entry["max_abs_err"] = max(entry["max_abs_err"], hashed["max_abs_err"], loam["max_abs_err"],
                               fig8["select"]["max_abs_err"], cli_sel["max_abs_err"],
                               step_sel["max_abs_err"],
                               *(v["max_abs_err"] for v in md_sel.values()))
    entry.update(launches=sum(by_path.values()), launches_by_path=by_path,
                 hashed_inputs={k: hashed[k] for k in ("all_miss_rows", "cover_rows",
                                                       "missed_blocks")},
                 shapes={**hashed["shapes"], **loam["shapes"], **fig8["select"]["shapes"],
                         **cli_sel["shapes"], **step_sel["shapes"],
                         **{k: v["shape"] for k, v in md_sel.items()}},
                 loam_brute_force_rows=loam["brute_force_rows"],
                 loop_brute_force_rows=fig8["select"]["brute_force_rows"],
                 cli_brute_force_rows=cli_sel["brute_force_rows"],
                 unpacked_step_brute_force_rows=step_sel["brute_force_rows"],
                 paths={p: {k: r[k] for k in summary if k in r} for p, r in paths.items()})
    entry["k_sweep"]["hashed"] = hashed["k_sweep"]
    print(json.dumps({"kernels": [entry] + probe_entries + loop_entries + [gn_entry]
                      + loam_gn_entries + [ndt_gn_entry, feature_entry, pose_graph_entry,
                                           refine_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
