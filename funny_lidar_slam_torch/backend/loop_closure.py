"""Euclidean-distance loop closure with coarse-to-fine verification on the
device (port of backend/loop_closure.py).

  detection (`detect_by_distance`, NumPy): throttled while fewer than
    `skip_near_loopclosure` keyframes passed since the last loop; the
    candidate is the closest keyframe within `near_neighbor_distance` whose
    index gap exceeds `skip_near_keyframe`;
  submaps (`_merge_submap`): the candidate's neighbours merged in the world
    frame, the current keyframe and its predecessors in the current
    keyframe's frame;
  verification (`_verify_cascade`): voxel filters, a block map of the
    target, NDT at each resolution, then a point-to-plane refine, each
    stage kept only where it improves the fitness; accepted below
    `fitness_threshold`.

Port notes: the JAX package runs the cascade as one cached executable
(`aot_jit`); here it is a plain call. Each NDT stage's GN loop runs in one
kernel launch with one host read (`run_gn_ndt`), and so does the
point-to-plane refine, its block-map 5-NN lookup inside every iteration
(`run_gn_plane_map`). The keyframe clouds of both submaps are
fetched with one copy (`materialize_batch`), and an over-capacity submap is
pre-filtered on the host by the C++ voxel filter (`native`), as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..maps import block_map, ndt_map
from ..native import voxel_downsample as host_voxel
from ..ops.voxel import voxel_downsample
from ..pipeline.keyframes import materialize_batch
from ..registration.gn import UPDATE_LOAM, UPDATE_NDT, GNConfig, run_gn_ndt, run_gn_plane_map
from ..registration.residuals import fitness_score


@dataclass
class LoopClosureConfig:
    skip_near_loopclosure: int = 100
    skip_near_keyframe: int = 100
    near_neighbor_distance: float = 10.0
    candidate_left: int = 20  # candidate submap range
    candidate_right: int = 20
    current_left: int = 30
    fitness_threshold: float = 1.5
    fitness_max_range: float = 2.0  # max correspondence distance of the fitness
    nn_voxel_size: float = 1.0
    submap_filter_size: float = 0.2
    submap_capacity: int = 65536
    source_capacity: int = 16384
    map_capacity: int = 131072
    bucket_size: int = 8
    ndt_resolutions: tuple = (10.0, 5.0, 3.0, 2.0)
    refine_iterations: int = 20


@dataclass
class LoopResult:
    current_id: int
    candidate_id: int
    delta_pose: np.ndarray  # T_cand^-1 T_corrected_current
    fitness: float


def detect_by_distance(poses: np.ndarray, current_id: int, last_loop_id: int,
                       cfg: LoopClosureConfig) -> int | None:
    """Vectorized candidate search."""
    if current_id - last_loop_id < cfg.skip_near_loopclosure:
        return None
    if current_id < cfg.skip_near_keyframe:
        return None
    cur = poses[current_id][:3, 3]
    d = np.linalg.norm(poses[: current_id + 1, :3, 3] - cur, axis=1)
    for idx in np.argsort(d):
        if d[idx] > cfg.near_neighbor_distance:
            break
        if current_id - idx > cfg.skip_near_keyframe:
            return int(idx)
    return None


def _merge_submap(frames, ids, poses, local_frame_of: int | None, cfg: LoopClosureConfig,
                  capacity: int):
    """Merge keyframe clouds over `ids`, in the world frame, or local to
    keyframe `local_frame_of` when given. Returns a padded (points
    [capacity, 3], mask [capacity]) NumPy pair; an over-capacity merge is
    voxel-filtered on the host at growing sizes until it fits (never a
    random subsample, which would bias the NDT statistics)."""
    inv_ref = np.linalg.inv(poses[local_frame_of]) if local_frame_of is not None else np.eye(4)
    pts = []
    for i in ids:
        t = inv_ref @ poses[i]
        pts.append(frames[i].cloud @ t[:3, :3].T + t[:3, 3])
    merged = np.concatenate(pts).astype(np.float32)
    size = cfg.submap_filter_size
    while len(merged) > capacity:
        merged = host_voxel(merged, size)
        size *= 1.5
    out = np.zeros((capacity, 3), np.float32)
    msk = np.zeros(capacity, bool)
    out[: len(merged)] = merged
    msk[: len(merged)] = True
    return out, msk


def _verify_cascade(cfg: LoopClosureConfig, src_pts, src_mask, tgt_pts, tgt_mask, t_init):
    """The device half of the verification: voxel filters -> block map ->
    coarse-to-fine NDT -> point-to-plane refine -> fitness. Unlike the
    reference's open-loop cascade, each stage's pose is kept only where it
    improves the fitness (`torch.where`, no host read), so a diverging
    coarse stage cannot destroy a good initial guess. Returns (best pose
    [4, 4], its fitness [])."""
    nn_inv = 1.0 / cfg.nn_voxel_size
    tgt = voxel_downsample(tgt_pts, tgt_mask, cfg.submap_filter_size, cfg.submap_capacity)
    src = voxel_downsample(src_pts, src_mask, cfg.submap_filter_size, cfg.source_capacity)
    mp = block_map.build(cfg.map_capacity, cfg.bucket_size, tgt.points, tgt.mask, nn_inv)

    def fit_of(t):
        return fitness_score(t, src.points, src.mask, mp, nn_inv,
                             max_range_sq=cfg.fitness_max_range ** 2)

    best_t, best_fit = t_init, fit_of(t_init)
    t_est = t_init
    for res in cfg.ndt_resolutions:
        m = ndt_map.create(cfg.map_capacity, tgt.points.dtype, tgt.points.device)
        # a one-shot dense load: the full probe window of claim rounds
        m = ndt_map.insert(m, tgt.points, tgt.mask, 1.0 / res, min_points=3,
                           estimate_all=True, claim_rounds=8)
        gn = GNConfig(max_iters=cfg.refine_iterations, rotation_eps=1e-3, position_eps=1e-3,
                      update=UPDATE_NDT, use_stall_check=False)
        t_est = run_gn_ndt(src.points, src.mask, m, 1.0 / res, 30.0, t_est, gn).t_mat
        f = fit_of(t_est)
        better = f < best_fit
        best_t = torch.where(better, t_est, best_t)
        best_fit = torch.where(better, f, best_fit)

    # fine refine: point-to-plane (the GICP stand-in), from the best pose
    gn = GNConfig(max_iters=cfg.refine_iterations, rotation_eps=1e-4, position_eps=1e-4,
                  update=UPDATE_LOAM, use_stall_check=True)
    t_ref = run_gn_plane_map(src.points, src.mask, mp, nn_inv, 0.3, cfg.fitness_max_range ** 2,
                             best_t, gn).t_mat
    f = fit_of(t_ref)
    better = f < best_fit
    return torch.where(better, t_ref, best_t), torch.where(better, f, best_fit)


def verify_candidate(frames, poses: np.ndarray, current_id: int, candidate_id: int,
                     cfg: LoopClosureConfig, device=None) -> LoopResult | None:
    """Coarse-to-fine registration of the current submap against the
    candidate submap on `device` (default: CUDA)."""
    dev = resolve_device(device)
    n = len(frames)
    cand_ids = range(max(0, candidate_id - cfg.candidate_left),
                     min(n, candidate_id + cfg.candidate_right + 1))
    curr_ids = range(max(0, current_id - cfg.current_left), current_id + 1)
    materialize_batch([frames[i] for i in sorted(set(cand_ids) | set(curr_ids))])

    tgt_pts, tgt_mask = _merge_submap(frames, cand_ids, poses, None, cfg, cfg.submap_capacity)
    src_pts, src_mask = _merge_submap(frames, curr_ids, poses, current_id, cfg,
                                      cfg.source_capacity)
    best_t, best_fit = _verify_cascade(
        cfg, torch.from_numpy(src_pts).to(dev), torch.from_numpy(src_mask).to(dev),
        torch.from_numpy(tgt_pts).to(dev), torch.from_numpy(tgt_mask).to(dev),
        torch.as_tensor(poses[current_id], dtype=torch.float32, device=dev))

    fit = float(best_fit)
    if not np.isfinite(fit) or fit >= cfg.fitness_threshold:
        return None
    delta = np.linalg.inv(poses[candidate_id]) @ best_t.cpu().numpy()
    return LoopResult(current_id=current_id, candidate_id=candidate_id, delta_pose=delta,
                      fitness=fit)


class LoopCloser:
    """Host-side loop closer, called per keyframe: throttles, detects, verifies
    on `device` (default: CUDA)."""

    def __init__(self, cfg: LoopClosureConfig = LoopClosureConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.last_loop_id = -(cfg.skip_near_loopclosure + 1)

    def try_close(self, frames, poses: np.ndarray, current_id: int) -> LoopResult | None:
        cand = detect_by_distance(poses, current_id, self.last_loop_id, self.cfg)
        if cand is None:
            return None
        result = verify_candidate(frames, poses, current_id, cand, self.cfg, self.device)
        if result is not None:
            self.last_loop_id = current_id
        return result
