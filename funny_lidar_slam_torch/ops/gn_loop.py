"""The Gauss-Newton loops over cached candidates as hand-written CUDA
kernels (the counterparts of the JAX package's `lax.while_loop` in
registration/gn.py::run_gn_corr), one for each linearization a matcher
iterates on its candidates:

  * `icp_gn_rounds`   (IcpMatcher: `point_to_point_hg_cand`, the ICP update)
    -> csrc/gn_loop.cu `icp_gn_launch`;
  * `plane_gn_rounds` (PointToPlaneMatcher: `point_to_plane_hg_cand`, the
    LOAM update) -> `plane_gn_launch`;
  * `loam_gn_rounds`  (LoamFullMatcher: `point_to_line_hg_cand` on the
    corner set plus `point_to_plane_hg_cand` on the planar set, summed, with
    the planar count as `num_valid`; the LOAM update) -> `loam_gn_launch`;
  * `ndt_gn_rounds`   (NdtMatcher and the loop closure's NDT stages:
    `ndt_corr` + `ndt_hg_corr`, the stencil lookup in the NDT map inside
    every iteration, the NDT update) -> `ndt_gn_launch`;
  * `plane_map_gn_rounds` (the loop closure's point-to-plane refine:
    `point_to_plane_hg`, the block map's 5-NN lookup inside every
    iteration, the LOAM update) -> `plane_map_gn_launch`;

each one launch a call for CUDA tensors (one thread block cluster,
`cluster_blocks`), and its plain version (`*_plain`: the same iterations in plain PyTorch, reading its
flags on the host) for CPU tensors.

A call runs the loop body from the carry, on the candidate set(s) the
caller has just gathered at the carry's pose, until the loop ends (`DONE`)
or the next iteration would need a fresh gather (`NEED_GATHER`); it writes
the carry back in place, the status word included. The caller
(registration/gn.py's round drivers) gathers, calls, and reads the status
word: one host read a gather round instead of one an iteration. NDT and
the refine regather every iteration and their calls make each gather
themselves, so one call runs the whole loop (status `DONE`): one host read
a match or a refine.

Update conventions (the kernel's U_* enum; `GNConfig.update`):
  UPDATE_ICP:  dx = [t, r]; P += dt; R := R Exp(dr)
  UPDATE_LOAM: dx = [r, t]; R := Exp(dr) R; P += dt
  UPDATE_NDT:  dx = [r, t]; R := R Exp(dr); P += dt

The carry is one int32 buffer; its float fields are read through a float32
view of the same storage (`carry.view(torch.float32)`), and `result_views`
returns the loop's outputs as views of it, with no copy. Layout (32-bit
words, mirrored by the `C_*` enum of csrc/gn_loop.cu):
  t_mat[16] (f32, 4x4 row-major) t_gather[16] (f32) last_rot last_pos
  total_res (f32) it gathers since_gather force_gather done converged
  num_valid status (int32)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.lie import so3_exp
from ..maps.voxel_hash import PROBE_WINDOW
from ..registration.residuals import (
    CandSet,
    merge_hg,
    ndt_hg,
    point_to_line_hg_cand,
    point_to_plane_hg,
    point_to_plane_hg_cand,
    point_to_point_hg_cand,
)
from . import cuda_build
from .lin3 import solve6_damped

F32, I32 = torch.float32, torch.int32

# (field, words, dtype) in buffer order
CARRY = (("t_mat", 16, F32), ("t_gather", 16, F32), ("last_rot", 1, F32),
         ("last_pos", 1, F32), ("total_res", 1, F32), ("it", 1, I32), ("gathers", 1, I32),
         ("since_gather", 1, I32), ("force_gather", 1, I32), ("done", 1, I32),
         ("converged", 1, I32), ("num_valid", 1, I32), ("status", 1, I32))
OFFSET = {f: int(o) for (f, _, _), o in zip(CARRY, np.cumsum([0] + [n for _, n, _ in CARRY]))}
CARRY_SIZE = int(sum(n for _, n, _ in CARRY))
# status words (the kernel's S_* enum); 0 until a call has run
NEED_GATHER, DONE = 1, 2
# update conventions (the kernel's U_* enum), by GNConfig.update
UPDATE_ICP, UPDATE_LOAM, UPDATE_NDT = 0, 1, 2
# csrc/gn_loop.cu's G_* enum: the wrapper whose cluster `cluster_blocks` asks for
CLUSTER_KIND = {"icp_gn_rounds": 0, "plane_gn_rounds": 1, "loam_gn_rounds": 2,
                "ndt_gn_rounds": 3, "plane_map_gn_rounds": 4}
BIG = 1e9  # last_rot / last_pos before the first exact iteration


class LoopResult(NamedTuple):
    """The loop's outputs, views of the carry (GNResult's fields)."""

    t_mat: torch.Tensor  # [4, 4] float32
    converged: torch.Tensor  # [] bool (the low byte of the int32 word)
    iters: torch.Tensor  # [] int32 gathers
    num_valid: torch.Tensor  # [] int32
    total_res: torch.Tensor  # [] float32


def init_carry(t0: torch.Tensor) -> torch.Tensor:
    """A new carry at pose `t0` on t0's device: t_mat = t_gather = t0,
    last_rot = last_pos = 1e9, every counter and flag 0. Filled on the
    device (no host copy)."""
    carry = torch.zeros(CARRY_SIZE, dtype=I32, device=t0.device)
    f = carry.view(F32)
    f[:32].view(2, 16).copy_(t0.reshape(1, 16).expand(2, 16))
    f[OFFSET["last_rot"]:OFFSET["last_pos"] + 1].fill_(BIG)
    return carry


def _word(carry: torch.Tensor, field: str) -> torch.Tensor:
    return carry[OFFSET[field]]


def result_views(carry: torch.Tensor) -> LoopResult:
    """The loop's outputs as views of the carry (no copy)."""
    f, o = carry.view(F32), OFFSET
    return LoopResult(
        t_mat=f[o["t_mat"]:o["t_mat"] + 16].view(4, 4),
        converged=carry.view(torch.uint8)[4 * o["converged"]].view(torch.bool),
        iters=_word(carry, "gathers"), num_valid=_word(carry, "num_valid"),
        total_res=f[o["total_res"]])


def trust_region_moved(t_mat, t_gather, radius, dist) -> torch.Tensor:
    """Pose displacement since the gather beyond the trust region:
    translation + small-angle rotation scaled by the source radius
    (|dR - I|_F = 2 sqrt(2) sin(theta/2) ~= sqrt(2) theta)."""
    dt = torch.linalg.vector_norm(t_mat[:3, 3] - t_gather[:3, 3])
    dr = t_mat[:3, :3] @ t_gather[:3, :3].T
    eye = torch.eye(3, dtype=t_mat.dtype, device=t_mat.device)
    theta = torch.linalg.matrix_norm(dr - eye) / math.sqrt(2.0)
    return dt + theta * radius > dist


def _step(t_mat, dx, update):
    """The update of one iteration: (the new pose, |rotation part of dx|,
    |position part|)."""
    t_new = t_mat.clone()
    if update == UPDATE_ICP:
        t_new[:3, 3] += dx[:3]
        t_new[:3, :3] = t_mat[:3, :3] @ so3_exp(dx[3:])
        rot, pos = dx[3:], dx[:3]
    elif update == UPDATE_NDT:
        t_new[:3, :3] = t_mat[:3, :3] @ so3_exp(dx[:3])
        t_new[:3, 3] += dx[3:]
        rot, pos = dx[:3], dx[3:]
    else:
        t_new[:3, :3] = so3_exp(dx[:3]) @ t_mat[:3, :3]
        t_new[:3, 3] += dx[3:]
        rot, pos = dx[:3], dx[3:]
    return t_new, torch.linalg.vector_norm(rot), torch.linalg.vector_norm(pos)


def _rounds_plain(carry: torch.Tensor, hg_fn, radius: torch.Tensor, cfg, update: int,
                  dtype, inside: bool = False) -> torch.Tensor:
    """The JAX loop body (funny_lidar_slam_tpu/registration/gn.py:156-212)
    with `hg_fn(T) -> HG` on the candidates gathered at the carry's pose,
    from `carry` until the loop bound fails (DONE) or an iteration asks for a
    gather that has not been handed in (NEED_GATHER). Writes the carry in
    place and returns its status word (a view). Reads its flags on the
    host, one small copy an iteration. Computes in `dtype` (the
    candidates'): float32 on every path, float64 for a reference run. With
    `inside`, `hg_fn` makes each gather itself (NDT's lookup), so no
    iteration waits for one and the call runs to DONE."""
    f, o = carry.view(F32), OFFSET
    it, gathers, since, force, done, converged, num_valid = carry[o["it"]:o["status"]].tolist()
    t_mat = f[o["t_mat"]:o["t_mat"] + 16].view(4, 4).to(dtype, copy=True)
    t_gather = f[o["t_gather"]:o["t_gather"] + 16].view(4, 4).to(dtype, copy=True)
    last_rot, last_pos, total_res = (f[o[k]].to(dtype, copy=True)
                                     for k in ("last_rot", "last_pos", "total_res"))
    max_total = cfg.max_iters * max(int(cfg.corr_every), 1)
    skip = cfg.skip_regather_dist > 0.0
    fresh = True  # the gather handed in with this call, not yet used
    while True:
        if not (gathers < cfg.max_iters and it < max_total and not done):
            status = DONE
            break
        moved = bool(trust_region_moved(t_mat, t_gather, radius, cfg.skip_regather_dist)) \
            if skip else True
        want = since >= cfg.corr_every or force
        refresh = (want and moved) or it == 0
        if refresh and not fresh:
            status = NEED_GATHER
            break
        if refresh:
            t_gather, fresh = t_mat, inside
        hg = hg_fn(t_mat)
        t_new, rn, pn = _step(t_mat, solve6_damped(hg.h, hg.g), update)
        enough = hg.num_valid >= cfg.min_valid
        conv = (rn < cfg.rotation_eps) & (pn < cfg.position_eps) & enough
        exact = refresh or not moved
        if cfg.use_stall_check and exact:
            stall = ((torch.abs(rn - last_rot) < cfg.stall_eps)
                     & (torch.abs(pn - last_pos) < cfg.stall_eps))
        else:
            stall = torch.zeros((), dtype=torch.bool, device=rn.device)
        settled_h, conv_h = torch.stack([conv | stall, conv | (stall & enough)]).tolist()
        it += 1
        gathers += int(refresh)
        since = 1 if refresh else since + 1
        force = int(settled_h and not exact)
        done = int(settled_h and exact)
        converged = int(conv_h and exact)
        if exact:
            last_rot, last_pos = rn, pn
        t_mat, num_valid, total_res = t_new, hg.num_valid, hg.total_res
    f[o["t_mat"]:o["t_mat"] + 16] = t_mat.reshape(-1)
    f[o["t_gather"]:o["t_gather"] + 16] = t_gather.reshape(-1)
    f[o["last_rot"]], f[o["last_pos"]], f[o["total_res"]] = last_rot, last_pos, total_res
    carry[o["it"]:o["num_valid"]] = torch.tensor([it, gathers, since, force, done, converged],
                                                 dtype=I32, device=carry.device)
    carry[o["num_valid"]] = num_valid
    carry[o["status"]] = status
    return carry[o["status"]]


def icp_gn_rounds_plain(carry: torch.Tensor, cand: CandSet, radius: torch.Tensor, cfg,
                        max_corr_dist_sq: float) -> torch.Tensor:
    """`_rounds_plain` with the ICP update and `point_to_point_hg_cand`."""
    return _rounds_plain(carry, lambda t: point_to_point_hg_cand(t, cand, max_corr_dist_sq),
                         radius, cfg, UPDATE_ICP, cand.px.dtype)


def plane_gn_rounds_plain(carry: torch.Tensor, cand: CandSet, radius: torch.Tensor, cfg,
                          plane_thresh: float, max_search_dist_sq: float) -> torch.Tensor:
    """`_rounds_plain` with the LOAM update and `point_to_plane_hg_cand`."""
    return _rounds_plain(
        carry, lambda t: point_to_plane_hg_cand(t, cand, plane_thresh, max_search_dist_sq),
        radius, cfg, UPDATE_LOAM, cand.px.dtype)


def loam_hg_cand(t_mat, cand_corner: CandSet, cand_planar: CandSet, line_ratio_thresh,
                 plane_thresh, max_search_dist_sq):
    """LoamFull's linearization: the line rows of the corner set and the
    plane rows of the planar set summed into one H, g and residual sum,
    with the planar count alone as `num_valid` (the reference's convergence
    gate counts planar matches only)."""
    hg_c = point_to_line_hg_cand(t_mat, cand_corner, line_ratio_thresh, max_search_dist_sq)
    hg_p = point_to_plane_hg_cand(t_mat, cand_planar, plane_thresh, max_search_dist_sq)
    return merge_hg(hg_c, hg_p)._replace(num_valid=hg_p.num_valid)


def loam_gn_rounds_plain(carry: torch.Tensor, cand_corner: CandSet, cand_planar: CandSet,
                         radius: torch.Tensor, cfg, line_ratio_thresh: float,
                         plane_thresh: float, max_search_dist_sq: float) -> torch.Tensor:
    """`_rounds_plain` with the LOAM update and `loam_hg_cand`."""
    return _rounds_plain(
        carry, lambda t: loam_hg_cand(t, cand_corner, cand_planar, line_ratio_thresh,
                                      plane_thresh, max_search_dist_sq),
        radius, cfg, UPDATE_LOAM, cand_planar.px.dtype)


def ndt_gn_rounds_plain(carry: torch.Tensor, src: torch.Tensor, src_mask: torch.Tensor, m,
                        inv, outlier_thresh: float, radius, cfg,
                        num_probes: int = 8) -> torch.Tensor:
    """`_rounds_plain` with the NDT update and `ndt_hg` (the stencil lookup
    and the Mahalanobis rows) at every iteration's pose: one call runs the
    whole loop. `radius` is read only under a trust-region skip, which
    `ndt_gn_rounds` refuses."""
    return _rounds_plain(
        carry, lambda t: ndt_hg(t, src, src_mask, m, inv, outlier_thresh, num_probes),
        radius, cfg, UPDATE_NDT, src.dtype, inside=True)


def plane_map_gn_rounds_plain(carry: torch.Tensor, src: torch.Tensor, src_mask: torch.Tensor,
                              m, inv, plane_thresh: float, max_search_dist_sq: float, radius,
                              cfg, stencil: str = "nearby26", num_probes: int = 8) -> torch.Tensor:
    """`_rounds_plain` with the LOAM update and `point_to_plane_hg` (the
    block map's 5-NN gather, the plane fit and its gates) at every
    iteration's pose: one call runs the whole loop. `radius` is read only
    under a trust-region skip, which `plane_map_gn_rounds` refuses."""
    return _rounds_plain(
        carry, lambda t: point_to_plane_hg(t, src, src_mask, m, inv, plane_thresh,
                                           max_search_dist_sq, stencil, num_probes),
        radius, cfg, UPDATE_LOAM, src.dtype, inside=True)


def _checked(name: str, table: dict, note: str = "") -> list:
    """A kernel's tensor arguments, checked: `table` maps each, in the C
    entry point's order, to (tensor, dtype, shape); each of its dtype,
    contiguous and of its shape (`note` says what the shapes must share),
    then all on one CUDA device. Returns the tensors in order."""
    for key, (t, want, _) in table.items():
        if t.dtype != want:
            raise TypeError(f"{name}: the kernel takes {want} {key}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    for key, (t, _, shape) in table.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} of shape {tuple(t.shape)}, {shape} expected{note}")
    tensors = [t for t, _, _ in table.values()]
    if tensors[0].device.type != "cuda" or any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: the inputs must lie on one CUDA device")
    return tensors


def _checked_inputs(carry, cand: CandSet, radius, *more: CandSet,
                    name: str = "icp_gn_rounds") -> list:
    """`_checked` for a candidate-set kernel: each set's px, py, pz float32
    and valid bool [N, M] (one M for every set) and src float32 [N, 3], then
    an int32 [CARRY_SIZE] carry and a float32 radius []."""
    sets = (cand, *more)
    m = cand.px.shape[1] if cand.px.dim() == 2 else -1
    table = {}
    for k, c in enumerate(sets):
        tag, n = f"set {k} " if more else "", c.px.shape[0]
        table.update({f"{tag}{f}": (getattr(c, f), torch.bool if f == "valid" else F32, (n, m))
                      for f in ("px", "py", "pz", "valid")})
        table[f"{tag}src"] = (c.src, F32, (n, 3))
    table.update(carry=(carry, I32, (CARRY_SIZE,)), radius=(radius, F32, ()))
    return _checked(name, table, " (one M for every set; init_carry's carry)")


def _check_inside_schedule(cfg, num_probes: int, capacity: int,
                           name: str = "ndt_gn_rounds") -> None:
    """The kernels that gather inside the loop (`name`: ndt_gn_rounds,
    plane_map_gn_rounds) serve their callers' only settings: a gather every
    iteration, no trust-region skip; num_probes in [1, PROBE_WINDOW] and a
    table capacity that is a power of two. The kernels take these as
    checked."""
    if int(cfg.corr_every) != 1 or float(cfg.skip_regather_dist) > 0.0:
        raise ValueError(f"{name}: the kernel runs corr_every 1 with no trust-region skip, "
                         f"not corr_every {cfg.corr_every}, skip {cfg.skip_regather_dist}")
    if not 1 <= int(num_probes) <= PROBE_WINDOW:
        raise ValueError(f"{name}: num_probes {num_probes} outside [1, {PROBE_WINDOW}]")
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"{name}: a map capacity of {capacity}, no power of two")


def _check_refine_schedule(cfg, stencil: str, num_probes: int, capacity: int) -> None:
    """plane_map_gn_rounds serves the loop closure's only settings:
    `_check_inside_schedule`'s and the nearby26 stencil."""
    _check_inside_schedule(cfg, num_probes, capacity, "plane_map_gn_rounds")
    if stencil != "nearby26":
        raise ValueError(f"plane_map_gn_rounds: the kernel takes the nearby26 stencil, not "
                         f"{stencil!r}")


def _checked_ndt_inputs(carry, src, src_mask, m) -> list:
    """`_checked` for ndt_gn_launch: src float32 [N, 3], src_mask bool [N],
    the map's probe windows fpwin int64 [C, PROBE_WINDOW] (read as 16-byte
    pairs, so 16-byte aligned), mean float32 [C, 3], info float32 [C, 3, 3]
    and estimated bool [C], and an int32 [CARRY_SIZE] carry."""
    n, c = src.shape[0], m.fpwin.shape[0]
    tensors = _checked("ndt_gn_rounds", {
        "src": (src, F32, (n, 3)), "src_mask": (src_mask, torch.bool, (n,)),
        "fpwin": (m.fpwin, torch.int64, (c, PROBE_WINDOW)), "mean": (m.mean, F32, (c, 3)),
        "info": (m.info, F32, (c, 3, 3)), "estimated": (m.estimated, torch.bool, (c,)),
        "carry": (carry, I32, (CARRY_SIZE,))})
    if m.fpwin.data_ptr() % 16:
        raise ValueError("ndt_gn_rounds: fpwin is not 16-byte aligned")
    return tensors


def _checked_refine_inputs(carry, src, src_mask, m) -> list:
    """`_checked` for plane_map_gn_launch: src float32 [N, 3], src_mask
    bool [N], the block map's probe windows fpwin int64 [Cb, PROBE_WINDOW]
    (read as 16-byte pairs, so 16-byte aligned) and its plane rows tab
    float32 [Cb + 1, 24 S], and an int32 [CARRY_SIZE] carry."""
    n, c = src.shape[0], m.fpwin.shape[0]
    tensors = _checked("plane_map_gn_rounds", {
        "src": (src, F32, (n, 3)), "src_mask": (src_mask, torch.bool, (n,)),
        "fpwin": (m.fpwin, torch.int64, (c, PROBE_WINDOW)),
        "tab": (m.tab, F32, (c + 1, 24 * m.bucket_size)),
        "carry": (carry, I32, (CARRY_SIZE,))})
    if m.fpwin.data_ptr() % 16:
        raise ValueError("plane_map_gn_rounds: fpwin is not 16-byte aligned")
    return tensors


def _ndt_launch_args(carry, src, src_mask, m) -> list:
    """ndt_gn_launch's tensors in its order: `_checked_ndt_inputs`, then
    after the carry a new [N, 12] int32 slot cache, the kernel's scratch
    (the kernel writes it before it reads it)."""
    return [*_checked_ndt_inputs(carry, src, src_mask, m),
            torch.empty((src.shape[0], 12), dtype=I32, device=carry.device)]


def _loop_args(cfg, schedule: bool = True) -> tuple:
    """The loop's scalars, in the C entry points' order: max_iters,
    max_total, corr_every, min_valid, use_stall (ints), then rot_eps,
    pos_eps, stall_eps, skip_dist (floats); without `schedule`, no
    corr_every and no skip_dist (ndt_gn_launch's fixed schedule)."""
    every = (int(cfg.corr_every),) if schedule else ()
    skip = (float(cfg.skip_regather_dist),) if schedule else ()
    return (int(cfg.max_iters), int(cfg.max_iters) * max(int(cfg.corr_every), 1), *every,
            int(cfg.min_valid), int(bool(cfg.use_stall_check)), float(cfg.rotation_eps),
            float(cfg.position_eps), float(cfg.stall_eps), *skip)


def _launched(fn, err: int, carry: torch.Tensor) -> torch.Tensor:
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    fn.launches += 1
    return _word(carry, "status")


def _stream(carry: torch.Tensor) -> int:
    return torch.cuda.current_stream(carry.device).cuda_stream


def icp_gn_rounds(carry: torch.Tensor, cand: CandSet, radius: torch.Tensor, cfg,
                  max_corr_dist_sq: float) -> torch.Tensor:
    """One gather round of the ICP GN loop: on CPU tensors the plain
    version; on CUDA tensors the kernel on the current stream, which reads
    nothing back to the host, raising on a non-float32 or non-contiguous
    input or a CUDA error. Returns the carry's status word (a view)."""
    if carry.device.type == "cpu":
        return icp_gn_rounds_plain(carry, cand, radius, cfg, max_corr_dist_sq)
    args = _checked_inputs(carry, cand, radius)
    n, m = cand.px.shape
    err = cuda_build.library("gn_loop").icp_gn_launch(
        *(t.data_ptr() for t in args), n, m, *_loop_args(cfg), float(max_corr_dist_sq),
        _stream(carry))
    return _launched(icp_gn_rounds, err, carry)


def plane_gn_rounds(carry: torch.Tensor, cand: CandSet, radius: torch.Tensor, cfg,
                    plane_thresh: float, max_search_dist_sq: float) -> torch.Tensor:
    """One gather round of the point-to-plane GN loop (PointToPlaneMatcher):
    on CPU tensors the plain version; on CUDA tensors the kernel on the
    current stream, raising as `icp_gn_rounds` does. Returns the carry's
    status word (a view)."""
    if carry.device.type == "cpu":
        return plane_gn_rounds_plain(carry, cand, radius, cfg, plane_thresh,
                                     max_search_dist_sq)
    args = _checked_inputs(carry, cand, radius, name="plane_gn_rounds")
    n, m = cand.px.shape
    err = cuda_build.library("gn_loop").plane_gn_launch(
        *(t.data_ptr() for t in args), n, m, *_loop_args(cfg), float(max_search_dist_sq),
        float(plane_thresh), _stream(carry))
    return _launched(plane_gn_rounds, err, carry)


def loam_gn_rounds(carry: torch.Tensor, cand_corner: CandSet, cand_planar: CandSet,
                   radius: torch.Tensor, cfg, line_ratio_thresh: float, plane_thresh: float,
                   max_search_dist_sq: float) -> torch.Tensor:
    """One gather round of LoamFull's GN loop (line rows of the corner set
    plus plane rows of the planar set): on CPU tensors the plain version;
    on CUDA tensors the kernel on the current stream, raising as
    `icp_gn_rounds` does. Returns the carry's status word (a view)."""
    if carry.device.type == "cpu":
        return loam_gn_rounds_plain(carry, cand_corner, cand_planar, radius, cfg,
                                    line_ratio_thresh, plane_thresh, max_search_dist_sq)
    args = _checked_inputs(carry, cand_corner, radius, cand_planar, name="loam_gn_rounds")
    (nc, m), np_ = cand_corner.px.shape, cand_planar.px.shape[0]
    err = cuda_build.library("gn_loop").loam_gn_launch(
        *(t.data_ptr() for t in args), nc, np_, m, *_loop_args(cfg),
        float(max_search_dist_sq), float(plane_thresh), float(line_ratio_thresh),
        _stream(carry))
    return _launched(loam_gn_rounds, err, carry)


def ndt_gn_rounds(carry: torch.Tensor, src: torch.Tensor, src_mask: torch.Tensor, m, inv,
                  outlier_thresh: float, radius, cfg, num_probes: int = 8) -> torch.Tensor:
    """NDT's whole GN loop (the stencil lookup in the map `m` and the
    Mahalanobis rows inside every iteration) from the carry to DONE: on CPU
    tensors the plain version; on CUDA tensors the kernel on the current
    stream, which reads nothing back to the host, raising on an input of
    another dtype (float32 points, a bool mask and flags, int64
    fingerprints), shape or device, a non-contiguous input, a probe-window
    view `fpwin` that is not 16-byte aligned, or a CUDA error. Raises on
    every device for the settings the kernel does not serve (`corr_every`
    other than 1, a trust-region skip), so `radius`, the round kernels'
    trust-region radius, is never read (None will do). Returns the carry's
    status word (a view).

    The kernel (csrc/gn_loop.cu `ndt_gn_kernel`) runs a row on one thread:
    it loads the first 8 probes of its 7 stencil voxels' windows (rows of
    `m.fpwin`, as the plain version's `ndt_map._probe` reads them), four
    windows at a time, before their first compare and takes each window's
    first match, then loads the found slots' means, infos and flags
    together; from a call's third iteration a row whose voxel has not
    changed takes its slots from the call's slot cache instead (the map is
    frozen within a call). It sums a row's lam and lam^T e over its valid
    pairs and applies J = [a | I]'s structure once a row, in float64, in a
    fixed order (a second launch gives the same bits)."""
    _check_inside_schedule(cfg, num_probes, m.fpwin.shape[0])
    if carry.device.type == "cpu":
        return ndt_gn_rounds_plain(carry, src, src_mask, m, inv, outlier_thresh, radius, cfg,
                                   num_probes)
    args = _ndt_launch_args(carry, src, src_mask, m)
    err = cuda_build.library("gn_loop").ndt_gn_launch(
        *(t.data_ptr() for t in args), src.shape[0], m.fpwin.shape[0], int(num_probes),
        *_loop_args(cfg, schedule=False), float(inv), float(outlier_thresh), _stream(carry))
    return _launched(ndt_gn_rounds, err, carry)


def plane_map_gn_rounds(carry: torch.Tensor, src: torch.Tensor, src_mask: torch.Tensor, m, inv,
                        plane_thresh: float, max_search_dist_sq: float, radius, cfg,
                        stencil: str = "nearby26", num_probes: int = 8) -> torch.Tensor:
    """The loop closure's whole point-to-plane GN loop over the hashed block
    map `m` (the 5-NN lookup, the plane fit and its gates inside every
    iteration) from the carry to DONE: on CPU tensors the plain version; on
    CUDA tensors the kernel on the current stream, which reads nothing back
    to the host, raising on an input of another dtype (float32 points and
    rows, a bool mask, int64 fingerprints), shape or device, a
    non-contiguous input, a probe-window view `fpwin` that is not 16-byte
    aligned, or a CUDA error. Raises on every device for the settings the
    kernel does not serve (`corr_every` other than 1, a trust-region skip,
    a stencil other than nearby26, num_probes outside [1, PROBE_WINDOW], a
    capacity that is no power of two), so `radius` is never read (None will
    do). Returns the carry's status word (a view).

    The kernel (csrc/gn_loop.cu `plane_map_gn_kernel`) runs a row on one
    thread: p = R s + t in the order `residuals._transform_fixed` takes it
    on the card, its voxel, the 8 cover blocks' slots from `m.fpwin` (four
    windows' probes loaded together), the 5 nearest among the stencil's 27
    voxels in the cover row's lane order (ties to the lower lane), then the
    plane row; the rows' sums in float64 in a fixed order (a second launch
    gives the same bits)."""
    _check_refine_schedule(cfg, stencil, num_probes, m.fpwin.shape[0])
    if carry.device.type == "cpu":
        return plane_map_gn_rounds_plain(carry, src, src_mask, m, inv, plane_thresh,
                                         max_search_dist_sq, radius, cfg, stencil, num_probes)
    args = _checked_refine_inputs(carry, src, src_mask, m)
    err = cuda_build.library("gn_loop").plane_map_gn_launch(
        *(t.data_ptr() for t in args), src.shape[0], m.fpwin.shape[0], int(num_probes),
        m.bucket_size, *_loop_args(cfg, schedule=False), float(inv), float(max_search_dist_sq),
        float(plane_thresh), _stream(carry))
    return _launched(plane_map_gn_rounds, err, carry)


def cluster_blocks(kernel: str, vec: bool = True) -> int:
    """The blocks of the thread block cluster that the wrapper named
    `kernel` (a key of `CLUSTER_KIND`) launches on the current CUDA device:
    16, or 8 where no 16-block cluster fits, chosen once a device by the
    launcher; `vec`: M = 16 with 16-byte aligned planes (every gather of
    the port), else the any-M kernel (NDT and the refine have one kernel
    each). Raises where not even 8 blocks fit."""
    blocks = cuda_build.library("gn_loop").gn_cluster_blocks(CLUSTER_KIND[kernel], int(vec))
    if blocks <= 0:
        raise RuntimeError(f"{kernel}: no cluster fits on the card: CUDA error {-blocks}")
    return blocks


def rank_rows(rows: int, ranks: int) -> list[int]:
    """The rows each rank of a cluster of `ranks` blocks linearizes an
    iteration of a call with `rows` rows (ICP: the set's; LoamFull: corner
    + planar; NDT and the refine: the source's), as the kernels' own split
    (csrc/gn_loop.cu `rank_rows`) deals them."""
    lib = cuda_build.library("gn_loop")
    return [lib.gn_rank_rows(rows, ranks, r) for r in range(ranks)]


icp_gn_rounds.launches = 0
plane_gn_rounds.launches = 0
loam_gn_rounds.launches = 0
ndt_gn_rounds.launches = 0
plane_map_gn_rounds.launches = 0
KERNELS = (icp_gn_rounds, plane_gn_rounds, loam_gn_rounds, ndt_gn_rounds, plane_map_gn_rounds)
