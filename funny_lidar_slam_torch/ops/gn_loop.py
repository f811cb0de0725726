"""The ICP Gauss-Newton loop over cached candidates as a hand-written CUDA
kernel (the counterpart of the JAX package's `lax.while_loop` in
registration/gn.py::run_gn_corr, with `hg_fn = point_to_point_hg_cand`):

  * `icp_gn_rounds`       -> csrc/gn_loop.cu `icp_gn_launch`, one thread
    block a call, for CUDA tensors; the plain version for CPU tensors;
  * `icp_gn_rounds_plain` -> the same iterations in plain PyTorch, reading
    its flags on the host.

A call runs the loop body from the carry, on the candidate set the caller
has just gathered at the carry's pose, until the loop ends (`DONE`) or the
next iteration would need a fresh gather (`NEED_GATHER`); it writes the
carry back in place, the status word included. The caller
(registration/gn.py::run_gn_icp_cand) gathers, calls, and reads the status
word: one host read a gather round instead of one an iteration.

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
from ..registration.residuals import CandSet, point_to_point_hg_cand
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
BIG = 1e9  # last_rot / last_pos before the first exact iteration


class IcpLoopResult(NamedTuple):
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


def result_views(carry: torch.Tensor) -> IcpLoopResult:
    """The loop's outputs as views of the carry (no copy)."""
    f, o = carry.view(F32), OFFSET
    return IcpLoopResult(
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


def icp_gn_rounds_plain(carry: torch.Tensor, cand: CandSet, radius: torch.Tensor, cfg,
                        max_corr_dist_sq: float) -> torch.Tensor:
    """The JAX loop body (funny_lidar_slam_tpu/registration/gn.py:156-212,
    ICP update, `point_to_point_hg_cand`) from `carry` on `cand`, gathered
    at the carry's pose, until the loop bound fails (DONE) or an iteration
    asks for a gather that has not been handed in (NEED_GATHER). Writes the
    carry in place and returns its status word (a view). Reads its flags
    on the host, one small copy an iteration. Computes in the candidates'
    dtype: float32 on every path, float64 for a reference run."""
    f, o, dtype = carry.view(F32), OFFSET, cand.px.dtype
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
            t_gather, fresh = t_mat, False
        hg = point_to_point_hg_cand(t_mat, cand, max_corr_dist_sq)
        dx = solve6_damped(hg.h, hg.g)
        t_new = t_mat.clone()
        t_new[:3, 3] += dx[:3]
        t_new[:3, :3] = t_mat[:3, :3] @ so3_exp(dx[3:])
        rn, pn = torch.linalg.vector_norm(dx[3:]), torch.linalg.vector_norm(dx[:3])
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


def _checked_inputs(carry, cand: CandSet, radius) -> list:
    """The kernel's tensor arguments, checked: float32 (bool for `valid`,
    an int32 [CARRY_SIZE] carry), contiguous, matching shapes, then all on
    one CUDA device."""
    tensors = {"px": cand.px, "py": cand.py, "pz": cand.pz, "valid": cand.valid,
               "src": cand.src, "carry": carry, "radius": radius}
    for name, t in tensors.items():
        want = {"valid": torch.bool, "carry": I32}.get(name, F32)
        if t.dtype != want:
            raise TypeError(f"icp_gn_rounds: the kernel takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"icp_gn_rounds: {name} is not contiguous")
    n, m = cand.px.shape
    if not (cand.py.shape == cand.pz.shape == cand.valid.shape == (n, m)
            and tuple(cand.src.shape) == (n, 3) and radius.numel() == 1
            and carry.numel() == CARRY_SIZE):
        raise ValueError("icp_gn_rounds: px, py, pz, valid [N, M], src [N, 3], radius [] "
                         f"and a [{CARRY_SIZE}] carry (init_carry) expected")
    if carry.device.type != "cuda" or any(t.device != carry.device for t in tensors.values()):
        raise ValueError("icp_gn_rounds: the inputs must lie on one CUDA device")
    return list(tensors.values())


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
        *(t.data_ptr() for t in args), n, m, int(cfg.max_iters),
        int(cfg.max_iters) * max(int(cfg.corr_every), 1), int(cfg.corr_every),
        int(cfg.min_valid), int(bool(cfg.use_stall_check)), float(cfg.rotation_eps),
        float(cfg.position_eps), float(cfg.stall_eps), float(cfg.skip_regather_dist),
        float(max_corr_dist_sq), torch.cuda.current_stream(carry.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"icp_gn_rounds launch failed: CUDA error {err}")
    icp_gn_rounds.launches += 1
    return _word(carry, "status")


icp_gn_rounds.launches = 0
KERNELS = (icp_gn_rounds,)
