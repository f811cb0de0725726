"""Tight LiDAR-IMU coupling: the per-frame 30-dof fusion solve (port of
fusion/tight.py).

A fixed-structure analytic Levenberg-Marquardt over the last and current
nav states: residuals and Jacobians of every factor are assembled directly
into the 30x30 normal equations, and after the solve the old state is
Schur-marginalized out to become the next prior.

State ordering:
  [R_i(0) V_i(3) P_i(6) bg_i(9) ba_i(12) R_j(15) V_j(18) P_j(21) bg_j(24) ba_j(27)]
Rotation vertices use RIGHT perturbation R <- R Exp(d).

`fuse` runs the whole solve (the JAX `lax.while_loop` LM, the posterior,
the marginalization and the PSD projection) as one CUDA kernel for CUDA
tensors (`ops/recurrences.py`, csrc/tight_fuse.cu) and as `fuse_plain` for
CPU tensors; `fuse_plain` runs the LM loop on the host and reads its exit
flag once an iteration. The kernel deviates from `fuse_plain` in one step:
it refines the marginalization's pseudo-inverse (a float32 Jacobi
eigensolve in place of the SVD) by one Newton-Schulz step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import marginalize, so3_exp, so3_hat, so3_jr, so3_jr_inv, so3_log
from ..core.state import NavState
from ..imu.preintegration import PreintState
from ..ops import recurrences


class TightFusionConfig(NamedTuple):
    iterations: int = 12
    lidar_rotation_std: float = 0.005
    lidar_position_std: float = 0.01
    gyro_rw_std: float = 1.0e-4
    acc_rw_std: float = 1.0e-4


class FusionStates(NamedTuple):
    r_i: torch.Tensor
    v_i: torch.Tensor
    p_i: torch.Tensor
    bg_i: torch.Tensor
    ba_i: torch.Tensor
    r_j: torch.Tensor
    v_j: torch.Tensor
    p_j: torch.Tensor
    bg_j: torch.Tensor
    ba_j: torch.Tensor


def _full_j(blocks, edim: int, like: torch.Tensor) -> torch.Tensor:
    """Blocks [(state_offset, J[edim, 3])] -> dense J [edim, 30]."""
    j = torch.zeros((edim, 30), dtype=like.dtype, device=like.device)
    for off, jb in blocks:
        j[:, off:off + 3] = jb
    return j


def _accumulate(h, b, cost, blocks, lam, err):
    """h += J^T lam J, b += J^T lam e, cost += e^T lam e."""
    j = _full_j(blocks, err.shape[0], err)
    lam_e = lam @ err
    return h + j.T @ (lam @ j), b + j.T @ lam_e, cost + err @ lam_e


def _preint_residual_blocks(s: FusionStates, pre: PreintState, g: torch.Tensor):
    """Preintegration edge error + Jacobian blocks."""
    dt = pre.dt
    dbg = s.bg_i - pre.bg
    dba = s.ba_i - pre.ba
    corrected_dr = pre.d_r @ so3_exp(pre.dr_dbg @ dbg)
    e_r = so3_log(corrected_dr.T @ s.r_i.T @ s.r_j)
    dv_w = s.v_j - s.v_i - g * dt
    dp_w = s.p_j - s.p_i - s.v_i * dt - 0.5 * g * dt * dt
    e_v = s.r_i.T @ dv_w - (pre.d_v + pre.dv_dbg @ dbg + pre.dv_dba @ dba)
    e_p = s.r_i.T @ dp_w - (pre.d_p + pre.dp_dbg @ dbg + pre.dp_dba @ dba)
    err = torch.cat([e_r, e_v, e_p])

    jr_inv = so3_jr_inv(e_r)
    z = torch.zeros((3, 3), dtype=g.dtype, device=g.device)
    rit = s.r_i.T
    j_ri = torch.cat([-jr_inv @ s.r_j.T @ s.r_i, so3_hat(rit @ dv_w), so3_hat(rit @ dp_w)])
    j_vi = torch.cat([z, -rit, -rit * dt])
    j_pi = torch.cat([z, z, -rit])
    j_bg = torch.cat([-jr_inv @ so3_exp(e_r).T @ so3_jr(pre.dr_dbg @ dbg) @ pre.dr_dbg,
                      -pre.dv_dbg, -pre.dp_dbg])
    j_ba = torch.cat([z, -pre.dv_dba, -pre.dp_dba])
    j_rj = torch.cat([jr_inv, z, z])
    j_vj = torch.cat([z, rit, z])
    j_pj = torch.cat([z, z, rit])
    blocks = [(0, j_ri), (3, j_vi), (6, j_pi), (9, j_bg), (12, j_ba),
              (15, j_rj), (18, j_vj), (21, j_pj)]
    return err, blocks


def _all_factors(s: FusionStates, last: NavState, pre: PreintState, lidar_r, lidar_p,
                 g, cfg: TightFusionConfig):
    """(err, blocks, lam) for every factor in the frame graph."""
    kw = dict(dtype=g.dtype, device=g.device)
    eye3 = torch.eye(3, **kw)
    factors = []

    # prior on the last nav state: error = measure (-) estimate
    e_rot = so3_log(last.r.T @ s.r_i)
    err = torch.cat([e_rot, last.v - s.v_i, last.p - s.p_i, last.bg - s.bg_i,
                     last.ba - s.ba_i])
    prior_blocks = []
    for off, jb in ((0, so3_jr_inv(e_rot)), (3, -eye3), (6, -eye3), (9, -eye3), (12, -eye3)):
        j15 = torch.zeros((15, 3), **kw)
        j15[off:off + 3] = jb
        prior_blocks.append((off, j15))
    factors.append((err, prior_blocks, last.info.to(g.dtype)))

    # lidar rotation on the current R
    e = so3_log(lidar_r.T @ s.r_j)
    factors.append((e, [(15, so3_jr_inv(e))], eye3 / (cfg.lidar_rotation_std**2)))
    # lidar position on the current P
    factors.append((lidar_p - s.p_j, [(21, -eye3)], eye3 / (cfg.lidar_position_std**2)))

    # preintegration: info = cov^-1 (9x9)
    err, blocks = _preint_residual_blocks(s, pre, g)
    lam = torch.linalg.inv_ex(pre.cov + 1e-16 * torch.eye(9, **kw))[0]
    factors.append((err, blocks, lam))

    # bias random walks
    factors.append((s.bg_j - s.bg_i, [(9, -eye3), (24, eye3)], eye3 / (cfg.gyro_rw_std**2)))
    factors.append((s.ba_j - s.ba_i, [(12, -eye3), (27, eye3)], eye3 / (cfg.acc_rw_std**2)))
    return factors


def _apply_dx(s: FusionStates, dx: torch.Tensor) -> FusionStates:
    return FusionStates(
        r_i=s.r_i @ so3_exp(dx[0:3]), v_i=s.v_i + dx[3:6], p_i=s.p_i + dx[6:9],
        bg_i=s.bg_i + dx[9:12], ba_i=s.ba_i + dx[12:15],
        r_j=s.r_j @ so3_exp(dx[15:18]), v_j=s.v_j + dx[18:21], p_j=s.p_j + dx[21:24],
        bg_j=s.bg_j + dx[24:27], ba_j=s.ba_j + dx[27:30],
    )


def fuse(last: NavState, pre: PreintState, lidar_pose: torch.Tensor,
         predict_nav: NavState, gravity, cfg: TightFusionConfig) -> NavState:
    """Run the per-frame fusion and return the current NavState with its
    marginalized prior information. `predict_nav` seeds the current
    vertices; bias vertices start at the last state's biases.

    CPU tensors take `fuse_plain`; CUDA tensors launch the kernel (float32,
    gravity as host values) or raise."""
    if recurrences.on_cpu(*last, *pre, lidar_pose, *predict_nav):
        return fuse_plain(last, pre, lidar_pose, predict_nav, gravity, cfg)
    r, v, p, bg, ba, info, _, _ = recurrences.tight_fuse(last, pre, lidar_pose, predict_nav,
                                                         gravity, cfg)
    return NavState(r=r, v=v, p=p, bg=bg, ba=ba, info=info, t=predict_nav.t)


def fuse_plain(last: NavState, pre: PreintState, lidar_pose: torch.Tensor,
               predict_nav: NavState, gravity, cfg: TightFusionConfig) -> NavState:
    """The plain PyTorch version of `fuse`."""
    dtype, dev = last.r.dtype, last.r.device
    g = torch.as_tensor(gravity, dtype=dtype, device=dev)
    lidar_r = lidar_pose[:3, :3].to(dtype)
    lidar_p = lidar_pose[:3, 3].to(dtype)
    s = FusionStates(r_i=last.r, v_i=last.v, p_i=last.p, bg_i=last.bg, ba_i=last.ba,
                     r_j=predict_nav.r, v_j=predict_nav.v, p_j=predict_nav.p,
                     bg_j=last.bg, ba_j=last.ba)

    def assemble(st: FusionStates):
        h = torch.zeros((30, 30), dtype=dtype, device=dev)
        b = torch.zeros(30, dtype=dtype, device=dev)
        cost = torch.zeros((), dtype=dtype, device=dev)
        for err, blocks, lam in _all_factors(st, last, pre, lidar_r, lidar_p, g, cfg):
            h, b, cost = _accumulate(h, b, cost, blocks, lam, err)
        return 0.5 * (h + h.T), b, cost

    # Levenberg-Marquardt with a Jacobi-preconditioned solve; an accepted
    # step's trial assembly becomes the next iteration's current one.
    eye30 = torch.eye(30, dtype=dtype, device=dev)
    h, b, cost = assemble(s)
    lm_lambda = torch.tensor(1e-4, dtype=dtype, device=dev)
    for _ in range(cfg.iterations):
        d_inv = torch.rsqrt(torch.clamp(torch.diagonal(h), min=1e-12))
        hs = h * d_inv[:, None] * d_inv[None, :]
        dx = d_inv * torch.linalg.solve_ex(hs + lm_lambda * eye30, -(b * d_inv))[0]
        s_try = _apply_dx(s, dx)
        h_try, b_try, cost_try = assemble(s_try)
        accept = cost_try < cost
        tiny = torch.linalg.vector_norm(dx) < 1e-6
        stuck = ~accept & (lm_lambda >= 1e2)
        s = FusionStates(*(torch.where(accept, a, r) for a, r in zip(s_try, s)))
        h, b, cost = (torch.where(accept, a, r) for a, r in
                      ((h_try, h), (b_try, b), (cost_try, cost)))
        lm_lambda = torch.where(accept, torch.clamp(lm_lambda * 0.5, min=1e-6),
                                torch.clamp(lm_lambda * 8.0, max=1e2))
        if bool((accept & tiny) | stuck):
            break

    # posterior information at the optimum -> marginalize the old state,
    # then project onto the PSD cone
    h_fin, _, _ = assemble(s)
    info_new = marginalize(h_fin, 0, 14)[15:, 15:]
    info_new = 0.5 * (info_new + info_new.T)
    w, v = torch.linalg.eigh(info_new)
    info_new = (v * torch.clamp(w, min=0.0)) @ v.T
    return NavState(r=s.r_j, v=s.v_j, p=s.p_j, bg=s.bg_j, ba=s.ba_j, info=info_new,
                    t=predict_nav.t)
