"""Error-state Kalman filter LiDAR-IMU fusion, `TightCouplingKF` (port of
fusion/eskf.py).

15-dof error state [dR, dV, dP, dbg, dba] with right perturbation
R = R_hat Exp(dR); gravity is the static initializer's constant. `predict`
propagates mean and covariance through the IMU segment; `update_pose`
corrects them with the scan matcher's pose.

Port notes: the JAX `lax.scan` of `predict` is one CUDA kernel for CUDA
tensors (`ops/recurrences.py`, csrc/imu_scan.cu) and `predict_plain`, a
Python loop over the segment's samples, each step masked by its validity
with `torch.where` (no host read), for CPU tensors. The biases are
constant through a prediction, so the plain version computes the corrected
rates, the rotation increments and the process noise of every step for the
whole segment up front. The 6x6 innovation is inverted with `inv_ex`,
which neither checks its result nor syncs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import so3_exp, so3_hat, so3_jr_inv, so3_log
from ..core.state import ImuSegment, NavState
from ..ops import recurrences


class EskfParams(NamedTuple):
    gyro_noise_var: torch.Tensor  # [3]
    acc_noise_var: torch.Tensor  # [3]
    gyro_rw_var: torch.Tensor  # [3] bias random walk
    acc_rw_var: torch.Tensor  # [3]

    @staticmethod
    def from_std(gyro_std, acc_std, gyro_rw_std=1e-4, acc_rw_std=1e-4,
                 dtype=torch.float32, device="cpu") -> "EskfParams":
        def var(x):
            return torch.as_tensor(x, dtype=dtype, device=device).expand(3).clone() ** 2

        return EskfParams(var(gyro_std), var(acc_std), var(gyro_rw_std), var(acc_rw_std))


class EskfState(NamedTuple):
    nav: NavState  # mean (its info field is unused; cov is the truth)
    cov: torch.Tensor  # [15, 15] error covariance [dR, dV, dP, dbg, dba]


def create(nav: NavState, init_cov_diag=None) -> EskfState:
    kw = dict(dtype=nav.r.dtype, device=nav.r.device)
    if init_cov_diag is None:
        init_cov_diag = [1e-6] * 3 + [1e-2] * 3 + [1e-6] * 3 + [1e-6] * 3 + [1e-4] * 3
    return EskfState(nav=nav, cov=torch.diag(torch.as_tensor(init_cov_diag, **kw)))


def predict(s: EskfState, segment: ImuSegment, params: EskfParams, gravity) -> EskfState:
    """Propagate mean and covariance through the padded IMU segment.

    CPU tensors take `predict_plain`; CUDA tensors launch the kernel
    (float32, one unbatched segment, gravity as host values) or raise."""
    if recurrences.on_cpu(*s.nav, s.cov, *segment, *params):
        return predict_plain(s, segment, params, gravity)
    r, v, p, cov = recurrences.eskf_predict(s.nav, s.cov, segment, params, gravity)
    return EskfState(nav=s.nav._replace(r=r, v=v, p=p), cov=cov)


def predict_plain(s: EskfState, segment: ImuSegment, params: EskfParams,
                  gravity) -> EskfState:
    """The plain PyTorch version of `predict`."""
    r, v, p, cov = s.nav.r, s.nav.v, s.nav.p, s.cov
    dtype, dev = r.dtype, r.device
    g = torch.as_tensor(gravity, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    t = segment.t.to(dtype)
    dts = t[1:] - t[:-1]
    valid = (segment.mask[1:] & segment.mask[:-1]) & (dts > 0)
    gyro = 0.5 * (segment.gyro[:-1] + segment.gyro[1:]).to(dtype) - s.nav.bg  # [S-1, 3]
    acc = 0.5 * (segment.accel[:-1] + segment.accel[1:]).to(dtype) - s.nav.ba
    dt3 = dts[:, None, None]
    r_step = so3_exp(gyro * dts[:, None])  # [S-1, 3, 3]
    acc_hat_dt = so3_hat(acc) * dt3

    # the transition's blocks that do not depend on the carried rotation
    steps = dts.shape[0]
    f_const = torch.eye(15, dtype=dtype, device=dev).repeat(steps, 1, 1)
    f_const[:, 0:3, 0:3] = r_step.transpose(-1, -2)
    f_const[:, 0:3, 9:12] = -eye3 * dt3
    f_const[:, 6:9, 3:6] = eye3 * dt3
    q_diag = torch.cat([params.gyro_noise_var, params.acc_noise_var,
                        torch.zeros(3, dtype=dtype, device=dev),
                        params.gyro_rw_var, params.acc_rw_var]).to(dtype)
    q = torch.diag_embed(q_diag * dts[:, None])  # [S-1, 15, 15]

    for k in range(steps):
        dt, ok = dts[k], valid[k]
        acc_world = r @ acc[k] + g
        f = f_const[k].clone()
        f[3:6, 0:3] = -r @ acc_hat_dt[k]
        f[3:6, 12:15] = -r * dt
        new_r = r @ r_step[k]
        new_v = v + acc_world * dt
        new_p = p + v * dt + 0.5 * acc_world * dt * dt
        new_cov = f @ cov @ f.T + q[k]
        r, v, p, cov = (torch.where(ok, a, b) for a, b in
                        ((new_r, r), (new_v, v), (new_p, p), (new_cov, cov)))
    return EskfState(nav=s.nav._replace(r=r, v=v, p=p), cov=cov)


def update_pose(s: EskfState, pose_meas: torch.Tensor, rot_std: float,
                pos_std: float) -> EskfState:
    """Kalman update with the scan-match pose: r_rot = Log(R_meas^T R_hat)
    with H = Jr(r_rot)^-1 on the dR block, r_pos = p_hat - p_meas with
    H = I on the dP block; the state moves by -K r, the covariance by the
    Joseph form."""
    nav = s.nav
    dtype, dev = nav.r.dtype, nav.r.device
    r_meas = pose_meas[:3, :3].to(dtype)
    p_meas = pose_meas[:3, 3].to(dtype)

    e_rot = so3_log(r_meas.T @ nav.r)
    resid = torch.cat([e_rot, nav.p - p_meas])  # [6]
    h = torch.zeros((6, 15), dtype=dtype, device=dev)
    h[0:3, 0:3] = so3_jr_inv(e_rot)
    h[3:6, 6:9] = torch.eye(3, dtype=dtype, device=dev)
    r_cov = torch.diag(torch.cat([torch.full((3,), rot_std**2, dtype=dtype, device=dev),
                                  torch.full((3,), pos_std**2, dtype=dtype, device=dev)]))

    pht = s.cov @ h.T
    k = pht @ torch.linalg.inv_ex(h @ pht + r_cov)[0]  # [15, 6]
    dx = k @ resid
    ikh = torch.eye(15, dtype=dtype, device=dev) - k @ h
    cov = ikh @ s.cov @ ikh.T + k @ r_cov @ k.T
    nav = nav._replace(r=nav.r @ so3_exp(-dx[0:3]), v=nav.v - dx[3:6], p=nav.p - dx[6:9],
                       bg=nav.bg - dx[9:12], ba=nav.ba - dx[12:15])
    return EskfState(nav=nav, cov=cov)
