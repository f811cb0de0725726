"""Forster-style IMU preintegration (port of imu/preintegration.py).

`preintegrate` runs the JAX `lax.scan` over the padded segment on the
device as one CUDA kernel for CUDA tensors (`ops/recurrences.py`,
csrc/imu_scan.cu) and as `preintegrate_plain`, a Python loop over the
samples, for CPU tensors. Each step is the same midpoint update:
  * midpoint gyro/accel between consecutive samples,
  * deltas updated in the order P, V, R with the previous dR,
  * bias Jacobians updated before the deltas,
  * cov = A cov A^T + B (Sigma/dt) B^T plus position integration noise.
Masked (padded) samples leave the state untouched.
Covariance/Jacobian ordering: [rotation(0:3), velocity(3:6), position(6:9)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import so3_exp, so3_hat, so3_jr
from ..core.state import ImuSegment, NavState
from ..ops import recurrences


class PreintState(NamedTuple):
    """Preintegrated IMU increments between two scans."""

    d_r: torch.Tensor  # [3, 3]
    d_v: torch.Tensor  # [3]
    d_p: torch.Tensor  # [3]
    cov: torch.Tensor  # [9, 9] (rot, vel, pos)
    dr_dbg: torch.Tensor  # [3, 3]
    dv_dbg: torch.Tensor  # [3, 3]
    dv_dba: torch.Tensor  # [3, 3]
    dp_dbg: torch.Tensor  # [3, 3]
    dp_dba: torch.Tensor  # [3, 3]
    dt: torch.Tensor  # [] total integration time (s)
    bg: torch.Tensor  # [3] gyro bias used during integration
    ba: torch.Tensor  # [3] accel bias used during integration

    @staticmethod
    def zero(bg: torch.Tensor, ba: torch.Tensor) -> "PreintState":
        kw = dict(dtype=bg.dtype, device=bg.device)
        z33 = torch.zeros((3, 3), **kw)
        z3 = torch.zeros(3, **kw)
        return PreintState(
            d_r=torch.eye(3, **kw), d_v=z3, d_p=z3,
            cov=torch.zeros((9, 9), **kw),
            dr_dbg=z33, dv_dbg=z33, dv_dba=z33, dp_dbg=z33, dp_dba=z33,
            dt=torch.zeros((), **kw), bg=bg, ba=ba,
        )


class PreintParams(NamedTuple):
    """Noise parameters: per-axis variances."""

    gyro_noise_var: torch.Tensor  # [3] gyro noise std^2
    acc_noise_var: torch.Tensor  # [3]
    integration_noise_var: torch.Tensor  # [3] position integration noise cov

    @staticmethod
    def from_std(gyro_std, acc_std, integration_cov=1.0e-8,
                 dtype=torch.float32, device="cpu") -> "PreintParams":
        def vec(x):
            return torch.as_tensor(x, dtype=dtype, device=device).expand(3).clone()

        return PreintParams(vec(gyro_std) ** 2, vec(acc_std) ** 2, vec(integration_cov))


def _step(state: PreintState, dt, gyro0, acc0, gyro1, acc1, valid,
          params: PreintParams) -> PreintState:
    """One midpoint integration step."""
    dtype = state.d_r.dtype
    gyro = 0.5 * (gyro0 + gyro1) - state.bg
    acc = 0.5 * (acc0 + acc1) - state.ba
    safe_dt = torch.clamp(dt, min=1e-9)

    r_step = so3_exp(gyro * dt)
    acc_hat = so3_hat(acc)
    jr = so3_jr(gyro * dt)
    d_r, d_v, d_p = state.d_r, state.d_v, state.d_p

    eye3 = torch.eye(3, dtype=dtype, device=dt.device)
    a_mat = torch.zeros((9, 9), dtype=dtype, device=dt.device)
    a_mat[0:3, 0:3] = r_step.T
    a_mat[3:6, 0:3] = -d_r @ acc_hat * dt
    a_mat[6:9, 0:3] = -0.5 * d_r @ acc_hat * dt * dt
    a_mat[3:6, 3:6] = eye3
    a_mat[6:9, 3:6] = dt * eye3
    a_mat[6:9, 6:9] = eye3

    b_mat = torch.zeros((9, 6), dtype=dtype, device=dt.device)
    b_mat[0:3, 0:3] = jr * dt
    b_mat[3:6, 3:6] = d_r * dt
    b_mat[6:9, 3:6] = 0.5 * d_r * dt * dt

    dp_dbg = state.dp_dbg + state.dv_dbg * dt - 0.5 * d_r @ acc_hat @ state.dr_dbg * dt * dt
    dp_dba = state.dp_dba + state.dv_dba * dt - 0.5 * d_r * dt * dt
    dv_dbg = state.dv_dbg - d_r @ acc_hat @ state.dr_dbg * dt
    dv_dba = state.dv_dba - d_r * dt
    dr_dbg = r_step.T @ state.dr_dbg - jr * dt

    new_d_p = d_p + d_v * dt + 0.5 * d_r @ acc * dt * dt
    new_d_v = d_v + d_r @ acc * dt
    new_d_r = d_r @ r_step

    noise = torch.cat([params.gyro_noise_var, params.acc_noise_var]).to(dtype)
    cov = a_mat @ state.cov @ a_mat.T + b_mat @ ((noise / safe_dt)[:, None] * b_mat.T)
    cov[6:9, 6:9] += torch.diag(params.integration_noise_var.to(dtype)) * dt

    new = PreintState(
        d_r=new_d_r, d_v=new_d_v, d_p=new_d_p, cov=cov,
        dr_dbg=dr_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba, dp_dbg=dp_dbg, dp_dba=dp_dba,
        dt=state.dt + dt, bg=state.bg, ba=state.ba,
    )
    return PreintState(*(torch.where(valid, a, b) for a, b in zip(new, state)))


def preintegrate(segment: ImuSegment, params: PreintParams, bg: torch.Tensor,
                 ba: torch.Tensor, init: PreintState | None = None) -> PreintState:
    """Integrate a padded, time-ordered IMU segment; `segment.mask` marks
    valid samples and the first valid sample seeds the integration.

    CPU tensors take `preintegrate_plain`; CUDA tensors launch the kernel
    (float32, one unbatched segment) or raise."""
    if recurrences.on_cpu(*segment, *params, bg, ba, *(init or ())):
        return preintegrate_plain(segment, params, bg, ba, init)
    return PreintState(*recurrences.preintegrate(segment, params, bg, ba, init))


def preintegrate_plain(segment: ImuSegment, params: PreintParams, bg: torch.Tensor,
                       ba: torch.Tensor, init: PreintState | None = None) -> PreintState:
    """The plain PyTorch version of `preintegrate`: one masked update a
    slot, every padded slot visited."""
    dtype = segment.gyro.dtype
    bg = torch.as_tensor(bg, dtype=dtype, device=segment.gyro.device)
    ba = torch.as_tensor(ba, dtype=dtype, device=segment.gyro.device)
    state = PreintState.zero(bg, ba) if init is None else init._replace(bg=bg, ba=ba)

    t = segment.t.to(dtype)
    dts = t[1:] - t[:-1]
    valid = (segment.mask[1:] & segment.mask[:-1]) & (dts > 0)
    for i in range(dts.shape[0]):
        state = _step(state, dts[i], segment.gyro[i], segment.accel[i],
                      segment.gyro[i + 1], segment.accel[i + 1], valid[i], params)
    return state


def predict(state: PreintState, nav: NavState, gravity: torch.Tensor) -> NavState:
    """Propagate the last nav state through the preintegrated increments."""
    dt = state.dt
    g = torch.as_tensor(gravity, dtype=state.d_v.dtype, device=state.d_v.device)
    p = nav.r @ state.d_p + nav.p + nav.v * dt + 0.5 * g * dt * dt
    v = nav.r @ state.d_v + nav.v + g * dt
    r = nav.r @ state.d_r
    return nav._replace(r=r, v=v, p=p)
