"""The step's three device loops as hand-written CUDA kernels (counterparts
of the JAX package's `lax.scan` and `lax.while_loop`):

  * `preintegrate` -> csrc/imu_scan.cu `preintegrate_launch` (the scan of
    imu/preintegration.py);
  * `eskf_predict` -> csrc/imu_scan.cu `eskf_predict_launch` (the scan of
    fusion/eskf.py's `predict`);
  * `tight_fuse`   -> csrc/tight_fuse.cu `tight_fuse_launch` (the LM
    `while_loop` of fusion/tight.py's `fuse` and its tail).

Each wrapper packs its inputs into one contiguous float32 buffer on the
inputs' CUDA device (the layouts below, mirrored by the kernels' enums),
allocates its output with `torch.empty`, launches one thread block on the
current stream, raises on a non-zero CUDA error and adds one to its
`.launches`. Scalars (gravity, the iteration count, the factor variances)
go by value; nothing is copied from or to the host, and nothing waits for
the device. The callers (`imu.preintegration.preintegrate`, `fusion.eskf.
predict`, `fusion.tight.fuse`) take the plain versions for CPU tensors and
these wrappers for CUDA tensors, with no fallback between them.

Layouts (float32 entries; S = segment slots):
  preintegrate in:  bg[3] ba[3] gyro_var[3] acc_var[3] integ_var[3] t[S]
                    gyro[S*3] accel[S*3] mask[S] (0/1), then the initial
                    state (PREINT_STATE) when one is given
  preintegrate out: PREINT_STATE: d_r[9] d_v[3] d_p[3] cov[81] dr_dbg[9]
                    dv_dbg[9] dv_dba[9] dp_dbg[9] dp_dba[9] dt[1]
  eskf in:          r[9] v[3] p[3] bg[3] ba[3] cov[225] gyro_var[3]
                    acc_var[3] gyro_rw_var[3] acc_rw_var[3] t[S] gyro[S*3]
                    accel[S*3] mask[S]
  eskf out:         r[9] v[3] p[3] cov[225]
  tight in:         last r[9] v[3] p[3] bg[3] ba[3] info[225], pre
                    PREINT_STATE bg[3] ba[3], lidar pose[16] (4x4),
                    predicted r[9] v[3] p[3]
  tight out:        r[9] v[3] p[3] bg[3] ba[3] info[225] iterations[1]
                    sweeps[2] (Jacobi sweeps that rotated, marginalization
                    and projection; 12 means unconverged)
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

F32 = torch.float32

# (field, shape) in buffer order
PREINT_STATE = (("d_r", (3, 3)), ("d_v", (3,)), ("d_p", (3,)), ("cov", (9, 9)),
                ("dr_dbg", (3, 3)), ("dv_dbg", (3, 3)), ("dv_dba", (3, 3)),
                ("dp_dbg", (3, 3)), ("dp_dba", (3, 3)), ("dt", ()))
ESKF_OUT = (("r", (3, 3)), ("v", (3,)), ("p", (3,)), ("cov", (15, 15)))
TIGHT_OUT = (("r", (3, 3)), ("v", (3,)), ("p", (3,)), ("bg", (3,)), ("ba", (3,)),
             ("info", (15, 15)), ("iterations", ()), ("sweeps", (2,)))


def _size(layout) -> int:
    return sum(int(np.prod(shape)) for _, shape in layout)


def unpack(buf: torch.Tensor, layout) -> tuple:
    """Views of `buf` ([n] float32) as the fields of `layout`."""
    out, o = [], 0
    for _, shape in layout:
        n = int(np.prod(shape))
        out.append(buf[o:o + n].view(shape) if shape else buf[o])
        o += n
    return tuple(out)


def _flat(*tensors) -> list:
    return [t.reshape(-1) for t in tensors]


def _check_f32(name: str, tensors) -> None:
    for t in tensors:
        if t.dtype != F32:
            raise TypeError(f"{name}: the kernel takes float32 tensors, got {t.dtype}")


def _sized(name: str, parts: list, n: int) -> torch.Tensor:
    """The parts concatenated, which must fill the kernel's layout exactly:
    the kernel reads `n` floats."""
    buf = torch.cat(parts)
    if buf.numel() != n:
        raise ValueError(f"{name}: the inputs fill {buf.numel()} floats of the "
                         f"kernel's {n}; check their shapes")
    return buf


def _host3(name: str, gravity) -> tuple:
    """Gravity as three host floats, passed to the kernel by value: reading
    a CUDA tensor would wait for the device, so one is refused."""
    if isinstance(gravity, torch.Tensor) and gravity.device.type != "cpu":
        raise ValueError(f"{name}: pass gravity as host values (a tuple or a CPU "
                         "tensor); it goes to the kernel by value")
    g = np.asarray(gravity, dtype=np.float64).reshape(3)
    return float(g[0]), float(g[1]), float(g[2])


def _segment_fields(segment) -> list:
    """t (cast to float32 before any difference is taken, as the plain
    versions do), gyro, accel and the mask as 0/1."""
    s = segment.t.shape[-1]
    if segment.t.dim() != 1 or tuple(segment.gyro.shape) != (s, 3) \
            or tuple(segment.accel.shape) != (s, 3) or tuple(segment.mask.shape) != (s,):
        raise ValueError("one unbatched segment expected: t [S], gyro/accel [S,3], mask [S]")
    _check_f32("segment", (segment.gyro, segment.accel))
    return [segment.t.to(F32), *_flat(segment.gyro, segment.accel),
            segment.mask.to(F32)]


def pack_preintegrate(segment, params, bg, ba, init=None):
    """(input buffer, slots, has_init) of `preintegrate_launch`."""
    dev = segment.gyro.device
    bg = torch.as_tensor(bg, dtype=F32, device=dev)
    ba = torch.as_tensor(ba, dtype=F32, device=dev)
    noise = (params.gyro_noise_var, params.acc_noise_var, params.integration_noise_var)
    _check_f32("preintegrate params", noise)
    parts = _flat(bg, ba, *noise) + _segment_fields(segment)
    if init is not None:
        state = [getattr(init, name) for name, _ in PREINT_STATE]
        _check_f32("preintegrate init", state)
        parts += _flat(*state)
    slots = int(segment.t.shape[-1])
    n = 15 + 8 * slots + (_size(PREINT_STATE) if init is not None else 0)
    return _sized("preintegrate", parts, n), slots, int(init is not None)


def pack_eskf(nav, cov, segment, params):
    """Input buffer of `eskf_predict_launch`."""
    state = (nav.r, nav.v, nav.p, nav.bg, nav.ba, cov)
    noise = (params.gyro_noise_var, params.acc_noise_var, params.gyro_rw_var,
             params.acc_rw_var)
    _check_f32("eskf_predict", state + noise)
    return _sized("eskf_predict", _flat(*state, *noise) + _segment_fields(segment),
                  258 + 8 * int(segment.t.shape[-1]))


def pack_tight(last, pre, lidar_pose, predict_nav):
    """Input buffer of `tight_fuse_launch`."""
    fields = ((last.r, last.v, last.p, last.bg, last.ba, last.info)
              + tuple(getattr(pre, name) for name, _ in PREINT_STATE)
              + (pre.bg, pre.ba, predict_nav.r, predict_nav.v, predict_nav.p))
    _check_f32("tight_fuse", fields)
    parts = _flat(*fields)
    if lidar_pose.numel() != 16:
        raise ValueError("tight_fuse: lidar_pose must be 4x4")
    return _sized("tight_fuse", parts[:-3] + [lidar_pose.to(F32).reshape(-1)] + parts[-3:],
                  425)


def _launch(name: str, lib: str, fn: str, buf: torch.Tensor, n_out: int, *args):
    """Launch `fn` of library `lib` on `buf` into a new [n_out] float32
    output on the current stream of buf's CUDA device."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the inputs must lie on one CUDA device")
    out = torch.empty(n_out, dtype=F32, device=dev)
    err = getattr(cuda_build.library(lib), fn)(
        buf.data_ptr(), out.data_ptr(), *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def preintegrate(segment, params, bg, ba, init=None) -> tuple:
    """The preintegration of one padded segment on its CUDA device: the
    fields of `PreintState` (bg and ba as given, as float32 tensors)."""
    buf, slots, has_init = pack_preintegrate(segment, params, bg, ba, init)
    out = _launch("preintegrate", "imu_scan", "preintegrate_launch", buf,
                  _size(PREINT_STATE), slots, has_init)
    preintegrate.launches += 1
    bg = torch.as_tensor(bg, dtype=F32, device=out.device)
    ba = torch.as_tensor(ba, dtype=F32, device=out.device)
    return unpack(out, PREINT_STATE) + (bg, ba)


def eskf_predict(nav, cov, segment, params, gravity) -> tuple:
    """ESKF propagation through one padded segment on its CUDA device:
    (r, v, p, cov) after the segment."""
    g = _host3("eskf_predict", gravity)
    buf = pack_eskf(nav, cov, segment, params)
    out = _launch("eskf_predict", "imu_scan", "eskf_predict_launch", buf, _size(ESKF_OUT),
                  int(segment.t.shape[-1]), *g)
    eskf_predict.launches += 1
    return unpack(out, ESKF_OUT)


def tight_fuse(last, pre, lidar_pose, predict_nav, gravity, cfg) -> tuple:
    """The 30-dof fusion solve on the inputs' CUDA device: (r, v, p, bg,
    ba, info, iterations, sweeps) of the current state, `iterations` the LM
    iterations run (a float32 0-d tensor), `sweeps` the rotating Jacobi
    sweeps of its two eigensolves ([2] float32; 12 means unconverged)."""
    g = _host3("tight_fuse", gravity)
    buf = pack_tight(last, pre, lidar_pose, predict_nav)
    out = _launch("tight_fuse", "tight_fuse", "tight_fuse_launch", buf, _size(TIGHT_OUT),
                  *g, int(cfg.iterations), float(cfg.lidar_rotation_std) ** 2,
                  float(cfg.lidar_position_std) ** 2, float(cfg.gyro_rw_std) ** 2,
                  float(cfg.acc_rw_std) ** 2)
    tight_fuse.launches += 1
    return unpack(out, TIGHT_OUT)


preintegrate.launches = 0
eskf_predict.launches = 0
tight_fuse.launches = 0
KERNELS = (preintegrate, eskf_predict, tight_fuse)


def on_cpu(*tensors) -> bool:
    """Whether every tensor among `tensors` (others ignored) lies on the
    CPU: the callers' test for the plain version."""
    return all(t.device.type == "cpu" for t in tensors if isinstance(t, torch.Tensor))
