"""Host-side IMU stream: caching, static initialization, orientation
integration, and padded segment extraction.

This is the feed-side replacement for the reference's IMU callback path and
time-series searchers (System::ImuMsgCallBack system.cpp:342-407,
System::InitIMU system.cpp:409-455, IMUDataSearcher::GetDataSegment
imu_data_searcher.h:16-119, DataSearcher buffer data_searcher.h:42-150).
It runs in NumPy on the host feed thread; the extracted fixed-capacity
segments are what cross to the device.

Reference semantics preserved:
  * static init: running mean/cov of acc & gyro; success after >200 samples
    with cov_acc < 0.05 and cov_gyro < 0.01; reset after 300 samples
    (movement too large); gravity = -mean_acc/|mean_acc| * g_norm.
  * accelerometer rescale by g_norm/|init_mean_acc| on every sample.
  * 6-axis IMUs integrate orientation with midpoint gyro; 9-axis uses the
    reported orientation.
  * segment extraction lerps boundary samples at exactly [t_left, t_right].
  * `DataSynchronizer` pops each consumed span (the reference's
    DataSynchronizer), for a feed that owns its stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.state import ImuSegment


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_from_rotvec(v):
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    u = v / theta
    return np.concatenate([[np.cos(theta / 2)], np.sin(theta / 2) * u])


def _quat_lerp(q0, q1, r):
    if np.dot(q0, q1) < 0:
        q1 = -q1
    q = q0 + (q1 - q0) * r
    return q / np.linalg.norm(q)


@dataclass
class ImuStaticInitializer:
    """Welford-style running stats with the reference's gates
    (System::InitIMU, system.cpp:409-455)."""

    gravity_norm: float = 9.81
    n: int = 0
    mean_acc: np.ndarray = field(default_factory=lambda: np.zeros(3))
    mean_gyro: np.ndarray = field(default_factory=lambda: np.zeros(3))
    cov_acc: np.ndarray = field(default_factory=lambda: np.zeros(3))
    cov_gyro: np.ndarray = field(default_factory=lambda: np.zeros(3))
    done: bool = False
    gravity: np.ndarray | None = None

    def push(self, acc, gyro) -> bool:
        if self.done:
            return True
        if self.n == 0:
            self.mean_acc = np.asarray(acc, float).copy()
            self.mean_gyro = np.asarray(gyro, float).copy()
            self.n = 1
            return False
        n = self.n
        acc = np.asarray(acc, float)
        gyro = np.asarray(gyro, float)
        self.mean_acc += (acc - self.mean_acc) / n
        self.mean_gyro += (gyro - self.mean_gyro) / n
        self.cov_acc = self.cov_acc * (n - 1.0) / n + (acc - self.mean_acc) ** 2 * (n - 1.0) / (n * n)
        self.cov_gyro = self.cov_gyro * (n - 1.0) / n + (gyro - self.mean_gyro) ** 2 * (n - 1.0) / (n * n)
        self.n += 1

        if self.n > 300:
            self.__init__(gravity_norm=self.gravity_norm)
            return False
        if self.n > 200 and np.linalg.norm(self.cov_acc) < 0.05 and np.linalg.norm(self.cov_gyro) < 0.01:
            self.gravity = -self.mean_acc / np.linalg.norm(self.mean_acc) * self.gravity_norm
            self.done = True
        return self.done

    @property
    def acc_scale(self) -> float:
        norm = np.linalg.norm(self.mean_acc)
        return self.gravity_norm / norm if norm > 0 else 1.0


class ImuStream:
    """Time-ordered IMU buffer with bounded size and segment extraction."""

    def __init__(
        self,
        has_orientation: bool = False,
        gravity_norm: float = 9.81,
        buffer_size: int = 2000,
        require_static_init: bool = True,
    ):
        self.has_orientation = has_orientation
        self.buffer_size = buffer_size
        self.require_static_init = require_static_init
        self.init = ImuStaticInitializer(gravity_norm=gravity_norm)
        self.t: list[float] = []
        self.gyro: list[np.ndarray] = []
        self.accel: list[np.ndarray] = []
        self.quat: list[np.ndarray] = []
        self._last_q = np.array([1.0, 0, 0, 0])
        self._last_gyro = np.zeros(3)
        self._last_t = None
        self.initialized = not require_static_init

    @property
    def gravity(self) -> np.ndarray:
        if self.init.done and self.init.gravity is not None:
            return self.init.gravity
        return np.array([0.0, 0.0, -self.init.gravity_norm])

    def push(self, t: float, gyro, accel, quat=None) -> None:
        gyro = np.asarray(gyro, float)
        accel = np.asarray(accel, float)
        if self.require_static_init and not self.init.done:
            if not self.init.push(accel, gyro):
                return  # drop samples until static init completes
            self.initialized = True
        if self.init.done:
            accel = accel * self.init.acc_scale

        if self.has_orientation and quat is not None:
            q = np.asarray(quat, float)
        else:
            if self._last_t is None:
                q = np.array([1.0, 0, 0, 0])
            else:
                dq = _quat_from_rotvec((self._last_gyro + gyro) * 0.5 * (t - self._last_t))
                q = _quat_mul(self._last_q, dq)
                q /= np.linalg.norm(q)
        self._last_q = q
        self._last_gyro = gyro
        self._last_t = t

        self.t.append(t)
        self.gyro.append(gyro)
        self.accel.append(accel)
        self.quat.append(q)
        if len(self.t) > self.buffer_size:
            del self.t[0], self.gyro[0], self.accel[0], self.quat[0]

    def covers(self, t0: float, t1: float) -> bool:
        return len(self.t) >= 2 and self.t[0] <= t0 and self.t[-1] >= t1

    def get_segment(self, t0: float, t1: float, capacity: int) -> ImuSegment | None:
        """Extract the span [t0, t1] with interpolated boundary samples
        (IMUDataSearcher::GetDataSegment semantics), padded to `capacity`."""
        if not self.covers(t0, t1) or t1 <= t0:
            return None
        ts = np.asarray(self.t)
        i0 = int(np.searchsorted(ts, t0, side="right"))  # first strictly inside
        i1 = int(np.searchsorted(ts, t1, side="left"))  # first >= t1

        def interp(t):
            j = int(np.searchsorted(ts, t, side="right")) - 1
            j = min(max(j, 0), len(ts) - 2)
            r = (t - ts[j]) / max(ts[j + 1] - ts[j], 1e-12)
            gyro = self.gyro[j] * (1 - r) + self.gyro[j + 1] * r
            accel = self.accel[j] * (1 - r) + self.accel[j + 1] * r
            quat = _quat_lerp(self.quat[j], self.quat[j + 1], r)
            return gyro, accel, quat

        rows_t, rows_g, rows_a, rows_q = [t0], [], [], []
        g, a, q = interp(t0)
        rows_g.append(g), rows_a.append(a), rows_q.append(q)
        for j in range(i0, i1):
            rows_t.append(ts[j])
            rows_g.append(self.gyro[j])
            rows_a.append(self.accel[j])
            rows_q.append(self.quat[j])
        g, a, q = interp(t1)
        rows_t.append(t1), rows_g.append(g), rows_a.append(a), rows_q.append(q)

        n = len(rows_t)
        if n > capacity:
            # keep boundaries, subsample interior
            keep = [0] + list(np.linspace(1, n - 2, capacity - 2).astype(int)) + [n - 1]
            rows_t = [rows_t[i] for i in keep]
            rows_g = [rows_g[i] for i in keep]
            rows_a = [rows_a[i] for i in keep]
            rows_q = [rows_q[i] for i in keep]
            n = capacity

        t_arr = np.zeros(capacity)
        g_arr = np.zeros((capacity, 3))
        a_arr = np.zeros((capacity, 3))
        q_arr = np.tile([1.0, 0, 0, 0], (capacity, 1))
        mask = np.zeros(capacity, bool)
        t_arr[:n] = rows_t
        g_arr[:n] = rows_g
        a_arr[:n] = rows_a
        q_arr[:n] = rows_q
        mask[:n] = True
        return ImuSegment(t=t_arr, gyro=g_arr, accel=a_arr, quat=q_arr, mask=mask)


class DataSynchronizer:
    """Consuming segment extraction: `ImuStream.get_segment`, then the
    consumed span is popped from the stream so each sample is handed out
    once and the buffer never regrows. The last sample at or before the
    right boundary stays, so the next segment's left-boundary
    interpolation still has its bracketing pair."""

    def __init__(self, stream: ImuStream):
        self.stream = stream

    def get_segment(self, t0: float, t1: float, capacity: int) -> ImuSegment | None:
        seg = self.stream.get_segment(t0, t1, capacity)
        if seg is None:
            return None
        s = self.stream
        # drop everything strictly before the bracketing sample of t1
        j = max(int(np.searchsorted(np.asarray(s.t), t1, side="right")) - 1, 0)
        del s.t[:j], s.gyro[:j], s.accel[:j], s.quat[:j]
        return seg
