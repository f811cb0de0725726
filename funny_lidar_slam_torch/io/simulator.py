"""Synthetic LiDAR-inertial dataset generator (NumPy; a copy of the JAX
package's io/simulator.py, so both packages see identical data from one
seed).

There are no sensor bags in this environment (zero egress), so correctness
gates and benchmarks run on a simulated world: a structured scene (ground +
walls + pillars), a smooth trajectory, a spinning-lidar scan model with real
motion distortion (each point expressed in the sensor pose at its own
timestamp), and an IMU derived from the trajectory's analytic derivatives with
configurable biases/noise/gravity.

This plays the role of the reference's dataset configs (M2DGR/NCLT/...,
README.md:94-218) for CI: ATE against the simulator ground truth is the
acceptance metric (SURVEY.md §4 'implication for the new framework').
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

G_WORLD = np.array([0.0, 0.0, -9.81])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def make_world(seed=0, extent=60.0, n_pillars=60, wall_spacing=0.12) -> np.ndarray:
    """Structured world point set: ground, boundary walls, random pillars."""
    rng = np.random.default_rng(seed)
    pts = []

    g = np.arange(-extent, extent, 0.6, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    ground = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], 1)
    pts.append(ground)

    h = np.arange(0.0, 6.0, wall_spacing * 4, dtype=np.float32)
    line = np.arange(-extent, extent, wall_spacing, dtype=np.float32)
    ll, hh = np.meshgrid(line, h)
    for wall in (
        np.stack([ll.ravel(), np.full(ll.size, -extent), hh.ravel()], 1),
        np.stack([ll.ravel(), np.full(ll.size, extent), hh.ravel()], 1),
        np.stack([np.full(ll.size, -extent), ll.ravel(), hh.ravel()], 1),
        np.stack([np.full(ll.size, extent), ll.ravel(), hh.ravel()], 1),
    ):
        pts.append(wall)

    # pillars: vertical boxes scattered in the interior
    for _ in range(n_pillars):
        cx, cy = rng.uniform(-extent * 0.8, extent * 0.8, 2)
        if np.hypot(cx, cy) < 12.0:
            continue  # keep the trajectory corridor clear
        w = rng.uniform(0.5, 2.0)
        hgt = rng.uniform(2.0, 8.0)
        face = np.arange(-w, w, 0.15, dtype=np.float32)
        zz = np.arange(0, hgt, 0.3, dtype=np.float32)
        ff, zf = np.meshgrid(face, zz)
        for dx, dy, along_x in ((w, 0, False), (-w, 0, False), (0, w, True), (0, -w, True)):
            if along_x:
                p = np.stack([ff.ravel() + cx, np.full(ff.size, cy + dy), zf.ravel()], 1)
            else:
                p = np.stack([np.full(ff.size, cx + dx), ff.ravel() + cy, zf.ravel()], 1)
            pts.append(p)

    return np.concatenate(pts).astype(np.float32)


@dataclass
class Trajectory:
    """Planar circle with heading along velocity; z bobbing optional."""

    radius: float = 20.0
    omega: float = 0.15  # rad/s around the circuit
    z_amp: float = 0.0
    z_freq: float = 0.0

    def pose(self, t):
        a = self.omega * t
        p = np.array(
            [self.radius * np.cos(a), self.radius * np.sin(a), 1.5 + self.z_amp * np.sin(self.z_freq * t)]
        )
        r = _rz(a + np.pi / 2)
        return r, p

    def velocity(self, t):
        a = self.omega * t
        v = self.radius * self.omega * np.array([-np.sin(a), np.cos(a), 0.0])
        if self.z_amp:
            v = v + np.array([0, 0, self.z_amp * self.z_freq * np.cos(self.z_freq * t)])
        return v

    def accel(self, t):
        a = self.omega * t
        acc = -self.radius * self.omega**2 * np.array([np.cos(a), np.sin(a), 0.0])
        if self.z_amp:
            acc = acc + np.array([0, 0, -self.z_amp * self.z_freq**2 * np.sin(self.z_freq * t)])
        return acc

    def gyro_body(self, t):
        return np.array([0.0, 0.0, self.omega])


@dataclass
class Figure8Trajectory:
    """Planar figure-8 (Lissajous 1:2) with heading along velocity and
    optional z bobbing — the 'harder acceptance scenario': aggressive yaw
    reversals, self-crossings, and genuine revisits that trigger loop
    closures (the circle never revisits with a large index gap).

    x = A sin(w t), y = B sin(2 w t), yaw = atan2(vy, vx).
    """

    amp_x: float = 25.0
    amp_y: float = 12.0
    omega: float = 0.08  # rad/s of the base harmonic (cycle = 2*pi/omega)
    z_amp: float = 0.0
    z_freq: float = 0.0

    def _v(self, t):
        w = self.omega
        return np.array([
            self.amp_x * w * np.cos(w * t),
            2 * self.amp_y * w * np.cos(2 * w * t),
            self.z_amp * self.z_freq * np.cos(self.z_freq * t),
        ])

    def _a(self, t):
        w = self.omega
        return np.array([
            -self.amp_x * w * w * np.sin(w * t),
            -4 * self.amp_y * w * w * np.sin(2 * w * t),
            -self.z_amp * self.z_freq ** 2 * np.sin(self.z_freq * t),
        ])

    def pose(self, t):
        w = self.omega
        p = np.array([
            self.amp_x * np.sin(w * t),
            self.amp_y * np.sin(2 * w * t),
            1.5 + self.z_amp * np.sin(self.z_freq * t),
        ])
        v = self._v(t)
        yaw = np.arctan2(v[1], v[0])
        return _rz(yaw), p

    def velocity(self, t):
        return self._v(t)

    def accel(self, t):
        return self._a(t)

    def gyro_body(self, t):
        # R = Rz(yaw): body rate = yaw rate about z
        v, a = self._v(t), self._a(t)
        den = max(v[0] ** 2 + v[1] ** 2, 1e-9)
        return np.array([0.0, 0.0, (v[0] * a[1] - v[1] * a[0]) / den])


@dataclass
class SimConfig:
    duration: float = 30.0
    scan_hz: float = 10.0
    imu_hz: float = 100.0
    points_per_scan: int = 16384
    max_range: float = 45.0
    min_range: float = 1.5
    point_noise: float = 0.01
    gyro_bias: np.ndarray = field(default_factory=lambda: np.array([0.002, -0.001, 0.003]))
    acc_bias: np.ndarray = field(default_factory=lambda: np.array([0.02, -0.01, 0.015]))
    gyro_noise: float = 1e-3
    acc_noise: float = 1e-2
    static_warmup: float = 2.5  # seconds of standstill for IMU static init
    seed: int = 0


@dataclass
class SimScan:
    t: float  # scan reference (start) time
    points: np.ndarray  # [N, 3] lidar frame (motion-distorted)
    rel_times: np.ndarray  # [N] seconds from scan start
    gt_pose: np.ndarray  # [4, 4] sensor pose at scan END (odometry convention)


@dataclass
class SimDataset:
    scans: list
    imu_t: np.ndarray
    imu_gyro: np.ndarray
    imu_accel: np.ndarray
    gravity: np.ndarray
    gt_times: np.ndarray
    gt_poses: np.ndarray  # [K, 4, 4]


def simulate(cfg: SimConfig = SimConfig(), traj: Trajectory | None = None, world=None) -> SimDataset:
    rng = np.random.default_rng(cfg.seed)
    traj = traj or Trajectory()
    world = world if world is not None else make_world(cfg.seed)

    warm = cfg.static_warmup
    ramp = 2.0  # seconds of linear velocity ramp after the static warmup
    scan_period = 1.0 / cfg.scan_hz

    def warp(t):
        """Circuit time tau(t) with C1-continuous start: standstill during
        warmup, linear velocity ramp over `ramp` seconds, then unit rate.
        Returns (tau, dtau/dt, d2tau/dt2)."""
        dt = t - warm
        if dt <= 0:
            return 0.0, 0.0, 0.0
        if dt < ramp:
            return dt * dt / (2 * ramp), dt / ramp, 1.0 / ramp
        return dt - ramp / 2, 1.0, 0.0

    def pose_at(t):
        tau, _, _ = warp(t)
        return traj.pose(tau)

    # ---- IMU stream ----
    n_imu = int(cfg.duration * cfg.imu_hz) + 1
    imu_t = np.arange(n_imu) / cfg.imu_hz
    gyro = np.zeros((n_imu, 3))
    accel = np.zeros((n_imu, 3))
    for i, t in enumerate(imu_t):
        tau, d1, d2 = warp(t)
        r, _ = traj.pose(tau)
        # chain rule: p(tau(t)) -> a = p''*tau'^2 + p'*tau''
        w_b = traj.gyro_body(tau) * d1
        a_w = traj.accel(tau) * d1 * d1 + traj.velocity(tau) * d2
        gyro[i] = w_b + cfg.gyro_bias + rng.normal(0, cfg.gyro_noise, 3)
        accel[i] = r.T @ (a_w - G_WORLD) + cfg.acc_bias + rng.normal(0, cfg.acc_noise, 3)

    # ---- scans ----
    scans = []
    gt_times, gt_poses = [], []
    t = warm + 0.2  # first scan after static init completes
    kd_world = world
    while t + scan_period <= cfg.duration:
        r_end, p_end = pose_at(t + scan_period)
        # visible world points (within range of the scan-end position)
        d = np.linalg.norm(kd_world - p_end, axis=1)
        vis = np.where((d > cfg.min_range) & (d < cfg.max_range))[0]
        if len(vis) > cfg.points_per_scan:
            vis = rng.choice(vis, cfg.points_per_scan, replace=False)
        pw = kd_world[vis].astype(np.float64)

        # per-point time from azimuth in the scan-end frame (spinning lidar)
        local = (pw - p_end) @ r_end
        az = np.arctan2(local[:, 1], local[:, 0])  # [-pi, pi)
        rel = (az + np.pi) / (2 * np.pi) * scan_period

        # express each point in the sensor pose at its own timestamp
        pts = np.zeros_like(pw)
        order = np.argsort(rel)
        # piecewise: group points into 32 time bins for speed
        bins = np.clip((rel / scan_period * 32).astype(int), 0, 31)
        for b in range(32):
            sel = bins == b
            if not sel.any():
                continue
            tb = t + (b + 0.5) / 32 * scan_period
            r_b, p_b = pose_at(tb)
            pts[sel] = (pw[sel] - p_b) @ r_b
        pts += rng.normal(0, cfg.point_noise, pts.shape)

        gt = np.eye(4)
        gt[:3, :3] = r_end
        gt[:3, 3] = p_end
        scans.append(
            SimScan(t=t, points=pts.astype(np.float32), rel_times=rel.astype(np.float32), gt_pose=gt)
        )
        gt_times.append(t + scan_period)
        gt_poses.append(gt)
        t += scan_period

    return SimDataset(
        scans=scans,
        imu_t=imu_t,
        imu_gyro=gyro,
        imu_accel=accel,
        gravity=G_WORLD.copy(),
        gt_times=np.asarray(gt_times),
        gt_poses=np.asarray(gt_poses),
    )


def noisy_circle_graph(n=40, seed=0, k_cap=64, e_cap=128, radius=10.0,
                       extra_loops=1):
    """Synthetic noisy-circle pose graph with loop edges (the reference's
    loop-closure unit-test pattern): exact relative-pose measurements, a
    noisy initial chain. Returns (the port's `PoseGraphBuilder`, the true
    poses [n, 4, 4]); the builder's arrays equal the JAX package's for the
    same arguments."""
    from ..backend import pose_graph

    rng = np.random.default_rng(seed)
    b = pose_graph.PoseGraphBuilder(k_cap, e_cap)
    gt = []
    for i in range(n):
        a = 2 * np.pi * i / n
        t = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        t[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        t[:3, 3] = [radius * c, radius * s, 0.0]
        gt.append(t)
    noisy = [gt[0]]
    for i in range(1, n):
        meas = np.linalg.inv(gt[i - 1]) @ gt[i]
        pert = np.eye(4, dtype=np.float32)
        pert[:3, 3] = rng.normal(0, 0.03, 3)
        noisy.append(noisy[-1] @ meas @ pert)
    b.add_vertex(noisy[0])
    for i in range(1, n):
        meas = np.linalg.inv(gt[i - 1]) @ gt[i]
        b.poses[i] = noisy[i]
        b.pose_mask[i] = True
        b.n_vertices += 1
        b.add_edge(i - 1, i, meas, (1e2,) * 3 + (1e4,) * 3)
    for l in range(extra_loops):
        i = (l * n // max(extra_loops, 1)) % n
        j = (i + n // 2) % n
        if abs(i - j) < 2:
            continue
        b.add_edge(i, j, np.linalg.inv(gt[i]) @ gt[j], (1e2,) * 3 + (1e4,) * 3)
    b.add_edge(n - 1, 0, np.linalg.inv(gt[n - 1]) @ gt[0], (1e2,) * 3 + (1e4,) * 3)
    return b, np.asarray(gt)
