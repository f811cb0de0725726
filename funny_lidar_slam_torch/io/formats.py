"""Vendor point-format decoding to the unified scan bundle (host, NumPy):
the port's copy of the JAX package's io/formats.py.

Re-design of PreProcessing::ConvertMessageToCloud
(src/slam/preprocessing.cpp:262-511): each vendor's per-point struct is
decoded from a structured NumPy array (as produced by `pointcloud2.decode`
from a ROS PointCloud2-style message, or by any dataset reader) into a
`RawScan` — padded later at the pipeline boundary. The reference's per-point
PSTL loops become whole-array NumPy expressions.

Per-vendor semantics preserved:
  * Velodyne:  ring + `time` offset scaled by `point_time_scale`; offset
    times synthesized from yaw when the last offset <= 0
    (preprocessing.cpp:295-299).
  * Ouster:    `t` field scaled (nanoseconds in the wild -> scale 1e-9).
  * LeiShen:   absolute `timestamp` scaled.
  * RoboSense: point `timestamp` is absolute UNIX seconds; offsets are
    relative to the FIRST point, and the scan stamp is rewritten to the
    first point's time (preprocessing.cpp:364-399).
  * Livox Mid-360: offsets relative to first point; ring = 0.
  * Livox Avia: keep points with line < 6 and tag bits 0x30 in {0x00, 0x10}
    (preprocessing.cpp:436-466).
  * None: XYZI only; ring from user geometry row index, out-of-range rows
    dropped; offsets synthesized from yaw (preprocessing.cpp:468-511).

NaN points are dropped up front (RemoveNaNFromPointCloud equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..lidar.model import LidarModel


@dataclass
class RawScan:
    """Unified scan bundle (the PointXYZIRT cloud of the reference)."""

    stamp: float  # scan timestamp (seconds)
    points: np.ndarray  # [N, 3] f32
    intensity: np.ndarray  # [N] f32
    ring: np.ndarray  # [N] i32
    rel_times: np.ndarray  # [N] f32 per-point offset from `stamp`

    @property
    def min_max_offset(self) -> tuple[float, float]:
        """GetLidarPointMinMaxOffsetTime (preprocessing.cpp:553-571)."""
        return float(self.rel_times.min()), float(self.rel_times.max())


def _finite_mask(xyz: np.ndarray) -> np.ndarray:
    return np.isfinite(xyz).all(axis=1)


def _fields(arr: np.ndarray, *names: str) -> list[np.ndarray]:
    return [np.asarray(arr[n]) for n in names]


def compute_point_offset_time(points: np.ndarray, ring: np.ndarray,
                              n_rings: int, lidar_rate: float = 10.0) -> np.ndarray:
    """Synthesize per-point offset times from yaw for mechanically spinning
    lidars without a time field (ComputePointOffsetTime,
    preprocessing.cpp:513-552): offset = (yaw_first - yaw) mod 2pi / omega
    per ring, with a +period unwrap when the scan passes the start azimuth."""
    points = np.asarray(points)
    ring = np.asarray(ring)
    n = len(points)
    out = np.zeros(n, np.float32)
    omega = 2.0 * np.pi * lidar_rate
    period = 2.0 * np.pi / omega
    yaw = np.arctan2(points[:, 1], points[:, 0])
    for r in range(n_rings):
        idx = np.flatnonzero(ring == r)
        if len(idx) == 0:
            continue
        dy = yaw[idx[0]] - yaw[idx]
        base = np.where(dy >= 0, dy, dy + 2.0 * np.pi) / omega
        base[0] = 0.0
        # unwrap: after the first decrease the scan has passed its start
        # azimuth; every later point is one period in (preprocessing.cpp:546)
        wrapped = np.zeros(len(idx), bool)
        if len(idx) > 1:
            wrapped[1:] = np.cumsum(base[1:] < base[:-1]) > 0
        out[idx] = (base + period * wrapped).astype(np.float32)
    return out


def convert_velodyne(arr: np.ndarray, stamp: float, time_scale: float = 1.0,
                     model: LidarModel | None = None, lidar_rate: float = 10.0) -> RawScan:
    x, y, z, inten, ring, t = _fields(arr, "x", "y", "z", "intensity", "ring", "time")
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    keep = _finite_mask(xyz)
    xyz, inten, ring, t = xyz[keep], inten[keep], ring[keep], t[keep]
    rel = (t.astype(np.float64) * time_scale).astype(np.float32)
    if len(rel) and rel[-1] <= 0.0:
        n_rings = model.vertical_scan_num if model else int(ring.max()) + 1
        rel = compute_point_offset_time(xyz, ring, n_rings, lidar_rate)
    return RawScan(stamp, xyz, inten.astype(np.float32), ring.astype(np.int32), rel)


def convert_ouster(arr: np.ndarray, stamp: float, time_scale: float = 1e-9) -> RawScan:
    x, y, z, inten, ring, t = _fields(arr, "x", "y", "z", "intensity", "ring", "t")
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    keep = _finite_mask(xyz)
    rel = (arr["t"][keep].astype(np.float64) * time_scale).astype(np.float32)
    return RawScan(stamp, xyz[keep], inten[keep].astype(np.float32),
                   ring[keep].astype(np.int32), rel)


def convert_leishen(arr: np.ndarray, stamp: float, time_scale: float = 1.0) -> RawScan:
    x, y, z, inten, ring, t = _fields(arr, "x", "y", "z", "intensity", "ring", "timestamp")
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    keep = _finite_mask(xyz)
    rel = (t[keep].astype(np.float64) * time_scale).astype(np.float32)
    return RawScan(stamp, xyz[keep], inten[keep].astype(np.float32),
                   ring[keep].astype(np.int32), rel)


def convert_robosense(arr: np.ndarray, stamp: float, time_scale: float = 1.0) -> RawScan:
    """RoboSense: absolute per-point UNIX timestamps; the scan stamp becomes
    the FIRST point's time and offsets are relative to it
    (preprocessing.cpp:364-399)."""
    x, y, z, inten, ring, t = _fields(arr, "x", "y", "z", "intensity", "ring", "timestamp")
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    keep = _finite_mask(xyz)
    t = t[keep].astype(np.float64)
    t0 = t[0] if len(t) else stamp
    rel = ((t - t0) * time_scale).astype(np.float32)
    return RawScan(float(t0), xyz[keep], inten[keep].astype(np.float32),
                   ring[keep].astype(np.int32), rel)


def convert_livox_mid360(arr: np.ndarray, stamp: float, time_scale: float = 1.0) -> RawScan:
    """Livox Mid-360 (pointcloud2 with per-point absolute `timestamp`):
    offsets relative to the first point, ring = 0."""
    x, y, z, inten, t = _fields(arr, "x", "y", "z", "intensity", "timestamp")
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    keep = _finite_mask(xyz)
    t = t[keep].astype(np.float64)
    t0 = t[0] if len(t) else 0.0
    rel = ((t - t0) * time_scale).astype(np.float32)
    return RawScan(stamp, xyz[keep], inten[keep].astype(np.float32),
                   np.zeros(keep.sum(), np.int32), rel)


def convert_livox_avia(arr: np.ndarray, stamp: float, time_scale: float = 1.0,
                       num_scans: int = 6) -> RawScan:
    """Livox Avia CustomMsg points: keep line < num_scans and tag&0x30 in
    {0x00, 0x10} (preprocessing.cpp:447-450)."""
    x, y, z, inten, line, tag, t = _fields(
        arr, "x", "y", "z", "intensity", "line", "tag", "time"
    )
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    tagbits = tag.astype(np.uint8) & 0x30
    keep = _finite_mask(xyz) & (line < num_scans) & ((tagbits == 0x10) | (tagbits == 0x00))
    rel = (t[keep].astype(np.float64) * time_scale).astype(np.float32)
    return RawScan(stamp, xyz[keep], inten[keep].astype(np.float32),
                   line[keep].astype(np.int32), rel)


def convert_none(arr: np.ndarray, stamp: float, model: LidarModel,
                 lidar_rate: float = 10.0) -> RawScan:
    """Generic XYZI clouds: ring from the user geometry, invalid rows dropped,
    offset times synthesized from yaw (preprocessing.cpp:468-511)."""
    x, y, z, inten = _fields(arr, "x", "y", "z", "intensity")
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    keep = _finite_mask(xyz)
    xyz, inten = xyz[keep], inten[keep]
    row = model.row_index(xyz)
    ok = (row >= 0) & (row < model.vertical_scan_num)
    xyz, inten, row = xyz[ok], inten[ok], row[ok]
    rel = compute_point_offset_time(xyz, row, model.vertical_scan_num, lidar_rate)
    return RawScan(stamp, xyz, inten.astype(np.float32), row.astype(np.int32), rel)


_CONVERTERS = {
    "Velodyne_16": convert_velodyne,
    "Velodyne_32": convert_velodyne,
    "Velodyne_64": convert_velodyne,
    "Ouster_128_os1": convert_ouster,
    "LeiShen_16": convert_leishen,
    "RoboSense_16": convert_robosense,
    "Livox_Mid_360": convert_livox_mid360,
    "Livox_Avia": convert_livox_avia,
}


def convert(lidar_type: str, arr: np.ndarray, stamp: float,
            time_scale: float = 1.0, model: LidarModel | None = None,
            lidar_rate: float = 10.0) -> RawScan:
    """Vendor dispatch (the type switch of ConvertMessageToCloud)."""
    if lidar_type == "None":
        if model is None:
            raise ValueError("lidar_type None requires an explicit LidarModel")
        return convert_none(arr, stamp, model, lidar_rate)
    if lidar_type.startswith("Velodyne"):
        return convert_velodyne(arr, stamp, time_scale, model, lidar_rate)
    fn = _CONVERTERS.get(lidar_type)
    if fn is None:
        raise ValueError(f"Not support lidar type: {lidar_type}")
    return fn(arr, stamp, time_scale)
