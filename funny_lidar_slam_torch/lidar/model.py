"""Per-vendor LiDAR scan geometry (LidarModel, src/lidar/lidar_model.cpp:9-81):
the port's copy of the JAX package's lidar/model.py.

The reference keeps a process-wide singleton; here the model is a plain
immutable dataclass resolved from the same type strings, with vectorized
NumPy row/col index math (lidar_model.h:50-81) for host-side preprocessing
and a `to_geometry()` bridge to the port's range-image projector
(loam/projection.LidarGeometry, the same fields).

Geometry numbers are vendor hardware constants (beam counts, angular
resolutions, lower angles) as tabulated in lidar_model.cpp:9-81.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..loam.projection import LidarGeometry

SENSOR_SPINNING = "spinning"  # row/col structure from geometry
SENSOR_SOLID_STATE = "solid_state"  # Livox: no ring structure
SENSOR_NONE = "none"  # user-provided geometry


@dataclasses.dataclass(frozen=True)
class LidarModel:
    lidar_type: str
    sensor_kind: str
    vertical_scan_num: int
    horizon_scan_num: int
    h_res: float  # radians
    v_res: float  # radians
    lower_angle: float  # radians (abs of minimum elevation)

    def row_index(self, points: np.ndarray) -> np.ndarray:
        """Ring index from elevation (LidarModel::RowIndex)."""
        points = np.asarray(points)
        xy = np.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2)
        return np.round(
            (np.arctan2(points[..., 2], xy) + self.lower_angle) / self.v_res
        ).astype(np.int32)

    def col_index(self, points: np.ndarray) -> np.ndarray:
        """Column index from azimuth; -pi maps to 0, 0 to H/2
        (LidarModel::ColIndex incl. the >=H wraparound)."""
        points = np.asarray(points)
        col = (
            np.round(np.arctan2(points[..., 1], points[..., 0]) / self.h_res).astype(np.int32)
            + self.horizon_scan_num // 2
        )
        return np.where(col >= self.horizon_scan_num, col - self.horizon_scan_num, col)

    def to_geometry(self, min_distance: float = 1.0, max_distance: float = 100.0):
        """Bridge to the device-side projector config."""
        return LidarGeometry(
            n_rows=self.vertical_scan_num,
            n_cols=self.horizon_scan_num,
            horizontal_resolution=self.h_res,
            min_distance=min_distance,
            max_distance=max_distance,
        )


def _deg(x: float) -> float:
    return math.radians(x)


_MODELS = {
    "LeiShen_16": dict(sensor_kind=SENSOR_SPINNING, vertical_scan_num=16,
                       horizon_scan_num=2000, h_res=_deg(0.18), v_res=_deg(2.0),
                       lower_angle=_deg(15.0)),
    "RoboSense_16": dict(sensor_kind=SENSOR_SPINNING, vertical_scan_num=16,
                         horizon_scan_num=1800, h_res=_deg(0.2), v_res=_deg(2.0),
                         lower_angle=_deg(15.0)),
    "Velodyne_16": dict(sensor_kind=SENSOR_SPINNING, vertical_scan_num=16,
                        horizon_scan_num=1800, h_res=_deg(0.2), v_res=_deg(2.0),
                        lower_angle=_deg(15.0)),
    # the 32-beam head is unevenly spaced; the reference approximates with a
    # uniform 1.29032258 deg pitch over [-30, +10] (lidar_model.cpp:31-38)
    "Velodyne_32": dict(sensor_kind=SENSOR_SPINNING, vertical_scan_num=32,
                        horizon_scan_num=1800, h_res=_deg(0.2),
                        v_res=_deg(1.290322581), lower_angle=_deg(30.0)),
    "Velodyne_64": dict(sensor_kind=SENSOR_SPINNING, vertical_scan_num=64,
                        horizon_scan_num=1800, h_res=_deg(0.2), v_res=_deg(0.4),
                        lower_angle=_deg(24.9)),
    "Ouster_128_os1": dict(sensor_kind=SENSOR_SPINNING, vertical_scan_num=128,
                           horizon_scan_num=1024, h_res=_deg(360.0 / 1024.0),
                           v_res=_deg(0.35), lower_angle=_deg(22.5)),
    "Livox_Mid_360": dict(sensor_kind=SENSOR_SOLID_STATE, vertical_scan_num=-1,
                          horizon_scan_num=-1, h_res=0.0, v_res=0.0, lower_angle=0.0),
    "Livox_Avia": dict(sensor_kind=SENSOR_SOLID_STATE, vertical_scan_num=-1,
                       horizon_scan_num=-1, h_res=0.0, v_res=0.0, lower_angle=0.0),
}


def make_lidar_model(lidar_type: str, **overrides) -> LidarModel:
    """Resolve a type string; "None" requires explicit geometry overrides
    (lidar_model.cpp:69-78)."""
    if lidar_type == "None":
        params = dict(sensor_kind=SENSOR_NONE, vertical_scan_num=0,
                      horizon_scan_num=0, h_res=0.0, v_res=0.0, lower_angle=0.0)
    elif lidar_type in _MODELS:
        params = dict(_MODELS[lidar_type])
    else:
        raise ValueError(f"Unsupported lidar sensor type: {lidar_type}")
    params.update(overrides)
    return LidarModel(lidar_type=lidar_type, **params)
