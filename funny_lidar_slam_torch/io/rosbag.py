"""ROS1 bag replay, dependency-free: the port's copy of the JAX package's
io/rosbag.py.

Offline replacement for the reference's live ROS subscribers
(System::InitSubscriber, src/slam/system.cpp:276-293 — standard
PointCloud2 vs Livox CustomMsg, plus sensor_msgs/Imu): iterates a bag in
time order yielding ("imu", t, gyro, accel, quat|None) and ("scan", RawScan)
events ready for SlamSystem.push_imu / process_scan.

Bag container parsing + message deserialization live in `bag_format`
(pure stdlib/numpy); vendor point-struct decoding lives in
io.pointcloud2 + io.formats.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..lidar.model import LidarModel
from . import bag_format, formats, pointcloud2


def _livox_to_structured(msg: bag_format.LivoxCustomMsg) -> np.ndarray:
    """livox_ros_driver/CustomMsg -> structured array with the avia fields
    (include/3rd/livox_ros_driver CustomMsg/CustomPoint)."""
    p = msg.points
    arr = np.zeros(len(p), np.dtype([
        ("x", "f4"), ("y", "f4"), ("z", "f4"), ("intensity", "f4"),
        ("line", "u1"), ("tag", "u1"), ("time", "f8"),
    ]))
    arr["x"], arr["y"], arr["z"] = p["x"], p["y"], p["z"]
    arr["intensity"] = p["reflectivity"]
    arr["line"], arr["tag"] = p["line"], p["tag"]
    arr["time"] = p["offset_time"].astype(np.float64)  # ns offsets
    return arr


def read_bag(path: str, lidar_topic: str, imu_topic: str, lidar_type: str,
             time_scale: float = 1.0, model: LidarModel | None = None,
             lidar_rate: float = 10.0) -> Iterator[tuple]:
    """Yield ("imu", t, gyro, accel, quat) and ("scan", RawScan) in time order."""
    reader = bag_format.BagReader(path)
    for m in reader.messages(topics={lidar_topic, imu_topic}):
        if m.topic == imu_topic:
            imu = bag_format.deserialize_imu(m.raw)
            t = imu.stamp if imu.stamp > 0 else m.t
            yield ("imu", t, imu.gyro, imu.accel, imu.quat)
        elif m.msgtype.endswith("CustomMsg"):
            livox = bag_format.deserialize_livox(m.raw)
            arr = _livox_to_structured(livox)
            scan = formats.convert(lidar_type, arr, livox.stamp, time_scale,
                                   model, lidar_rate)
            yield ("scan", scan)
        else:
            pc = bag_format.deserialize_pointcloud2(m.raw)
            arr = pointcloud2.decode(pc.fields, pc.point_step, pc.data,
                                     is_bigendian=pc.is_bigendian)
            scan = formats.convert(lidar_type, arr, pc.stamp, time_scale,
                                   model, lidar_rate)
            yield ("scan", scan)
