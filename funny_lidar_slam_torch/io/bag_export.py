"""Export a dataset to a ROS1 bag, the test harness of the bag replay path:
the port's copy of the JAX package's io/bag_export.py.

The reference is validated on recorded bags (README.md:94-218: M2DGR, NCLT,
LIO-SAM); none ships with the repository, so the tests prove the ingestion path
by synthesizing a bag from the simulator and replaying it through
`io.rosbag.read_bag` -> `pipeline.run_slam`.
"""

from __future__ import annotations

import numpy as np

from . import bag_format

_VELODYNE_POINT = np.dtype({
    "names": ["x", "y", "z", "intensity", "ring", "time"],
    "formats": ["<f4", "<f4", "<f4", "<f4", "<u2", "<f4"],
    "offsets": [0, 4, 8, 12, 16, 18],
    "itemsize": 22,
})


def dataset_to_bag(ds, path: str, lidar_topic: str = "/velodyne_points",
                   imu_topic: str = "/imu/data", max_scans: int | None = None,
                   imu_quat: bool = False) -> str:
    """Write a SimDataset as a Velodyne-layout PointCloud2 + sensor_msgs/Imu
    bag (the M2DGR/NCLT wire format, preprocessing.cpp:262-330)."""
    w = bag_format.BagWriter(path)
    w.add_connection(lidar_topic, "sensor_msgs/PointCloud2")
    w.add_connection(imu_topic, "sensor_msgs/Imu")

    for t, gyro, accel in zip(ds.imu_t, ds.imu_gyro, ds.imu_accel):
        msg = bag_format.ImuMsg(float(t), None, np.asarray(gyro), np.asarray(accel))
        w.write(imu_topic, float(t), bag_format.serialize_imu(msg))

    scans = ds.scans[:max_scans] if max_scans else ds.scans
    for scan in scans:
        n = len(scan.points)
        arr = np.zeros(n, _VELODYNE_POINT)
        arr["x"], arr["y"], arr["z"] = scan.points.T.astype(np.float32)
        arr["intensity"] = getattr(scan, "intensity", np.zeros(n, np.float32))
        arr["ring"] = getattr(scan, "ring", np.zeros(n, np.int32)).astype(np.uint16)
        arr["time"] = scan.rel_times.astype(np.float32)
        pc = bag_format.pointcloud2_from_structured(arr, float(scan.t))
        w.write(lidar_topic, float(scan.t), bag_format.serialize_pointcloud2(pc))

    w.close()
    return path
