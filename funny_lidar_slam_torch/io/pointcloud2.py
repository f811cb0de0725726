"""ROS PointCloud2 binary decoding to structured NumPy arrays (host side):
the port's copy of the JAX package's io/pointcloud2.py.

Standalone equivalent of pcl::fromROSMsg as used by
PreProcessing::ConvertMessageToCloud (src/slam/preprocessing.cpp:262-511):
takes the message's field table + raw buffer (from any bag reader) and
returns a structured array whose columns feed io.formats.convert. No ROS
dependency.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# sensor_msgs/PointField datatype codes
_DATATYPES = {
    1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8",
}


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int = 1


def decode(fields, point_step: int, data: bytes, n_points: int | None = None,
           is_bigendian: bool = False) -> np.ndarray:
    """Decode a PointCloud2 buffer into a structured array.

    `fields` is a list of PointField-like objects (attributes name/offset/
    datatype/count — rosbags' message objects work directly)."""
    names, formats, offsets = [], [], []
    for f in fields:
        code = _DATATYPES[int(f.datatype)]
        if is_bigendian:
            code = ">" + code
        cnt = int(getattr(f, "count", 1) or 1)
        names.append(f.name)
        formats.append(code if cnt == 1 else f"({cnt},){code}")
        offsets.append(int(f.offset))
    dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                      "itemsize": point_step})
    if n_points is None:
        n_points = len(data) // point_step
    return np.frombuffer(data, dtype=dtype, count=n_points)
