"""Minimal PCD v0.7 reader/writer (host side, NumPy): the port's own copy
of the JAX package's io/pcd.py.

The reference persists all map products as PCL PCD files — per-keyframe
clouds (include/common/keyframe.h:59-94), the merged global map and 100 m
tile maps (src/slam/system.cpp:299-340, src/slam/split_map.cpp:22-55) — and
localization consumes them back (src/slam/localization.cpp:174-188). Writing
the same container keeps the new framework's map products interchangeable
with the reference's without depending on PCL.

Supports ascii and binary encodings, fields x/y/z (+ optional intensity).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4", ("I", 1): "i1",
           ("I", 2): "i2", ("U", 4): "u4", ("U", 1): "u1", ("U", 2): "u2"}


def write_pcd(path: str, points: np.ndarray, intensity: np.ndarray | None = None,
              binary: bool = True) -> None:
    """Write an Nx3 float cloud (optional per-point intensity) as PCD."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    fields = ["x", "y", "z"]
    if intensity is not None:
        fields.append("intensity")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    cols = [points]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32).reshape(-1, 1))
    data = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a PCD file -> (points [N,3] f32, intensity [N] f32 or None).

    Handles ascii and binary encodings and arbitrary extra fields (only
    x/y/z/intensity are returned)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        data_mode = header["DATA"]

        names, formats = [], []
        for fld, sz, ty, cnt in zip(fields, sizes, types, counts):
            dt = _DTYPES[(ty, sz)]
            names.append(fld)
            formats.append(dt if cnt == 1 else f"{cnt}{dt}")
        dtype = np.dtype({"names": names, "formats": formats})

        if data_mode == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif data_mode == "ascii":
            arr = np.loadtxt(f, dtype=dtype, ndmin=1)
        else:
            raise ValueError(f"unsupported PCD encoding: {data_mode}")

    pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
    inten = arr["intensity"].astype(np.float32) if "intensity" in names else None
    return pts, inten


def voxel_downsample_np(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Host-side centroid voxel filter (pcl::VoxelGrid equivalent,
    common/pointcloud_utility.h VoxelGridCloud) for map products."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    if len(points) == 0 or voxel_size <= 0:
        return points
    coords = np.floor(points / voxel_size).astype(np.int64)
    # unique voxel ids via lexicographic ordering
    _, inv, counts = np.unique(coords, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)
