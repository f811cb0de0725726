"""ctypes loader of the port's host C++ filters (`csrc/host/flp_native.cpp`,
a copy of the JAX package's native/flp_native.cpp).

The library is built with g++ at first use into
`build/host/libflp_native-<hash>.so` under the repository root, the hash
taken over the source, so an edited source rebuilds. Nothing is built or
loaded when this module is imported. Unlike the JAX package's loader there
is no NumPy fallback: a library that cannot be built raises, and
`io/pcd.voxel_downsample_np` stays only as the plain version the tests use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "flp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None


def lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libflp_native-{digest}.so"


def _build(out: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host filters "
                           "(csrc/host/flp_native.cpp) build with a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = lib_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        i64, f32 = ctypes.c_int64, ctypes.c_float
        pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.flp_filter_pad.restype = i64
        lib.flp_filter_pad.argtypes = [pf, ctypes.c_void_p, i64, f32, f32, i64, i64,
                                       pf, pf, pu8]
        lib.flp_voxel_downsample.restype = i64
        lib.flp_voxel_downsample.argtypes = [pf, i64, f32, i64, pf]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library loads (building it first if needed); a failed
    build raises from the filters themselves."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def filter_pad(points: np.ndarray, rel_times: np.ndarray | None,
               min_r: float, max_r: float, jump: int, capacity: int):
    """Range/jump filter + pad. Returns (points [cap, 3] f32, rel [cap] f32,
    mask [cap] bool, n_valid)."""
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    out_p = np.empty((capacity, 3), np.float32)
    out_r = np.empty(capacity, np.float32)
    out_m = np.empty(capacity, np.uint8)
    rel = None if rel_times is None else np.ascontiguousarray(rel_times, np.float32)
    n = _load().flp_filter_pad(points, None if rel is None else rel.ctypes.data,
                               len(points), min_r, max_r, jump, capacity,
                               out_p, out_r, out_m)
    return out_p, out_r, out_m.astype(bool), int(n)


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     cap: int | None = None) -> np.ndarray:
    """Centroid voxel filter (the reference's pcl::VoxelGrid) through a g++
    hash map; the voxels come in the hash map's order."""
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    cap = cap or len(points)
    out = np.empty((max(cap, 1), 3), np.float32)
    n = _load().flp_voxel_downsample(points, len(points), voxel_size, cap, out)
    return out[:n].copy()
