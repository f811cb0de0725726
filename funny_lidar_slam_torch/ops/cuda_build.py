"""Build and load the port's CUDA kernels (plain C entry points + ctypes).

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into
`build/kernels/lib<name>-<hash>.so` under the repository root, at first use;
the hash of the source and of the shared headers (`csrc/*.cuh`) names the
library, so an edited source or header rebuilds.
Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# ctypes signatures of each library's C entry points: (argtypes, restype)
SIGNATURES = {
    "fused_select": {
        "fused_select_launch": ([_P] * 8 + [_I] * 5 + [_P], _I),
        "fused_select_occupancy": ([_I], _I),
    },
    "probes": {
        "probe_scale2_launch": ([_P, _P, _I, _P], _I),
        "probe_row_gather_loop_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
        "probe_row_gather_vector_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
        "probe_lane_gather_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
        "probe_dma_rows_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
    },
    "imu_scan": {
        "preintegrate_launch": ([_P, _P, _I, _I, _P], _I),
        "eskf_predict_launch": ([_P, _P, _I, _F, _F, _F, _P], _I),
    },
    "tight_fuse": {
        "tight_fuse_launch": ([_P, _P, _F, _F, _F, _I, _F, _F, _F, _F, _P], _I),
    },
    "gn_loop": {
        "icp_gn_launch": ([_P] * 7 + [_I] * 7 + [_F] * 5 + [_P], _I),
        "plane_gn_launch": ([_P] * 7 + [_I] * 7 + [_F] * 6 + [_P], _I),
        "loam_gn_launch": ([_P] * 12 + [_I] * 8 + [_F] * 7 + [_P], _I),
        "ndt_gn_launch": ([_P] * 8 + [_I] * 7 + [_F] * 5 + [_P], _I),
        "plane_map_gn_launch": ([_P] * 5 + [_I] * 8 + [_F] * 6 + [_P], _I),
        "gn_cluster_blocks": ([_I, _I], _I),
        "gn_rank_rows": ([_I] * 3, _I),
    },
    "loam_features": {
        "loam_corners_launch": ([_P] * 7 + [_I] * 6 + [_F] * 3 + [_P], _I),
    },
    "pose_graph": {
        "pose_graph_gn_launch": ([_P] * 10 + [_L] * 2 + [_I] * 3 + [_F, _P], _I),
    },
}

_loaded: dict = {}  # {(name, defines): the loaded library}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def lib_path(name: str, defines=()) -> Path:
    """The library's path, named by a hash of its source, of every header
    in csrc/ and of the `defines` (nvcc -D flags) it is built with, so that
    an edit to either rebuilds it."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    for flag in defines:
        h.update(flag.encode())
    tag = "".join(f"-{flag[2:].lower()}" for flag in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, defines=()):
    """Start nvcc for one source unless its library exists; returns
    (process or None, output path, temporary path)."""
    out = lib_path(name, defines)
    if out.exists():
        return None, out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def build_all(names=None, variants=()) -> dict:
    """Compile the given kernel sources (default: all) and the `variants`,
    (name, defines) pairs built with nvcc -D flags beside, one nvcc process
    each, all started together. Returns {(name, defines): nvcc output},
    with defines () for a plain build; for a library built earlier, the
    output kept beside it (`.log`)."""
    builds = [(n, ()) for n in (SIGNATURES if names is None else names)]
    builds += [(n, tuple(d)) for n, d in variants]
    started = {b: _start_build(*b) for b in builds}
    logs = {}
    for key, (proc, out, tmp) in started.items():
        if proc is None:
            kept = out.with_suffix(".log")
            logs[key] = kept.read_text() if kept.exists() else "cached"
            continue
        log, _ = proc.communicate()
        logs[key] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return logs


def variant(name: str, defines) -> ctypes.CDLL:
    """The loaded build of `name` with nvcc -D flags `defines` (a profiling
    build: -DFLS_STAGE_CLOCKS), built first if needed; a build with other
    defines, the plain one included, is another library."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        build_all([], [key])
        lib = _loaded[key] = ctypes.CDLL(str(lib_path(*key)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    return variant(name, ())
