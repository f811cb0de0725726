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
        "ndt_gn_launch": ([_P] * 7 + [_I] * 7 + [_F] * 5 + [_P], _I),
        "gn_cluster_blocks": ([_I, _I], _I),
        "gn_rank_rows": ([_I] * 3, _I),
    },
}

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header in csrc/, so that an edit to either rebuilds it."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, output path, temporary path)."""
    out = lib_path(name)
    if out.exists():
        return None, out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def build_all(names=None) -> dict:
    """Compile the given kernel sources (default: all), one nvcc process
    per source, all started together. Returns {name: nvcc output}; for a
    library built earlier, the output kept beside it (`.log`)."""
    names = list(SIGNATURES) if names is None else list(names)
    started = {n: _start_build(n) for n in names}
    logs = {}
    for name, (proc, out, tmp) in started.items():
        if proc is None:
            kept = out.with_suffix(".log")
            logs[name] = kept.read_text() if kept.exists() else "cached"
            continue
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
