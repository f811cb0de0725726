"""Platform probes (counterpart of tools/pallas_smoke.py): five small
kernels that show the card does what the port's kernels build on, each
held against the expression the TPU probe asserts with.

    python -m funny_lidar_slam_torch.ops.probes [--device cpu]

runs all five at the TPU probes' shapes (on the card by default) and
prints one line per probe; a mismatch or a refused launch raises.

The wrappers launch the hand-written kernels of `csrc/probes.cu` for CUDA
tensors (each adds one to its `launches` per call) and take the plain
PyTorch versions for CPU tensors. Every gather clamps its indices to
[0, C), as a JAX gather clamps.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve_device
from . import cuda_build


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def row_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = tab[clamp(idx[i])]: the plain version of the three row
    gathers (row_gather_loop, row_gather_vector, dma_rows)."""
    return tab[idx.to(torch.int64).clamp(0, tab.shape[0] - 1)]


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j] = x[b, clamp(idx[b, j])]."""
    return torch.gather(x, 1, idx.to(torch.int64).clamp(0, x.shape[1] - 1))


def _on_cuda(name: str, *tensors) -> bool:
    """True for CUDA inputs, False for CPU ones; raises on anything else."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, or all on the CPU")
    return True


def _check(name: str, data: torch.Tensor, idx: torch.Tensor | None = None, rows16=False):
    if data.dtype != torch.float32:
        raise TypeError(f"{name}: the data must be float32")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"{name}: the indices must be int32")
    if not data.is_contiguous() or (idx is not None and not idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if rows16 and (data.shape[-1] % 4 or data.data_ptr() % 16):
        raise ValueError(f"{name}: rows must be whole 16-byte units, 16-byte aligned")


def _launch(name: str, fn, *args) -> None:
    err = getattr(cuda_build.library("probes"), fn)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def scale2(x: torch.Tensor) -> torch.Tensor:
    """x * 2 (tools/pallas_smoke.py::test_basic): one launch, a thread a
    float4 and a thread a tail element."""
    if not _on_cuda("scale2", x):
        return scale2_plain(x)
    _check("scale2", x)
    if x.data_ptr() % 16:
        raise ValueError("scale2: the input must be 16-byte aligned")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("scale2", "probe_scale2_launch", x.data_ptr(), out.data_ptr(), x.numel())
    scale2.launches += 1
    return out


def _row_gather(wrapper, fn: str, tab: torch.Tensor, idx: torch.Tensor, rows16: bool):
    name = wrapper.__name__
    if not _on_cuda(name, tab, idx):
        return row_gather_plain(tab, idx)
    _check(name, tab, idx, rows16)
    if tab.dim() != 2 or idx.dim() != 1 or tab.shape[0] < 1:
        raise ValueError(f"{name}: tab [C, D] with C >= 1 and idx [B] expected")
    (c, d), b = tab.shape, idx.shape[0]
    out = torch.empty((b, d), dtype=tab.dtype, device=tab.device)
    with torch.cuda.device(tab.device):
        _launch(name, fn, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), c, d, b)
    wrapper.launches += 1
    return out


def row_gather_loop(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows by staged indices, a warp per row
    (tools/pallas_smoke.py::test_dynamic_row_loop)."""
    return _row_gather(row_gather_loop, "probe_row_gather_loop_launch", tab, idx, True)


def row_gather_vector(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows elementwise (tools/pallas_smoke.py::test_vector_gather): a
    thread a float4 of the output where D % 4 == 0 and tab and out are
    16-byte aligned, else a thread an element."""
    return _row_gather(row_gather_vector, "probe_row_gather_vector_launch", tab, idx, False)


DMA_MAX_D = 3072  # dma_rows' widest row: a cover row at plane 128


def dma_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows by bulk async copies through a ring of 8 shared-memory slots
    per block (tools/pallas_smoke.py::test_hbm_dma_rows). Rows up to
    DMA_MAX_D floats."""
    if tab.dim() == 2 and tab.shape[1] > DMA_MAX_D and tab.device.type != "cpu":
        raise ValueError(f"dma_rows: rows of at most {DMA_MAX_D} floats")
    return _row_gather(dma_rows, "probe_dma_rows_launch", tab, idx, True)


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row lane gather (tools/pallas_smoke.py::test_take_along_axis_lanes):
    four outputs a thread, x read directly, any J."""
    if not _on_cuda("lane_gather", x, idx):
        return lane_gather_plain(x, idx)
    _check("lane_gather", x, idx)
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError("lane_gather: x [B, D] and idx [B, J] expected")
    (b, d), j = x.shape, idx.shape[1]
    if d < 1:
        raise ValueError("lane_gather: D >= 1")
    out = torch.empty((b, j), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("lane_gather", "probe_lane_gather_launch", x.data_ptr(), idx.data_ptr(),
                out.data_ptr(), b, d, j)
    lane_gather.launches += 1
    return out


PROBES = (scale2, row_gather_loop, row_gather_vector, lane_gather, dma_rows)
for _p in PROBES:
    _p.launches = 0


def probe_inputs(device, seed: int = 0) -> dict:
    """The TPU probes' inputs at their shapes: {probe name: (args...)}."""
    rng = np.random.default_rng(seed)

    def table(c, d):
        return torch.arange(c * d, dtype=torch.float32, device=device).reshape(c, d)

    def index(high, shape):
        return torch.as_tensor(rng.integers(0, high, shape).astype(np.int32), device=device)

    gather = (table(4096, 128), index(4096, 1024))
    return {
        "scale2": (table(8, 128),),
        "row_gather_loop": gather,
        "row_gather_vector": gather,
        "lane_gather": (table(256, 512), index(512, (256, 128))),
        "dma_rows": (table(65536, 128), index(65536, 512)),
    }


def cover_index(c: int, n: int, seed: int = 0) -> np.ndarray:
    """n distinct row ids of [0, c), sorted, as int32: the pattern in which
    a scan's voxel groups read the cover rows of a map."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(c, n, replace=False)).astype(np.int32)


def expected(name: str, args) -> np.ndarray:
    """What the TPU probe asserts its kernel against, in NumPy."""
    a = [t.cpu().numpy() for t in args]
    if name == "scale2":
        return a[0] * 2.0
    if name == "lane_gather":
        return np.take_along_axis(a[0], a[1].astype(np.int64), axis=1)
    return a[0][a[1]]


def run(device=None) -> dict:
    """Every probe once at its TPU shape, checked exactly against the TPU
    probe's expression. Returns {probe name: output}."""
    device = resolve_device(device)
    inputs = probe_inputs(device)
    outs = {}
    for fn in PROBES:
        out = fn(*inputs[fn.__name__])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        np.testing.assert_array_equal(out.cpu().numpy(),
                                      expected(fn.__name__, inputs[fn.__name__]))
        outs[fn.__name__] = out
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    for probe, out in run(device).items():
        print(f"{probe}: OK {tuple(out.shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
