"""The LOAM corner selection as a hand-written CUDA kernel (the
counterpart of the JAX package's jitted feature extraction up to the
corner mask, with its `lax.scan` of masked argmax picks,
loam/features.py::extract_features):

  * `corner_mask` -> csrc/loam_features.cu `loam_corners_launch`.

On CPU tensors `corner_mask` runs the plain version
(`loam/features.py::corner_mask_plain`); on CUDA tensors it zeroes the
output (one fill) and launches the kernel once on the current stream: one
thread block an angular block, a thread a lane, the block's window staged
in shared memory; the roughness, the valid marks and the row guard of
every lane at once, then the picks in one warp, each two warp reductions
over keys held in registers. It reads nothing back
to the host and has no fallback between the two routes: a CUDA input the
kernel does not take, or a failed build or launch, raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .gn_loop import _checked as checked_tensors

F32, I32 = torch.float32, torch.int32
# the kernel stages a block's window (9 B a point, its lanes and 6 either
# side) and its lanes' keys (4 B a lane) in one block's shared memory
MAX_LANES = (232448 - 12 * 9) // 13


def lanes(n: int, rows: int, blocks_per_row: int) -> int:
    """The lanes of a block, l_max, as corner_mask_plain sizes its lattice."""
    return max(int(n // (rows * blocks_per_row)) + 2, 8)


def _checked(scan, cfg) -> list:
    """A config the kernel takes (at most MAX_LANES lanes a block), then the
    scan's tensors in loam_corners_launch's order (depth float32, col, row
    int32 and mask bool [N], row_start and row_end int32 [R]), each of its
    dtype, contiguous and of its shape, all on one CUDA device (gn_loop's
    check)."""
    n, rows = scan.depth.shape[0], scan.row_start.shape[0]
    if rows < 1 or cfg.blocks_per_row < 1 or cfg.max_corners_per_block < 0:
        raise ValueError(f"corner_mask: {rows} rows, {cfg.blocks_per_row} blocks a row and "
                         f"{cfg.max_corners_per_block} corners a block")
    if lanes(n, rows, cfg.blocks_per_row) > MAX_LANES:
        raise ValueError(f"corner_mask: {lanes(n, rows, cfg.blocks_per_row)} lanes a block, "
                         f"over the kernel's {MAX_LANES}")
    return checked_tensors("corner_mask", {
        "depth": (scan.depth, F32, (n,)), "col": (scan.col, I32, (n,)),
        "row": (scan.row, I32, (n,)), "mask": (scan.mask, torch.bool, (n,)),
        "row_start": (scan.row_start, I32, (rows,)), "row_end": (scan.row_end, I32, (rows,))})


def corner_mask(scan, cfg) -> torch.Tensor:
    """The corner mask bool [N] of an OrderedScan under a FeatureConfig:
    on CPU tensors the plain version, on CUDA tensors one kernel launch
    (after one fill of the output), raising on an input of another dtype,
    shape or device, a non-contiguous input, or a CUDA error."""
    from ..loam import features

    if all(t.device.type == "cpu" for t in scan if isinstance(t, torch.Tensor)):
        return features.corner_mask_plain(scan, cfg)
    tensors = _checked(scan, cfg)
    n, rows = scan.depth.shape[0], scan.row_start.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=scan.depth.device)
    err = cuda_build.library("loam_features").loam_corners_launch(
        *(t.data_ptr() for t in tensors), out.data_ptr(), n, rows, int(cfg.blocks_per_row),
        lanes(n, rows, cfg.blocks_per_row), int(cfg.max_corners_per_block),
        int(cfg.occlusion_col_diff), float(cfg.occlusion_depth_jump),
        float(cfg.parallel_ratio), float(cfg.corner_threshold),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"corner_mask launch failed: CUDA error {err}")
    corner_mask.launches += 1
    return out


corner_mask.launches = 0
KERNELS = (corner_mask,)
