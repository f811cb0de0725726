"""Fused candidate selection: the hot op of scan matching (counterpart of
ops/pallas_select.py).

Given per-unique-voxel cover windows gathered from the map
(`grid_map.gather_cover`, [Gp, 8*3*plane]) and voxel-sorted query points
with their monotone group ids, return each query's K nearest candidates
(d2, x, y, z; each [N, K]) in the sorted query order:
  * squared distance to every candidate lane of the query's window,
  * lanes outside the stencil (`center`/`nearby6`/`nearby18`/`nearby26`)
    masked to +inf, from each lane's static block/voxel bits and the query
    voxel parity,
  * the K nearest, nearest first.
Sentinel lanes (coords 1e30) and masked lanes carry d2 = +inf; callers
treat d2 >= 1e18 as invalid, and the coordinates of such entries are
unspecified (the kernel ends its rounds once only +inf keys are left and
reports the sentinel 1e30; the plain version reports the lane's own).

`fused_select` is the wrapper of the hand-written CUDA kernel
`csrc/fused_select.cu`; `fused_select_plain` is the plain PyTorch version
it is held against, and the one the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import torch

from . import cuda_build

STENCILS = ("center", "nearby6", "nearby18", "nearby26")

# query-tile alignment of the TPU kernel; group capacities keep the same
# rounding so shapes match the JAX package
TQ = 128


def _stencil_mask(n_lanes: int, qvox: torch.Tensor, plane: int, stencil: str) -> torch.Tensor:
    """[N, n_lanes] bool: which candidate lanes lie in the query's stencil.

    Lane j decomposes statically as (block offset bits, local voxel bits,
    bucket pos); its voxel's window coordinate per axis is
    w_a = 2*blk_a + l_a in {0..3}. The query voxel sits at window coordinate
    q_a = 2 - (v_a & 1), and delta_a = w_a - q_a is the stencil offset."""
    s = plane // 8
    j = torch.arange(n_lanes, device=qvox.device)
    blk = j // plane
    loc = (j % plane) // s
    w = torch.stack([2 * (blk >> 2) + (loc >> 2),
                     2 * ((blk >> 1) & 1) + ((loc >> 1) & 1),
                     2 * (blk & 1) + (loc & 1)], dim=-1)  # [L, 3]
    q = (2 - (qvox.to(torch.int64) & 1))  # [N, 3]
    d = torch.abs(w[None, :, :] - q[:, None, :])  # [N, L, 3]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    in26 = (dx <= 1) & (dy <= 1) & (dz <= 1)
    if stencil == "nearby26":
        return in26
    if stencil == "nearby18":
        return in26 & ~((dx == 1) & (dy == 1) & (dz == 1))
    if stencil == "nearby6":
        return in26 & (dx + dy + dz <= 1)
    if stencil == "center":
        return (dx == 0) & (dy == 0) & (dz == 0)
    raise ValueError(stencil)


def _planes(wnd: torch.Tensor, plane: int):
    """[N, 8*3*plane] windows -> (x, y, z) planes [N, 8*plane]."""
    w = wnd.reshape(wnd.shape[0], 8, 3, plane)
    return tuple(w[:, :, a, :].reshape(wnd.shape[0], 8 * plane) for a in range(3))


def fused_select_plain(cand_tab, gid, qpts, k: int, plane: int,
                       stencil: str = "nearby26", qvox=None):
    """Plain PyTorch version (gather + distance + mask + top-k)."""
    assert qvox is not None
    gp = cand_tab.shape[0]
    wnd = cand_tab[gid.to(torch.int64).clamp(0, gp - 1)]  # [N, 8*row]
    x, y, z = _planes(wnd, plane)
    d2 = ((x - qpts[:, 0:1]) ** 2 + (y - qpts[:, 1:2]) ** 2
          + (z - qpts[:, 2:3]) ** 2)
    mask = _stencil_mask(d2.shape[1], qvox, plane, stencil)
    d2 = torch.where(mask, d2, torch.full_like(d2, float("inf")))
    kd2, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return (kd2, torch.gather(x, 1, idx), torch.gather(y, 1, idx),
            torch.gather(z, 1, idx))


def fused_select(cand_tab, gid, qpts, k: int, plane: int,
                 stencil: str = "nearby26", qvox=None):
    """Select the K nearest stencil candidates per sorted query.

    CPU tensors take `fused_select_plain`; CUDA tensors launch the kernel
    (no fallback) and add one to `fused_select.launches` per launch.

    cand_tab f32 [Gp, 24*plane], 16-byte aligned (the kernel stages rows
    by bulk copy); gid i32 [N] (clamped to [0, Gp) in the kernel, as a JAX
    gather clamps; any values, fastest when they do not decrease, as the
    callers' voxel-sorted ids); qpts f32 [N, 3]; qvox i32 [N, 3].
    Returns (d2, x, y, z), each f32 [N, k]; the coordinates of entries
    with d2 >= 1e18 are unspecified."""
    if qvox is None:
        raise ValueError("qvox (the sorted query voxel coords) is required")
    tensors = (cand_tab, gid, qpts, qvox)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_select_plain(cand_tab, gid, qpts, k, plane, stencil, qvox)
    n = qpts.shape[0]
    gp, row = cand_tab.shape
    if cand_tab.dtype != torch.float32 or qpts.dtype != torch.float32:
        raise TypeError("fused_select: cand_tab and qpts must be float32")
    if gid.dtype != torch.int32 or qvox.dtype != torch.int32:
        raise TypeError("fused_select: gid and qvox must be int32")
    if row != 24 * plane or plane not in (8, 16, 32, 64, 128):
        raise ValueError(f"fused_select: unsupported plane {plane} for row {row}")
    if tuple(gid.shape) != (n,) or tuple(qpts.shape) != (n, 3) or tuple(qvox.shape) != (n, 3):
        raise ValueError("fused_select: gid [N], qpts [N,3], qvox [N,3] expected")
    if not 1 <= k <= 32 or gp < 1:
        raise ValueError("fused_select: need 1 <= k <= 32 and Gp >= 1")
    if stencil not in STENCILS:
        raise ValueError(stencil)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_select: inputs must be contiguous")
    if cand_tab.data_ptr() % 16:
        raise ValueError("fused_select: cand_tab must be 16-byte aligned (bulk copy source)")
    dev = cand_tab.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_select: all inputs must lie on one CUDA device")

    lib = cuda_build.library("fused_select")
    outs = [torch.empty((n, k), dtype=torch.float32, device=dev) for _ in range(4)]
    err = lib.fused_select_launch(
        cand_tab.data_ptr(), gid.data_ptr(), qpts.data_ptr(), qvox.data_ptr(),
        *(o.data_ptr() for o in outs), n, gp, plane, k, STENCILS.index(stencil),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_select launch failed: CUDA error {err}")
    fused_select.launches += 1
    return tuple(outs)


fused_select.launches = 0


def resident_blocks(plane: int) -> int:
    """Blocks of the kernel resident on one SM of the current CUDA device
    at this plane, by the runtime's occupancy calculator (8 warps a
    block)."""
    blocks = cuda_build.library("fused_select").fused_select_occupancy(plane)
    if blocks < 0:
        raise RuntimeError(f"fused_select occupancy failed: CUDA error {-blocks}")
    return blocks
