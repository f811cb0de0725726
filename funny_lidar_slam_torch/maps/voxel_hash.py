"""Probing helpers of the voxel hash (port of the helpers of
maps/voxel_hash.py), which the hashed block map builds on.

Fingerprints are uint32 values held in int64 (0 = empty slot), bit for bit
the JAX package's. The per-voxel `VoxelHashMap` itself is not ported yet
(ROADMAP Queue 1 item 21).
"""

from __future__ import annotations

import torch

from ..ops.voxel import fmix32, u32, u32_mul

# second independent hash for the per-slot fingerprint (0 = empty slot)
_F1, _F2, _F3 = 2654435761, 805459861, 3674653429

# probe-window width: probing reads one [W] row of `fpwin` per lookup;
# callers may raise num_probes up to W without a layout change
PROBE_WINDOW = 16


def fingerprint(coords: torch.Tensor) -> torch.Tensor:
    """Nonzero 32-bit fingerprint of int coords [..., 3], as int64: the
    multiply-add combine passed through fmix32, with the low bit set."""
    c = u32(coords)
    h = (u32_mul(c[..., 0], _F1) + u32_mul(c[..., 1], _F2) + u32_mul(c[..., 2], _F3)) & 0xFFFFFFFF
    return fmix32(h) | 1


def _window(arr: torch.Tensor, width: int = PROBE_WINDOW) -> torch.Tensor:
    """[C] -> [C, W] with out[i, j] = arr[(i + j) mod C], as one gather."""
    c = arr.shape[0]
    idx = (torch.arange(c, device=arr.device)[:, None]
           + torch.arange(width, device=arr.device)[None, :]) % c
    return arr[idx]
