"""Carry state between the JAX package and the port.

The JAX package's state arrives as NamedTuples of NumPy arrays (for
example `jax.device_get(state)`); these helpers build the port's tensors
from them, field by field with the same names and dtypes, and turn the
port's state back into NumPy. Nothing here imports JAX: any object with the
right field names works.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend.pose_graph import PoseGraph
from .core.cloud import Cloud, ScanBundle
from .core.state import ImuSegment, NavState
from .loam.projection import OrderedScan
from .maps.block_map import BlockMap
from .maps.grid_map import GridMap
from .maps.ndt_map import NdtMap
from .maps.voxel_hash import VoxelHashMap
from .pipeline.frontend import FrontendState
from .registration.matchers import (
    LoamFullState,
    NdtState,
    P2PlaneIvoxState,
    P2PlaneWindowState,
    WindowMapState,
)
from .registration.residuals import CandSet


def tensor(a, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def _fields(cls, obj, device, nested=None):
    nested = nested or {}
    return cls(*(nested[f](getattr(obj, f), device) if f in nested
                 else tensor(getattr(obj, f), device) for f in cls._fields))


def grid_map(m, device="cpu") -> GridMap:
    return _fields(GridMap, m, device)


def _u32_as_int64(a, device):
    """The JAX package's uint32 fingerprints, bit for bit, in int64."""
    return torch.as_tensor(np.asarray(a).astype(np.uint32).astype(np.int64), device=device)


def block_map(m, device="cpu") -> BlockMap:
    return _fields(BlockMap, m, device, {"fp": _u32_as_int64, "fpwin": _u32_as_int64})


def sharded_block_map(sm, rank: int, device="cpu") -> BlockMap:
    """Rank `rank`'s map of the JAX package's region-sharded map, whose
    fields are stacked [n_dev, ...] on a leading mesh axis."""
    return block_map(type(sm)(*(np.asarray(a)[rank] for a in sm)), device)


def voxel_hash_map(m, device="cpu") -> VoxelHashMap:
    return _fields(VoxelHashMap, m, device, {"fp": _u32_as_int64, "fpwin": _u32_as_int64})


def any_map(m, device="cpu") -> BlockMap | GridMap:
    """A block map (it has fingerprints) or a dense grid map."""
    return block_map(m, device) if hasattr(m, "fp") else grid_map(m, device)


def ndt_map(m, device="cpu") -> NdtMap:
    return _fields(NdtMap, m, device, {"fp": _u32_as_int64, "fpwin": _u32_as_int64})


def ndt_state(s, device="cpu") -> NdtState:
    return _fields(NdtState, s, device, {"m": ndt_map})


def window_state(s, device="cpu") -> WindowMapState:
    return _fields(WindowMapState, s, device, {"m": any_map})


def p2plane_window_state(s, device="cpu") -> P2PlaneWindowState:
    return _fields(P2PlaneWindowState, s, device, {"w": window_state})


def p2plane_ivox_state(s, device="cpu") -> P2PlaneIvoxState:
    return _fields(P2PlaneIvoxState, s, device, {"m": any_map})


def loam_full_state(s, device="cpu") -> LoamFullState:
    return _fields(LoamFullState, s, device, {"corner": window_state, "planar": window_state})


def matcher_state(s, device="cpu"):
    """Any matcher state of the port's modes, told apart by its fields."""
    if hasattr(s, "first_scan"):
        return ndt_state(s, device)
    if hasattr(s, "corner"):
        return loam_full_state(s, device)
    if hasattr(s, "w"):
        return p2plane_window_state(s, device)
    if hasattr(s, "window_pts"):
        return window_state(s, device)
    return p2plane_ivox_state(s, device)


def cloud(c, device="cpu") -> Cloud:
    """A (points, mask) cloud, such as a LOAM feature cloud."""
    return _fields(Cloud, c, device)


def imu_segment(seg, device="cpu") -> ImuSegment:
    return _fields(ImuSegment, seg, device)


def scan_bundle(b, device="cpu") -> ScanBundle:
    """A preprocessed scan: timestamp, the three clouds and the IMU segment."""
    return _fields(ScanBundle, b, device, {"ordered": cloud, "planar": cloud,
                                           "corner": cloud, "imu": imu_segment})


def ordered_scan(s, device="cpu") -> OrderedScan:
    return _fields(OrderedScan, s, device)


def nav_state(n, device="cpu") -> NavState:
    return _fields(NavState, n, device)


def frontend_state(fs, device="cpu") -> FrontendState:
    return _fields(FrontendState, fs, device, {"nav": nav_state})


def cand_set(c, device="cpu") -> CandSet:
    return _fields(CandSet, c, device)


def pose_graph(g, device="cpu") -> PoseGraph:
    """A padded pose graph (`PoseGraphBuilder.to_device` of either package)."""
    return _fields(PoseGraph, g, device)


def to_numpy(tree):
    """Port state (NamedTuples of tensors, nested) -> the same NamedTuple
    types holding NumPy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
