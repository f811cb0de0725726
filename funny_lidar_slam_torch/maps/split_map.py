"""Tile-map partitioning of the global map (host side, NumPy): the port's
own copy of the JAX package's maps/split_map.py.

Re-design of SplitMap (src/slam/split_map.cpp:22-55) and the tile consumers
in localization (src/slam/localization.cpp:306-365, 665-679):

  * the global cloud is partitioned into `tile_size` (100 m) XY grid cells;
  * each tile is written as `<gx>_<gy>.pcd` next to a `tile_map_indices.txt`
    index file (one "gx gy" pair per line, split_map.cpp:41-52);
  * localization loads the 3x3 tile neighborhood around the current pose and
    evicts tiles with grid Chebyshev distance > eviction_distance.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.pcd import read_pcd, write_pcd

TILE_INDEX_FILE = "tile_map_indices.txt"
DEFAULT_TILE_SIZE = 100.0  # split_map.h tile edge (meters)


def tile_index_of(xy: np.ndarray, tile_size: float = DEFAULT_TILE_SIZE) -> np.ndarray:
    """Grid index of XY positions (split_map.cpp:27-33 floor semantics)."""
    return np.floor(np.asarray(xy) / tile_size).astype(np.int64)


def split(points: np.ndarray, tile_size: float = DEFAULT_TILE_SIZE) -> dict:
    """Partition a global cloud into {(gx, gy): points} tiles."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    idx = tile_index_of(points[:, :2], tile_size)
    tiles: dict[tuple[int, int], np.ndarray] = {}
    if len(points) == 0:
        return tiles
    keys, inv = np.unique(idx, axis=0, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(keys) + 1))
    for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        tiles[(int(keys[k, 0]), int(keys[k, 1]))] = points[order[lo:hi]]
    return tiles


def save_tiles(map_dir: str, points: np.ndarray,
               tile_size: float = DEFAULT_TILE_SIZE) -> list[tuple[int, int]]:
    """SplitMap::Split: write per-tile PCDs + the tile index file."""
    os.makedirs(map_dir, exist_ok=True)
    tiles = split(points, tile_size)
    indices = sorted(tiles.keys())
    for gx, gy in indices:
        write_pcd(os.path.join(map_dir, f"{gx}_{gy}.pcd"), tiles[(gx, gy)])
    with open(os.path.join(map_dir, TILE_INDEX_FILE), "w") as f:
        for gx, gy in indices:
            f.write(f"{gx} {gy}\n")
    return indices


def load_tile_indices(map_dir: str) -> list[tuple[int, int]]:
    """Read tile_map_indices.txt (localization.cpp:665-679)."""
    path = os.path.join(map_dir, TILE_INDEX_FILE)
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                out.append((int(parts[0]), int(parts[1])))
    return out


def load_tile(map_dir: str, gx: int, gy: int) -> np.ndarray:
    pts, _ = read_pcd(os.path.join(map_dir, f"{gx}_{gy}.pcd"))
    return pts


@dataclass
class TileMapLoader:
    """3x3 tile neighborhood with eviction (LoadTileMap,
    localization.cpp:306-365): keeps tiles whose grid Chebyshev distance to
    the current tile is <= eviction_distance, loads the missing 3x3 block."""

    map_dir: str
    tile_size: float = DEFAULT_TILE_SIZE
    eviction_distance: int = 2

    def __post_init__(self):
        self.available = set(load_tile_indices(self.map_dir))
        self.loaded: dict[tuple[int, int], np.ndarray] = {}
        self._center: tuple[int, int] | None = None

    def update(self, position_xy) -> bool:
        """Refresh around a position; returns True when the loaded set
        changed (the caller must rebuild the device-side local map)."""
        gx, gy = (int(v) for v in tile_index_of(np.asarray(position_xy), self.tile_size))
        if (gx, gy) == self._center:
            return False
        self._center = (gx, gy)
        changed = False
        for key in list(self.loaded):
            if max(abs(key[0] - gx), abs(key[1] - gy)) > self.eviction_distance:
                del self.loaded[key]
                changed = True
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                key = (gx + dx, gy + dy)
                if key not in self.loaded and key in self.available:
                    self.loaded[key] = load_tile(self.map_dir, *key)
                    changed = True
        return changed

    def local_cloud(self) -> np.ndarray:
        if not self.loaded:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(list(self.loaded.values()))
