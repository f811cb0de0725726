"""Host-side keyframe store with npz persistence (port of
pipeline/keyframes.py).

Laziness: the retire loop keeps DEVICE references to a keyframe's deskewed
cloud and, in LOAM-geometry modes, to its corner and planar feature clouds;
`materialize_batch` fetches a whole batch of lazy keyframes, clouds and
features together, with one device->host copy, off the per-frame path.

Persistence: `keyframe_{i}.npz` per keyframe (timestamp, pose, cloud,
planar, corner) and a `poses.npy` sidecar of the current poses, which
overrides the npz poses on `load` after a loop closure rewrote them. The
keys and dtypes are the JAX package's, so a store written by either package
loads in the other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch


class KeyFrame:
    """One keyframe. `cloud` (deskewed body-frame points) and the feature
    clouds `corner`/`planar` are host arrays, or lazy device references
    until materialized: `cloud_dev` is (points [N,3], mask [N]), `feat_dev`
    (corner points, corner mask, planar points, planar mask) or None."""

    def __init__(self, kf_id: int, timestamp: float, pose: np.ndarray,
                 cloud: np.ndarray | None = None, planar=None, corner=None,
                 cloud_dev=None, feat_dev=None):
        self.kf_id = kf_id
        self.timestamp = timestamp
        self.pose = pose
        self._cloud, self._planar, self._corner = cloud, planar, corner
        self._cloud_dev = cloud_dev
        self._feat_dev = feat_dev

    @property
    def materialized(self) -> bool:
        return self._cloud_dev is None and self._feat_dev is None

    def materialize(self) -> None:
        """Fetch this keyframe's pending device clouds with one copy; a
        no-op once materialized."""
        materialize_batch([self])

    @property
    def cloud(self) -> np.ndarray:
        materialize_batch([self])
        return self._cloud

    @cloud.setter
    def cloud(self, v) -> None:
        self._cloud = v
        self._cloud_dev = None

    @property
    def corner(self) -> np.ndarray | None:
        materialize_batch([self])
        return self._corner

    @corner.setter
    def corner(self, v) -> None:
        self._corner = v

    @property
    def planar(self) -> np.ndarray | None:
        materialize_batch([self])
        return self._planar

    @planar.setter
    def planar(self, v) -> None:
        self._planar = v

    def _pending(self) -> list:
        """The lazy (points, mask) pairs, in the order `_fill` takes them."""
        out = [self._cloud_dev] if self._cloud_dev is not None else []
        if self._feat_dev is not None:
            out += [self._feat_dev[:2], self._feat_dev[2:]]
        return out

    def _fill(self, clouds: list) -> None:
        if self._cloud_dev is not None:
            self._cloud = clouds.pop(0)
        if self._feat_dev is not None:
            self._corner, self._planar = clouds
        self._cloud_dev = self._feat_dev = None


def materialize_batch(kfs) -> None:
    """Fetch the device clouds of all lazy keyframes in `kfs` with one copy:
    every pending (points, mask) pair is flattened into one f32 vector
    (points, then the mask as 0/1), and the vectors are concatenated on the
    device first."""
    lazy = [kf for kf in kfs if not kf.materialized]
    if not lazy:
        return
    pairs = [kf._pending() for kf in lazy]
    flat = [torch.cat([p.reshape(-1).float(), m.float()]) for kp in pairs for p, m in kp]
    host = torch.cat(flat).cpu().numpy()
    o = 0
    for kf, kp in zip(lazy, pairs):
        clouds = []
        for p, m in kp:
            n = m.shape[0]
            pts = host[o:o + 3 * n].reshape(n, 3)
            msk = host[o + 3 * n:o + 4 * n] > 0.5
            clouds.append(pts[msk].astype(np.float32))
            o += 4 * n
        kf._fill(clouds)


@dataclass
class KeyFrameStore:
    save_dir: str | None = None
    frames: list = field(default_factory=list)

    def add(self, kf: KeyFrame) -> None:
        """Register a keyframe; one already on the host is written now, a
        lazy one by `flush` after its batch's copy."""
        self.frames.append(kf)
        if self.save_dir and kf.materialized:
            self.flush(kf)

    def flush(self, kf: KeyFrame) -> None:
        """Write one keyframe's npz (fetching it first if still lazy)."""
        if not self.save_dir:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(self.save_dir, f"keyframe_{kf.kf_id}.npz"),
            timestamp=kf.timestamp,
            pose=kf.pose,
            cloud=kf.cloud,
            planar=kf.planar if kf.planar is not None else np.zeros((0, 3)),
            corner=kf.corner if kf.corner is not None else np.zeros((0, 3)),
        )

    def flush_poses(self) -> None:
        """Write the current poses to the `poses.npy` sidecar: a loop
        closure rewrites every pose, and one small file replaces N npz
        rewrites."""
        if not self.save_dir or not self.frames:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        np.save(os.path.join(self.save_dir, "poses.npy"), self.poses())

    def __len__(self) -> int:
        return len(self.frames)

    def poses(self) -> np.ndarray:
        return np.stack([f.pose for f in self.frames]) if self.frames else np.zeros((0, 4, 4))

    def set_poses(self, poses: np.ndarray) -> None:
        """Rewrite all keyframe poses (after a pose-graph optimization)."""
        for f, p in zip(self.frames, poses):
            f.pose = np.asarray(p)

    @staticmethod
    def load(save_dir: str) -> "KeyFrameStore":
        """Read `keyframe_0.npz`, `keyframe_1.npz`, ... up to the first gap;
        the sidecar's poses override when it covers every keyframe."""
        store = KeyFrameStore(save_dir=save_dir)
        i = 0
        while os.path.exists(path := os.path.join(save_dir, f"keyframe_{i}.npz")):
            z = np.load(path)
            store.frames.append(KeyFrame(
                kf_id=i, timestamp=float(z["timestamp"]), pose=z["pose"], cloud=z["cloud"],
                planar=z["planar"] if len(z["planar"]) else None,
                corner=z["corner"] if len(z["corner"]) else None))
            i += 1
        pose_path = os.path.join(save_dir, "poses.npy")
        if os.path.exists(pose_path):
            poses = np.load(pose_path)
            if len(poses) >= len(store.frames):
                store.set_poses(poses[: len(store.frames)])
        return store
