"""Host-side keyframe store (port of pipeline/keyframes.py).

Laziness: the retire loop keeps DEVICE references to a keyframe's deskewed
cloud and, in LOAM-geometry modes, to its corner and planar feature clouds;
`materialize_batch` fetches a whole batch of lazy keyframes, clouds and
features together, with one device->host copy, off the per-frame path.
Keyframe persistence (the JAX package's npz files) comes with resume, a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


class KeyFrame:
    """One keyframe. `cloud` (deskewed body-frame points) and the feature
    clouds `corner`/`planar` are lazy device references until materialized:
    `cloud_dev` is (points [N,3], mask [N]), `feat_dev` (corner points,
    corner mask, planar points, planar mask) or None."""

    def __init__(self, kf_id: int, timestamp: float, pose: np.ndarray, cloud_dev,
                 feat_dev=None):
        self.kf_id = kf_id
        self.timestamp = timestamp
        self.pose = pose
        self._cloud = self._corner = self._planar = None
        self._cloud_dev = cloud_dev
        self._feat_dev = feat_dev

    @property
    def materialized(self) -> bool:
        return self._cloud_dev is None and self._feat_dev is None

    @property
    def cloud(self) -> np.ndarray:
        materialize_batch([self])
        return self._cloud

    @property
    def corner(self) -> np.ndarray | None:
        materialize_batch([self])
        return self._corner

    @property
    def planar(self) -> np.ndarray | None:
        materialize_batch([self])
        return self._planar

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
    frames: list = field(default_factory=list)

    def add(self, kf: KeyFrame) -> None:
        self.frames.append(kf)

    def __len__(self) -> int:
        return len(self.frames)
