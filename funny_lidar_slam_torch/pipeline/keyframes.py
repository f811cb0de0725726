"""Host-side keyframe store (port of pipeline/keyframes.py).

Laziness: the retire loop keeps DEVICE references to a keyframe's deskewed
cloud; `materialize_batch` fetches a whole batch of lazy keyframes with one
device->host copy, off the per-frame path. Keyframe persistence (the JAX
package's npz files) comes with resume, a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


class KeyFrame:
    """One keyframe; `cloud` (deskewed body-frame points) is a lazy device
    reference (points [N,3], mask [N]) until materialized."""

    def __init__(self, kf_id: int, timestamp: float, pose: np.ndarray, cloud_dev):
        self.kf_id = kf_id
        self.timestamp = timestamp
        self.pose = pose
        self._cloud = None
        self._cloud_dev = cloud_dev

    @property
    def materialized(self) -> bool:
        return self._cloud_dev is None

    @property
    def cloud(self) -> np.ndarray:
        materialize_batch([self])
        return self._cloud


def materialize_batch(kfs) -> None:
    """Fetch the device clouds of all lazy keyframes in `kfs` with one copy
    of their points and one of their masks: the clouds, of equal capacity,
    are stacked on the device first."""
    lazy = [kf for kf in kfs if not kf.materialized]
    if not lazy:
        return
    pts = torch.stack([kf._cloud_dev[0] for kf in lazy]).cpu().numpy()
    msk = torch.stack([kf._cloud_dev[1] for kf in lazy]).cpu().numpy()
    for kf, p, m in zip(lazy, pts, msk):
        kf._cloud = p[m].astype(np.float32)
        kf._cloud_dev = None


@dataclass
class KeyFrameStore:
    frames: list = field(default_factory=list)

    def add(self, kf: KeyFrame) -> None:
        self.frames.append(kf)

    def __len__(self) -> int:
        return len(self.frames)
