"""One mesh axis over torch.distributed: the counterpart of a 1-D
`jax.sharding.Mesh` and of the collectives that the JAX package's
`shard_map` bodies use.

Every collective is an `all_reduce`: NCCL and gloo, on CPU and on CUDA
tensors, all provide it (gloo has no `reduce_scatter` or `all_gather` on
CUDA tensors). A mesh of one rank needs no process group, and its
collectives are the identity.

Every rank runs the same program on replicated values, so every loop exit
and every branch that leads to a collective must be decided from values
that all ranks hold alike, or the ranks stop at different collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.device import resolve_device


class Mesh(NamedTuple):
    group: object  # the process group (None: the default one)
    rank: int
    size: int
    device: torch.device

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the ranks (`jax.lax.psum`), on a copy."""
        if self.size == 1:
            return x
        y = x.clone()
        dist.all_reduce(y, group=self.group)
        return y

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's row block of the sum of x over the ranks
        (`jax.lax.psum_scatter`, tiled on dim 0)."""
        return self.shard_rows(self.psum(x))

    def axis_index(self) -> int:
        return self.rank

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of dim 0, as `PartitionSpec(axis)`
        lays it out; dim 0 must divide by the mesh size."""
        n = x.shape[0]
        assert n % self.size == 0, f"dim 0 {n} % mesh {self.size} != 0"
        per = n // self.size
        return x[self.rank * per:(self.rank + 1) * per]


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of `group` (None: the default process group, or one rank
    when no process group is initialized) on `device` (None:
    `cuda:{rank % device_count}`; raises without CUDA)."""
    if dist.is_initialized():
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        assert group is None, "a process group needs torch.distributed initialized"
        rank, size = 0, 1
    if device is None:
        resolve_device(None)  # raises without CUDA
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group, rank, size, torch.device(device))
