"""SE(3) pose-graph optimization, batched over edges (port of
backend/pose_graph.py).

Vertices are keyframe poses (vertex 0 fixed); edges carry a relative SE(3)
measurement with a diagonal 6x6 information. Residual and Jacobians, in the
[translation, rotation] tangent:
    e   = Log(T_m^-1 T_i^-1 T_j)
    J_i = -Jr(e)^-1 Adj(T_j^-1)
    J_j = +Jr(e)^-1 Adj(T_j^-1)

Each GN iteration scatters the per-edge blocks into a dense [6K, 6K]
system (K = the vertex capacity), Jacobi-equilibrates it and solves it by
Cholesky on the device, then applies a left-multiplicative update.

`optimize` dispatches: on CPU tensors the plain version `optimize_plain`,
on CUDA tensors one launch of csrc/pose_graph.cu (ops/pose_graph.py::
pose_graph_gn), which runs every iteration on the card over the free
vertices alone, its H and b summed in a fixed order and eliminated in a
nested-dissection order, a tree level at a time.

Port notes on the plain version: the JAX `fori_loop` is a host loop that
reads nothing back. The four `.at[i, j].add` are
`index_put_(accumulate=True)`, whose repeated indices add in no fixed order
on the card. The solve is `cholesky_ex` + `cholesky_solve` and the 6x6
inverses `inv_ex`, none of which checks its result on the host; a
factorization that fails gives NaN poses, as the JAX Cholesky does.
`PoseGraphBuilder` is the JAX package's NumPy bookkeeping.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.lie import mat_to_quat, se3_adj, se3_exp, se3_inv, se3_jr, se3_log


class PoseGraph(NamedTuple):
    """Padded pose-graph state (static capacities)."""

    poses: torch.Tensor  # [K, 4, 4]
    pose_mask: torch.Tensor  # [K] bool
    edge_i: torch.Tensor  # [E] int32
    edge_j: torch.Tensor  # [E] int32
    edge_meas: torch.Tensor  # [E, 4, 4] T_i^-1 T_j measurement
    edge_info: torch.Tensor  # [E, 6] diagonal information [t, r]
    edge_mask: torch.Tensor  # [E] bool


def create(k_cap: int, e_cap: int, dtype=torch.float32, device="cpu") -> PoseGraph:
    eye = torch.eye(4, dtype=dtype, device=device)
    return PoseGraph(
        poses=eye.expand(k_cap, 4, 4).clone(),
        pose_mask=torch.zeros(k_cap, dtype=torch.bool, device=device),
        edge_i=torch.zeros(e_cap, dtype=torch.int32, device=device),
        edge_j=torch.zeros(e_cap, dtype=torch.int32, device=device),
        edge_meas=eye.expand(e_cap, 4, 4).clone(),
        edge_info=torch.zeros((e_cap, 6), dtype=dtype, device=device),
        edge_mask=torch.zeros(e_cap, dtype=torch.bool, device=device),
    )


def _edge_residuals(g: PoseGraph):
    t_i = g.poses[g.edge_i.long()]
    t_j = g.poses[g.edge_j.long()]
    e = se3_log(se3_inv(g.edge_meas) @ se3_inv(t_i) @ t_j)  # [E, 6]
    jr_inv = torch.linalg.inv_ex(se3_jr(e)).inverse
    j_j = jr_inv @ se3_adj(se3_inv(t_j))  # [E, 6, 6]
    return e, -j_j, j_j


def optimize(g: PoseGraph, iterations: int = 15, damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton over the graph, vertex 0 and the unused vertices fixed:
    `optimize_plain` on CPU tensors, one `pose_graph_gn` launch on CUDA
    tensors (which raises on what the kernel does not take)."""
    if g.poses.device.type == "cpu":
        return optimize_plain(g, iterations, damping)
    from ..ops.pose_graph import pose_graph_gn

    return pose_graph_gn(g, iterations, damping)


def optimize_plain(g: PoseGraph, iterations: int = 15, damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton over the whole graph; vertex 0 gated (fixed), unused
    vertices pinned with identity blocks."""
    k = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    lam = g.edge_info * g.edge_mask.to(dtype)[:, None]  # [E, 6]
    free = g.pose_mask.clone()
    free[0] = False
    d = free.to(dtype).repeat_interleave(6)
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)

    poses = g.poses
    for _ in range(iterations):
        e, j_i, j_j = _edge_residuals(g._replace(poses=poses))
        jtl_i = j_i.transpose(-1, -2) * lam[:, None, :]  # J_i^T Lambda
        jtl_j = j_j.transpose(-1, -2) * lam[:, None, :]
        h = torch.zeros((k, k, 6, 6), dtype=dtype, device=dev)
        h.index_put_((ei, ei), jtl_i @ j_i, accumulate=True)
        h.index_put_((ei, ej), jtl_i @ j_j, accumulate=True)
        h.index_put_((ej, ei), jtl_j @ j_i, accumulate=True)
        h.index_put_((ej, ej), jtl_j @ j_j, accumulate=True)
        b = torch.zeros((k, 6), dtype=dtype, device=dev)
        b.index_add_(0, ei, torch.einsum("eab,eb->ea", jtl_i, e))
        b.index_add_(0, ej, torch.einsum("eab,eb->ea", jtl_j, e))

        h = h.permute(0, 2, 1, 3).reshape(k * 6, k * 6)
        h = h * d[:, None] * d[None, :]
        h.diagonal().add_(1.0 - d)
        b = b.reshape(k * 6) * d

        # Jacobi equilibration: lever arms of O(radius) put H entries at
        # O(info * r^2), and the raw f32 Cholesky loses the step at > 100 m;
        # D H D y = D b with D = diag(H)^-1/2 is the same step
        dj = torch.rsqrt(torch.clamp(torch.diagonal(h), min=1e-12))
        hs = h * dj[:, None] * dj[None, :]
        hs.diagonal().add_(damping)
        chol, info = torch.linalg.cholesky_ex(hs)
        chol = torch.where(info == 0, chol, nan)
        dx = dj * torch.cholesky_solve((-(b * dj))[:, None], chol)[:, 0]

        # left-multiplicative SE(3) update (the Adj(T_j^-1) factor of the
        # edge Jacobians is the left perturbation convention)
        poses = torch.where(free[:, None, None], se3_exp(dx.reshape(k, 6)) @ poses, poses)
    return g._replace(poses=poses)


class PoseGraphBuilder:
    """Host-side incremental graph bookkeeping (NumPy): a vertex and an
    odometry edge per keyframe, loop edges, geometric growth."""

    # odometry edge information diag(1,1,1,100,100,100) [t, r]
    ODOM_INFO = (1.0, 1.0, 1.0, 100.0, 100.0, 100.0)

    def __init__(self, k_cap: int = 512, e_cap: int = 1024):
        self.k_cap = k_cap
        self.e_cap = e_cap
        self.poses = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
        self.pose_mask = np.zeros(k_cap, bool)
        self.edge_i = np.zeros(e_cap, np.int32)
        self.edge_j = np.zeros(e_cap, np.int32)
        self.edge_meas = np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1))
        self.edge_info = np.zeros((e_cap, 6), np.float32)
        self.edge_mask = np.zeros(e_cap, bool)
        self.n_vertices = 0
        self.n_edges = 0

    def _grow_vertices(self) -> None:
        """Double the vertex capacity (geometric, so the solve sees few
        distinct sizes)."""
        new_cap = self.k_cap * 2
        poses = np.tile(np.eye(4, dtype=np.float32), (new_cap, 1, 1))
        poses[: self.k_cap] = self.poses
        mask = np.zeros(new_cap, bool)
        mask[: self.k_cap] = self.pose_mask
        self.poses, self.pose_mask, self.k_cap = poses, mask, new_cap

    def _grow_edges(self) -> None:
        new_cap = self.e_cap * 2
        ei = np.zeros(new_cap, np.int32); ei[: self.e_cap] = self.edge_i
        ej = np.zeros(new_cap, np.int32); ej[: self.e_cap] = self.edge_j
        meas = np.tile(np.eye(4, dtype=np.float32), (new_cap, 1, 1))
        meas[: self.e_cap] = self.edge_meas
        info = np.zeros((new_cap, 6), np.float32); info[: self.e_cap] = self.edge_info
        msk = np.zeros(new_cap, bool); msk[: self.e_cap] = self.edge_mask
        self.edge_i, self.edge_j, self.edge_meas = ei, ej, meas
        self.edge_info, self.edge_mask, self.e_cap = info, msk, new_cap

    def add_vertex(self, pose, odom_meas=None) -> int:
        """Add a keyframe vertex + odometry edge to the previous one. With
        `odom_meas` (the odometry-frame relative pose) the vertex's initial
        value is re-based on the previous, possibly loop-corrected, vertex."""
        i = self.n_vertices
        if i >= self.k_cap:
            self._grow_vertices()
        if i > 0 and odom_meas is not None:
            self.poses[i] = self.poses[i - 1] @ np.asarray(odom_meas, np.float32)
        else:
            self.poses[i] = np.asarray(pose, np.float32)
        self.pose_mask[i] = True
        self.n_vertices += 1
        if i > 0:
            meas = (np.asarray(odom_meas, np.float32) if odom_meas is not None
                    else np.linalg.inv(self.poses[i - 1]) @ self.poses[i])
            self.add_edge(i - 1, i, meas, self.ODOM_INFO)
        return i

    def add_edge(self, i: int, j: int, meas, info) -> None:
        e = self.n_edges
        if e >= self.e_cap:
            self._grow_edges()
        self.edge_i[e] = i
        self.edge_j[e] = j
        self.edge_meas[e] = np.asarray(meas, np.float32)
        self.edge_info[e] = np.asarray(info, np.float32)
        self.edge_mask[e] = True
        self.n_edges += 1

    def to_device(self, dtype=torch.float32, device=None) -> PoseGraph:
        """The graph as tensors on `device` (default: CUDA)."""
        dev = resolve_device(device)

        def t(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=dev)

        return PoseGraph(poses=t(self.poses, dtype), pose_mask=t(self.pose_mask),
                         edge_i=t(self.edge_i), edge_j=t(self.edge_j),
                         edge_meas=t(self.edge_meas, dtype), edge_info=t(self.edge_info, dtype),
                         edge_mask=t(self.edge_mask))

    def set_poses(self, poses) -> None:
        self.poses[: self.n_vertices] = np.asarray(poses)[: self.n_vertices]

    def save_g2o(self, path: str) -> None:
        """.g2o export: VERTEX_SE3:QUAT and EDGE_SE3:QUAT lines, quaternions
        [x y z w], the information's upper triangle row by row."""
        def quat(m):
            return mat_to_quat(torch.as_tensor(m[:3, :3])).numpy()

        with open(path, "w") as f:
            for i in range(self.n_vertices):
                p = self.poses[i]
                q = quat(p)
                f.write(f"VERTEX_SE3:QUAT {i} {p[0,3]} {p[1,3]} {p[2,3]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")
            for e in range(self.n_edges):
                m = self.edge_meas[e]
                q = quat(m)
                info = np.zeros((6, 6))
                np.fill_diagonal(info, self.edge_info[e])
                upper = " ".join(str(info[r, c]) for r in range(6) for c in range(r, 6))
                f.write(f"EDGE_SE3:QUAT {self.edge_i[e]} {self.edge_j[e]} "
                        f"{m[0,3]} {m[1,3]} {m[2,3]} {q[1]} {q[2]} {q[3]} {q[0]} {upper}\n")
