"""The pose graph's Gauss-Newton loop as a hand-written CUDA kernel (the
counterpart of the JAX package's jitted `optimize`, its `lax.fori_loop` of
15 GN steps, backend/pose_graph.py):

  * `pose_graph_gn` -> csrc/pose_graph.cu `pose_graph_gn_launch`.

On CPU tensors `pose_graph_gn` runs the plain version
(`backend/pose_graph.py::optimize_plain`); on CUDA tensors it launches the
kernel once on the current stream: one thread block runs every iteration
over the free vertices alone (the vertices whose mask is set, less vertex
0, under a compact index), factoring their system by 6x6 vertex blocks and
skipping the blocks no edge or update writes. It reads nothing back to the
host and has no fallback between the two routes: a CUDA input the kernel
does not take, or a failed build or launch, raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .gn_loop import _checked

F32, I32 = torch.float32, torch.int32
EDGE_FLOATS = 42  # an edge's h = J^T Lam J (6x6) and g = J^T Lam e (6)


def scratch_sizes(k: int, e: int) -> tuple:
    """(float32, int32) scratch elements of a graph of K vertices and E
    edges, as csrc/pose_graph.cu's `layout`: the packed lower block triangle
    (K(K+1)/2 blocks of 36), 42 an edge and three 6K vectors; the compact
    index, the vertex of each index, the list offsets and cursors, the
    incident lists (2E) and an epoch a block. Sized for K, so no host read
    learns how many vertices are free; the kernel touches the first
    n_f(n_f+1)/2 blocks."""
    nb = k * (k + 1) // 2
    return nb * 36 + EDGE_FLOATS * e + 18 * k, 4 * k + 1 + 2 * e + nb


def _checked_graph(g) -> list:
    """The graph's tensors in pose_graph_gn_launch's order, each of its
    dtype, contiguous and of its shape, all on one CUDA device: poses
    float32 [K, 4, 4], pose_mask bool [K], edge_i and edge_j int32 [E],
    edge_meas float32 [E, 4, 4], edge_info float32 [E, 6], edge_mask bool
    [E]."""
    k, e = g.poses.shape[0], g.edge_i.shape[0]
    if k < 1:
        raise ValueError("pose_graph_gn: a graph of no vertex")
    return _checked("pose_graph_gn", {
        "poses": (g.poses, F32, (k, 4, 4)), "pose_mask": (g.pose_mask, torch.bool, (k,)),
        "edge_i": (g.edge_i, I32, (e,)), "edge_j": (g.edge_j, I32, (e,)),
        "edge_meas": (g.edge_meas, F32, (e, 4, 4)), "edge_info": (g.edge_info, F32, (e, 6)),
        "edge_mask": (g.edge_mask, torch.bool, (e,))})


def pose_graph_gn(g, iterations: int = 15, damping: float = 1e-6):
    """`optimize` of a PoseGraph: on CPU tensors the plain version, on CUDA
    tensors one kernel launch on the current stream (the output and the
    scratch allocated here with torch.empty), raising on an input of another
    dtype, shape or device, a non-contiguous input, a negative iteration
    count or a CUDA error. Returns the graph with its new poses."""
    from ..backend import pose_graph

    if all(t.device.type == "cpu" for t in g):
        return pose_graph.optimize_plain(g, iterations, damping)
    if int(iterations) < 0:
        raise ValueError(f"pose_graph_gn: {iterations} iterations")
    tensors = _checked_graph(g)
    k, e = g.poses.shape[0], g.edge_i.shape[0]
    n_float, n_int = scratch_sizes(k, e)
    dev = g.poses.device
    out = torch.empty_like(g.poses)
    fs = torch.empty(n_float, dtype=F32, device=dev)
    ints = torch.empty(n_int, dtype=I32, device=dev)
    err = cuda_build.library("pose_graph").pose_graph_gn_launch(
        *(t.data_ptr() for t in tensors), out.data_ptr(), fs.data_ptr(), ints.data_ptr(),
        n_float, n_int, k, e, int(iterations), float(damping),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_graph_gn launch failed: CUDA error {err}")
    pose_graph_gn.launches += 1
    return g._replace(poses=out)


pose_graph_gn.launches = 0
KERNELS = (pose_graph_gn,)
