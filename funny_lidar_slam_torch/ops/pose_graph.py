"""The pose graph's Gauss-Newton loop as a hand-written CUDA kernel (the
counterpart of the JAX package's jitted `optimize`, its `lax.fori_loop` of
15 GN steps, backend/pose_graph.py):

  * `pose_graph_gn` -> csrc/pose_graph.cu `pose_graph_gn_launch`.

On CPU tensors `pose_graph_gn` runs the plain version
(`backend/pose_graph.py::optimize_plain`); on CUDA tensors it launches the
kernel once on the current stream: one thread block runs every iteration
over the free vertices alone (the vertices whose mask is set, less vertex
0, under a compact index), eliminated in a nested-dissection order it
computes once a call, its block Cholesky and both substitutions a tree
level at a time. It reads nothing back to the host and has no fallback
between the two routes: a CUDA input the kernel does not take, or a failed
build or launch, raises.

`symbolic_plain` is the kernel's symbolic phase in NumPy (the order, the
elimination tree, its levels and L's block pattern): the tests hold their
mirror of the kernel to it, and chip_smoke.py holds the kernel's
permutation to it and counts the bound's blocks with it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .gn_loop import _checked

F32, I32 = torch.float32, torch.int32
EDGE_FLOATS = 42  # an edge's h = J^T Lam J (6x6) and g = J^T Lam e (6)
SWEEPS = 4  # kSweeps: pseudo-peripheral BFS after a part's first


def scratch_sizes(k: int, e: int) -> tuple:
    """(float32, int32) scratch elements of a graph of K vertices and E
    edges, as csrc/pose_graph.cu's `layout`: L's blocks (at most K(K+1)/2
    of 36, a filled triangle), A's diagonal blocks (36 K), 42 an edge, b,
    dj and L's inverse pivots (6 K each); the permutation first (K ints: position -> compact
    index), 13 more per-vertex arrays, 4 of K + 1, three of 2E beside the
    incident lists and three of K(K+1)/2 for L's pattern. Sized for K, so no
    host read learns how many vertices are free."""
    nb = k * (k + 1) // 2
    return nb * 36 + 54 * k + EDGE_FLOATS * e, 18 * k + 4 + 6 * e + 3 * nb


def _bfs(nbrs, where, lo, hi, root) -> tuple:
    """A BFS inside the part of positions [lo, hi) from `root`: ({vertex:
    level}, the order it reached them)."""
    lev, order = {root: 0}, [root]
    for v in order:
        for n in nbrs[v]:
            if lo <= where[n] < hi and n not in lev:
                lev[n] = lev[v] + 1
                order.append(n)
    return lev, order


def nested_dissection(nbrs) -> list:
    """The kernel's order of the compact vertices (`nbrs[c]`: the compact
    neighbours of c), position -> compact index. Parts are ranges of
    positions, each holding its vertices in ascending index, split by rounds
    (the kernel: a thread a part). A part of one vertex is placed; else a
    BFS from its smallest vertex; if that does not reach the whole part, the
    part splits into its connected components in the order of their
    smallest vertices; else up to SWEEPS more BFS from the smallest vertex
    of the last level while the eccentricity e grows, and the part splits
    into the levels below e // 2, those above, and the separator (level
    e // 2), in that order."""
    nf = len(nbrs)
    pv, where = list(range(nf)), list(range(nf))
    active = [(0, nf)] if nf else []

    def place(groups, lo):
        p, parts = lo, []
        for grp in groups:
            for v in grp:
                pv[p], where[v] = v, p
                p += 1
            parts.append((p - len(grp), p))
        return parts

    while active:
        nxt = []
        for lo, hi in active:
            part = pv[lo:hi]
            if hi - lo == 1:
                continue
            lev, order = _bfs(nbrs, where, lo, hi, part[0])
            if len(order) < hi - lo:
                label, ncomp = {}, 0
                for v in part:
                    if v not in label:
                        label.update(dict.fromkeys(_bfs(nbrs, where, lo, hi, v)[1], ncomp))
                        ncomp += 1
                nxt += place([[v for v in part if label[v] == c] for c in range(ncomp)], lo)
                continue
            ecc = max(lev.values())
            for _ in range(SWEEPS):
                cand = min(v for v in order if lev[v] == ecc)
                lev, order = _bfs(nbrs, where, lo, hi, cand)
                grew = max(lev.values()) > ecc
                ecc = max(lev.values())
                if not grew:
                    break
            m = ecc // 2
            groups = [[v for v in part if lev[v] < m], [v for v in part if lev[v] > m],
                      [v for v in part if lev[v] == m]]
            nxt += [r for r, grp in zip(place(groups, lo), groups[:2]) if grp]
        active = nxt
    return pv


def compact_graph(pose_mask, edge_i, edge_j, edge_mask) -> tuple:
    """(vid, nbrs): the free vertices (mask set, less vertex 0) in index
    order, and each one's compact neighbours over the edges that count
    (mask set, both ends in [0, K)), in edge order, a self-loop left out."""
    mask = np.asarray(pose_mask, bool).copy()
    k = len(mask)
    mask[0] = False
    vid = np.flatnonzero(mask)
    cidx = np.full(k, -1)
    cidx[vid] = np.arange(len(vid))
    nbrs = [[] for _ in vid]
    for a, b, used in zip(np.asarray(edge_i), np.asarray(edge_j), np.asarray(edge_mask)):
        if used and 0 <= a < k and 0 <= b < k and cidx[a] >= 0 and cidx[b] >= 0 \
                and cidx[a] != cidx[b]:
            nbrs[cidx[a]].append(int(cidx[b]))
            nbrs[cidx[b]].append(int(cidx[a]))
    return vid, nbrs


def symbolic_plain(pose_mask, edge_i, edge_j, edge_mask, order=nested_dissection) -> dict:
    """The kernel's symbolic phase on a graph's structure (NumPy arrays or
    tensors): `vid` (compact index -> vertex), `perm` (position -> compact
    index, the kernel's int scratch's first n_f entries), `where` (its
    inverse), `parent` (the elimination tree by position, -1 at a root),
    `level` (leaves 0), `height`, `rows` (each row's columns k < i with
    L_ik != 0, ascending), `cols` (each column's rows below the diagonal,
    ascending) and `levels` (the columns of each level, ascending).
    `order(nbrs)` gives the permutation: the kernel's nested dissection,
    or any other (the natural order: `lambda nbrs: range(len(nbrs))`)."""
    as_np = [t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
             for t in (pose_mask, edge_i, edge_j, edge_mask)]
    vid, nbrs = compact_graph(*as_np)
    nf = len(vid)
    perm = list(order(nbrs))
    where = [0] * nf
    for p, c in enumerate(perm):
        where[c] = p
    parent, flag, rows = [-1] * nf, [-1] * nf, [[] for _ in range(nf)]
    for i in range(nf):  # Liu's row-subtree walk
        flag[i] = i
        for o in nbrs[perm[i]]:
            j = where[o]
            while j < i and flag[j] != i:
                flag[j] = i
                rows[i].append(j)
                if parent[j] < 0:
                    parent[j] = i
                j = parent[j]
        rows[i].sort()
    cols = [[] for _ in range(nf)]
    for i in range(nf):
        for j in rows[i]:
            cols[j].append(i)
    level = [0] * nf
    for j in range(nf):
        if parent[j] >= 0:
            level[parent[j]] = max(level[parent[j]], level[j] + 1)
    height = max(level) + 1 if nf else 0
    return {"vid": vid, "perm": np.asarray(perm, np.int64), "where": np.asarray(where, np.int64),
            "parent": parent, "level": level, "height": height, "rows": rows, "cols": cols,
            "levels": [[j for j in range(nf) if level[j] == h] for h in range(height)]}


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
