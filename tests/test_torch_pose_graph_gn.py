"""Port parity: the pose graph's GN loop kernel (csrc/pose_graph.cu,
ops/pose_graph.py::pose_graph_gn), through a NumPy mirror of its algorithm,
against the JAX package's jitted `optimize` on the CPU, on chip_smoke.py's
graphs (`pose_graph_builders`: the 60-pose noisy circle in k_cap 64 with 1
and 8 extra loops, 2 vertices, 1 vertex, 70 vertices grown from k_cap 64, a
used vertex no edge touches, a factorization that fails). The mirror
repeats the kernel's algorithm: the compaction of the free vertices, the
nested-dissection order and the elimination tree of
ops/pose_graph.py::symbolic_plain, each vertex's incident edges summed in
edge order at its position (a block below the diagonal by the later
vertex), the left-looking block Cholesky a tree level at a time, each block
less its fan-in over the common row-list entries (k ascending), the two
block substitutions by levels, NaN at every free vertex on a pivot that is
not > 0. Tolerances: float64 poses within 1e-8 of JAX's
(tests/test_torch_backend.py's f64 tolerance); float32 within 2e-3 m and
1e-3 rad (the chord angle), that test's f32 tolerance for 15 GN steps
through two differently ordered f32 Cholesky factorizations; NaN at the same
vertices. Also: the order is a permutation of the free vertices on every
graph, the dry run's and a 4,000-keyframe session's included; L's symbolic
pattern holds every nonzero block of a dense Cholesky of the permuted
system; the dry run's order cuts the natural order's 15,105,149 block
updates at least 100x, with a tree of at most 64 levels; an 84-vertex
chain's tree is at most 2 log2(n_f) + 2 levels high; the mirror's block
counts against chip_smoke.pose_graph_structure's in the kernel's order,
and the phase's bound counting no more than the cheaper of that order and
the natural order; chip_smoke's mirror of where the kernel keeps its
arrays against the source; optimize on CPU tensors bit for bit the plain version, with no
launch and no build; the staged copy of the plain version that
tools/profile_torch_pose_graph.py times, bit for bit the plain version; the
kernel's C signature and scratch layout; the wrapper's refusals."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from funny_lidar_slam_tpu.backend import pose_graph as jpg
from funny_lidar_slam_torch.backend import pose_graph as tpg
from funny_lidar_slam_torch.core.lie import chord_angle
from funny_lidar_slam_torch.ops import cuda_build
from funny_lidar_slam_torch.ops import pose_graph as opg

torch.set_num_threads(1)

CSRC = Path(opg.__file__).resolve().parents[1] / "csrc"
ROOT = Path(__file__).resolve().parents[1]
GRAPHS = ("circle 60, 1 loops", "circle 60, 8 loops", "2 vertices", "1 vertex",
          "70 vertices grown from k_cap 64", "a used vertex with no edge",
          "failing factorization")
EPS = {np.float32: 1e-7, np.float64: 1e-12}


@pytest.fixture(scope="module")
def builders():
    return chip_smoke.pose_graph_builders()


def arrays(b):
    return (b.poses, b.pose_mask, b.edge_i, b.edge_j, b.edge_meas, b.edge_info, b.edge_mask)


# ------------------------------------------------ the kernel's algorithm in NumPy
def hat(v):
    z = np.zeros_like(v[0])
    return np.array([[z, -v[2], v[1]], [v[2], z, -v[0]], [-v[1], v[0], z]], dtype=v.dtype)


def rodrigues(v, a, b):
    vx = hat(v)
    return np.eye(3, dtype=v.dtype) + a * vx + b * (vx @ vx)


def angle(v, dt):
    """(theta^2, theta, the clamped theta, small) as core/lie.py takes them."""
    th2 = dt(v @ v)
    th = np.sqrt(th2)
    return th2, th, max(th, dt(EPS[dt])), th < np.sqrt(dt(EPS[dt]))


def so3_exp(v, dt):
    th2, _, safe, small = angle(v, dt)
    a = dt(1) - th2 / dt(6) if small else np.sin(safe) / safe
    b = dt(0.5) - th2 / dt(24) if small else (dt(1) - np.cos(safe)) / (safe * safe)
    return rodrigues(v, dt(a), dt(b))


def so3_jl(v, dt):
    th2, _, safe, small = angle(v, dt)
    a = dt(0.5) - th2 / dt(24) if small else (dt(1) - np.cos(safe)) / (safe * safe)
    b = dt(1 / 6) - th2 / dt(120) if small else (safe - np.sin(safe)) / (safe * safe * safe)
    return rodrigues(v, dt(a), dt(b))


def so3_jl_inv(v, dt):
    th2, _, safe, small = angle(v, dt)
    half = safe / dt(2)
    cot = (dt(1 / 12) + th2 / dt(720) if small
           else dt(1) / (safe * safe) - np.cos(half) / (dt(2) * safe * np.sin(half)))
    return rodrigues(v, dt(-0.5), dt(cot))


def so3_log(m, dt):
    """Through the quaternion: the first largest Shepperd pivot, w >= 0."""
    one, tr = dt(1), m[0, 0] + m[1, 1] + m[2, 2]
    cands = [[one + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
             [m[2, 1] - m[1, 2], one + m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0],
              m[0, 2] + m[2, 0]],
             [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], one - m[0, 0] + m[1, 1] - m[2, 2],
              m[1, 2] + m[2, 1]],
             [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
              one - m[0, 0] - m[1, 1] + m[2, 2]]]
    q = np.array(cands[int(np.argmax([c[k] for k, c in enumerate(cands)]))], dt)
    q = q / np.sqrt(q @ q)
    q = -q if q[0] < 0 else q
    eps, nv = dt(EPS[dt]), np.sqrt(q[1:] @ q[1:])
    if nv < eps:
        return dt(2) * q[1:] / max(q[0], eps)
    return dt(2) * np.arctan2(nv, q[0]) * (q[1:] / max(nv, eps))


def q_block(rho, phi, dt):
    """lie._se3_q_block with its coefficients in float64 (the kernel's)."""
    th2, th, safe, _ = angle(phi, dt)
    c = (1 / 6, 1 / 24, 1 / 120)
    if not th2 < dt(EPS[dt]):
        s = float(safe)
        st, ct, it = np.sin(s), np.cos(s), 1.0 / s
        it2, it4 = it * it, it ** 4
        c = (it2 - st * it2 * it, 0.5 * it2 + ct * it4 - it4,
             it4 + 0.5 * ct * it4 - 1.5 * st * it * it4)
    c1, c2, c3 = (dt(x) for x in c)
    u, w = hat(rho), hat(phi)
    wu, uw = w @ u, u @ w
    wuw = wu @ w
    return (dt(0.5) * u + c1 * (wu + uw + wuw) - c2 * (th2 * u + dt(2) * wuw)
            + c3 * (wuw @ w + w @ wuw))


def inv3(a, dt):
    """Gauss-Jordan with partial pivoting (the kernel's inv3)."""
    m = np.concatenate([a, np.eye(3, dtype=dt)], axis=1).astype(dt)
    for c in range(3):
        p = c + int(np.argmax(np.abs(m[c:, c])))
        m[[c, p]] = m[[p, c]]
        m[c] = m[c] / m[c, c]
        for r in range(3):
            if r != c:
                m[r] = m[r] - m[r, c] * m[c]
    return m[:, 3:]


def edge_blocks(ti, tj, meas, lam, dt):
    """h = J^T Lam J and g = J^T Lam e of one edge, J = J_j = [[M, N], [0, M]]
    with M = A^-1 Rt, N = A^-1 hat(pt) Rt - (A^-1 Q A^-1) Rt: Jr(e) =
    [[A, Q], [0, A]] inverted by its blocks, Adj(T_j^-1) = [[Rt, hat(pt) Rt],
    [0, Rt]]."""
    def inv(t):
        return t[:3, :3].T, -(t[:3, :3].T @ t[:3, 3])

    rm, pm = inv(meas)
    ri, pi = inv(ti)
    ra, pa = rm @ ri, rm @ pi + pm
    re, pe = ra @ tj[:3, :3], ra @ tj[:3, 3] + pa
    phi = so3_log(re, dt)
    e = np.concatenate([so3_jl_inv(phi, dt) @ pe, phi]).astype(dt)
    ai = inv3(so3_jl(-phi, dt), dt)
    rt, pt = inv(tj)
    j = np.zeros((6, 6), dt)
    j[:3, :3] = j[3:, 3:] = ai @ rt
    j[:3, 3:] = ai @ (hat(pt) @ rt) - (ai @ q_block(-e[:3], -phi, dt) @ ai) @ rt
    jtl = j.T * lam[None, :]
    return jtl @ j, jtl @ e


def chol6(a, dt):
    """The lower factor of a 6x6 block; None on a pivot that is not > 0."""
    lo = np.zeros((6, 6), dt)
    for c in range(6):
        d = a[c, c] - lo[c, :c] @ lo[c, :c]
        if not d > 0:
            return None
        lo[c, c] = np.sqrt(d)
        for i in range(c + 1, 6):
            lo[i, c] = (a[i, c] - lo[i, :c] @ lo[c, :c]) / lo[c, c]
    return lo


def lower_solve(lo, r):
    """v with lo v = r (lo lower triangular 6x6), row by row."""
    v = np.zeros_like(r)
    for q in range(6):
        v[q] = (r[q] - lo[q, :q] @ v[:q]) / lo[q, q]
    return v


def upper_solve(lo, r):
    """v with lo^T v = r, from the last row up."""
    v = np.zeros_like(r)
    for q in range(5, -1, -1):
        v[q] = (r[q] - lo[q + 1:, q] @ v[q + 1:]) / lo[q, q]
    return v


def mirror_optimize(poses, pose_mask, ei, ej, meas, info, emask, iterations=15, damping=1e-6,
                    dt=np.float32, counts=None, system=None):
    """csrc/pose_graph.cu's algorithm; `counts` (a dict) gets the panel
    blocks, block updates (each L_ik L_jk^T of the fan-in, the diagonal's
    included) and blocks below the diagonal of the last iteration, up to a
    failed pivot's level; `system` (a dict) gets the first iteration's
    equilibrated, damped compact system in the kernel's order, dense
    (`h`)."""
    k = len(poses)
    poses, meas, info = (np.array(a, dt) for a in (poses, meas, info))
    sym = opg.symbolic_plain(pose_mask, ei, ej, emask)
    vid, where, rows, cols = sym["vid"], sym["where"], sym["rows"], sym["cols"]
    nf = len(vid)
    cidx = np.full(k, -1)
    cidx[vid] = np.arange(nf)
    if nf == 0 or iterations <= 0:
        return poses
    used, inc = [], [[] for _ in range(nf)]
    for e in range(len(ei)):  # each free vertex's (edge, end) pairs in edge order
        a, b = int(ei[e]), int(ej[e])
        if not emask[e] or not (0 <= a < k and 0 <= b < k) or (cidx[a] < 0 and cidx[b] < 0):
            continue
        used.append(e)
        for end, v in ((0, a), (1, b)):
            if cidx[v] >= 0:
                inc[cidx[v]].append((e, end))
    damping, eye, zero = dt(damping), np.eye(6, dtype=dt), np.zeros((6, 6), dt)
    for _ in range(iterations):
        hg = {e: edge_blocks(poses[ei[e]], poses[ej[e]], meas[e], info[e], dt) for e in used}
        adiag, blocks = np.zeros((nf, 6, 6), dt), {}
        rhs, dj = np.zeros((nf, 6), dt), np.zeros((nf, 6), dt)
        for c in range(nf):  # at the vertex's position i; a block below the diagonal by row
            i = where[c]
            diag, bv = np.zeros((6, 6), dt), np.zeros(6, dt)
            for e, end in inc[c]:
                h, g = hg[e]
                diag = diag + h
                bv = bv + (g if end else -g)
                o = cidx[ej[e] if end == 0 else ei[e]]
                if o == c:
                    diag = diag + (-h)
                elif o >= 0 and where[o] < i:
                    blocks[(i, where[o])] = blocks.get((i, where[o]), zero) + (-h)
            adiag[i] = diag
            d = np.diagonal(diag)
            dj[i] = dt(1) / np.sqrt(np.where(d < dt(1e-12), dt(1e-12), d))
            rhs[i] = -(bv * dj[i])

        def equilibrated(i, j):
            a = adiag[j] if i == j else blocks.get((i, j), zero)
            m = (a * dj[i][:, None]) * dj[j][None, :]
            return m + damping * eye if i == j else m

        if system is not None and "h" not in system:
            h = np.zeros((6 * nf, 6 * nf), dt)
            for i in range(nf):
                for j in [i] + rows[i]:
                    h[6 * i:6 * i + 6, 6 * j:6 * j + 6] = equilibrated(i, j)
                    h[6 * j:6 * j + 6, 6 * i:6 * i + 6] = equilibrated(i, j).T
            system["h"] = h
        lo, failed, panel, updates = {}, False, 0, 0
        for level in sym["levels"]:  # leaves first; each block by its own fan-in
            for j in level:
                s = equilibrated(j, j)
                for kk in rows[j]:
                    s = s - lo[(j, kk)] @ lo[(j, kk)].T
                updates += len(rows[j])
                lo[(j, j)] = chol6(s, dt)
                if lo[(j, j)] is None:
                    failed = True
                    continue
                for i in cols[j]:
                    s = equilibrated(i, j)
                    for kk in sorted(set(rows[i]) & set(rows[j])):
                        s = s - lo[(i, kk)] @ lo[(j, kk)].T
                        updates += 1
                    x = np.zeros((6, 6), dt)
                    for c in range(6):  # x L_jj^T = s
                        x[:, c] = (s[:, c] - x[:, :c] @ lo[(j, j)][c, :c]) / lo[(j, j)][c, c]
                    lo[(i, j)] = x
                panel += len(cols[j])
            if failed:
                break
        if counts is not None:
            counts.update(panel_blocks=panel, block_updates=updates,
                          blocks_below_diagonal=sum(len(c) for c in cols))
        if failed:
            x = np.full((nf, 6), np.nan, dt)
        else:
            x = rhs.copy()
            for level in sym["levels"]:  # L y = rhs, leaves first
                for j in level:
                    r = x[j] - sum((lo[(j, kk)] @ x[kk] for kk in rows[j]), np.zeros(6, dt))
                    x[j] = lower_solve(lo[(j, j)], r)
            for level in sym["levels"][::-1]:  # L^T x = y, from the root down
                for j in level:
                    r = x[j] - sum((lo[(i, j)].T @ x[i] for i in cols[j]), np.zeros(6, dt))
                    x[j] = upper_solve(lo[(j, j)], r)
        dx = dj * x
        for c in range(nf):
            d = dx[where[c]]
            t = np.eye(4, dtype=dt)
            t[:3, :3], t[:3, 3] = so3_exp(d[3:], dt), so3_jl(d[3:], dt) @ d[:3]
            poses[vid[c]] = t @ poses[vid[c]]
    return poses


def jax_optimize(b, dt):
    f = {np.float32: jnp.float32, np.float64: jnp.float64}[dt]
    g = jpg.PoseGraph(*(jnp.asarray(a, f) if a.dtype == np.float32 else jnp.asarray(a)
                        for a in arrays(b)))
    return np.asarray(jpg.optimize(g, iterations=15).poses)


def test_the_graphs_are_chip_smokes(builders):
    assert tuple(builders) == GRAPHS
    assert builders["70 vertices grown from k_cap 64"].k_cap == 128
    assert builders["1 vertex"].n_vertices == 1


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", GRAPHS)
def test_the_kernels_algorithm_matches_jax(builders, name, dt):
    """The mirror against the jitted JAX optimize (15 iterations): NaN at the
    same vertices (every free one where the factorization fails); elsewhere
    f64 within 1e-8, f32 within 2e-3 m and 1e-3 rad; vertex 0 and the unused
    vertices bit for bit the input."""
    b = builders[name]
    out = mirror_optimize(*arrays(b), dt=dt)
    ref = jax_optimize(b, dt)
    nan_m, nan_j = np.isnan(out).any(axis=(1, 2)), np.isnan(ref).any(axis=(1, 2))
    np.testing.assert_array_equal(nan_m, nan_j)
    fixed = ~b.pose_mask.copy()
    fixed[0] = True
    np.testing.assert_array_equal(out[fixed], np.asarray(b.poses, dt)[fixed])
    ok = ~nan_m
    if dt is np.float64:
        np.testing.assert_allclose(out[ok], ref[ok], atol=1e-8, rtol=0)
    else:
        dpos = np.linalg.norm(out[ok, :3, 3] - ref[ok, :3, 3], axis=1).max()
        drot = float(chord_angle(out[ok], ref[ok]).max())
        assert dpos < 2e-3 and drot < 1e-3, (dpos, drot)
    if name == "failing factorization":
        assert nan_m.sum() == b.n_vertices - 1
    elif name != "1 vertex":
        assert not nan_m.any() and not np.array_equal(out, np.asarray(b.poses, dt))


@pytest.mark.parametrize("name", ["circle 60, 8 loops", "70 vertices grown from k_cap 64",
                                  "failing factorization", "2 vertices"])
def test_the_bounds_block_counts_are_the_kernels(builders, name):
    """chip_smoke.pose_graph_structure counts, in the kernel's order, the
    panel blocks, block updates and blocks below the diagonal the mirror
    runs in an iteration (its first, for the failing graph: up to the
    failed pivot's level, the whole count below); phase 24's bound counts
    no more of each than either the kernel's order or the natural order
    needs."""
    b = builders[name]
    counts = {}
    mirror_optimize(*arrays(b), iterations=1, dt=np.float64, counts=counts)
    st = chip_smoke.pose_graph_structure(b.to_device(torch.float32, device="cpu"))
    nd = st["nested_dissection"]
    if name == "failing factorization":
        assert counts["panel_blocks"] <= nd["panel_blocks"]
        assert counts["block_updates"] <= nd["block_updates"]
    else:
        assert {k: nd[k] for k in counts} == counts
    for k in ("panel_blocks", "block_updates", "blocks_below_diagonal"):
        assert st[k] <= nd[k] and st[k] <= st["natural"][k], (k, st)
    assert st["free_vertices"] == b.n_vertices - 1


@pytest.mark.parametrize("name", GRAPHS + ("dry run, 1,000 keyframes",
                                           "long session, 4,000 keyframes"))
def test_the_order_is_a_permutation_of_the_free_vertices(name):
    """symbolic_plain's order (the kernel's, which chip_smoke.py phase 24
    reads back from its int scratch) holds each free vertex once, and
    `where` is its inverse; the tree's parents come later in the order."""
    b = chip_smoke.pose_graph_builders(dry_run=name not in GRAPHS)[name]
    st = opg.symbolic_plain(b.pose_mask, b.edge_i, b.edge_j, b.edge_mask)
    free = b.pose_mask.copy()
    free[0] = False
    np.testing.assert_array_equal(st["vid"], np.flatnonzero(free))
    nf = int(free.sum())
    np.testing.assert_array_equal(np.sort(st["perm"]), np.arange(nf))
    np.testing.assert_array_equal(st["where"][st["perm"]], np.arange(nf))
    assert all(p < 0 or p > j for j, p in enumerate(st["parent"]))
    assert sum(len(lv) for lv in st["levels"]) == nf


@pytest.mark.parametrize("name", ["circle 60, 1 loops", "circle 60, 8 loops", "2 vertices",
                                  "70 vertices grown from k_cap 64", "a used vertex with no edge"])
def test_the_pattern_holds_a_dense_cholesky(builders, name):
    """Every block of a dense float64 Cholesky of the mirror's first
    equilibrated, damped system, in the kernel's order, that is not exactly
    zero lies in L's symbolic pattern (a block outside it is a sum of
    products each with an exact zero)."""
    b = builders[name]
    system = {}
    mirror_optimize(*arrays(b), iterations=1, dt=np.float64, system=system)
    chol = np.linalg.cholesky(system["h"])
    st = opg.symbolic_plain(b.pose_mask, b.edge_i, b.edge_j, b.edge_mask)
    nf = len(st["perm"])
    nonzero = np.abs(chol.reshape(nf, 6, nf, 6)).max(axis=(1, 3)) > 0
    pattern = np.eye(nf, dtype=bool)
    for i, row in enumerate(st["rows"]):
        pattern[i, row] = True
    assert not (nonzero & ~pattern).any()
    assert nonzero[np.tril_indices(nf, -1)].sum() > 0 or nf == 1


def test_the_dry_runs_order_cuts_the_work():
    """On the dry run's 1,000-keyframe graph (structure only) the kernel's
    order needs at least 100x fewer block updates an iteration than the
    natural order's 15,105,149, with an elimination tree of at most 64
    levels (the natural order's: 999)."""
    b = chip_smoke.pose_graph_builders(dry_run=True)["dry run, 1,000 keyframes"]
    st = chip_smoke.pose_graph_structure(b.to_device(torch.float32, device="cpu"))
    assert st["natural"]["block_updates"] == 15_105_149
    assert st["nested_dissection"]["block_updates"] * 100 <= 15_105_149, st
    assert st["block_updates"] == st["nested_dissection"]["block_updates"]
    assert st["height"] <= 64, st


def test_a_chains_tree_is_shallow():
    """An 84-vertex chain (85 keyframes, loop edges to the fixed vertex 0,
    as the figure-8's second graph): a tree of at most 2 log2(n_f) + 2
    levels, against 84 in the natural order. Its natural order needs fewer
    blocks (83 below the diagonal and 83 updates an iteration, against 155
    and 227 in the kernel's), and the bound counts those."""
    from funny_lidar_slam_torch.backend.pose_graph import PoseGraphBuilder

    b = PoseGraphBuilder(k_cap=512, e_cap=1024)
    for _ in range(85):
        b.add_vertex(np.eye(4))
    for i in (42, 84):
        b.add_edge(i, 0, np.eye(4), (1.0,) * 6)
    st = opg.symbolic_plain(b.pose_mask, b.edge_i, b.edge_j, b.edge_mask)
    assert len(st["perm"]) == 84
    assert st["height"] <= 2 * np.log2(84) + 2, st["height"]
    counts = chip_smoke.pose_graph_structure(b.to_device(torch.float32, device="cpu"))
    assert counts["natural"] == {"blocks_below_diagonal": 83, "panel_blocks": 83,
                                 "block_updates": 83}
    assert counts["nested_dissection"]["block_updates"] == 227
    assert counts["nested_dissection"]["blocks_below_diagonal"] == 155
    assert {k: counts[k] for k in counts["natural"]} == counts["natural"]


@pytest.mark.parametrize("name", GRAPHS)
def test_cpu_tensors_take_the_plain_version_and_build_nothing(builders, monkeypatch, name):
    def refuse(lib):
        raise AssertionError(f"built {lib}")

    monkeypatch.setattr(cuda_build, "library", refuse)
    before = opg.pose_graph_gn.launches
    for dtype in (torch.float32, torch.float64):
        g = builders[name].to_device(dtype, device="cpu")
        for out in (tpg.optimize(g).poses, opg.pose_graph_gn(g).poses):
            ref = tpg.optimize_plain(g).poses
            assert out.dtype == dtype
            assert torch.equal(torch.isnan(out), torch.isnan(ref))
            assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))
    assert opg.pose_graph_gn.launches == before


def test_the_staged_copy_is_the_plain_version(builders):
    """tools/profile_torch_pose_graph.py's staged_plain, whose stages the
    tool times, computes optimize_plain bit for bit, its marks in order."""
    spec = importlib.util.spec_from_file_location(
        "profile_torch_pose_graph", ROOT / "tools" / "profile_torch_pose_graph.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in ("circle 60, 8 loops", "failing factorization"):
        g = builders[name].to_device(torch.float32, device="cpu")
        marks = []
        out = tool.staged_plain(g, 3, mark=marks.append).poses
        ref = tpg.optimize_plain(g, 3).poses
        assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        assert marks == list(tool.STAGES) * 3


def test_the_tools_stage_clocks_are_the_kernels():
    """tools/profile_torch_pose_graph.py names csrc/pose_graph.cu's PG_*
    stage clocks in their order, each marked once in the kernel, and room
    for stage_clock.cuh's kStageClocks after the float scratch; its
    --parent reads a checkout's scratch sizes from that checkout's source."""
    spec = importlib.util.spec_from_file_location(
        "profile_torch_pose_graph", ROOT / "tools" / "profile_torch_pose_graph.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = (CSRC / "pose_graph.cu").read_text()
    enum = re.split(r",\s*", re.search(r"enum \{\s*(PG_\w+(?:,\s*PG_\w+)*)\s*\};", text).group(1))
    assert [e[3:].lower() for e in enum] == list(tool.PG_STAGES)
    assert all(text.count(f"clk.mark({e});") == 1 for e in enum)
    clocks = re.search(r"constexpr int kStageClocks = (\d+);",
                       (CSRC / "stage_clock.cuh").read_text()).group(1)
    assert int(clocks) == tool.CLOCKS >= len(enum)
    assert "fscratch + lay.floats" in text and "lay.floats + clock_floats" in text
    # --parent sizes a parent's scratch from its own source: this checkout's, here
    sizes = tool.parent_scratch_sizes(str(ROOT))
    assert all(sizes(k, e) == opg.scratch_sizes(k, e) for k, e in ((1, 0), (64, 128), (1024, 2048)))


def test_the_placement_mirror_is_the_kernels():
    """chip_smoke.pose_graph_placement repeats the kernel's three tests of
    what fits in its dynamic shared memory (its constants and formulas read
    from the source), and the graphs of pose_graph_builders(dry_run=True),
    which phase 24 runs on the card, take each placement both ways: the
    long session puts all three in the scratch."""
    text = (CSRC / "pose_graph.cu").read_text()
    assert "constexpr int kDynBytes = 128 * 1024;" in text
    assert chip_smoke.PG_DYN_BYTES == 128 * 1024
    assert re.search(r"constexpr int kHotArrays = (\d+);", text).group(1) == \
        str(chip_smoke.PG_HOT_ARRAYS)
    for formula in ("(kHotArrays * hn + hn + entries) * static_cast<int>(sizeof(int)) <= kDynBytes",
                    "const int words = 4 * nf + 3 + 2 * nrow + nblocks;",
                    "words * static_cast<int>(sizeof(int)) <= kDynBytes",
                    "const int skip = idx_fits ? (words + 3) / 4 * 4 : 0;",
                    "const long long fwords = skip + 36LL * nblocks + 54LL * nf;",
                    "fwords * static_cast<int>(sizeof(float)) <= kDynBytes",
                    "const int hn = nf + 1, entries = s.off[nf];"):
        assert formula in text, formula
    rows = {}
    for name, b in chip_smoke.pose_graph_builders(dry_run=True).items():
        g = b.to_device(torch.float32, device="cpu")
        sym = opg.symbolic_plain(g.pose_mask, g.edge_i, g.edge_j, g.edge_mask)
        rows[name] = chip_smoke.pose_graph_placement(sym, chip_smoke.pose_graph_edges(g)[1])
    assert rows["circle 60, 8 loops"] == {"hot": True, "pattern": True, "L": True}
    assert rows["dry run, 1,000 keyframes"] == {"hot": True, "pattern": True, "L": False}
    assert rows["long session, 4,000 keyframes"] == {"hot": False, "pattern": False, "L": False}


# ------------------------------------------------------ the kernel's interface
def test_signature_and_scratch_layout_match_the_kernel_source():
    text = (CSRC / "pose_graph.cu").read_text()
    params = re.search(r'extern "C" int pose_graph_gn_launch\(([^)]*)\)', text).group(1)
    kinds = ["ptr" if "*" in q else " ".join(q.split()[:-1]) for q in params.split(",")]
    # the graph's 7 tensors, out, the two scratch buffers, their sizes, K, E,
    # iterations, damping, then the stream
    assert kinds == ["ptr"] * 10 + ["long long"] * 2 + ["int"] * 3 + ["float", "ptr"]
    names = {cuda_build._P: "ptr", cuda_build._I: "int", cuda_build._F: "float",
             cuda_build._L: "long long"}
    argtypes, restype = cuda_build.SIGNATURES["pose_graph"]["pose_graph_gn_launch"]
    assert [names[a] for a in argtypes] == kinds and restype is cuda_build._I
    assert re.search(r"constexpr int kEdgeFloats = (\d+);", text).group(1) == str(opg.EDGE_FLOATS)
    layout = re.search(r"Layout layout\(int k, int e\) \{(.*?)\n}", text, re.S).group(1)
    nb_c = "static_cast<long long>(k) * (k + 1) / 2"
    assert nb_c in layout
    floats, ints = re.search(r"return \{(.*?),\s*(18LL.*?)\};", layout, re.S).groups()
    for k, e in ((1, 0), (4, 4), (64, 128), (1024, 2048)):
        env = {"nb": k * (k + 1) // 2, "e": e, "k": k}
        py = [eval(re.sub(r"static_cast<long long>\((\w+)\)", r"\1", x).replace("LL", "")
                   .replace("kEdgeFloats", str(opg.EDGE_FLOATS)), env) for x in (floats, ints)]
        assert tuple(py) == opg.scratch_sizes(k, e)
    # the permutation is the int scratch's first array (phase 24 reads it back)
    assert re.search(r"int\*\* per_vertex\[\] = \{&s\.perm,", text)
    assert re.search(r"Scratch carve\(float\* f, int\* n, int k, int e\) \{\s*const long long nb = "
                     r"static_cast<long long>\(k\) \* \(k \+ 1\) / 2;\s*Scratch s;\s*s\.blocks = f;",
                     text)
    assert re.search(r"constexpr int kSweeps = (\d+);", text).group(1) == str(opg.SWEEPS)
    assert "__launch_bounds__(kThreads)" in text and "constexpr int kThreads = 512;" in text
    assert opg.KERNELS == (opg.pose_graph_gn,)


def meta_graph(builders, **bad):
    g = builders["circle 60, 8 loops"].to_device(torch.float32, device="meta")
    return g._replace(**bad)


@pytest.mark.parametrize("fault", ["f64 poses", "i64 edge_i", "non-contiguous meas",
                                   "short pose_mask", "not on CUDA", "mixed devices",
                                   "negative iterations"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(builders, monkeypatch, fault):
    """On tensors off the CPU, `optimize` goes to the kernel's wrapper, which
    refuses before any build or launch what the kernel does not take (meta
    tensors stand for the card); nothing falls back to the plain version."""
    def refuse(lib):
        raise AssertionError(f"built {lib}")

    monkeypatch.setattr(cuda_build, "library", refuse)
    monkeypatch.setattr(tpg, "optimize_plain", refuse)
    g = meta_graph(builders)
    e = g.edge_i.shape[0]
    bad = {"f64 poses": dict(poses=g.poses.double()), "i64 edge_i": dict(edge_i=g.edge_i.long()),
           "non-contiguous meas": dict(edge_meas=torch.empty((e, 4, 4, 2),
                                                             device="meta")[..., 0]),
           "short pose_mask": dict(pose_mask=g.pose_mask[:-1]), "not on CUDA": {},
           "mixed devices": dict(edge_mask=torch.zeros(e, dtype=torch.bool)),
           "negative iterations": {}}[fault]
    err = TypeError if fault in ("f64 poses", "i64 edge_i") else ValueError
    with pytest.raises(err):
        tpg.optimize(g._replace(**bad), iterations=-1 if fault == "negative iterations" else 15)
