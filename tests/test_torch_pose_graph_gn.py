"""Port parity: the pose graph's GN loop kernel (csrc/pose_graph.cu,
ops/pose_graph.py::pose_graph_gn), through a NumPy mirror of its algorithm,
against the JAX package's jitted `optimize` on the CPU, on chip_smoke.py's
graphs (`pose_graph_builders`: the 60-pose noisy circle in k_cap 64 with 1
and 8 extra loops, 2 vertices, 1 vertex, 70 vertices grown from k_cap 64, a
used vertex no edge touches, a factorization that fails). The mirror
repeats the kernel's algorithm: the compaction of the free vertices, each
vertex's incident edges summed in edge order, the right-looking Cholesky by
6x6 vertex blocks that skips the blocks no edge or update wrote, the two
block substitutions, NaN at every free vertex on a pivot that is not > 0.
Tolerances: float64 poses within 1e-8 of JAX's (tests/test_torch_backend.py's
f64 tolerance); float32 within 2e-3 m and 1e-3 rad (the chord angle), that
test's f32 tolerance for 15 GN steps through two differently ordered f32
Cholesky factorizations; NaN at the same vertices. Also: the mirror's block
counts against chip_smoke.pose_graph_structure (the phase's bound counts
what the kernel runs); optimize on CPU tensors bit for bit the plain
version, with no launch and no build; the staged copy of the plain version
that tools/profile_torch_pose_graph.py times, bit for bit the plain version;
the kernel's C signature and scratch layout; the wrapper's refusals."""

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


def mirror_optimize(poses, pose_mask, ei, ej, meas, info, emask, iterations=15, damping=1e-6,
                    dt=np.float32, counts=None):
    """csrc/pose_graph.cu's algorithm; `counts` (a dict) gets the panel
    blocks and block updates of the last iteration."""
    k = len(poses)
    poses, meas, info = (np.array(a, dt) for a in (poses, meas, info))
    free = np.array(pose_mask, bool)
    free[0] = False
    vid = np.flatnonzero(free)
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
    damping = dt(damping)
    for _ in range(iterations):
        hg = {e: edge_blocks(poses[ei[e]], poses[ej[e]], meas[e], info[e], dt) for e in used}
        blocks, rhs, dj = {}, np.zeros((nf, 6), dt), np.zeros((nf, 6), dt)
        for c in range(nf):
            diag, bv = np.zeros((6, 6), dt), np.zeros(6, dt)
            for e, end in inc[c]:
                h, g = hg[e]
                diag = diag + h
                bv = bv + (g if end else -g)
                o = cidx[ej[e] if end == 0 else ei[e]]
                if o == c:
                    diag = diag + (-h)
                elif 0 <= o < c:
                    blocks[(c, o)] = blocks[(c, o)] + (-h) if (c, o) in blocks else -h
            blocks[(c, c)] = diag
            rhs[c] = bv
            d = np.diagonal(diag)
            dj[c] = dt(1) / np.sqrt(np.where(d < dt(1e-12), dt(1e-12), d))
        for (a, b), m in blocks.items():
            m = (m * dj[a][:, None]) * dj[b][None, :]
            blocks[(a, b)] = m + damping * np.eye(6, dtype=dt) if a == b else m
        rhs = -(rhs * dj)
        failed, panel, updates = False, 0, 0
        for kk in range(nf):
            lo = chol6(blocks[(kk, kk)], dt)
            if lo is None:
                failed = True
                break
            blocks[(kk, kk)] = lo
            rows = [i for i in range(kk + 1, nf) if (i, kk) in blocks]
            for i in rows:
                x = np.zeros((6, 6), dt)
                for c in range(6):
                    x[:, c] = (blocks[(i, kk)][:, c] - x[:, :c] @ lo[c, :c]) / lo[c, c]
                blocks[(i, kk)] = x
            panel += len(rows)
            for x, i in enumerate(rows):
                for j in rows[:x + 1]:
                    upd = blocks[(i, kk)] @ blocks[(j, kk)].T
                    blocks[(i, j)] = blocks[(i, j)] - upd if (i, j) in blocks else -upd
                    updates += 1
        if counts is not None:
            counts.update(panel_blocks=panel, block_updates=updates,
                          blocks_below_diagonal=len(blocks) - nf)
        if failed:
            x = np.full((nf, 6), np.nan, dt)
        else:
            y = np.zeros((nf, 6), dt)
            for i in range(nf):
                r = rhs[i] - sum((blocks[(i, j)] @ y[j] for j in range(i) if (i, j) in blocks),
                                 np.zeros(6, dt))
                lo = blocks[(i, i)]
                for q in range(6):
                    y[i, q] = (r[q] - lo[q, :q] @ y[i, :q]) / lo[q, q]
            x, acc = np.zeros((nf, 6), dt), np.zeros((nf, 6), dt)
            for i in range(nf - 1, -1, -1):
                r, lo = y[i] - acc[i], blocks[(i, i)]
                for q in range(5, -1, -1):
                    x[i, q] = (r[q] - lo[q + 1:, q] @ x[i, q + 1:]) / lo[q, q]
                for j in range(i):
                    if (i, j) in blocks:
                        acc[j] = acc[j] + blocks[(i, j)].T @ x[i]
        dx = dj * x
        for c in range(nf):
            t = np.eye(4, dtype=dt)
            t[:3, :3], t[:3, 3] = so3_exp(dx[c, 3:], dt), so3_jl(dx[c, 3:], dt) @ dx[c, :3]
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
    """chip_smoke.pose_graph_structure (phase 24's bound) counts the panel
    blocks, block updates and blocks below the diagonal the mirror runs in
    an iteration (its first, for the failing graph: up to the failed pivot,
    the whole count below)."""
    b = builders[name]
    counts = {}
    mirror_optimize(*arrays(b), iterations=1, dt=np.float64, counts=counts)
    st = chip_smoke.pose_graph_structure(b.to_device(torch.float32, device="cpu"))
    if name == "failing factorization":
        assert counts["panel_blocks"] <= st["panel_blocks"]
    else:
        assert {k: st[k] for k in counts} == counts
    assert st["free_vertices"] == b.n_vertices - 1


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
    floats, ints = re.search(r"return \{(.*?),\s*(4LL.*?)\};", layout, re.S).groups()
    for k, e in ((1, 0), (4, 4), (64, 128), (1024, 2048)):
        env = {"nb": k * (k + 1) // 2, "e": e, "k": k}
        py = [eval(re.sub(r"static_cast<long long>\((\w+)\)", r"\1", x).replace("LL", "")
                   .replace("kEdgeFloats", str(opg.EDGE_FLOATS)), env) for x in (floats, ints)]
        assert tuple(py) == opg.scratch_sizes(k, e)
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
