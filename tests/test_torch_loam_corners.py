"""Port parity: the LOAM corner selection (loam/features.py::corner_mask_plain
and extract_features, the plain version of csrc/loam_features.cu) against the
JAX package's extract_features, on JAX OrderedScans carried across, over
chip_smoke.py's edge cases (`feature_cases`: the bench geometry, 32 and 64
rows, short and empty rows, every point masked, tied roughness, wrap-around
at packed indices 0 and N-1, threshold -2, 1 and 40 corners a block); a
NumPy mirror of the kernel's algorithm (a warp's scores, its picks, their
early end and its clamped writes) against the plain version; the kernel's C
signature against ops/cuda_build.py; the wrapper's dispatch and refusals."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from funny_lidar_slam_tpu.loam import features as jfeat
from funny_lidar_slam_tpu.loam import projection as jproj
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.loam import features as tfeat
from funny_lidar_slam_torch.ops import cuda_build, loam_features

torch.set_num_threads(1)

CSRC = Path(tfeat.__file__).resolve().parents[1] / "csrc"
CASES = ("bench", "bench max_corners 1", "bench max_corners 40", "bench threshold -2",
         "32x1800 at 8192 points", "64x1800", "short and empty rows",
         "short and empty rows threshold -2", "all masked", "equal depths", "quantized depths",
         "wrap-around at 0 and N-1")
EXTRACT = jax.jit(jfeat.extract_features, static_argnums=1)


@pytest.fixture(scope="module")
def cases():
    """{name: (JAX OrderedScan, FeatureConfig fields)}: each case's inputs
    projected by the JAX package (jitted), its depth edit applied, and each
    point's z replaced by its packed index, so that a cloud names its
    points."""
    project = jax.jit(jproj.project, static_argnums=4)
    out = {}
    for name, (rows, cols, lo, hi), inp, edit, cfg in chip_smoke.feature_cases():
        geom = jproj.LidarGeometry(rows, cols, 2 * np.pi / cols, lo, hi)
        sj = project(*(jnp.asarray(inp[k]) for k in ("points", "ring", "rel_times", "mask")),
                     geom)
        if edit is not None:
            sj = sj._replace(depth=jnp.asarray(edit(np.asarray(sj.depth), np.asarray(sj.mask))))
        n = sj.depth.shape[0]
        sj = sj._replace(points=sj.points.at[:, 2].set(jnp.arange(n, dtype=jnp.float32)))
        out[name] = (sj, cfg)
    return out


def test_the_cases_are_chip_smokes():
    assert tuple(c[0] for c in chip_smoke.feature_cases()) == CASES


@pytest.mark.parametrize("name", CASES)
def test_corner_selection_matches_jax(cases, name):
    """extract_features (device="cpu") equals the JAX package's (jitted):
    the corner and planar clouds, masks and points, exactly; and
    corner_mask_plain the corner mask the JAX corner cloud names (each
    point's z is its packed index; every case's corners fit the cloud)."""
    sj, cfg = cases[name]
    st = convert.ordered_scan(sj)
    cj, pj = EXTRACT(sj, jfeat.FeatureConfig(**cfg))
    ct, pt = tfeat.extract_features(st, tfeat.FeatureConfig(**cfg))
    for t, j in ((ct, cj), (pt, pj)):
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    n, named = st.depth.shape[0], np.asarray(cj.points)[np.asarray(cj.mask), 2]
    assert len(named) < tfeat.FeatureConfig(**cfg).corner_capacity
    jax_mask = np.zeros(n, bool)
    jax_mask[named.astype(np.int64)] = True
    mask = tfeat.corner_mask_plain(st, tfeat.FeatureConfig(**cfg))
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
    assert not (mask & ~st.mask).any()
    if name == "all masked":
        assert not mask.any()
    elif name != "short and empty rows":
        assert mask.any()


# ------------------------------------------- a NumPy mirror of the kernel
F32 = np.float32


def kernel_mirror(scan, cfg) -> np.ndarray:
    """csrc/loam_features.cu's algorithm in NumPy float32, a block at a
    time: each lane's score from direct reads of its neighbours modulo n
    (no rolls), the picks as first-maximum argmaxes that end at the first
    one not above the threshold, the +-5 suppression as scores set to -1,
    True written at the clamped index where the mask holds."""
    d, col, row = scan.depth.numpy(), scan.col.numpy(), scan.row.numpy()
    m, rs, re_ = scan.mask.numpy(), scan.row_start.numpy(), scan.row_end.numpy()
    n, rows, nb = len(d), len(rs), cfg.blocks_per_row
    l_max = loam_features.lanes(n, rows, nb)
    jump, ratio, thr = F32(cfg.occlusion_depth_jump), F32(cfg.parallel_ratio), F32(
        cfg.corner_threshold)
    md = np.where(m, d, F32(0.0)).astype(F32)

    def seed(j, ahead):
        j1 = (j + 1) % n
        if not m[j] or abs(int(col[j1]) - int(col[j])) >= cfg.occlusion_col_diff:
            return False
        return (d[j] - d[j1] if ahead else d[j1] - d[j]) > jump

    def pickable(g):
        if not m[g] or not 0 <= row[g] < rows:
            return False
        if g < rs[row[g]] + 5 or g >= re_[row[g]] - 6:
            return False
        lim = ratio * d[g]
        if abs(d[(g - 1) % n] - d[g]) > lim and abs(d[(g + 1) % n] - d[g]) > lim:
            return False
        return not (any(seed((g + k) % n, True) for k in range(6))
                    or any(seed((g - k) % n, False) for k in range(1, 7)))

    def rough(g):
        acc = F32(-10.0) * md[g]
        for k in range(1, 6):
            acc = F32(acc + md[(g - k) % n])
            acc = F32(acc + md[(g + k) % n])
        return F32(acc * acc)

    out = np.zeros(n, bool)
    for b in range(rows * nb):
        r, i = divmod(b, nb)
        span = int(re_[r]) - int(rs[r]) - 11
        len6 = span // nb if span >= 0 else -((-span + nb - 1) // nb)  # the kernel's floor
        start = int(rs[r]) + 5 + i * len6
        score = np.full(l_max, F32(-1.0), F32)
        for p in range(l_max):
            g = start + p
            gs = min(max(g, 0), n - 1)
            if p < len6 and g < n and pickable(gs):
                score[p] = rough(gs)
        for _ in range(cfg.max_corners_per_block):
            at = int(np.argmax(score))  # the first maximum, a NaN first
            if not score[at] > thr:
                break
            g = min(max(start + at, 0), n - 1)
            if m[g]:
                out[g] = True
            score[max(at - 5, 0):at + 6] = F32(-1.0)
    return out


@pytest.mark.parametrize("name", CASES)
def test_a_mirror_of_the_kernel_matches_the_plain_version(cases, name):
    sj, cfg = cases[name]
    st = convert.ordered_scan(sj)
    cfg = tfeat.FeatureConfig(**cfg)
    np.testing.assert_array_equal(kernel_mirror(st, cfg), tfeat.corner_mask_plain(st, cfg).numpy())


def test_the_mirror_ends_a_block_at_the_threshold_and_breaks_ties_low(cases):
    """Tied roughness (equal depths: 0 on every inner lane) picks the lowest
    offset, then every 11th; the kernel's early end changes nothing when no
    pick clears the threshold."""
    sj, cfg = cases["equal depths"]
    st = convert.ordered_scan(sj)
    picks = np.flatnonzero(tfeat.corner_mask_plain(st, tfeat.FeatureConfig(**cfg)).numpy())
    starts = st.row_start.numpy()
    first_row = next(r for r in range(len(starts)) if (st.row_end[r] - starts[r] - 11) // 6 >= 12)
    in_block = picks[(picks >= starts[first_row] + 5)
                     & (picks < starts[first_row] + 5 + 12)]
    assert in_block[0] == starts[first_row] + 5
    flat = tfeat.FeatureConfig(**dict(cfg, corner_threshold=0.0))
    assert not kernel_mirror(st, flat).any()
    assert not tfeat.corner_mask_plain(st, flat).any()


# ------------------------------------------------- the kernel's interface
def test_signature_matches_the_kernel_source():
    text = (CSRC / "loam_features.cu").read_text()
    params = re.search(r'extern "C" int loam_corners_launch\(([^)]*)\)', text).group(1)
    kinds = ["ptr" if "*" in q else q.split()[0] for q in params.split(",")]
    # depth, col, row, mask, row_start, row_end, out, then the stream
    assert kinds == ["ptr"] * 7 + ["int"] * 6 + ["float"] * 3 + ["ptr"]
    ctypes_kinds = {cuda_build._P: "ptr", cuda_build._I: "int", cuda_build._F: "float"}
    argtypes, restype = cuda_build.SIGNATURES["loam_features"]["loam_corners_launch"]
    assert [ctypes_kinds[a] for a in argtypes] == kinds and restype is cuda_build._I
    # no float operation left for nvcc to contract into an FMA in the roughness
    body = re.search(r"float roughness\(.*?\n}\n", text, re.S).group(0)
    assert "__fmul_rn" in body and "__fadd_rn" in body and not re.search(r"acc [+*]", body)
    assert loam_features.KERNELS == (loam_features.corner_mask,)


def test_cpu_tensors_take_the_plain_version_and_build_nothing(cases, monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(cuda_build, "library", refuse)
    sj, cfg = cases["bench"]
    st = convert.ordered_scan(sj)
    before = loam_features.corner_mask.launches
    cfg = tfeat.FeatureConfig(**cfg)
    assert torch.equal(loam_features.corner_mask(st, cfg), tfeat.corner_mask_plain(st, cfg))
    assert loam_features.corner_mask.launches == before


@pytest.mark.parametrize("fault", ["f64 depth", "i64 col", "non-contiguous row", "short mask",
                                   "not on CUDA", "mixed devices"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cases, monkeypatch, fault):
    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(cuda_build, "library", refuse)
    sj, cfg = cases["bench"]
    st = convert.ordered_scan(sj, device="meta")
    n = st.depth.shape[0]
    bad = {"f64 depth": dict(depth=st.depth.double()), "i64 col": dict(col=st.col.long()),
           "non-contiguous row": dict(row=torch.empty(2 * n, dtype=torch.int32,
                                                      device="meta")[::2]),
           "short mask": dict(mask=st.mask[:-1]),
           "not on CUDA": {},
           "mixed devices": dict(row_end=torch.zeros(st.row_end.shape, dtype=torch.int32))}[fault]
    err = TypeError if fault in ("f64 depth", "i64 col") else ValueError
    with pytest.raises(err):
        loam_features.corner_mask(st._replace(**bad), tfeat.FeatureConfig(**cfg))
