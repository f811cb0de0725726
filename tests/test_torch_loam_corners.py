"""Port parity: the LOAM corner selection (loam/features.py::corner_mask_plain
and extract_features, the plain version of csrc/loam_features.cu) against the
JAX package's extract_features, on JAX OrderedScans carried across, over
chip_smoke.py's edge cases (`feature_cases`: the bench geometry, 32 and 64
rows, short and empty rows, every point masked, tied roughness, wrap-around
at packed indices 0 and N-1, threshold -2, 1 and 40 corners a block, 602
lanes a block) and 18
other scans (`EXTRA`: seeds 1-6; 16 and 32 rows; 8,192 to 57,600 points; 5
corners a block and threshold 0.5 among them); a NumPy mirror of the
kernel's algorithm (the staged window with its wrap, a thread a lane, the
uint32 keys and the warp's two-reduction argmax, the picks' early end and
the clamped writes) against the plain version on all of them; the key's
order against torch.argmax; the kernel's C signature and its variants
against ops/cuda_build.py and the mirror; the wrapper's dispatch and
refusals."""

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
from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.loam import features as tfeat
from funny_lidar_slam_torch.ops import cuda_build, loam_features

torch.set_num_threads(1)

CSRC = Path(tfeat.__file__).resolve().parents[1] / "csrc"
CASES = ("bench", "bench max_corners 1", "bench max_corners 40", "bench threshold -2",
         "32x1800 at 8192 points", "64x1800", "short and empty rows",
         "short and empty rows threshold -2", "all masked", "equal depths", "quantized depths",
         "wrap-around at 0 and N-1", "16x900 at 57600 points")
# (seed, rows, points, FeatureConfig fields): at 57,600 points and 16 rows a
# block has 602 lanes, above the 512 whose keys the pick warp holds in
# registers; 32 rows of 20 corners a block need a corner cloud above 2,048
EXTRA_SPECS = tuple(
    spec for seed in range(1, 7) for spec in (
        (seed, 16, 16384, {}),
        (seed, 32, 8192, {"max_corners_per_block": 5}),
        (seed, 32 if seed % 2 else 16, 57600, {"corner_threshold": 0.5,
                                               "corner_capacity": 4096})))
EXTRA = tuple(f"seed {seed}, {rows} rows, {points} points" + "".join(
    f", {k} {v}" for k, v in cfg.items() if k != "corner_capacity")
    for seed, rows, points, cfg in EXTRA_SPECS)
ALL = CASES + EXTRA
EXTRACT = jax.jit(jfeat.extract_features, static_argnums=1)


def extra_cases() -> list:
    """EXTRA in chip_smoke.feature_cases' layout: the last scan of a 1 s
    simulator run of each seed and size, ring ids from the elevation, 900
    columns a 16 rows."""
    out = []
    for name, (seed, rows, points, cfg) in zip(EXTRA, EXTRA_SPECS):
        scan = simulate(SimConfig(duration=1.0, static_warmup=0.2, points_per_scan=points,
                                  seed=seed)).scans[-1]
        inp = chip_smoke._sim_case(scan.points.astype(np.float32),
                                   scan.rel_times.astype(np.float32), rows)
        out.append((name, (rows, 900 * rows // 16, 1.5, 50.0), inp, None, cfg))
    return out


@pytest.fixture(scope="module")
def cases():
    """{name: (JAX OrderedScan, FeatureConfig fields)}: each case's inputs
    projected by the JAX package (jitted), its depth edit applied, and each
    point's z replaced by its packed index, so that a cloud names its
    points."""
    project = jax.jit(jproj.project, static_argnums=4)
    out = {}
    for name, (rows, cols, lo, hi), inp, edit, cfg in chip_smoke.feature_cases() + extra_cases():
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


@pytest.mark.parametrize("name", ALL)
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
HALO = 6
NAN_KEY = np.uint32(0xFFFFFFFF)
NONE = np.uint32(0xFFFFFFFF)  # no offset


def key_of(v) -> np.ndarray:
    """csrc/loam_features.cu's key_of: a score as an order-preserving uint32,
    a NaN above every number, -0 as +0."""
    v = np.asarray(v, F32)
    u = np.where(v == 0, F32(0.0), v).view(np.uint32)
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(v), NAN_KEY, key).astype(np.uint32)


def score_of(key) -> np.ndarray:
    """The kernel's score_of: the score of a key (a NaN for the NaN key)."""
    key = np.asarray(key, np.uint32)
    u = np.where(key & np.uint32(0x80000000), key & np.uint32(0x7FFFFFFF), ~key)
    return np.where(key == NAN_KEY, F32(np.nan), u.astype(np.uint32).view(F32))


def key_slots(l_max: int) -> int:
    """The keys a lane of the pick warp holds in registers (loam_corners_launch's
    K: 8, 16, or 0 for shared memory above 512 lanes)."""
    return 8 if l_max <= 32 * 8 else 16 if l_max <= 32 * 16 else 0


def warp_argmax(keys3: np.ndarray) -> tuple:
    """A pick of the kernel's warp over keys [B, slots, 32] (offset 32 k +
    lane): each lane's first maximum over its slots, then the largest key
    (__reduce_max_sync) and the lowest offset among the lanes that hold it
    (__reduce_min_sync). Returns (top key [B], offset [B])."""
    lane_best = keys3.max(axis=1)
    lane_at = (32 * keys3.argmax(axis=1) + np.arange(32)).astype(np.uint32)
    top = lane_best.max(axis=1)
    at = np.where(lane_best == top[:, None], lane_at, NONE).min(axis=1)
    return top, at.astype(np.int64)


def kernel_mirror(scan, cfg) -> np.ndarray:
    """csrc/loam_features.cu's algorithm in NumPy float32, all blocks at
    once: 1. each block's window, packed indices b_start - 6 .. b_start +
    l_max + 5 modulo n, staged (depth, col, mask); 2. one thread a lane: its
    13 window points, its row guard from its own row id, its score as a
    uint32 key; 3. the picks of one warp over the keys laid out as the
    lanes hold them, each a warp argmax (`warp_argmax`), ended by the first
    one not above the threshold, the +-5 suppression as -1 keys, and True
    written after the picks at the clamped index of each picked offset
    where the mask holds."""
    d, col, row = scan.depth.numpy(), scan.col.numpy().astype(np.int64), scan.row.numpy()
    m, rs, re_ = scan.mask.numpy(), scan.row_start.numpy(), scan.row_end.numpy()
    n, rows, nb = len(d), len(rs), cfg.blocks_per_row
    l_max = loam_features.lanes(n, rows, nb)
    jump, ratio, thr = F32(cfg.occlusion_depth_jump), F32(cfg.parallel_ratio), F32(
        cfg.corner_threshold)
    blk = np.arange(rows * nb)
    r, i = blk // nb, blk % nb
    start, end = rs[r].astype(np.int64), re_[r].astype(np.int64)
    span = end - start - 11
    len6 = np.where(span >= 0, span // nb, -((-span + nb - 1) // nb))  # the kernel's floor
    b_start = start + 5 + i * len6
    lanes_in = np.maximum(0, np.minimum(np.minimum(len6, l_max), n - b_start))
    assert (b_start[lanes_in > 0] >= 0).all()  # the projection's rows start at 0 or above

    # 1. the staged windows [B, l_max + 12]
    j = (b_start[:, None] - HALO + np.arange(l_max + 2 * HALO)) % n
    sd, sc, sm = d[j], col[j], m[j]
    # 2. a lane's 13 points [B, L, 13]: window entries p .. p + 12
    p = np.arange(l_max)
    g = b_start[:, None] + p
    at13 = p[:, None] + np.arange(2 * HALO + 1)
    wd, wc, wm = sd[:, at13].astype(F32), sc[:, at13], sm[:, at13]
    md = np.where(wm, wd, F32(0.0)).astype(F32)
    acc = F32(-10.0) * md[..., HALO]
    for k in range(1, 6):
        acc = (acc + md[..., HALO - k]).astype(F32)
        acc = (acc + md[..., HALO + k]).astype(F32)
    rough = (acc * acc).astype(F32)
    c0 = wd[..., HALO]
    lim = (ratio * c0).astype(F32)
    parallel = ((np.abs((wd[..., HALO - 1] - c0).astype(F32)) > lim)
                & (np.abs((wd[..., HALO + 1] - c0).astype(F32)) > lim))
    near = np.abs(wc[..., 1:] - wc[..., :-1]) < cfg.occlusion_col_diff  # seed at j: j, j + 1
    ahead = wm[..., :-1] & near & ((wd[..., :-1] - wd[..., 1:]).astype(F32) > jump)
    behind = wm[..., :-1] & near & ((wd[..., 1:] - wd[..., :-1]).astype(F32) > jump)
    kill = ahead[..., HALO:HALO + 6].any(-1) | behind[..., 0:HALO].any(-1)
    gs = np.clip(g, 0, n - 1)  # g itself on every lane in block
    rg = row[gs].astype(np.int64)
    ok_row = (rg >= 0) & (rg < rows)
    rgc = np.clip(rg, 0, rows - 1)
    guard = ok_row & (gs >= rs[rgc] + 5) & (gs < re_[rgc] - 6)
    pickable = (p < lanes_in[:, None]) & wm[..., HALO] & guard & ~parallel & ~kill
    keys = key_of(np.where(pickable, rough, F32(-1.0)))

    # 3. the picks, keys laid out as the warp holds them: offset 32 k + lane
    slots = key_slots(l_max) or -(-l_max // 32)
    held = np.zeros((len(blk), 32 * slots), np.uint32)  # 0: below every score
    held[:, :l_max] = keys
    picked = np.zeros(held.shape, bool)
    live = np.ones(len(blk), bool)
    q = np.arange(32 * slots)
    for _ in range(cfg.max_corners_per_block):
        top, at = warp_argmax(held.reshape(len(blk), slots, 32))
        live &= score_of(top) > thr  # an ended block stays ended
        picked[live, at[live]] = True
        held[live[:, None] & (q < l_max) & (np.abs(q - at[:, None]) <= 5)] = key_of(-1.0)
    out = np.zeros(n, bool)
    b_idx, off = np.nonzero(picked)
    tgt = np.clip(b_start[b_idx] + off, 0, n - 1)
    staged = off < lanes_in[b_idx]
    write = np.where(staged, sm[b_idx, np.minimum(off + HALO, l_max + 2 * HALO - 1)], m[tgt])
    out[tgt[write]] = True
    return out


def test_the_key_orders_as_the_plain_argmax():
    """key_of orders scores as torch.argmax does (a NaN first, -0 equal to +0,
    -1 and +-inf in their places, the lowest offset among equal scores), and
    score_of inverts it; the warp's two reductions pick torch.argmax's
    offset on rows laid out as the lanes hold them."""
    special = np.array([np.nan, -0.0, 0.0, -1.0, np.inf, -np.inf, 1.0, -2.0], F32)
    keys = key_of(special)
    assert keys[0] == NAN_KEY and keys[1] == keys[2]
    assert keys[5] < keys[7] < keys[3] < keys[1] < keys[6] < keys[4] < keys[0]
    back = score_of(keys)
    assert np.isnan(back[0])
    np.testing.assert_array_equal(back[2:].view(np.uint32), special[2:].view(np.uint32))
    assert back[1] == 0 and not np.signbit(back[1])  # -0 reads back as +0
    rng = np.random.default_rng(5)
    rows = rng.choice(special, (400, 200)).astype(F32)
    rows[:100] = rng.choice(special[1:], (100, 200))  # no NaN: the largest wins
    rows[100:200] = rng.choice(special[[1, 2, 3]], (100, 200))  # ties of +-0 and -1
    for slots in (8, 16):
        held = np.zeros((len(rows), 32 * slots), np.uint32)
        held[:, :200] = key_of(rows)
        top, at = warp_argmax(held.reshape(len(rows), slots, 32))
        np.testing.assert_array_equal(at, torch.argmax(torch.from_numpy(rows), dim=1).numpy())
        ref = rows[np.arange(len(rows)), at]
        np.testing.assert_array_equal(score_of(top).view(np.uint32),
                                      np.where(ref == 0, F32(0.0), ref).view(np.uint32))


@pytest.mark.parametrize("name", ALL)
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


def test_the_kernel_variants_and_lane_limit_match_the_source():
    """The launcher's choice of keys a lane (K 8 to 256 lanes, 16 to 512, else
    shared memory; shared memory at every l_max in the timing build with
    -DFLS_CORNER_KEYS_IN_SMEM) is the mirror's `key_slots`; the picks are
    the two warp reductions; and MAX_LANES is the most lanes whose window
    and keys (the launcher's 4 B a lane and 9 B a window point) fit one
    block's shared memory."""
    text = (CSRC / "loam_features.cu").read_text()
    forced, dispatch = text.split("#ifdef FLS_CORNER_KEYS_IN_SMEM")[1].split("#else")
    assert re.findall(r"launch<(\d+)>\(s, out", forced) == ["0"]
    assert [int(k) for k in re.findall(r"l_max <= 32 \* (\d+)", dispatch)] == [8, 16]
    assert re.findall(r"launch<(\d+)>\(s, out", dispatch) == ["8", "16", "0"]
    assert [key_slots(lanes) for lanes in (8, 256, 257, 512, 513)] == [8, 8, 16, 16, 0]
    assert "__reduce_max_sync" in text and "__reduce_min_sync" in text
    assert re.search(r"l_max\) \* 4 \+ window \* \(4 \+ 4 \+ 1\)", text)
    assert re.search(r"kMaxSmem = 232448;", text)

    def smem(lanes):
        return 4 * lanes + 9 * (lanes + 2 * HALO)

    assert smem(loam_features.MAX_LANES) <= 232448 < smem(loam_features.MAX_LANES + 1)


def test_the_wrapper_refuses_more_lanes_than_shared_memory_holds(monkeypatch):
    """A scan of one row whose blocks would have more than MAX_LANES lanes is
    refused before any build or launch (meta tensors stand for the card)."""
    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(cuda_build, "library", refuse)
    cfg = tfeat.FeatureConfig()
    for n, ok in ((6 * (loam_features.MAX_LANES - 2), True),
                  (6 * (loam_features.MAX_LANES - 1), False)):
        assert (loam_features.lanes(n, 1, cfg.blocks_per_row) <= loam_features.MAX_LANES) == ok

        def meta(dtype, size=n):
            return torch.empty(size, dtype=dtype, device="meta")

        scan = tfeat.OrderedScan(points=meta(torch.float32, (n, 3)), depth=meta(torch.float32),
                                 col=meta(torch.int32), row=meta(torch.int32),
                                 rel_time=meta(torch.float32), mask=meta(torch.bool),
                                 row_start=meta(torch.int32, 1), row_end=meta(torch.int32, 1))
        with pytest.raises(ValueError, match="CUDA" if ok else "over the kernel's"):
            loam_features.corner_mask(scan, cfg)
    assert loam_features.corner_mask.launches == 0
