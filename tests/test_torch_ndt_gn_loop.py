"""NDT's Gauss-Newton loop with the stencil lookup inside every iteration
(ops/gn_loop.py::ndt_gn_rounds, registration/gn.py::run_gn_ndt) on the CPU,
where the wrapper runs the plain version: the driver against the JAX
`run_gn_corr(ndt_corr, ndt_hg_corr)` and `run_gn(ndt_hg)`, bit for bit
against the port's host loop (`run_gn_corr`), NdtMatcher.match against the
JAX matcher with one round and one host read a match, the kernel source's
enums, signature, hash constants and stencil against the Python side,
Python mirrors of the kernel's lookup order (`batched_lookup`) and of its
fold through J's structure (`structured_fold`), the count of the kernel's
bound (chip_smoke.py `ndt_cost`), and the wrapper's refusals and dispatch.

Tolerances: (a) against JAX, the same iterations, gathers and `converged`
(decisions of the same f32 arithmetic), the pose within 1e-4 m and 1e-4 rad
(`chord_angle`) and `num_valid` within 5 pairs (a point on a voxel face
may land on either side where the two packages' f32 poses differ in the
last bits); (b) against the port's host loop, every output bit for bit (the
same arithmetic at the same poses); (c) NdtMatcher.match as
tests/test_torch_ndt.py::test_ndt_match_matches_jax holds it (1e-3 m, 1e-3
rad, the same `converged` and gathers). The source checks and the lookup
mirror are exact; the fold mirror agrees with the dense sums to 1e-12 of
their largest entry (float64, another summation order)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.lie import se3_exp
from funny_lidar_slam_tpu.maps import ndt_map as jndt
from funny_lidar_slam_tpu.maps import voxel_hash as jvh
from funny_lidar_slam_tpu.ops import voxel as jvox
from funny_lidar_slam_tpu.ops.voxel import voxel_downsample as jdownsample
from funny_lidar_slam_tpu.registration import gn as jgn
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.lie import chord_angle
from funny_lidar_slam_torch.maps import ndt_map as tndt
from funny_lidar_slam_torch.maps.voxel_hash import _window
from funny_lidar_slam_torch.ops import cuda_build, gn_loop
from funny_lidar_slam_torch.ops import voxel as tvox
from funny_lidar_slam_torch.registration import gn
from funny_lidar_slam_torch.registration import matchers as tm
from funny_lidar_slam_torch.registration import residuals as tres

from test_registration import T_SMALL_V, room_scene
from test_torch_ndt import NDT, clouds, ndt_scene, sim  # noqa: F401 (fixtures)

torch.set_num_threads(1)

CSRC = Path(gn_loop.__file__).resolve().parents[1] / "csrc"
OUTLIER = 30.0
CAP = 4096


class Rounds:
    """Counts the driver's kernel calls and its host reads."""

    def __init__(self, monkeypatch):
        self.calls, self.reads = 0, 0
        rounds, read = gn.ndt_gn_rounds, gn._host_read

        def counted_rounds(*a):
            self.calls += 1
            return rounds(*a)

        def counted_read(flags):
            self.reads += 1
            return read(flags)

        monkeypatch.setattr(gn, "ndt_gn_rounds", counted_rounds)
        monkeypatch.setattr(gn, "_host_read", counted_read)


def gn_cfgs(max_iters, rot_eps=0.05, pos_eps=0.01, min_valid=10):
    kw = dict(max_iters=max_iters, rotation_eps=rot_eps, position_eps=pos_eps, update="ndt",
              use_stall_check=False, min_valid=min_valid)
    return jgn.GNConfig(**kw), gn.GNConfig(**kw)


def scan_case(state, s1, t_init):
    """(JAX map, port map, source points and mask as numpy, start pose, inv)
    of test_torch_ndt.py's scene: the JAX matcher's filtered source, given
    to both packages as the same f32 numbers."""
    src = jdownsample(*clouds(s1.points)[0], NDT["source_filter_size"], NDT["source_capacity"])
    return (state.m, convert.ndt_map(state.m), np.array(src.points), np.array(src.mask),
            t_init, 1.0 / NDT["voxel_size"])


def room_case(res):
    """The loop-closure room of test_torch_backend.py::
    test_run_gn_ndt_matches_jax, its map loaded at resolution `res` as the
    cascade loads it, from the identity."""
    pts = room_scene(spacing=0.15, noise=0.02)
    n = len(pts)
    t_true = np.asarray(se3_exp(jnp.asarray(T_SMALL_V, jnp.float32)), np.float64)
    src = ((pts - t_true[:3, 3]) @ t_true[:3, :3]).astype(np.float32)
    cap = 16384
    tgt_p, src_p = np.zeros((cap, 3), np.float32), np.zeros((cap, 3), np.float32)
    tgt_p[:n], src_p[:n] = pts, src
    mask = np.arange(cap) < n
    inv = 1.0 / res
    mj = jndt.insert(jndt.create(cap), jnp.asarray(tgt_p), jnp.asarray(mask), inv, min_points=3,
                     estimate_all=True, claim_rounds=8)
    mt = tndt.insert(tndt.create(cap), torch.from_numpy(tgt_p), torch.from_numpy(mask), inv,
                     min_points=3, estimate_all=True, claim_rounds=8)
    return mj, mt, src_p, mask, np.eye(4, dtype=np.float32), inv


def with_bad_voxels(mj, src, mask, t0, inv):
    """The JAX map with one-point voxels (info 1e2 I, estimated) one voxel
    above every 50th source point at t0, then the info of 40 estimated
    voxels around the source set to inf or NaN, as an under-populated
    voxel's inverted covariance can be: the same map for both sides."""
    world = src[mask] @ t0[:3, :3].T + t0[:3, 3]
    lone = (world[::50] + np.float32([0.0, 0.0, 1.0 / inv])).astype(np.float32)
    pad = np.zeros((2 * len(lone), 3), np.float32)
    pad[:len(lone)] = lone
    mj = jndt.insert(mj, jnp.asarray(pad), jnp.asarray(np.arange(len(pad)) < len(lone)), inv,
                     estimate_all=True)
    mt = convert.ndt_map(mj)
    coords = tvox.voxel_coords(torch.from_numpy(world.astype(np.float32)), inv)
    slots, match, _ = tndt._probe(mt, coords, 8)
    hit = np.unique(slots[match].numpy())
    hit = hit[mt.estimated.numpy()[hit]]
    bad = np.random.default_rng(0).choice(hit, 40, replace=False)
    info = np.array(jax.device_get(mj.info))
    info[bad[:20], 0, 0] = np.inf
    info[bad[20:], 1, 2] = np.nan
    return mj._replace(info=jnp.asarray(info))


def run_jax(mj, src, mask, t0, inv, cfg):
    src_j, mask_j = jnp.asarray(src), jnp.asarray(mask)
    return jgn.run_gn_corr(lambda t: jres.ndt_corr(t, src_j, mask_j, mj, inv, OUTLIER),
                           lambda t, c: jres.ndt_hg_corr(t, src_j, c), jnp.asarray(t0), cfg)


def run_port(mt, src, mask, t0, inv, cfg, monkeypatch):
    rounds = Rounds(monkeypatch)
    rt = gn.run_gn_ndt(torch.from_numpy(src), torch.from_numpy(mask), mt, inv, OUTLIER,
                       torch.as_tensor(t0), cfg)
    assert rounds.calls == rounds.reads == 1  # the whole loop, one host read
    return rt


def assert_close_to_jax(rt, rj):
    assert int(rt.iters) == int(rj.iters)
    assert bool(rt.converged) == bool(rj.converged)
    assert abs(int(rt.num_valid) - int(rj.num_valid)) <= 5
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.abs(pt[:3, 3] - pj[:3, 3]).max() < 1e-4
    assert float(chord_angle(pt, pj)) < 1e-4


def carry_it(res) -> int:
    """The iterations of a result whose fields are views of a carry."""
    carry = res.iters.as_strided((gn_loop.CARRY_SIZE,), (1,), 0)
    return int(carry[gn_loop.OFFSET["it"]])


# ------------------------------------------------- (a) the driver against JAX
@pytest.mark.parametrize("max_iters", [2, 30])
def test_driver_matches_jax_on_a_scan(ndt_scene, max_iters, monkeypatch):  # noqa: F811
    """run_gn_ndt against the JAX run_gn_corr(ndt_corr, ndt_hg_corr) on a
    scan against a map seeded from an earlier one: iterations (= gathers),
    converged, num_valid and pose; one kernel call and one host read."""
    mj, mt, src, mask, t0, inv = scan_case(*ndt_scene)
    cfg_j, cfg_t = gn_cfgs(max_iters)
    rj = run_jax(mj, src, mask, t0, inv, cfg_j)
    rt = run_port(mt, src, mask, t0, inv, cfg_t, monkeypatch)
    assert_close_to_jax(rt, rj)
    assert carry_it(rt) == int(rt.iters) > 0 and int(rt.num_valid) > 1000
    if max_iters == 2:
        assert int(rt.iters) == 2 and not bool(rt.converged)


@pytest.mark.parametrize("res", [1.0, 2.0])
@pytest.mark.parametrize("max_iters", [2, 30])
def test_driver_matches_jax_run_gn_on_the_room(res, max_iters, monkeypatch):
    """run_gn_ndt against the JAX run_gn(ndt_hg), the verification's NDT
    stage, on the loop-closure room at two of the cascade's resolutions."""
    mj, mt, src, mask, t0, inv = room_case(res)
    cfg_j, cfg_t = gn_cfgs(max_iters, 1e-3, 1e-3)
    src_j, mask_j = jnp.asarray(src), jnp.asarray(mask)
    rj = jgn.run_gn(lambda t: jres.ndt_hg(t, src_j, mask_j, mj, inv, OUTLIER), jnp.asarray(t0),
                    cfg_j)
    rt = run_port(mt, src, mask, t0, inv, cfg_t, monkeypatch)
    assert_close_to_jax(rt, rj)


@pytest.mark.parametrize("case", ["starved", "bad voxels", "every row masked"])
def test_driver_matches_jax_on_edge_cases(ndt_scene, case, monkeypatch):  # noqa: F811
    """A starved source (min_valid above the valid pairs it has: never
    converged, the bound ends the loop), a map whose estimated voxels
    include one-point ones and some with inf or NaN info (gated out, never
    in the sums), and a source with every row masked (no pair at all)."""
    mj, mt, src, mask, t0, inv = scan_case(*ndt_scene)
    min_valid = 10
    if case == "starved":
        min_valid = 7 * int(mask.sum()) + 1
    elif case == "every row masked":
        mask = np.zeros_like(mask)
    else:
        mj = with_bad_voxels(mj, src, mask, t0, inv)
        mt = convert.ndt_map(mj)
        assert (mt.count.numpy() == 1).sum() > 10
        assert not np.isfinite(mt.info.numpy()).all()
    cfg_j, cfg_t = gn_cfgs(30, min_valid=min_valid)
    rj = run_jax(mj, src, mask, t0, inv, cfg_j)
    rt = run_port(mt, src, mask, t0, inv, cfg_t, monkeypatch)
    assert_close_to_jax(rt, rj)
    assert np.isfinite(rt.t_mat.numpy()).all() and np.isfinite(float(rt.total_res))
    if case != "bad voxels":
        assert not bool(rt.converged) and int(rt.iters) == 30
        assert int(rt.num_valid) < min_valid
    if case == "every row masked":
        assert int(rt.num_valid) == 0 and torch.equal(rt.t_mat, torch.as_tensor(t0))


# ------------------------------------------ (b) against the port's host loop
@pytest.mark.parametrize("max_iters", [2, 30])
def test_driver_equals_the_host_loop(ndt_scene, max_iters):  # noqa: F811
    """On the CPU run_gn_ndt gives the port's old route, run_gn_corr over
    ndt_corr and ndt_hg_corr, bit for bit: the same arithmetic at the same
    poses."""
    _, mt, src, mask, t0, inv = scan_case(*ndt_scene)
    s, msk, t = torch.from_numpy(src), torch.from_numpy(mask), torch.as_tensor(t0)
    cfg = gn_cfgs(max_iters)[1]
    old = gn.run_gn_corr(lambda p: tres.ndt_corr(p, s, msk, mt, inv, OUTLIER),
                         lambda p, c: tres.ndt_hg_corr(p, s, c), t, cfg)
    new = gn.run_gn_ndt(s, msk, mt, inv, OUTLIER, t, cfg)
    assert torch.equal(new.t_mat, old.t_mat)
    assert int(new.iters) == int(old.iters) and bool(new.converged) == bool(old.converged)
    assert int(new.num_valid) == int(old.num_valid)
    assert torch.equal(new.total_res, old.total_res.to(torch.float32))


# --------------------------------------- (c) NdtMatcher.match, one read a match
@pytest.mark.parametrize("localization", [False, True])
def test_ndt_match_one_round_and_one_read(ndt_scene, localization, monkeypatch):  # noqa: F811
    """NdtMatcher.match against the JAX matcher from the same state and
    guess: pose, converged and gathers as test_ndt_match_matches_jax holds
    them, and the whole loop in one round with one host read."""
    state, s1, t_init = ndt_scene
    cfg = dict(NDT, is_localization_mode=localization)
    cj, ct = clouds(s1.points)
    _, rj = jm.NdtMatcher(jm.NdtConfig(**cfg)).match(jax.tree.map(jnp.asarray, state), cj,
                                                     t_init)
    rounds = Rounds(monkeypatch)
    _, rt = tm.NdtMatcher(tm.NdtConfig(**cfg), device="cpu").match(
        convert.matcher_state(state), ct, t_init)
    assert rounds.calls == rounds.reads == 1
    assert bool(rt.converged) == bool(rj.converged) is True
    assert int(rt.iters) == int(rj.iters) > 1
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 1e-3
    assert float(chord_angle(pt, pj)) < 1e-3


# -------------------------------------------------- (d) the kernel's source
def cu_text() -> str:
    return (CSRC / "gn_loop.cu").read_text()


def test_enums_and_signature_match_the_kernel_source():
    text = cu_text()
    upd = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bU_([A-Z_]+) = (\d+)", text)}
    assert upd == {"ICP": gn_loop.UPDATE_ICP, "LOAM": gn_loop.UPDATE_LOAM,
                   "NDT": gn_loop.UPDATE_NDT}
    kinds = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bG_([A-Z_]+) = (\d+)", text)}
    assert kinds == {k.removesuffix("_gn_rounds").upper(): v
                     for k, v in gn_loop.CLUSTER_KIND.items()}
    assert kinds["NDT"] == gn_loop.CLUSTER_KIND["ndt_gn_rounds"] == 3
    params = re.search(r'extern "C" int ndt_gn_launch\(([^)]*)\)', text).group(1)
    kinds = ["ptr" if "*" in q else q.split()[0] for q in params.split(",")]
    # src, mask, fpwin, mean, info, estimated, carry, the slot cache, the
    # stream; the schedule is fixed (corr_every 1, no trust-region skip),
    # so no radius
    assert kinds.count("ptr") == 9 and kinds.count("int") == 7 and kinds.count("float") == 5
    # the int64 probe windows [C, 16], read as stored, and the int32 scratch
    assert "const long long* fpwin" in params and "int* slot_cache" in params
    assert not re.search(r"corr_every|skip_dist|radius", params)
    sig = cuda_build.SIGNATURES["gn_loop"]["ndt_gn_launch"][0]
    assert len(sig) == len(kinds) == 8 + 7 + 5 + 1
    assert tndt.PROBE_WINDOW == jvh.PROBE_WINDOW  # the wrapper's bound on num_probes
    assert gn_loop.ndt_gn_rounds in gn_loop.KERNELS
    assert gn.ROUND_DRIVERS["ndt_gn_rounds"] is gn.run_gn_ndt


def test_hash_constants_and_stencil_match_the_python_side():
    text = cu_text()
    const = {m.group(1): int(m.group(2), 0)
             for m in re.finditer(r"\bk(P[123]|F[123]|Fmix[12]) = (0x[0-9A-Fa-f]+|\d+)u", text)}
    assert const == {"P1": tvox._P1, "P2": tvox._P2, "P3": tvox._P3,
                     "F1": jvh._F1, "F2": jvh._F2, "F3": jvh._F3,
                     "Fmix1": 0x85EBCA6B, "Fmix2": 0xC2B2AE35}
    assert (tvox._P1, tvox._P2, tvox._P3) == (jvox._P1, jvox._P2, jvox._P3)
    # fmix32's multipliers: the ones ops/voxel.py applies
    fmix = re.findall(r"u32_mul\(h, (0x[0-9A-F]+)\)", Path(tvox.__file__).read_text())
    assert [int(v, 16) for v in fmix] == [const["Fmix1"], const["Fmix2"]]
    body = re.search(r"kStencil\[7\]\[3\] = \{(.*?)\};", text).group(1)
    sten = [tuple(int(v) for v in t.split(",")) for t in re.findall(r"\{([^{}]*)\}", body)]
    assert sten == [tuple(o) for o in tndt.NDT_STENCIL] == [tuple(o) for o in jndt.NDT_STENCIL]


def test_a_python_mirror_of_the_kernel_lookup_finds_the_map_slots(ndt_scene):  # noqa: F811
    """The kernel's lookup written out in Python uint32 arithmetic (the
    hash, the fingerprint, the first match among num_probes slots) finds
    the slots ndt_map's own lookup finds, around every source point."""
    _, mt, src, mask, t0, inv = scan_case(*ndt_scene)
    p = tres.transform_points(torch.as_tensor(t0), torch.from_numpy(src))[torch.from_numpy(mask)]
    coords = tvox.voxel_coords(p, inv)[:300]
    fp = mt.fp.numpy()
    mean_ref, _, valid_ref = tndt.query_stencil(mt, p[:300], inv)
    u = np.uint64(0xFFFFFFFF)

    def fmix(h):
        h ^= h >> np.uint64(16)
        h = (h * np.uint64(0x85EBCA6B)) & u
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & u
        return h ^ (h >> np.uint64(16))

    found = 0
    for n, c in enumerate(coords.numpy()):
        for v, off in enumerate(tndt.NDT_STENCIL):
            x, y, z = (np.uint64(np.uint32(np.int32(a + b))) for a, b in zip(c, off))
            base = fmix(((x * np.uint64(tvox._P1)) & u) ^ ((y * np.uint64(tvox._P2)) & u)
                        ^ ((z * np.uint64(tvox._P3)) & u)) & np.uint64(mt.capacity - 1)
            f = fmix((((x * np.uint64(jvh._F1)) & u) + ((y * np.uint64(jvh._F2)) & u)
                      + ((z * np.uint64(jvh._F3)) & u)) & u) | np.uint64(1)
            slot = next((int((base + np.uint64(k)) & np.uint64(mt.capacity - 1))
                         for k in range(8) if fp[int((base + np.uint64(k))
                                                     & np.uint64(mt.capacity - 1))] == int(f)),
                        -1)
            valid = slot >= 0 and bool(mt.estimated[slot])
            assert valid == bool(valid_ref[n, v])
            if valid:
                assert torch.equal(mt.mean[slot], mean_ref[n, v])
                found += 1
    assert found > 300


U32 = np.uint64(0xFFFFFFFF)


def _fmix(h):
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & U32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & U32
    return h ^ (h >> np.uint64(16))


def _base_and_key(voxel, capacity):
    """The kernel's window base and fingerprint of one voxel, in uint32
    arithmetic (ops/voxel.py spatial_hash, maps/voxel_hash.py fingerprint)."""
    x, y, z = (np.uint64(np.uint32(np.int32(a))) for a in voxel)
    base = _fmix(((x * np.uint64(tvox._P1)) & U32) ^ ((y * np.uint64(tvox._P2)) & U32)
                 ^ ((z * np.uint64(tvox._P3)) & U32)) & np.uint64(capacity - 1)
    key = _fmix((((x * np.uint64(jvh._F1)) & U32) + ((y * np.uint64(jvh._F2)) & U32)
                 + ((z * np.uint64(jvh._F3)) & U32)) & U32) | np.uint64(1)
    return int(base), int(key)


def batched_lookup(fpwin: np.ndarray, voxels: np.ndarray, num_probes: int) -> np.ndarray:
    """csrc/gn_loop.cu's lookup (`ndt_probe_batch`) in Python for the
    stencil voxels of each row of int32 voxel coords [R, 3]: every window's
    probes 0-7 read (the window row fpwin[base]) before any compare, the
    first match below num_probes its slot; probes 8-15 read only for the
    windows without one, where num_probes > 8; -1 where none matches.
    [R, 7] slots."""
    cap = fpwin.shape[0]
    out = np.full((len(voxels), 7), -1, np.int64)
    for n, c in enumerate(voxels):
        keys = [_base_and_key(np.asarray(c) + off, cap) for off in tndt.NDT_STENCIL]
        for start in (0, 8):
            if start >= num_probes:
                break
            windows = [fpwin[b, start:start + 8].copy() for b, _ in keys]  # all loads first
            for v, ((b, key), w) in enumerate(zip(keys, windows)):
                if out[n, v] >= 0:
                    continue
                hits = [k for k in range(8) if start + k < num_probes and int(w[k]) == key]
                if hits:
                    out[n, v] = (b + start + hits[0]) & (cap - 1)
    return out


def hand_map(voxels, offsets, capacity):
    """An NDT map built by hand, fp and fpwin set directly (no insert):
    voxel i of `voxels` at window offset offsets[i] from its base, its mean
    (slot, i, 0) so a lookup's mean names the slot, info I, estimated."""
    fp = torch.zeros(capacity, dtype=torch.int64)
    mean = torch.zeros(capacity, 3)
    for i, (vox, off) in enumerate(zip(voxels, offsets)):
        base, key = _base_and_key(vox, capacity)
        slot = (base + off) % capacity
        assert int(fp[slot]) == 0, "two voxels in one slot"
        fp[slot] = key
        mean[slot] = torch.tensor([slot, i, 0.0])
    occupied = fp != 0
    m = tndt.create(capacity)
    return m._replace(fp=fp, fpwin=_window(fp), mean=mean,
                      info=torch.eye(3).expand(capacity, 3, 3).clone(), estimated=occupied,
                      count=occupied.float() * 10)


def lookup_case(name, ndt_scene):
    """(map, row voxel coords [R, 3], num_probes) of each lookup case."""
    if name == "scene":
        _, mt, src, mask, t0, inv = scan_case(*ndt_scene)
        p = tres.transform_points(torch.as_tensor(t0), torch.from_numpy(src))
        coords = tvox.voxel_coords(p[torch.from_numpy(mask)], inv)[:300].numpy()
        return mt, coords, 8
    rng = np.random.default_rng(11)
    rows = rng.integers(-6, 6, (40, 3)).astype(np.int32)
    sten = np.unique((rows[:, None, :] + np.asarray(tndt.NDT_STENCIL)).reshape(-1, 3), axis=0)
    if name == "wrapping window":
        # 16 slots: voxels whose base is 9-15 at offset 7 (past slot 15), the
        # rest, where free, at offset 0
        cap, placed, offs, used = 16, [], [], set()
        for vox in sten[rng.permutation(len(sten))]:
            base, _ = _base_and_key(vox, cap)
            off = 7 if base >= 9 else 0
            if (base + off) % cap not in used:
                used.add((base + off) % cap)
                placed.append(vox)
                offs.append(off)
        assert sum(_base_and_key(v, cap)[0] + o >= cap for v, o in zip(placed, offs)) >= 3
        return hand_map(placed, offs, cap), rows, 8
    # 256 slots: every third voxel at offset 3 (slots 0-2 of its window
    # empty where no other voxel took them), one at offset 10 (found with
    # 16 probes only)
    cap, placed, offs, used = 256, [], [], set()
    for i, vox in enumerate(sten[::3]):
        base, _ = _base_and_key(vox, cap)
        off = 10 if i == 0 else 3
        if (base + off) % cap not in used:
            used.add((base + off) % cap)
            placed.append(vox)
            offs.append(off)
    return hand_map(placed, offs, cap), rows, 16 if name == "empty slot, 16 probes" else 8


@pytest.mark.parametrize("name", ["scene", "wrapping window", "empty slot before the match",
                                  "empty slot, 16 probes"])
def test_the_batched_lookup_finds_the_map_slots(ndt_scene, name):  # noqa: F811
    """The kernel's lookup order (`batched_lookup`: every probe of a window
    read before the first compare, the first match a voxel) finds the
    slots ndt_map's own lookup (`_stencil_lookup`) finds, on the NDT scene,
    on a hand-built 16-slot map whose windows wrap past slot 15, and on a
    hand-built map with empty slots before the matches (num_probes 8 and
    16, one voxel at offset 10). Exact: the same slot, or none."""
    m, coords, probes = lookup_case(name, ndt_scene)
    slots = batched_lookup(m.fpwin.numpy(), coords, probes)
    mean_ref, _, valid_ref = tndt._stencil_lookup(m, torch.from_numpy(coords), probes)
    found = slots >= 0
    valid = found & m.estimated.numpy()[np.maximum(slots, 0)]
    assert np.array_equal(valid, valid_ref.numpy())
    assert torch.equal(mean_ref[torch.from_numpy(valid)],
                       m.mean[torch.from_numpy(slots[valid])])
    cap = m.capacity
    bases = np.array([[_base_and_key(c + np.asarray(o), cap)[0] for o in tndt.NDT_STENCIL]
                      for c in coords])
    offset = (slots - bases) % cap
    empty_before = [bool((m.fpwin[b, :k] == 0).any()) for b, k in zip(bases[found],
                                                                      offset[found])]
    if name == "scene":
        assert found.sum() > 300
    elif name == "wrapping window":
        assert (found & (slots < bases)).sum() >= 3  # matches past the wrap
    else:
        assert sum(empty_before) >= 10
        deep = int((found & (offset >= 8)).sum())
        assert deep > 0 if probes == 16 else deep == 0


def structured_fold(t_mat, src, corr):
    """csrc/gn_loop.cu's fold (`ndt_fold_row`) in float64: a row's valid
    pairs summed first (lsum = sum lam, esum = sum lam^T e), then J = [a |
    I]'s structure applied once a row: H_rr = a^T lsum a, H_rt = a^T lsum,
    H_tt = lsum, g = -[a^T esum; esum]."""
    r = t_mat[:3, :3]
    err = tres.transform_points(t_mat, src)[:, None, :] - corr.mu
    w = corr.valid.to(src.dtype)
    lsum = torch.einsum("nv,nvab->nab", w, corr.lam)
    esum = torch.einsum("nv,nvab,nva->nb", w, corr.lam, err)
    a = -torch.einsum("ij,njk->nik", r, tres.so3_hat(src))
    h = torch.zeros(6, 6, dtype=src.dtype)
    h[:3, :3] = torch.einsum("nki,nkl,nlj->ij", a, lsum, a)
    h[:3, 3:] = torch.einsum("nki,nkj->ij", a, lsum)
    h[3:, :3] = torch.einsum("nik,nkj->ij", lsum, a)
    h[3:, 3:] = lsum.sum(0)
    g = -torch.cat([torch.einsum("nki,nk->i", a, esum), esum.sum(0)])
    return h, g


@pytest.mark.parametrize("seed,asymmetric", [(0, False), (1, False), (2, True)])
def test_the_structured_fold_equals_the_dense_normal_equations(seed, asymmetric):
    """The kernel's fold of a row's pairs through J's structure gives the
    dense sum J^T lam J and -J^T lam^T e of residuals.ndt_hg_corr, in
    float64, on a random map, pose and source (and, with `asymmetric`, an
    info that is not symmetric, as sums in no fixed order can leave it):
    within 1e-12 of the largest entry (the two differ in summation order
    only)."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-6, 6, (3000, 3)))
    m = tndt.insert(tndt.create(2048, dtype=torch.float64), pts, torch.ones(3000, dtype=torch.bool),
                    0.5, min_points=3)
    if asymmetric:
        m = m._replace(info=m.info + torch.from_numpy(rng.normal(0, 0.05, m.info.shape)))
    t_mat = torch.from_numpy(np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32)),
                                        np.float64))
    src = torch.from_numpy(rng.uniform(-6, 6, (500, 3)))
    mask = torch.from_numpy(rng.random(500) < 0.9)
    corr = tres.ndt_corr(t_mat, src, mask, m, 0.5, 1e6)
    assert int(corr.valid.sum()) > 500
    dense = tres.ndt_hg_corr(t_mat, src, corr)
    h, g = structured_fold(t_mat, src, corr)
    assert dense.h.dtype == torch.float64
    assert torch.allclose(h, dense.h, rtol=0, atol=1e-12 * float(dense.h.abs().max()))
    assert torch.allclose(g, dense.g, rtol=0, atol=1e-12 * float(dense.g.abs().max()))
    if asymmetric:  # lam^T e, not lam e: the fold follows the reference's g
        assert not torch.allclose(m.info, m.info.transpose(-1, -2))


def test_the_bound_counts_each_iterations_pairs_and_folded_rows(monkeypatch):
    """chip_smoke.ndt_cost, the kernel's bound, counts the work by J's
    structure at each of the plain version's iterations: every unmasked row
    and its 7 voxels, every valid pair, and J applied once to the sums of
    each row with a valid pair; here held against the poses the plain loop
    visits, counted apart."""
    import chip_smoke

    pts = torch.from_numpy(np.random.default_rng(3).uniform(-5, 5, (2000, 3)).astype(np.float32))
    m = tndt.insert(tndt.create(1024), pts, torch.ones(2000, dtype=torch.bool), 1.0,
                    estimate_all=True)
    src, mask = pts[:300] + 0.05, torch.ones(300, dtype=torch.bool)
    mask[::5] = False
    carry, radius, cfg = gn_loop.init_carry(torch.eye(4)), torch.tensor(20.0), gn_cfgs(30)[1]
    poses, hg = [], gn_loop.ndt_hg

    def seen(t_mat, *a):
        poses.append(t_mat.clone())
        return hg(t_mat, *a)

    monkeypatch.setattr(gn_loop, "ndt_hg", seen)
    gn_loop.ndt_gn_rounds_plain(carry.clone(), src, mask, m, 1.0, OUTLIER, radius, cfg)
    monkeypatch.setattr(gn_loop, "ndt_hg", hg)
    _, ops, its = chip_smoke.ndt_cost(torch, (carry, src, mask, m, 1.0, OUTLIER, radius, cfg))
    assert its == len(poses) > 1
    rows, want = int(mask.sum()), 0
    for t_mat in poses:
        valid = tres.ndt_corr(t_mat, src, mask, m, 1.0, OUTLIER).valid
        pairs, folded = int(valid.sum()), int(valid.any(-1).sum())
        assert 0 < folded < rows and pairs > folded
        want += (rows * (chip_smoke.NDT_ROW_OPS + 7 * chip_smoke.NDT_VOXEL_OPS)
                 + pairs * chip_smoke.NDT_PAIR_OPS + folded * chip_smoke.NDT_FOLD_OPS)
    assert ops == want
    assert (chip_smoke.NDT_PAIR_OPS, chip_smoke.NDT_FOLD_OPS) == (52, 191)


# ------------------------------------------------ (e) refusals and dispatch
def small_inputs(device=None):
    pts = np.random.default_rng(3).uniform(-5, 5, (64, 3)).astype(np.float32)
    m = tndt.insert(tndt.create(256), torch.from_numpy(pts), torch.ones(64, dtype=torch.bool),
                    1.0, estimate_all=True)
    src = torch.from_numpy(pts + 0.05)
    mask = torch.ones(64, dtype=torch.bool)
    carry = gn_loop.init_carry(torch.eye(4))
    radius = torch.tensor(20.0)
    if device is not None:
        m = tndt.NdtMap(*(t.to(device) for t in m))
        src, mask, carry, radius = (t.to(device) for t in (src, mask, carry, radius))
    return carry, src, mask, m, radius


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU inputs run ndt_gn_rounds_plain bit for bit, to DONE in one call,
    and build, load and count nothing."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel was built for CPU tensors")

    monkeypatch.setattr(cuda_build, "library", no_build)
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    before = [fn.launches for fn in gn_loop.KERNELS]
    carry, src, mask, m, radius = small_inputs()
    other = carry.clone()
    cfg = gn_cfgs(30)[1]
    sa = gn_loop.ndt_gn_rounds(carry, src, mask, m, 1.0, OUTLIER, radius, cfg)
    sb = gn_loop.ndt_gn_rounds_plain(other, src, mask, m, 1.0, OUTLIER, radius, cfg)
    assert torch.equal(carry, other) and int(sa) == int(sb) == gn_loop.DONE
    assert int(carry[gn_loop.OFFSET["gathers"]]) == int(carry[gn_loop.OFFSET["it"]]) > 0
    assert [fn.launches for fn in gn_loop.KERNELS] == before


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """The settings the kernel does not serve raise on every device; off
    the CPU the wrapper checks its inputs and never computes a result
    itself: a float64 source, a non-bool mask or flag, int32 fingerprints,
    a non-contiguous input and inputs that pass the checks but lie off a
    CUDA device all raise."""
    carry, src, mask, m, radius = small_inputs()
    cfg = gn_cfgs(30)[1]
    for bad in (cfg._replace(corr_every=10), cfg._replace(skip_regather_dist=0.2)):
        with pytest.raises(ValueError, match="corr_every 1"):
            gn_loop.ndt_gn_rounds(carry, src, mask, m, 1.0, OUTLIER, radius, bad)
    with pytest.raises(ValueError, match="num_probes"):
        gn_loop.ndt_gn_rounds(carry, src, mask, m, 1.0, OUTLIER, radius, cfg, num_probes=17)
    with pytest.raises(ValueError, match="corr_every 1"):
        gn.run_gn_ndt(src, mask, m, 1.0, OUTLIER, torch.eye(4), cfg._replace(corr_every=5))
    with pytest.raises(ValueError, match="NDT update"):
        gn.run_gn_ndt(src, mask, m, 1.0, OUTLIER, torch.eye(4), cfg._replace(update="icp"))
    carry, src, mask, m, radius = small_inputs("meta")

    def call(carry=carry, src=src, mask=mask, m=m):
        return gn_loop.ndt_gn_rounds(carry, src, mask, m, 1.0, OUTLIER, radius, cfg)

    with pytest.raises(TypeError, match="float32 src"):
        call(src=src.double())
    with pytest.raises(TypeError, match="bool src_mask"):
        call(mask=mask.to(torch.uint8))
    with pytest.raises(TypeError, match="int64 fpwin"):
        call(m=m._replace(fpwin=m.fpwin.to(torch.int32)))
    with pytest.raises(ValueError, match="fpwin of shape"):
        call(m=m._replace(fpwin=m.fpwin[:, :8].contiguous()))
    with pytest.raises(TypeError, match="bool estimated"):
        call(m=m._replace(estimated=m.estimated.float()))
    with pytest.raises(TypeError, match="int32 carry"):
        call(carry=carry.float())
    with pytest.raises(ValueError, match="contiguous"):
        call(src=src.T.contiguous().T)
    with pytest.raises(ValueError, match="info of shape"):
        call(m=m._replace(info=m.info[:, :2].contiguous()))
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(ValueError, match="CUDA"):  # CPU inputs: the wrapper's plain route
        gn_loop._checked_ndt_inputs(*small_inputs()[:4])
