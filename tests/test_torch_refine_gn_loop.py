"""The loop closure's point-to-plane refine with the block map's 5-NN lookup
inside every iteration (ops/gn_loop.py::plane_map_gn_rounds,
registration/gn.py::run_gn_plane_map) on the CPU, where the wrapper runs the
plain version: the driver against the JAX `run_gn(point_to_plane_hg)` on
block maps both packages build from the same seeded target, bit for bit
against the port's host loop (`run_gn`), a NumPy mirror of the kernel's
lookup and selection order against `block_map.query_knn(k=5)` of both
packages, the kernel source's signature and enums against the Python side,
the loop closure's one refine round a verification, and the wrapper's
refusals and dispatch.

Tolerances: (a) against JAX, on scenes near the origin whose 5-neighbour
patches span decimetres to a metre (so the float32 plane fits are not
decided by rounding, ROADMAP Queue 3), the same iterations, `converged` and
`num_valid`, and the pose within 1e-4 m and 1e-4 rad (`chord_angle`). The
drifted room of tests/test_torch_backend.py lies 2-14 m from the origin,
where the float32 fits follow the last bits (the two packages keep 2,055
and 2,066 of 10,800 rows at its start pose), so it is held in float64: with
1 cm of noise, as the near scenes are; as the noise-free 0.2 m grid it is,
whose points sit on voxel faces and at the 2 m gate, one iteration at a time
along the JAX call's path, to 10 rows, 5e-3 m and 5e-4 rad a step (the
test says why).
(b) Against the port's host loop, every output bit for bit (the same
arithmetic at the same poses). (c) The lookup mirror: the same points in
the same order as both packages' query_knn, the port's squared distances
exactly and the JAX package's to 2.5e-7 relative (XLA may round the
three-term sum another way: an ulp)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.maps import block_map as jbm
from funny_lidar_slam_tpu.registration import gn as jgn
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.backend import loop_closure as tlc
from funny_lidar_slam_torch.core.lie import chord_angle, so3_exp
from funny_lidar_slam_torch.maps import block_map as tbm
from funny_lidar_slam_torch.ops import cuda_build, gn_loop
from funny_lidar_slam_torch.pipeline.keyframes import KeyFrame as TKeyFrame
from funny_lidar_slam_torch.registration import gn
from funny_lidar_slam_torch.registration import residuals as tres

from test_registration import room_scene
from test_torch_backend import VERIFY_CFG, drifted_room
from test_torch_ndt_gn_loop import _base_and_key  # csrc/gn_loop.cu's hash_key

torch.set_num_threads(1)

CSRC = Path(gn_loop.__file__).resolve().parents[1] / "csrc"
INV = 1.0  # the loop closure's nn_voxel_size
PLANE_THRESH, MAX_D2 = 0.3, 4.0  # _verify_cascade's gates (fitness_max_range 2 m)
MAP_CAP, BUCKET = 8192, 8  # voxels (4,096 block slots), LoopClosureConfig.bucket_size


class Rounds:
    """Counts the driver's kernel calls and its host reads."""

    def __init__(self, monkeypatch):
        self.calls, self.reads = 0, 0
        rounds, read = gn.plane_map_gn_rounds, gn._host_read

        def counted_rounds(*a):
            self.calls += 1
            return rounds(*a)

        def counted_read(flags):
            self.reads += 1
            return read(flags)

        monkeypatch.setattr(gn, "plane_map_gn_rounds", counted_rounds)
        monkeypatch.setattr(gn, "_host_read", counted_read)


def gn_cfgs(max_iters=20, min_valid=10):
    """_verify_cascade's refine settings for both packages."""
    kw = dict(max_iters=max_iters, rotation_eps=1e-4, position_eps=1e-4, update="loam",
              use_stall_check=True, min_valid=min_valid)
    return jgn.GNConfig(**kw), gn.GNConfig(**kw)


def pad(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(pts)] = pts
    return out, np.arange(cap) < len(pts)


def pose(rotvec, trans):
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = so3_exp(torch.tensor(rotvec, dtype=torch.float64)).numpy()
    t[:3, 3] = trans
    return t


def near_scene(seed):
    """(target, source, start pose): a noisy room of 0.45 m spacing within
    ~5 m of the origin, and the same room seen from a pose ~0.15 m and
    ~0.02 rad away, with its own noise; the refine starts at the identity."""
    rng = np.random.default_rng(seed)
    world = room_scene(0.45, 6.0, 0.03, seed=seed) - np.float32([4.5, 5.5, 6.5])
    t = pose(rng.normal(0, 0.02, 3), rng.normal(0, 0.15, 3)).astype(np.float64)
    src = (world - t[:3, 3]) @ t[:3, :3] + rng.normal(0, 0.01, world.shape)
    return world, src.astype(np.float32), np.eye(4, dtype=np.float32)


def maps_of(tgt, mask, dtype=np.float32):
    """The block maps both packages build from one padded target, checked
    equal."""
    mj = jbm.build(MAP_CAP, BUCKET, jnp.asarray(tgt.astype(dtype)), jnp.asarray(mask), INV)
    mt = tbm.build(MAP_CAP, BUCKET, torch.from_numpy(tgt.astype(dtype)), torch.from_numpy(mask),
                   INV)
    np.testing.assert_array_equal(mt.fp.numpy(), np.asarray(mj.fp).astype(np.int64))
    np.testing.assert_array_equal(mt.tab.numpy(), np.asarray(mj.tab))
    return mj, mt


def case(name, seed=1):
    """(JAX map, port map, source, mask, start pose, (JAX cfg, port cfg)) of
    a near-origin scene with the edge case `name` applied."""
    world, src, t0 = near_scene(seed)
    tgt, tmask = pad(world, 1024)
    src, mask = pad(src, 1024)
    mj, mt = maps_of(tgt, tmask)
    cfgs = gn_cfgs()
    if name == "starved":  # min_valid above the rows: only the stall test or the bound ends it
        cfgs = gn_cfgs(min_valid=int(mask.sum()) + 1)
    elif name == "max_iters 1":
        cfgs = gn_cfgs(max_iters=1)
    elif name == "masked rows":
        mask = mask & (np.arange(len(mask)) % 3 != 0)
    return mj, mt, src, mask, t0, cfgs


def run_jax(mj, src, mask, t0, cfg):
    src_j, mask_j = jnp.asarray(src), jnp.asarray(mask)
    return jgn.run_gn(lambda t: jres.point_to_plane_hg(t, src_j, mask_j, mj, INV, PLANE_THRESH,
                                                       MAX_D2),
                      jnp.asarray(t0), cfg)


def run_port(mt, src, mask, t0, cfg, monkeypatch):
    rounds = Rounds(monkeypatch)
    rt = gn.run_gn_plane_map(torch.from_numpy(src), torch.from_numpy(mask), mt, INV,
                             PLANE_THRESH, MAX_D2, torch.as_tensor(t0), cfg)
    assert rounds.calls == rounds.reads == 1  # the whole loop, one host read
    return rt


def pose_close(pt, pj, tol=1e-4):
    pt, pj = np.asarray(pt, np.float64), np.asarray(pj, np.float64)
    return np.abs(pt[:3, 3] - pj[:3, 3]).max() < tol and float(chord_angle(pt, pj)) < tol


def assert_close_to_jax(rt, rj):
    assert int(rt.iters) == int(rj.iters)
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.num_valid) == int(rj.num_valid)
    assert pose_close(rt.t_mat.numpy(), rj.t_mat)


def carry_of(res) -> torch.Tensor:
    """The carry of a result whose fields are views of it."""
    return res.iters.as_strided((gn_loop.CARRY_SIZE,), (1,), 0)


# ------------------------------------------------- (a) the driver against JAX
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_driver_matches_jax_near_the_origin(seed, monkeypatch):
    """run_gn_plane_map against the JAX run_gn(point_to_plane_hg) from the
    identity, ~0.15 m and ~0.02 rad off: iterations, converged, num_valid
    and pose; one kernel call and one host read."""
    mj, mt, src, mask, t0, (cfg_j, cfg_t) = case("plain", seed)
    rj = run_jax(mj, src, mask, t0, cfg_j)
    rt = run_port(mt, src, mask, t0, cfg_t, monkeypatch)
    assert_close_to_jax(rt, rj)
    assert bool(rt.converged) and 1 < int(rt.iters) < 20 and int(rt.num_valid) > 500


@pytest.mark.parametrize("name", ["starved", "max_iters 1", "masked rows"])
def test_driver_matches_jax_on_edge_cases(name, monkeypatch):
    """A starved source (min_valid above its rows: never converged; its
    loop ends on the stall test), one iteration, and a source with every
    third row masked."""
    mj, mt, src, mask, t0, (cfg_j, cfg_t) = case(name)
    rj = run_jax(mj, src, mask, t0, cfg_j)
    rt = run_port(mt, src, mask, t0, cfg_t, monkeypatch)
    assert_close_to_jax(rt, rj)
    o = gn_loop.OFFSET
    carry = carry_of(rt)
    if name == "starved":  # done, not converged, before the bound: the stall test ended it
        assert not bool(rt.converged) and int(carry[o["done"]]) == 1
        assert int(rt.iters) < cfg_t.max_iters and int(rt.num_valid) < cfg_t.min_valid
    elif name == "max_iters 1":
        assert int(rt.iters) == 1 and not bool(rt.converged)
    else:
        assert int(rt.num_valid) <= int(mask.sum()) < 2 * 1024 // 3


def drifted_case(noise: bool):
    """(JAX map, port map, source, mask, start pose) of the drifted room in
    float64, with 1 cm of seeded noise on both clouds or none. Its 1 m
    voxels hold ~25 points for a bucket of 8, and the JAX sort that picks
    them is not stable (ROADMAP Queue 3), so the port takes the JAX map as
    built (convert.block_map)."""
    world, local, _, poses = drifted_room()
    if noise:
        rng = np.random.default_rng(0)
        world = world + rng.normal(0, 0.01, world.shape).astype(np.float32)
        local = local + rng.normal(0, 0.01, local.shape).astype(np.float32)
    tgt, tmask = pad(world, 10880)
    src, mask = pad(local, 10880)
    mj = jbm.build(MAP_CAP, BUCKET, jnp.asarray(tgt.astype(np.float64)), jnp.asarray(tmask), INV)
    return mj, convert.block_map(mj), src.astype(np.float64), mask, poses[1].astype(np.float32)


def test_noisy_drifted_room_matches_jax(monkeypatch):
    """The drifted room with 1 cm of noise, in float64 (2-14 m from the
    origin, where float32 fits follow the last bits): the whole call, from
    the pose 0.6 m off, as the near scenes are held."""
    mj, mt, src, mask, t0 = drifted_case(noise=True)
    cfg_j, cfg_t = gn_cfgs()
    rj = run_jax(mj, src, mask, t0.astype(np.float64), cfg_j)
    rt = run_port(mt, src, mask, t0, cfg_t, monkeypatch)
    assert_close_to_jax(rt, rj)
    assert bool(rt.converged) and int(rt.num_valid) > 10000


def test_drifted_room_step_by_step_near_jax():
    """The drifted room as tests/test_torch_backend.py has it, in float64:
    along the JAX call's path, each iteration from the same pose (rounded to
    float32, the carry's type) in both packages. Its noise-free 0.2 m grid
    puts points on voxel faces (z = 5.0 at the start pose) and pairs of map
    points 2 m apart (d2 = 4.0, the gate), so a last-bit difference of the
    two packages' transforms flips a few rows at each step (measured: at
    most 5 of 6,146-10,686 rows, steps within 3.3e-3 m and 2.3e-4 rad); each
    step is held to 10 rows and 5e-3 m and 5e-4 rad (the first 8 steps;
    from the 7th the JAX path alternates between two poses), and the whole
    calls to converging within 0.05 m of each other."""
    mj, mt, src, mask, t0 = drifted_case(noise=False)
    cfg_j, cfg_t = gn_cfgs()
    whole = run_jax(mj, src, mask, t0.astype(np.float64), cfg_j)
    one_j, one_t = cfg_j._replace(max_iters=1), cfg_t._replace(max_iters=1)
    at = t0
    for step in range(min(int(whole.iters), 8)):  # from the 7th the steps repeat
        rj = run_jax(mj, src, mask, at.astype(np.float64), one_j)
        rt = gn.run_gn_plane_map(torch.from_numpy(src), torch.from_numpy(mask), mt, INV,
                                 PLANE_THRESH, MAX_D2, torch.from_numpy(at), one_t)
        assert abs(int(rt.num_valid) - int(rj.num_valid)) <= 10 and int(rj.num_valid) > 5000
        assert pose_close(rt.t_mat.numpy(), rj.t_mat, 5e-3), step
        at = np.asarray(rj.t_mat, np.float32)
    port = gn.run_gn_plane_map(torch.from_numpy(src), torch.from_numpy(mask), mt, INV,
                               PLANE_THRESH, MAX_D2, torch.from_numpy(t0), cfg_t)
    assert bool(whole.converged) and bool(port.converged) and int(whole.iters) > 5
    assert pose_close(port.t_mat.numpy(), whole.t_mat, 0.05)


# ------------------------------------------ (b) against the port's host loop
@pytest.mark.parametrize("scene", ["drifted room", "near the origin", "starved"])
def test_driver_equals_the_host_loop(scene):
    """On the CPU run_gn_plane_map gives the port's old route, run_gn over
    point_to_plane_hg, bit for bit: the same arithmetic at the same poses."""
    if scene == "drifted room":
        world, local, _, poses = drifted_room()
        tgt, tmask = pad(world, 10880)
        src, mask = pad(local, 10880)
        mt = tbm.build(MAP_CAP * 4, BUCKET, torch.from_numpy(tgt), torch.from_numpy(tmask), INV)
        t0, cfg = poses[1].astype(np.float32), gn_cfgs()[1]
    else:
        _, mt, src, mask, t0, (_, cfg) = case("plain" if scene == "near the origin" else scene)
    s, m, t = torch.from_numpy(src), torch.from_numpy(mask), torch.as_tensor(t0)
    old = gn.run_gn(lambda p: tres.point_to_plane_hg(p, s, m, mt, INV, PLANE_THRESH, MAX_D2), t,
                    cfg)
    new = gn.run_gn_plane_map(s, m, mt, INV, PLANE_THRESH, MAX_D2, t, cfg)
    assert torch.equal(new.t_mat, old.t_mat)
    assert int(new.iters) == int(old.iters) > 1 and bool(new.converged) == bool(old.converged)
    assert int(new.num_valid) == int(old.num_valid)
    assert torch.equal(new.total_res, old.total_res.to(torch.float32))


# ------------------------- (c) the kernel's lookup and selection order, in NumPy
def cover_slots(fpwin, v, num_probes):
    """`cover_slots`: the 8 blocks ((v - 1) >> 1) + {0, 1}^3 in _COVER
    order, each window's first 8 probes read before any compare, probes
    8-15 only where none matched and num_probes > 8; -1 where no probe
    below num_probes matches."""
    cap = fpwin.shape[0]
    b0 = (np.asarray(v, np.int32) - np.int32(1)) >> np.int32(1)  # arithmetic: floors negatives
    keys = [_base_and_key(b0 + np.int32(off), cap) for off in jbm._COVER]
    slot = [-1] * 8
    for start in (0, 8):
        if start >= num_probes:
            break
        windows = [fpwin[b, start:start + 8].copy() for b, _ in keys]
        for i, ((b, key), w) in enumerate(zip(keys, windows)):
            hits = [k for k in range(8) if start + k < num_probes and int(w[k]) == key]
            if slot[i] < 0 and hits:
                slot[i] = (b + start + hits[0]) & (cap - 1)
    return slot


def cover_nearest5(tab, slot, v, q):
    """`cover_nearest5`: the blocks in cover order, a missed one skipped;
    in each the local voxels in order, those outside the nearby26 stencil
    skipped (window coordinate 2 b + l more than 1 from 2 - (v & 1) on an
    axis); each voxel's bucket slots in order, d2 = ((dx dx + dy dy) + dz
    dz) in float32, offered to the five (insert5: before the first entry it
    is strictly below). Returns (d2 [5], points [5, 3]), +inf and 0 past
    the points found."""
    s = tab.shape[1] // 24
    plane = 8 * s
    qw = 2 - (np.asarray(v) & 1)
    d = [np.float32(np.inf)] * 5
    c = [np.zeros(3, np.float32) for _ in range(5)]
    for b, off in enumerate(jbm._COVER):
        if slot[b] < 0:
            continue
        row = tab[slot[b]]
        for l_ in range(8):
            w = 2 * np.asarray(off) + np.array([l_ >> 2, (l_ >> 1) & 1, l_ & 1])
            if np.abs(w - qw).max() > 1:
                continue
            for k in range(s):
                p = np.array([row[a * plane + l_ * s + k] for a in range(3)], np.float32)
                with np.errstate(over="ignore", invalid="ignore"):
                    e = p - q
                    cd = np.float32(np.float32(e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])
                if not cd < d[4]:
                    continue
                at = next(i for i in range(5) if cd < d[i])
                d.insert(at, cd)
                c.insert(at, p)
                d, c = d[:5], c[:5]
    return np.array(d, np.float32), np.stack(c)


def mirror_knn(m, queries, num_probes=8):
    """The kernel's lookup of each query: (d2 [N, 5], points [N, 5, 3])."""
    fpwin, tab = m.fpwin.numpy(), m.tab.numpy()
    vox = np.floor(queries * np.float32(INV)).astype(np.int32)  # ops/voxel.py voxel_coords
    out = [cover_nearest5(tab, cover_slots(fpwin, v, num_probes), v, q)
           for v, q in zip(vox, queries)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def lookup_case(name):
    """(port map, JAX map, queries [N, 3] f32, num_probes)."""
    rng = np.random.default_rng(7)
    probes = 8
    if name == "scene":
        world, src, _ = near_scene(1)
        tgt, queries = world, src[::3]
    elif name == "duplicate points":  # every point twice, and four times: tied d2
        base = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
        tgt = np.concatenate([base, base, base[:100], base[:100]])
        queries = base[::4] + rng.normal(0, 0.2, (100, 3)).astype(np.float32)
    elif name == "negative coordinates":
        tgt = rng.uniform(-6, -0.5, (1500, 3)).astype(np.float32)
        queries = rng.uniform(-6.5, -0.2, (300, 3)).astype(np.float32)
    elif name == "missed blocks":  # a sparse map: most cover blocks are not in it
        tgt = rng.uniform(-20, 20, (60, 3)).astype(np.float32)
        queries = np.concatenate([tgt[:40] + rng.normal(0, 0.8, (40, 3)).astype(np.float32),
                                  rng.uniform(-20, 20, (60, 3)).astype(np.float32)])
    else:  # a full probe window: 16 block slots, every one taken
        tgt = rng.uniform(0, 8, (600, 3)).astype(np.float32)
        queries = rng.uniform(-1, 9, (200, 3)).astype(np.float32)
        probes = 16 if name == "full probe window, 16 probes" else 8
    cap = 32 if name.startswith("full probe window") else MAP_CAP
    tgt_p, tmask = pad(tgt, len(tgt) + 8)
    mj = jbm.build(cap, BUCKET, jnp.asarray(tgt_p), jnp.asarray(tmask), INV, num_probes=probes)
    mt = tbm.build(cap, BUCKET, torch.from_numpy(tgt_p), torch.from_numpy(tmask), INV,
                   num_probes=probes)
    np.testing.assert_array_equal(mt.tab.numpy(), np.asarray(mj.tab))
    return mt, mj, queries.astype(np.float32), probes


LOOKUP_CASES = ["scene", "duplicate points", "negative coordinates", "missed blocks",
                "full probe window", "full probe window, 16 probes"]


@pytest.mark.parametrize("name", LOOKUP_CASES)
def test_the_kernel_lookup_mirror_equals_query_knn(name):
    """The mirror's 5 nearest against block_map.query_knn(k=5) of the port
    (its plain select) and of the JAX package (lax.top_k, ties to the lower
    lane): the same squared distances and the same points in the same
    order, +inf and 0 past the points found. Each case holds what it
    names: tied distances, negative voxels (the arithmetic >>), queries
    whose cover misses blocks, a table whose every probe window is full."""
    mt, mj, queries, probes = lookup_case(name)
    d2, pts = mirror_knn(mt, queries, probes)
    nbrs, kd2, _ = tbm.query_knn(mt, torch.from_numpy(queries), INV, k=5, num_probes=probes)
    np.testing.assert_array_equal(kd2.numpy(), d2)
    np.testing.assert_array_equal(nbrs.numpy(), pts)
    # XLA's d2 may part from the separately rounded ops by an ulp
    nbrs, kd2, _ = jbm.query_knn(mj, jnp.asarray(queries), INV, k=5, num_probes=probes)
    np.testing.assert_allclose(np.asarray(kd2), d2, rtol=2.5e-7, atol=0)
    np.testing.assert_array_equal(np.asarray(nbrs), pts)
    fpwin = mt.fpwin.numpy()
    found = np.isfinite(d2[:, 0])
    assert found.sum() > 10
    if name == "duplicate points":
        assert (d2[:, 0] == d2[:, 1]).sum() > 50
    elif name == "negative coordinates":
        assert (np.floor(queries) < -1).all(1).sum() > 100
    elif name == "missed blocks":
        slots = np.array([cover_slots(fpwin, v, 8) for v in np.floor(queries).astype(np.int32)])
        assert (slots < 0).sum() > 300 and (~found).sum() > 20
    elif name.startswith("full probe window"):
        assert (fpwin != 0).all() and fpwin.shape[0] == 16


# -------------------------------------------------- (d) the kernel's source
def cu_text() -> str:
    return (CSRC / "gn_loop.cu").read_text()


def test_signature_and_enums_match_the_kernel_source():
    text = cu_text()
    params = re.search(r'extern "C" int plane_map_gn_launch\(([^)]*)\)', text).group(1)
    names = [q.split()[-1].lstrip("*") for q in params.split(",")]
    assert names == ["src", "src_mask", "fpwin", "tab", "carry", "n", "capacity", "num_probes",
                     "bucket", "max_iters", "max_total", "min_valid", "use_stall", "rot_eps",
                     "pos_eps", "stall_eps", "inv", "max_d2", "plane_thresh", "stream"]
    kinds = ["p" if "*" in q else q.split()[0] for q in params.split(",")]
    ctypes_of = {"p": cuda_build._P, "int": cuda_build._I, "float": cuda_build._F}
    sig = cuda_build.SIGNATURES["gn_loop"]["plane_map_gn_launch"]
    assert sig == ([ctypes_of[k] for k in kinds], cuda_build._I)
    assert "const long long* fpwin" in params and "const float* tab" in params
    assert not re.search(r"corr_every|skip_dist|radius|stencil", params)
    # the wrapper passes the loop's scalars in the entry point's order
    assert gn_loop._loop_args(gn_cfgs()[1], schedule=False) == (20, 20, 10, 1, 1e-4, 1e-4, 1e-4)
    enum = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bG_([A-Z_]+) = (\d+)", text)}
    assert enum["PLANE_MAP"] == gn_loop.CLUSTER_KIND["plane_map_gn_rounds"] == 4
    upd = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bU_([A-Z_]+) = (\d+)", text)}
    assert "cluster_loop<L_SIZE, U_LOAM, true>" in text.split("plane_map_gn_kernel(")[1]
    assert upd["LOAM"] == gn_loop.UPDATE_LOAM
    assert int(re.search(r"kCoverBlocks = (\d+);", text).group(1)) == len(tbm._COVER) == 8
    assert gn_loop.plane_map_gn_rounds in gn_loop.KERNELS
    assert gn.ROUND_DRIVERS["plane_map_gn_rounds"] is gn.run_gn_plane_map


# ---------------------------------------- (e) the loop closure's one round
def test_the_loop_closure_refines_in_one_round(monkeypatch):
    """verify_candidate on the drifted room (the JAX comparison is
    test_torch_backend.py::test_verify_candidate_matches_jax) runs its
    refine as one run_gn_plane_map round, one read, and never calls
    run_gn or run_gn_corr."""
    def host_loop(*a, **kw):
        raise AssertionError("the verification ran the host loop")

    monkeypatch.setattr(gn, "run_gn", host_loop)
    monkeypatch.setattr(gn, "run_gn_corr", host_loop)
    rounds = Rounds(monkeypatch)
    refines = gn.run_gn_plane_map.rounds
    world, local, true_pose, poses = drifted_room()
    frames = [TKeyFrame(0, 0.0, np.eye(4), world), TKeyFrame(1, 1.0, true_pose, local)]
    res = tlc.verify_candidate(frames, poses, 1, 0, tlc.LoopClosureConfig(**VERIFY_CFG),
                               device="cpu")
    assert res is not None
    assert gn.run_gn_plane_map.rounds - refines == rounds.calls == 1
    assert rounds.reads == 1 + len(VERIFY_CFG["ndt_resolutions"])  # NDT stages read once each


# ------------------------------------------------ (f) refusals and dispatch
def small_inputs(device=None):
    world, src, t0 = near_scene(4)
    tgt, tmask = pad(world, 640)
    src, mask = pad(src, 640)
    m = tbm.build(1024, BUCKET, torch.from_numpy(tgt), torch.from_numpy(tmask), INV)
    carry = gn_loop.init_carry(torch.from_numpy(t0))
    s, msk = torch.from_numpy(src), torch.from_numpy(mask)
    if device is not None:
        m = tbm.BlockMap(*(t.to(device) for t in m))
        s, msk, carry = s.to(device), msk.to(device), carry.to(device)
    return carry, s, msk, m


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU inputs run plane_map_gn_rounds_plain bit for bit, to DONE in one
    call, and build, load and count nothing."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel was built for CPU tensors")

    monkeypatch.setattr(cuda_build, "library", no_build)
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    before = [fn.launches for fn in gn_loop.KERNELS]
    carry, src, mask, m = small_inputs()
    other = carry.clone()
    cfg = gn_cfgs()[1]
    sa = gn_loop.plane_map_gn_rounds(carry, src, mask, m, INV, PLANE_THRESH, MAX_D2, None, cfg)
    sb = gn_loop.plane_map_gn_rounds_plain(other, src, mask, m, INV, PLANE_THRESH, MAX_D2, None,
                                           cfg)
    assert torch.equal(carry, other) and int(sa) == int(sb) == gn_loop.DONE
    assert int(carry[gn_loop.OFFSET["gathers"]]) == int(carry[gn_loop.OFFSET["it"]]) > 1
    assert [fn.launches for fn in gn_loop.KERNELS] == before


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """The settings the kernel does not serve raise on every device; off
    the CPU the wrapper checks its inputs and never computes a result
    itself: a float64 source, a non-bool mask, int32 fingerprints, a table
    of another width, a non-contiguous input and inputs that pass the
    checks but lie off a CUDA device all raise."""
    carry, src, mask, m = small_inputs()
    cfg = gn_cfgs()[1]

    def call(carry=carry, src=src, mask=mask, m=m, cfg=cfg, **kw):
        return gn_loop.plane_map_gn_rounds(carry, src, mask, m, INV, PLANE_THRESH, MAX_D2, None,
                                           cfg, **kw)

    for bad in (cfg._replace(corr_every=10), cfg._replace(skip_regather_dist=0.2)):
        with pytest.raises(ValueError, match="plane_map_gn_rounds: .*corr_every 1"):
            call(cfg=bad)
    with pytest.raises(ValueError, match="nearby26"):
        call(stencil="nearby18")
    with pytest.raises(ValueError, match="num_probes"):
        call(num_probes=17)
    with pytest.raises(ValueError, match="no power of two"):
        call(m=m._replace(fpwin=m.fpwin[:24].contiguous()))
    with pytest.raises(ValueError, match="LOAM update"):
        gn.run_gn_plane_map(src, mask, m, INV, PLANE_THRESH, MAX_D2, torch.eye(4),
                            cfg._replace(update="ndt"))
    carry, src, mask, m = small_inputs("meta")
    with pytest.raises(TypeError, match="float32 src"):
        call(carry, src=src.double(), mask=mask, m=m)
    with pytest.raises(TypeError, match="bool src_mask"):
        call(carry, src=src, mask=mask.to(torch.uint8), m=m)
    with pytest.raises(TypeError, match="int64 fpwin"):
        call(carry, src=src, mask=mask, m=m._replace(fpwin=m.fpwin.to(torch.int32)))
    with pytest.raises(ValueError, match="tab of shape"):
        call(carry, src=src, mask=mask, m=m._replace(tab=m.tab[:-1].contiguous()))
    with pytest.raises(TypeError, match="int32 carry"):
        call(carry.float(), src=src, mask=mask, m=m)
    with pytest.raises(ValueError, match="contiguous"):
        call(carry, src=src.T.contiguous().T, mask=mask, m=m)
    with pytest.raises(ValueError, match="CUDA"):
        call(carry, src=src, mask=mask, m=m)
    with pytest.raises(ValueError, match="CUDA"):  # CPU inputs: the wrapper's plain route
        gn_loop._checked_refine_inputs(*small_inputs())
