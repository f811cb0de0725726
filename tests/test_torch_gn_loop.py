"""The ICP Gauss-Newton loop over cached candidates (ops/gn_loop.py,
registration/gn.py::run_gn_icp_cand) on the CPU, where the wrapper runs the
plain version: the round driver against the JAX `run_gn_corr` with
`point_to_point_hg_cand`, IcpMatcher.match against the JAX matcher with one
host read a gather round, the carry layout against csrc/gn_loop.cu, and the
dispatch by device.

Tolerances: (a) the same gathers, iterations and `converged` and an equal
`num_valid` (integer decisions from the same f32 arithmetic), the pose
within 1e-5 m and 1e-5 rad (`chord_angle`) and `total_res` within 1e-5
relative (f32 sums over 600 rows in another order); (b) as
tests/test_torch_registration.py::test_icp_match_matches_jax holds one
match (1e-3 m, 1e-3 rad, the same `converged` and gathers, the same map).
The layout checks are exact."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.lie import se3_exp
from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.registration import gn as jgn
from funny_lidar_slam_tpu.registration import matchers as jm
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.lie import chord_angle
from funny_lidar_slam_torch.ops import cuda_build, gn_loop
from funny_lidar_slam_torch.registration import gn
from funny_lidar_slam_torch.registration import matchers as tm

from test_torch_registration import cloud

torch.set_num_threads(1)

CSRC = Path(gn_loop.__file__).resolve().parents[1] / "csrc"
MAX_D2 = 1.0


def cand_scene(seed, n=600, m=16, valid_rows=None):
    """A fixed JAX CandSet: source points on a floor and two walls, their
    world points at a true pose, M candidates a row scattered around each
    (one within 2 cm), a fifth of the lanes and a few rows invalid; and a
    start pose 0.25 m and ~0.03 rad off the truth. `valid_rows` keeps only
    that many valid rows (a starved set)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-8.0, 8.0, (n, 2))
    k = n // 3
    src = np.concatenate([np.stack([a[:k, 0], a[:k, 1], np.full(k, -1.5)], 1),
                          np.stack([a[k:2 * k, 0], np.full(k, 6.0), a[k:2 * k, 1] / 4], 1),
                          np.stack([np.full(n - 2 * k, 7.0), a[2 * k:, 0], a[2 * k:, 1] / 4],
                                   1)]).astype(np.float32)
    t_true = np.asarray(se3_exp(jnp.asarray([2.0, 1.0, 0.2, 0.02, -0.01, 0.3], jnp.float32)))
    world = src @ t_true[:3, :3].T + t_true[:3, 3]
    off = rng.normal(0.0, 0.25, (n, m, 3))
    off[:, 0] *= 0.08
    off = np.take_along_axis(off, rng.permuted(np.tile(np.arange(m), (n, 1)), axis=1)[..., None],
                             axis=1)
    cand = (world[:, None] + off).astype(np.float32)
    valid = rng.random((n, m)) > 0.2
    valid[rng.choice(n, n // 20, replace=False)] = False
    if valid_rows is not None:
        valid[rng.permutation(n)[valid_rows:]] = False
    cand = np.where(valid[..., None], cand, 0.0).astype(np.float32)
    pert = np.asarray(se3_exp(jnp.asarray([0.15, -0.15, 0.12, 0.01, -0.01, 0.025],
                                          jnp.float32)))
    t0 = (t_true @ pert).astype(np.float32)
    cs = jres.CandSet(px=jnp.asarray(cand[..., 0]), py=jnp.asarray(cand[..., 1]),
                      pz=jnp.asarray(cand[..., 2]), valid=jnp.asarray(valid),
                      src=jnp.asarray(src), src_mask=jnp.asarray(valid.any(1)))
    radius = np.float32(np.sqrt((src ** 2).sum(1).max()))
    return cs, t0, radius


def gn_cfgs(corr_every, skip, max_iters, stall):
    kw = dict(max_iters=max_iters, rotation_eps=0.05, position_eps=0.01, update="icp",
              use_stall_check=stall, corr_every=corr_every, skip_regather_dist=skip)
    return jgn.GNConfig(**kw), gn.GNConfig(**kw)


def run_jax(cs, t0, radius, cfg):
    """JAX run_gn_corr with its loop run eagerly (`disable_jit`), so the
    linearizations can be counted: (result, iterations)."""
    calls = [0]

    def hg_fn(t, c):
        calls[0] += 1
        return jres.point_to_point_hg_cand(t, c, MAX_D2)

    with jax.disable_jit():
        res = jgn.run_gn_corr(lambda t: cs, hg_fn, jnp.asarray(t0), cfg,
                              regather_radius=jnp.asarray(radius))
    return res, calls[0]


class Rounds:
    """Counts the driver's rounds, its host reads and each call's carry."""

    def __init__(self, monkeypatch):
        self.carries, self.reads = [], 0
        rounds, read = gn.icp_gn_rounds, gn._host_read

        def counted_rounds(carry, *a):
            self.carries.append(carry)
            return rounds(carry, *a)

        def counted_read(flags):
            self.reads += 1
            return read(flags)

        monkeypatch.setattr(gn, "icp_gn_rounds", counted_rounds)
        monkeypatch.setattr(gn, "_host_read", counted_read)

    def it(self) -> int:
        return int(self.carries[-1][gn_loop.OFFSET["it"]])


def assert_same_result(rt, rj, rounds, its_j):
    assert int(rt.iters) == int(rj.iters) == len(rounds.carries) == rounds.reads
    assert rounds.it() == its_j
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.num_valid) == int(rj.num_valid)
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.abs(pt[:3, 3] - pj[:3, 3]).max() < 1e-5
    assert float(chord_angle(pt, pj)) < 1e-5
    assert float(rt.total_res) == pytest.approx(float(rj.total_res), rel=1e-5)


# ------------------------------------------------- (a) the driver against JAX
# corr_every, skip, max_iters and the stall test on the default scene; then
# the shapes where the kernel's cluster split and its any-M path matter:
# fewer rows than one 256-row tile (all on the first rank), a row count
# that is a multiple neither of 16 nor of a tile, and M = 12
DRIVER_CASES = [pytest.param(c, s, i, st, 3, 600, 16, id=f"{st}-{i}-{s}-{c}")
                for st in (True, False) for i in (2, 30) for s in (0.0, 0.2) for c in (1, 10)]
DRIVER_CASES += [pytest.param(10, 0.2, 30, True, 8, n, m, id=name)
                 for name, n, m in (("n100", 100, 16), ("n1003", 1003, 16), ("m12", 600, 12))]


@pytest.mark.parametrize("corr_every, skip, max_iters, stall, seed, n, m", DRIVER_CASES)
def test_driver_matches_jax_run_gn_corr(corr_every, skip, max_iters, stall, seed, n, m,
                                        monkeypatch):
    """run_gn_icp_cand on a fixed candidate set (every gather returns it)
    against the JAX loop: gathers, iterations, converged, num_valid, pose
    and total_res; one round and one host read a gather."""
    cs, t0, radius = cand_scene(seed=seed, n=n, m=m)
    cfg_j, cfg_t = gn_cfgs(corr_every, skip, max_iters, stall)
    rj, its_j = run_jax(cs, t0, radius, cfg_j)
    rounds = Rounds(monkeypatch)
    cand = convert.cand_set(cs)
    rt, gate = gn.run_gn_icp_cand(lambda t: cand, torch.as_tensor(t0), cfg_t, MAX_D2,
                                  regather_radius=torch.tensor(radius))
    assert gate is None and cand.px.shape == (n, m)
    assert_same_result(rt, rj, rounds, its_j)
    if max_iters == 2 and corr_every == 1 and skip == 0.0:
        assert int(rt.iters) == 2 and not bool(rt.converged)  # the bound ends the loop


@pytest.mark.parametrize("stall", [True, False])
def test_driver_matches_jax_when_starved(stall, monkeypatch):
    """Six valid rows, fewer than min_valid: never converged; the stall
    test ends the loop, or without it the gather bound does."""
    cs, t0, radius = cand_scene(seed=4, valid_rows=6)
    cfg_j, cfg_t = gn_cfgs(10, 0.2, 30, stall)
    rj, its_j = run_jax(cs, t0, radius, cfg_j)
    rounds = Rounds(monkeypatch)
    cand = convert.cand_set(cs)
    rt, _ = gn.run_gn_icp_cand(lambda t: cand, torch.as_tensor(t0), cfg_t, MAX_D2,
                               regather_radius=torch.tensor(radius))
    assert int(rt.num_valid) == 6 and not bool(rt.converged)
    assert_same_result(rt, rj, rounds, its_j)


def test_driver_rejects_other_updates():
    cs, t0, _ = cand_scene(seed=5, n=60)
    with pytest.raises(ValueError, match="ICP update"):
        gn.run_gn_icp_cand(lambda t: convert.cand_set(cs), torch.as_tensor(t0),
                           gn.GNConfig(update="loam"), MAX_D2)


# ------------------------------------------- (b) IcpMatcher.match, real gathers
CAP = 2048
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192,
           map_capacity=8192, local_map_size=20, group_capacity=2048,
           map_layout="grid", grid_dims=(48, 48, 12))


@pytest.fixture(scope="module")
def scene():
    """A grid map seeded from one simulator scan at its true pose, and a
    later scan with a guess 0.1 m and ~0.01 rad off its true pose."""
    ds = simulate(SimConfig(duration=4.2, points_per_scan=CAP, seed=11))
    s0, s1 = ds.scans[0], ds.scans[12]
    jmat = jm.IcpMatcher(jm.IcpConfig(**CFG))
    state = jmat.add_first(jmat.create_state(), cloud(s0.points, jnp), s0.gt_pose)
    pert = np.asarray(se3_exp(jnp.asarray([0.08, -0.06, 0.03, 0.004, -0.003, 0.01],
                                          jnp.float32)))
    return jax.device_get(state), s1, (s1.gt_pose @ pert).astype(np.float32)


@pytest.mark.parametrize("schedule", [dict(corr_every=1, regather_skip_dist=0.0),
                                      dict(corr_every=10, regather_skip_dist=0.2),
                                      dict(corr_every=10, regather_skip_dist=0.2,
                                           is_localization_mode=True)])
def test_icp_match_one_read_a_round(scene, schedule, monkeypatch):
    """IcpMatcher.match through the driver against the JAX matcher: pose,
    converged, gathers and the map afterwards (the insertion gate read with
    the last status word); one kernel round and one host read a gather."""
    state, s1, t_init = scene
    cfg = dict(CFG, **schedule)
    sj, rj = jm.IcpMatcher(jm.IcpConfig(**cfg)).match(jax.tree.map(jnp.asarray, state),
                                                      cloud(s1.points, jnp), t_init)
    rounds = Rounds(monkeypatch)
    st, rt = tm.IcpMatcher(tm.IcpConfig(**cfg), device="cpu").match(
        convert.window_state(state), cloud(s1.points, np), t_init)
    assert bool(rt.converged) == bool(rj.converged) is True
    assert int(rt.iters) == int(rj.iters) == len(rounds.carries) == rounds.reads >= 1
    if schedule["corr_every"] == 1:
        assert rounds.reads > 1
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 1e-3
    assert float(chord_angle(pt, pj)) < 1e-3
    np.testing.assert_array_equal(st.m.bc.numpy(), np.asarray(sj.m.bc))
    np.testing.assert_array_equal(st.m.counts.numpy(), np.asarray(sj.m.counts))
    np.testing.assert_allclose(st.last_added.numpy(), np.asarray(sj.last_added), atol=1e-3)


# ------------------------------------------------------------- (c) the layout
def test_carry_layout_matches_the_kernel_source():
    text = (CSRC / "gn_loop.cu").read_text()
    enum = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bC_([A-Z_]+) = (\d+)", text)}
    assert enum == {**{f.upper(): o for f, o in gn_loop.OFFSET.items()},
                    "SIZE": gn_loop.CARRY_SIZE}
    status = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bS_([A-Z_]+) = (\d+)", text)}
    assert status == {"NEED_GATHER": gn_loop.NEED_GATHER, "DONE": gn_loop.DONE}
    sig = cuda_build.SIGNATURES["gn_loop"]["icp_gn_launch"][0]
    assert len(sig) == 7 + 7 + 5 + 1  # pointers, ints, floats, the stream


def test_result_views_share_the_carry():
    t0 = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    carry = gn_loop.init_carry(t0)
    res = gn_loop.result_views(carry)
    assert torch.equal(res.t_mat, t0) and res.t_mat.data_ptr() == carry.data_ptr()
    f = carry.view(torch.float32)
    assert torch.equal(f[16:32].view(4, 4), t0)
    assert float(f[gn_loop.OFFSET["last_rot"]]) == float(f[gn_loop.OFFSET["last_pos"]]) == 1e9
    carry[gn_loop.OFFSET["converged"]] = 1
    carry[gn_loop.OFFSET["gathers"]] = 3
    f[gn_loop.OFFSET["total_res"]] = 2.5
    assert res.converged.dtype == torch.bool and bool(res.converged)
    assert int(res.iters) == 3 and float(res.total_res) == 2.5


# ------------------------------------------------------------ (d) the dispatch
def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU inputs run icp_gn_rounds_plain bit for bit and build, load and
    count nothing."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel was built for CPU tensors")

    monkeypatch.setattr(cuda_build, "library", no_build)
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    before = gn_loop.icp_gn_rounds.launches
    cs, t0, radius = cand_scene(seed=6, n=120)
    cand, cfg = convert.cand_set(cs), gn_cfgs(10, 0.2, 30, False)[1]
    a, b = gn_loop.init_carry(torch.as_tensor(t0)), gn_loop.init_carry(torch.as_tensor(t0))
    sa = gn_loop.icp_gn_rounds(a, cand, torch.tensor(radius), cfg, MAX_D2)
    sb = gn_loop.icp_gn_rounds_plain(b, cand, torch.tensor(radius), cfg, MAX_D2)
    assert torch.equal(a, b) and int(sa) == int(sb) in (gn_loop.NEED_GATHER, gn_loop.DONE)
    assert gn_loop.icp_gn_rounds.launches == before


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """Off the CPU the wrapper checks its inputs and never computes a
    result itself: float64 or non-contiguous inputs raise, and inputs that
    pass the checks but lie off a CUDA device raise too."""
    cs, t0, radius = cand_scene(seed=7, n=64)
    cand = convert.cand_set(cs, device="meta")
    carry = torch.zeros(gn_loop.CARRY_SIZE, dtype=torch.int32, device="meta")
    r = torch.tensor(radius).to("meta")
    cfg = gn_cfgs(10, 0.2, 30, False)[1]
    with pytest.raises(TypeError, match="float32"):
        gn_loop.icp_gn_rounds(carry, cand._replace(px=cand.px.double()), r, cfg, MAX_D2)
    with pytest.raises(TypeError, match="int32"):
        gn_loop.icp_gn_rounds(carry.float(), cand, r, cfg, MAX_D2)
    with pytest.raises(ValueError, match="contiguous"):
        gn_loop.icp_gn_rounds(carry, cand._replace(src=cand.src.T.contiguous().T), r, cfg,
                              MAX_D2)
    with pytest.raises(ValueError, match="CUDA"):
        gn_loop.icp_gn_rounds(carry, cand, r, cfg, MAX_D2)
    with pytest.raises(ValueError, match="CUDA"):  # CPU inputs: the wrapper's plain route
        gn_loop._checked_inputs(torch.zeros(gn_loop.CARRY_SIZE, dtype=torch.int32),
                                convert.cand_set(cs), torch.tensor(radius))
