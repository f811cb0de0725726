"""The LOAM matchers' Gauss-Newton loops over cached candidates
(ops/gn_loop.py `plane_gn_rounds` / `loam_gn_rounds`, registration/gn.py
`run_gn_plane_cand` / `run_gn_loam_cand`) on the CPU, where the wrappers
run the plain versions: the round drivers against the JAX `run_gn_corr`
with `point_to_plane_hg_cand` and with LoamFull's merged linearization,
PointToPlaneMatcher.match (ivox and window) and LoamFullMatcher.match
against the JAX matchers with one host read a gather round, the update
enum against csrc/gn_loop.cu, and the dispatch by device.

Tolerances: (a) the same gathers, iterations and `converged` and an equal
`num_valid` (gate decisions on well-conditioned fits within 1.5 m of the
origin), the pose within 1e-4 m and 1e-4 rad (`chord_angle`) and
`total_res` within 5e-4 relative: the fitted plane normals differ in their
fourth digit between the packages (XLA accumulates A^T A with fused
multiply-adds, PyTorch rounds each product, and the adjugate amplifies the
last bit; see tests/test_torch_registration.py::
test_fit_plane_5nn_matches_jax), and test_surface_hg_cand_matches_jax
holds one linearization to 5e-4 for that reason (1e-3 at the cluster-split
shape N 1,003, where one row's fit is ill-conditioned: see DRIVER_CASES);
(b) as
tests/test_torch_registration.py::test_loam_match_matches_jax holds one
match: the pose within 1e-3 m and 1e-3 rad, the same `converged` and
gathers, `num_valid` within 2 %, and the same map-insertion decision. The
layout checks and the CPU dispatch are exact."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.lie import se3_exp
from funny_lidar_slam_tpu.registration import gn as jgn
from funny_lidar_slam_tpu.registration import residuals as jres
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.core.lie import chord_angle
from funny_lidar_slam_torch.ops import cuda_build, gn_loop
from funny_lidar_slam_torch.registration import gn
from funny_lidar_slam_torch.registration.residuals import CandSet

from test_torch_registration import (
    MATCHERS,
    assert_same_block_map,
    noisy_problem,
    surface_cands,
)

torch.set_num_threads(1)

CSRC = Path(gn_loop.__file__).resolve().parents[1] / "csrc"
PLANE_THRESH, LINE_RATIO, MAX_D2 = 0.1, 3.0, 1.0


def scene(n_planar=400, n_corner=200):
    """Fixed candidate sets (tests/test_torch_registration.py::surface_cands)
    around one true pose, and a start pose 5 cm and ~0.01 rad off it:
    (t0, planar set, corner set, radius)."""
    t_mat, planar = surface_cands(np.random.default_rng(41), n_planar, 16, "plane")
    _, corner = surface_cands(np.random.default_rng(42), n_corner, 16, "line")
    pert = np.asarray(se3_exp(jnp.asarray([0.04, -0.03, 0.02, 0.006, -0.004, 0.008],
                                          jnp.float32)))
    return (t_mat @ pert).astype(np.float32), planar, corner, np.float32(1.5)


def jax_set(c: CandSet):
    return jres.CandSet(*(jnp.asarray(x.numpy()) for x in c))


def gn_cfgs(corr_every, skip, max_iters, stall):
    kw = dict(max_iters=max_iters, rotation_eps=0.05, position_eps=0.01, update="loam",
              use_stall_check=stall, corr_every=corr_every, skip_regather_dist=skip)
    return jgn.GNConfig(**kw), gn.GNConfig(**kw)


def jax_hg(kind):
    if kind == "plane":
        return lambda t, c: jres.point_to_plane_hg_cand(t, c, PLANE_THRESH, MAX_D2)

    def loam(t, c):
        hg_c = jres.point_to_line_hg_cand(t, c[0], LINE_RATIO, MAX_D2)
        hg_p = jres.point_to_plane_hg_cand(t, c[1], PLANE_THRESH, MAX_D2)
        return jres.merge_hg(hg_c, hg_p)._replace(num_valid=hg_p.num_valid)
    return loam


def run_jax(kind, sets, t0, radius, cfg):
    """JAX run_gn_corr with its loop run eagerly (`disable_jit`), so the
    linearizations can be counted: (result, iterations)."""
    calls, hg = [0], jax_hg(kind)
    corr = jax_set(sets[0]) if kind == "plane" else tuple(jax_set(c) for c in sets)

    def hg_fn(t, c):
        calls[0] += 1
        return hg(t, c)

    with jax.disable_jit():
        res = jgn.run_gn_corr(lambda t: corr, hg_fn, jnp.asarray(t0), cfg,
                              regather_radius=jnp.asarray(radius))
    return res, calls[0]


def run_port(kind, sets, t0, radius, cfg):
    if kind == "plane":
        return gn.run_gn_plane_cand(lambda t: sets[0], torch.as_tensor(t0), cfg, PLANE_THRESH,
                                    MAX_D2, regather_radius=torch.tensor(radius))
    return gn.run_gn_loam_cand(lambda t: sets, torch.as_tensor(t0), cfg, LINE_RATIO,
                               PLANE_THRESH, MAX_D2, regather_radius=torch.tensor(radius))


class Rounds:
    """Counts the drivers' rounds (either LOAM kernel), their host reads and
    each call's carry."""

    def __init__(self, monkeypatch):
        self.carries, self.reads = [], 0
        read = gn._host_read
        for name in ("plane_gn_rounds", "loam_gn_rounds"):
            fn = getattr(gn, name)

            def counted(carry, *a, fn=fn):
                self.carries.append(carry)
                return fn(carry, *a)
            monkeypatch.setattr(gn, name, counted)

        def counted_read(flags):
            self.reads += 1
            return read(flags)

        monkeypatch.setattr(gn, "_host_read", counted_read)

    def it(self) -> int:
        return int(self.carries[-1][gn_loop.OFFSET["it"]])


def assert_same_result(rt, rj, rounds, its_j, res_rel=5e-4):
    assert int(rt.iters) == int(rj.iters) == len(rounds.carries) == rounds.reads
    assert rounds.it() == its_j
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.num_valid) == int(rj.num_valid)
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.abs(pt[:3, 3] - pj[:3, 3]).max() < 1e-4
    assert float(chord_angle(pt, pj)) < 1e-4
    assert float(rt.total_res) == pytest.approx(float(rj.total_res), rel=res_rel)


# ------------------------------------------------- (a) the drivers against JAX
# (kind, corr_every, skip, max_iters, stall, shape): shape None is scene()'s;
# else (n_planar, n_corner, total_res's relative tolerance) at the row counts
# where the CUDA kernel's split over the blocks of its cluster leaves blocks,
# threads or the last 256-row tile short. At N 1,003 one of the 586 valid
# rows (row 808) fits its plane on five neighbours whose A^T A has a
# condition of 2.0e4, so its f32 adjugate is decided by rounding in both
# packages: its residual is -8.54 mm in the JAX package, -16.63 mm in the
# port and -13.18 mm in float64, which moves total_res by 5.7e-4 relative;
# the counts and the pose are held as everywhere
DRIVER_CASES = [
    *((kind, corr_every, skip, max_iters, stall, None)
      for stall in (True, False) for max_iters in (2, 30) for skip in (0.0, 0.1)
      for corr_every in (1, 8, 10) for kind in ("plane", "loam")),
    ("plane", 8, 0.1, 30, True, (100, 0, 5e-4)),    # fewer rows than one block
    ("plane", 8, 0.1, 30, True, (1003, 0, 1e-3)),   # no multiple of 16 or of a tile
    ("loam", 8, 0.1, 30, True, (100, 300, 5e-4)),   # more corner than planar rows
    ("loam", 8, 0.1, 30, True, (40, 60, 5e-4)),     # both sets inside one tile
]


def driver_case_id(case):
    kind, corr_every, skip, max_iters, stall, shape = case
    if shape is None:
        return f"{stall}-{max_iters}-{skip}-{corr_every}-{kind}"
    return f"{kind}-N{shape[0]}-corner{shape[1]}"


@pytest.mark.parametrize("kind,corr_every,skip,max_iters,stall,shape", DRIVER_CASES,
                         ids=[driver_case_id(c) for c in DRIVER_CASES])
def test_driver_matches_jax_run_gn_corr(kind, corr_every, skip, max_iters, stall, shape,
                                        monkeypatch):
    """run_gn_plane_cand / run_gn_loam_cand on fixed candidate sets (every
    gather returns them) against the JAX loop: gathers, iterations,
    converged, num_valid (LoamFull: the planar count), pose and total_res;
    one round and one host read a gather."""
    n_planar, n_corner, res_rel = shape or (400, 200, 5e-4)
    t0, planar, corner, radius = scene(n_planar=n_planar, n_corner=n_corner)
    sets = (planar,) if kind == "plane" else (corner, planar)
    cfg_j, cfg_t = gn_cfgs(corr_every, skip, max_iters, stall)
    rj, its_j = run_jax(kind, sets, t0, radius, cfg_j)
    rounds = Rounds(monkeypatch)
    rt, gate = run_port(kind, sets, t0, radius, cfg_t)
    assert gate is None
    assert_same_result(rt, rj, rounds, its_j, res_rel)
    assert int(rt.num_valid) > min(50, n_planar // 3)  # the gates keep most clean rows
    if max_iters == 2 and corr_every == 1 and skip == 0.0:
        assert int(rt.iters) == 2  # the bound ends the loop


@pytest.mark.parametrize("kind", ["plane", "loam"])
@pytest.mark.parametrize("stall", [True, False])
def test_driver_matches_jax_when_starved(kind, stall, monkeypatch):
    """A starved set: min_valid (1,000) above the planar rows (400), so the
    loop never converges; the stall test ends it, or without it the gather
    bound does (LoamFull's line rows add to H but not to the count). Fewer
    rows instead leave the plane problem degenerate, where both packages'
    f32 fits wander apart over the bound's 240 iterations."""
    t0, planar, corner, radius = scene()
    sets = (planar,) if kind == "plane" else (corner, planar)
    cfg_j, cfg_t = (c._replace(min_valid=1000) for c in gn_cfgs(8, 0.1, 30, stall))
    rj, its_j = run_jax(kind, sets, t0, radius, cfg_j)
    rounds = Rounds(monkeypatch)
    rt, _ = run_port(kind, sets, t0, radius, cfg_t)
    assert 50 < int(rt.num_valid) < 1000 and not bool(rt.converged)
    assert_same_result(rt, rj, rounds, its_j)


def test_loam_with_no_corner_rows_is_the_plane_loop():
    """A corner set of N 0 beside the planar set: the LoamFull rounds give
    the point-to-plane rounds' carry bit for bit (the line rows add
    nothing)."""
    t0, planar, corner, radius = scene()
    empty = CandSet(*(x[:0] for x in corner))
    cfg = gn_cfgs(8, 0.1, 30, True)[1]
    a, b = gn_loop.init_carry(torch.as_tensor(t0)), gn_loop.init_carry(torch.as_tensor(t0))
    gn_loop.loam_gn_rounds(a, empty, planar, torch.tensor(radius), cfg, LINE_RATIO,
                           PLANE_THRESH, MAX_D2)
    gn_loop.plane_gn_rounds(b, planar, torch.tensor(radius), cfg, PLANE_THRESH, MAX_D2)
    assert torch.equal(a, b)


def test_every_lane_invalid_ends_at_the_bound():
    """No valid lane: H = 0 and g = 0, dx = 0 (the damped solve), num_valid
    0, never converged; the stall test ends the loop on its second exact
    iteration, as in the JAX loop."""
    t0, planar, _, radius = scene()
    dead = planar._replace(valid=torch.zeros_like(planar.valid))
    cfg_j, cfg_t = gn_cfgs(8, 0.1, 30, True)
    rj, its_j = run_jax("plane", (dead,), t0, radius, cfg_j)
    rt, _ = run_port("plane", (dead,), t0, radius, cfg_t)
    assert int(rt.num_valid) == int(rj.num_valid) == 0
    assert not bool(rt.converged) and not bool(rj.converged)
    assert int(rt.iters) == int(rj.iters)
    assert torch.equal(rt.t_mat, torch.as_tensor(t0))


@pytest.mark.parametrize("rows", [8, 400])
def test_a_call_is_held_step_by_step(rows):
    """chip_smoke.py's step-by-step gate (`stepwise_compare`: phases 20-22
    where a call's end parts from both plain runs, and phase 21's
    rank-deficient edge case), on the plain path, where the wrapper and its
    plain version are one: on `rows` rows spread over scene()'s planar set
    (8: fewer than 6 pass, so H is rank-deficient; 400: full rank), a
    one-iteration call (max_iters 1) runs one iteration, the chain of them
    from the carry ends on the whole call's pose bit for bit, and every step
    agrees with itself."""
    import chip_smoke

    t0, planar, _, radius = scene()
    few = chip_smoke.gn_rows(torch, planar, rows)
    hg = gn_loop.point_to_plane_hg_cand(torch.as_tensor(t0), few, PLANE_THRESH, MAX_D2)
    assert (0 < int(hg.num_valid) < 6) == (rows == 8)
    args = (gn_loop.init_carry(torch.as_tensor(t0)), few, torch.tensor(radius),
            gn_cfgs(10, 0.0, 2, False)[1], PLANE_THRESH, MAX_D2)
    one = args[0].clone()
    gn_loop.plane_gn_rounds(one, *chip_smoke.gn_with_cfg(args, max_iters=1)[1:])
    assert int(one[gn_loop.OFFSET["it"]]) == 1
    r = chip_smoke.gn_compare(torch, args, "plane_gn_rounds")
    assert r["iterations"] > 1
    assert chip_smoke.stepwise_compare(torch, args, r, "plane_gn_rounds") == {
        "nv_rel": 0.0, "res_rel": 0.0, "dp": 0.0, "da": 0.0, "steps": r["iterations"],
        "chain_bit_equal": True, "held": True}


@pytest.mark.parametrize("corr_every,skip", [(10, 0.1), (8, 0.2)])
def test_a_starved_call_is_held_step_by_step_with_its_stall_test(corr_every, skip):
    """chip_smoke.py's gate for phase 21's starved edge cases
    (`LOAM_STARVED`, `starved_compare`: min_valid above the rows, so only
    the stall test ends the call), on the plain path, where the wrapper and its plain version
    are one, under the LOAM matchers' trust-region skips (a call's
    iterations inside the region of its first pose are exact, and only
    they test for a stall): the chain of one-iteration calls that carries
    the step norms of its last exact step ends on the whole call's pose,
    stalls first on the call's last iteration, and every step and stall
    decision agrees with itself."""
    import chip_smoke

    t0, planar, _, radius = scene()
    args = (gn_loop.init_carry(torch.as_tensor(t0)), planar, torch.tensor(radius),
            gn_cfgs(corr_every, skip, 30, True)[1]._replace(min_valid=planar.px.shape[0] + 1),
            PLANE_THRESH, MAX_D2)
    r = chip_smoke.gn_compare(torch, args, "plane_gn_rounds")
    assert r["iterations"] > 1 and r["carry_k"][4] == 1 and r["carry_k"][5] == 0  # a stall
    assert chip_smoke.starved_compare(torch, args, r, "plane_gn_rounds") == {
        "nv_rel": 0.0, "res_rel": 0.0, "dp": 0.0, "da": 0.0, "steps": r["iterations"],
        "chain_bit_equal": True, "held": True, "norm_diff": [0.0, 0.0], "decisions_parted": 0,
        "decisions_off_band": 0, "first_stall": r["iterations"], "ended_on_stall": True,
        "stall_end_held": True, "status_held": True}
    assert set(chip_smoke.LOAM_STARVED) == {"plane_gn_rounds starved", "loam_gn_rounds starved"}


@pytest.mark.parametrize("factor", [10.0, 0.01])
def test_the_starved_gate_sees_a_wrong_stall_test(factor, monkeypatch):
    """`starved_compare` against a kernel whose stall test uses `factor`
    times stall_eps (the plain version itself, so every step's pose and
    norms still agree bit for bit): the call still ends on its own stall
    test with the plain version's status, and its chain of one-iteration
    calls still stalls first on its last iteration, but a stall decision
    parts from the plain step's off the test's edge, so the gate fails.
    On scene() the stall test's differences fall from ~3e-4 to ~2e-6 to
    ~3e-8 on the last three steps, so 10x stalls one step early and 0.01x
    one step late."""
    import chip_smoke

    plain = gn_loop.plane_gn_rounds_plain

    def wrong(carry, cand, radius, cfg, *rest):
        return plain(carry, cand, radius, cfg._replace(stall_eps=cfg.stall_eps * factor), *rest)

    monkeypatch.setattr(gn_loop, "plane_gn_rounds", wrong)
    t0, planar, _, radius = scene()
    args = (gn_loop.init_carry(torch.as_tensor(t0)), planar, torch.tensor(radius),
            gn_cfgs(10, 0.1, 30, True)[1]._replace(min_valid=planar.px.shape[0] + 1),
            PLANE_THRESH, MAX_D2)
    r = chip_smoke.gn_compare(torch, args, "plane_gn_rounds")
    assert r["carry_k"][4] == 1 and r["carry_k"][5] == 0  # the wrong test ended the call
    out = chip_smoke.starved_compare(torch, args, r, "plane_gn_rounds")
    assert out["status_held"] and out["stall_end_held"] and out["chain_bit_equal"]
    assert out["norm_diff"] == [0.0, 0.0] and out["decisions_off_band"] >= 1
    assert not out["held"]


@pytest.mark.parametrize("kind", ["plane", "loam"])
def test_driver_rejects_other_updates(kind):
    t0, planar, corner, radius = scene(n_planar=40, n_corner=20)
    with pytest.raises(ValueError, match="LOAM update"):
        run_port(kind, (planar,) if kind == "plane" else (corner, planar), t0, radius,
                 gn.GNConfig(update="icp"))


# ------------------------------- (b) the matchers through the drivers
# kind -> (the near room, pose m, pose rad, num_valid share, the same map)
MATCH_TOL = {"window": (True, 1e-3, 1e-3, 0.02, True),
             "loam_full": (True, 1e-3, 1e-3, 0.02, True),
             "ivox": (False, 2e-3, 1e-3, 0.3, False)}


@pytest.mark.parametrize("kind", ["ivox", "window", "loam_full"])
@pytest.mark.parametrize("localization", [False, True])
def test_loam_match_one_read_a_round(kind, localization, monkeypatch):
    """PointToPlaneMatcher (ivox, window) and LoamFullMatcher .match against
    the JAX matchers, from the same map state and guess: converged,
    gathers, pose and num_valid; in mapping mode the same insertion
    decision (the gate read with the last status word) and the same map, in
    localization mode the state untouched; one kernel round and one host
    read a gather, and no other read of `_host_read`. Window and LoamFull
    on the near room, held as test_loam_match_matches_jax holds them; ivox
    on the 8 m room, held as test_ivox_match_matches_jax holds it (its
    plane fits span metres at a spread of decimetres, so the f32 adjugate
    decides many gates by rounding in both packages, and the maps are
    compared by the decision and the pose inserted at)."""
    near, tol_m, tol_rad, tol_nv, same_map = MATCH_TOL[kind]
    jcls, tcls, jcfg, tcfg, cfg = MATCHERS[kind]
    cfg = dict(cfg, is_localization_mode=localization)
    jmat, tmat = jcls(jcfg(**cfg)), tcls(tcfg(**cfg), device="cpu")
    world_j, src_j, t_true = noisy_problem(kind, jnp, near=near)
    _, src_t, _ = noisy_problem(kind, np, near=near)
    sj = jmat.add_first(jmat.create_state(), *world_j, jnp.eye(4))
    st = convert.matcher_state(jax.device_get(sj))
    sj2, rj = jmat.match(sj, *src_j, jnp.eye(4))
    rounds = Rounds(monkeypatch)
    st2, rt = tmat.match(st, *src_t, np.eye(4, dtype=np.float32))
    assert bool(rt.converged) == bool(rj.converged) is True
    assert int(rt.iters) == int(rj.iters) == len(rounds.carries) == rounds.reads >= 1
    pj, pt = np.asarray(rj.t_mat, np.float64), rt.t_mat.numpy().astype(np.float64)
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < tol_m
    assert float(chord_angle(pt, pj)) < tol_rad
    assert abs(int(rt.num_valid) - int(rj.num_valid)) <= tol_nv * int(rj.num_valid)
    if localization:
        assert st2 is st
        return
    (mt_, lt), (mj_, lj), (_, l0) = (states(x) for x in (st2, sj2, st))
    for a, b in zip(mt_, mj_):
        if same_map:
            assert_same_block_map(a, b)
    for a, b, c in zip(lt, lj, l0):  # the same insertion decision
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol_m)
        assert torch.equal(a, c) == np.array_equal(np.asarray(b), c.numpy())


def states(s):
    """[(map, last_added)] of a LOAM matcher state of either package."""
    if hasattr(s, "corner"):
        return [(s.corner.m, s.planar.m), (s.corner.last_added, s.planar.last_added)]
    w = s.w if hasattr(s, "w") else s
    return [(w.m,), (w.last_added,)]


# ------------------------------------------------------------- (c) the layout
def test_update_enum_and_signatures_match_the_kernel_source():
    text = (CSRC / "gn_loop.cu").read_text()
    enum = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bU_([A-Z_]+) = (\d+)", text)}
    assert enum == {"ICP": gn_loop.UPDATE_ICP, "LOAM": gn_loop.UPDATE_LOAM,
                    "NDT": gn_loop.UPDATE_NDT}
    carry = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bC_([A-Z_]+) = (\d+)", text)}
    assert carry == {**{f.upper(): o for f, o in gn_loop.OFFSET.items()},
                     "SIZE": gn_loop.CARRY_SIZE}
    kinds = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bG_([A-Z_]+) = (\d+)", text)}
    assert kinds == {k.removesuffix("_gn_rounds").upper(): v
                     for k, v in gn_loop.CLUSTER_KIND.items()}
    sigs = cuda_build.SIGNATURES["gn_loop"]
    for name, n in {"gn_cluster_blocks": 2, "gn_rank_rows": 3}.items():  # ints only
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
        assert [q.split()[0] for q in params.split(",")] == ["int"] * n
        assert len(sigs[name][0]) == n
    # pointers, ints, floats, the stream: the C entry points' parameter lists
    for name, counts in {"plane_gn_launch": (7, 7, 6), "loam_gn_launch": (12, 8, 7)}.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
        kinds = ["ptr" if "*" in q else q.split()[0] for q in params.split(",")]
        assert kinds.count("ptr") == counts[0] + 1 and kinds.count("int") == counts[1]
        assert kinds.count("float") == counts[2]
        assert len(sigs[name][0]) == sum(counts) + 1


# ------------------------------------------------------------ (d) the dispatch
def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU inputs run plane_gn_rounds_plain / loam_gn_rounds_plain bit for
    bit and build, load and count nothing."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel was built for CPU tensors")

    monkeypatch.setattr(cuda_build, "library", no_build)
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    before = [fn.launches for fn in gn_loop.KERNELS]
    t0, planar, corner, radius = scene(n_planar=120, n_corner=60)
    cfg, r = gn_cfgs(8, 0.1, 30, True)[1], torch.tensor(radius)
    for wrapper, plain, args in (
            (gn_loop.plane_gn_rounds, gn_loop.plane_gn_rounds_plain,
             (planar, r, cfg, PLANE_THRESH, MAX_D2)),
            (gn_loop.loam_gn_rounds, gn_loop.loam_gn_rounds_plain,
             (corner, planar, r, cfg, LINE_RATIO, PLANE_THRESH, MAX_D2))):
        a, b = gn_loop.init_carry(torch.as_tensor(t0)), gn_loop.init_carry(torch.as_tensor(t0))
        sa, sb = wrapper(a, *args), plain(b, *args)
        assert torch.equal(a, b) and int(sa) == int(sb) in (gn_loop.NEED_GATHER, gn_loop.DONE)
    assert [fn.launches for fn in gn_loop.KERNELS] == before


def meta(c: CandSet) -> CandSet:
    return CandSet(*(x.contiguous().to("meta") for x in c))


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """Off the CPU the wrappers check their inputs and never compute a
    result themselves: float64, non-contiguous, a float carry, sets of two
    different M, and inputs that pass the checks but lie off a CUDA device
    all raise."""
    t0, planar, corner, radius = scene(n_planar=64, n_corner=32)
    p, c = meta(planar), meta(corner)
    carry = torch.zeros(gn_loop.CARRY_SIZE, dtype=torch.int32, device="meta")
    r = torch.tensor(radius).to("meta")
    cfg = gn_cfgs(8, 0.1, 30, True)[1]

    def plane(carry=carry, p=p):
        return gn_loop.plane_gn_rounds(carry, p, r, cfg, PLANE_THRESH, MAX_D2)

    def loam(carry=carry, c=c, p=p):
        return gn_loop.loam_gn_rounds(carry, c, p, r, cfg, LINE_RATIO, PLANE_THRESH, MAX_D2)

    with pytest.raises(TypeError, match="plane_gn_rounds: .*float32"):
        plane(p=p._replace(px=p.px.double()))
    with pytest.raises(TypeError, match="loam_gn_rounds: .*float32 set 0 src"):
        loam(c=c._replace(src=c.src.double()))
    with pytest.raises(TypeError, match="int32"):
        loam(carry=carry.float())
    with pytest.raises(ValueError, match="contiguous"):
        plane(p=p._replace(src=p.src.T.contiguous().T))
    with pytest.raises(ValueError, match="one M"):
        loam(c=c._replace(**{f: getattr(c, f)[:, :12].contiguous()
                             for f in ("px", "py", "pz", "valid")}))
    with pytest.raises(ValueError, match="CUDA"):
        plane()
    with pytest.raises(ValueError, match="CUDA"):
        loam()
