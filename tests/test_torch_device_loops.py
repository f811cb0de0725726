"""The step's three device loops (ops/recurrences.py: preintegrate,
eskf_predict, tight_fuse) on the CPU: their plain versions against the JAX
package, the wrappers' packed layouts against the CUDA sources' offsets and
a Python mirror of them, the dispatch by device, and the frontend step's
calls of `preintegrate` by fusion method.

Tolerances: preintegration and ESKF in f32 as tests/test_torch_imu.py and
tests/test_torch_eskf.py hold them (1e-5 absolute on deltas, Jacobians and
states; 1e-4 of the largest covariance entry); the tight fusion as
tests/test_torch_frontend.py holds a step (2e-3 m and 2e-3 rad: an f32 LM
on each side whose accept decisions can part on rounding) and 1e-2 of the
largest information entry. The packing round trips are exact."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.core.state import ImuSegment as JSeg, NavState as JNav
from funny_lidar_slam_tpu.fusion import eskf as jeskf, tight as jtight
from funny_lidar_slam_tpu.imu import preintegration as jpre
from funny_lidar_slam_torch.core.lie import chord_angle
from funny_lidar_slam_torch.core.state import ImuSegment
from funny_lidar_slam_torch.fusion import eskf, tight
from funny_lidar_slam_torch.imu import preintegration as pi
from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.ops import cuda_build, recurrences as rec
from funny_lidar_slam_torch.pipeline import frontend as tfe
from funny_lidar_slam_torch.pipeline.system import SlamSystem, SystemConfig
from funny_lidar_slam_torch.registration import matchers as tm

from test_torch_eskf import GRAVITY, assert_eskf_close, eskf_states

torch.set_num_threads(1)

CSRC = Path(tfe.__file__).resolve().parents[1] / "csrc"
CAP, SEG = 2048, 16
CFG = dict(source_capacity=CAP, cloud_capacity=CAP, merged_capacity=8192,
           map_capacity=8192, local_map_size=20, group_capacity=2048,
           map_layout="grid", grid_dims=(48, 48, 12))


def segment(slots, seed=0):
    """A padded f32 segment: a masked tail, an interior masked sample and a
    repeated stamp (a zero-dt slot)."""
    rng = np.random.default_rng(seed)
    t = (5.0 + np.arange(slots) * 0.005).astype(np.float32)
    t[3] = t[2]
    mask = np.arange(slots) < slots - 3
    mask[slots // 2] = False
    return dict(t=t, gyro=rng.normal(0, 0.4, (slots, 3)).astype(np.float32),
                accel=(np.array([0.3, -0.2, 9.81]) + rng.normal(0, 0.3, (slots, 3))
                       ).astype(np.float32),
                quat=np.tile(np.array([1, 0, 0, 0], np.float32), (slots, 1)), mask=mask)


def tseg(d):
    return ImuSegment(**{k: torch.as_tensor(v) for k, v in d.items()})


def jseg(d):
    return JSeg(**{k: jnp.asarray(v) for k, v in d.items()})


BG = np.array([0.01, -0.02, 0.005], np.float32)
BA = np.array([0.05, 0.02, -0.03], np.float32)


@pytest.mark.parametrize("slots", [16, 32, 64])
def test_preintegrate_plain_matches_jax(slots):
    seg = segment(slots, seed=slots)
    pj = jpre.preintegrate(jseg(seg), jpre.PreintParams.from_std(0.01, 0.1, 1e-8),
                           jnp.asarray(BG), jnp.asarray(BA))
    pt = pi.preintegrate_plain(tseg(seg), pi.PreintParams.from_std(0.01, 0.1, 1e-8),
                               torch.as_tensor(BG), torch.as_tensor(BA))
    for f in jpre.PreintState._fields:
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        tol = 1e-4 * np.abs(b).max() if f == "cov" else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)
    assert abs(float(pt.dt) - 0.005 * (slots - 6)) < 1e-5  # the masked slots add nothing


def edge_segment(case):
    """(segment, the valid slots) of an edge case of the preintegration
    kernel: every sample masked, one valid slot, slots of dt <= 0 (a
    repeated and a decreasing stamp) between valid ones, 64 slots all
    valid."""
    slots = 64 if case == "all_valid_64" else 16
    seg = segment(slots, seed=200 + slots)
    seg["t"] = (5.0 + np.arange(slots) * 0.005).astype(np.float32)
    seg["mask"] = np.ones(slots, bool)
    if case == "all_masked":
        seg["mask"][:] = False
        return seg, 0
    if case == "one_valid_slot":
        seg["mask"][:] = False
        seg["mask"][5:7] = True
        return seg, 1
    if case == "nonpositive_dt":
        seg["t"][6] = seg["t"][5]  # dt = 0 in slot 5
        seg["t"][9] = seg["t"][8] - np.float32(0.002)  # dt < 0 in slot 8
        return seg, slots - 3
    return seg, slots - 1


def assert_preint_close(pt, pj):
    for f in jpre.PreintState._fields:
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        tol = 1e-4 * np.abs(b).max() if f == "cov" else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)


@pytest.mark.parametrize("case", ["all_masked", "one_valid_slot", "nonpositive_dt",
                                  "all_valid_64"])
def test_preintegrate_plain_matches_jax_at_the_edges(case):
    """The cases the kernel's slot staging must get right: no valid slot
    leaves the zero state exactly; the masked and dt <= 0 slots add nothing."""
    seg, valid = edge_segment(case)
    params_j = jpre.PreintParams.from_std(0.01, 0.1, 1e-8)
    params_t = pi.PreintParams.from_std(0.01, 0.1, 1e-8)
    pj = jpre.preintegrate(jseg(seg), params_j, jnp.asarray(BG), jnp.asarray(BA))
    pt = pi.preintegrate_plain(tseg(seg), params_t, torch.as_tensor(BG), torch.as_tensor(BA))
    assert_preint_close(pt, pj)
    t = seg["t"]
    ok = seg["mask"][1:] & seg["mask"][:-1] & (t[1:] > t[:-1])
    assert int(ok.sum()) == valid
    np.testing.assert_allclose(float(pt.dt), float((t[1:] - t[:-1])[ok].sum()), atol=1e-6)
    if valid == 0:
        zero = pi.PreintState.zero(torch.as_tensor(BG), torch.as_tensor(BA))
        assert_equal_trees(pt, zero)


def test_preintegrate_plain_matches_jax_chained():
    """has_init: a second segment integrated on the state of a first, as
    one segment of both."""
    first, _ = edge_segment("all_valid")
    second, _ = edge_segment("all_valid")
    second["t"] = (first["t"][-1] + 0.005 * (1 + np.arange(16))).astype(np.float32)
    params_j = jpre.PreintParams.from_std(0.01, 0.1, 1e-8)
    params_t = pi.PreintParams.from_std(0.01, 0.1, 1e-8)
    bg, ba = torch.as_tensor(BG), torch.as_tensor(BA)
    init_j = jpre.preintegrate(jseg(first), params_j, jnp.asarray(BG), jnp.asarray(BA))
    init_t = pi.preintegrate_plain(tseg(first), params_t, bg, ba)
    pj = jpre.preintegrate(jseg(second), params_j, jnp.asarray(BG), jnp.asarray(BA), init_j)
    pt = pi.preintegrate_plain(tseg(second), params_t, bg, ba, init_t)
    assert_preint_close(pt, pj)
    np.testing.assert_allclose(float(pt.dt), 0.005 * 30, atol=1e-5)


@pytest.mark.parametrize("slots", [16, 64])
def test_eskf_predict_plain_matches_jax(slots):
    seg = segment(slots, seed=100 + slots)
    js, ts = eskf_states(seed=slots)
    out_j = jeskf.predict(js, jseg(seg), jeskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4),
                          GRAVITY)
    out_t = eskf.predict_plain(ts, tseg(seg), eskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4),
                               GRAVITY)
    assert_eskf_close(out_t, out_j, 1e-5, 1e-4)


@pytest.mark.parametrize("case", ["all_masked", "one_valid_slot", "nonpositive_dt",
                                  "all_valid_64"])
def test_eskf_predict_plain_matches_jax_at_the_edges(case):
    """The kernel's edge cases, on preintegrate's segments: no valid slot
    leaves the state exactly; the masked and dt <= 0 slots move nothing."""
    seg, valid = edge_segment(case)
    js, ts = eskf_states(seed=300 + valid)
    out_j = jeskf.predict(js, jseg(seg), jeskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4),
                          GRAVITY)
    out_t = eskf.predict_plain(ts, tseg(seg), eskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4),
                               GRAVITY)
    assert_eskf_close(out_t, out_j, 1e-5, 1e-4)
    if valid == 0:
        for a, b in ((out_t.nav.r, ts.nav.r), (out_t.nav.v, ts.nav.v), (out_t.nav.p, ts.nav.p),
                     (out_t.cov, ts.cov)):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def fuse_calls():
    """The arguments of every `fuse` call of a short TightCouplingOptimization
    run of the port on the CPU (the states of real steps)."""
    calls, orig = [], tfe.tight_fuse

    def record(*args):
        calls.append(args)
        return orig(*args)

    tfe.tight_fuse = record
    try:
        ds = simulate(SimConfig(duration=4.0, points_per_scan=CAP, seed=3))
        slam = SlamSystem(SystemConfig(matcher_config=tm.IcpConfig(**CFG),
                                       frontend=tfe.FrontendConfig(), scan_capacity=CAP,
                                       imu_segment_capacity=SEG), device="cpu")
        slam.run_dataset(ds)
    finally:
        tfe.tight_fuse = orig
    assert len(calls) >= 8
    return calls


def jax_fuse(args):
    last, pre, pose, pred, g, cfg = args

    def nav(n):
        return JNav(**{k: jnp.asarray(v.numpy()) for k, v in n._asdict().items()})

    jpre_state = jpre.PreintState(**{k: jnp.asarray(v.numpy())
                                     for k, v in pre._asdict().items()})
    return jtight.fuse(nav(last), jpre_state, jnp.asarray(pose.numpy()), nav(pred),
                       jnp.asarray(np.asarray(g, np.float32)),
                       jtight.TightFusionConfig(*cfg))


def assert_fuse_close(nav_t, nav_j):
    p_t, p_j = nav_t.p.numpy(), np.asarray(nav_j.p)
    assert np.abs(p_t - p_j).max() < 2e-3
    assert float(chord_angle(nav_t.r, torch.as_tensor(np.array(nav_j.r)))) < 2e-3
    info_j = np.asarray(nav_j.info)
    np.testing.assert_allclose(nav_t.info.numpy(), info_j, rtol=0,
                               atol=1e-2 * np.abs(info_j).max())


def fuse_plain_trials(args) -> tuple:
    """(`fuse_plain(*args)`, the trial states of its LM iterations): each
    iteration applies its step once."""
    trials, orig = [], tight._apply_dx

    def record(s, dx):
        trials.append(orig(s, dx))
        return trials[-1]

    tight._apply_dx = record
    try:
        return tight.fuse_plain(*args), trials
    finally:
        tight._apply_dx = orig


@pytest.mark.parametrize("iterations", [12, 20])
def test_fuse_plain_matches_jax(fuse_calls, iterations):
    for k in (2, len(fuse_calls) // 2, len(fuse_calls) - 1):
        args = fuse_calls[k]
        args = args[:5] + (args[5]._replace(iterations=iterations),)
        nav_t, trials = fuse_plain_trials(args)
        assert 1 <= len(trials) <= iterations
        assert_fuse_close(nav_t, jax_fuse(args))


@pytest.mark.parametrize("iterations", [0, 1])
def test_fuse_plain_matches_jax_at_few_iterations(fuse_calls, iterations):
    """0 LM iterations: the posterior, marginalization and projection at the
    starting state alone (the kernel's tail); 1: one solve and trial."""
    for k in (2, len(fuse_calls) - 1):
        args = fuse_calls[k]
        args = args[:5] + (args[5]._replace(iterations=iterations),)
        nav_t, trials = fuse_plain_trials(args)
        assert len(trials) == iterations
        assert_fuse_close(nav_t, jax_fuse(args))
        if iterations == 0:  # the current state is the prediction, biases the last
            last, _, _, pred = args[:4]
            assert_equal_trees((nav_t.r, nav_t.v, nav_t.p, nav_t.bg, nav_t.ba),
                               (pred.r, pred.v, pred.p, last.bg, last.ba))


def lm_decisions(args) -> tuple:
    """(`fuse_plain(*args)`, the plain LM's (accept, stuck) decision of
    each trial), the decisions recomputed from the trial states it
    assembles (the same factor sums as its assembly) with its lambda
    schedule."""
    last, pre, pose, pred, g, cfg = args
    nav, trials = fuse_plain_trials(args)
    gt = torch.as_tensor(g, dtype=torch.float32)

    def cost(s):
        c = torch.zeros(())
        for err, _, lam in tight._all_factors(s, last, pre, pose[:3, :3], pose[:3, 3], gt,
                                              cfg):
            c = c + err @ (lam @ err)
        return c

    s0 = tight.FusionStates(r_i=last.r, v_i=last.v, p_i=last.p, bg_i=last.bg, ba_i=last.ba,
                            r_j=pred.r, v_j=pred.v, p_j=pred.p, bg_j=last.bg, ba_j=last.ba)
    cur, lam, out = cost(s0), torch.tensor(1e-4), []
    for s in trials:
        c = cost(s)
        accept = bool(c < cur)
        out.append((accept, not accept and bool(lam >= 1e2)))
        cur = c if accept else cur
        lam = torch.clamp(lam * 0.5, min=1e-6) if accept else torch.clamp(lam * 8.0, max=1e2)
    return nav, out


def test_fuse_plain_matches_jax_on_the_stuck_exit(fuse_calls):
    """A lidar std of 1e-15 against the IMU's: after a few accepted steps
    every trial is rejected until lambda reaches its ceiling, and the loop
    leaves by the stuck exit, before its iteration budget."""
    for k in (2, len(fuse_calls) - 1):
        args = fuse_calls[k]
        args = args[:5] + (args[5]._replace(iterations=20, lidar_rotation_std=1e-15,
                                            lidar_position_std=1e-15),)
        nav_t, decisions = lm_decisions(args)
        assert len(decisions) < 20
        assert decisions[-1] == (False, True)  # rejected at lambda = 1e2
        assert_fuse_close(nav_t, jax_fuse(args))


# ------------------------------------------------------------ the layouts
def enum_offsets(source: str, prefix: str) -> dict:
    """{name: offset} of the `prefix`-named enum entries of a CUDA source."""
    text = (CSRC / source).read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(rf"\b({prefix}[A-Z_]+) = (\d+)", text)}


def offsets(layout, start=0) -> list:
    out, o = [], start
    for _, shape in layout:
        out.append(o)
        o += int(np.prod(shape))
    return out + [o]


def test_layouts_match_the_kernel_sources():
    ps = enum_offsets("imu_scan.cu", "PS_")
    assert [ps[k] for k in ("PS_DR", "PS_DV", "PS_DP", "PS_COV", "PS_DR_DBG", "PS_DV_DBG",
                            "PS_DV_DBA", "PS_DP_DBG", "PS_DP_DBA", "PS_DT", "PS_SIZE")] \
        == offsets(rec.PREINT_STATE)
    eo = enum_offsets("imu_scan.cu", "EO_")
    assert [eo[k] for k in ("EO_R", "EO_V", "EO_P", "EO_COV", "EO_SIZE")] \
        == offsets(rec.ESKF_OUT)
    ei = enum_offsets("imu_scan.cu", "EI_")
    assert (ei["EI_COV"], ei["EI_GVAR"], ei["EI_SIZE"]) == (21, 246, 258)
    pre = enum_offsets("tight_fuse.cu", "P_")
    assert [pre[k] for k in ("P_DR", "P_DV", "P_DP", "P_COV", "P_DR_DBG", "P_DV_DBG",
                             "P_DV_DBA", "P_DP_DBG", "P_DP_DBA", "P_DT")] \
        == offsets(rec.PREINT_STATE)[:-1]
    assert (pre["P_BG"], pre["P_BA"]) == (142, 145)
    ti = enum_offsets("tight_fuse.cu", "I_")
    assert (ti["I_INFO"], ti["I_PRE"], ti["I_POSE"], ti["I_PR"], ti["I_SIZE"]) \
        == (21, 246, 394, 410, 425)
    to = enum_offsets("tight_fuse.cu", "O_")
    assert [to[k] for k in ("O_R", "O_V", "O_P", "O_BG", "O_BA", "O_INFO", "O_ITERS",
                            "O_SWEEPS")] \
        == offsets(rec.TIGHT_OUT)[:-1]


def mirror_preint_input(buf, slots, has_init):
    """The kernel's reading of a preintegrate input buffer."""
    f = buf.view(-1)
    hdr, o = f[:15], 15
    t, o = f[o:o + slots], o + slots
    gyro, o = f[o:o + 3 * slots].view(slots, 3), o + 3 * slots
    accel, o = f[o:o + 3 * slots].view(slots, 3), o + 3 * slots
    mask, o = f[o:o + slots] > 0.5, o + slots
    params = pi.PreintParams(hdr[6:9], hdr[9:12], hdr[12:15])
    init = None
    if has_init:
        init = pi.PreintState(*rec.unpack(f[o:o + 142], rec.PREINT_STATE), hdr[0:3], hdr[3:6])
        o += 142
    assert o == f.numel()
    seg = ImuSegment(t=t, gyro=gyro, accel=accel, quat=torch.zeros(slots, 4), mask=mask)
    return seg, params, hdr[0:3], hdr[3:6], init


def assert_equal_trees(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert_equal_trees(x, y)
        else:
            assert torch.equal(x, y)


def test_preintegrate_packing_round_trips():
    seg = tseg(segment(32, seed=5))
    params = pi.PreintParams.from_std(0.01, 0.1, 1e-8)
    bg, ba = torch.as_tensor(BG), torch.as_tensor(BA)
    ref = pi.preintegrate_plain(seg, params, bg, ba)
    for init in (None, ref):
        buf, slots, has_init = rec.pack_preintegrate(seg, params, bg, ba, init)
        assert (slots, has_init) == (32, int(init is not None))
        out = pi.preintegrate_plain(*mirror_preint_input(buf, slots, has_init))
        assert_equal_trees(out, pi.preintegrate_plain(seg, params, bg, ba, init))
    # the output buffer, written in the kernel's order, reads back as the state
    flat = torch.cat([getattr(ref, name).reshape(-1) for name, _ in rec.PREINT_STATE])
    assert_equal_trees(rec.unpack(flat, rec.PREINT_STATE), ref[:10])


def test_eskf_packing_round_trips():
    seg = tseg(segment(16, seed=6))
    _, ts = eskf_states(seed=3)
    params = eskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4)
    buf = rec.pack_eskf(ts.nav, ts.cov, seg, params).view(-1)
    n = seg.t.shape[0]
    nav = ts.nav._replace(r=buf[0:9].view(3, 3), v=buf[9:12], p=buf[12:15], bg=buf[15:18],
                          ba=buf[18:21])
    cov = buf[21:246].view(15, 15)
    mparams = eskf.EskfParams(buf[246:249], buf[249:252], buf[252:255], buf[255:258])
    o = 258
    mseg = ImuSegment(t=buf[o:o + n], gyro=buf[o + n:o + 4 * n].view(n, 3),
                      accel=buf[o + 4 * n:o + 7 * n].view(n, 3), quat=seg.quat,
                      mask=buf[o + 7 * n:o + 8 * n] > 0.5)
    assert buf.numel() == o + 8 * n
    out = eskf.predict_plain(eskf.EskfState(nav, cov), mseg, mparams, GRAVITY)
    ref = eskf.predict_plain(ts, seg, params, GRAVITY)
    assert_equal_trees(out, ref)
    flat = torch.cat([ref.nav.r.reshape(-1), ref.nav.v, ref.nav.p, ref.cov.reshape(-1)])
    assert_equal_trees(rec.unpack(flat, rec.ESKF_OUT), (ref.nav.r, ref.nav.v, ref.nav.p,
                                                        ref.cov))


def test_tight_packing_round_trips(fuse_calls):
    last, pre, pose, pred, g, cfg = fuse_calls[3]
    buf = rec.pack_tight(last, pre, pose, pred).view(-1)
    assert buf.numel() == 425
    mlast = last._replace(r=buf[0:9].view(3, 3), v=buf[9:12], p=buf[12:15], bg=buf[15:18],
                          ba=buf[18:21], info=buf[21:246].view(15, 15))
    mpre = pi.PreintState(*rec.unpack(buf[246:388], rec.PREINT_STATE), buf[388:391],
                          buf[391:394])
    mpose = buf[394:410].view(4, 4)
    mpred = pred._replace(r=buf[410:419].view(3, 3), v=buf[419:422], p=buf[422:425])
    out = tight.fuse_plain(mlast, mpre, mpose, mpred, g, cfg)
    ref = tight.fuse_plain(last, pre, pose, pred, g, cfg)
    assert_equal_trees(out, ref)
    flat = torch.cat([ref.r.reshape(-1), ref.v, ref.p, ref.bg, ref.ba, ref.info.reshape(-1),
                      torch.tensor([7.0, 5.0, 6.0])])
    r, v, p, bg, ba, info, its, sweeps = rec.unpack(flat, rec.TIGHT_OUT)
    assert_equal_trees((r, v, p, bg, ba, info), ref[:6])
    assert its.shape == () and float(its) == 7.0
    assert sweeps.tolist() == [5.0, 6.0]


# ------------------------------------------------------------ the dispatch
def test_cpu_tensors_take_the_plain_versions(fuse_calls, monkeypatch):
    """CPU inputs run the plain versions bit for bit and build, load and
    count nothing."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel was built for CPU tensors")

    monkeypatch.setattr(cuda_build, "library", no_build)
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    before = [fn.launches for fn in rec.KERNELS]
    seg = tseg(segment(16, seed=7))
    params = pi.PreintParams.from_std(0.01, 0.1, 1e-8)
    bg, ba = torch.as_tensor(BG), torch.as_tensor(BA)
    assert_equal_trees(pi.preintegrate(seg, params, bg, ba),
                       pi.preintegrate_plain(seg, params, bg, ba))
    _, ts = eskf_states(seed=4)
    eparams = eskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4)
    assert_equal_trees(eskf.predict(ts, seg, eparams, GRAVITY),
                       eskf.predict_plain(ts, seg, eparams, GRAVITY))
    args = fuse_calls[4]
    assert_equal_trees(tight.fuse(*args), tight.fuse_plain(*args))
    assert [fn.launches for fn in rec.KERNELS] == before


def test_wrappers_refuse_what_they_cannot_launch(fuse_calls):
    """The kernel wrappers never compute a result off the card: CPU inputs
    raise, and so does gravity on a device (it goes by value)."""
    seg = tseg(segment(16, seed=8))
    params = pi.PreintParams.from_std(0.01, 0.1, 1e-8)
    with pytest.raises(ValueError, match="CUDA"):
        rec.preintegrate(seg, params, BG, BA)
    _, ts = eskf_states(seed=5)
    eparams = eskf.EskfParams.from_std(0.01, 0.1, 1e-4, 1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        rec.eskf_predict(ts.nav, ts.cov, seg, eparams, GRAVITY)
    with pytest.raises(ValueError, match="host values"):
        rec.eskf_predict(ts.nav, ts.cov, seg, eparams, torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rec.tight_fuse(*fuse_calls[4])
    with pytest.raises(TypeError, match="float32"):
        rec.pack_eskf(ts.nav, ts.cov.double(), seg, eparams)


# ------------------------------------------------------- the frontend step
@pytest.mark.parametrize("fusion", [tfe.FUSION_TIGHT_OPT, tfe.FUSION_TIGHT_KF,
                                    tfe.FUSION_LOOSE])
def test_step_preintegrates_only_for_tight_coupling(fusion, monkeypatch):
    """`preintegrate` runs once a step under TightCouplingOptimization and
    never under the KF or loose coupling, which do not read it; every
    output stays bit-equal to the earlier step, which also preintegrated
    under loose coupling (replayed here by a step that calls it first)."""
    calls = []
    orig = tfe.preintegrate

    def counted(*args):
        calls.append(1)
        return orig(*args)

    class EarlierFrontend(tfe.Frontend):
        def _step_impl(self, mstate, fstate, points, rel_times, mask, ref_time, dseg, pseg,
                       ring):
            if self.cfg.fusion_method != tfe.FUSION_TIGHT_KF:
                tfe.preintegrate(pseg, self.params, fstate.nav.bg, fstate.nav.ba)
            return super()._step_impl(mstate, fstate, points, rel_times, mask, ref_time,
                                      dseg, pseg, ring)

    monkeypatch.setattr(tfe, "preintegrate", counted)
    ds = simulate(SimConfig(duration=3.4, points_per_scan=CAP, seed=3))
    runs = {}
    for name in ("now", "earlier"):
        slam = SlamSystem(SystemConfig(matcher_config=tm.IcpConfig(**CFG),
                                       frontend=tfe.FrontendConfig(fusion_method=fusion),
                                       scan_capacity=CAP, imu_segment_capacity=SEG),
                          device="cpu")
        if name == "earlier":
            slam.frontend.__class__ = EarlierFrontend
        calls.clear()
        slam.run_dataset(ds)
        steps = sum(1 for s in slam.stats if not s.get("init"))
        runs[name] = (slam, len(calls), steps)
    (now, n_now, steps), (earlier, n_earlier, _) = runs["now"], runs["earlier"]
    assert steps >= 3
    assert n_now == (steps if fusion == tfe.FUSION_TIGHT_OPT else 0)
    assert n_earlier == n_now + (0 if fusion == tfe.FUSION_TIGHT_KF else steps)
    assert len(now.trajectory) == len(earlier.trajectory)
    for a, b in zip(now.trajectory, earlier.trajectory):
        np.testing.assert_array_equal(a, b)
    assert_equal_trees(now.fstate, earlier.fstate)
