"""The port's benchmark, bench_torch.py, against the JAX package's bench.py
on the CPU:
  (a) every configuration builder equals, field by field, the config that
      bench.py builds inside main() (written out here as bench.py writes
      it; importing bench.py's main would set up JAX);
  (b) `_steady_fps` equals bench.py's on synthetic stats lists, in both
      branches, with and without retire gaps over the 5 s cutoff, and
      counts the gaps it drops exactly;
  (c) the headline and Localization sections against bench.py's own
      `_run_mode` and `_run_localization` (the JAX SlamSystem and
      Localizer, on fused_select_xla as on any CPU) on one small dataset:
      equal frames, ATE within 0.02 m (the tight LM amplifies f32
      order-of-sum differences, ROADMAP Queue 3);
  (d) the result line: a superset of bench.py's keys, `value` the median
      of the headline draws, the budget and section errors (exit 1), and
      `emit` racing a section that keeps writing;
  (e) the script as a process: without CUDA and without `--device cpu` it
      exits non-zero with no JSON line; the watchdog prints a partial line
      and exits 0."""

import importlib.util
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import bench_torch as tb
from funny_lidar_slam_torch.io.simulator import SimConfig, simulate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 2048


@pytest.fixture(scope="module")
def jbench():
    """bench.py as a module, with the environment it sets restored."""
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


def tree(obj):
    """A config as nested plain values: class name and fields."""
    if hasattr(obj, "_fields"):
        return (type(obj).__name__, {f: tree(getattr(obj, f)) for f in obj._fields})
    if hasattr(obj, "__dataclass_fields__"):
        return (type(obj).__name__, {f: tree(getattr(obj, f)) for f in obj.__dataclass_fields__})
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.tolist())
    if isinstance(obj, (list, tuple)):
        return [tree(x) for x in obj]
    return obj


# ------------------------------------------------------------- (a) configs
def jax_configs(cap):
    """bench.py's configurations (bench.py:202-214, :238-255, :296-330)."""
    from funny_lidar_slam_tpu.backend.loop_closure import LoopClosureConfig
    from funny_lidar_slam_tpu.io.simulator import Figure8Trajectory
    from funny_lidar_slam_tpu.io.simulator import SimConfig as JSimConfig
    from funny_lidar_slam_tpu.localization.localizer import LocalizationConfig
    from funny_lidar_slam_tpu.loam.projection import LidarGeometry
    from funny_lidar_slam_tpu.pipeline.frontend import FUSION_TIGHT_OPT, FrontendConfig
    from funny_lidar_slam_tpu.pipeline.system import SystemConfig
    from funny_lidar_slam_tpu.registration import matchers

    tight = FrontendConfig(fusion_method=FUSION_TIGHT_OPT)
    geom = LidarGeometry(n_rows=16, n_cols=900, horizontal_resolution=2 * np.pi / 900,
                         min_distance=1.5, max_distance=50.0)
    loam_fe = FrontendConfig(fusion_method=FUSION_TIGHT_OPT, lidar_geometry=geom)
    modes = {
        "IcpOptimized": (matchers.IcpConfig(
            source_capacity=cap, cloud_capacity=cap, merged_capacity=65536,
            map_capacity=65536, local_map_size=20,
            map_layout="grid", grid_dims=(96, 96, 16)), tight),
        "PointToPlane_IVOX": (matchers.PointToPlaneConfig(
            mode="ivox", source_capacity=cap, cloud_capacity=cap,
            map_capacity=131072), loam_fe),
        "PointToPlane_KdTree": (matchers.PointToPlaneConfig(
            mode="window", source_capacity=cap, cloud_capacity=cap,
            merged_capacity=65536, map_capacity=65536), loam_fe),
        "LoamFull_KdTree": (matchers.LoamFullConfig(
            corner_capacity=4096, planar_capacity=16384,
            merged_capacity=65536, map_capacity=65536), loam_fe),
        "IncrementalNDT": (matchers.NdtConfig(
            voxel_size=2.0, source_filter_size=0.3, min_points_in_voxel=4,
            min_effective_pts=50, res_outlier_thresh=30.0,
            source_capacity=cap, map_capacity=131072), tight),
    }
    out = {mode: SystemConfig(registration_mode=mode, matcher_config=mcfg, frontend=fe,
                              scan_capacity=cap, imu_segment_capacity=16)
           for mode, (mcfg, fe) in modes.items()}
    out["Localization"] = LocalizationConfig(
        registration_mode="IcpOptimized",
        matcher_config=matchers.IcpConfig(
            source_capacity=cap, cloud_capacity=cap,
            merged_capacity=65536, map_capacity=65536,
            is_localization_mode=True),
        scan_capacity=cap,
        imu_segment_capacity=16,
        map_filter_size=0.4,
        local_map_size=80.0,
        local_map_boundary=20.0,
        local_map_capacity=65536,
    )
    out["Figure8_Loop"] = SystemConfig(
        registration_mode="IcpOptimized",
        matcher_config=matchers.IcpConfig(
            source_capacity=cap, cloud_capacity=cap,
            merged_capacity=65536, map_capacity=65536, local_map_size=20),
        frontend=FrontendConfig(fusion_method=FUSION_TIGHT_OPT),
        scan_capacity=cap,
        imu_segment_capacity=16,
        enable_loopclosure=True,
        loopclosure=LoopClosureConfig(skip_near_loopclosure=20,
                                      skip_near_keyframe=40,
                                      near_neighbor_distance=5.0),
    )
    out["Figure8_sim"] = (JSimConfig(duration=24.0, points_per_scan=cap, seed=11),
                          Figure8Trajectory(amp_x=18.0, amp_y=9.0, omega=0.35))
    out["sim"] = JSimConfig(duration=14.0, points_per_scan=cap, seed=7)
    return out


def port_configs(cap):
    out = {mode: tb.mode_config(mode, cap) for mode in tb.MODES}
    out.update(Localization=tb.localization_config(cap), Figure8_Loop=tb.figure8_config(cap),
               Figure8_sim=tb.figure8_sim(cap), sim=SimConfig(points_per_scan=cap, **tb.SIM))
    return out


CONFIGS = tb.MODES + ("Localization", "Figure8_Loop", "Figure8_sim", "sim")


@pytest.mark.parametrize("cap", [tb.CAP, SMALL])
@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_bench_py(name, cap):
    assert tree(port_configs(cap)[name]) == tree(jax_configs(cap)[name])


def test_headline_config_is_the_headline_mode():
    """chip_smoke.py's grid phases build `headline_config`, the bench's
    headline section `mode_config("IcpOptimized")`: the same config."""
    assert tree(tb.headline_config()) == tree(tb.mode_config("IcpOptimized"))


# ------------------------------------------------------------ (b) steady fps
def stats_case(kind):
    rng = np.random.default_rng(5)
    init = [{"init": True, "tr": 0.0, "wall": 9.0}]
    if kind == "retire":
        trs = np.cumsum(rng.uniform(0.05, 0.3, 40))
        return init + [{"tr": float(t), "wall": 0.2} for t in trs]
    if kind == "retire_stalls":  # three gaps over 5 s, one in the first half
        gaps = rng.uniform(0.05, 0.3, 40)
        gaps[[5, 25, 33, 34]] = [7.0, 6.5, 12.0, 5.0]
        return init + [{"tr": float(t), "wall": 0.2} for t in np.cumsum(gaps)]
    if kind == "retire_batched":  # bursts of equal stamps, as a batch retire
        trs = np.repeat(np.cumsum(rng.uniform(0.5, 1.0, 8)), 4)
        return init + [{"tr": float(t)} for t in trs]
    if kind == "walls":
        return init + [{"wall": float(w)} for w in rng.uniform(0.05, 0.3, 15)]
    if kind == "walls_few":  # < 12 stamps: the wall branch
        return init + [{"tr": float(i), "wall": float(w)}
                       for i, w in enumerate(rng.uniform(0.05, 0.3, 10))]
    if kind == "too_short":
        return init + [{"wall": 0.1}] * 7
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["retire", "retire_stalls", "retire_batched", "walls",
                                  "walls_few", "too_short"])
def test_steady_fps_matches_bench_py(jbench, kind):
    stats = stats_case(kind)
    fps, excluded = tb._steady_fps(stats)
    assert fps == jbench._steady_fps(stats)
    trs = [s["tr"] for s in stats if "tr" in s and not s.get("init")]
    want = int((np.diff(trs[len(trs) // 2:]) >= 5.0).sum()) if len(trs) >= 12 else 0
    assert excluded == want
    assert excluded == {"retire_stalls": 3}.get(kind, 0)


# ------------------------------------------ (c) sections against the JAX bench
@pytest.fixture(scope="module")
def small_ds():
    return simulate(SimConfig(duration=4.5, points_per_scan=SMALL, seed=7))


def test_headline_matches_jax_bench(jbench, small_ds):
    mcfg, fe = jax_configs(SMALL)["IcpOptimized"].matcher_config, \
        jax_configs(SMALL)["IcpOptimized"].frontend
    j = jbench._run_mode(small_ds, "IcpOptimized", mcfg, fe, SMALL, with_rpe=True)
    t = tb._run_mode(small_ds, "IcpOptimized", SMALL, "cpu")
    assert t["frames"] == j["frames"] >= 15
    assert abs(t["ate_m"] - j["ate_m"]) < 0.02, (t, j)
    assert t["ate_m"] < 0.3 and t["rpe_m"] < 0.1
    assert t["fused_select_launches"] == 0  # the CPU runs the plain version


def test_localization_matches_jax_bench(jbench, small_ds, monkeypatch):
    monkeypatch.setenv("FLS_AOT_CACHE", "0")  # plain jit: no executable cache on disk
    j = jbench._run_localization(small_ds, SMALL)
    t = tb._run_localization(small_ds, SMALL, "cpu")
    assert t["frames"] == j["frames"] >= 15
    assert abs(t["ate_m"] - j["ate_m"]) < 0.02, (t, j)
    assert t["ate_m"] < 0.3


# ----------------------------------------------------------- (d) result line
def fake_sections(monkeypatch, fps=(4.0, 6.0, 5.0), fail=()):
    """Stub sections: the headline's draws give `fps` in turn; a section
    named in `fail` (or the headline's draw "draw2") raises."""
    draws = iter(fps)

    def section(name, **extra):
        if name in fail:
            raise RuntimeError(f"{name} broke")
        return {"fps": 7.0, "ate_m": 0.03, "rpe_m": 0.01, "frames": 10, "excluded_deltas": 0,
                "fused_select_launches": 0 if name == "IncrementalNDT" else 9, **extra}

    def run_mode(ds, mode, cap, device=None):
        if mode == "IcpOptimized":
            f = next(draws)
            if f is None:
                raise RuntimeError("draw broke")
            return {**section(mode), "fps": f}
        return section(mode)

    monkeypatch.setattr(tb, "_sim_cached", lambda cfg, traj=None: None)
    monkeypatch.setattr(tb, "_run_mode", run_mode)
    monkeypatch.setattr(tb, "_run_localization",
                        lambda ds, cap, device=None: section("Localization"))
    monkeypatch.setattr(tb, "_run_figure8",
                        lambda cap, device=None: section("Figure8_Loop", loops_accepted=2))


def test_line_keys_and_median_value(jbench, monkeypatch):
    fake_sections(monkeypatch)
    result = tb.Result()
    assert tb.bench(result, "cpu") == 0
    line = json.loads(result.line("main"))
    assert set(jbench.RESULT) | {"bench_wall_s", "card", "rpe_m"} <= set(line)
    assert "partial" not in line and line["skipped"] == []
    assert list(line["per_mode"]) == list(tb.MODES) + ["Localization", "Figure8_Loop"]
    head = line["per_mode"]["IcpOptimized"]
    assert head["fps_runs"] == [4.0, 6.0, 5.0] and head["fps_best"] == 6.0
    assert line["value"] == head["fps"] == np.median(head["fps_runs"]) == 5.0
    assert line["vs_baseline"] == 0.25 and line["realtime_x"] == 0.5
    assert head["fused_select_launches"] == 27
    assert json.loads(result.line("watchdog"))["partial"] == "watchdog"


def test_budget_zero_runs_the_headline_once(monkeypatch):
    fake_sections(monkeypatch)
    monkeypatch.setattr(tb, "BUDGET_S", 0.0)
    result = tb.Result()
    assert tb.bench(result, "cpu") == 0
    line = json.loads(result.line("main"))
    assert list(line["per_mode"]) == ["IcpOptimized"]
    assert line["per_mode"]["IcpOptimized"]["fps_runs"] == [4.0] and line["value"] == 4.0
    assert line["skipped"] == list(tb.MODES[1:]) + ["Localization", "Figure8_Loop"]


@pytest.mark.parametrize("fail", ["PointToPlane_KdTree", "Localization", "Figure8_Loop",
                                  "draw2"])
def test_section_error_is_written_and_exits_1(monkeypatch, fail):
    fake_sections(monkeypatch, fps=(4.0, None, 5.0) if fail == "draw2" else (4.0, 6.0, 5.0),
                  fail=(fail,))
    result = tb.Result()
    assert tb.bench(result, "cpu") == 1
    line = json.loads(result.line("main"))
    name = "IcpOptimized" if fail == "draw2" else fail
    assert "broke" in line["per_mode"][name]["error"]
    assert len(line["per_mode"]) == 7 and line["skipped"] == []
    if fail == "draw2":  # the draw before the error still counts
        assert line["per_mode"]["IcpOptimized"]["fps_runs"] == [4.0] and line["value"] == 4.0


def test_emit_races_a_writing_section(capsys):
    """A second thread serializes (and then emits) while the main thread
    keeps writing sections and skips; no call raises, one line prints."""
    result, errors, done = tb.Result(), [], threading.Event()

    def reader():
        try:
            while not done.is_set():
                json.loads(result.line("watchdog"))
            result.emit("watchdog")
        except Exception as e:  # noqa: BLE001 - the test reports any failure
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=reader)
        th.start()
        for i in range(3000):
            result.put_section(f"s{i}", {"fps": float(i), "runs": list(range(i % 7))})
            result.skip(f"k{i}")
        done.set()
        th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive() and not errors, errors
    assert result.emit("main") is False
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["partial"] == "watchdog"


# -------------------------------------------------------------- (e) processes
def run_script(args, tmp_path, **env):
    e = dict(os.environ, PYTHONPATH=ROOT, HOME=str(tmp_path), OMP_NUM_THREADS="1", **env)
    return subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), *args],
                          cwd=ROOT, env=e, capture_output=True, text=True, timeout=180)


def test_script_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    out = run_script([], tmp_path)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not any(x.startswith("{") for x in out.stdout.splitlines())


def test_watchdog_prints_a_partial_line(tmp_path):
    out = run_script(["--device", "cpu"], tmp_path, BENCH_WATCHDOG_S="3")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["partial"] == "watchdog" and line["device"] == "cpu"
    assert line["metric"] == "scan_match_fps" and line["bench_wall_s"] >= 3.0
