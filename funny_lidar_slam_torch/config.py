"""YAML configuration, schema-compatible with the reference: the port's
copy of the JAX package's config.py.

The reference loads YAML through roslaunch into a ROS param server and a
process-wide `ConfigParameters` singleton (System::InitConfigParameters,
src/slam/system.cpp:118-248; fields include/slam/config_parameters.h:27-116).
Here the same YAML schema (sensor_topic / slam_mode / lidar / imu / gravity /
calibration / frontend / system / loopclosure sections) is parsed directly
into the port's typed configs, so the presets under `configs/` load 1:1.
The `tpu:` section (absent in reference files) carries the static
capacities of the padded-tensor design; everything has defaults.

The YAML is read by `read_yaml`, a reader of the subset the presets use
(block mappings, flow lists, plain and quoted scalars, comments), typed as
`yaml.safe_load` types them (YAML 1.1): the port does not need PyYAML.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

from .backend.loop_closure import LoopClosureConfig
from .fusion.tight import TightFusionConfig
from .lidar.model import LidarModel, make_lidar_model
from .pipeline.frontend import FrontendConfig
from .pipeline.system import SystemConfig
from .registration import matchers

MODE_MAPPING = 1
MODE_LOCALIZATION = 2


@dataclass
class TpuCapacities:
    """Static shape capacities (padded-tensor design, SURVEY.md §7)."""

    scan_capacity: int = 16384
    source_capacity: int = 16384
    cloud_capacity: int = 16384
    merged_capacity: int = 131072
    map_capacity: int = 131072
    bucket_size: int = 8
    imu_segment_capacity: int = 64
    corner_capacity: int = 4096
    planar_capacity: int = 16384
    local_map_capacity: int = 262144


@dataclass
class SlamConfig:
    """Full parsed configuration tree."""

    slam_mode: int = MODE_MAPPING
    lidar_topic: str = ""
    imu_topic: str = ""
    lidar_model: LidarModel | None = None
    lidar_point_jump_span: int = 1
    lidar_point_time_scale: float = 1.0
    lidar_use_min_distance: float = 1.0
    lidar_use_max_distance: float = 1000.0
    system: SystemConfig | None = None
    caps: TpuCapacities = field(default_factory=TpuCapacities)
    raw: dict = field(default_factory=dict)
    # localization extras (config/localization/*.yaml + localization.h)
    map_path: str | None = None
    tile_map_dir: str | None = None


def _get(d: dict, key: str, default):
    v = d.get(key, default)
    return default if v is None else v


def _build_matcher_config(mode: str, reg: dict, feat: dict, caps: TpuCapacities,
                          is_localization: bool):
    iters = int(_get(reg, "optimization_iter_num", 30))
    pos_eps = float(_get(reg, "position_converge_thres", 0.01))
    rot_eps = float(_get(reg, "rotation_converge_thres", 0.05))
    kf_d = float(_get(reg, "keyframe_delta_distance", 1.0))
    kf_r = float(_get(reg, "keyframe_delta_rotation", 0.2))

    if mode == "IcpOptimized":
        return matchers.IcpConfig(
            max_iterations=iters,
            local_map_size=max(int(_get(reg, "local_map_size", 25)), 1),
            map_filter_size=float(_get(reg, "local_map_cloud_filter_size", 0.5)),
            source_filter_size=float(_get(reg, "source_cloud_filter_size", 0.4)),
            max_correspond_distance=float(_get(reg, "point_search_thres", 1.0)),
            position_converge_thresh=pos_eps, rotation_converge_thresh=rot_eps,
            dist_thresh_add_cloud=kf_d, rot_thresh_add_cloud=kf_r,
            # the window ring buffer stores the downsampled source cloud, so
            # its per-cloud capacity must match the source capacity
            source_capacity=caps.source_capacity, cloud_capacity=caps.source_capacity,
            merged_capacity=caps.merged_capacity, map_capacity=caps.map_capacity,
            bucket_size=caps.bucket_size, is_localization_mode=is_localization,
        )
    if mode in ("PointToPlane_KdTree", "PointToPlane_IVOX"):
        return matchers.PointToPlaneConfig(
            mode="window" if mode == "PointToPlane_KdTree" else "ivox",
            max_iterations=iters,
            point_to_planar_thresh=float(_get(reg, "point_to_planar_thres", 0.1)),
            position_converge_thresh=pos_eps, rotation_converge_thresh=rot_eps,
            dist_thresh_add_cloud=kf_d, rot_thresh_add_cloud=kf_r,
            local_map_size=max(int(_get(reg, "local_planar_map_size",
                                        _get(reg, "local_map_size", 30))), 1),
            map_filter_size=float(_get(reg, "local_planar_voxel_filter_size", 0.5)),
            source_capacity=caps.planar_capacity, cloud_capacity=caps.planar_capacity,
            merged_capacity=caps.merged_capacity, map_capacity=caps.map_capacity,
            bucket_size=caps.bucket_size, is_localization_mode=is_localization,
        )
    if mode == "LoamFull_KdTree":
        return matchers.LoamFullConfig(
            max_iterations=iters,
            point_to_planar_thresh=float(_get(reg, "point_to_planar_thres", 0.1)),
            point_search_thresh=float(_get(reg, "point_search_thres", 1.0)),
            line_ratio_thresh=float(_get(reg, "line_ratio_thres", 3.0)),
            position_converge_thresh=pos_eps, rotation_converge_thresh=rot_eps,
            dist_thresh_add_cloud=kf_d, rot_thresh_add_cloud=kf_r,
            corner_map_size=max(int(_get(reg, "local_corner_map_size", 30)), 1),
            planar_map_size=max(int(_get(reg, "local_planar_map_size", 30)), 1),
            corner_filter_size=float(_get(reg, "local_corner_voxel_filter_size", 0.2)),
            planar_filter_size=float(_get(reg, "local_planar_voxel_filter_size", 0.4)),
            corner_capacity=caps.corner_capacity, planar_capacity=caps.planar_capacity,
            merged_capacity=caps.merged_capacity, map_capacity=caps.map_capacity,
            bucket_size=caps.bucket_size, is_localization_mode=is_localization,
        )
    if mode == "IncrementalNDT":
        return matchers.NdtConfig(
            voxel_size=float(_get(reg, "ndt_voxel_size", 1.0)),
            res_outlier_thresh=float(_get(reg, "ndt_outlier_threshold", 5.0)),
            source_filter_size=float(_get(reg, "source_cloud_filter_size", 1.0)),
            position_converge_thresh=pos_eps, rotation_converge_thresh=rot_eps,
            min_points_in_voxel=int(_get(reg, "ndt_min_points_in_voxel", 3)),
            max_points_in_voxel=int(_get(reg, "ndt_max_points_in_voxel", 50)),
            min_effective_pts=int(_get(reg, "ndt_min_effective_pts", 10)),
            max_iterations=iters,
            source_capacity=caps.source_capacity,
            map_capacity=caps.map_capacity, is_localization_mode=is_localization,
        )
    raise ValueError(f"unknown registration_and_searcher_mode: {mode}")


def parse_config(doc: dict) -> SlamConfig:
    """Parse a loaded YAML document (reference schema) into SlamConfig."""
    lidar = _get(doc, "lidar", {})
    imu = _get(doc, "imu", {})
    fe = _get(doc, "frontend", {})
    reg = _get(fe, "registration", {})
    feat = _get(fe, "feature", {})
    sysd = _get(doc, "system", {})
    lc = _get(doc, "loopclosure", {})
    calib = _get(doc, "calibration", {})
    topics = _get(doc, "sensor_topic", {})
    tpu = _get(doc, "tpu", {})
    loc = _get(doc, "localization", {})

    caps = TpuCapacities(**{k: int(v) for k, v in tpu.items()
                            if k in TpuCapacities.__dataclass_fields__})
    slam_mode = int(_get(doc, "slam_mode", MODE_MAPPING))
    is_localization = slam_mode == MODE_LOCALIZATION

    lidar_type = str(_get(lidar, "lidar_sensor_type", "None"))
    model_overrides = {}
    # both our names (radians) and the reference's config keys (degrees,
    # converted like System::InitLidarModel, system.cpp:105-112; h_res
    # derived from the horizon scan count) for the "None" model
    for src_key, dst_key in (("lidar_vertical_scan_num", "vertical_scan_num"),
                             ("lidar_scan", "vertical_scan_num"),
                             ("lidar_horizon_scan_num", "horizon_scan_num"),
                             ("lidar_horizon_scan", "horizon_scan_num"),
                             ("lidar_vertical_resolution", "v_res"),
                             ("lidar_horizontal_resolution", "h_res"),
                             ("lidar_lower_angle", "lower_angle")):
        if src_key in lidar:
            model_overrides[dst_key] = lidar[src_key]
    if "lidar_vertical_resolution" in lidar:
        model_overrides["v_res"] = float(np.radians(lidar["lidar_vertical_resolution"]))
    if "lidar_lower_angle" in lidar:
        model_overrides["lower_angle"] = float(np.radians(lidar["lidar_lower_angle"]))
    if "lidar_horizon_scan" in lidar and "lidar_horizontal_resolution" not in lidar:
        model_overrides["h_res"] = float(np.radians(360.0 / float(lidar["lidar_horizon_scan"])))
    lidar_model = make_lidar_model(lidar_type, **model_overrides)

    t_l2i = np.asarray(_get(calib, "lidar_to_imu",
                            np.eye(4).ravel().tolist()), np.float64).reshape(4, 4)

    mode = str(_get(fe, "registration_and_searcher_mode", "IcpOptimized"))
    mcfg = _build_matcher_config(mode, reg, feat, caps, is_localization)

    fusion = TightFusionConfig(
        iterations=int(_get(fe, "fusion_opti_iters", 20)),
        lidar_rotation_std=float(_get(lidar, "lidar_rotation_noise_std", 0.005)),
        lidar_position_std=float(_get(lidar, "lidar_position_noise_std", 0.01)),
        gyro_rw_std=float(_get(imu, "gyro_rw_noise_std", 1e-4)),
        acc_rw_std=float(_get(imu, "acc_rw_noise_std", 1e-4)),
    )

    geometry = None
    if mode in ("LoamFull_KdTree", "PointToPlane_IVOX", "PointToPlane_KdTree") and \
            lidar_model.vertical_scan_num > 0:
        geometry = lidar_model.to_geometry(
            min_distance=float(_get(lidar, "lidar_use_min_distance", 1.0)),
            max_distance=float(_get(lidar, "lidar_use_max_distance", 1000.0)),
        )

    frontend_cfg = FrontendConfig(
        fusion_method=str(_get(fe, "fusion_method", "TightCouplingOptimization")),
        gravity=(0.0, 0.0, -float(_get(doc, "gravity", 9.81))),
        t_lidar_to_imu=t_l2i,
        gyro_noise_std=float(_get(imu, "gyro_noise_std", 0.01)),
        acc_noise_std=float(_get(imu, "acc_noise_std", 0.1)),
        fusion=fusion,
        lidar_geometry=geometry,
        planar_voxel_filter_size=float(_get(feat, "planar_voxel_filter_size", 0.5)),
    )

    lc_cfg = LoopClosureConfig(
        skip_near_loopclosure=int(_get(lc, "skip_near_loopclosure_threshold", 100)),
        skip_near_keyframe=int(_get(lc, "skip_near_keyframe_threshold", 100)),
        near_neighbor_distance=float(_get(lc, "near_neighbor_distance_threshold", 10.0)),
        candidate_left=int(_get(lc, "candidate_local_map_left_range", 20)),
        candidate_right=int(_get(lc, "candidate_local_map_right_range", 20)),
        current_left=int(_get(lc, "loopclosure_local_map_left_range", 30)),
        fitness_threshold=float(_get(lc, "registration_converge_threshold", 1.5)),
    )

    system_cfg = SystemConfig(
        registration_mode=mode,
        matcher_config=mcfg,
        frontend=frontend_cfg,
        keyframe_delta_dist=float(_get(sysd, "keyframe_delta_distance", 1.0)),
        keyframe_delta_rotation=float(_get(sysd, "keyframe_delta_rotation", 0.2)),
        scan_capacity=caps.scan_capacity,
        imu_segment_capacity=caps.imu_segment_capacity,
        imu_has_orientation=bool(_get(imu, "has_orientation", False)),
        imu_buffer_size=int(_get(imu, "data_searcher_buffer_size", 2000)),
        gravity_norm=float(_get(doc, "gravity", 9.81)),
        enable_loopclosure=bool(_get(sysd, "enable_loopclosure", False)),
        loopclosure=lc_cfg,
    )

    return SlamConfig(
        slam_mode=slam_mode,
        lidar_topic=str(_get(topics, "lidar_topic", "")),
        imu_topic=str(_get(topics, "imu_topic", "")),
        lidar_model=lidar_model,
        lidar_point_jump_span=int(_get(lidar, "lidar_point_jump_span", 1)),
        lidar_point_time_scale=float(_get(lidar, "lidar_point_time_scale", 1.0)),
        lidar_use_min_distance=float(_get(lidar, "lidar_use_min_distance", 1.0)),
        lidar_use_max_distance=float(_get(lidar, "lidar_use_max_distance", 1000.0)),
        system=system_cfg,
        caps=caps,
        raw=doc,
        map_path=_get(loc, "map_path", None),
        tile_map_dir=_get(loc, "tile_map_dir", None),
    )


# -- YAML reader -----------------------------------------------------------
# The subset the presets use, typed by PyYAML's YAML 1.1 resolver
# (yaml/resolver.py): `1.0e-6` is a float, a bare `1e-4` a string, `None` a
# string, `~`/`null`/empty null; ints take `_`, 0x, 0b, leading-0 octal and
# base 60. Anything outside the subset (block lists, flow mappings, anchors,
# tags, multi-line scalars) raises rather than being read another way.

_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _base60(v: str, cast):
    value = 0
    for part in v.split(":"):
        value = value * 60 + cast(part)
    return value


def _plain(tok: str):
    """Type a plain (unquoted) scalar as yaml.safe_load does."""
    if _NULL_RE.match(tok):
        return None
    if _BOOL_RE.match(tok):
        return _BOOL[tok.lower()]
    if _INT_RE.match(tok):
        v = tok.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _base60(v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(tok):
        v = tok.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _base60(v, float)
        return sign * float(v)
    if tok[0] in "&*!|>%@`{-?" and (tok[0] not in "-?" or len(tok) == 1 or tok[1] == " "):
        raise ValueError(f"YAML construct outside the presets' subset: {tok!r}")
    return tok


def _quoted(tok: str, i: int) -> tuple[str, int]:
    """Read the quoted scalar starting at tok[i]; returns (text, index after it)."""
    q = tok[i]
    out, j = [], i + 1
    escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0", " ": " "}
    while j < len(tok):
        c = tok[j]
        if q == "'" and c == "'":
            if tok[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = tok[j + 1:j + 2]
            if e not in escapes:
                raise ValueError(f"unsupported escape in {tok!r}")
            out.append(escapes[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {tok!r}")


def _scalar(tok: str):
    tok = tok.strip()
    if tok[:1] in ("'", '"'):
        text, end = _quoted(tok, 0)
        if tok[end:].strip():
            raise ValueError(f"text after a quoted scalar: {tok!r}")
        return text
    if tok[:1] == "[":
        items, end = _flow_list(tok, 0)
        if tok[end:].strip():
            raise ValueError(f"text after a flow list: {tok!r}")
        return items
    return _plain(tok)


def _flow_list(tok: str, i: int) -> tuple[list, int]:
    """Read the flow list `[a, b, ...]` starting at tok[i] (nested lists and
    quoted items allowed); returns (items, index after the `]`)."""
    items, j, want_item = [], i + 1, True
    while j < len(tok):
        c = tok[j]
        if c == " ":
            j += 1
            continue
        if c == "]":
            return items, j + 1
        if c == ",":
            if want_item:
                raise ValueError(f"empty flow list item: {tok!r}")
            want_item = True
            j += 1
            continue
        if not want_item:
            raise ValueError(f"missing `,` in a flow list: {tok!r}")
        if c in "'\"":
            item, j = _quoted(tok, j)
        elif c == "[":
            item, j = _flow_list(tok, j)
        elif c == "{":
            raise ValueError(f"flow mappings are outside the presets' subset: {tok!r}")
        else:
            end = j
            while end < len(tok) and tok[end] not in ",]":
                end += 1
            item, j = _plain(tok[j:end].strip()), end
        items.append(item)
        want_item = False
    raise ValueError(f"unterminated flow list: {tok!r}")


def _strip_comment(line: str) -> str:
    """Drop a trailing `#` comment (a `#` at the start or after a space,
    outside quotes) and the trailing blanks."""
    quote = None
    for j, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or line[j - 1] in " [,:"):
            quote = c
        elif c == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """Split `key: value` at the first `:` followed by a blank or the end,
    outside quotes; None when the line holds no mapping key."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0)
        rest = text[end:]
        if not (rest.startswith(":") and (len(rest) == 1 or rest[1] == " ")):
            return None
        return key, rest[1:].strip()
    for j, c in enumerate(text):
        if c == ":" and (j + 1 == len(text) or text[j + 1] == " "):
            return _plain(text[:j].rstrip()), text[j + 1:].strip()
    return None


def read_yaml(text: str):
    """Parse a YAML document of the presets' subset into dicts, lists and
    scalars, as `yaml.safe_load` would."""
    lines = []  # (indent, text) of each logical line, flow lists joined
    raw = text.split("\n")
    k = 0
    while k < len(raw):
        line = raw[k]
        k += 1
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = _strip_comment(line)
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        indent = len(body) - len(body.lstrip(" "))
        body = body.strip()
        while body.count("[") > body.count("]") and k < len(raw):
            body += " " + _strip_comment(raw[k]).strip()
            k += 1
        lines.append((indent, body))
    if not lines:
        return None
    root: dict = {}
    stack = [[-1, root, None]]  # [indent of the owning key line, mapping, its keys' indent]
    for n, (indent, body) in enumerate(lines):
        while stack[-1][0] >= indent:
            stack.pop()
        top = stack[-1]
        if top[2] is None:
            top[2] = indent
        kv = _split_key(body)
        if kv is None or top[2] != indent:
            raise ValueError(f"YAML line outside the presets' subset: {body!r}")
        key, rest = kv
        nxt = lines[n + 1][0] if n + 1 < len(lines) else -1
        if rest:
            if nxt > indent:
                raise ValueError(f"unexpected indentation after {body!r}")
            top[1][key] = _scalar(rest)
        elif nxt > indent:
            top[1][key] = child = {}
            stack.append([indent, child, None])
        else:
            top[1][key] = None
    return root


def load_config(path: str) -> SlamConfig:
    with open(path) as f:
        return parse_config(read_yaml(f.read()))


def make_localization_config(cfg: SlamConfig):
    """Derive a LocalizationConfig from a parsed (slam_mode=2) tree."""
    from .localization import LocalizationConfig

    loc = _get(cfg.raw, "localization", {})
    return LocalizationConfig(
        registration_mode=cfg.system.registration_mode,
        matcher_config=cfg.system.matcher_config,
        frontend=cfg.system.frontend,
        map_path=cfg.map_path,
        tile_map_dir=cfg.tile_map_dir,
        map_filter_size=float(_get(loc, "map_filter_size", 0.3)),
        local_map_size=float(_get(loc, "local_map_size", 200.0)),
        local_map_boundary=float(_get(loc, "local_map_boundary", 50.0)),
        local_map_capacity=cfg.caps.local_map_capacity,
        init_fitness=float(_get(loc, "init_fitness", 1.0)),
        init_fitness_range=float(_get(loc, "init_fitness_range", 2.0)),
        scan_capacity=cfg.caps.scan_capacity,
        imu_segment_capacity=cfg.caps.imu_segment_capacity,
        imu_has_orientation=cfg.system.imu_has_orientation,
        imu_buffer_size=cfg.system.imu_buffer_size,
        gravity_norm=cfg.system.gravity_norm,
    )
