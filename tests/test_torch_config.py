"""Port parity: the YAML presets, their configuration tree and the LiDAR
models of funny_lidar_slam_torch against the JAX package.

- The port's YAML reader (`config.read_yaml`) gives what `yaml.safe_load`
  gives on every preset under `configs/`, in value and in type (exactly:
  YAML 1.1 types `1.0e-6` as a float and a bare `1e-4` as a string), and
  on a document of edge cases; constructs outside the presets' subset
  raise.
- `parse_config` of every preset equals the JAX package's field by field:
  the matcher config, frontend, fusion, loop closure, system, LiDAR model
  and capacities, and `make_localization_config` on the localization
  presets. Floats equal exactly, arrays equal exactly and in dtype.
- `row_index` / `col_index` of every LiDAR model, "None" with overrides
  included, equal the JAX package's exactly on random points; an unknown
  type raises in both."""

import dataclasses
import glob
import math
import os

import numpy as np
import pytest
import torch
import yaml

from funny_lidar_slam_tpu import config as jconfig
from funny_lidar_slam_tpu.lidar import model as jmodel
from funny_lidar_slam_torch import config as tconfig
from funny_lidar_slam_torch.lidar import model as tmodel

torch.set_num_threads(1)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
PRESETS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*", "*.yaml")))
PRESET_IDS = [os.path.relpath(p, CONFIG_DIR) for p in PRESETS]


def same_yaml(a, b) -> bool:
    """Equal values of identical types (bool is not int, int is not float)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_yaml(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_yaml(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def fields_of(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return obj._asdict()


def assert_same_tree(t, j, path="cfg"):
    """The port's config object `t` equals the JAX one `j`: the same class
    name and fields, recursively, with exact scalars and arrays."""
    if dataclasses.is_dataclass(j) or hasattr(j, "_asdict"):
        assert type(t).__name__ == type(j).__name__, path
        ft, fj = fields_of(t), fields_of(j)
        assert list(ft) == list(fj), path
        for k in fj:
            assert_same_tree(ft[k], fj[k], f"{path}.{k}")
    elif isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray) and t.dtype == j.dtype, path
        np.testing.assert_array_equal(t, j, err_msg=path)
    elif isinstance(j, (tuple, list)):
        assert type(t) is type(j) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(j, dict):
        assert same_yaml(t, j), path
    else:
        assert type(t) is type(j) and t == j, f"{path}: {t!r} != {j!r}"


def test_every_preset_is_covered():
    assert len(PRESETS) == 18


@pytest.mark.parametrize("path", PRESETS, ids=PRESET_IDS)
def test_yaml_reader_matches_safe_load(path):
    text = open(path).read()
    assert same_yaml(tconfig.read_yaml(text), yaml.safe_load(text))


EDGE_DOC = """# leading comment
---
a: 1e-4
b: 1.0e-6
c: None
d: ~
e:
f: "x # not a comment"
g: 'it''s'
h: [1, -2., .5, 0x1F, 010, 1_000, 0b11, 1:30, 1:30.5, .inf, -.Inf, yes, Off, "q", [1, 2], ]
i: x#y   # comment
j:
    k:
        l: +12
    m: null
n: [ 1.,
     2e3,   # a comment inside the list
     -3.5e-05 ]
o: -0
p: 1.5e+3
q: 3.
r: .nan
s: True
"quoted key": 4
"""


def test_yaml_reader_edge_cases():
    assert same_yaml(tconfig.read_yaml(EDGE_DOC), yaml.safe_load(EDGE_DOC))
    assert tconfig.read_yaml("") is None and yaml.safe_load("") is None


@pytest.mark.parametrize("doc", [
    "- a\n- b\n", "a: {x: 1}\n", "a: &x 1\n", "a: *x\n", "a: !!str 1\n",
    "a: 1\n  b: 2\n", "a:\n  b: 1\n c: 2\n", "a: |\n  x\n", "a: [1, 2\n",
    "a: [1,, 2]\n", "just text\n",
], ids=["block-list", "flow-map", "anchor", "alias", "tag", "over-indent",
        "dedent", "literal", "unclosed-list", "empty-item", "no-key"])
def test_yaml_reader_raises_outside_subset(doc):
    with pytest.raises(ValueError):
        tconfig.read_yaml(doc)


@pytest.mark.parametrize("path", PRESETS, ids=PRESET_IDS)
def test_parse_config_matches_jax(path):
    t, j = tconfig.load_config(path), jconfig.load_config(path)
    assert_same_tree(t, j)
    if j.slam_mode == jconfig.MODE_LOCALIZATION:
        assert_same_tree(tconfig.make_localization_config(t),
                         jconfig.make_localization_config(j))


MODEL_TYPES = sorted(jmodel._MODELS) + ["None"]
NONE_OVERRIDES = dict(vertical_scan_num=16, horizon_scan_num=1800, v_res=math.radians(2.0),
                      lower_angle=math.radians(15.0), h_res=math.radians(0.2))


@pytest.mark.parametrize("lidar_type", MODEL_TYPES)
def test_lidar_model_matches_jax(lidar_type):
    kw = NONE_OVERRIDES if lidar_type == "None" else {}
    t, j = tmodel.make_lidar_model(lidar_type, **kw), jmodel.make_lidar_model(lidar_type, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.to_geometry(2.0, 80.0)._asdict() == j.to_geometry(2.0, 80.0)._asdict()
    if j.vertical_scan_num <= 0:
        return  # solid state: no ring structure to index
    rng = np.random.default_rng(len(lidar_type))
    pts = rng.normal(0.0, 20.0, (4096, 3)).astype(np.float32)
    pts[:8, 1] = 0.0  # azimuth 0 and pi: the wrap of col_index
    pts[:4, 0] = -np.abs(pts[:4, 0])
    np.testing.assert_array_equal(t.row_index(pts), j.row_index(pts))
    np.testing.assert_array_equal(t.col_index(pts), j.col_index(pts))
    assert t.col_index(pts).max() < j.horizon_scan_num


def test_unknown_lidar_type_raises():
    with pytest.raises(ValueError, match="Unsupported"):
        tmodel.make_lidar_model("Hesai_Pandar")
    with pytest.raises(ValueError, match="Unsupported"):
        jmodel.make_lidar_model("Hesai_Pandar")


def test_unknown_registration_mode_raises():
    doc = tconfig.read_yaml("frontend:\n  registration_and_searcher_mode: Gicp\n")
    with pytest.raises(ValueError, match="registration_and_searcher_mode"):
        tconfig.parse_config(doc)
