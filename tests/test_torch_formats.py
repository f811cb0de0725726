"""Port parity: the bag, message and point-format readers and the host C++
filters of funny_lidar_slam_torch against the JAX package.

- `bag_export.dataset_to_bag` of the same dataset gives byte-identical bags
  in both packages, and each package's `read_bag` reads the other's bag
  into the same event stream (every value exactly equal).
- Imu, PointCloud2 and Livox CustomMsg round trips, and each serializer
  gives the JAX package's bytes; a Livox bag replays into the same scans.
- Every `convert_*` (through the `convert` dispatch),
  `compute_point_offset_time` and `range_and_jump_filter` equal the JAX
  package's exactly.
- The port's `native` (its copy of the g++ library) equals the JAX
  package's `native` bit for bit, in values and order."""

import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu import native as jnative
from funny_lidar_slam_tpu.io import bag_export as jexport
from funny_lidar_slam_tpu.io import bag_format as jbag
from funny_lidar_slam_tpu.io import formats as jformats
from funny_lidar_slam_tpu.io import pointcloud2 as jpc2
from funny_lidar_slam_tpu.io import rosbag as jrosbag
from funny_lidar_slam_tpu.lidar import model as jmodel
from funny_lidar_slam_tpu.pipeline import preprocess as jpre
from funny_lidar_slam_torch import native as tnative
from funny_lidar_slam_torch.io import bag_export as texport
from funny_lidar_slam_torch.io import bag_format as tbag
from funny_lidar_slam_torch.io import formats as tformats
from funny_lidar_slam_torch.io import pointcloud2 as tpc2
from funny_lidar_slam_torch.io import rosbag as trosbag
from funny_lidar_slam_torch.io.pcd import voxel_downsample_np
from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
from funny_lidar_slam_torch.lidar import model as tmodel
from funny_lidar_slam_torch.pipeline import preprocess as tpre

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset():
    return simulate(SimConfig(duration=4.0, points_per_scan=2048, seed=5))


@pytest.fixture(scope="module")
def bags(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("bags")
    paths = {"jax": str(d / "jax.bag"), "torch": str(d / "torch.bag")}
    jexport.dataset_to_bag(dataset, paths["jax"], lidar_topic="/points", imu_topic="/imu")
    texport.dataset_to_bag(dataset, paths["torch"], lidar_topic="/points", imu_topic="/imu")
    return paths


def assert_same_event(a, b):
    assert a[0] == b[0]
    if a[0] == "imu":
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
        assert (a[4] is None) == (b[4] is None)
        if a[4] is not None:
            np.testing.assert_array_equal(a[4], b[4])
    else:
        assert_same_scan(a[1], b[1])


def assert_same_scan(t, j):
    assert t.stamp == j.stamp
    for name in ("points", "intensity", "ring", "rel_times"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_bag_export_bytes_identical(dataset, bags):
    with open(bags["jax"], "rb") as f, open(bags["torch"], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_bag(dataset, bags, writer):
    args = ("/points", "/imu", "Velodyne_16")
    tev = list(trosbag.read_bag(bags[writer], *args))
    jev = list(jrosbag.read_bag(bags[writer], *args))
    assert len(tev) == len(jev) == len(dataset.imu_t) + len(dataset.scans)
    for a, b in zip(tev, jev):
        assert_same_event(a, b)
    scans = [e[1] for e in tev if e[0] == "scan"]
    np.testing.assert_array_equal(scans[0].points, dataset.scans[0].points)


def test_bag_records_read_back(bags):
    conns = {}
    for m in tbag.BagReader(bags["jax"]).messages():
        conns.setdefault(m.topic, m.msgtype)
    assert conns == {"/imu": "sensor_msgs/Imu", "/points": "sensor_msgs/PointCloud2"}
    only_imu = list(tbag.BagReader(bags["torch"]).messages(topics={"/imu"}))
    assert only_imu and all(m.topic == "/imu" for m in only_imu)


@pytest.mark.parametrize("quat", [None, np.array([0.9, 0.1, -0.2, 0.3])])
def test_imu_roundtrip(quat):
    msg = tbag.ImuMsg(1234.5678, quat, np.array([0.01, -0.02, 0.03]),
                      np.array([0.1, 0.2, 9.8]))
    raw = tbag.serialize_imu(msg)
    assert raw == jbag.serialize_imu(jbag.ImuMsg(msg.stamp, quat, msg.gyro, msg.accel))
    out = tbag.deserialize_imu(raw)
    assert abs(out.stamp - msg.stamp) < 1e-6
    np.testing.assert_array_equal(out.gyro, msg.gyro)
    np.testing.assert_array_equal(out.accel, msg.accel)
    if quat is None:
        assert out.quat is None
    else:
        np.testing.assert_array_equal(out.quat, quat)


def test_pointcloud2_roundtrip():
    arr = np.zeros(7, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                ("intensity", "<f4"), ("ring", "<u2"), ("time", "<f4"),
                                ("t", "<u4"), ("timestamp", "<f8")]))
    rng = np.random.default_rng(1)
    for name in ("x", "y", "z", "intensity", "time", "timestamp"):
        arr[name] = rng.normal(size=7)
    arr["ring"] = np.arange(7)
    arr["t"] = rng.integers(0, 10**8, 7)
    msg = tbag.pointcloud2_from_structured(arr, 42.25)
    raw = tbag.serialize_pointcloud2(msg)
    assert raw == jbag.serialize_pointcloud2(jbag.pointcloud2_from_structured(arr, 42.25))
    out = tbag.deserialize_pointcloud2(raw)
    assert out.stamp == 42.25 and out.width == 7 and out.point_step == arr.dtype.itemsize
    dec = tpc2.decode(out.fields, out.point_step, out.data)
    jdec = jpc2.decode(out.fields, out.point_step, out.data)
    assert dec.dtype == jdec.dtype
    for name in arr.dtype.names:
        np.testing.assert_array_equal(dec[name], arr[name])
    big = tpc2.decode([tpc2.PointField("x", 0, 7)], 4, np.float32([1.5]).byteswap().tobytes(),
                      is_bigendian=True)
    assert big["x"][0] == 1.5


def livox_points(n, seed):
    rng = np.random.default_rng(seed)
    pts = np.zeros(n, tbag._LIVOX_POINT)
    pts["offset_time"] = np.sort(rng.integers(0, 10**8, n))
    pts["x"], pts["y"], pts["z"] = rng.normal(0, 10, (3, n))
    pts["reflectivity"] = rng.integers(0, 256, n)
    pts["tag"] = rng.choice([0x00, 0x10, 0x20, 0x30], n)
    pts["line"] = rng.integers(0, 8, n)
    return pts


def test_livox_roundtrip():
    pts = livox_points(300, 2)
    msg = tbag.LivoxCustomMsg(10.5, 123456789, pts)
    raw = tbag.serialize_livox(msg)
    assert raw == jbag.serialize_livox(jbag.LivoxCustomMsg(10.5, 123456789, pts))
    out = tbag.deserialize_livox(raw)
    jout = jbag.deserialize_livox(raw)
    assert out.stamp == pytest.approx(10.5) and out.timebase == 123456789
    assert out.points.dtype == jout.points.dtype
    np.testing.assert_array_equal(out.points, pts)
    np.testing.assert_array_equal(out.points, jout.points)


def test_livox_bag_replays_alike(tmp_path):
    path = str(tmp_path / "livox.bag")
    w = tbag.BagWriter(path)
    w.add_connection("/livox/lidar", "livox_ros_driver/CustomMsg")
    w.add_connection("/livox/imu", "sensor_msgs/Imu")
    for k in range(3):
        t = 1.0 + 0.1 * k
        w.write("/livox/imu", t, tbag.serialize_imu(
            tbag.ImuMsg(t, None, np.zeros(3), np.array([0.0, 0.0, 9.81]))))
        w.write("/livox/lidar", t, tbag.serialize_livox(
            tbag.LivoxCustomMsg(t, 0, livox_points(200, k))))
    w.close()
    args = (path, "/livox/lidar", "/livox/imu", "Livox_Avia", 1e-9)
    tev, jev = list(trosbag.read_bag(*args)), list(jrosbag.read_bag(*args))
    assert len(tev) == len(jev) == 6
    for a, b in zip(tev, jev):
        assert_same_event(a, b)
    assert 0 < len(tev[1][1].points) < 200  # the line and tag filter dropped some


# -- vendor formats -----------------------------------------------------------

F4, U1, U2, U4, F8 = "<f4", "u1", "<u2", "<u4", "<f8"
XYZI = [("x", F4), ("y", F4), ("z", F4), ("intensity", F4)]
VENDORS = {
    "Velodyne_16": XYZI + [("ring", U2), ("time", F4)],
    "Velodyne_32": XYZI + [("ring", U2), ("time", F4)],
    "Velodyne_64": XYZI + [("ring", U2), ("time", F4)],
    "Ouster_128_os1": XYZI + [("ring", U2), ("t", U4)],
    "LeiShen_16": XYZI + [("ring", U2), ("timestamp", F8)],
    "RoboSense_16": XYZI + [("ring", U2), ("timestamp", F8)],
    "Livox_Mid_360": XYZI + [("timestamp", F8)],
    "Livox_Avia": XYZI + [("line", U1), ("tag", U1), ("time", F8)],
    "None": XYZI,
}
TIME_SCALE = {"Ouster_128_os1": 1e-9, "Livox_Avia": 1e-9}


def vendor_array(lidar_type, n=2000, seed=0, zero_time=False):
    """A clockwise multi-ring sweep with NaN points, in the vendor's layout."""
    rng = np.random.default_rng(seed)
    arr = np.zeros(n, np.dtype(VENDORS[lidar_type]))
    yaw = -np.linspace(0.0, 2.2 * np.pi, n) + rng.normal(0, 1e-3, n)
    r = rng.uniform(1.0, 60.0, n)
    elev = np.radians(rng.uniform(-16.0, 16.0, n))
    arr["x"], arr["y"] = r * np.cos(elev) * np.cos(yaw), r * np.cos(elev) * np.sin(yaw)
    arr["z"] = r * np.sin(elev)
    arr["x"][rng.choice(n, 7, replace=False)] = np.nan
    arr["intensity"] = rng.uniform(0, 255, n)
    names = arr.dtype.names
    if "ring" in names:
        arr["ring"] = rng.integers(0, 16, n)
    if "time" in names:
        arr["time"] = 0.0 if zero_time else np.linspace(0.0, 0.1, n) * (1e9 if lidar_type == "Livox_Avia" else 1.0)
    if "t" in names:
        arr["t"] = np.linspace(0, 1e8, n).astype(np.uint32)
    if "timestamp" in names:
        arr["timestamp"] = 1.7e9 + np.linspace(0.0, 0.1, n)
    if "line" in names:
        arr["line"] = rng.integers(0, 8, n)
        arr["tag"] = rng.choice([0x00, 0x10, 0x20, 0x30], n)
    return arr


@pytest.mark.parametrize("lidar_type", sorted(VENDORS))
def test_convert_matches_jax(lidar_type):
    arr = vendor_array(lidar_type, seed=len(lidar_type))
    kw = {}
    if lidar_type == "None":
        over = dict(vertical_scan_num=16, horizon_scan_num=1800, v_res=np.radians(2.0),
                    lower_angle=np.radians(15.0), h_res=np.radians(0.2))
        kw = dict(t=tmodel.make_lidar_model("None", **over),
                  j=jmodel.make_lidar_model("None", **over))
    elif lidar_type.startswith("Velodyne"):
        kw = dict(t=tmodel.make_lidar_model(lidar_type), j=jmodel.make_lidar_model(lidar_type))
    scale = TIME_SCALE.get(lidar_type, 1.0)
    t = tformats.convert(lidar_type, arr, 100.0, scale, kw.get("t"), 10.0)
    j = jformats.convert(lidar_type, arr, 100.0, scale, kw.get("j"), 10.0)
    assert_same_scan(t, j)
    assert t.min_max_offset == j.min_max_offset
    assert 0 < len(t.points) < len(arr)


@pytest.mark.parametrize("lidar_type", ["Velodyne_16", "Velodyne_32"])
def test_convert_synthesized_offsets_match_jax(lidar_type):
    """A last offset <= 0 makes both synthesize offsets from yaw."""
    arr = vendor_array(lidar_type, seed=3, zero_time=True)
    t = tformats.convert(lidar_type, arr, 5.0, 1.0, tmodel.make_lidar_model(lidar_type))
    j = jformats.convert(lidar_type, arr, 5.0, 1.0, jmodel.make_lidar_model(lidar_type))
    assert_same_scan(t, j)
    assert t.rel_times.max() > 0.0


def test_compute_point_offset_time_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 10, (3000, 3)).astype(np.float32)
    ring = rng.integers(0, 16, 3000).astype(np.int32)
    a = tformats.compute_point_offset_time(pts, ring, 16, 10.0)
    np.testing.assert_array_equal(a, jformats.compute_point_offset_time(pts, ring, 16, 10.0))


def test_convert_unknown_type_raises():
    arr = vendor_array("Velodyne_16")
    for fmt in (tformats, jformats):
        with pytest.raises(ValueError, match="Not support"):
            fmt.convert("Hesai_Pandar", arr, 0.0)
        with pytest.raises(ValueError, match="explicit LidarModel"):
            fmt.convert("None", arr, 0.0)


@pytest.mark.parametrize("span", [1, 3, 6])
def test_range_and_jump_filter_matches_jax(span):
    scan_t = tformats.convert("Velodyne_16", vendor_array("Velodyne_16", seed=9), 1.0)
    scan_j = jformats.convert("Velodyne_16", vendor_array("Velodyne_16", seed=9), 1.0)
    t = tpre.range_and_jump_filter(scan_t, 2.0, 50.0, span)
    j = jpre.range_and_jump_filter(scan_j, 2.0, 50.0, span)
    assert_same_scan(t, j)
    assert len(t.points) < len(scan_t.points)


# -- host C++ filters ------------------------------------------------------------


def cloud(n, seed, extent=30.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-extent, extent, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("voxel,cap", [(0.3, None), (1.0, None), (2.5, 500), (0.0, 100)])
def test_native_voxel_downsample_matches_jax(voxel, cap):
    assert jnative.available() and tnative.available()
    pts = np.concatenate([cloud(40000, 1), cloud(20000, 2, 3.0)])
    t = tnative.voxel_downsample(pts, voxel, cap)
    j = jnative.voxel_downsample(pts, voxel, cap)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    if voxel > 0 and cap is None:
        # the same centroids as the plain version, in the hash map's order
        key = lambda a: a[np.lexsort(np.floor(a / voxel).astype(np.int64).T[::-1])]
        np.testing.assert_allclose(key(t), key(voxel_downsample_np(pts, voxel)),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_rel", [True, False])
def test_native_filter_pad_matches_jax(with_rel):
    pts = cloud(5000, 3)
    rel = np.linspace(0, 0.1, 5000).astype(np.float32) if with_rel else None
    t = tnative.filter_pad(pts, rel, 2.0, 25.0, 3, 4096)
    j = jnative.filter_pad(pts, rel, 2.0, 25.0, 3, 4096)
    assert t[3] == j[3] > 0
    for a, b in zip(t[:3], j[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
