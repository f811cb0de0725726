"""Port parity: the LOAM feature front end (loam/projection.py and
loam/features.py) of funny_lidar_slam_torch against the JAX package, on the
same NumPy inputs; and the port's mirrors of tests/test_loam.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_tpu.io.simulator import SimConfig, simulate
from funny_lidar_slam_tpu.loam import features as jfeat
from funny_lidar_slam_tpu.loam import projection as jproj
from funny_lidar_slam_torch import convert
from funny_lidar_slam_torch.loam import features as tfeat
from funny_lidar_slam_torch.loam import projection as tproj

torch.set_num_threads(1)

# the bench's geometry (bench.py:299-301)
BENCH = dict(n_rows=16, n_cols=900, horizontal_resolution=2 * np.pi / 900,
             min_distance=1.5, max_distance=50.0)
GEOM_T = tproj.LidarGeometry(**BENCH)
GEOM_J = jproj.LidarGeometry(**BENCH)
CAP = 4096
# a point whose azimuth lies this close to a column boundary may round to
# either column: arctan2 may differ by an ulp between the two packages
BOUNDARY_RAD = 1e-5


@pytest.fixture(scope="module")
def scans():
    ds = simulate(SimConfig(duration=5.0, points_per_scan=CAP, seed=5))
    return [ds.scans[k] for k in (3, 12, 20)]


def padded(scan, cap=CAP):
    pts = np.zeros((cap, 3), np.float32)
    rts = np.zeros(cap, np.float32)
    n = min(len(scan.points), cap)
    pts[:n], rts[:n] = scan.points[:n], scan.rel_times[:n]
    return pts, rts, np.arange(cap) < n


def near_boundary(pts, res):
    """Points whose azimuth is within BOUNDARY_RAD of a column boundary."""
    az = np.arctan2(pts[:, 1].astype(np.float64), pts[:, 0].astype(np.float64)) / res
    return np.abs(az - np.floor(az) - 0.5) * res < BOUNDARY_RAD


def both_project(pts, rts, mask, ring=None, geom=(GEOM_J, GEOM_T)):
    if ring is None:
        ring = np.array(jproj.synth_rings(jnp.asarray(pts), geom[0].n_rows))
    sj = jproj.project(jnp.asarray(pts), jnp.asarray(ring), jnp.asarray(rts),
                       jnp.asarray(mask), geom[0])
    st = tproj.project(torch.as_tensor(pts), torch.as_tensor(ring), torch.as_tensor(rts),
                       torch.as_tensor(mask), geom[1])
    return sj, st


def assert_same_scan(st, sj):
    for f in tproj.OrderedScan._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)


def test_synth_rings_matches_jax(scans):
    """Ring ids from the elevation: equal but for points within 1e-5 rad of
    a ring boundary (at most 0.1 % of them)."""
    for scan in scans:
        pts, _, _ = padded(scan)
        rj = np.asarray(jproj.synth_rings(jnp.asarray(pts), 16))
        rt = tproj.synth_rings(torch.as_tensor(pts), 16).numpy()
        diff = rj != rt
        elev = np.degrees(np.arctan2(pts[:, 2], np.linalg.norm(pts[:, :2], axis=1)))
        step = 40.0 / 16
        edge = np.abs((elev + 25.0) / step - np.round((elev + 25.0) / step)) * step
        assert (edge[diff] < np.degrees(BOUNDARY_RAD)).all()
        assert diff.sum() <= CAP // 1000


def test_project_matches_jax_away_from_boundaries(scans):
    """With every point near a column boundary masked out, the packed scan
    equals the JAX one slot for slot (the stable compaction sort)."""
    for scan in scans:
        pts, rts, mask = padded(scan)
        mask &= ~near_boundary(pts, GEOM_T.horizontal_resolution)
        sj, st = both_project(pts, rts, mask)
        assert int(st.mask.sum()) > CAP // 2
        assert_same_scan(st, sj)


def test_project_boundary_points_counted(scans):
    """On the whole scan the two packages may put a boundary point in the
    neighbouring column. The test counts those points (fewer than 0.5 % of
    the scan) and checks that every cell whose winner differs lies on a
    boundary point's ring, within one column of it."""
    for scan in scans:
        pts, rts, mask = padded(scan)
        ring = np.array(jproj.synth_rings(jnp.asarray(pts), 16))
        edge = near_boundary(pts, GEOM_T.horizontal_resolution) & mask
        assert edge.sum() <= CAP // 200
        sj, st = both_project(pts, rts, mask, ring)

        def winners(s):
            m = np.asarray(s.mask)
            cells = np.asarray(s.row)[m] * 900 + np.asarray(s.col)[m]
            return dict(zip(cells.tolist(), map(tuple, np.asarray(s.points)[m])))

        wj, wt = winners(sj), winners(st)
        differ = {c for c in wj.keys() | wt.keys() if wj.get(c) != wt.get(c)}
        az = np.arctan2(pts[edge, 1], pts[edge, 0]) / GEOM_T.horizontal_resolution
        near = set()
        for r, a in zip(ring[edge], az):
            for c in (np.floor(a), np.ceil(a)):
                near.add(int(r) * 900 + (int(c) + 450) % 900)
        assert differ <= near, sorted(differ - near)[:5]
        if not edge.any():
            assert_same_scan(st, sj)


@pytest.mark.parametrize("cfg", [{}, {"corner_threshold": 0.1, "max_corners_per_block": 5}])
def test_extract_features_matches_jax(scans, cfg):
    """extract_features fed the JAX OrderedScan carried across: the corner
    and planar clouds equal exactly (masks and points)."""
    fcfg = dict(corner_capacity=512, planar_capacity=CAP, **cfg)
    n_corners = 0
    for scan in scans:
        pts, rts, mask = padded(scan)
        sj, _ = both_project(pts, rts, mask)
        cj, pj = jfeat.extract_features(sj, jfeat.FeatureConfig(**fcfg))
        ct, pt = tfeat.extract_features(convert.ordered_scan(sj), tfeat.FeatureConfig(**fcfg))
        for t, j in ((ct, cj), (pt, pj)):
            np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
            np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
        n_corners += int(ct.mask.sum())
    assert n_corners > 0


def test_roughness_and_valid_marks_match_jax(scans):
    """compute_roughness to 1e-5 relative, mark_valid exactly."""
    pts, rts, mask = padded(scans[1])
    sj, _ = both_project(pts, rts, mask)
    st = convert.ordered_scan(sj)
    np.testing.assert_allclose(tfeat.compute_roughness(st).numpy(),
                               np.asarray(jfeat.compute_roughness(sj)), rtol=1e-5, atol=1e-5)
    cfg_t, cfg_j = tfeat.FeatureConfig(), jfeat.FeatureConfig()
    np.testing.assert_array_equal(tfeat.mark_valid(st, cfg_t).numpy(),
                                  np.asarray(jfeat.mark_valid(sj, cfg_j)))


# --- mirrors of tests/test_loam.py on the port ---------------------------

GEOM = tproj.LidarGeometry(n_rows=8, n_cols=360, horizontal_resolution=2 * np.pi / 360,
                           min_distance=1.0, max_distance=50.0)


def spinning_scan(geom, far_wall=False):
    """Rings scanning a corridor corner (walls x=8 and y=8), or, with
    `far_wall`, a wall at x=8 below 30 deg and a far wall beyond it."""
    pts, rings, times = [], [], []
    for ring in range(8):
        elev = np.deg2rad(-10 + 2.5 * ring)
        for c in range(geom.n_cols):
            az = (c - geom.n_cols // 2) * geom.horizontal_resolution
            if az <= 0.02 or az >= np.pi / 2 - 0.02:
                continue
            if far_wall:
                d = 8.0 / np.cos(az) if az < np.deg2rad(30) else 30.0 / np.cos(az - np.deg2rad(30))
                t = 0.0
            else:
                d = min(8.0 / np.cos(az), 8.0 / np.sin(az))
                t = c / geom.n_cols * 0.1
            pts.append([d * np.cos(az), d * np.sin(az), d * np.tan(elev)])
            rings.append(ring)
            times.append(t)
    return (np.asarray(pts, np.float32), np.asarray(rings, np.int32),
            np.asarray(times, np.float32))


def project_t(pts, rings, times):
    return tproj.project(torch.as_tensor(pts), torch.as_tensor(rings), torch.as_tensor(times),
                         torch.ones(len(pts), dtype=torch.bool), GEOM)


def test_projection_rows_and_cols():
    pts, rings, times = spinning_scan(GEOM)
    scan = project_t(pts, rings, times)
    m = scan.mask.numpy()
    assert m.sum() == len(pts)  # distinct cells, all kept
    rs, re = scan.row_start.numpy(), scan.row_end.numpy()
    assert (re >= rs).all() and (re - rs).sum() == len(pts)
    assert (np.diff(scan.row.numpy()[m]) >= 0).all()
    p = scan.points.numpy()[m]
    assert np.allclose(scan.depth.numpy()[m], np.linalg.norm(p, axis=1), atol=1e-5)


def test_projection_first_point_wins():
    pts = np.asarray([[5.0, 0.001, 0.0], [6.0, 0.001, 0.0]], np.float32)
    scan = project_t(pts, np.zeros(2, np.int32), np.asarray([0.0, 0.01], np.float32))
    m = scan.mask.numpy()
    assert m.sum() == 1
    assert np.allclose(scan.points.numpy()[m][0], pts[0])


def test_roughness_edge_vs_plane():
    scan = project_t(*spinning_scan(GEOM))
    rough = tfeat.compute_roughness(scan).numpy()
    p = scan.points.numpy()
    az = np.arctan2(p[:, 1], p[:, 0])
    flat = scan.mask.numpy() & (np.abs(az - np.deg2rad(20)) < np.deg2rad(5))
    assert np.median(rough[flat]) < 0.1


def test_extract_features_discontinuity():
    scan = project_t(*spinning_scan(GEOM, far_wall=True))
    cfg = tfeat.FeatureConfig(corner_threshold=1.0, corner_capacity=512, planar_capacity=4096)
    corner, planar = tfeat.extract_features(scan, cfg)
    c_pts = corner.points.numpy()[corner.mask.numpy()]
    p_pts = planar.points.numpy()[planar.mask.numpy()]
    assert len(p_pts) > len(c_pts) * 5
    assert len(c_pts) >= 4
    az_c = np.degrees(np.arctan2(c_pts[:, 1], c_pts[:, 0]))
    assert (np.abs(az_c - 30.0) < 5.0).mean() > 0.5, az_c
