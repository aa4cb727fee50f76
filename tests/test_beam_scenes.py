"""Beam-structured synthetic Velodyne scans (data/synthetic.py).

The structural properties a real HDL-32 scan has and the uniform clutter
generator lacks: discrete elevation beams on the projector's
row comb, near-full ground occupancy in downward rows, sparse upper rows,
occlusion shadows behind objects, and range-dependent return dropout.
Reference geometry: `modules/lidar/process/extract_rosbag_lidar.py:18-77`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpufusion.config import RangeViewSpec
from tpufusion.data.synthetic import (
    synthesize_beam_multi_vehicle_batch,
    synthesize_beam_scan_batch,
    synthesize_beam_tracking_sequence,
)
from tpufusion.geometry.range_view import range_view_project_batch


@pytest.fixture(scope="module")
def scan():
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(0), 2, 32768
    )
    return np.asarray(pts), jax.tree.map(np.asarray, gt), np.asarray(valid)


def test_beam_elevation_comb(scan):
    """Every return sits on one of exactly n_beams discrete elevations
    spanning the projector VFOV (a 32-beam comb, not a uniform band)."""
    pts, _, valid = scan
    p = pts[0][valid[0]]
    elev = np.rad2deg(np.arctan2(p[:, 2], np.linalg.norm(p[:, :2], axis=1)))
    # ground-noise and surface-noise jitter elevation a hair; bin at 0.5 deg
    uniq = np.unique(np.round(elev * 2) / 2)
    assert 25 <= len(uniq) <= 40, uniq
    assert elev.min() > -31.0 and elev.max() < 11.0


def test_row_occupancy_profile(scan):
    """Downward rows are near their sampling-limited maximum occupancy
    (ground everywhere); upward rows are sparse (only tall clutter)."""
    pts, _, valid = scan
    spec = RangeViewSpec()
    img = np.asarray(
        range_view_project_batch(jnp.asarray(pts), spec, jnp.asarray(valid))
    )
    occ = (img[0, :, :, 0] > 0).mean(axis=1)
    # image rows are flipped (reference flipud): last rows = lowest beams
    assert occ[-4:].mean() > 0.35  # ground-dense (cap ~0.57 = 1024/1800)
    assert occ[:4].mean() < 0.15  # sky-pointing beams


def test_occlusion_shadow(scan):
    """No returns in the range interval behind the vehicle along its
    azimuth — nearest-hit raycasting produces real shadows."""
    pts, gt, valid = scan
    for i in range(2):
        c, y = gt["center"][i], gt["yaw"][i]
        cy, sy = np.cos(y), np.sin(y)
        spot = np.array([cy * c[0] - sy * c[1], sy * c[0] + cy * c[1]])
        d = np.linalg.norm(spot)
        a = np.arctan2(spot[1], spot[0])
        p = pts[i][valid[i]]
        paz = np.arctan2(p[:, 1], p[:, 0])
        pr = np.linalg.norm(p[:, :2], axis=1)
        near = np.abs((paz - a + np.pi) % (2 * np.pi) - np.pi) < 0.02
        on_vehicle = near & (np.abs(pr - d) < 2.6)
        behind = near & (pr > d + 5.0) & (pr < 55.0)
        assert on_vehicle.sum() >= 8, f"frame {i}: vehicle invisible"
        assert behind.sum() == 0, f"frame {i}: no shadow behind vehicle"


def test_valid_mask_and_parked_points(scan):
    """Invalid rays are parked at the origin with zero intensity and the
    valid fraction reflects hit rate x dropout (not 0, not 1)."""
    pts, _, valid = scan
    assert 0.3 < valid.mean() < 0.95
    parked = pts[~valid]
    np.testing.assert_array_equal(parked, np.zeros_like(parked))
    live = pts[valid]
    assert np.linalg.norm(live[:, :2], axis=1).min() > 0.4


def test_range_dependent_dropout():
    """Far returns drop more often than near ones."""
    pts, _, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(5), 4, 32768, dropout=0.5
    )
    pts0, _, valid0 = synthesize_beam_scan_batch(
        jax.random.PRNGKey(5), 4, 32768, dropout=0.0
    )
    pts0, valid0 = np.asarray(pts0), np.asarray(valid0)
    valid = np.asarray(valid)
    # same scene (same key): dropout removes returns, never adds
    assert valid.sum() < valid0.sum()
    r0 = np.linalg.norm(pts0[valid0][:, :2], axis=1)
    surv = valid[valid0]  # survival of each original return
    near_rate = surv[r0 < 15].mean()
    far_rate = surv[r0 > 40].mean()
    assert near_rate > far_rate + 0.05


def test_multi_vehicle_and_tracking_shapes():
    pts, gt, valid = synthesize_beam_multi_vehicle_batch(
        jax.random.PRNGKey(1), 3, 8192, n_vehicles=2
    )
    assert pts.shape == (3, 8192, 4) and valid.shape == (3, 8192)
    assert gt["center"].shape == (3, 2, 3)

    seq, sgt, svalid = synthesize_beam_tracking_sequence(
        jax.random.PRNGKey(2), 5, 8192, n_vehicles=2
    )
    assert seq.shape == (5, 8192, 4) and svalid.shape == (5, 8192)
    c = np.asarray(sgt["center"])
    step = np.linalg.norm(np.diff(c[:, 0, :2], axis=0), axis=1)
    assert (step < 0.3).all()  # constant-velocity, v <= 2*sqrt(2) m/s * 0.1 s


def test_ellipse_surface_yaw_observable():
    """vehicle_surface="ellipse" renders an oriented (l/2, w/2) ellipse:
    vehicle-return geometry must CHANGE with yaw (it is rotationally
    invariant for the default circle model, which is exactly why yaw was
    unobservable — NOTES.md round-2 session 3)."""
    import jax
    import jax.numpy as jnp

    from tpufusion.data.synthetic import _raycast_scene

    key = jax.random.PRNGKey(3)
    center = jnp.asarray([[[12.0, 0.0, -0.7]]])  # (1, 1, 3)
    size = jnp.asarray([[[4.8, 1.6, 1.5]]])  # long, narrow

    def veh_pts(surface, yaw):
        pts, valid = _raycast_scene(
            key, 1, 32, 256, center, size, 60.0, 0, 0.0,
            vehicle_surface=surface, yaws=jnp.asarray([[yaw]]),
        )
        p = np.asarray(pts[0])[np.asarray(valid[0])]
        # vehicle returns only (intensity >= 30 marks vehicle hits)
        return p[p[:, 3] >= 30.0]

    # at bearing 0, yaw=0 points the LENGTH down the line of sight (the
    # sensor sees the narrow front) while yaw=pi/2 lays the length across
    # the view (broadside) — so broadside must span far more azimuth
    head_on = veh_pts("ellipse", 0.0)
    broadside = veh_pts("ellipse", np.pi / 2)
    assert len(head_on) > 0 and len(broadside) > 0
    span = lambda p: np.ptp(np.arctan2(p[:, 1], p[:, 0]))
    assert span(broadside) > span(head_on) * 1.5

    # the circle model is yaw-invariant: identical clouds for any yaw
    c0 = veh_pts("circle", 0.0)
    c1 = veh_pts("circle", np.pi / 2)
    np.testing.assert_allclose(c0, c1, atol=1e-5)

    # l == w ellipse behaves like a circle of the same radius: same
    # azimuth span of vehicle returns
    sq = jnp.asarray([[[1.8, 1.8, 1.5]]])
    pts_e, valid_e = _raycast_scene(
        key, 1, 32, 256, center, sq, 60.0, 0, 0.0,
        vehicle_surface="ellipse", yaws=jnp.asarray([[0.7]]),
    )
    pe = np.asarray(pts_e[0])[np.asarray(valid_e[0])]
    pe = pe[pe[:, 3] >= 30.0]
    assert len(pe) > 0
    # entry distances sit on/near the r=0.81 scaled ellipse around 12 m
    d = np.linalg.norm(pe[:, :2], axis=1)
    assert (d > 10.5).all() and (d < 12.1).all()


def test_oriented_tracking_sequence():
    """oriented=True: per-vehicle yaw is constant, equals the velocity
    heading, the gt stays in the orbit convention (physical center =
    Rz(yaw) @ center follows a constant-velocity path), and vehicle
    returns land near the physical position, not the orbit tuple."""
    seq, gt, valid = synthesize_beam_tracking_sequence(
        jax.random.PRNGKey(9), 6, 8192, n_vehicles=2, oriented=True
    )
    yaw = np.asarray(gt["yaw"])  # (F, V)
    c = np.asarray(gt["center"])  # (F, V, 3) orbit tuples
    assert seq.shape == (6, 8192, 4)
    # constant heading per vehicle
    np.testing.assert_allclose(yaw, np.broadcast_to(yaw[0], yaw.shape), atol=1e-6)

    # physical path: Rz(yaw) @ center, constant velocity
    cy, sy = np.cos(yaw), np.sin(yaw)
    phys = np.stack(
        [cy * c[..., 0] - sy * c[..., 1],
         sy * c[..., 0] + cy * c[..., 1]], axis=-1,
    )  # (F, V, 2)
    steps = np.diff(phys, axis=0)  # (F-1, V, 2)
    np.testing.assert_allclose(steps, np.broadcast_to(steps[0], steps.shape), atol=1e-4)
    speed = np.linalg.norm(steps[0], axis=-1)
    # heading equals the velocity direction for moving vehicles
    for vi in range(2):
        if speed[vi] > 0.02:
            want = np.arctan2(steps[0, vi, 1], steps[0, vi, 0])
            d = (yaw[0, vi] - want + np.pi) % (2 * np.pi) - np.pi
            assert abs(d) < 1e-4, (yaw[0, vi], want)

    # vehicle returns (intensity >= 30 marks vehicle hits in the
    # ray-cast) cluster near the PHYSICAL position of each vehicle
    p0 = np.asarray(seq[0])[np.asarray(valid[0])]
    veh = p0[p0[:, 3] >= 30.0]
    assert len(veh) > 0
    d0 = np.linalg.norm(veh[None, :, :2] - phys[0][:, None], axis=-1)
    assert (d0.min(axis=1) < 3.5).any(), d0.min(axis=1)
