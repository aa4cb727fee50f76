"""Decode pipeline vs the NumPy oracle of predict.py semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufusion.config import DecodeConfig, RangeViewSpec
from tpufusion.decode import (
    find_obstacle,
    back_project_2d_to_3d,
    decode_frame,
)
from tpufusion.geometry.range_view import range_view_project
from tpufusion.geometry import encoding

from tests.conftest import synthetic_cloud
from tests.oracle import reference_numpy as oracle

SPEC = RangeViewSpec()
CFG = DecodeConfig()


def _perfect_prediction(cloud, center, size, yaw):
    """Network output that matches the encoded ground truth exactly."""
    img = np.asarray(range_view_project(jnp.asarray(cloud), SPEC))
    lbl = np.asarray(
        encoding.encode_label(
            jnp.asarray(center, jnp.float32),
            jnp.asarray(size, jnp.float32),
            jnp.asarray(yaw, jnp.float32),
            jnp.asarray(img),
            SPEC,
        )
    )
    return img, lbl


def _blob_prob_map(rng, n_blobs=3):
    prob = np.zeros((SPEC.height, SPEC.width), dtype=np.float32)
    for _ in range(n_blobs):
        r0 = rng.integers(2, SPEC.height - 8)
        c0 = rng.integers(2, SPEC.width - 40)
        h = rng.integers(4, 10)
        w = rng.integers(8, 40)
        prob[r0 : r0 + h, c0 : c0 + w] = 0.9
    return prob


def test_find_obstacle_matches_oracle(rng):
    for trial in range(5):
        prob = _blob_prob_map(rng, n_blobs=trial % 3 + 1)
        want_c, want_b, want_a = oracle.find_obstacle(prob)
        got_c, got_b, got_a, found = find_obstacle(jnp.asarray(prob), CFG)
        got_c, got_b = np.asarray(got_c), np.asarray(got_b)
        if want_c is None:
            assert not bool(found)
            continue
        assert bool(found)
        assert tuple(got_c) == want_c
        assert (got_b[0], got_b[1]) == want_b[0]
        assert (got_b[2], got_b[3]) == want_b[1]
        assert float(got_a) == want_a


def test_find_obstacle_empty():
    prob = jnp.zeros((SPEC.height, SPEC.width))
    _, _, _, found = find_obstacle(prob, CFG)
    assert not bool(found)


def test_find_obstacle_small_blob_rejected():
    prob = np.zeros((SPEC.height, SPEC.width), dtype=np.float32)
    prob[10:14, 100:106] = 1.0  # tiny: area below min_bbox_area
    want = oracle.find_obstacle(prob)
    _, _, _, found = find_obstacle(jnp.asarray(prob), CFG)
    assert want[0] is None and not bool(found)


def test_back_project_matches_oracle(rng, cloud):
    img = np.asarray(range_view_project(jnp.asarray(cloud), SPEC))
    dist, hgt = img[..., 0], img[..., 1]
    for _ in range(10):
        cx = int(rng.integers(5, SPEC.width - 5))
        cy = int(rng.integers(2, SPEC.height - 2))
        bbox = (
            max(cx - 20, 1),
            max(cy - 4, 0),
            min(cx + 20, SPEC.width - 1),
            min(cy + 4, SPEC.height - 1),
        )
        want, _ = oracle.back_project((cx, cy), bbox, dist, hgt)
        got, _, _ = back_project_2d_to_3d(
            jnp.asarray([cx, cy], jnp.int32),
            jnp.asarray(bbox, jnp.int32),
            jnp.asarray(dist),
            jnp.asarray(hgt),
            SPEC,
            CFG,
        )
        np.testing.assert_allclose(np.asarray(got), want[:3], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vehicle", [(10.0, -3.0, -0.7), (-14.0, 6.0, -0.8)])
def test_decode_frame_recovers_pose(rng, vehicle):
    """End-to-end: perfect predictions on a synthetic scene must decode to a
    pose near the true vehicle center (and match the oracle decode)."""
    size = (4.2, 1.6, 1.5)
    yaw = 0.3  # nonzero: at yaw=0 the reference's atan2(dy~0, dx) is noise
    # the reference corner convention rotates the box about the sensor origin
    # (encoder.py:47-60), so physical returns must sit at the rotated spot
    c, s = np.cos(yaw), np.sin(yaw)
    spot = (
        c * vehicle[0] - s * vehicle[1],
        s * vehicle[0] + c * vehicle[1],
        vehicle[2],
    )
    cloud = synthetic_cloud(rng, n=6000, with_vehicle_at=spot)
    img, lbl = _perfect_prediction(cloud, np.array(vehicle), np.array(size), yaw)

    out = decode_frame(jnp.asarray(lbl), jnp.asarray(img), SPEC, CFG)
    assert bool(out["found"])
    pose = np.asarray(out["pose"])

    # oracle pipeline on the same inputs
    want_c, want_b, _ = oracle.find_obstacle(lbl[..., 1])
    assert want_c is not None
    want_xyz, _ = oracle.back_project(
        want_c,
        (want_b[0][0], want_b[0][1], want_b[1][0], want_b[1][1]),
        img[..., 0],
        img[..., 1],
    )
    want_pose, _ = oracle.find_bbox_3d(
        img[..., 0],
        img[..., 1],
        lbl.reshape(-1, 26),
        want_b,
        want_xyz[:3],
    )
    np.testing.assert_allclose(
        np.delete(pose, 3), np.delete(want_pose, 3), rtol=1e-3, atol=5e-3
    )
    # yaw: atan2(dy~0, dx<0) flips between +/-pi on float noise and the
    # reference averages raw angles; a box is invariant under yaw+pi, so
    # compare modulo pi with circular distance
    dyaw = (pose[3] - want_pose[3]) % np.pi
    assert min(dyaw, np.pi - dyaw) < 5e-3

    # and the pose should be physically near the (rotated) truth
    assert np.linalg.norm(pose[:3] - np.array(spot)) < 1.5


def test_direct_head_codec_round_trip():
    """Perfect direct-head labels through the direct decode recover the
    exact pose — the direct analogue of the corner codec's encode/decode
    inverse pair (framework extension, ModelConfig.head="direct")."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_points_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt = synthesize_points_batch(
        jax.random.PRNGKey(5), 4, 16384, max_yaw=0.4
    )
    imgs = range_view_project_batch(pts, spec)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(cfg.decode, min_bbox_area=20.0)
    out = decode_batch_direct(labels, imgs, spec, dcfg, 1, center="head")
    po = np.asarray(out["poses"])[:, 0]
    fd = np.asarray(out["found"])[:, 0]
    c = np.asarray(gt["center"])
    assert fd.all()
    np.testing.assert_allclose(po[:, :3], c, atol=1e-3)
    np.testing.assert_allclose(po[:, 3], np.asarray(gt["yaw"]), atol=1e-3)
    np.testing.assert_allclose(po[:, 4:7], np.asarray(gt["size"]), atol=1e-3)


def test_direct_head_top_k_two_vehicles():
    """Direct decode returns both vehicles of a two-cluster scene."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_multi_vehicle_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt = synthesize_multi_vehicle_batch(jax.random.PRNGKey(3), 1, 16384, 2)
    imgs = range_view_project_batch(pts, spec)
    # merge per-vehicle labels: take the vehicle whose footprint owns the px
    labs = [
        np.asarray(
            encode_direct_label_batch(
                gt["center"][:, v], gt["size"][:, v], gt["yaw"][:, v],
                imgs, spec,
            )
        )[0]
        for v in range(2)
    ]
    fg = np.maximum(labs[0][..., 1], labs[1][..., 1])
    reg = np.where(labs[1][..., 1:2] > 0.5, labs[1][..., 2:], labs[0][..., 2:])
    merged = np.concatenate([(1 - fg)[..., None], fg[..., None], reg], -1)

    dcfg = dataclasses.replace(cfg.decode, min_bbox_area=20.0)
    out = decode_batch_direct(merged[None], imgs, spec, dcfg, 4,
                              center="head")
    po = np.asarray(out["poses"])[0]
    fd = np.asarray(out["found"])[0]
    assert int(fd.sum()) == 2
    got = po[fd][:, :2]
    c = np.asarray(gt["center"])[0, :, :2]
    d = np.linalg.norm(got[:, None] - c[None], axis=-1)
    assert set(d.argmin(axis=1)) == {0, 1}
    assert (d.min(axis=1) < 0.5).all()


def test_direct_surface_center_mode():
    """center="surface" (cluster surface-point mean + geometric push)
    with oracle labels on beam-structured scans: decoded centers land
    near ground truth and at least match the single-pixel "geometric"
    estimator it refines (the surface mean averages tens of returns, the
    bbox-center pixel is one)."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(11), 8, 16384
    )
    imgs = range_view_project_batch(pts, spec, valid)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(cfg.decode, min_bbox_area=20.0)
    c = np.asarray(gt["center"])
    errs, founds = {}, {}
    for mode in ("surface", "geometric"):
        out = decode_batch_direct(labels, imgs, spec, dcfg, 1, center=mode)
        po = np.asarray(out["poses"])[:, 0]
        founds[mode] = np.asarray(out["found"])[:, 0]
        errs[mode] = np.linalg.norm(po[:, :2] - c[:, :2], axis=1)
    # found-ness is cluster gating, identical across center modes (a far
    # sparse vehicle can drop below min_bbox_area on beam scans)
    np.testing.assert_array_equal(founds["surface"], founds["geometric"])
    fd = founds["surface"]
    assert fd.sum() >= 6, fd
    # the analytic radial push misfits oblique L-shape views by ~1-1.5 m
    # even with oracle size/yaw (the well-trained "head" mode is the
    # exact estimator; "surface" is its robust fallback) — the bound
    # documents that and catches frame-level blowups
    assert errs["surface"][fd].mean() < 1.6, errs["surface"]
    assert (
        errs["surface"][fd].mean() <= errs["geometric"][fd].mean() + 0.05
    ), errs


def test_direct_silhouette_center_mode():
    """center="silhouette" (near-face box fit to the cluster's surface
    silhouette, seeded by the pushed geometric center) with oracle labels
    on beam scans: the lateral constraint beats the purely radial
    "geometric" estimator by a wide margin (measured 0.77 vs 1.17 m mean
    xy error). With oracle (full-coverage) heat the extents are clean;
    with trained heat the tuner decides per asset whether it wins."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(11), 8, 16384
    )
    imgs = range_view_project_batch(pts, spec, valid)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(cfg.decode, min_bbox_area=20.0)
    c = np.asarray(gt["center"])
    errs, founds = {}, {}
    for mode in ("silhouette", "geometric"):
        out = decode_batch_direct(labels, imgs, spec, dcfg, 1, center=mode)
        po = np.asarray(out["poses"])[:, 0]
        founds[mode] = np.asarray(out["found"])[:, 0]
        errs[mode] = np.linalg.norm(po[:, :2] - c[:, :2], axis=1)
    np.testing.assert_array_equal(founds["silhouette"], founds["geometric"])
    fd = founds["silhouette"]
    assert fd.sum() >= 6, fd
    assert (
        errs["silhouette"][fd].mean() < errs["geometric"][fd].mean() - 0.2
    ), errs
    assert errs["silhouette"][fd].mean() < 1.0, errs["silhouette"]


def test_direct_consensus_center_mode():
    """center="consensus" = surface estimate gated by agreement with the
    robust geometric estimate (fallback on >2.5 m disagreement). On
    oracle labels the two estimators agree on most frames, so consensus
    tracks the better (surface) one; on every frame its error is within
    the max of the two constituents (it can only pick one of them)."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(11), 8, 16384
    )
    imgs = range_view_project_batch(pts, spec, valid)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(cfg.decode, min_bbox_area=20.0)
    c = np.asarray(gt["center"])
    poses, errs, founds = {}, {}, {}
    for mode in ("consensus", "surface", "geometric"):
        out = decode_batch_direct(labels, imgs, spec, dcfg, 1, center=mode)
        poses[mode] = np.asarray(out["poses"])[:, 0]
        founds[mode] = np.asarray(out["found"])[:, 0]
        errs[mode] = np.linalg.norm(poses[mode][:, :2] - c[:, :2], axis=1)
    np.testing.assert_array_equal(founds["consensus"], founds["surface"])
    fd = founds["consensus"]
    assert fd.sum() >= 6, fd
    # per-frame: consensus picks one of the two constituents
    worst = np.maximum(errs["surface"], errs["geometric"]) + 1e-4
    assert (errs["consensus"][fd] <= worst[fd]).all(), errs
    # per-frame: equals surface wherever the two agree within the gate
    agree = (
        np.linalg.norm(
            poses["surface"][:, :3] - poses["geometric"][:, :3], axis=1
        )
        <= 2.5
    )
    sel = fd & agree
    np.testing.assert_allclose(
        poses["consensus"][sel], poses["surface"][sel], atol=1e-5
    )


def test_direct_yaw_frame_local_semantics():
    """The local yaw codec: (a) sc channels equal sin/cos(yaw - theta_px)
    exactly; (b) the global-frame codec still round-trips when both sides
    pin it (shipped pre-round-3 assets); (c) local targets are
    azimuth-equivariant — the fg sc values are identical for the same
    vehicle placed at two different azimuths, which is the property that
    makes the target learnable by a translation-equivariant conv trunk
    (global targets differ by construction)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_points_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import (
        encode_direct_label_batch,
        pixel_angles,
    )
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt = synthesize_points_batch(
        jax.random.PRNGKey(5), 4, 16384, max_yaw=0.4
    )
    imgs = range_view_project_batch(pts, spec)

    # (a) channel semantics
    lab = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="local"
    )
    theta, _ = pixel_angles(spec)
    fg = np.asarray(lab[..., 1]) > 0.5
    for b in range(4):
        # ray azimuth is -theta, so the local target is yaw + theta
        want_s = np.sin(float(gt["yaw"][b]) + np.asarray(theta))[fg[b]]
        np.testing.assert_allclose(
            np.asarray(lab[b, ..., 8])[fg[b]], want_s, atol=1e-5
        )

    # (b) global codec round-trips when pinned on both sides
    lab_g = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="global"
    )
    dcfg = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0, direct_yaw_frame="global"
    )
    out = decode_batch_direct(lab_g, imgs, spec, dcfg, 1, center="head")
    np.testing.assert_allclose(
        np.asarray(out["poses"])[:, 0, 3], np.asarray(gt["yaw"]), atol=1e-3
    )

    # (c) learnability: under the orbit convention the physical heading is
    # yaw and the physical position azimuth is center_az + yaw, so the
    # arc's orientation RELATIVE to the viewing ray is -center_az —
    # independent of yaw. The local target sin(yaw + theta) therefore
    # equals sin(-center_az) on the cluster for ANY yaw: two scenes with
    # the same unrotated center but different yaws must produce the same
    # local targets (the yaw information is carried by the cluster's image
    # POSITION, which the decode adds back via theta). This is exactly the
    # translation-invariant quantity a conv trunk can learn.
    ang = 0.5
    center_a = jnp.asarray(
        [[12.0 * np.cos(ang), 12.0 * np.sin(ang), -1.0]]
    )
    center_b = center_a
    size = jnp.asarray([[4.2, 1.6, 1.5]])
    yaw_a, yaw_b = jnp.asarray([0.3]), jnp.asarray([-0.2])
    # dense synthetic points around each PHYSICAL box position (the orbit
    # convention places the box at Rz(yaw) @ center) so the surface is hit
    def phys(c, y):
        cy, sy = np.cos(float(y[0])), np.sin(float(y[0]))
        return jnp.asarray(
            [cy * c[0, 0] - sy * c[0, 1], sy * c[0, 0] + cy * c[0, 1],
             c[0, 2]]
        )

    k = jax.random.PRNGKey(0)
    cloud_a = phys(center_a, yaw_a) + 2.0 * jax.random.normal(k, (1, 8192, 3))
    cloud_b = phys(center_b, yaw_b) + 2.0 * jax.random.normal(k, (1, 8192, 3))
    pa = jnp.concatenate([cloud_a, jnp.ones((1, 8192, 1))], -1)
    pb = jnp.concatenate([cloud_b, jnp.ones((1, 8192, 1))], -1)
    im_a = range_view_project_batch(pa, spec)
    im_b = range_view_project_batch(pb, spec)
    la = encode_direct_label_batch(center_a, size, yaw_a, im_a, spec)
    lb = encode_direct_label_batch(center_b, size, yaw_b, im_b, spec)
    sa = np.asarray(la[0, ..., 8])[np.asarray(la[0, ..., 1]) > 0.5]
    sb = np.asarray(lb[0, ..., 8])[np.asarray(lb[0, ..., 1]) > 0.5]
    assert sa.size and sb.size
    want = np.sin(-ang)
    assert abs(sa.mean() - want) < 0.05, (sa.mean(), want)
    assert abs(sb.mean() - want) < 0.05, (sb.mean(), want)


def test_direct_fit_center_mode_ellipse():
    """center="fit" on oriented-ellipse beam scans with oracle labels,
    plus a biased-yaw variant: rotating the label's sin/cos field by
    +0.35 rad simulates the trained head's dominant error (yaw noise ~
    0.4-0.5 rad, NOTES.md round 3). The boundary fit must (a) not
    degrade the oracle decode, and (b) recover yaw from the surface
    points despite the biased head — the property that lifted the
    config-4 wide-yaw protocol from IoU 0.42 to 0.66."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.eval.scoring import orbit_to_physical
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(13), 16, 32768, max_yaw=0.45,
        vehicle_surface="ellipse",
    )
    imgs = range_view_project_batch(pts, spec, valid)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0,
        fit_boundary="ellipse", fit_surface_scale=0.9,
    )
    truth = np.concatenate(
        [np.asarray(gt["center"]), np.asarray(gt["yaw"])[:, None],
         np.asarray(gt["size"])], axis=1,
    )
    tp = orbit_to_physical(truth)

    def run(lab, mode):
        out = decode_batch_direct(lab, imgs, spec, dcfg, 1, center=mode)
        po = np.asarray(out["poses"])[:, 0]
        fd = np.asarray(out["found"])[:, 0]
        pp = orbit_to_physical(po)
        xy = np.linalg.norm(pp[:, :2] - tp[:, :2], axis=1)
        dy = np.abs((pp[:, 3] - tp[:, 3]) % np.pi)
        return fd, xy, np.minimum(dy, np.pi - dy)

    # (a) oracle labels: fit matches-or-beats consensus, yaw stays tight
    fd_f, xy_f, yaw_f = run(labels, "fit")
    fd_c, xy_c, yaw_c = run(labels, "consensus")
    np.testing.assert_array_equal(fd_f, fd_c)
    assert fd_f.sum() >= 6, fd_f
    assert xy_f[fd_f].mean() <= xy_c[fd_c].mean() + 0.05, (xy_f, xy_c)
    assert yaw_f[fd_f].mean() < 0.2, yaw_f

    # (b) bias the yaw channels by +0.35 rad (pure head-yaw error)
    delta = 0.35
    s, c = np.asarray(labels[..., 8]), np.asarray(labels[..., 9])
    lab_b = np.asarray(labels).copy()
    lab_b[..., 8] = s * np.cos(delta) + c * np.sin(delta)
    lab_b[..., 9] = c * np.cos(delta) - s * np.sin(delta)
    import jax.numpy as jnp

    lab_b = jnp.asarray(lab_b)
    fd_fb, xy_fb, yaw_fb = run(lab_b, "fit")
    fd_cb, xy_cb, yaw_cb = run(lab_b, "consensus")
    assert yaw_cb[fd_cb].mean() > 0.25, yaw_cb  # consensus keeps the bias
    # fit recovers from the points on most frames (shallow arcs fall
    # back to the biased head yaw — 8-frame sample, so assert the
    # margin, not a tight absolute: the 128-frame protocol measures 0.16)
    assert yaw_fb[fd_fb].mean() < yaw_cb[fd_cb].mean() - 0.10, (
        yaw_fb, yaw_cb)
    assert np.median(yaw_fb[fd_fb]) < 0.15, yaw_fb
    assert xy_fb[fd_fb].mean() < xy_cb[fd_cb].mean() + 0.05, (xy_fb, xy_cb)


def test_direct_fit_center_mode_circle():
    """center="fit" with the circle boundary (rotationally symmetric
    obstacles, the flagship's scene family): yaw must pass through the
    head estimate untouched (a circle carries no orientation signal) and
    the fitted center must match-or-beat consensus on oracle labels."""
    import dataclasses

    import jax
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.geometry.encoding import encode_direct_label_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(17), 8, 16384
    )
    imgs = range_view_project_batch(pts, spec, valid)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0,
        fit_boundary="circle", fit_surface_scale=0.8,
    )
    out_f = decode_batch_direct(labels, imgs, spec, dcfg, 1, center="fit")
    out_c = decode_batch_direct(
        labels, imgs, spec, dcfg, 1, center="consensus"
    )
    out_h = decode_batch_direct(labels, imgs, spec, dcfg, 1, center="head")
    fd = np.asarray(out_f["found"])[:, 0]
    assert fd.sum() >= 6
    # yaw passthrough: identical to the head's yaw on every found frame
    np.testing.assert_allclose(
        np.asarray(out_f["poses"])[fd, 0, 3],
        np.asarray(out_h["poses"])[fd, 0, 3], atol=1e-5,
    )
    c = np.asarray(gt["center"])
    xy_f = np.linalg.norm(
        np.asarray(out_f["poses"])[:, 0, :2] - c[:, :2], axis=1
    )
    xy_c = np.linalg.norm(
        np.asarray(out_c["poses"])[:, 0, :2] - c[:, :2], axis=1
    )
    assert xy_f[fd].mean() <= xy_c[fd].mean() + 0.05, (xy_f, xy_c)
    assert xy_f[fd].mean() < 0.7, xy_f


def test_direct_fit_center_mode_box():
    """center="fit" with the BOX boundary on box-rendered scenes — the
    oracle-sensitivity case: the ray-caster renders
    the true l x w rectangle (no inset) and the fit's rectangle model
    uses only the head's size estimate (scale 1.0), so no constant is
    shared with the generator. Same structure as the ellipse test:
    (a) oracle labels: fit must match-or-beat consensus and keep yaw
    tight; (b) +0.35 rad head-yaw bias: the fit must recover most of it
    from the surface points."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.eval.scoring import orbit_to_physical
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(23), 16, 32768, max_yaw=0.45,
        vehicle_surface="box",
    )
    imgs = range_view_project_batch(pts, spec, valid)
    labels = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec
    )
    dcfg = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0,
        fit_boundary="box", fit_surface_scale=1.0,
    )
    truth = np.concatenate(
        [np.asarray(gt["center"]), np.asarray(gt["yaw"])[:, None],
         np.asarray(gt["size"])], axis=1,
    )
    tp = orbit_to_physical(truth)

    def run(lab, mode):
        out = decode_batch_direct(lab, imgs, spec, dcfg, 1, center=mode)
        po = np.asarray(out["poses"])[:, 0]
        fd = np.asarray(out["found"])[:, 0]
        pp = orbit_to_physical(po)
        xy = np.linalg.norm(pp[:, :2] - tp[:, :2], axis=1)
        dy = np.abs((pp[:, 3] - tp[:, 3]) % np.pi)
        return fd, xy, np.minimum(dy, np.pi - dy)

    # (a) oracle labels: fit matches-or-beats consensus, yaw stays tight
    fd_f, xy_f, yaw_f = run(labels, "fit")
    fd_c, xy_c, yaw_c = run(labels, "consensus")
    np.testing.assert_array_equal(fd_f, fd_c)
    assert fd_f.sum() >= 6, fd_f
    assert xy_f[fd_f].mean() <= xy_c[fd_c].mean() + 0.05, (xy_f, xy_c)
    assert yaw_f[fd_f].mean() < 0.2, yaw_f

    # (b) bias the yaw channels by +0.35 rad (pure head-yaw error)
    delta = 0.35
    s, c = np.asarray(labels[..., 8]), np.asarray(labels[..., 9])
    lab_b = np.asarray(labels).copy()
    lab_b[..., 8] = s * np.cos(delta) + c * np.sin(delta)
    lab_b[..., 9] = c * np.cos(delta) - s * np.sin(delta)
    lab_b = jnp.asarray(lab_b)
    fd_fb, xy_fb, yaw_fb = run(lab_b, "fit")
    fd_cb, xy_cb, yaw_cb = run(lab_b, "consensus")
    assert yaw_cb[fd_cb].mean() > 0.25, yaw_cb  # consensus keeps the bias
    assert yaw_fb[fd_fb].mean() < yaw_cb[fd_cb].mean() - 0.10, (
        yaw_fb, yaw_cb)
    assert np.median(yaw_fb[fd_fb]) < 0.15, yaw_fb
    assert xy_fb[fd_fb].mean() < xy_cb[fd_cb].mean() + 0.05, (xy_fb, xy_cb)


def test_box_raycast_surface_geometry():
    """vehicle_surface="box" must place vehicle returns ON the oriented
    l x w rectangle outline (within surface noise), with L-shaped
    two-face coverage when viewed obliquely."""
    import jax
    import numpy as np

    from tpufusion.data.synthetic import synthesize_beam_scan_batch

    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(3), 6, 32768, max_yaw=0.45,
        vehicle_surface="box",
    )
    p = np.asarray(pts)
    v = np.asarray(valid)
    c = np.asarray(gt["center"])
    yaw = np.asarray(gt["yaw"])
    sz = np.asarray(gt["size"])
    for i in range(p.shape[0]):
        cy, sy = np.cos(yaw[i]), np.sin(yaw[i])
        spot = np.array(
            [cy * c[i, 0] - sy * c[i, 1], sy * c[i, 0] + cy * c[i, 1]]
        )
        # gate to the vehicle's z-band first: clutter poles taller than
        # the box can return from inside its xy footprint (rays passing
        # above the vehicle), and those are legitimate scene points
        zb = c[i, 2] - sz[i, 2] / 2 - 0.1
        zt = c[i, 2] + sz[i, 2] / 2 + 0.1
        pv = p[i, v[i]]
        pv = pv[(pv[:, 2] >= zb) & (pv[:, 2] <= zt)]
        d = pv[:, :2] - spot
        u = cy * d[:, 0] + sy * d[:, 1]
        w_ = -sy * d[:, 0] + cy * d[:, 1]
        su = np.abs(u) / (sz[i, 0] / 2)
        sv = np.abs(w_) / (sz[i, 1] / 2)
        # the +-0.03 m radial surface noise maps to ~0.04-0.12 scaled
        # units depending on incidence, so "on the outline" is a band
        onbox = np.abs(np.maximum(su, sv) - 1.0) < 0.15
        inside = np.maximum(su, sv) <= 1.1
        n_in = int(inside.sum())
        assert n_in >= 20, n_in
        # returns sit on the outline band, not in the deep interior
        assert onbox.sum() >= 0.8 * n_in, (onbox.sum(), n_in)
        assert (np.maximum(su, sv)[inside] > 0.6).mean() > 0.95


def test_dual_yaw_codec_encode_and_auto_gate():
    """yaw_frame="both" encodes 12-channel labels whose local pair
    matches the "local" encoding and global pair the "global" one; the
    decode's direct_yaw_frame="auto" magnitude gate picks whichever
    codec kept its vector magnitude (an unlearnable codec collapses
    toward zero — simulated by zeroing one pair), and with both pairs
    intact matches the explicit decodes."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(31), 8, 32768, max_yaw=0.45,
        vehicle_surface="ellipse",
    )
    imgs = range_view_project_batch(pts, spec, valid)
    lab_l = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="local"
    )
    lab_g = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="global"
    )
    lab_b = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="both"
    )
    assert lab_b.shape[-1] == 12
    np.testing.assert_allclose(
        np.asarray(lab_b[..., :10]), np.asarray(lab_l), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(lab_b[..., 10:]), np.asarray(lab_g[..., 8:]), atol=1e-6
    )

    base = dataclasses.replace(cfg.decode, min_bbox_area=20.0)
    d_auto = dataclasses.replace(base, direct_yaw_frame="auto")
    d_local = dataclasses.replace(base, direct_yaw_frame="local")
    d_global = dataclasses.replace(base, direct_yaw_frame="global")

    out_auto = decode_batch_direct(lab_b, imgs, spec, d_auto, 1, "consensus")
    out_local = decode_batch_direct(lab_l, imgs, spec, d_local, 1,
                                    "consensus")
    fd = np.asarray(out_auto["found"])[:, 0]
    assert fd.sum() >= 5
    # oracle dual labels: both codecs are exact; the gate's result must
    # match the explicit local decode
    np.testing.assert_allclose(
        np.asarray(out_auto["poses"])[fd, 0],
        np.asarray(out_local["poses"])[fd, 0], atol=1e-4,
    )

    # simulate the collapsed-local regime (symmetric-family cluster):
    # zero the local pair -> gate must fall to the global codec
    lab_z = np.asarray(lab_b).copy()
    lab_z[..., 8:10] = 0.0
    out_z = decode_batch_direct(
        jnp.asarray(lab_z), imgs, spec, d_auto, 1, "consensus"
    )
    out_g = decode_batch_direct(lab_b, imgs, spec, d_global, 1, "consensus")
    np.testing.assert_allclose(
        np.asarray(out_z["poses"])[fd, 0, 3],
        np.asarray(out_g["poses"])[fd, 0, 3], atol=1e-4,
    )
    # and the mirrored case: zero the global pair -> local codec
    lab_z2 = np.asarray(lab_b).copy()
    lab_z2[..., 10:12] = 0.0
    out_z2 = decode_batch_direct(
        jnp.asarray(lab_z2), imgs, spec, d_auto, 1, "consensus"
    )
    np.testing.assert_allclose(
        np.asarray(out_z2["poses"])[fd, 0, 3],
        np.asarray(out_local["poses"])[fd, 0, 3], atol=1e-4,
    )


def test_fit_boundary_auto_gates_per_cluster():
    """fit_boundary="auto" + direct_yaw_frame="auto": on oriented
    (ellipse) clusters with intact dual labels the result matches the
    explicit ellipse fit; with the local pair zeroed (symmetric-cluster
    regime) it matches the circle fit at fit_symmetric_scale."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpufusion.config import DEFAULT
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch

    cfg = DEFAULT
    spec = cfg.range_view
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(37), 8, 32768, max_yaw=0.45,
        vehicle_surface="ellipse",
    )
    imgs = range_view_project_batch(pts, spec, valid)
    lab_b = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="both"
    )
    d_auto = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0, direct_yaw_frame="auto",
        fit_boundary="auto", fit_boundary_oriented="ellipse",
        fit_surface_scale=0.9, fit_symmetric_scale=0.8,
    )
    d_ell = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0, direct_yaw_frame="local",
        fit_boundary="ellipse", fit_surface_scale=0.9,
    )
    d_cir = dataclasses.replace(
        cfg.decode, min_bbox_area=20.0, direct_yaw_frame="global",
        fit_boundary="circle", fit_surface_scale=0.8,
    )
    # local pair decoded from a 12-ch input == 10-ch local label decode.
    # With EXACT oracle labels both codecs carry magnitude ~1 and the
    # gate is a float-level coin flip — dampen the global pair slightly
    # (the direction a real net collapses on oriented scenes) so the
    # gate's pick is deterministic for the parity check.
    lab_l = encode_direct_label_batch(
        gt["center"], gt["size"], gt["yaw"], imgs, spec, yaw_frame="local"
    )
    lab_bo = np.asarray(lab_b).copy()
    lab_bo[..., 10:12] *= 0.9
    out_auto = decode_batch_direct(
        jnp.asarray(lab_bo), imgs, spec, d_auto, 1, "fit"
    )
    out_ell = decode_batch_direct(lab_l, imgs, spec, d_ell, 1, "fit")
    fd = np.asarray(out_auto["found"])[:, 0]
    assert fd.sum() >= 5
    np.testing.assert_allclose(
        np.asarray(out_auto["poses"])[fd, 0],
        np.asarray(out_ell["poses"])[fd, 0], atol=1e-4,
    )

    lab_z = np.asarray(lab_b).copy()
    lab_z[..., 8:10] = 0.0
    out_z = decode_batch_direct(
        jnp.asarray(lab_z), imgs, spec, d_auto, 1, "fit"
    )
    lab_g = np.asarray(lab_b)[..., list(range(8)) + [10, 11]]
    out_c = decode_batch_direct(
        jnp.asarray(lab_g), imgs, spec, d_cir, 1, "fit"
    )
    np.testing.assert_allclose(
        np.asarray(out_z["poses"])[fd, 0],
        np.asarray(out_c["poses"])[fd, 0], atol=1e-4,
    )
