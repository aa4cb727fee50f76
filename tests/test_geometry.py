"""Golden tests: JAX geometry vs the NumPy oracle of reference semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufusion.config import BevSpec, RangeViewSpec
from tpufusion.geometry.range_view import range_view_project
from tpufusion.geometry.bev import bev_rasterize
from tpufusion.geometry import boxes
from tpufusion.geometry import encoding

from tests.oracle import reference_numpy as oracle

SPEC = RangeViewSpec()


def test_spec_constants_match_reference():
    assert SPEC.x_min == oracle.X_MIN
    assert abs(SPEC.y_min - oracle.Y_MIN) < 1e-12
    assert SPEC.x_max == oracle.X_MAX
    assert SPEC.y_max == oracle.Y_MAX
    assert (SPEC.height, SPEC.width) == (oracle.H, oracle.W)


def test_range_view_matches_oracle(cloud):
    want = oracle.range_view(cloud.astype(np.float64))
    got = np.asarray(range_view_project(jnp.asarray(cloud), SPEC))
    np.testing.assert_allclose(got[..., 0], want["distance"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[..., 1], want["height"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[..., 2], want["intensity"], rtol=1e-4, atol=1e-4)


def test_range_view_nearest_wins():
    # two points in the same pixel; nearer must win
    far = [20.0, 0.0, 0.0, 7.0]
    near = [10.0, 0.0, 0.0, 3.0]
    pts = jnp.array([far, near], dtype=jnp.float32)
    img = np.asarray(range_view_project(pts, SPEC))
    occupied = img[..., 0] > 0
    assert occupied.sum() == 1
    assert np.isclose(img[..., 0][occupied][0], 10.0)
    assert np.isclose(img[..., 2][occupied][0], 3.0)


def test_range_view_padding_masked(cloud):
    pad = np.full((100, 4), np.nan, dtype=np.float32)
    padded = np.concatenate([cloud, pad], axis=0)
    a = np.asarray(range_view_project(jnp.asarray(cloud), SPEC))
    b = np.asarray(range_view_project(jnp.asarray(padded), SPEC))
    np.testing.assert_array_equal(a, b)


def test_bev_density_matches_oracle(cloud):
    spec = BevSpec(with_height_channel=False, with_intensity_channel=False)
    want = oracle.bev_density(cloud.astype(np.float64))
    got = np.asarray(bev_rasterize(jnp.asarray(cloud), spec))[..., 0]
    assert got.shape == want.shape
    # f32 bucketing vs f64 histogram2d: points within float eps of a bin edge
    # may land one bin over; bound the damage instead of exact equality
    diff = np.abs(got - want)
    assert (diff > 0.05).mean() < 1e-3
    assert np.median(diff) == 0.0


def test_project_2d_matches_oracle(rng):
    pts = rng.uniform(-50, 50, size=(256, 3))
    pts[:, 2] = rng.uniform(-3, 3, size=256)
    want = np.array([oracle.project_2d(*p) for p in pts])
    col, row = boxes.project_2d(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]), SPEC
    )
    got = np.stack([np.asarray(col), np.asarray(row)], axis=1)
    # float32 vs float64 trunc can differ by 1 pixel exactly at integer
    # boundaries; require 99.5%+ exact match and max off-by-one
    exact = (got == want).all(axis=1).mean()
    assert exact > 0.99, exact
    assert np.abs(got - want).max() <= 1


def test_box_corners_match_oracle():
    center = np.array([12.0, -4.0, -0.8])
    size = np.array([4.2418, 1.4478, 1.5748])
    yaw = 0.37
    want = oracle.box_corners(center, size, yaw)
    got = np.asarray(boxes.box_corners_3d(center, size, yaw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_outer_rect_matches_oracle():
    center = np.array([12.0, -4.0, -0.8])
    size = np.array([4.2418, 1.4478, 1.5748])
    yaw = 0.15
    (ulx, uly), (lrx, lry) = oracle.outer_rect(center, size, yaw)
    g_ulx, g_uly, g_lrx, g_lry = [
        int(v) for v in boxes.outer_rect(
            jnp.asarray(center, jnp.float32), jnp.asarray(size, jnp.float32),
            jnp.asarray(yaw, jnp.float32), SPEC,
        )
    ]
    assert abs(g_ulx - ulx) <= 1 and abs(g_uly - uly) <= 1
    assert abs(g_lrx - lrx) <= 1 and abs(g_lry - lry) <= 1


@pytest.mark.parametrize("yaw", [0.0, 0.3, -1.1])
def test_encode_label_matches_oracle(cloud, yaw):
    center = np.array([12.0, -4.0, -0.8])
    size = np.array([4.2418, 1.4478, 1.5748])
    img = np.stack(
        [
            oracle.range_view(cloud.astype(np.float64))[k]
            for k in ("distance", "height", "intensity")
        ],
        axis=-1,
    )
    want = oracle.encode_label(center, size, yaw, img)
    got = np.asarray(
        encoding.encode_label(
            jnp.asarray(center, jnp.float32),
            jnp.asarray(size, jnp.float32),
            jnp.asarray(yaw, jnp.float32),
            jnp.asarray(img, jnp.float32),
            SPEC,
        )
    )
    # footprint can differ along its 1-pixel border from f32 trunc; compare
    # where the masks agree and require near-total mask agreement
    mask_agree = (want[..., 1] == got[..., 1])
    assert mask_agree.mean() > 0.999
    np.testing.assert_allclose(
        got[mask_agree], want[mask_agree], rtol=1e-3, atol=1e-3
    )


def test_encode_decode_roundtrip(cloud):
    """decode_corners inverts encode_label exactly on the footprint."""
    center = jnp.array([12.0, -4.0, -0.8], jnp.float32)
    size = jnp.array([4.2418, 1.4478, 1.5748], jnp.float32)
    yaw = jnp.float32(0.42)
    img = range_view_project(jnp.asarray(cloud), SPEC)
    lbl = encoding.encode_label(center, size, yaw, img, SPEC)
    corners = encoding.decode_corners(lbl[..., 2:], img, SPEC)
    mask = np.asarray(lbl[..., 1]) > 0
    want = np.asarray(boxes.box_corners_3d(center, size, yaw))
    got = np.asarray(corners)[mask]  # (K, 8, 3)
    err = np.abs(got - want[None]).max()
    assert err < 1e-3, err


def test_connected_components_matches_scipy(rng):
    from scipy.ndimage import label as scipy_label
    from tpufusion.ops.components import connected_components

    mask = rng.random((32, 180)) > 0.7
    want, n = scipy_label(mask)
    got = np.asarray(connected_components(jnp.asarray(mask)))
    # same partition: bijection between scipy labels and our root ids
    assert (got >= 0).sum() == (want > 0).sum()
    for k in range(1, n + 1):
        roots = np.unique(got[want == k])
        assert len(roots) == 1, f"component {k} split"
    # distinct scipy components map to distinct roots
    roots = [got[want == k][0] for k in range(1, n + 1)]
    assert len(set(roots)) == n


def test_sort_and_scatter_winners_identical(rng):
    """The sort-based exact path (default) and the two-pass scatter-min
    produce bit-identical images, including collision tie-breaks."""
    from tests.conftest import synthetic_cloud
    from tpufusion.geometry.range_view import range_view_project

    spec = RangeViewSpec()
    for seed in range(3):
        r = np.random.default_rng(seed)
        pts = synthetic_cloud(r, n=8192, with_vehicle_at=(10.0, 2.0, -0.7))
        # force collisions: duplicate some points with equal L2
        pts = np.concatenate([pts, pts[:512]], axis=0)
        a = np.asarray(range_view_project(jnp.asarray(pts), spec, None, "exact"))
        b = np.asarray(range_view_project(jnp.asarray(pts), spec, None, "scatter"))
        np.testing.assert_array_equal(a, b)


def test_packed_winner_divergence_bound(rng):
    """Measured divergence bound for the packed throughput mode.

    `nearest_wins_scatter_packed` quantizes the 31-bit sortable L2
    encoding to its top (31 - idx_bits) bits, so the packed winner of a
    pixel may differ from the exact winner only when their L2 keys agree
    within 2**idx_bits encoding ulps — i.e. the two candidates' 3D
    distances agree to ~2**(idx_bits - 23) relative (2**-9 at N=16k).
    This test verifies: identical occupancy, the winner-L2 relative
    divergence bound on every differing pixel, and that differing pixels
    are a small fraction of occupied ones on realistic clouds."""
    from tests.conftest import synthetic_cloud
    from tpufusion.geometry.range_view import project_to_pixels
    from tpufusion.ops.scatter import (
        nearest_wins_scatter_packed,
        nearest_wins_sort,
    )

    spec = RangeViewSpec()
    num_pixels = spec.height * spec.width

    def compare(pts):
        n = len(pts)
        idx_bits = max((n - 1).bit_length(), 1)
        jp = jnp.asarray(pts)
        finite = jnp.all(jnp.isfinite(jp), axis=1)
        row, col, l2 = project_to_pixels(jp, spec)
        pix = row * spec.width + col
        wa, occa = nearest_wins_sort(pix, l2, finite, num_pixels)
        wp, occp = nearest_wins_scatter_packed(pix, l2, finite, num_pixels)
        occa, occp = np.asarray(occa), np.asarray(occp)
        np.testing.assert_array_equal(occa, occp)  # occupancy identical
        wa, wp, l2np = np.asarray(wa), np.asarray(wp), np.asarray(l2)
        diff = occa & (wa != wp)
        if diff.any():
            la, lp = l2np[wa[diff]], l2np[wp[diff]]
            rel = np.abs(lp - la) / np.maximum(la, 1e-6)
            # 2 ulp slack for exponent-boundary truncation
            assert rel.max() <= 2.0 ** (idx_bits - 22), rel.max()
        return int(diff.sum()), int(occa.sum())

    plain_diff = plain_occ = 0
    for seed in range(3):
        r = np.random.default_rng(seed)
        pts = synthetic_cloud(
            r, n=16384, with_vehicle_at=(10.0, 2.0, -0.7)
        ).astype(np.float32)
        # realistic cloud: divergence is a per-mille effect
        d, o = compare(pts)
        plain_diff += d
        plain_occ += o
        # adversarial near-ties (duplicates jittered ~1e-4 relative):
        # every tie may flip winner, but the L2 bound above still holds
        dup = pts[:1024].copy()
        dup[:, :3] *= (1.0 + r.uniform(-1e-4, 1e-4, (1024, 1))).astype(
            np.float32
        )
        compare(np.concatenate([pts, dup], axis=0))
    assert plain_diff / max(plain_occ, 1) < 0.005, (plain_diff, plain_occ)


def test_sort16_and_exact_and_scatter_identical(rng):
    """The packed-key 2-operand sort (method="sort16", a measured-slower
    but kept variant), the exact 2-key sort, and the two-pass scatter-min
    produce bit-identical images, including collision and exact-tie
    behavior."""
    from tests.conftest import synthetic_cloud
    from tpufusion.geometry.range_view import range_view_project

    spec = RangeViewSpec()
    for seed in range(3):
        r = np.random.default_rng(seed)
        pts = synthetic_cloud(r, n=8192, with_vehicle_at=(10.0, 2.0, -0.7))
        pts = np.concatenate([pts, pts[:512]], axis=0)  # exact-key ties
        a = np.asarray(range_view_project(jnp.asarray(pts), spec, None, "exact"))
        b = np.asarray(range_view_project(jnp.asarray(pts), spec, None, "sort16"))
        c = np.asarray(range_view_project(jnp.asarray(pts), spec, None, "scatter"))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_projection_rejects_unknown_method():
    """Only the XLA winner formulations exist; any other method name
    (the removed "pallas" kernel included) is refused, not defaulted."""
    from tpufusion.geometry.range_view import (
        range_view_project,
        range_view_project_batch,
    )

    pts = jnp.zeros((16, 4))
    with pytest.raises(ValueError, match="pallas"):
        range_view_project(pts, RangeViewSpec(), None, "pallas")
    with pytest.raises(ValueError, match="pallas"):
        range_view_project_batch(pts[None], RangeViewSpec(), None, "pallas")


def test_footprint_mask_methods_match_oracle():
    """All three reference label footprints (outer_rect / inner_rect /
    circle, encoder.py:124-168) match an independent numpy re-statement
    of the reference's paint loops, including the circle's
    centroid-centered disk inside the inner-rect-centered square."""
    import jax.numpy as jnp

    from tests.oracle import reference_numpy as oracle
    from tpufusion.geometry.encoding import footprint_mask

    spec = RangeViewSpec()
    boxes = [
        ((12.0, 3.0, -0.7), (4.2, 1.6, 1.5), 0.0),
        ((20.0, -8.0, -0.6), (4.2, 1.6, 1.5), 0.3),
        ((9.0, 9.0, -0.8), (5.0, 2.0, 1.8), -0.8),
        ((25.0, 0.5, -0.7), (4.2, 1.6, 1.5), 1.2),
    ]
    for center, size, yaw in boxes:
        for method in ("outer_rect", "inner_rect", "circle"):
            got = np.asarray(
                footprint_mask(
                    jnp.asarray(center), jnp.asarray(size),
                    jnp.asarray(yaw), spec, method,
                )
            )
            want = oracle.footprint_label(
                np.asarray(center), np.asarray(size), float(yaw),
                (spec.height, spec.width), method,
            )
            np.testing.assert_array_equal(got, want, err_msg=f"{method} {center}")
