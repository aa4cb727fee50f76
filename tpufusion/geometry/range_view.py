"""Cylindrical 360-degree range-view projection, on device.

Reproduces the output of `lidar_2d_front_view` / `generate_lidar_2d_front_view`
(`modules/lidar/process/extract_rosbag_lidar.py:18-86`) for all three float
channels in one fused pass instead of three python scatters:

  column = trunc(arctan2(-y, x) / res_h - X_MIN)
  row'   = trunc(arcsin(z / l2) / res_v - Y_MIN)
  row    = Y_MAX - row'            (the reference flipuds after scatter)

Collision rule: nearest point (smallest full L2 norm) wins, ties broken by
lowest point index — see tpufusion.ops.scatter. Negative integer pixel
coordinates follow numpy wrap-around semantics (the reference indexes numpy
arrays directly, so a point just below the vertical FOV lands on the top
rows); coordinates beyond the positive end — which would crash the reference —
are wrapped too, documented divergence.

Channel order matches the training loader (`modules/lidar/train/loader.py:
192-209`): 0 = distance (xy-range), 1 = height (z), 2 = intensity.
Empty-pixel fill values match the reference: 0 for distance/intensity,
min_height for height (`extract_rosbag_lidar.py:54,62`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpufusion.config import RangeViewSpec
from tpufusion.ops.scatter import (
    nearest_wins_scatter,
    nearest_wins_scatter_packed,
    nearest_wins_sort,
    nearest_wins_sort16,
)

_WINNER = {
    "exact": nearest_wins_sort,
    "sort16": nearest_wins_sort16,
    "scatter": nearest_wins_scatter,
    "packed": nearest_wins_scatter_packed,
}


def project_to_pixels(
    points: jax.Array, spec: RangeViewSpec
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Map points (N,>=3) to (row, col) int32 pixel coords + L2 rank key.

    Rows are already flipped to image orientation.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    l2 = jnp.sqrt(x * x + y * y + z * z)
    az = jnp.arctan2(-y, x) / spec.res_h_rad - spec.x_min
    el = jnp.arcsin(jnp.where(l2 > 0, z / jnp.maximum(l2, 1e-12), 0.0)) / spec.res_v_rad
    el = el - spec.y_min

    col = jnp.trunc(az).astype(jnp.int32)
    row_unflipped = jnp.trunc(el).astype(jnp.int32)
    # numpy wrap-around for negative indices; positive overflow wraps too
    col = jnp.mod(col, spec.width)
    row_unflipped = jnp.mod(row_unflipped, spec.height)
    row = spec.y_max - row_unflipped
    return row, col, l2


def range_view_project(
    points: jax.Array,
    spec: RangeViewSpec = RangeViewSpec(),
    valid: jax.Array | None = None,
    method: str = "exact",
) -> jax.Array:
    """Project one padded point cloud (N, 4) -> (H, W, 3) float32 image.

    `valid` masks padding; non-finite points are dropped regardless.
    method="exact" reproduces the reference's nearest-wins collision rule
    bit-for-bit via the 2-key sort formulation (nearest_wins_sort), which
    is bit-identical to "scatter", the two-pass scatter-min, and to
    "sort16", the packed-key 2-operand sort variant. "packed" quantizes
    the winner key for one fewer pass (bounded winner-selection
    tolerance, see nearest_wins_scatter_packed).
    """
    if method not in _WINNER:
        raise ValueError(
            f"unknown projection method {method!r}; one of {sorted(_WINNER)}"
        )
    pts = points.astype(jnp.float32)
    finite = jnp.all(jnp.isfinite(pts), axis=1)
    if valid is not None:
        finite = finite & valid

    row, col, l2 = project_to_pixels(pts, spec)
    pixel_ids = row * spec.width + col
    num_pixels = spec.height * spec.width
    winner, occupied = _WINNER[method](pixel_ids, l2, finite, num_pixels)

    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    intensity = pts[:, 3] if pts.shape[1] > 3 else jnp.zeros_like(x)
    # one row gather of all channels instead of three 1-D gathers
    payload = jnp.stack([jnp.sqrt(x * x + y * y), z, intensity], axis=-1)
    vals = payload[winner]  # (num_pixels, 3)
    fills = jnp.asarray([0.0, spec.min_height, 0.0], jnp.float32)
    img = jnp.where(occupied[:, None], vals, fills[None, :])
    return img.reshape(spec.height, spec.width, 3)


def range_view_project_batch(
    points: jax.Array,
    spec: RangeViewSpec = RangeViewSpec(),
    valid: jax.Array | None = None,
    method: str = "exact",
) -> jax.Array:
    """(B, N, 4) [+ (B, N) valid] -> (B, H, W, 3)."""
    if valid is None:
        return jax.vmap(lambda p: range_view_project(p, spec, None, method))(
            points
        )
    return jax.vmap(lambda p, v: range_view_project(p, spec, v, method))(
        points, valid
    )
