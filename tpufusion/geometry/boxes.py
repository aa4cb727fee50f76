"""3D box corner generation and 2D projection (pure JAX, fully traceable).

Reimplements the geometry of `modules/lidar/train/encoder.py:22-122`:
  * project_2d — forward 3D -> range-view pixel mapping with int truncation,
    vertical clamp, and y flip;
  * box_corners_3d — the 8-corner template rotated by yaw;
  * sorted_projected_corners — corners ordered by 2D distance from the
    projected centroid (stable argsort, like numpy);
  * inner/outer rect — bbox of the 4 nearest / 4 farthest corners.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.config import RangeViewSpec

# corner template signs in (l, w, h) halves; order matches encoder.py:52-59.
# A NUMPY constant on purpose: a module-level device array would be captured
# as an on-device constant by every jit trace, forcing a device->host fetch
# during lowering.
_CORNER_SIGNS = np.array(
    [
        [-1, +1, +1],
        [-1, +1, -1],
        [-1, -1, +1],
        [-1, -1, -1],
        [+1, +1, +1],
        [+1, +1, -1],
        [+1, -1, +1],
        [+1, -1, -1],
    ],
    dtype=np.float32,
)


def rot_z(angle: jax.Array) -> jax.Array:
    c, s = jnp.cos(angle), jnp.sin(angle)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], -1),
            jnp.stack([s, c, z], -1),
            jnp.stack([z, z, o], -1),
        ],
        -2,
    )


def rot_y(angle: jax.Array) -> jax.Array:
    c, s = jnp.cos(angle), jnp.sin(angle)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, z, s], -1),
            jnp.stack([z, o, z], -1),
            jnp.stack([-s, z, c], -1),
        ],
        -2,
    )


def box_corners_3d(center, size, yaw) -> jax.Array:
    """(..., 3) center, (..., 3) size (l, w, h), (...) yaw -> (..., 8, 3).

    Matches encoder.py:47-60: the full corner coordinates (center offset
    included) are rotated by Rz(yaw) — i.e. the box orbits the sensor origin,
    not its own center. That is the reference's convention and the decode
    inverts the same convention, so we keep it.
    """
    center = jnp.asarray(center, jnp.float32)
    size = jnp.asarray(size, jnp.float32)
    yaw = jnp.asarray(yaw, jnp.float32)
    half = size[..., None, :] * _CORNER_SIGNS / 2.0
    corners = center[..., None, :] + half  # (..., 8, 3)
    r = rot_z(yaw)  # (..., 3, 3)
    # highest precision: a default-precision float32 product may run in
    # reduced precision (TF32 on the GPU), too coarse for regression
    # targets
    return jnp.einsum("...ij,...kj->...ki", r, corners, precision="highest")


def project_2d(tx, ty, tz, spec: RangeViewSpec):
    """Forward 3D -> pixel mapping of encoder.py:22-44 (elementwise).

    Returns (col, row) int32 with python-int truncation toward zero, the row
    clamped to [0, y_max] and flipped. Columns are NOT clamped (the reference
    doesn't either).
    """
    tx = jnp.asarray(tx, jnp.float32)
    ty = jnp.asarray(ty, jnp.float32)
    tz = jnp.asarray(tz, jnp.float32)
    l2 = jnp.sqrt(tx * tx + ty * ty + tz * tz)
    col = jnp.trunc(
        jnp.arctan2(-ty, tx) / spec.res_h_rad - spec.x_min
    ).astype(jnp.int32)
    row = jnp.trunc(
        jnp.arcsin(jnp.where(l2 > 0, tz / jnp.maximum(l2, 1e-12), 0.0))
        / spec.res_v_rad
        - spec.y_min
    ).astype(jnp.int32)
    row = jnp.clip(row, 0, spec.y_max)
    row = spec.y_max - row
    return col, row


def sorted_projected_corners(center, size, yaw, spec: RangeViewSpec):
    """Project the 8 box corners and sort by 2D distance to the projected
    centroid (encoder.py:62-76). Returns (8, 2) int32 [col, row]."""
    corners = box_corners_3d(center, size, yaw)  # (8, 3)
    ccol, crow = project_2d(corners[:, 0], corners[:, 1], corners[:, 2], spec)
    pcol, prow = project_2d(center[0], center[1], center[2], spec)
    d = jnp.sqrt(
        (ccol - pcol).astype(jnp.float32) ** 2
        + (crow - prow).astype(jnp.float32) ** 2
    )
    order = jnp.argsort(d, stable=True)
    return jnp.stack([ccol, crow], axis=-1)[order]


def _rect_of(corners2d: jax.Array):
    ul = corners2d.min(axis=0)
    lr = corners2d.max(axis=0)
    return ul[0], ul[1], lr[0], lr[1]  # ul_col, ul_row, lr_col, lr_row


def inner_rect(center, size, yaw, spec: RangeViewSpec):
    """bbox of the 4 corners nearest the centroid (encoder.py:89-97)."""
    return _rect_of(sorted_projected_corners(center, size, yaw, spec)[:4])


def outer_rect(center, size, yaw, spec: RangeViewSpec):
    """bbox of the 4 corners farthest from the centroid (encoder.py:100-108)."""
    return _rect_of(sorted_projected_corners(center, size, yaw, spec)[-4:])


def circle_rect(center, size, yaw, spec: RangeViewSpec):
    """Square of side min(inner-rect dims) centered on the inner rect
    (encoder.py:111-122). Float bounds — the reference divides by 2
    without truncating until the paint loop."""
    ul_x, ul_y, lr_x, lr_y = inner_rect(center, size, yaw, spec)
    dim_x = (lr_x - ul_x).astype(jnp.float32)
    dim_y = (lr_y - ul_y).astype(jnp.float32)
    r = jnp.minimum(dim_x, dim_y)
    cx = ul_x.astype(jnp.float32) + dim_x / 2
    cy = ul_y.astype(jnp.float32) + dim_y / 2
    return cx - r / 2, cy - r / 2, cx + r / 2, cy + r / 2
