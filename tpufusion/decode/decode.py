"""jit-fused pose decode: heatmap -> cluster -> 3D centroid -> corner vote.

Device-side, fixed-shape re-design of the reference decode
(`modules/lidar/train/predict.py`):

  find_obstacle (predict.py:33-81)
      threshold >= min_prob, stamp 4x4 heat around each positive (a
      reduce_window box sum replaces the python stamp loop; positives at
      row < 2 or col < 2 stamp nothing, matching python negative-slice
      semantics), drop heat <= min_heat, 4-connected components, pick the
      largest-area cluster bbox (ties -> first in scan order, like scipy's
      label numbering), shrink by 2, integer centroid.

  back_project_2d_to_3d (predict.py:230-293)
      nearest-valid-pixel fallback inside the bbox when the centroid pixel
      has no return, then range+0.75 -> (x, y, z).

  corner_vote (predict.py:94-199)
      decode every candidate pixel's 8 corners in one batched matmul,
      apply the reference's candidate test (window around bbox AND the
      column/row-membership check of predict.py:107), reject corners far
      from the centroid, then count neighbors within max_bbox_dist via a
      KxK distance matmul instead of the O(N^2) python loop; average the
      tied winners and derive yaw / l / w / h from corner geometry.

All data-dependent control flow is masks + sentinels so one XLA program
serves every frame. decode_batch vmaps the whole thing.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tpufusion.config import DecodeConfig, RangeViewSpec
from tpufusion.geometry.boxes import rot_y, rot_z
from tpufusion.ops.components import connected_components_with_bbox

_SENTINEL = 1e8  # reference uses 10e7 for "no valid pixel"
_BIG_I = jnp.iinfo(jnp.int32).max


def _heat_components(prob_map: jax.Array, cfg: DecodeConfig):
    """Shared stage: threshold -> heat stamp -> connected components.
    Returns (mask, labels, min_x, max_x, min_y, max_y)."""
    h, w = prob_map.shape
    pos = prob_map >= cfg.min_prob
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    # python slice semantics: positives at row<2 or col<2 stamp nothing
    stamp = pos & (rows >= 2) & (cols >= 2)

    # heat[r, c] = #stamping positives in rows [r-1, r+2] x cols [c-1, c+2]
    heat = jax.lax.reduce_window(
        stamp.astype(jnp.float32),
        0.0,
        jax.lax.add,
        window_dimensions=(4, 4),
        window_strides=(1, 1),
        padding=((1, 2), (1, 2)),
    )
    heat = jnp.where(heat <= cfg.min_heat, 0.0, heat)

    mask = heat > 0
    labels, min_x, max_x, min_y, max_y = connected_components_with_bbox(
        mask, cfg.max_cc_iters
    )  # per-pixel cluster root + cluster extents
    return mask, labels, min_x, max_x, min_y, max_y


def find_obstacle(
    prob_map: jax.Array,  # (H, W) foreground probability
    cfg: DecodeConfig = DecodeConfig(),
):
    """Returns (centroid(2) int32 [x, y], bbox(4) int32 [l, t, r, b],
    area float32, found bool)."""
    h, w = prob_map.shape
    mask, labels, min_x, max_x, min_y, max_y = _heat_components(
        prob_map, cfg
    )

    area = jnp.where(mask, (max_x - min_x) * (max_y - min_y), -1)
    max_area = jnp.max(area)
    # earliest cluster (smallest root id) among area ties, like the
    # strictly-greater scan of predict.py:58-71; any pixel of the winning
    # cluster carries the same extents, so pick the first such pixel
    key = jnp.where(mask & (area == max_area), labels, _BIG_I)
    winner = jnp.argmin(key.ravel())
    wy, wx = winner // w, winner % w

    found = max_area > cfg.min_bbox_area
    bbox = jnp.stack(
        [
            min_x[wy, wx] + 2,
            min_y[wy, wx] + 2,
            max_x[wy, wx] - 2,
            max_y[wy, wx] - 2,
        ]
    ).astype(jnp.int32)
    centroid = jnp.stack(
        [
            ((bbox[0] + bbox[2]).astype(jnp.float32) / 2.0).astype(jnp.int32),
            ((bbox[1] + bbox[3]).astype(jnp.float32) / 2.0).astype(jnp.int32),
        ]
    )
    zero2 = jnp.zeros(2, jnp.int32)
    zero4 = jnp.zeros(4, jnp.int32)
    return (
        jnp.where(found, centroid, zero2),
        jnp.where(found, bbox, zero4),
        jnp.where(found, max_area.astype(jnp.float32), 0.0),
        found,
    )


def _topk_roots(mask, labels, min_x, max_x, min_y, max_y, cfg, k):
    """Top-k cluster roots by bbox area over _heat_components output.
    Returns (root_idx (k,) flat int32, found (k,), bboxes (k, 4)
    [l, t, r, b] shrunk by 2, centroids (k, 2) [x, y], areas (k,)).
    Ties keep scipy scan order (top_k is stable, so equal areas resolve
    to the smaller flat index = the smaller root label) — the single
    definition of the selection/shrink/centroid semantics shared by the
    corner (find_obstacles_topk) and direct (decode_frame_direct) paths."""
    h, w = mask.shape
    flat_ids = (
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
        + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    )
    # exactly one representative pixel per cluster: its root
    is_root = mask & (labels == flat_ids)
    area = (max_x - min_x) * (max_y - min_y)
    score = jnp.where(is_root, area, -1)
    areas, idx = jax.lax.top_k(score.ravel(), k)
    wy, wx = idx // w, idx % w

    found = areas > cfg.min_bbox_area
    bboxes = jnp.stack(
        [
            min_x[wy, wx] + 2,
            min_y[wy, wx] + 2,
            max_x[wy, wx] - 2,
            max_y[wy, wx] - 2,
        ],
        axis=-1,
    ).astype(jnp.int32)
    centroids = jnp.stack(
        [
            ((bboxes[:, 0] + bboxes[:, 2]).astype(jnp.float32) / 2.0).astype(
                jnp.int32
            ),
            ((bboxes[:, 1] + bboxes[:, 3]).astype(jnp.float32) / 2.0).astype(
                jnp.int32
            ),
        ],
        axis=-1,
    )
    return idx, found, bboxes, centroids, areas


def find_obstacles_topk(
    prob_map: jax.Array,  # (H, W) foreground probability
    cfg: DecodeConfig = DecodeConfig(),
    k: int = 4,
):
    """Top-K clusters by bbox area — the multi-obstacle extension the
    reference never had (its `find_obstacle` keeps only the largest
    cluster, predict.py:58-71). Returns (centroids (K, 2) int32 [x, y],
    bboxes (K, 4) int32 [l, t, r, b], areas (K,) float32, found (K,)),
    ordered by descending area; ties keep scipy scan order (smaller root
    label first, matching find_obstacle's tie-break)."""
    mask, labels, min_x, max_x, min_y, max_y = _heat_components(
        prob_map, cfg
    )
    _, found, bboxes, centroids, areas = _topk_roots(
        mask, labels, min_x, max_x, min_y, max_y, cfg, k
    )
    fm = found[:, None]
    return (
        jnp.where(fm, centroids, 0),
        jnp.where(fm, bboxes, 0),
        jnp.where(found, areas.astype(jnp.float32), 0.0),
        found,
    )


def back_project_2d_to_3d(
    centroid: jax.Array,  # (2,) int32 [x, y]
    bbox: jax.Array,  # (4,) int32 [l, t, r, b]
    dist_img: jax.Array,  # (H, W)
    height_img: jax.Array,  # (H, W)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
):
    """Returns (xyz(3,), centroid'(2,) int32, ok bool)."""
    h, w = dist_img.shape
    valid = (dist_img > 0) & (height_img > spec.min_height)
    cx, cy = centroid[0], centroid[1]
    centroid_ok = valid[cy, cx]

    # nearest-valid fallback inside the (inclusive) bbox, masked over the
    # full image: raster-order argmin among in-bbox pixels matches the
    # reference's subgrid argmin (predict.py:243-275). Full-image masking
    # replaces a vmapped data-dependent dynamic_slice, which lowers to a
    # batched XLA gather.
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_window = (
        (rows >= bbox[1])
        & (rows <= bbox[3])
        & (cols >= bbox[0])
        & (cols <= bbox[2])
    )
    d2c = jnp.sqrt(
        ((cols - cx).astype(jnp.float32)) ** 2
        + ((rows - cy).astype(jnp.float32)) ** 2
    )
    d2c = jnp.where(valid & in_window, d2c, _SENTINEL)
    flat_arg = jnp.argmin(d2c.ravel())  # first minimum in raster order
    fb_y = (flat_arg // w).astype(jnp.int32)
    fb_x = (flat_arg % w).astype(jnp.int32)
    fb_ok = d2c.ravel()[flat_arg] < _SENTINEL

    use_fallback = (~centroid_ok) & (bbox[0] != 0) & (bbox[2] != 0)
    new_cx = jnp.where(use_fallback, jnp.where(fb_ok, fb_x, 0), cx)
    new_cy = jnp.where(use_fallback, jnp.where(fb_ok, fb_y, 0), cy)

    nonzero = ~((new_cx == 0) & (new_cy == 0))
    d = dist_img[new_cy, new_cx] + cfg.range_offset
    theta = (new_cx.astype(jnp.float32) + spec.x_min) * spec.res_h_rad
    xyz = jnp.stack(
        [d * jnp.cos(theta), -d * jnp.sin(theta), height_img[new_cy, new_cx]]
    )
    xyz = jnp.where(nonzero, xyz, 0.0)
    return xyz, jnp.stack([new_cx, new_cy]), nonzero


def corner_vote(
    y_pred: jax.Array,  # (H, W, 2+24)
    image: jax.Array,  # (H, W, >=2) distance/height
    bbox: jax.Array,  # (4,) int32 [l, t, r, b]
    centroid_3d: jax.Array,  # (3,)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
):
    """Returns (pose(7,) [xyz, yaw, l, w, h], box(8,3), ok bool).

    Candidates come from the FULL image masked to bbox +- margins —
    exactly the reference's scan span (predict.py:103). (An earlier
    revision worked in a 512-column dynamic_slice window for static
    shapes; a vmapped data-dependent dynamic_slice lowers to a batched
    XLA gather, and the window also truncated candidates for very wide
    bboxes. Full-image masking removes both.)
    """
    h, w = y_pred.shape[:2]

    pos = y_pred[..., 1] >= cfg.min_prob
    col_has_pos = jnp.any(pos, axis=0)  # (W,)
    row_has_pos = jnp.any(pos, axis=1)  # (H,)

    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_window = (
        (cols >= bbox[0] - cfg.margin_x)
        & (cols < bbox[2] + cfg.margin_x)
        & (rows >= bbox[1] - cfg.margin_y)
        & (rows < bbox[3] + cfg.margin_y)
    )
    cand = in_window & col_has_pos[None, :] & row_has_pos[:, None]

    # fixed-budget candidate selection in the reference's column-major scan
    # order (predict.py loops x outer, y inner) BEFORE decoding corners —
    # the expensive per-pixel inversion then runs on K pixels, not the
    # whole image. The rank is computed hierarchically — a height-H cumsum
    # down each column plus a width-W exclusive prefix of column totals.
    # The rank->pixel inversion is scatter-free (no H*W-update scatter
    # into the slot array): each slot finds its column by counting
    # ended column ranges (compare-sum), pulls that column's cumulative
    # counts through a one-hot matmul
    # (exact: one-hot selection in "highest" splits operands losslessly),
    # and locates its row as the first place the cumulative hits the
    # slot's within-column rank.
    k = min(cfg.max_candidates, h * w)
    within = jnp.cumsum(cand.astype(jnp.int32), axis=0)  # (H, W) down cols
    col_tot = within[-1, :]
    col_pre = jnp.cumsum(col_tot) - col_tot  # exclusive column prefix
    total = col_pre[-1] + col_tot[-1]
    col_end = col_pre + col_tot  # (W,)
    slots = jax.lax.broadcasted_iota(jnp.int32, (k,), 0)
    sel_valid = slots < total

    # column of slot s = #columns whose candidate range ends at or before s
    sel_col = jnp.sum(
        (col_end[None, :] <= slots[:, None]).astype(jnp.int32), axis=1
    )
    sel_col = jnp.minimum(sel_col, w - 1)
    onehot = (
        sel_col[None, :] == jax.lax.broadcasted_iota(jnp.int32, (w, k), 0)
    ).astype(jnp.float32)  # (W, K)
    # round(): the values are integers < 2**16, but a multi-pass f32
    # matmul may return them with sub-ulp error that would break an
    # exact equality compare — rounding restores integer exactness
    col_vals = jnp.round(
        jnp.matmul(within.astype(jnp.float32), onehot, precision="highest")
    )  # (H, K): each slot's column of cumulative counts
    col_pre_sel = jnp.round(
        jnp.matmul(
            col_pre.astype(jnp.float32)[None, :], onehot, precision="highest"
        )[0]
    )  # (K,)
    r_in_col = (slots + 1).astype(jnp.float32) - col_pre_sel  # 1-based
    # cumulative count jumps to r_in_col exactly at the candidate row
    sel_row = jnp.argmax(col_vals >= r_in_col[None, :], axis=0).astype(
        jnp.int32
    )

    # gather the selected pixels' data and invert the corner encoding
    # only for them: c = Rz(theta) Ry(phi) c' + p  (predict.py:118-131)
    gather_ids = sel_row * w + sel_col
    reg = y_pred[..., 2:].reshape(-1, 24)[gather_ids]  # (K, 24)
    dist_h = image[..., :2].reshape(-1, 2)[gather_ids]  # (K, 2)
    theta = (
        sel_col.astype(jnp.float32) + spec.x_min
    ) * spec.res_h_rad
    phi = (sel_row.astype(jnp.float32) + spec.y_min) * spec.res_v_rad
    rot = jnp.einsum(
        "kij,kjl->kil", rot_z(theta), rot_y(phi), precision="highest"
    )  # (K, 3, 3)
    p3 = jnp.stack(
        [
            dist_h[:, 0] * jnp.cos(theta),
            -dist_h[:, 0] * jnp.sin(theta),
            dist_h[:, 1],
        ],
        axis=-1,
    )  # (K, 3)
    c_prime = reg.reshape(k, 8, 3)
    sel_corners = (
        jnp.einsum("kij,kcj->kci", rot, c_prime, precision="highest")
        + p3[:, None, :]
    )  # (K, 8, 3)

    # is_far: every corner within far_delta of the 3D centroid
    delta = jnp.asarray(cfg.far_delta, jnp.float32)
    near = jnp.all(
        jnp.abs(sel_corners - centroid_3d[None, None, :]) <= delta,
        axis=(-1, -2),
    )
    sel_valid = sel_valid & near
    sel = sel_corners.reshape(k, 24)

    # pairwise neighbor count within max_bbox_dist (Frobenius over 24 dims).
    # Center on the 3D centroid first: pairwise distances are translation
    # invariant and the small magnitudes keep the f32 Gram trick accurate.
    # NB cross-platform: a reduced-precision product ("high") can flip
    # pairs sitting exactly at the max_bbox_dist threshold vs a true f32
    # matmul, which perturbs the winner set and the averaged box in the
    # 3rd decimal; the CPU path pins the reference semantics in tests.
    sel_c = sel - jnp.tile(centroid_3d, 8)[None, :]
    sq = jnp.sum(sel_c * sel_c, axis=1)
    gram = jnp.matmul(sel_c, sel_c.T, precision="high")
    d2 = jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * gram, 0.0)
    d2 = jnp.where(jnp.eye(k, dtype=bool), 0.0, d2)
    pair_ok = (
        (d2 > 1e-9)
        & (d2 < cfg.max_bbox_dist**2)
        & sel_valid[None, :]
        & sel_valid[:, None]
    )
    counts = jnp.sum(pair_ok, axis=1)
    counts = jnp.where(sel_valid, counts, -1)
    max_count = jnp.max(counts)
    winners = sel_valid & (counts == max_count)
    n_win = jnp.maximum(jnp.sum(winners), 1)
    box = jnp.sum(
        jnp.where(winners[:, None], sel, 0.0), axis=0
    ).reshape(8, 3) / n_win

    ok = jnp.any(sel_valid)

    # pose from corner geometry (predict.py:166-197)
    i = jnp.arange(4)
    dx = box[i, 0] - box[i + 4, 0]
    dy = box[i, 1] - box[i + 4, 1]
    yaw = jnp.arctan2(dy, dx)
    cos_yaw = jnp.cos(yaw)
    safe_cos = jnp.where(jnp.abs(cos_yaw) > 1e-12, cos_yaw, 1.0)
    box_l = jnp.where(jnp.abs(cos_yaw) > 1e-12, dx / safe_cos, dy)
    dx2 = box[i, 0] - box[i + 2, 0]
    dy2 = box[i, 1] - box[i + 2, 1]
    box_w = jnp.where(jnp.abs(cos_yaw) > 1e-12, dy2 / safe_cos, dx2)
    box_h = jnp.abs(box[i, 2] - box[i + 1, 2])

    pose = jnp.concatenate(
        [
            jnp.mean(box, axis=0),
            jnp.stack(
                [
                    jnp.mean(yaw),
                    jnp.mean(jnp.abs(box_l)),
                    jnp.mean(jnp.abs(box_w)),
                    jnp.mean(box_h),
                ]
            ),
        ]
    )
    pose = jnp.where(ok, pose, 0.0)
    box = jnp.where(ok, box, 0.0)
    # signal budget overflow: the reference scans an unbounded candidate
    # list; we truncate at k in scan order
    overflow = total > k
    return pose, box, ok, overflow


def decode_frame(
    y_pred: jax.Array,  # (H, W, 2+24) network output
    image: jax.Array,  # (H, W, >=2) distance/height channels
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
) -> dict[str, jax.Array]:
    """Full per-frame decode; mirrors the staging of predict.py:441-505.

    Returns pose (7,) = (tx, ty, tz, rz, l, w, h) — zeros when no obstacle
    survives all stages — plus the intermediate products.
    """
    prob = y_pred[..., 1]
    centroid, bbox, area, found = find_obstacle(prob, cfg)

    centroid_nonzero = ~((centroid[0] == 0) & (centroid[1] == 0))
    stage1 = found & centroid_nonzero

    xyz, centroid2, bp_ok = back_project_2d_to_3d(
        centroid, bbox, image[..., 0], image[..., 1], spec, cfg
    )
    stage2 = stage1 & bp_ok & ~((xyz[0] == 0.0) & (xyz[1] == 0.0))

    pose, box, cv_ok, overflow = corner_vote(y_pred, image, bbox, xyz, spec, cfg)
    ok = stage2 & cv_ok

    zero7 = jnp.zeros(7, jnp.float32)
    return {
        "pose": jnp.where(ok, pose, zero7),
        "found": ok,
        "centroid_2d": jnp.where(stage1, centroid, 0),
        "bbox_2d": jnp.where(stage1, bbox, 0),
        "centroid_3d": jnp.where(stage2, xyz, 0.0),
        "corners_3d": jnp.where(ok, box, 0.0),
        "area": area,
        # True when the fixed vote budget truncated the candidate set —
        # the pose may then diverge from the reference's unbounded scan
        "vote_overflow": stage2 & overflow,
    }


def decode_frame_multi(
    y_pred: jax.Array,  # (H, W, 2+24)
    image: jax.Array,  # (H, W, >=2)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
    k: int = 4,
) -> dict[str, jax.Array]:
    """Multi-obstacle decode: top-K clusters each through back-projection
    + corner voting. Returns poses (K, 7) ordered by cluster area and
    found (K,) — the shape `serve.tracker.PoseTracker.step` consumes."""
    prob = y_pred[..., 1]
    centroids, bboxes, areas, founds = find_obstacles_topk(prob, cfg, k)

    def one(centroid, bbox, found):
        stage1 = found & ~((centroid[0] == 0) & (centroid[1] == 0))
        xyz, _, bp_ok = back_project_2d_to_3d(
            centroid, bbox, image[..., 0], image[..., 1], spec, cfg
        )
        stage2 = stage1 & bp_ok & ~((xyz[0] == 0.0) & (xyz[1] == 0.0))
        pose, _, cv_ok, overflow = corner_vote(
            y_pred, image, bbox, xyz, spec, cfg
        )
        ok = stage2 & cv_ok
        return jnp.where(ok, pose, 0.0), ok, stage2 & overflow

    poses, oks, overflow = jax.vmap(one)(centroids, bboxes, founds)
    return {
        "poses": poses,
        "found": oks,
        "areas": areas,
        "vote_overflow": overflow,
    }


def decode_batch(y_pred, images, spec=RangeViewSpec(), cfg=DecodeConfig()):
    """(B, H, W, 26), (B, H, W, C) -> dict of batched decode products."""
    return jax.vmap(lambda p, im: decode_frame(p, im, spec, cfg))(
        y_pred, images
    )


def decode_batch_multi(
    y_pred, images, spec=RangeViewSpec(), cfg=DecodeConfig(), k: int = 4
):
    """(B, H, W, 26), (B, H, W, C) -> dict with poses (B, K, 7) etc."""
    return jax.vmap(lambda p, im: decode_frame_multi(p, im, spec, cfg, k))(
        y_pred, images
    )


# ---------------------------------------------------------------------------
# Direct-pose decode (framework extension; pairs with ModelConfig.head=
# "direct" and geometry/encoding.encode_direct_label). Cluster discovery is
# identical to the reference path (_heat_components); the pose then comes
# from probability-weighted averaging of the per-pixel direct predictions
# over the winning cluster's valid pixels — no corner voting.
# ---------------------------------------------------------------------------


def _direct_pose_from_cluster(
    y_pred: jax.Array,  # (H, W, 2+8) [bkg, fg, dc(3), lwh(3), sin, cos]
    image: jax.Array,  # (H, W, >=2)
    cluster: jax.Array,  # (H, W) bool — pixels of one cluster
    spec: RangeViewSpec,
    cfg: DecodeConfig,
    with_center: bool = True,
):
    """Weighted average of decoded per-pixel poses over cluster pixels with
    valid returns. Returns (pose (7,), ok bool). with_center=False skips
    the per-pixel center einsum (pose[:3] is zeros) — used by the hybrid
    decode, whose position comes from back-projection instead."""
    from tpufusion.geometry.encoding import pixel_points, pixel_rotations

    valid = (image[..., 0] > 0) & (image[..., 1] > spec.min_height)
    m = cluster & valid & (y_pred[..., 1] >= cfg.min_prob)
    w = jnp.where(m, y_pred[..., 1], 0.0)
    tot = jnp.maximum(jnp.sum(w), 1e-6)

    lwh = jnp.sum(y_pred[..., 5:8] * w[..., None], axis=(0, 1)) / tot
    dual = y_pred.shape[-1] >= 12  # [.., sin_l, cos_l, sin_g, cos_g]

    def _local_mean():
        # channels carry sin/cos(yaw + theta_pixel) — yaw relative to the
        # pixel's physical ray azimuth -theta (see encode_direct_label):
        # rotate each pixel's vector back BEFORE averaging (angle
        # subtraction on the vector field)
        from tpufusion.geometry.encoding import pixel_angles

        s_px, c_px = y_pred[..., 8], y_pred[..., 9]
        theta, _ = pixel_angles(spec)
        st, ct = jnp.sin(theta), jnp.cos(theta)
        s_px, c_px = s_px * ct - c_px * st, c_px * ct + s_px * st
        return jnp.sum(s_px * w) / tot, jnp.sum(c_px * w) / tot

    def _global_mean():
        gi = 10 if dual else 8
        return (
            jnp.sum(y_pred[..., gi] * w) / tot,
            jnp.sum(y_pred[..., gi + 1] * w) / tot,
        )

    if cfg.direct_yaw_frame == "local":
        sin_m, cos_m = _local_mean()
        oriented = jnp.bool_(True)
    elif cfg.direct_yaw_frame == "global":
        sin_m, cos_m = _global_mean()
        oriented = jnp.bool_(False)
    elif cfg.direct_yaw_frame == "auto":
        # dual-codec gate: the codec that is UNOBSERVABLE on this
        # cluster's surface family collapses toward the zero vector (the
        # L2-optimal prediction under a near-uniform conditional angle
        # distribution — NOTES.md round-3 sessions B/D), so the weighted
        # mean vector's magnitude is each codec's own confidence.
        if not dual:
            raise ValueError(
                "direct_yaw_frame='auto' needs a dual-codec head "
                "(ModelConfig.yaw_codec='dual', 12-channel output); got "
                f"{y_pred.shape[-1]} channels"
            )
        sl, cl = _local_mean()
        sg, cg = _global_mean()
        use_local = sl * sl + cl * cl >= sg * sg + cg * cg
        sin_m = jnp.where(use_local, sl, sg)
        cos_m = jnp.where(use_local, cl, cg)
        oriented = use_local
    else:
        raise ValueError(f"unknown direct_yaw_frame "
                         f"{cfg.direct_yaw_frame!r}")
    yaw = jnp.arctan2(sin_m, cos_m)

    p = jax.lax.stop_gradient(pixel_points(image, spec))  # (H, W, 3)
    # prob-weighted mean of the cluster's raw surface points (physical
    # frame) — the position seed of the "surface" center mode. The heat
    # cluster covers the label's footprint RECT, so some of its rays miss
    # the vehicle and hit background clutter tens of meters behind it
    # (the same contamination the reg-target-norm clip fights in
    # models/losses.py); gate to returns within a vehicle-depth margin of
    # the cluster's closest return before averaging.
    d = image[..., 0]
    dmin = jnp.min(jnp.where(m, d, jnp.inf))
    msurf = m & (d <= dmin + 4.0)
    wsurf = jnp.where(msurf, y_pred[..., 1], 0.0)
    p_mean = (
        jnp.sum(p * wsurf[..., None], axis=(0, 1))
        / jnp.maximum(jnp.sum(wsurf), 1e-6)
    )
    if with_center:
        rot = pixel_rotations(spec)  # (H, W, 3, 3)
        dc = y_pred[..., 2:5]
        c_phys_px = (
            jnp.einsum("hwij,hwj->hwi", rot, dc, precision="highest") + p
        )  # per-pixel decoded physical center
        c_phys = jnp.sum(c_phys_px * w[..., None], axis=(0, 1)) / tot
        # back to the reference's conventional frame: Rz(-yaw) c_phys
        c, s = jnp.cos(-yaw), jnp.sin(-yaw)
        center = jnp.stack(
            [
                c * c_phys[0] - s * c_phys[1],
                s * c_phys[0] + c * c_phys[1],
                c_phys[2],
            ]
        )
    else:
        center = jnp.zeros(3, jnp.float32)
    pose = jnp.concatenate([center, yaw[None], lwh])
    ok = jnp.sum(m) > 0
    return jnp.where(ok, pose, 0.0), ok, p_mean, oriented


def _silhouette_center(
    y_pred: jax.Array,  # (H, W, 2+8)
    image: jax.Array,  # (H, W, >=2)
    cluster: jax.Array,  # (H, W) bool
    spec: RangeViewSpec,
    cfg: DecodeConfig,
    yaw: jax.Array,  # scalar — predicted box heading (physical frame)
    lwh: jax.Array,  # (3,) — predicted box size
    seed: jax.Array,  # (3,) — robust center seed (pushed geometric)
) -> jax.Array:
    """Refine a center seed laterally by fitting the box to the cluster's
    observed surface silhouette.

    Rotate the cluster's surface points near `seed` by -yaw into the box
    frame; along each box axis the feasible centers form the interval
    [max_pt - half, min_pt + half] and its midpoint equals the extent
    midpoint. When an axis is viewed head-on only the near face is
    observed, so the box extends AWAY from the sensor from the near
    edge (center = near_edge + half); when viewed broadside the full
    extent is visible and the midpoint is right. Blend the two by
    |cos d| / |sin d| of the ray-vs-heading angle. This constrains the
    LATERAL center directly — the component the radial push of the
    "geometric"/"surface" modes cannot see (a 1 m lateral offset alone
    caps a 4.2x1.6 box's IoU at ~0.23). Outlier control: only points
    within half a box diagonal (+1 m) of the robust seed count, so
    footprint rays that hit background clutter (the failure of a
    min-range gate) cannot stretch the extents; with fewer than 5 gated
    points the seed is returned unchanged."""
    from tpufusion.geometry.encoding import pixel_points

    # no prob gate here: a trained heat map's high-confidence pixels are
    # a spatially biased subset (strongest beams) that under-covers the
    # silhouette; the physical seed gate below is the outlier control
    valid = (image[..., 0] > 0) & (image[..., 1] > spec.min_height)
    m = cluster & valid
    p = jax.lax.stop_gradient(pixel_points(image, spec))
    gate = 0.5 * jnp.sqrt(lwh[0] ** 2 + lwh[1] ** 2) + 1.0
    near = jnp.sum((p - seed) ** 2, axis=-1) <= gate * gate
    mext = m & near
    n = jnp.sum(mext)

    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    u = p[..., 0] * cy + p[..., 1] * sy
    v = -p[..., 0] * sy + p[..., 1] * cy
    # 3%/97% quantile extents: min/max would hand the near-face edge to
    # a single stray pixel (ground return / clutter inside the seed gate)
    nan = jnp.float32(jnp.nan)
    u_m = jnp.where(mext, u, nan)
    v_m = jnp.where(mext, v, nan)
    min_u = jnp.nanquantile(u_m, 0.03)
    max_u = jnp.nanquantile(u_m, 0.97)
    min_v = jnp.nanquantile(v_m, 0.03)
    max_v = jnp.nanquantile(v_m, 0.97)
    ray_az = jnp.arctan2(seed[1], seed[0])
    d_rel = ray_az - yaw
    cos_d, sin_d = jnp.cos(d_rel), jnp.sin(d_rel)
    half_l, half_w = 0.5 * lwh[0], 0.5 * lwh[1]
    cu_near = jnp.where(cos_d > 0, min_u + half_l, max_u - half_l)
    cv_near = jnp.where(sin_d > 0, min_v + half_w, max_v - half_w)
    # Only the near-face constraint is trustworthy under PARTIAL heat
    # coverage (the near face is the densest part of the silhouette;
    # extent MIDpoints are biased toward whichever side the cluster
    # happened to cover — measured: midpoint fallback cut u error 0.74
    # -> 0.53 m but grew v error 0.51 -> 0.81 m on trained heat). Weight
    # each axis's near-face constraint by how head-on the ray is to that
    # axis and defer to the robust seed for the rest.
    u_seed = seed[0] * cy + seed[1] * sy
    v_seed = -seed[0] * sy + seed[1] * cy
    a_u, a_v = jnp.abs(cos_d), jnp.abs(sin_d)
    cu = a_u * cu_near + (1 - a_u) * u_seed
    cv = a_v * cv_near + (1 - a_v) * v_seed
    p_sil = jnp.stack([cu * cy - cv * sy, cu * sy + cv * cy, seed[2]])
    return jnp.where(n >= 5, p_sil, seed)


# "fit" center-mode constants (see _fit_pose_to_surface): yaw-candidate
# grid over [0, pi), Gauss-Newton iterations per candidate, seed-prior
# strength (fraction of the point count), acceptance radius around the
# seed, and the minimum gated point count for a trustworthy fit.
_FIT_PHI_CANDIDATES = 36
_FIT_GN_ITERS = 4
_FIT_PRIOR = 0.08
_FIT_ACCEPT_DIST = 2.0
_FIT_MIN_POINTS = 5


def _fit_pose_to_surface(
    image: jax.Array,  # (H, W, >=2)
    cluster: jax.Array,  # (H, W) bool — pixels of one cluster
    spec: RangeViewSpec,
    cfg: DecodeConfig,
    yaw: jax.Array,  # scalar — head yaw (physical heading), phi fallback
    lwh: jax.Array,  # (3,) — head box size
    seed: jax.Array,  # (3,) — robust center seed (consensus, physical)
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Model-based pose refinement: fit the box's known-size boundary
    curve to the cluster's raw 3D surface points, returning
    (center_phys (3,), phi, ok_fit).

    The conv head resolves yaw to only ~0.4-0.5 rad (the visible arc's
    orientation must be read off a 1-2 px-thick crescent), and every
    push-style center estimator inherits that error. The surface points
    themselves pin both: an oriented ellipse with KNOWN semi-axes
    fit_surface_scale*(l/2, w/2) has 3 free parameters (cx, cy, phi);
    ~40-100 exact surface returns over-determine them. Solved as a grid
    over phi in [0, pi) (the boundary is pi-symmetric; the head yaw
    resolves which end is the nose) x damped Gauss-Newton in (cx, cy)
    per candidate, all fixed-shape and batch-vmappable.

    Two measured failure modes are guarded (NOTES.md round 3):
      * shallow arcs constrain the center tangentially but not radially
        (J^T J near-singular along the viewing ray) — a Tikhonov prior
        of strength _FIT_PRIOR * n_points anchors the flat direction to
        the seed;
      * the fit must start from the CONSENSUS seed: seeding from the raw
        surface mean let rare clutter-latched clusters drag the
        regularized fit meters off (consensus cross-checks the surface
        mean against back-projection first).
    A fit farther than _FIT_ACCEPT_DIST from its seed, or with fewer
    than _FIT_MIN_POINTS gated points, reports ok_fit=False (callers
    keep the seed + head yaw). cfg.fit_boundary="circle" fits a circle
    of radius fit_surface_scale*0.5*sqrt(l^2+w^2) instead — center only,
    phi stays the head's (rotationally symmetric obstacles carry no
    orientation signal). cfg.fit_boundary="box" fits the l x w RECTANGLE
    outline (scaled-Chebyshev residual max(|u|/a, |v|/b) - 1, active-face
    GN) — the rectangle model the reference's own decode assumed
    (predict.py:166-197) and the right boundary for L-shaped real
    vehicle silhouettes; its only inputs are the head's size estimate
    and the raw returns, no generator constant.
    """
    from tpufusion.geometry.encoding import pixel_points

    l_, w_ = lwh[0], lwh[1]
    if cfg.fit_boundary == "circle":
        a = b = jnp.maximum(
            cfg.fit_surface_scale * 0.5 * jnp.sqrt(l_ * l_ + w_ * w_),
            1e-2,
        )
        # phi is irrelevant for a circle; one candidate (the head yaw)
        phis = (yaw % jnp.pi)[None]
    elif cfg.fit_boundary in ("ellipse", "box"):
        a = jnp.maximum(cfg.fit_surface_scale * l_ / 2.0, 1e-2)
        b = jnp.maximum(cfg.fit_surface_scale * w_ / 2.0, 1e-2)
        grid = (
            jnp.arange(_FIT_PHI_CANDIDATES, dtype=jnp.float32)
            / _FIT_PHI_CANDIDATES
            * jnp.pi
        )
        phis = jnp.concatenate([grid, (yaw % jnp.pi)[None]])
    else:
        raise ValueError(f"unknown fit_boundary {cfg.fit_boundary!r}")

    # gated surface points: cluster pixels with real returns, within a
    # vehicle depth of the nearest return (the heat cluster spans the
    # footprint RECT, so some rays hit background behind the vehicle)
    # and within a box diagonal (+margin) of the seed
    valid = (image[..., 0] > 0) & (image[..., 1] > spec.min_height)
    m = cluster & valid
    p = jax.lax.stop_gradient(pixel_points(image, spec))
    d = image[..., 0]
    dmin = jnp.min(jnp.where(m, d, jnp.inf))
    gate = 0.5 * jnp.sqrt(l_ * l_ + w_ * w_) + 3.0
    near = jnp.sum((p - seed) ** 2, axis=-1) <= gate * gate
    msurf = m & (d <= dmin + 4.0) & near
    px = p[..., 0].reshape(-1)
    py = p[..., 1].reshape(-1)
    wts = msurf.reshape(-1).astype(jnp.float32)
    nw = jnp.maximum(jnp.sum(wts), 1e-6)
    lam = _FIT_PRIOR * nw
    seed_xy = seed[:2]

    def residual(m_xy, phi):
        """(r, (gu, gv, c, s)): residual per point + its gradient in the
        BOX FRAME (u along phi, v across). ellipse/circle: the scaled
        quadratic (u/a)^2 + (v/b)^2 - 1; box: the scaled Chebyshev
        max(|u|/a, |v|/b) - 1, zero exactly on the rectangle outline —
        its gradient is the active face's normal (piecewise-constant,
        the standard active-set linearization for GN)."""
        c, s = jnp.cos(phi), jnp.sin(phi)
        dx = px - m_xy[0]
        dy = py - m_xy[1]
        u = c * dx + s * dy
        v = -s * dx + c * dy
        if cfg.fit_boundary == "box":
            su = jnp.abs(u) / a
            sv = jnp.abs(v) / b
            r = jnp.maximum(su, sv) - 1.0
            act_u = su >= sv
            gu = jnp.where(act_u, jnp.sign(u) / a, 0.0)
            gv = jnp.where(act_u, 0.0, jnp.sign(v) / b)
        else:
            vx = u / a
            vy = v / b
            r = vx * vx + vy * vy - 1.0
            gu = 2.0 * vx / a
            gv = 2.0 * vy / b
        return r, (gu, gv, c, s)

    def gn(phi):
        def body(m_xy, _):
            r, (gx, gy, c, s) = residual(m_xy, phi)
            # dr/dm = -R(phi) @ (gu, gv)
            jx = -(c * gx - s * gy)
            jy = -(s * gx + c * gy)
            jxx = jnp.sum(wts * jx * jx) + lam
            jxy = jnp.sum(wts * jx * jy)
            jyy = jnp.sum(wts * jy * jy) + lam
            bx = jnp.sum(wts * jx * r) + lam * (m_xy[0] - seed_xy[0])
            by = jnp.sum(wts * jy * r) + lam * (m_xy[1] - seed_xy[1])
            det = jxx * jyy - jxy * jxy
            m_xy = m_xy - jnp.stack(
                [(jyy * bx - jxy * by) / det, (jxx * by - jxy * bx) / det]
            )
            return m_xy, None

        m_xy, _ = jax.lax.scan(body, seed_xy, None, length=_FIT_GN_ITERS)
        r, _ = residual(m_xy, phi)
        return m_xy, jnp.sum(wts * r * r) / nw

    ms, ress = jax.vmap(gn)(phis)
    i = jnp.argmin(ress)
    # Orientation identifiability guard: the head-yaw candidate is the
    # LAST grid entry; adopt the grid winner only when its residual
    # beats the head candidate's by a clear margin. A shallow arc's
    # residual is nearly flat in phi, so its argmin is noise (measured:
    # wrong-lobe picks up to 0.66 rad off); when flat, keep the head yaw
    # but still take ITS fitted center (the center refinement does not
    # need phi identifiability). With an unbiased head the two residuals
    # tie and the head yaw is preserved exactly.
    decisive = ress[i] < 0.9 * ress[-1]
    ctr = jnp.where(decisive, ms[i], ms[-1])
    phi = jnp.where(decisive, phis[i], phis[-1])
    # resolve the ellipse's pi-symmetry with the head yaw
    cand = jnp.stack([phi, phi + jnp.pi, phi - jnp.pi])
    pick = jnp.argmin(
        jnp.abs(((cand - yaw) + jnp.pi) % (2 * jnp.pi) - jnp.pi)
    )
    phi = cand[pick]
    ok_fit = (jnp.sum(wts) >= _FIT_MIN_POINTS) & (
        jnp.sum((ctr - seed_xy) ** 2) <= _FIT_ACCEPT_DIST**2
    )
    center = jnp.concatenate([ctr, seed[2:]])
    return (
        jnp.where(ok_fit, center, seed),
        jnp.where(ok_fit, phi, yaw),
        ok_fit,
    )


def decode_frame_direct(
    y_pred: jax.Array,  # (H, W, 2+8)
    image: jax.Array,  # (H, W, >=2)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
    k: int = 1,
    center: str | None = None,
) -> dict[str, jax.Array]:
    """Direct-head decode: top-k clusters -> poses (k, 7).

    `center` (None -> cfg.direct_center) picks the position estimator:

    "backproject" is the hybrid estimator: position from the cluster's
    back-projected bbox-center pixel + the fixed range_offset (the
    reference's robust path — measured 0.87-within-2m vs 0.37 for the
    averaged head center at 2k training steps), size/yaw from the
    averaged head channels. "geometric" replaces the fixed offset with
    half the box's radial extent along the viewing ray computed from the
    head's own l/w/yaw — on beam-structured scans the visible face sits
    0.8-2.1 m in front of the center depending on aspect, so any constant
    offset is systematically wrong. "surface" seeds the position from the
    prob-weighted MEAN of the cluster's raw surface points (instead of
    the single back-projected bbox-center pixel) before the same
    geometric push — averaging tens of surface returns cuts the lateral
    error that dominates box IoU (a 1 m width-direction offset alone caps
    IoU at ~0.23 for a 4.2x1.6 box). "silhouette" fits the box to the
    gated surface points in the predicted-yaw box frame (near-face /
    extent-midpoint blend per axis — see _silhouette_center): the
    only estimator that constrains the LATERAL center directly.
    "consensus" takes the surface estimate unless it disagrees with the
    geometric one by more than 2.5 m, then falls back to geometric —
    surface wins mean IoU (its averaging is lateral-accurate) but its
    mean xy error is dragged by rare frames where the range gate latches
    onto clutter; geometric never blows up (tuner sweep: surface IoU
    0.397/xy 1.58 vs geometric 0.345/0.83 — consensus keeps both ends).
    "head" uses the head's averaged center too — the exact inverse of
    encode_direct_label (round-trip tested). "fit" starts from the
    consensus estimate and refines center AND yaw by fitting the box's
    known-size boundary curve to the cluster's raw surface points
    (_fit_pose_to_surface) — the round-3 accuracy winner on both shipped
    assets (config-4 protocol: flagship IoU 0.50 -> 0.66 / xy 0.71 ->
    0.38 m; wide-yaw IoU 0.42 -> 0.66 / yaw err 0.48 -> 0.16 rad).

    k=1 mirrors decode_frame's largest-cluster semantics but still returns
    (1, 7)/(1,) shaped outputs; squeeze at the call site if needed."""
    if center is None:
        center = cfg.direct_center
    if center not in (
        "backproject", "geometric", "surface", "head", "silhouette",
        "consensus", "fit",
    ):
        raise ValueError(f"unknown direct_center {center!r}")
    prob = y_pred[..., 1]
    mask, labels, min_x, max_x, min_y, max_y = _heat_components(prob, cfg)
    idx, found, bboxes, centroids, areas = _topk_roots(
        mask, labels, min_x, max_x, min_y, max_y, cfg, k
    )
    if center in ("geometric", "silhouette", "consensus", "fit"):
        # back-project to the raw SURFACE point; the radial push below
        # replaces the fixed range_offset entirely
        bp_cfg = dataclasses.replace(cfg, range_offset=0.0)
    else:
        bp_cfg = cfg

    def one(root_id, ok, bbox, cpx):
        cluster = mask & (labels == root_id)
        pose, nonempty, p_mean, oriented = _direct_pose_from_cluster(
            y_pred, image, cluster, spec, cfg,
            with_center=center == "head",
        )
        good = ok & nonempty
        if center != "head":
            yaw = pose[3]
            l_, w_ = pose[4], pose[5]

            def push(xyz):
                # The physical box heading equals yaw (the orbit
                # convention rotates the whole corner set, orientation
                # included — boxes.box_corners_3d), so the box half-extent
                # along the viewing ray is 0.5(l|cos d| + w|sin d|),
                # d = ray azimuth - heading. Push the surface point that
                # far outward along the ray.
                ray_az = jnp.arctan2(xyz[1], xyz[0])
                d = ray_az - yaw
                p_ = 0.5 * (
                    l_ * jnp.abs(jnp.cos(d)) + w_ * jnp.abs(jnp.sin(d))
                )
                rho = jnp.sqrt(xyz[0] ** 2 + xyz[1] ** 2)
                scale = (rho + p_) / jnp.maximum(rho, 1e-6)
                return jnp.stack(
                    [xyz[0] * scale, xyz[1] * scale, xyz[2]]
                )

            if center == "surface":
                xyz, bp_ok = push(p_mean), nonempty
            elif center in ("consensus", "fit"):
                geo, _, bp_ok = back_project_2d_to_3d(
                    cpx, bbox, image[..., 0], image[..., 1], spec, bp_cfg
                )
                geo = push(geo)
                surf = push(p_mean)
                agree = jnp.sum((surf - geo) ** 2) <= 2.5**2
                xyz = jnp.where(agree, surf, geo)
            else:
                xyz, _, bp_ok = back_project_2d_to_3d(
                    cpx, bbox, image[..., 0], image[..., 1], spec, bp_cfg
                )
                if center in ("geometric", "silhouette"):
                    xyz = push(xyz)
            if center == "silhouette":
                xyz = _silhouette_center(
                    y_pred, image, cluster, spec, cfg,
                    yaw, pose[4:7], xyz,
                )
            elif center == "fit":
                if cfg.fit_boundary == "auto":
                    # dual-codec assets: fit both boundary arms and keep
                    # the one matching the codec the yaw gate picked —
                    # the family is a per-cluster property at decode time
                    cfg_ori = dataclasses.replace(
                        cfg, fit_boundary=cfg.fit_boundary_oriented
                    )
                    cfg_sym = dataclasses.replace(
                        cfg, fit_boundary="circle",
                        fit_surface_scale=cfg.fit_symmetric_scale,
                    )
                    xyz_o, yaw_o, _ = _fit_pose_to_surface(
                        image, cluster, spec, cfg_ori, yaw, pose[4:7], xyz
                    )
                    xyz_s, yaw_s, _ = _fit_pose_to_surface(
                        image, cluster, spec, cfg_sym, yaw, pose[4:7], xyz
                    )
                    xyz = jnp.where(oriented, xyz_o, xyz_s)
                    yaw = jnp.where(oriented, yaw_o, yaw_s)
                else:
                    xyz, yaw, _ = _fit_pose_to_surface(
                        image, cluster, spec, cfg, yaw, pose[4:7], xyz
                    )
            c, s = jnp.cos(-yaw), jnp.sin(-yaw)
            ctr = jnp.stack(
                [c * xyz[0] - s * xyz[1], s * xyz[0] + c * xyz[1], xyz[2]]
            )
            pose = jnp.concatenate([ctr, yaw[None], pose[4:]])
            good = good & bp_ok
        return jnp.where(good, pose, 0.0), good

    poses, oks = jax.vmap(one)(idx, found, bboxes, centroids)
    return {
        "poses": poses,
        "found": oks,
        "areas": jnp.where(found, areas.astype(jnp.float32), 0.0),
    }


def decode_batch_direct(
    y_pred, images, spec=RangeViewSpec(), cfg=DecodeConfig(), k: int = 1,
    center: str | None = None,
):
    """(B, H, W, 10), (B, H, W, C) -> poses (B, k, 7), found (B, k)."""
    return jax.vmap(
        lambda p, im: decode_frame_direct(p, im, spec, cfg, k, center)
    )(y_pred, images)
