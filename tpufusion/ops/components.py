"""Connected-component labeling in fixed-shape XLA.

Replaces `scipy.ndimage.measurements.label` used by the reference decode
(`modules/lidar/train/predict.py:53`). scipy's default structuring element is
4-connectivity; we reproduce that with iterative min-propagation: every
foreground pixel starts labeled with its own flat index, then repeatedly takes
the minimum label of its 4-neighborhood until a fixed point. The result labels
each component by the smallest flat pixel index it contains — which is also
the first pixel scipy's scanner encounters, so ordering components by our
label value matches scipy's 1..K numbering order.

Each sweep is a cross-shaped max-pool (labels are negated so reduce_window's
max implements min-propagation) — two cheap `reduce_window` calls, no
scatter. The loop is a `lax.while_loop` with an iteration cap: convergence
needs at most the longest geodesic path inside a component, tiny for the
compact 32x1801 range-view heat blobs; the cap bounds pathological inputs.

connected_components_with_bbox fuses the per-cluster bounding-box fixed
point into the same loop: any two 4-adjacent foreground pixels belong to the
same final cluster, so running extents merge unconditionally alongside the
labels, sparing the four segment-scatter reductions a post-hoc pass would
need.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = jnp.iinfo(jnp.int32).max - 1


def _shift(x: jax.Array, axis: int, d: int, fill) -> jax.Array:
    """Shift x by d along axis (d > 0 pulls from lower indices), padding
    with `fill`. axis is 1 (rows) or 2 (cols) of a (C, H, W) stack; also
    works on 2-D (H, W) masks with axis 0/1."""
    nd = x.ndim
    pad = [(0, 0)] * nd
    pad[axis] = (d, 0) if d > 0 else (0, -d)
    sl = [slice(None)] * nd
    n = x.shape[axis]
    sl[axis] = slice(0, n) if d > 0 else slice(-d, -d + n)
    return jnp.pad(x, pad, constant_values=fill)[tuple(sl)]


def _run_gates(mask: jax.Array, axis: int, dists) -> dict:
    """gate[d][p] = True iff the d-1 cells strictly between p and the pull
    source (distance d along -axis direction encoded by d's sign) are all
    foreground — i.e. the shifted min stays within one connected run."""
    gates = {}
    for d in dists:
        if abs(d) == 1:
            gates[d] = None
            continue
        step = 1 if d > 0 else -1
        g = None
        for j in range(1, abs(d)):
            m = _shift(mask, axis, step * j, False)
            g = m if g is None else (g & m)
        gates[d] = g
    return gates


_H_DISTS = (1, -1, 2, -2, 4, -4, 8, -8, 16, -16)
_V_DISTS = (1, -1, 2, -2, 4, -4)


def _propagate(st0: jax.Array, mask: jax.Array, max_iters: int) -> jax.Array:
    """Fixed-point label/extent propagation with multi-distance gated
    sweeps: each sweep takes the max over shifts {1,2,4,8,16} along rows
    and {1,2,4} along columns, every shift gated by a precomputed
    within-run mask, so information travels up to 16 px per sweep instead
    of 1 — range-view blobs are wide and flat, and the iteration count is
    what the whole decode's cost scales with under detection load
    (plain 1-px sweeps need ~blob-width iterations)."""
    h_gates = _run_gates(mask, 1, _H_DISTS)
    v_gates = _run_gates(mask, 0, _V_DISTS)

    def sweep(st):
        out = st
        for d in _H_DISTS:
            s = _shift(st, 2, d, -_BIG)
            g = h_gates[d]
            if g is not None:
                s = jnp.where(g[None], s, -_BIG)
            out = jnp.maximum(out, s)
        for d in _V_DISTS:
            s = _shift(st, 1, d, -_BIG)
            g = v_gates[d]
            if g is not None:
                s = jnp.where(g[None], s, -_BIG)
            out = jnp.maximum(out, s)
        return jnp.where(mask[None], out, -_BIG)

    def cond(state):
        i, st, changed = state
        return changed & (i < max_iters)

    def body(state):
        i, st, _ = state
        nxt = sweep(st)
        return i + 1, nxt, jnp.any(nxt != st)

    with jax.named_scope("cc"):
        _, st, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), st0, jnp.bool_(True))
        )
    return st


def connected_components(mask: jax.Array, max_iters: int = 128) -> jax.Array:
    """Label 4-connected components of a 2D boolean mask.

    Returns int32 labels with shape == mask.shape: background pixels get -1;
    each foreground pixel gets the smallest flat index of its component.
    """
    h, w = mask.shape
    flat_ids = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    st0 = jnp.where(mask, -flat_ids, -_BIG)[None]
    st = _propagate(st0, mask, max_iters)
    return jnp.where(mask, -st[0], -1)


def connected_components_with_bbox(mask: jax.Array, max_iters: int = 128):
    """Labels plus per-pixel cluster bbox (min_x, max_x, min_y, max_y).

    Background pixels: label -1 and undefined extents.
    """
    h, w = mask.shape
    flat_ids = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    def init(chan):
        return jnp.where(mask, chan, -_BIG)

    st0 = jnp.stack(
        [init(-flat_ids), init(-cols), init(cols), init(-rows), init(rows)],
        axis=0,
    )
    st = _propagate(st0, mask, max_iters)
    labels = jnp.where(mask, -st[0], -1)
    return labels, -st[1], st[2], -st[3], st[4]
