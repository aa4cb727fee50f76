"""Deterministic scatter reductions for point-cloud rasterization.

The reference resolves pixel collisions by sorting points by descending
L2 norm and letting later numpy writes win (`modules/lidar/process/
extract_rosbag_lidar.py:64-71`): the nearest point (smallest L2) is written
last; among equal L2 the lowest original index wins. A straight
`arr.at[idx].set(vals)` in XLA has unspecified collision order, so we make
the winner explicit with a two-stage segment-min:

  1. per pixel, find the minimum sortable encoding of the L2 key;
  2. among points matching that key, pick the minimum point index;
  3. gather the winning point's payload.

Non-negative finite float32 values have the property that their raw bit
patterns (viewed as int32) sort identically to the floats themselves, so
step 1 works entirely in int32 — no float-compare scatter and no int64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_INT32_MAX = jnp.iinfo(jnp.int32).max


def _sortable_bits(x: jax.Array) -> jax.Array:
    """Bit-pattern encoding of non-negative float32 that preserves order."""
    return jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)


def nearest_wins_scatter(
    pixel_ids: jax.Array,  # (N,) int32 flat pixel index in [0, num_pixels)
    rank_key: jax.Array,  # (N,) float32 >= 0; smallest key wins a pixel
    valid: jax.Array,  # (N,) bool
    num_pixels: int,
) -> tuple[jax.Array, jax.Array]:
    """Returns (winner_idx, occupied) per pixel.

    winner_idx[p] is the index into the point arrays of the point that wins
    pixel p (lowest rank_key, ties broken by lowest point index); undefined
    (0) where occupied[p] is False.

    Two-stage segment-min: (1) per-pixel min of the sortable float bits,
    (2) among points matching that minimum, per-pixel min point index.
    Both are colliding scatter-mins.
    """
    n = pixel_ids.shape[0]
    safe_ids = jnp.where(valid, pixel_ids, 0)
    key_bits = jnp.where(valid, _sortable_bits(rank_key), _INT32_MAX)

    min_bits = jnp.full((num_pixels,), _INT32_MAX, dtype=jnp.int32)
    min_bits = min_bits.at[safe_ids].min(key_bits)

    idx = jnp.arange(n, dtype=jnp.int32)
    is_winner_key = valid & (key_bits == min_bits[safe_ids])
    cand_idx = jnp.where(is_winner_key, idx, _INT32_MAX)

    winner = jnp.full((num_pixels,), _INT32_MAX, dtype=jnp.int32)
    winner = winner.at[safe_ids].min(cand_idx)

    occupied = winner != _INT32_MAX
    return jnp.where(occupied, winner, 0), occupied


def nearest_wins_sort(
    pixel_ids: jax.Array,  # (N,) int32 flat pixel index in [0, num_pixels)
    rank_key: jax.Array,  # (N,) float32 >= 0; smallest key wins a pixel
    valid: jax.Array,  # (N,) bool
    num_pixels: int,
) -> tuple[jax.Array, jax.Array]:
    """Exact nearest-wins winner via one stable 2-key sort — same contract
    and bit-identical result as nearest_wins_scatter: one sort plus a
    collision-free scatter in place of two colliding scatter-mins. Its
    device time on the GPU against nearest_wins_scatter: not measured.

    Sort (pixel, key-bits) lexicographically, stable, carrying the point
    index: the first element of each pixel run is the winner (stability
    gives lowest-index tie-break, matching the reference's sort order at
    extract_rosbag_lidar.py:64-71). Run starts then scatter to UNIQUE
    targets — XLA emits the fast non-colliding path. Invalid points sort
    to a sentinel pixel (num_pixels) at the end; non-first run elements
    write to the same junk slot, which is sliced away.
    """
    n = pixel_ids.shape[0]
    pix = jnp.where(valid, pixel_ids, num_pixels)
    bits = jnp.where(valid, _sortable_bits(rank_key), _INT32_MAX)
    idx = jnp.arange(n, dtype=jnp.int32)
    sp, _, si = jax.lax.sort((pix, bits, idx), num_keys=2, is_stable=True)
    first = jnp.concatenate([jnp.ones((1,), bool), sp[1:] != sp[:-1]])
    tgt = jnp.where(first & (sp < num_pixels), sp, num_pixels)
    winner = jnp.zeros((num_pixels + 1,), jnp.int32).at[tgt].set(
        si, mode="drop"
    )
    occupied = jnp.zeros((num_pixels + 1,), bool).at[tgt].set(
        True, mode="drop"
    )
    return winner[:num_pixels], occupied[:num_pixels]


def nearest_wins_scatter_packed(
    pixel_ids: jax.Array,
    rank_key: jax.Array,
    valid: jax.Array,
    num_pixels: int,
) -> tuple[jax.Array, jax.Array]:
    """Fast variant: ONE scatter-min over a packed (quantized-key, index)
    int32. The key keeps the top (31 - ceil(log2 N)) bits of the sortable
    float encoding, so two points whose L2 norms agree to ~2^-9 relative
    (for N=32k) may resolve to the lower index instead of the true nearer
    point — a bounded winner-selection tolerance traded for dropping the
    second scatter pass and the min-bits gather. Use for throughput paths;
    `nearest_wins_scatter` is the exact reference semantics.
    """
    n = pixel_ids.shape[0]
    idx_bits = max((n - 1).bit_length(), 1)
    safe_ids = jnp.where(valid, pixel_ids, 0)
    # drop the low idx_bits of the 31-bit float encoding to make room
    qkey = _sortable_bits(rank_key) >> idx_bits
    idx = jnp.arange(n, dtype=jnp.int32)
    packed = (qkey << idx_bits) | idx
    packed = jnp.where(valid, packed, _INT32_MAX)

    out = jnp.full((num_pixels,), _INT32_MAX, dtype=jnp.int32)
    out = out.at[safe_ids].min(packed)
    occupied = out != _INT32_MAX
    winner = out & ((1 << idx_bits) - 1)
    return jnp.where(occupied, winner, 0), occupied


def scatter_count(
    pixel_ids: jax.Array, valid: jax.Array, num_pixels: int
) -> jax.Array:
    """Number of valid points landing in each pixel (float32)."""
    safe_ids = jnp.where(valid, pixel_ids, 0)
    counts = jnp.zeros((num_pixels,), dtype=jnp.float32)
    return counts.at[safe_ids].add(valid.astype(jnp.float32))


def scatter_max(
    pixel_ids: jax.Array,
    values: jax.Array,
    valid: jax.Array,
    num_pixels: int,
    fill: float = 0.0,
) -> jax.Array:
    """Per-pixel maximum of values over valid points; `fill` where empty."""
    safe_ids = jnp.where(valid, pixel_ids, 0)
    neg_inf = jnp.float32(-jnp.inf)
    vals = jnp.where(valid, values.astype(jnp.float32), neg_inf)
    out = jnp.full((num_pixels,), neg_inf, dtype=jnp.float32)
    out = out.at[safe_ids].max(vals)
    return jnp.where(jnp.isfinite(out), out, jnp.float32(fill))


def nearest_wins_sort16(
    pixel_ids: jax.Array,  # (N,) int32 flat pixel index in [0, num_pixels)
    rank_key: jax.Array,  # (N,) float32 >= 0; smallest key wins a pixel
    valid: jax.Array,  # (N,) bool
    num_pixels: int,
) -> tuple[jax.Array, jax.Array]:
    """Exact nearest-wins winner via a SINGLE-key sort with packed 16-bit
    pixel ids — the round-2 'smaller sort keys' lever.

    The 3-operand 2-key sort of nearest_wins_sort moves (pix, bits, idx);
    here the sort moves only (packed, idx) where packed = pix(16 bits) <<
    16 | coarse(top 16 bits of the sortable L2 encoding). Ordering by
    `packed` equals ordering by (pix, coarse), so each pixel's TRUE winner
    lives somewhere in its first equal-`packed` run; a log2(N)-deep gated
    shift-min over (low 15 key bits << 15 | idx) then resolves the exact
    winner inside each run (the same fixed-distance sweep trick as the CC
    propagation, ops/components.py) — a handful of fused elementwise ops instead
    of a third sorted operand.

    Bit-identical to nearest_wins_sort/scatter (golden-tested). Requires
    pixel ids + 1 sentinel to fit 16 bits and N <= 2^15 (128k-point Waymo
    clouds need nearest_wins_sort). NOT the default: it trades the third
    sort operand for a 15-step run-min sweep; method="sort16" selects it.
    """
    n = pixel_ids.shape[0]
    assert n <= (1 << 15), f"idx must fit 15 bits, got N={n}"
    assert num_pixels + 1 <= (1 << 16), num_pixels
    pix = jnp.where(valid, pixel_ids, num_pixels)
    bits = jnp.where(valid, _sortable_bits(rank_key), _INT32_MAX)
    coarse = ((bits >> 15) & 0xFFFF).astype(jnp.uint32)
    # uint32 key: pix up to 65535 in the high half would overflow int32
    packed = (pix.astype(jnp.uint32) << 16) | coarse
    idx = jnp.arange(n, dtype=jnp.int32)
    sk, si = jax.lax.sort((packed, idx), num_keys=1, is_stable=True)

    # exact winner inside each equal-`packed` run: min of (low-bits, idx)
    low = (bits & 0x7FFF)[si]
    key2 = (low << 15) | si  # 30 bits; idx tie-break for free
    run_min = key2
    d = 1
    while d < n:
        shifted = jnp.concatenate(
            [run_min[d:], jnp.full((d,), _INT32_MAX, jnp.int32)]
        )
        same = jnp.concatenate([sk[d:] == sk[:-d], jnp.zeros((d,), bool)])
        run_min = jnp.minimum(run_min, jnp.where(same, shifted, _INT32_MAX))
        d <<= 1

    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    spix = (sk >> 16).astype(jnp.int32)
    # first run of each pixel = run start whose pixel differs from the
    # previous element's pixel
    pix_first = jnp.concatenate(
        [jnp.ones((1,), bool), spix[1:] != spix[:-1]]
    )
    win_here = first & pix_first & (spix < num_pixels)
    winner_idx = run_min & 0x7FFF
    tgt = jnp.where(win_here, spix, num_pixels)
    winner = jnp.zeros((num_pixels + 1,), jnp.int32).at[tgt].set(
        winner_idx, mode="drop"
    )
    occupied = jnp.zeros((num_pixels + 1,), bool).at[tgt].set(
        True, mode="drop"
    )
    return winner[:num_pixels], occupied[:num_pixels]
