"""End-to-end benchmark: lidar frames/sec/device (projection + FCN + decode).

The whole per-frame pipeline — cylindrical range-view projection, FCN
forward, heatmap->pose decode — runs fused in one jitted graph
(`predict.make_e2e_step`) on batches of 64 beam-structured 32768-point
Velodyne scans.

  * an untrained FCN marks ~half the range view "vehicle", which drives
    the connected-component loop to its iteration cap on every frame —
    nothing like production traffic. The classifier head bias is offset
    toward background so detection masks have trained-network sparsity.
  * every timed window ends in `jax.block_until_ready`
    (utils/profiling.measure); compilation happens before it.

Needs a GPU and fails without one. Prints ONE JSON line on stdout, with
the device it ran on; details go to stderr.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.config import DEFAULT
from tpufusion.data.synthetic import synthesize_beam_scan_batch
from tpufusion.models.fcn import init_fcn
from tpufusion.models.io import load_detector_asset
from tpufusion.predict import make_e2e_step
from tpufusion.utils.device import (
    card_description,
    device_record,
    enable_compile_cache,
    require_gpu,
)
from tpufusion.utils.profiling import measure

BATCH = 64
N_POINTS = 32768  # 32 beams x 1024 azimuth steps, ~HDL-32E revolution
NSETS = 24

# The shipped flagship detector is the direct-pose head at width 2
# (tpufusion/assets/synthetic_detector.npz.json "model") — its decode
# (masked cluster averaging) replaces the corner vote. The headline
# measures the production path; the corner-vote path is reported
# alongside.
FLAGSHIP = dict(
    head="direct", width_multiplier=2, reg_output_activation="linear"
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _background_biased(model_cfg):
    """Random-init variables with the classifier biased to background
    (trained-detector output statistics)."""
    v = init_fcn(model_cfg, jax.random.PRNGKey(0), in_channels=3)
    v["params"]["deconv6a"]["bias"] = jnp.asarray([2.0, -2.0])
    return v


def main():
    enable_compile_cache()
    require_gpu()
    card = card_description()
    log(f"card: {card}; devices: {jax.devices()}")
    cfg = DEFAULT
    spec = cfg.range_view
    fcfg = dataclasses.replace(cfg.model, dtype="bfloat16", **FLAGSHIP)
    variables = _background_biased(fcfg)
    e2e = make_e2e_step(fcfg, spec, cfg.decode, cfg.projection_method,
                        head="direct")

    # beam-structured Velodyne scans (32 discrete beams, occlusion
    # shadows, range-dependent dropout); invalid (no-return) rays ride
    # the projector's padding mask
    synth = jax.jit(
        lambda k: synthesize_beam_scan_batch(k, BATCH, N_POINTS)[::2]
    )
    batches = [synth(jax.random.PRNGKey(i)) for i in range(NSETS)]
    jax.block_until_ready(batches)

    t0 = time.perf_counter()
    jax.block_until_ready(e2e(variables, *batches[0]))
    log(f"compile+first run: {time.perf_counter() - t0:.1f}s")

    dt = measure(e2e, [(variables, b, v) for b, v in batches], reps=1)
    fps = BATCH / dt
    log(f"throughput: {fps:.1f} frames/s ({dt * 1e3:.1f} ms/batch of {BATCH})")

    # supplementary: throughput under detection load, with the SHIPPED
    # trained asset at its validated decode operating point — the CC
    # labeling loop iterates with the blob diameter, so frames with
    # detections cost more than empty ones
    acfg, avars, _ = load_detector_asset()
    acfg = acfg.replace(
        model=dataclasses.replace(acfg.model, dtype="bfloat16")
    )
    ae2e = make_e2e_step(acfg.model, spec, acfg.decode,
                         cfg.projection_method, head=acfg.model.head)
    det = int(np.asarray(ae2e(avars, *batches[0])[1]).sum())
    live_dt = measure(ae2e, [(avars, b, v) for b, v in batches], reps=1)
    live_fps = BATCH / live_dt
    log(f"with live detections, shipped asset ({det}/{BATCH} frames): "
        f"{live_fps:.1f} frames/s")

    # supplementary: the reference-parity corner-vote decode (the
    # reference's own head design, predict.py:94-199) on the same scans
    ccfg = dataclasses.replace(cfg.model, dtype="bfloat16")
    cvars = _background_biased(ccfg)
    ce2e = make_e2e_step(ccfg, spec, cfg.decode, cfg.projection_method)
    corner_dt = measure(ce2e, [(cvars, b, v) for b, v in batches], reps=1)
    corner_fps = BATCH / corner_dt
    log(f"corner-vote parity decode: {corner_fps:.1f} frames/s")

    # supplementary: throughput with the quantized-winner projection
    fast = make_e2e_step(fcfg, spec, cfg.decode, "packed", head="direct")
    fast_dt = measure(fast, [(variables, b, v) for b, v in batches], reps=1)
    fast_fps = BATCH / fast_dt
    log(f"packed-projection mode: {fast_fps:.1f} frames/s")

    # latency: single-frame path, one call at a time
    ones = [
        (batches[i][0][i % BATCH : i % BATCH + 1],
         batches[i][1][i % BATCH : i % BATCH + 1])
        for i in range(13)
    ]
    jax.block_until_ready(e2e(variables, *ones[12]))  # compile batch 1
    lats = []
    for i in range(12):
        t0 = time.perf_counter()
        jax.block_until_ready(e2e(variables, *ones[i]))
        lats.append(time.perf_counter() - t0)
    p50 = float(np.percentile(lats, 50) * 1e3)
    log(f"single-frame p50 latency: {p50:.2f} ms")

    print(f"card: {card}")
    print(
        json.dumps(
            {
                "metric": "lidar frames/sec/device end-to-end "
                          "(projection+FCN+decode)",
                "value": round(fps, 1),
                "unit": "frames/s/device",
                "p50_latency_ms": round(p50, 2),
                "fps_with_live_detections": round(live_fps, 1),
                "fps_corner_parity_decode": round(corner_fps, 1),
                "fps_packed_projection": round(fast_fps, 1),
                "batch": BATCH,
                "points_per_frame": N_POINTS,
                "device": device_record(),
            }
        )
    )


if __name__ == "__main__":
    main()
