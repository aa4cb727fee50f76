"""Device time of the fused e2e step's stages, from a profiler trace.

Runs `predict.make_e2e_step` with the shipped flagship detector asset on
batches of 64 beam-structured 32768-point scans (the bench shapes),
traces a steady window with `jax.profiler`, and sums the device time of
the operations under each of the step's named scopes: "projection",
"fcn", "decode", and "cc" (the connected-component sweeps inside the
decode). Also reports the device's busy time (union of its operation
intervals) over the window.

XLA runs the step as CUDA command buffers by default, whose kernels carry
no operation names in the trace; the tool turns them off for its own
process (XLA_FLAGS `--xla_gpu_enable_command_buffer=`), which adds kernel
launch overhead to the traced window.

Run on a GPU: python -m tpufusion.tools.profile_e2e --trace_dir DIR
[--steps 5] [--dtype bfloat16]. `--dtype` sets the FCN's compute dtype:
float32 is the asset as shipped and served (full float32 convolutions),
bfloat16 the setting bench.py times. Prints one JSON line: per-stage
device ms per step, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import time

import jax

from tpufusion.data.synthetic import synthesize_beam_scan_batch
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.io import decode_for_resolution, load_detector_asset
from tpufusion.predict import make_e2e_step
from tpufusion.utils.device import (
    card_description,
    device_record,
    enable_compile_cache,
    require_gpu,
)

BATCH = 64
N_POINTS = 32768
SCOPES = ("cc", "projection", "fcn", "decode")
NO_COMMAND_BUFFERS = "--xla_gpu_enable_command_buffer="


def _scope(stats: dict) -> str | None:
    """The innermost of SCOPES in an event's scope path (its "name" stat,
    e.g. "jit(step)/decode/vmap(cc)/while/body"); transformation
    wrappers such as vmap(...) are looked through."""
    parts = {
        re.sub(r"^(\w+\()+|\)+$", "", p)
        for p in str(stats.get("name", "")).split("/")
    }
    for s in SCOPES:  # "cc" first: it sits inside "decode"
        if s in parts:
            return s
    return None


def device_times(xplane_path: str) -> dict:
    """Sums the durations of the device planes' events by scope; busy is
    the union of all event intervals, window its first-to-last span."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    per_scope = dict.fromkeys(SCOPES, 0.0)
    other, intervals = 0.0, []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                dur = ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                s = _scope(dict(ev.stats))
                if s is None:
                    other += dur
                else:
                    per_scope[s] += dur
    if not intervals:
        raise SystemExit(f"no device operations in {xplane_path}")
    busy, window = busy_and_window(intervals)
    return {"scope_ns": per_scope, "unscoped_ns": other,
            "busy_ns": busy, "window_ns": window}


def busy_and_window(intervals: list) -> tuple[float, float]:
    """(union length of the [start, end) intervals, first start to last
    end)."""
    intervals = sorted(intervals)
    busy, (lo, hi) = 0.0, intervals[0]
    for a, b in intervals[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy, max(b for _, b in intervals) - intervals[0][0]


def _traced(fn, variables, batches, trace_dir):
    """Runs fn over the batches inside one profiler trace."""
    with jax.profiler.trace(trace_dir):
        for b in batches:
            out = fn(variables, *b)
        jax.block_until_ready(out)
    return out


def _xplane(trace_dir: str) -> str:
    return sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace_dir", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    # before the first backend use: XLA reads its flags once
    os.environ["XLA_FLAGS"] = " ".join(
        [os.environ.get("XLA_FLAGS", ""), NO_COMMAND_BUFFERS]
    ).strip()
    enable_compile_cache()
    require_gpu()

    cfg, variables, meta = load_detector_asset()
    mcfg = dataclasses.replace(cfg.model, dtype=args.dtype)
    dcfg = decode_for_resolution(cfg.decode, meta, N_POINTS)
    step = make_e2e_step(mcfg, cfg.range_view, dcfg,
                         cfg.projection_method, head=cfg.model.head)
    batches = [
        synthesize_beam_scan_batch(jax.random.PRNGKey(i), BATCH,
                                   N_POINTS)[::2]
        for i in range(args.steps)
    ]
    jax.block_until_ready(batches)
    jax.block_until_ready(step(variables, *batches[0]))  # compile

    t0 = time.perf_counter()
    out = _traced(step, variables, batches, os.path.join(args.trace_dir,
                                                          "e2e"))
    wall = time.perf_counter() - t0
    found = int(out[1].sum())
    t = device_times(_xplane(os.path.join(args.trace_dir, "e2e")))

    # XLA's sort and scatter kernels carry no scope name in the trace, so
    # the projection is also traced alone: all its device time is its own
    proj = jax.jit(lambda _, p, v: range_view_project_batch(
        p, cfg.range_view, v, cfg.projection_method))
    jax.block_until_ready(proj(None, *batches[0]))
    _traced(proj, None, batches, os.path.join(args.trace_dir, "projection"))
    tp = device_times(_xplane(os.path.join(args.trace_dir, "projection")))
    ms = 1e-6 / args.steps
    print(json.dumps({
        "metric": "e2e device ms per step by stage (batch 64 x 32768)",
        "card": card_description(),
        "device": device_record(),
        "steps": args.steps,
        "fcn_dtype": args.dtype,
        "found_last_batch": found,
        "ms_per_step": {s: round(v * ms, 3) for s, v in
                        t["scope_ns"].items()},
        "unscoped_ms_per_step": round(t["unscoped_ns"] * ms, 3),
        "projection_alone_busy_ms_per_step": round(tp["busy_ns"] * ms, 3),
        "busy_ms_per_step": round(t["busy_ns"] * ms, 3),
        "idle_share": round(1.0 - t["busy_ns"] / t["window_ns"], 4),
        "traced_wall_ms_per_step": round(wall * 1e3 / args.steps, 3),
        "xla_flags": os.environ["XLA_FLAGS"],
    }))


if __name__ == "__main__":
    main()
