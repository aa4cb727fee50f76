"""Device timing: mean seconds per call of a jitted function."""

from __future__ import annotations

import time

import jax


def measure(fn, argsets: list[tuple], reps: int = 2) -> float:
    """Mean seconds per call over len(argsets)*reps dispatches. One call
    first compiles and warms up outside the window; the window ends in
    `jax.block_until_ready`, since dispatch returns before the device
    finishes."""
    jax.block_until_ready(fn(*argsets[0]))
    t0 = time.perf_counter()
    for _ in range(reps):
        for a in argsets:
            r = fn(*a)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / (reps * len(argsets))
