"""Process set-up for runs on the GPU: compile cache, device guard, card.

Every entry point that runs on the card (chip_smoke.py, bench.py,
`python -m tpufusion.benchmarks`, the cli) calls `enable_compile_cache`
before its first compilation. Measurement entry points call
`require_gpu`: a run that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turns on JAX's persistent compilation cache; returns its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is honoured as it stands (JAX
    reads it itself) and nothing is set in code. Otherwise the cache is
    the fixed `<repo>/.jax_cache`: the path is part of the cache key, so
    a directory that moved would never hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU; SystemExit otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX found {dev.platform} ({dev.device_kind}); "
            "nothing is measured on another backend"
        )
    return dev


def card_description() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line (a
    card below its maximum power limit runs slower under load, so every
    number is reported beside it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """The device as JAX reports it, for every printed result."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
