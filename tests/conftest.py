"""Test configuration: the CPU with a virtual 8-device mesh by default, so
sharding tests run without a GPU. Must run before jax initializes a
backend. An explicit JAX_PLATFORMS wins: tests marked `gpu` run on the
card with JAX_PLATFORMS=cuda,cpu and skip wherever no GPU is found."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise (the
    decision is made here, at run time, never at import)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def synthetic_cloud(rng, n=4096, with_vehicle_at=None):
    """A plausible lidar scan: ground ring + random scatter + optional dense
    vehicle-shaped cluster (so decode tests have something to find)."""
    az = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(2.0, 60.0, n)
    z = rng.uniform(-1.9, 0.5, n)
    x = r * np.cos(az)
    y = r * np.sin(az)
    intensity = rng.uniform(0.0, 100.0, n)
    pts = np.stack([x, y, z, intensity], axis=1).astype(np.float32)
    if with_vehicle_at is not None:
        cx, cy, cz = with_vehicle_at
        m = 800
        vx = rng.uniform(cx - 2.1, cx + 2.1, m)
        vy = rng.uniform(cy - 0.9, cy + 0.9, m)
        vz = rng.uniform(cz - 0.75, cz + 0.75, m)
        vi = rng.uniform(0.0, 100.0, m)
        v = np.stack([vx, vy, vz, vi], axis=1).astype(np.float32)
        pts = np.concatenate([pts, v], axis=0)
    return pts


@pytest.fixture
def cloud(rng):
    return synthetic_cloud(rng)
