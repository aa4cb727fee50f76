"""Device-mesh and sharding helpers.

The reference has no distributed execution at all (SURVEY.md §2.2); here
scale-out over several devices is first-class: pick a
`jax.sharding.Mesh`, annotate shardings, and let XLA's SPMD partitioner
insert the collectives (NCCL on the GPU).

Two mesh axes cover this model family:

  data    — batch parallelism: batch tensors sharded, parameters
            replicated, XLA inserts the gradient psum.
  spatial — width partitioning of the range-view image: convolutions are
            spatially partitioned by GSPMD, which inserts the halo
            exchanges a 5x5 kernel needs at shard edges. This is the
            axis that cuts single-frame latency.

Tensor/pipeline/expert parallelism are deliberately NOT used: the FCN is
~1 MB of parameters (SURVEY §2.1 #36) with <= 24-channel layers — there
is nothing to shard (tp), no layer pipeline deep enough to fill (pp),
and no experts (ep). The mesh follows the algorithm alone: every GPU of
a host reaches every other over NVLink at the same rate, so the layout
of the devices into (data, spatial) carries no topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpufusion.config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """1-D (data,) mesh, or 2-D (data, spatial) when cfg.n_spatial > 1."""
    devices = devices if devices is not None else jax.devices()
    n = cfg.n_devices or len(devices)
    if cfg.n_spatial > 1:
        assert n % cfg.n_spatial == 0, (
            f"{n} devices not divisible by n_spatial={cfg.n_spatial}"
        )
        grid = np.asarray(devices[:n]).reshape(n // cfg.n_spatial,
                                               cfg.n_spatial)
        return Mesh(grid, axis_names=(cfg.data_axis, cfg.spatial_axis))
    return Mesh(np.asarray(devices[:n]), axis_names=(cfg.data_axis,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def image_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """(B, H, W, ...) images: batch over data, width over spatial (if the
    mesh has one). ndim=3 covers (B, H, W) masks/labels."""
    spatial = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    spec = [mesh.axis_names[0], None, spatial] + [None] * (ndim - 3)
    return NamedSharding(mesh, P(*spec))


def constrain_spatial(x: jax.Array, mesh: Mesh) -> jax.Array:
    """Pin an image-like tensor (B, H, W[, C]) to the data x spatial
    layout inside a jitted computation. No-op on 1-D meshes."""
    if len(mesh.axis_names) < 2:
        return x
    return jax.lax.with_sharding_constraint(
        x, image_sharding(mesh, x.ndim)
    )


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    s = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), batch)


def replicate(tree, mesh: Mesh):
    s = replicated_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)
