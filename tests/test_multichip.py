"""Multi-chip data parallelism on the virtual 8-device CPU mesh.

Validates what the driver's dryrun_multichip checks: the full training step
(on-device projection, label encoding, augmentation, fwd/bwd, optimizer
update) compiles and runs with the batch sharded over a Mesh and params
replicated, and that gradients are identical to single-device execution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import PartitionSpec as P

from tpufusion.config import LossConfig, MeshConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion.data.synthetic import synthesize_points_batch
from tpufusion.models.fcn import init_fcn
from tpufusion.parallel.mesh import batch_sharding, make_mesh, replicate
from tpufusion.predict import make_e2e_step
from tpufusion.train.train_step import make_train_step

SPEC = RangeViewSpec(res_h_deg=1.8)
TX = optax.adam(1e-3)


def _setup(seed=0, mesh=None):
    """(variables, opt_state), replicated over `mesh` when given."""
    v = init_fcn(ModelConfig(), jax.random.PRNGKey(seed), in_channels=3)
    o = TX.init(v["params"])
    if mesh is not None:
        v, o = replicate(v, mesh), replicate(o, mesh)
    return v, o


def _step(spec, cfg, mesh=None):
    return make_train_step(ModelConfig(), TX, spec, LossConfig(), cfg,
                           mesh=mesh)


def _assert_params_match(v1, v2):
    for a, b in zip(jax.tree.leaves(v1["params"]),
                    jax.tree.leaves(v2["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def _batch(n=16, pts=512):
    points, gt = synthesize_points_batch(jax.random.PRNGKey(1), n, pts)
    return {
        "points": np.asarray(points),
        "center": np.asarray(gt["center"]),
        "size": np.asarray(gt["size"]),
        "yaw": np.asarray(gt["yaw"]),
    }


def test_eight_virtual_devices():
    assert len(jax.devices()) >= 8


def test_sharded_train_step_runs_and_matches_single_device():
    mesh = make_mesh(MeshConfig(n_devices=8))
    batch_np = _batch()
    step = _step(SPEC, TrainConfig(batch_size=16, augment=False))
    key = jax.random.PRNGKey(2)

    # single device
    v1, _, m1 = step(*_setup(), jax.device_put(batch_np), key)

    # 8-way data parallel: params replicated, batch sharded
    sh = batch_sharding(mesh)
    batch_sharded = {k: jax.device_put(v, sh) for k, v in batch_np.items()}
    with mesh:
        v2, _, m2 = step(*_setup(mesh=mesh), batch_sharded, key)

    assert np.isfinite(float(m2["loss"]))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    # updated parameters must match single-device training
    _assert_params_match(v1, v2)


def test_spatial_partition_train_step_matches_single_device():
    """dp x sp: 4-way data x 2-way spatial width partitioning. GSPMD
    inserts the conv halo exchanges; updates must match single-device."""
    mesh = make_mesh(MeshConfig(n_devices=8, n_spatial=2))
    assert mesh.axis_names == ("data", "spatial")
    batch_np = _batch()
    cfg = TrainConfig(batch_size=16, augment=False)
    key = jax.random.PRNGKey(2)

    v1, _, m1 = _step(SPEC, cfg)(*_setup(), jax.device_put(batch_np), key)

    sh = batch_sharding(mesh)
    batch_sharded = {k: jax.device_put(v, sh) for k, v in batch_np.items()}
    with mesh:
        v2, _, m2 = _step(SPEC, cfg, mesh)(
            *_setup(mesh=mesh), batch_sharded, key
        )

    assert np.isfinite(float(m2["loss"]))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    _assert_params_match(v1, v2)


def test_image_sharding_layout():
    from tpufusion.parallel.mesh import image_sharding

    mesh = make_mesh(MeshConfig(n_devices=8, n_spatial=2))
    s4 = image_sharding(mesh, 4)
    assert s4.spec == P("data", None, "spatial", None)
    s3 = image_sharding(mesh, 3)
    assert s3.spec == P("data", None, "spatial")
    mesh1d = make_mesh(MeshConfig(n_devices=8))
    assert image_sharding(mesh1d, 4).spec == P("data", None, None, None)


def test_graft_entry_dryrun():
    import importlib.util, sys, pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    spec_ = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_graft_entry_compiles():
    import importlib.util, pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    spec_ = importlib.util.spec_from_file_location("graft_entry2", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    poses, found = out
    assert poses.shape == (4, 7)


def test_sharded_e2e_inference_matches_single_device():
    """The fused inference graph (projection + FCN + decode with its
    top_k/argmin/CC fixed-point ops) batch-sharded over the data axis and
    width-constrained over spatial: poses must match unsharded execution
    (this graph is the one a deployment shards)."""
    from tpufusion.config import DecodeConfig

    mesh = make_mesh(MeshConfig(n_devices=8, n_spatial=2))
    state, _ = _setup()
    dcfg = DecodeConfig()
    # scenes with vehicles near enough that some frames decode a pose
    points, _ = synthesize_points_batch(jax.random.PRNGKey(3), 16, 2048)
    pts_host = np.asarray(points)

    ref_pose, ref_found = make_e2e_step(ModelConfig(), SPEC, dcfg)(
        state, jax.device_put(pts_host)
    )
    sh = batch_sharding(mesh)
    with mesh:
        got_pose, got_found = make_e2e_step(
            ModelConfig(), SPEC, dcfg, mesh=mesh
        )(replicate(state, mesh), jax.device_put(pts_host, sh))
    np.testing.assert_array_equal(np.asarray(ref_found), np.asarray(got_found))
    np.testing.assert_allclose(
        np.asarray(ref_pose), np.asarray(got_pose), atol=1e-4
    )


@pytest.mark.slow
def test_spatial_partition_full_width_train_step():
    """dp x sp at the REAL production geometry (32 x 1801): the spatial
    axis partitions the actual 1801-wide range image (with the conv halo
    exchanges at real shard sizes), not a shrunken stand-in. CPU-mesh, so
    just one step + finite loss + parity with single-device."""
    full_spec = RangeViewSpec()  # 32 x 1801
    assert full_spec.width == 1801
    mesh = make_mesh(MeshConfig(n_devices=8, n_spatial=2))
    batch_np = _batch(n=8, pts=4096)
    cfg = TrainConfig(batch_size=8, augment=False)
    key = jax.random.PRNGKey(2)

    v1, _, m1 = _step(full_spec, cfg)(
        *_setup(), jax.device_put(batch_np), key
    )
    sh = batch_sharding(mesh)
    batch_sharded = {k: jax.device_put(v, sh) for k, v in batch_np.items()}
    with mesh:
        v2, _, m2 = _step(full_spec, cfg, mesh)(
            *_setup(mesh=mesh), batch_sharded, key
        )

    assert np.isfinite(float(m2["loss"]))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    _assert_params_match(v1, v2)


@pytest.mark.slow
def test_sharded_full_width_e2e_inference_matches_single_device():
    """The FLAGSHIP inference graph (direct head, width 2, masked-cluster
    decode) at the real production geometry (32 x 1801), batch-sharded
    over data and width-constrained over spatial: the spatial axis must
    partition the real-width CC/top_k decode, and poses
    must match unsharded execution."""
    import dataclasses

    from tpufusion.config import DecodeConfig

    full_spec = RangeViewSpec()
    assert full_spec.width == 1801
    mesh = make_mesh(MeshConfig(n_devices=8, n_spatial=2))
    mcfg = dataclasses.replace(
        ModelConfig(), head="direct", width_multiplier=2,
        reg_output_activation="linear",
    )
    state = init_fcn(mcfg, jax.random.PRNGKey(0), in_channels=3)
    dcfg = DecodeConfig(min_bbox_area=20.0)
    points, _ = synthesize_points_batch(jax.random.PRNGKey(5), 8, 8192)
    pts_host = np.asarray(points)

    ref_pose, ref_found = make_e2e_step(mcfg, full_spec, dcfg, head="direct")(
        state, jax.device_put(pts_host)
    )
    sh = batch_sharding(mesh)
    with mesh:
        got_pose, got_found = make_e2e_step(
            mcfg, full_spec, dcfg, head="direct", mesh=mesh
        )(replicate(state, mesh), jax.device_put(pts_host, sh))
    np.testing.assert_array_equal(
        np.asarray(ref_found), np.asarray(got_found)
    )
    np.testing.assert_allclose(
        np.asarray(ref_pose), np.asarray(got_pose), atol=1e-4
    )
