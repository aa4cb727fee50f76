"""The plain-JAX FCN against an independent numpy forward, the shipped
assets' key layout, and the step-numbered npz checkpoints."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.oracle.keras_numpy import EPSILON, conv2d, conv2d_transpose, relu
from tpufusion.config import ModelConfig, PipelineConfig, RangeViewSpec, TrainConfig
from tpufusion.models.fcn import apply_fcn, init_fcn
from tpufusion.models.fusion import FusionConfig, init_fusion
from tpufusion.models.io import (
    ASSET_DIR,
    load_detector_asset,
    load_state_npz,
    save_state_npz,
    variables_to_flat,
)
from tpufusion.tools.import_keras import keras_deconv_kernel
from tpufusion.train.checkpoint import CheckpointManager

DETECTOR_ASSETS = sorted(
    f for f in os.listdir(ASSET_DIR)
    if f.startswith("synthetic_detector") and f.endswith(".npz")
)


def _numpy_fcn(cfg: ModelConfig, variables: dict, x: np.ndarray):
    """Feature-wise BN -> pad -> conv1..3 -> deconv4 -> both heads, in
    numpy with the oracle's TF-semantics convolutions (one frame)."""
    p = {k: {n: np.asarray(a) for n, a in v.items()}
         for k, v in variables["params"].items()}
    st = {n: np.asarray(a) for n, a in variables["batch_stats"]["norm"].items()}
    vs = cfg.vertical_stride
    w = x.shape[1]
    x = (x - st["mean"]) / np.sqrt(st["var"] + 1e-3)
    x = x * p["norm"]["scale"] + p["norm"]["bias"]
    x = np.pad(x, ((0, 0), (0, 3), (0, 0)))

    def conv(name, y, s):
        return conv2d(y, p[name]["kernel"], p[name]["bias"], s, "same")

    def deconv(name, y, s):
        k = keras_deconv_kernel(p[name]["kernel"])
        return conv2d_transpose(y, k, p[name]["bias"], s, "same")

    c1 = relu(conv("conv1", x, (vs, 4)))
    c2 = relu(conv("conv2", c1, (vs, 2)))
    c3 = relu(conv("conv3", c2, (vs, 2)))
    cat4 = np.concatenate([c2, relu(deconv("deconv4", c3, (vs, 2)))], -1)
    crop5 = 2 * c2.shape[1] - c1.shape[1]
    d5a = relu(deconv("deconv5a", cat4, (vs, 2)))[:, crop5:]
    d6a = deconv("deconv6a", np.concatenate([c1, d5a], -1), (vs, 4))[:, :w]
    e = np.exp(d6a - d6a.max(-1, keepdims=True))
    probs = np.clip(e / e.sum(-1, keepdims=True), EPSILON, 1.0)
    d5b = relu(deconv("deconv5b", cat4, (vs, 2)))[:, crop5:]
    d6b = deconv("deconv6b", np.concatenate([c1, d5b], -1), (vs, 4))[:, :w]
    return np.concatenate([probs, d6b], -1)


def test_fcn_matches_numpy_forward_on_shipped_asset():
    """The flagship asset's weights through apply_fcn and through an
    independent numpy forward built from the Keras oracle's conv and
    conv-transpose, at the full 32 x 1801 range view."""
    cfg, variables, _ = load_detector_asset()
    assert cfg.model.head == "direct"  # linear regression output
    x = np.stack([
        np.random.default_rng(0).uniform(0, 60, (32, 1801)),
        np.random.default_rng(1).uniform(-2, 2, (32, 1801)),
        np.random.default_rng(2).uniform(0, 100, (32, 1801)),
    ], -1).astype(np.float32)
    got, stats = apply_fcn(cfg.model, variables, jnp.asarray(x[None]))
    want = _numpy_fcn(cfg.model, variables, x)
    assert got.shape == (1, 32, 1801, want.shape[-1])
    np.testing.assert_allclose(np.asarray(got[0]), want, rtol=1e-4, atol=1e-4)
    # inference leaves the running statistics untouched
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_mode_updates_running_statistics():
    """train=True normalizes with the batch's statistics and folds them
    into the running averages (momentum 0.99)."""
    cfg = ModelConfig()
    v = init_fcn(cfg, jax.random.PRNGKey(0), in_channels=3)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 201, 3)) * 3 + 5
    _, stats = apply_fcn(cfg, v, x, train=True)
    mean = np.asarray(x).mean(axis=(0, 1, 2))
    np.testing.assert_allclose(
        np.asarray(stats["norm"]["mean"]), 0.01 * mean, rtol=1e-4
    )


@pytest.mark.parametrize("name", DETECTOR_ASSETS)
def test_shipped_detector_assets_load_with_matching_keys(name):
    path = os.path.join(ASSET_DIR, name)
    cfg, variables, meta = load_detector_asset(path)
    with np.load(path) as z:
        assert set(variables_to_flat(variables)) == set(z.files)
        for k, v in variables_to_flat(variables).items():
            assert v.shape == z[k].shape, k
    assert cfg.model.head == meta["model"].get("head", "corner")


def test_shipped_fusion_asset_loads_with_matching_keys():
    path = os.path.join(ASSET_DIR, "fusion_net.npz")
    with open(path + ".json") as f:
        meta = json.load(f)
    fcfg = FusionConfig(lidar_pool=tuple(meta["lidar_pool"]),
                        cam_pool=tuple(meta["cam_pool"]))
    variables = load_state_npz(path, init_fusion(fcfg, jax.random.PRNGKey(0)))
    with np.load(path) as z:
        assert set(variables_to_flat(variables)) == set(z.files)
    assert set(variables["batch_stats"]) == {"lidar_fcn", "camera_fcn"}


def test_state_npz_roundtrip_and_mismatch(tmp_path):
    cfg = ModelConfig(head="direct", width_multiplier=2)
    v = init_fcn(cfg, jax.random.PRNGKey(3), in_channels=3)
    path = str(tmp_path / "w.npz")
    save_state_npz(path, v)
    back = load_state_npz(path, init_fcn(cfg, jax.random.PRNGKey(9)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="key mismatch"):
        load_state_npz(path, init_fcn(ModelConfig(use_regression=False),
                                      jax.random.PRNGKey(0)))


def _opt_state(tx, v):
    """An optax state with non-trivial moments and count."""
    state = tx.init(v["params"])
    grads = jax.tree.map(jnp.ones_like, v["params"])
    _, state = tx.update(grads, state, v["params"])
    return state


def test_checkpoint_roundtrip_keep_and_latest(tmp_path):
    cfg = ModelConfig()
    tx = optax.adam(1e-3)
    v = init_fcn(cfg, jax.random.PRNGKey(0), in_channels=3)
    o = _opt_state(tx, v)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(v)
    for step in (1, 5, 9):
        mgr.save(step, v, o)
    assert mgr.steps() == [5, 9] and mgr.latest_step() == 9
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]

    template = init_fcn(cfg, jax.random.PRNGKey(7), in_channels=3)
    step, v2, o2 = mgr.restore(template, tx.init(template["params"]))
    assert step == 9
    for a, b in zip(jax.tree.leaves((v2, o2)), jax.tree.leaves((v, o))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # inference-time restore of a training checkpoint: variables only
    step, v3, o3 = mgr.restore(template, step=5)
    assert step == 5 and o3 is None
    # another architecture is refused, not half-loaded
    with pytest.raises(ValueError):
        mgr.restore(init_fcn(ModelConfig(use_regression=False),
                             jax.random.PRNGKey(0)))


def test_trainer_resume_is_exact(tmp_path):
    """Two steps, checkpoint, one more step == resume in a fresh trainer
    and take the same step: bit-identical variables and optimizer state."""
    from tpufusion.data.synthetic import synthesize_dataset
    from tpufusion.train.trainer import Trainer

    spec = RangeViewSpec(res_h_deg=1.8)
    cfg = PipelineConfig(range_view=spec,
                         train=TrainConfig(batch_size=2, augment=False))
    data = synthesize_dataset(seed=1, num_frames=2, n_points=1024)
    batch = {"points": jnp.asarray(data["points"]),
             "center": jnp.asarray(data["center"]),
             "size": jnp.asarray(data["size"]),
             "yaw": jnp.asarray(data["yaw"])}
    key = jax.random.PRNGKey(0)

    def step(t):
        t.variables, t.opt_state, _ = t.train_step(
            t.variables, t.opt_state, batch, key
        )

    a = Trainer(cfg, outdir=str(tmp_path / "run"))
    step(a)
    step(a)
    a.ckpt.save(2, a.variables, a.opt_state)
    step(a)

    b = Trainer(cfg, outdir=str(tmp_path / "run"))
    assert b.resume() and b.step == 2
    step(b)
    for x, y in zip(jax.tree.leaves((a.variables, a.opt_state)),
                    jax.tree.leaves((b.variables, b.opt_state))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
