"""Fusion net, timestamp alignment, and serving harness tests (small
geometries to keep CPU runtime sane)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from tpufusion.config import (
    CameraConfig,
    DecodeConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
)
from tpufusion.data.align import align_camera_lidar_radar, nearest_indices
from tpufusion.models.fusion import (
    FusionConfig,
    apply_fusion,
    fusion_loss,
    init_fusion,
    trainable_groups,
)

SMALL_SPEC = RangeViewSpec(res_h_deg=1.8)  # width 201
SMALL_CAM = CameraConfig(width=201, height=64, channels=1)


SMALL_FUSION = FusionConfig(
    lidar_model=ModelConfig(),
    camera_model=ModelConfig(vertical_stride=2, use_regression=False),
    camera=SMALL_CAM,
    lidar_hw=(SMALL_SPEC.height, SMALL_SPEC.width),
)


def _small_fusion():
    return init_fusion(SMALL_FUSION, jax.random.PRNGKey(0))


def test_fusion_forward_shapes():
    variables = _small_fusion()
    cam = jnp.zeros((2, 64, 201, 1))
    lidar = jnp.zeros((2, 32, 201, 3))
    radar = jnp.zeros((2, 2))
    (centroid, rz), _ = apply_fusion(SMALL_FUSION, variables, cam, lidar,
                                     radar)
    assert centroid.shape == (2, 3) and rz.shape == (2, 1)


def test_fusion_freeze_filter():
    variables = _small_fusion()
    kept = trainable_groups(lock_lidar=True, lock_camera=True)
    assert kept, "head params must remain trainable"
    assert set(kept) <= set(variables["params"])
    assert not {"lidar_fcn", "camera_fcn"} & set(kept)
    assert set(trainable_groups()) == set(variables["params"])


def test_fusion_train_step_learns():
    variables = _small_fusion()
    tx = optax.adam(1e-3)
    opt_state = tx.init(variables["params"])
    cam = jnp.ones((4, 64, 201, 1)) * 0.1
    lidar = jnp.ones((4, 32, 201, 3)) * 0.2
    radar = jnp.asarray([[10.0, 0.1]] * 4)
    target = (jnp.asarray([[5.0, 1.0, -0.5]] * 4), jnp.asarray([[0.3]] * 4))

    @jax.jit
    def step(params, opt_state):
        def loss_fn(params):
            out, _ = apply_fusion(
                SMALL_FUSION,
                {"params": params,
                 "batch_stats": variables["batch_stats"]},
                cam, lidar, radar,
            )
            return fusion_loss(out, target)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params = variables["params"]
    params, opt_state, first = step(params, opt_state)
    for _ in range(20):
        params, opt_state, last = step(params, opt_state)
    assert float(last) < float(first) * 0.5, (first, last)


def test_nearest_indices():
    sorted_ts = np.array([0, 100, 200, 300])
    q = np.array([-10, 0, 49, 51, 149, 151, 1000])
    idx = nearest_indices(sorted_ts, q)
    np.testing.assert_array_equal(idx, [0, 0, 0, 1, 1, 2, 3])


def test_align_camera_lidar_radar():
    cam = np.array([105, 205, 305])
    lidar = np.array([0, 100, 200, 300])
    radar = np.array([50, 150, 250, 350])
    out = align_camera_lidar_radar(cam, lidar, radar)
    np.testing.assert_array_equal(out["lidar_index"], [1, 2, 3])
    np.testing.assert_array_equal(out["radar_index"], [1, 2, 3])


def test_lidar_pipeline_predict(rng):
    from tests.conftest import synthetic_cloud
    from tpufusion.serve.pipeline import LidarPipeline

    cfg = PipelineConfig(range_view=SMALL_SPEC, max_points=8192)
    pipe = LidarPipeline(cfg)
    cloud = synthetic_cloud(rng, n=4000, with_vehicle_at=(12.0, -3.0, -0.7))
    pose, found = pipe.predict_position(cloud)
    assert pose.shape == (7,)
    # untrained net: just verify the fused graph runs and returns finite data
    assert np.isfinite(pose).all()
    mean = LidarPipeline.fake_predict(cloud)
    assert mean.shape == (3,)


def test_replay_harness(rng):
    from tpufusion.serve.replay import ReplayHarness

    cfg = PipelineConfig(range_view=SMALL_SPEC)
    harness = ReplayHarness(cfg, chunk=4)
    pts = np.stack(
        [
            np.pad(
                __import__("tests.conftest", fromlist=["synthetic_cloud"])
                .synthetic_cloud(rng, n=2000),
                ((0, 48), (0, 0)),
                constant_values=np.nan,
            )
            for _ in range(8)
        ]
    )
    poses, founds, stats = harness.run(pts)
    assert poses.shape == (8, 7)
    s = stats.summary()
    assert s["frames"] == 8 and s["fps"] > 0


def test_plateau_decay_is_per_epoch():
    """make_fusion_tx must apply the Keras ReduceLROnPlateau semantics:
    the plateau test compares EPOCH-mean losses, not raw per-step batch
    losses (which are noisy enough to halve the LR inside epoch 0 — the
    measured loss-frozen-at-101 bug on the 512-frame fusion run)."""
    from tpufusion.train.fusion_trainer import make_fusion_tx

    spe = 64  # steps per epoch at 512 frames / batch 8
    tx = make_fusion_tx(1e-3, spe)
    params = {"w": jnp.zeros(3)}
    grads = {"w": jnp.ones(3)}
    state = tx.init(params)
    rng = np.random.default_rng(0)

    def plateau(state):
        return float(state[1].scale)

    @jax.jit
    def upd(state, value):
        return tx.update(grads, state, params, value=value)[1]

    # three epochs of noisy but steadily improving batch losses: under
    # per-step patience the +/-5 noise triggers repeated halvings; the
    # per-epoch accumulation must leave the scale untouched.
    for epoch in range(3):
        base = 100.0 - 30.0 * epoch
        for _ in range(spe):
            state = upd(state, jnp.float32(base + rng.uniform(-5.0, 5.0)))
    assert plateau(state) == 1.0

    # genuinely plateaued epochs DO reduce (patience=3 epochs, factor .5),
    # and keep reducing: 12 flat epochs must fit at least two reductions
    # (cooldown is counted in epochs, not steps — a steps-unit cooldown
    # would block the second one for 64 epochs)
    for _ in range(6 * spe):
        state = upd(state, jnp.float32(10.0))
    assert plateau(state) <= 0.5
    for _ in range(6 * spe):
        state = upd(state, jnp.float32(10.0))
    assert plateau(state) <= 0.25


def test_replay_harness_host_ring_matches_fresh(rng):
    """host_ring staging (bounded-reuse H2D buffers) must be output-
    identical to fresh-array staging, including across slot reuse (more
    chunks than ring slots exercises the overwrite hazard)."""
    from tests.conftest import synthetic_cloud
    from tpufusion.serve.replay import ReplayHarness

    cfg = PipelineConfig(range_view=SMALL_SPEC)
    pts = np.stack(
        [
            np.pad(
                synthetic_cloud(rng, n=2000),
                ((0, 48), (0, 0)),
                constant_values=np.nan,
            )
            for _ in range(24)
        ]
    )
    fresh = ReplayHarness(cfg, chunk=4)
    ring = ReplayHarness(cfg, chunk=4, host_ring=2)
    p1, f1, _ = fresh.run(pts)
    p2, f2, _ = ring.run(pts)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_allclose(p1, p2, atol=1e-6)
