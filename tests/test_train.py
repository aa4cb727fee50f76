"""Model, loss, data pipeline, and end-to-end training smoke tests.

Training tests use a reduced azimuth resolution (width 201 instead of 1801)
to keep CPU runtime sane; the layer-geometry constraints (W = 4c-3, c odd,
(c+1)/2 even) hold for both.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from tpufusion.config import (
    LossConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
    TrainConfig,
)
from tpufusion.data.pipeline import BatchPipeline, epoch_indices
from tpufusion.data.synthetic import synthesize_dataset
from tpufusion.models.fcn import apply_fcn, init_fcn
from tpufusion.models.losses import weighted_pose_loss
from tpufusion.models.metrics import batch_metrics
from tpufusion.train.stats import population_weights
from tpufusion.train.train_step import make_train_step

SMALL_SPEC = RangeViewSpec(res_h_deg=1.8)  # width 201


def _conv1(trainer):
    return np.asarray(trainer.variables["params"]["conv1"]["kernel"])


def _poison_conv1(trainer):
    k = trainer.variables["params"]["conv1"]["kernel"]
    trainer.variables["params"]["conv1"]["kernel"] = jnp.full_like(k, jnp.nan)


def _run_step(trainer, batch, key):
    trainer.variables, trainer.opt_state, m = trainer.train_step(
        trainer.variables, trainer.opt_state, batch, key
    )
    return m


def test_small_spec_geometry():
    assert SMALL_SPEC.width == 201 and SMALL_SPEC.height == 32


def test_fcn_output_shape():
    cfg = ModelConfig()
    variables = init_fcn(cfg, jax.random.PRNGKey(0), in_channels=3)
    x = jnp.zeros((1, 32, 1801, 3))
    y, _ = apply_fcn(cfg, variables, x)
    assert y.shape == (1, 32, 1801, 26)
    probs = np.asarray(y[..., :2])
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert (np.asarray(y[..., 2:]) >= 0).all()  # relu regression head


def test_fcn_camera_stride_shape():
    cfg = ModelConfig(vertical_stride=2, use_regression=False)
    variables = init_fcn(cfg, jax.random.PRNGKey(0), in_channels=1)
    # camera: 512 x 1368; width pipeline: 1368+3=1371 -> not the lidar
    # geometry, reference crops (0,4) for camera. Use the lidar width here
    # and just verify the stride-2 vertical path composes.
    x = jnp.zeros((1, 32, 201, 1))
    y, _ = apply_fcn(cfg, variables, x)
    assert y.shape[0] == 1 and y.shape[-1] == 2


def test_weighted_loss_semantics(rng):
    b, p = 2, 64
    y_true = np.zeros((b, p, 26), np.float32)
    fg = rng.random((b, p)) < 0.2
    y_true[..., 0] = ~fg
    y_true[..., 1] = fg
    y_true[..., 2:] = rng.normal(size=(b, p, 24)) * fg[..., None]
    y_pred = np.concatenate(
        [
            np.clip(rng.random((b, p, 2)), 1e-7, 1).astype(np.float32),
            rng.normal(size=(b, p, 24)).astype(np.float32),
        ],
        axis=-1,
    )
    cfg = LossConfig(obj_to_bkg_ratio=0.1, avg_obj_size=10.0, weight_bb=0.01)

    # direct numpy restatement
    area = fg.sum(1, keepdims=True).astype(np.float64)
    w = 0.1 * y_true[..., 0] + (10.0 / np.clip(area, 1e-7, p))[:, :] * y_true[..., 1]
    nll = -(
        y_true[..., 0] * np.log(y_pred[..., 0])
        + y_true[..., 1] * np.log(y_pred[..., 1])
    )
    pix = w * nll * 1000.0
    norm = np.sqrt(((y_true[..., 2:] - y_pred[..., 2:]) ** 2).sum(-1))
    reg = (10.0 / np.clip(area, 1e-7, p)) * y_true[..., 1] * norm
    want = (pix + 0.01 * reg).mean()

    got = float(weighted_pose_loss(jnp.asarray(y_pred), jnp.asarray(y_true), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_metrics_semantics():
    y_true = np.zeros((1, 8, 26), np.float32)
    y_true[0, :4, 1] = 1
    y_true[0, 4:, 0] = 1
    y_pred = np.zeros((1, 8, 26), np.float32)
    y_pred[0, :2, 1] = 0.9  # 2 tp
    y_pred[0, 6:, 1] = 0.8  # 2 fp
    m = batch_metrics(jnp.asarray(y_pred), jnp.asarray(y_true))
    assert abs(float(m["precision"]) - 0.5) < 1e-5
    assert abs(float(m["recall"]) - 0.5) < 1e-5


def test_epoch_indices_fill():
    r = np.random.default_rng(0)
    plan = epoch_indices(10, 4, r, shuffle=True)
    assert plan.shape == (3, 4)
    # every sample appears at least once
    assert set(np.arange(10)) <= set(plan.ravel().tolist())


def test_population_weights_match_oracle(rng):
    from tests.oracle import reference_numpy as oracle

    n = 4
    centers = np.stack(
        [rng.uniform(8, 25, n), rng.uniform(-5, 5, n), np.full(n, -0.7)], 1
    )
    sizes = np.tile([4.2, 1.6, 1.5], (n, 1))
    yaws = rng.uniform(-0.5, 0.5, n)
    got = population_weights(centers, sizes, yaws, RangeViewSpec())

    areas = []
    for i in range(n):
        (ulx, uly), (lrx, lry) = oracle.outer_rect(centers[i], sizes[i], yaws[i])
        m = np.zeros((oracle.H, oracle.W))
        m[uly:lry, ulx:lrx] = 1
        areas.append(m.sum())
    areas = np.array(areas)
    pos = areas[areas > 0].sum()
    total = oracle.H * oracle.W * (areas > 0).sum()
    np.testing.assert_allclose(
        got["positive_to_negative_ratio"], pos / (total - pos), rtol=2e-2
    )
    np.testing.assert_allclose(
        got["average_area"], pos / (areas > 0).sum(), rtol=2e-2
    )


@pytest.mark.slow
def test_train_learns():
    """30 steps on tiny synthetic data: loss drops, recall climbs."""
    spec = SMALL_SPEC
    data = synthesize_dataset(seed=7, num_frames=16, n_points=4096)
    from tpufusion.geometry.range_view import range_view_project_batch

    images = np.asarray(
        range_view_project_batch(jnp.asarray(data["points"]), spec)
    )
    ds = {
        "images": images,
        "center": data["center"],
        "size": data["size"],
        "yaw": data["yaw"],
    }
    stats = population_weights(data["center"], data["size"], data["yaw"], spec)
    # note: the synthetic scenes are denser in foreground than the Didi
    # data, so the reference's x4 negative weight overweights background
    # here; the raw ratio balances the classes
    loss_cfg = LossConfig(
        obj_to_bkg_ratio=stats["positive_to_negative_ratio"],
        avg_obj_size=stats["average_area"],
    )
    train_cfg = TrainConfig(batch_size=8, augment=True, seed=0)

    mcfg = ModelConfig()
    tx = optax.adam(3e-3)
    variables = init_fcn(mcfg, jax.random.PRNGKey(0), in_channels=3)
    opt_state = tx.init(variables["params"])
    step = make_train_step(mcfg, tx, spec, loss_cfg, train_cfg)

    pipe = BatchPipeline(ds, batch_size=8, seed=0)
    key = jax.random.PRNGKey(0)
    losses, recalls = [], []
    it = iter(pipe)
    for i in range(40):
        key, sub = jax.random.split(key)
        variables, opt_state, metrics = step(
            variables, opt_state, next(it), sub
        )
        losses.append(float(metrics["loss"]))
        recalls.append(float(metrics["recall"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.7, losses
    assert np.mean(recalls[-5:]) > 0.5, recalls


def test_grad_accumulation(tmp_path):
    """grad_accum_steps=2: params change only every 2nd micro-batch, and the
    applied update equals the mean-gradient update."""
    from tpufusion.config import PipelineConfig
    from tpufusion.train.trainer import Trainer

    cfg = PipelineConfig(
        range_view=SMALL_SPEC,
        train=TrainConfig(batch_size=4, augment=False, grad_accum_steps=2),
    )
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"))
    data = synthesize_dataset(seed=1, num_frames=8, n_points=2048)
    from tpufusion.geometry.range_view import range_view_project_batch

    images = np.asarray(
        range_view_project_batch(jnp.asarray(data["points"]), SMALL_SPEC)
    )
    batch = {
        "images": jnp.asarray(images[:4]),
        "center": jnp.asarray(data["center"][:4]),
        "size": jnp.asarray(data["size"][:4]),
        "yaw": jnp.asarray(data["yaw"][:4]),
    }
    k = jax.random.PRNGKey(0)
    before = _conv1(trainer)
    _run_step(trainer, batch, k)
    mid = _conv1(trainer)
    np.testing.assert_array_equal(mid, before)  # accumulating, no update yet
    _run_step(trainer, batch, k)
    after = _conv1(trainer)
    assert np.abs(after - before).max() > 0  # update applied on step 2


def test_cosine_lr_schedule(tmp_path):
    """lr_schedule='cosine' decays the applied update toward
    lr_final_fraction * lr by lr_decay_steps (the reference's lidar
    trainer is constant-LR; this is the device-side schedule option)."""
    from tpufusion.config import PipelineConfig
    from tpufusion.train.trainer import Trainer

    cfg = PipelineConfig(
        range_view=SMALL_SPEC,
        train=TrainConfig(
            batch_size=4, augment=False, lr_schedule="cosine",
            lr_decay_steps=6, lr_final_fraction=1e-3,
        ),
    )
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"))
    data = synthesize_dataset(seed=1, num_frames=4, n_points=2048)
    from tpufusion.geometry.range_view import range_view_project_batch

    images = np.asarray(
        range_view_project_batch(jnp.asarray(data["points"]), SMALL_SPEC)
    )
    batch = {
        "images": jnp.asarray(images),
        "center": jnp.asarray(data["center"]),
        "size": jnp.asarray(data["size"]),
        "yaw": jnp.asarray(data["yaw"]),
    }
    k = jax.random.PRNGKey(0)
    deltas = []
    for _ in range(7):
        before = _conv1(trainer)
        _run_step(trainer, batch, k)
        after = _conv1(trainer)
        deltas.append(np.abs(after - before).max())
    # adam's per-step magnitude ~ lr: the final (post-horizon) update is
    # ~1000x smaller than the first
    assert deltas[-1] < deltas[0] * 0.01, deltas


def test_divergence_recovery(tmp_path):
    """A non-finite loss restores the last checkpoint instead of training
    on poisoned weights."""
    from tpufusion.config import PipelineConfig
    from tpufusion.train.trainer import Trainer

    cfg = PipelineConfig(
        range_view=SMALL_SPEC,
        train=TrainConfig(batch_size=4, epochs=1, augment=False),
    )
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"))
    trainer.ckpt.save(0, trainer.variables, trainer.opt_state)
    want = _conv1(trainer)
    # poison the weights, then trigger recovery
    _poison_conv1(trainer)
    assert trainer._recover_from_divergence()
    got = _conv1(trainer)
    np.testing.assert_array_equal(got, want)


def test_checkpoint_roundtrip(tmp_path):
    from tpufusion.train.checkpoint import CheckpointManager

    cfg = ModelConfig()
    tx = optax.adam(1e-3)
    variables = init_fcn(cfg, jax.random.PRNGKey(0), in_channels=3)
    opt_state = tx.init(variables["params"])
    x = jnp.ones((1, 32, 201, 3))
    want = np.asarray(apply_fcn(cfg, variables, x)[0])

    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    mgr.save(3, variables, opt_state)

    template = init_fcn(cfg, jax.random.PRNGKey(42), in_channels=3)
    step, v2, o2 = mgr.restore(template, tx.init(template["params"]))
    assert step == 3
    got = np.asarray(apply_fcn(cfg, v2, x)[0])
    np.testing.assert_array_equal(got, want)
    for a, b in zip(jax.tree.leaves(o2), jax.tree.leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_recovers_from_divergence(tmp_path):
    """fit() detects a non-finite loss within divergence_check_every steps,
    restores the last checkpoint, and finishes with finite weights —
    without any per-step host sync (drains ~steps/check_every times)."""
    from tpufusion.config import PipelineConfig
    from tpufusion.data.pipeline import BatchPipeline
    from tpufusion.data.synthetic import synthesize_dataset
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.train.trainer import Trainer

    cfg = PipelineConfig(
        range_view=SMALL_SPEC,
        train=TrainConfig(
            batch_size=4, epochs=1, augment=False, divergence_check_every=2
        ),
    )
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"))
    trainer.ckpt.save(0, trainer.variables, trainer.opt_state)
    good = _conv1(trainer)
    # poison the live weights: every loss is NaN until recovery restores
    _poison_conv1(trainer)

    data = synthesize_dataset(seed=3, num_frames=16, n_points=2048)
    images = np.asarray(
        range_view_project_batch(jnp.asarray(data["points"]), SMALL_SPEC)
    )
    train_data = {
        "images": images,
        "center": data["center"],
        "size": data["size"],
        "yaw": data["yaw"],
    }
    drains = []
    orig = trainer._drain

    def counting_drain(pending, sums, nb):
        drains.append(len(pending))
        return orig(pending, sums, nb)

    trainer._drain = counting_drain
    hist = trainer.fit(BatchPipeline(train_data, 4, seed=0))
    # recovery happened: finite weights again, and post-recovery batches
    # were recorded with finite losses
    now = _conv1(trainer)
    assert np.isfinite(now).all()
    assert len(hist.batch["loss"]) > 0
    assert np.isfinite(hist.batch["loss"]).all()
    # host pulls were batched, not per step
    assert all(n <= 2 for n in drains) and len(drains) >= 2
    # the restored-then-trained weights moved off the checkpoint
    assert np.abs(now - good).max() > 0


def test_reg_output_activation_linear_represents_signed_targets():
    """relu (reference-compat) clamps the regression head to >= 0 —
    unable to express the signed corner targets (PARITY.md #7); the
    "linear" option passes negatives through."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from tpufusion.config import ModelConfig
    from tpufusion.models.fcn import apply_fcn, init_fcn

    x = jnp.zeros((1, 8, 201, 3))
    for act, can_be_negative in (("relu", False), ("linear", True)):
        cfg = dataclasses.replace(ModelConfig(), reg_output_activation=act)
        v = init_fcn(cfg, jax.random.PRNGKey(0), in_channels=3)
        # force the head negative-biased so linear must emit negatives
        b = v["params"]["deconv6b"]["bias"]
        v["params"]["deconv6b"]["bias"] = -1.0 * jnp.ones_like(b)
        out = np.asarray(apply_fcn(cfg, v, x)[0])
        reg = out[..., 2:]
        assert (reg < 0).any() == can_be_negative, act


def test_reg_target_norm_clip_masks_clutter_pixels():
    """Pixels whose target corner norm exceeds the clip contribute no
    regression loss (LossConfig.reg_target_norm_clip); default None keeps
    the reference's supervise-the-whole-rect behavior."""
    import jax.numpy as jnp
    import numpy as np

    from tpufusion.config import LossConfig
    from tpufusion.models.losses import weighted_pose_loss

    b, p = 1, 4
    y_true = np.zeros((b, p, 26), np.float32)
    y_true[..., 0] = 1.0
    # pixel 0: foreground, small well-defined target
    y_true[0, 0, :2] = [0.0, 1.0]
    y_true[0, 0, 2:] = 0.5
    # pixel 1: foreground, huge clutter target (norm ~ 98)
    y_true[0, 1, :2] = [0.0, 1.0]
    y_true[0, 1, 2:] = 20.0
    y_pred = np.full((b, p, 26), 0.5, np.float32)
    y_pred[..., :2] = 0.5

    base = dict(obj_to_bkg_ratio=0.1, avg_obj_size=2.0, weight_bb=1.0)
    l_ref = float(weighted_pose_loss(jnp.asarray(y_pred), jnp.asarray(y_true),
                                     LossConfig(**base)))
    l_clip = float(weighted_pose_loss(jnp.asarray(y_pred), jnp.asarray(y_true),
                                      LossConfig(**base,
                                                 reg_target_norm_clip=15.0)))
    # clipping removes the huge pixel's reg term -> strictly smaller loss
    assert l_clip < l_ref
    # and equals a hand-built loss where pixel 1's reg contribution is gone
    y_true_nop1 = y_true.copy()
    y_true_nop1[0, 1, 2:] = y_pred[0, 1, 2:]  # zero diff -> zero reg term
    l_manual = float(weighted_pose_loss(jnp.asarray(y_pred),
                                        jnp.asarray(y_true_nop1),
                                        LossConfig(**base)))
    np.testing.assert_allclose(l_clip, l_manual, rtol=1e-6)


def test_trainer_direct_head_plumbed(tmp_path):
    """ModelConfig.head='direct' through the main Trainer entry point:
    the train step encodes 8-channel direct-pose targets against the
    10-channel output (previously only tools/train_synthetic_detector
    passed head explicitly), and eval_step matches."""
    import dataclasses

    from tpufusion.config import PipelineConfig
    from tpufusion.train.trainer import Trainer

    cfg = PipelineConfig(
        range_view=SMALL_SPEC,
        model=ModelConfig(head="direct", reg_output_activation="linear"),
        train=TrainConfig(batch_size=4, augment=False),
    )
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"))
    data = synthesize_dataset(seed=1, num_frames=4, n_points=2048)
    batch = {
        "points": jnp.asarray(data["points"]),
        "center": jnp.asarray(data["center"]),
        "size": jnp.asarray(data["size"]),
        "yaw": jnp.asarray(data["yaw"]),
    }
    metrics = _run_step(trainer, batch, jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["loss"]))
    emetrics = trainer.eval_step(trainer.variables, batch)
    assert np.isfinite(float(emetrics["loss"]))
    with pytest.raises(ValueError, match="head"):
        Trainer(
            cfg.replace(model=ModelConfig(head="nope")),
            outdir=str(tmp_path / "run2"),
        )


def test_detector_evaluate_prepared_matches_unprepared():
    """evaluate(...) with externally prepared batches (the operating-point
    tuner's fast path) must score identically to the self-preparing call."""
    import dataclasses

    from tpufusion.config import DEFAULT, RangeViewSpec
    from tpufusion.models.fcn import init_fcn
    from tpufusion.tools.train_synthetic_detector import (
        evaluate,
        prepare_eval_batches,
    )

    spec = RangeViewSpec(res_h_deg=1.8)  # small geometry for CPU
    gd = dataclasses.replace(
        DEFAULT.model, head="direct", reg_output_activation="linear"
    )
    st = init_fcn(gd, jax.random.PRNGKey(0), in_channels=3)
    dcfg = dataclasses.replace(DEFAULT.decode, min_prob=0.5, min_bbox_area=4.0)
    kw = dict(batch=4, n_points=2048, seed=7, head="direct",
              scenes="beam", center="geometric", n_batches=2)
    prepared = prepare_eval_batches(
        gd, st, spec, batch=4, n_points=2048, seed=7, scenes="beam",
        n_batches=2,
    )
    a = evaluate(gd, st, spec, dcfg, **kw)
    b = evaluate(gd, st, spec, dcfg, **kw, prepared=prepared)
    for k in a:
        assert a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]), (k, a, b)


def test_pipeline_device_resident_matches_streaming():
    """Device-resident batching (the default when the dataset fits — one
    transfer per epoch instead of one per batch) must yield exactly the
    batches the host-streaming path yields for the same seed."""
    rng = np.random.default_rng(3)
    ds = {
        "points": rng.normal(0, 1, (20, 64, 4)).astype(np.float32),
        "center": rng.normal(0, 1, (20, 3)).astype(np.float32),
    }
    a = BatchPipeline(ds, batch_size=8, seed=4, device_resident=True)
    b = BatchPipeline(ds, batch_size=8, seed=4, device_resident=False)
    assert a._dev is not None and b._dev is None
    for ba, bb in zip(a.epoch(), b.epoch()):
        for k in ds:
            np.testing.assert_array_equal(np.asarray(ba[k]), np.asarray(bb[k]))


def test_reg_channel_weights_rescale_gradient_share():
    """reg_channel_weights multiplies per-channel diffs inside the joint
    L2: a boosted channel's error raises the loss by exactly the weight
    (single-channel error case), uniform 1.0 weights match None, and a
    wrong-length tuple raises. Motivation: the direct head's sin/cos yaw
    channels (<= 0.43) are gradient-starved next to meter-scale dc —
    measured corr(yaw) 0.07 after 12k steps without the boost, 0.99 when
    overfitting one batch with it (NOTES.md round 3)."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from tpufusion.config import LossConfig
    from tpufusion.models.losses import weighted_pose_loss

    b, p, reg = 1, 2, 8
    y_true = np.zeros((b, p, 2 + reg), np.float32)
    y_true[..., 0] = 1.0
    y_true[0, 0, :2] = [0.0, 1.0]  # one fg pixel
    y_true[0, 0, 8] = 0.4  # sin-yaw target; all other reg targets 0
    y_pred = np.zeros((b, p, 2 + reg), np.float32)
    y_pred[..., :2] = 0.5  # uniform class prob; reg pred 0

    base = dict(obj_to_bkg_ratio=0.1, avg_obj_size=2.0, weight_bb=1.0)
    l_none = weighted_pose_loss(jnp.asarray(y_pred), jnp.asarray(y_true),
                                LossConfig(**base))
    l_ones = weighted_pose_loss(
        jnp.asarray(y_pred), jnp.asarray(y_true),
        LossConfig(**base, reg_channel_weights=(1.0,) * reg))
    np.testing.assert_allclose(float(l_none), float(l_ones), rtol=1e-6)

    w = 8.0
    l_boost = weighted_pose_loss(
        jnp.asarray(y_pred), jnp.asarray(y_true),
        LossConfig(**base, reg_channel_weights=(1.0,) * 6 + (w, w)))
    # the only reg error is on the boosted sin channel, so the reg term
    # scales by exactly w: loss_boost - cls = w * (loss_none - cls)
    l_cls = weighted_pose_loss(
        jnp.asarray(y_pred),
        jnp.asarray(np.concatenate(
            [y_true[..., :2], np.zeros((b, p, reg), np.float32)], -1)),
        LossConfig(**base))
    np.testing.assert_allclose(
        float(l_boost) - float(l_cls), w * (float(l_none) - float(l_cls)),
        rtol=1e-3)

    with pytest.raises(ValueError, match="reg_channel_weights"):
        weighted_pose_loss(jnp.asarray(y_pred), jnp.asarray(y_true),
                           LossConfig(**base, reg_channel_weights=(1.0,) * 5))


def test_detector_trainer_points_mix_smoke(tmp_path):
    """--points_mix cycles sweep resolutions per step (distinct static
    shapes -> one compiled variant each) and records the mix in the
    asset json; the held-out eval stays at --n_points."""
    from tpufusion.tools.train_synthetic_detector import main as train_main

    out = str(tmp_path / "asset.npz")
    train_main([
        "--steps", "2", "--batch", "2", "--n_points", "1024",
        "--points_mix", "512,1024", "--eval_every", "2",
        "--eval_batches", "1", "--eval_min_prob", "0.5",
        "--eval_min_bbox_area", "4",
    ] + ["--out", out])
    import json as _json
    import os

    assert os.path.exists(out)
    meta = _json.load(open(out + ".json"))
    assert meta["points_mix"] == "512,1024"
    assert meta["n_points"] == 1024
    # circle ("beam") scenes resolve the auto codec to global: the local
    # target is unlearnable on rotationally symmetric surfaces
    assert meta["decode"]["direct_yaw_frame"] == "global"


def test_resolve_yaw_frame():
    from tpufusion.tools.train_synthetic_detector import resolve_yaw_frame

    assert resolve_yaw_frame("auto", "beam") == "global"
    assert resolve_yaw_frame("auto", "uniform") == "global"
    assert resolve_yaw_frame("auto", "beam-ellipse") == "local"
    assert resolve_yaw_frame("local", "beam") == "local"
    assert resolve_yaw_frame("global", "beam-ellipse") == "global"
