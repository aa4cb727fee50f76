"""jit-compiled train / eval steps.

Everything that the reference did on the host per batch — unpickling,
python label encoding (`loader.py:243-253` -> `encoder.py:156-238`),
augmentation (`loader.py:31-57`) — happens on device inside one XLA
program here: (optional) point projection, label encoding, azimuth-roll
augmentation, forward, loss, backward, optimizer update, metrics.

Batches are dicts with either precomputed range-view `images` (B, H, W, 3)
or raw `points` (B, N, 4) to be projected on device, plus ground truth
`center` (B, 3), `size` (B, 3), `yaw` (B,).
"""

from __future__ import annotations

import jax
import optax

from tpufusion.config import LossConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion.data.augment import augment_batch
from tpufusion.geometry.encoding import (
    encode_direct_label_batch,
    encode_label_batch,
)
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fcn import apply_fcn
from tpufusion.models.losses import weighted_pose_loss
from tpufusion.models.metrics import batch_metrics


def _batch_images(batch, spec: RangeViewSpec):
    if "images" in batch:
        return batch["images"]
    # optional per-point validity (beam-structured scans mark no-return
    # rays invalid; the projector drops them like padding)
    return range_view_project_batch(
        batch["points"], spec, batch.get("valid")
    )


def _labels(batch, images, spec, head, yaw_frame):
    if "labels" in batch:
        # precomputed labels (camera-source training: footprints from
        # geometry/camera.camera_label_footprint, no on-device encode)
        return batch["labels"]
    if head == "direct":
        return encode_direct_label_batch(
            batch["center"], batch["size"], batch["yaw"], images, spec,
            yaw_frame=yaw_frame,
        )
    return encode_label_batch(
        batch["center"], batch["size"], batch["yaw"], images, spec
    )


def make_train_step(
    model_cfg: ModelConfig,
    tx: optax.GradientTransformation,
    spec: RangeViewSpec,
    loss_cfg: LossConfig,
    train_cfg: TrainConfig,
    mesh=None,
    yaw_frame: str = "local",
):
    """Returns train_step(variables, opt_state, batch, key) ->
    (variables, opt_state, metrics); metrics["loss"] is the loss. The
    params update through `tx` (whose state is `tx.init(params)`), the
    batch statistics through the normalization's running averages.

    With a 2-D (data, spatial) `mesh`, the range image and labels are
    pinned to the data x spatial layout after projection/encode, so GSPMD
    spatially partitions the FCN convolutions (halo exchanges at shard
    edges) instead of gathering full images per device.

    yaw_frame selects the direct head's sin/cos codec
    (geometry/encoding.encode_direct_label): "local" for oriented
    surfaces (the arc's ray-relative orientation is the locally visible
    quantity), "global" for rotationally symmetric surfaces, where the
    local target is pure position information a translation-equivariant
    trunk cannot represent (tools/train_synthetic_detector resolves this
    per scene family; decode must use the matching
    DecodeConfig.direct_yaw_frame).

    model_cfg.head="direct" encodes the 8-channel direct-pose targets
    instead of the 24-dim corner field; the azimuth-roll augmentation is
    skipped for it (the sin/cos yaw channels are not roll-invariant — see
    geometry/encoding.encode_direct_label).
    """
    head, use_regression = model_cfg.head, model_cfg.use_regression

    @jax.jit
    def train_step(variables, opt_state, batch, key):
        images = _batch_images(batch, spec)
        labels = _labels(batch, images, spec, head, yaw_frame)
        if train_cfg.augment and "labels" not in batch and head != "direct":
            images, labels = augment_batch(
                key, images, labels,
                batch["center"], batch["size"], batch["yaw"], spec,
            )
        if mesh is not None:
            from tpufusion.parallel.mesh import constrain_spatial

            images = constrain_spatial(images, mesh)
            labels = constrain_spatial(labels, mesh)

        def loss_fn(params):
            preds, stats = apply_fcn(
                model_cfg,
                {"params": params, "batch_stats": variables["batch_stats"]},
                images, train=True,
            )
            loss = weighted_pose_loss(preds, labels, loss_cfg, use_regression)
            return loss, (preds, stats)

        params = variables["params"]
        (loss, (preds, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = batch_metrics(preds, labels, use_regression)
        metrics["loss"] = loss
        return {"params": params, "batch_stats": stats}, opt_state, metrics

    return train_step


def make_eval_step(
    model_cfg: ModelConfig,
    spec: RangeViewSpec,
    loss_cfg: LossConfig,
    yaw_frame: str = "local",
):
    """Eval twin of make_train_step: eval_step(variables, batch) ->
    metrics. yaw_frame must match the codec the model was trained with
    (see make_train_step's docstring)."""
    head, use_regression = model_cfg.head, model_cfg.use_regression

    @jax.jit
    def eval_step(variables, batch):
        images = _batch_images(batch, spec)
        labels = _labels(batch, images, spec, head, yaw_frame)
        preds, _ = apply_fcn(model_cfg, variables, images, train=False)
        loss = weighted_pose_loss(preds, labels, loss_cfg, use_regression)
        metrics = batch_metrics(preds, labels, use_regression)
        metrics["loss"] = loss
        return metrics

    return eval_step
