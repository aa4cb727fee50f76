"""Fusion (camera+lidar+radar) training and inference drivers.

Covers `modules/lidar/train/train_fcn.py:317-505` and `predict_fcn.py`
(both drift-broken in the reference): triple-modality alignment via
vectorized timestamp joins, a jitted MSE train step with optional
sub-network freezing, ReduceLROnPlateau-style learning-rate decay, and a
batched inference driver emitting the centroid+rz CSV.
"""

from __future__ import annotations

import csv

import jax
import numpy as np
import optax

from tpufusion.data.align import align_camera_lidar_radar
from tpufusion.models.fusion import (
    GROUPS,
    FusionConfig,
    apply_fusion,
    fusion_loss,
    trainable_groups,
)
from tpufusion.utils.logging import get_logger

log = get_logger("fusion")


def build_fusion_batches(
    cam_images: np.ndarray,  # (Fc, Hc, Wc, 1) in camera-timestamp order
    cam_ts: np.ndarray,
    cam_poses: np.ndarray,  # (Fc, 4) tx ty tz rz at camera timestamps
    lidar_images: np.ndarray,  # (Fl, H, W, 3)
    lidar_ts: np.ndarray,
    radar_feats: np.ndarray,  # (Fr, 2) range, angle
    radar_ts: np.ndarray,
) -> dict[str, np.ndarray]:
    """One aligned sample per camera frame (train_fcn.py:178-255)."""
    idx = align_camera_lidar_radar(cam_ts, lidar_ts, radar_ts)
    return {
        "cam": cam_images,
        "lidar": lidar_images[idx["lidar_index"]],
        "radar": radar_feats[idx["radar_index"]],
        "centroid": np.asarray(cam_poses[:, :3], np.float32),
        "rz": np.asarray(cam_poses[:, 3:4], np.float32),
    }


def make_fusion_train_step(fcfg: FusionConfig, tx, groups=GROUPS):
    """Jitted step over the DEVICE-RESIDENT dataset: the batch gather by
    `rows` happens inside the jit, so each step moves only a scalar loss
    device->host and no batch host->device. Only the parameter `groups`
    train (trainable_groups); `tx`'s state covers exactly those."""

    @jax.jit
    def step(variables, opt_state, data, rows, key):
        params = variables["params"]
        train = {g: params[g] for g in groups}

        def loss_fn(train):
            out, stats = apply_fusion(
                fcfg,
                {"params": {**params, **train},
                 "batch_stats": variables["batch_stats"]},
                data["cam"][rows], data["lidar"][rows], data["radar"][rows],
                train=True, dropout_key=key,
            )
            loss = fusion_loss(
                out, (data["centroid"][rows], data["rz"][rows])
            )
            return loss, stats

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            train
        )
        # reduce_on_plateau in the chain consumes the loss value
        updates, opt_state = tx.update(grads, opt_state, train, value=loss)
        train = optax.apply_updates(train, updates)
        variables = {"params": {**params, **train}, "batch_stats": stats}
        return variables, opt_state, loss

    return step


def make_fusion_tx(lr: float, steps_per_epoch: int):
    """adam + Keras-style ReduceLROnPlateau (train_fcn.py:442-443).

    Keras applies the plateau test once per EPOCH on the epoch's loss;
    the optax transform sees per-step batch losses, so accumulate a full
    epoch of them before comparing (accumulation_size) and wait
    patience=3 epochs. Raw per-step patience collapses the LR inside the
    first epoch on any dataset larger than a few batches (measured: a
    512-frame run froze at loss 101 by epoch 1). Note optax's patience
    and cooldown both count accumulation WINDOWS (= epochs here), not
    steps — its _update_scale runs and decrements cooldown_count once
    per accumulation_size values.
    """
    return optax.chain(
        optax.adam(lr),
        optax.contrib.reduce_on_plateau(
            patience=3, factor=0.5,
            accumulation_size=steps_per_epoch,
            cooldown=1,
        ),
    )


def train_fusion(
    fcfg: FusionConfig,
    variables: dict,
    data: dict[str, np.ndarray],
    epochs: int = 10,
    batch_size: int = 8,
    lr: float = 1e-3,
    lock_lidar: bool = False,
    lock_camera: bool = False,
    seed: int = 0,
) -> tuple[dict, list[float]]:
    """-> (trained variables, per-epoch mean losses)."""
    groups = trainable_groups(lock_lidar, lock_camera)
    n = len(data["cam"])
    steps_per_epoch = max(1, (max(n - batch_size, 0)) // batch_size + 1)
    tx = make_fusion_tx(lr, steps_per_epoch)
    opt_state = tx.init({g: variables["params"][g] for g in groups})
    step = make_fusion_train_step(fcfg, tx, groups)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    losses = []
    # stage the dataset on device ONCE and gather batches on-device
    dev = {
        k: jax.numpy.asarray(data[k])
        for k in ("cam", "lidar", "radar", "centroid", "rz")
    }
    for epoch in range(epochs):
        order = rng.permutation(n)
        epoch_losses = []
        for lo in range(0, n - batch_size + 1, batch_size):
            rows = jax.numpy.asarray(order[lo : lo + batch_size])
            key, sub = jax.random.split(key)
            variables, opt_state, loss = step(
                variables, opt_state, dev, rows, sub
            )
            epoch_losses.append(float(loss))
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else 0.0
        losses.append(mean_loss)
        log.info("fusion epoch %d loss %.5f", epoch, mean_loss)
    return variables, losses


def predict_fusion(
    fcfg: FusionConfig,
    variables: dict,
    data: dict[str, np.ndarray],
    timestamps,
    output_csv: str,
    batch_size: int = 8,
) -> None:
    """Batched fusion inference -> centroid+rz CSV (predict_fcn.py:157-183)."""
    @jax.jit
    def fwd(variables, cam, lidar, radar):
        out, _ = apply_fusion(fcfg, variables, cam, lidar, radar)
        return out

    n = len(data["cam"])
    rows = []
    for lo in range(0, n, batch_size):
        sl = slice(lo, min(lo + batch_size, n))
        pad = batch_size - (sl.stop - sl.start)
        def pick(a):
            x = a[sl]
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            return jax.numpy.asarray(x)
        centroid, rz = fwd(variables, pick(data["cam"]), pick(data["lidar"]), pick(data["radar"]))
        centroid = np.asarray(centroid)[: sl.stop - sl.start]
        rz = np.asarray(rz)[: sl.stop - sl.start]
        for c, r in zip(centroid, rz):
            rows.append((c[0], c[1], c[2], r[0]))
    with open(output_csv, "w", newline="") as f:
        wr = csv.DictWriter(
            f, ["timestamp", "tx", "ty", "tz", "rx", "ry", "rz", "l", "w", "h"]
        )
        wr.writeheader()
        for ts, (tx, ty, tz, rz_) in zip(timestamps, rows):
            wr.writerow(
                {
                    "timestamp": ts,
                    "tx": float(tx), "ty": float(ty), "tz": float(tz),
                    "rx": 0.0, "ry": 0.0, "rz": float(rz_),
                    "l": 0.0, "w": 0.0, "h": 0.0,
                }
            )
