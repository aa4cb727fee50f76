"""Training orchestration: epochs, validation, checkpoints, PR history.

The reference orchestration lives in `modules/lidar/train/train.py:107-290`
(Keras fit_generator + ModelCheckpoint + TensorBoard + LossHistory +
PR-curve plots, Ctrl-C-safe final save). Here: a plain loop over the
device-feeding pipeline with a jitted step, step-numbered npz checkpoints,
an in-memory metric history that serializes to the same PR-curve CSV
schema (`modules/lidar/common/pr_curve_plotter.py`), and interrupt-safe
final checkpointing.
"""

from __future__ import annotations

import csv
import os
import time

import jax
import numpy as np
import optax

from tpufusion.config import PipelineConfig
from tpufusion.data.pipeline import BatchPipeline
from tpufusion.models.fcn import init_fcn
from tpufusion.train.checkpoint import CheckpointManager
from tpufusion.train.train_step import make_eval_step, make_train_step
from tpufusion.utils.logging import get_logger

log = get_logger("trainer")


class MetricHistory:
    """Per-batch and per-epoch precision/recall/loss, like LossHistory
    (`train.py:81-104`)."""

    def __init__(self):
        self.batch = {"loss": [], "precision": [], "recall": []}
        self.epoch = {"loss": [], "precision": [], "recall": [],
                      "val_loss": [], "val_precision": [], "val_recall": []}

    def record_batch(self, metrics):
        for k in ("loss", "precision", "recall"):
            self.batch[k].append(float(metrics[k]))

    def record_epoch(self, train_metrics, val_metrics=None):
        for k in ("loss", "precision", "recall"):
            self.epoch[k].append(float(train_metrics[k]))
            self.epoch[f"val_{k}"].append(
                float(val_metrics[k]) if val_metrics else float("nan")
            )

    def write_pr_csv(self, path: str):
        """epoch, loss, precision, recall (+val) — pr_curve_plotter schema."""
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(
                ["epoch", "loss", "precision", "recall",
                 "val_loss", "val_precision", "val_recall"]
            )
            for i in range(len(self.epoch["loss"])):
                wr.writerow(
                    [i]
                    + [self.epoch[k][i] for k in
                       ("loss", "precision", "recall",
                        "val_loss", "val_precision", "val_recall")]
                )


class Trainer:
    def __init__(
        self,
        cfg: PipelineConfig,
        variables: dict | None = None,
        outdir: str = "./runs/default",
        in_channels: int = 3,
    ):
        self.cfg = cfg
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.variables = variables or init_fcn(
            cfg.model, jax.random.PRNGKey(cfg.train.seed), in_channels
        )
        tcfg = cfg.train
        if tcfg.lr_schedule == "cosine":
            decay_steps = tcfg.lr_decay_steps or tcfg.epochs * 100
            lr = optax.cosine_decay_schedule(
                tcfg.learning_rate, decay_steps, tcfg.lr_final_fraction
            )
        elif tcfg.lr_schedule == "constant":
            lr = tcfg.learning_rate
        else:
            raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")
        tx = optax.adam(lr)
        if cfg.train.grad_accum_steps > 1:
            tx = optax.MultiSteps(tx, cfg.train.grad_accum_steps)
        self.tx = tx
        self.opt_state = tx.init(self.variables["params"])
        if cfg.model.head not in ("corner", "direct"):
            raise ValueError(f"unknown model head {cfg.model.head!r}")
        # The direct head's yaw codec has one source of truth per pipeline:
        # DecodeConfig.direct_yaw_frame (decode must invert the codec the
        # model was trained with — NOTES.md round-3 sessions B/D).
        yaw_frame = cfg.decode.direct_yaw_frame
        self.train_step = make_train_step(
            cfg.model, tx, cfg.range_view, cfg.loss, cfg.train,
            yaw_frame=yaw_frame,
        )
        self.eval_step = make_eval_step(
            cfg.model, cfg.range_view, cfg.loss, yaw_frame=yaw_frame
        )
        self.history = MetricHistory()
        self.ckpt = CheckpointManager(
            os.path.join(outdir, "ckpt"), keep=cfg.train.keep_checkpoints
        )
        self.step = 0

    def _restore(self) -> int:
        step, self.variables, self.opt_state = self.ckpt.restore(
            self.variables, self.opt_state
        )
        self.step = step
        return step

    def resume(self) -> bool:
        try:
            step = self._restore()
        except FileNotFoundError:
            return False
        log.info("resumed from step %d", step)
        return True

    def _recover_from_divergence(self) -> bool:
        """Failure detection: on a non-finite loss, restore the last good
        checkpoint instead of training onward on poisoned weights. (The
        reference has no failure handling at all — SURVEY.md §5.)"""
        try:
            step = self._restore()
        except FileNotFoundError:
            log.error(
                "non-finite loss before any checkpoint exists — aborting "
                "so poisoned weights are never persisted"
            )
            return False
        log.warning("non-finite loss — restored checkpoint at step %d", step)
        return True

    def _append_metrics_jsonl(self, epoch, train_avg, val_avg=None) -> None:
        """Structured per-epoch scalars (the reference's TensorBoard
        equivalent, consumable by any dashboard)."""
        import json

        row = {"epoch": epoch, "step": self.step, "time": time.time()}
        row.update({k: float(v) for k, v in train_avg.items()})
        if val_avg:
            row.update({f"val_{k}": float(v) for k, v in val_avg.items()})
        with open(os.path.join(self.outdir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def _params_finite(self) -> bool:
        return all(
            bool(jax.numpy.isfinite(leaf).all())
            for leaf in jax.tree.leaves(self.variables["params"])
        )

    def _drain(self, pending: list, sums: dict, nb: int):
        """One host transfer for a span of queued device-side metrics.
        Returns (all_finite, nb, sums); on a non-finite loss the whole
        span is discarded (the weights are suspect from the divergence
        point onward, and the caller restores a checkpoint)."""
        host = jax.device_get(pending)
        for m in host:
            if not np.isfinite(m["loss"]):
                return False, nb, sums
        for m in host:
            self.history.record_batch(m)
            nb += 1
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        return True, nb, sums

    def fit(
        self,
        train_pipe: BatchPipeline,
        val_pipe: BatchPipeline | None = None,
        epochs: int | None = None,
    ):
        cfg = self.cfg.train
        epochs = epochs if epochs is not None else cfg.epochs
        key = jax.random.PRNGKey(cfg.seed)
        check_every = max(int(cfg.divergence_check_every), 1)
        try:
            for epoch in range(epochs):
                t0 = time.time()
                sums, nb = {}, 0
                pending: list = []
                diverged_unrecoverable = False
                # the loop body issues NO device->host transfer: metrics
                # stay on device and drain every check_every steps, so
                # dispatch runs ahead of execution (the reference blocked
                # on fit's feed_dict every batch; round 1 blocked on
                # float(loss) every step)
                for batch in train_pipe.epoch():
                    key, sub = jax.random.split(key)
                    self.variables, self.opt_state, metrics = (
                        self.train_step(
                            self.variables, self.opt_state, batch, sub
                        )
                    )
                    pending.append(metrics)
                    self.step += 1
                    if len(pending) >= check_every:
                        ok, nb, sums = self._drain(pending, sums, nb)
                        pending = []
                        if not ok and not self._recover_from_divergence():
                            diverged_unrecoverable = True
                            break
                if pending and not diverged_unrecoverable:
                    ok, nb, sums = self._drain(pending, sums, nb)
                    if not ok and not self._recover_from_divergence():
                        diverged_unrecoverable = True
                if diverged_unrecoverable or nb == 0:
                    log.error(
                        "epoch %d: training diverged with nothing to "
                        "restore — aborting", epoch,
                    )
                    break
                train_avg = {k: v / nb for k, v in sums.items()}

                val_avg = None
                if val_pipe is not None:
                    vsums, vn = {}, 0
                    for batch in val_pipe.epoch():
                        metrics = self.eval_step(self.variables, batch)
                        vn += 1
                        for k, v in metrics.items():
                            vsums[k] = vsums.get(k, 0.0) + float(v)
                    val_avg = {k: v / max(vn, 1) for k, v in vsums.items()}

                self.history.record_epoch(train_avg, val_avg)
                self._append_metrics_jsonl(epoch, train_avg, val_avg)
                log.info(
                    "epoch %d: loss=%.4f prec=%.3f rec=%.3f%s (%.1fs)",
                    epoch, train_avg["loss"], train_avg["precision"],
                    train_avg["recall"],
                    f" val_loss={val_avg['loss']:.4f}" if val_avg else "",
                    time.time() - t0,
                )
                if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                    self.ckpt.save(self.step, self.variables, self.opt_state)
        except KeyboardInterrupt:
            log.info("interrupted — saving final checkpoint")
        finally:
            # never persist non-finite weights as the "latest" checkpoint —
            # a later resume/recovery would restore them as if good
            if self._params_finite():
                self.ckpt.save(self.step, self.variables, self.opt_state)
            else:
                log.error("final weights are non-finite — NOT checkpointing")
            self.history.write_pr_csv(os.path.join(self.outdir, "pr_curve.csv"))
        return self.history
