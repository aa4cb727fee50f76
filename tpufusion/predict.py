"""Batch inference driver: dataset -> pose CSV + metadata.

The new-framework counterpart of `modules/lidar/train/predict.py:383-531`:
stream stored frames (extracted npz or reference-layout dirs) through the
fused FCN+decode graph in fixed-size batches and write the prediction CSV
(`objects_obs1_lidar_predictions.csv` schema) plus the mean-box-size
metadata CSV. Unlike the reference, the whole per-frame decode runs on
device; the host only pads the final partial batch.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from tpufusion.config import DEFAULT, ModelConfig, PipelineConfig
from tpufusion.decode.decode import (
    decode_batch,
    decode_batch_direct,
    decode_batch_multi,
)
from tpufusion.eval.submission import write_metadata_csv, write_predictions_csv
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fcn import apply_fcn
from tpufusion.parallel.mesh import constrain_spatial
from tpufusion.utils.logging import get_logger

log = get_logger("predict")


def make_e2e_step(model_cfg: ModelConfig, spec, decode_cfg,
                  method: str = "exact", max_obstacles: int = 1,
                  head: str = "corner", mesh=None):
    """The one fused inference graph everyone shares: raw point batches ->
    projection -> FCN -> pose decode. Used by the batch predictor, the
    replay harness, the online pipeline, and the benchmarks, so the decode
    pipeline has a single definition.

    max_obstacles=1 keeps the reference's largest-cluster semantics
    (predict.py:58-71) and returns pose (B, 7); >1 decodes the top-K
    clusters and returns poses (B, K, 7) for the multi-object tracker.
    head="direct" routes through the direct-pose decode (masked cluster
    averaging of the 8-channel head, decode.decode_batch_direct). With a
    2-D (data, spatial) `mesh` the range image is pinned to the data x
    spatial layout, so GSPMD partitions projection and FCN by width.

    The step is step(variables, points (B, N, 4), valid (B, N) or None).
    Its stages run under the named scopes "projection", "fcn" and
    "decode", which a profiler trace attributes device time to."""

    @jax.jit
    def step(variables, points, valid=None):
        with jax.named_scope("projection"):
            images = range_view_project_batch(points, spec, valid, method)
        if mesh is not None:
            images = constrain_spatial(images, mesh)
        with jax.named_scope("fcn"):
            preds, _ = apply_fcn(model_cfg, variables, images)
        with jax.named_scope("decode"):
            if head == "direct":
                out = decode_batch_direct(
                    preds, images, spec, decode_cfg, max_obstacles
                )
                if max_obstacles == 1:
                    return out["poses"][:, 0], out["found"][:, 0]
                return out["poses"], out["found"]
            if max_obstacles > 1:
                out = decode_batch_multi(
                    preds, images, spec, decode_cfg, max_obstacles
                )
                return out["poses"], out["found"]
            out = decode_batch(preds, images, spec, decode_cfg)
            return out["pose"], out["found"]

    return step


def predict_images(
    variables: dict,
    images: np.ndarray,  # (F, H, W, 3) range-view tensors
    cfg: PipelineConfig = DEFAULT,
    batch: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (poses (F, 7), found (F,)). The decode family follows
    cfg.model.head so a direct-head checkpoint decodes its 8-channel
    pose field instead of the corner vote."""
    spec, dcfg, head = cfg.range_view, cfg.decode, cfg.model.head

    @jax.jit
    def step(variables, imgs):
        preds, _ = apply_fcn(cfg.model, variables, imgs)
        if head == "direct":
            out = decode_batch_direct(preds, imgs, spec, dcfg, 1)
            return out["poses"][:, 0], out["found"][:, 0]
        out = decode_batch(preds, imgs, spec, dcfg)
        return out["pose"], out["found"]

    f = len(images)
    poses = np.zeros((f, 7), np.float32)
    found = np.zeros((f,), bool)
    for lo in range(0, f, batch):
        chunk = images[lo : lo + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        p, fd = step(variables, jax.numpy.asarray(chunk))
        poses[lo : lo + batch - pad] = np.asarray(p)[: batch - pad]
        found[lo : lo + batch - pad] = np.asarray(fd)[: batch - pad]
    log.info("predicted %d frames, %d detections", f, int(found.sum()))
    return poses, found


def predict_dataset_dir(
    variables: dict,
    dataset_dir: str,
    output_dir: str,
    cfg: PipelineConfig = DEFAULT,
    batch: int = 32,
) -> dict:
    """Extracted-dataset dir (lidar_frames.npz) -> prediction CSVs."""
    from tpufusion.data.etl import load_extracted

    data = load_extracted(dataset_dir)
    poses, found = predict_images(variables, data["images"], cfg, batch)
    os.makedirs(output_dir, exist_ok=True)
    pred_csv = os.path.join(output_dir, "objects_obs1_lidar_predictions.csv")
    meta_csv = os.path.join(output_dir, "objects_obs1_metadata.csv")
    write_predictions_csv(
        [(p[0], p[1], p[2], p[3], p[4], p[5], p[6]) for p in poses],
        list(map(int, data["timestamps"])),
        pred_csv,
    )
    write_metadata_csv(poses, meta_csv)
    return {
        "frames": len(poses),
        "detections": int(found.sum()),
        "predictions_csv": pred_csv,
        "metadata_csv": meta_csv,
    }
