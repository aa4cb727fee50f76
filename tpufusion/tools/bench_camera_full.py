"""Time + convergence-check camera-FCN training at the FULL reference scale.

The reference trains its camera variant on 512x1368x1 crops
(`modules/lidar/train/globals.py:19-21`, rows 430:942 of the 1096-row
frame) with the same FCN geometry as lidar but vertical_stride 2 and no
regression head (`modules/lidar/train/model.py:45-60`). tpufusion's
camera path (cli train --source camera) was exercised only at reduced
geometry through round 2 — the 1368-wide deconvs were the predicted cost
center. This tool measures the real shape:

  * ms/step of the jitted camera train step at batch >= 8 (distinct
    batches, ended by block_until_ready);
  * a short convergence run on a fixed synthetic camera dataset
    (footprint labels from geometry/camera.camera_label_footprint, the
    same encoder the CLI uses) — loss + precision/recall trajectory.

Run on a GPU: python -m tpufusion.tools.bench_camera_full [--batch 8]
[--steps 120]. Prints one JSON line, with the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from tpufusion.config import (
    CameraConfig,
    LossConfig,
    ModelConfig,
    RangeViewSpec,
    TrainConfig,
)
from tpufusion.geometry.camera import camera_label_footprint
from tpufusion.models.fcn import init_fcn
from tpufusion.tools.train_fusion_synthetic import (
    make_camera,
    render_camera_frames,
)
from tpufusion.train.train_step import make_train_step
from tpufusion.utils.device import (
    device_record,
    enable_compile_cache,
    require_gpu,
)
from tpufusion.utils.profiling import measure

CAM = CameraConfig(width=1368, height=512, crop_top=0)


def build_camera_dataset(n_frames: int, seed: int):
    """(frames (F,512,1368,1), labels (F,512,1368,2)) synthetic scenes.

    Physical vehicle centers are drawn inside the camera FOV wedge;
    frames render like the fusion tool's camera branch and labels
    rasterize through the reference's outer-rect footprint encoder."""
    rng = np.random.default_rng(seed)
    cam = make_camera()
    n = n_frames
    dist = rng.uniform(8.0, 30.0, n)
    ang = rng.uniform(-0.35, 0.35, n)
    phys = np.stack(
        [dist * np.cos(ang), dist * np.sin(ang),
         rng.uniform(-1.0, -0.4, n)], axis=-1,
    ).astype(np.float32)
    size = np.broadcast_to(
        np.array([4.2, 1.6, 1.5], np.float32), (n, 3)
    ).copy()
    frames = render_camera_frames(phys, size, cam, rng)
    # the synthetic pinhole renders the full 1024-row frame and
    # render_camera_frames center-crops to 512 — mirror that v-shift in
    # the label projection (the reference's 430:942 crop plays this role)
    vcrop = (1024 - CAM.height) // 2
    labels = np.empty((n, CAM.height, CAM.width, 2), np.float32)
    for i in range(n):
        labels[i], _ = camera_label_footprint(
            phys[i], size[i], cam, (CAM.height, CAM.width), crop_top=vcrop
        )
    return frames, labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--timing_batches", type=int, default=4)
    args = ap.parse_args(argv)
    enable_compile_cache()
    require_gpu()

    frames, labels = build_camera_dataset(args.frames, seed=31)
    pos = labels[..., 1]
    loss_cfg = LossConfig(
        obj_to_bkg_ratio=float(pos.sum() / max((1.0 - pos).sum(), 1.0)),
        avg_obj_size=float(pos.sum() / max(len(pos), 1)),
    )
    mcfg = ModelConfig(vertical_stride=2, use_regression=False,
                       dtype="bfloat16")
    tx = optax.adam(args.lr)
    step = make_train_step(
        mcfg, tx,
        RangeViewSpec(),  # unused: batches carry precomputed images
        loss_cfg,
        TrainConfig(batch_size=args.batch, augment=False),
    )

    def fresh():
        v = init_fcn(mcfg, jax.random.PRNGKey(0), in_channels=1)
        return v, tx.init(v["params"])

    # --- timing: distinct fixed batches ---
    b = args.batch
    key = jax.random.PRNGKey(0)
    variables, opt_state = fresh()
    sets = []
    for i in range(args.timing_batches):
        rows = np.arange(i * b, (i + 1) * b) % len(frames)
        sets.append((
            {"images": jnp.asarray(frames[rows]),
             "labels": jnp.asarray(labels[rows])},
            jax.random.PRNGKey(i),
        ))
    t0 = time.time()
    dt = measure(lambda batch, k: step(variables, opt_state, batch, k),
                 sets, reps=3)
    ms_step = dt * 1e3
    print(f"train step {ms_step:.1f} ms at batch {b} "
          f"(timing incl. compile wall {time.time() - t0:.0f}s)",
          flush=True)

    # --- convergence: fresh model/optimizer, same data ---
    variables, opt_state = fresh()
    hist = []
    rng = np.random.default_rng(5)

    # dataset staged on device ONCE, batch gathered inside the jit, so a
    # step moves no batch host->device
    frames_d, labels_d = jnp.asarray(frames), jnp.asarray(labels)

    @jax.jit
    def conv_step(variables, opt_state, fr, lb, rows, key):
        return step(variables, opt_state,
                    {"images": fr[rows], "labels": lb[rows]}, key)

    for s in range(args.steps):
        rows = jnp.asarray(rng.choice(len(frames), b, replace=False))
        key, sub = jax.random.split(key)
        variables, opt_state, metrics = conv_step(
            variables, opt_state, frames_d, labels_d, rows, sub
        )
        if s % 20 == 0 or s == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            hist.append({"step": s, "loss": round(m["loss"], 4),
                         "precision": round(m["precision"], 3),
                         "recall": round(m["recall"], 3)})
            print(hist[-1], flush=True)

    out = {
        "metric": "camera-FCN train step, full 512x1368 reference shape",
        "ms_per_step": round(ms_step, 1),
        "batch": b,
        "frames_per_sec": round(b / dt, 1),
        "loss_first": hist[0]["loss"],
        "loss_last": hist[-1]["loss"],
        "recall_last": hist[-1]["recall"],
        "precision_last": hist[-1]["precision"],
        "steps": args.steps,
        "device": device_record(),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
