"""Train + evaluate the cam+lidar+radar FusionNet on aligned synthetic data.

The reference's fusion net (`modules/lidar/train/train_fcn.py:258-315`)
was drift-broken and shipped no weights, so it has NO accuracy record.
This tool answers the question the subsystem exists for: does fusing
camera + radar with lidar beat lidar alone on centroid/rz error?

Protocol
  * beam-structured lidar scans with the vehicle spawned inside the
    camera FOV wedge; a synthetic pinhole camera renders the scene
    (bright vehicle box + structured noise) at the FULL reference scale
    (512x1368 crop, globals.py:19-21); radar reports (range, angle) of
    the physical cluster with sensor noise. Timestamp streams are
    deliberately offset and joined with
    data/align.align_camera_lidar_radar, like the real triple-modality
    path (train_fcn.py:178-255).
  * two nets with identical architecture/init/data order train on the
    same frames: "fused" sees all three modalities; "lidar-only" sees
    zeroed camera + zeroed radar (the controlled ablation).
  * both evaluate on held-out scenes; the fused asset + measured table
    ship to tpufusion/assets/fusion_net.npz(.json) and benchmarks
    config 3 loads the asset so it times real trained weights.

Run: python -m tpufusion.tools.train_fusion_synthetic [--epochs 25]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.config import CameraConfig, ModelConfig, RangeViewSpec
from tpufusion.data.synthetic import synthesize_beam_scan_batch
from tpufusion.geometry.boxes import _CORNER_SIGNS
from tpufusion.geometry.camera import CameraModel, synthetic_camera
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fusion import FusionConfig, apply_fusion, init_fusion
from tpufusion.models.io import save_state_npz

ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "fusion_net.npz",
)

# full reference camera geometry (512x1368 crop, globals.py:19-21);
# feature pooling keeps the dense branches asset-sized
CAM = CameraConfig(width=1368, height=512, crop_top=0)
LIDAR_POOL = (2, 8)
CAM_POOL = (8, 8)
# bump when synthesize_beam_scan_batch / render_camera_frames semantics
# change: it invalidates cached datasets
_DATASET_VERSION = "v1"


def make_camera() -> CameraModel:
    """Synthetic forward-facing pinhole at the reference camera scale."""
    return synthetic_camera(CAM.width, 1024, 1400.0)


def render_camera_frames(
    centers_phys: np.ndarray,  # (F, 3) physical cluster centers
    sizes: np.ndarray,  # (F, 3)
    cam: CameraModel,
    rng: np.random.Generator,
) -> np.ndarray:
    """(F, Hc, Wc, 1) grayscale frames: smooth noise background + a bright
    vehicle box whose position/scale encode direction and distance (the
    signal a real camera contributes to late fusion)."""
    f = len(centers_phys)
    hc, wc = CAM.height, CAM.width
    out = np.empty((f, hc, wc, 1), np.float32)
    vcrop = (1024 - hc) // 2  # center crop rows like the reference's 430:942
    for i in range(f):
        img = rng.uniform(0.05, 0.25, (hc, wc)).astype(np.float32)
        # cheap smoothing: two half-resolution averages
        img = 0.5 * img + 0.5 * img[::-1, ::-1]
        c, s = centers_phys[i], sizes[i]
        corners = c + _CORNER_SIGNS * s / 2.0
        uv = cam.project_lidar_to_pixels(corners)
        if np.all(corners @ [1, 0, 0] > 0.5):  # in front of the camera
            u0, v0 = uv.min(axis=0)
            u1, v1 = uv.max(axis=0)
            v0, v1 = v0 - vcrop, v1 - vcrop
            u0, u1 = np.clip([u0, u1], 0, wc - 1).astype(int)
            v0, v1 = np.clip([v0, v1], 0, hc - 1).astype(int)
            if u1 > u0 and v1 > v0:
                shade = rng.uniform(0.7, 1.0)
                img[v0:v1, u0:u1] = shade
                # windows: darker band in the upper third
                vb = v0 + max(1, (v1 - v0) // 4)
                img[v0:vb, u0:u1] = shade * 0.5
        out[i, :, :, 0] = img
    return out


def build_dataset(
    n_frames: int, seed: int, spec: RangeViewSpec, cache_dir: str | None = None
):
    """Aligned (cam, lidar, radar, targets) arrays for n_frames scenes.

    Building 512 frames costs ~8 min (beam-scan synthesis + projection +
    camera render); cache_dir memoizes the result keyed on (n_frames,
    seed) so training iterations don't repay it.
    """
    if cache_dir:
        # key every input that shapes the data: frames, seed, projection
        # geometry, and a version bumped when the generators change — a
        # stale cache must never silently stand in for a different
        # protocol
        import hashlib

        spec_key = hashlib.sha1(
            (repr(spec) + repr(CAM) + _DATASET_VERSION).encode()
        ).hexdigest()[:10]
        path = os.path.join(
            cache_dir, f"fusion_ds_{n_frames}_{seed}_{spec_key}.npz"
        )
        if os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        data = build_dataset(n_frames, seed, spec, cache_dir=None)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, **data)
        return data
    from tpufusion.train.fusion_trainer import build_fusion_batches

    cam = make_camera()
    rng = np.random.default_rng(seed)
    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(seed), n_frames, 32768,
        angle_range=(-0.42, 0.42),  # the camera FOV wedge (~24 deg half)
    )
    imgs = np.asarray(range_view_project_batch(pts, spec, valid))
    center = np.asarray(gt["center"])
    yaw = np.asarray(gt["yaw"])
    size = np.asarray(gt["size"])
    cy, sy = np.cos(yaw), np.sin(yaw)
    phys = np.stack(
        [cy * center[:, 0] - sy * center[:, 1],
         sy * center[:, 0] + cy * center[:, 1],
         center[:, 2]], axis=-1,
    )
    cam_frames = render_camera_frames(phys, size, cam, rng)

    # radar: sensor-noised polar observation of the physical cluster
    rr = np.linalg.norm(phys[:, :2], axis=1) + rng.normal(0, 0.25, n_frames)
    ra = np.arctan2(phys[:, 1], phys[:, 0]) + rng.normal(0, 0.008, n_frames)
    radar = np.stack([rr, ra], axis=-1).astype(np.float32)

    # deliberately offset timestamp streams through the real aligner
    # (scenes are independent, so every stream runs at the frame rate;
    # the offsets still exercise the nearest-timestamp joins)
    t0 = 1_490_000_000_000
    lidar_ts = t0 + np.arange(n_frames) * 100_000  # 10 Hz (us)
    cam_ts = lidar_ts + 7_000
    radar_ts = lidar_ts + 3_000
    poses = np.concatenate([center, yaw[:, None]], axis=1).astype(np.float32)
    data = build_fusion_batches(
        cam_frames, cam_ts, poses, imgs, lidar_ts, radar, radar_ts
    )
    return data


def evaluate(fcfg, variables, data, rows) -> dict:
    @jax.jit
    def fwd(variables, cam, lidar, radar):
        out, _ = apply_fusion(fcfg, variables, cam, lidar, radar)
        return out

    c, r = fwd(
        variables,
        jnp.asarray(data["cam"][rows]),
        jnp.asarray(data["lidar"][rows]),
        jnp.asarray(data["radar"][rows]),
    )
    c, r = np.asarray(c), np.asarray(r)
    terr = np.linalg.norm(c[:, :2] - data["centroid"][rows, :2], axis=1)
    return {
        "xy_err": float(terr.mean()),
        "xy_err_p90": float(np.percentile(terr, 90)),
        "z_err": float(np.abs(c[:, 2] - data["centroid"][rows, 2]).mean()),
        "rz_err": float(np.abs(r[:, 0] - data["rz"][rows, 0]).mean()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_frames", type=int, default=512)
    ap.add_argument("--eval_frames", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=ASSET)
    ap.add_argument("--cache_dir", default="/tmp/fusion_ds_cache")
    ap.add_argument("--variants", default="fused,lidar_only",
                    help="comma list; rerun one variant without repaying "
                         "the other (results merge into the asset json)")
    args = ap.parse_args(argv)

    spec = RangeViewSpec()
    t0 = time.time()
    train = build_dataset(
        args.train_frames, seed=11, spec=spec, cache_dir=args.cache_dir
    )
    held = build_dataset(
        args.eval_frames, seed=999, spec=spec, cache_dir=args.cache_dir
    )
    held_rows = np.arange(len(held["cam"]))
    print(f"datasets built ({time.time() - t0:.0f}s)", flush=True)

    fcfg = FusionConfig(
        lidar_model=ModelConfig(dtype="bfloat16"),
        camera_model=ModelConfig(
            vertical_stride=2, use_regression=False, dtype="bfloat16"
        ),
        camera=CAM,
        lidar_pool=LIDAR_POOL,
        cam_pool=CAM_POOL,
    )

    from tpufusion.train.fusion_trainer import train_fusion

    results = {}
    if os.path.exists(args.out + ".json"):
        # merge over a previous run's results (e.g. rerunning one variant)
        try:
            with open(args.out + ".json") as f:
                results = json.load(f).get("results", {})
        except (OSError, ValueError):
            results = {}
    for variant in args.variants.split(","):
        data = dict(train)
        heldv = dict(held)
        if variant == "lidar_only":
            # controlled ablation: identical net/data/order, camera and
            # radar inputs zeroed
            data["cam"] = np.zeros_like(data["cam"])
            data["radar"] = np.zeros_like(data["radar"])
            heldv["cam"] = np.zeros_like(heldv["cam"])
            heldv["radar"] = np.zeros_like(heldv["radar"])
        variables, losses = train_fusion(
            fcfg, init_fusion(fcfg, jax.random.PRNGKey(3)), data,
            epochs=args.epochs, batch_size=args.batch, lr=args.lr, seed=5,
        )
        ev = evaluate(fcfg, variables, heldv, held_rows)
        ev["final_loss"] = losses[-1]
        results[variant] = ev
        print(f"{variant}: {ev}", flush=True)
        if variant == "fused":
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            save_state_npz(args.out, variables, dtype=np.float16)

    # context: the raw radar feature error is the fused floor for range
    rr = held["radar"][:, 0]
    gtr = np.linalg.norm(held["centroid"][:, :2], axis=1)
    results["radar_range_noise"] = float(np.abs(rr - gtr).mean())

    with open(args.out + ".json", "w") as f:
        json.dump(
            {
                "results": results,
                "train_frames": args.train_frames,
                "eval_frames": args.eval_frames,
                "epochs": args.epochs,
                "camera": {"width": CAM.width, "height": CAM.height,
                           "scale": "full reference 512x1368"},
                "lidar_pool": list(LIDAR_POOL),
                "cam_pool": list(CAM_POOL),
            },
            f, indent=1,
        )
    print("results:", json.dumps(results, indent=1))
    print("asset ->", args.out)


if __name__ == "__main__":
    main()
