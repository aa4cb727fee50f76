"""Operating-envelope sweep for the shipped detector asset.

The config-4 protocol measures one operating condition (the asset's
training distribution). This tool measures how the shipped asset
degrades AWAY from it — scene knobs the reference never characterized
its model against (its constants were tuned to its own bags,
`modules/lidar/train/predict.py:28-31`):

  * clutter density x2 / x4 (the config-5 "asset wasn't trained against
    128k-pt density" caveat, quantified)
  * beam dropout x2.5
  * sweep resolution (16k / 65k points per revolution)
  * yaw range (the orbit-origin convention makes large yaw partially
    unobservable — NOTES.md round-2 session 3; quantified, not hidden)
  * varied vehicle sizes
  * per-distance-quartile breakdown under the standard protocol

Run: python -m tpufusion.tools.detector_envelope
Prints one row per condition + a JSON tail.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import numpy as np

from tpufusion.config import DEFAULT
from tpufusion.data.synthetic import synthesize_beam_scan_batch
from tpufusion.decode.decode import decode_batch_direct
from tpufusion.eval.scoring import score_poses
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fcn import apply_fcn
from tpufusion.models.io import (
    DETECTOR_ASSET,
    decode_for_resolution,
    load_detector_asset,
)


def run_condition(model_cfg, variables, dcfg, n_batches=4, batch=32,
                  seed=999, **scene_kw) -> tuple[dict, np.ndarray, dict]:
    """128 fixed frames under one scene condition -> scores + per-frame
    (distance, xy_err, found, iou-able pose/truth rows)."""
    if model_cfg.head != "direct":
        raise ValueError(
            "detector_envelope decodes through the direct-pose head; "
            f"the asset reports head={model_cfg.head!r}"
        )
    spec = DEFAULT.range_view
    center_mode = dcfg.direct_center
    preds_all, truth_all = [], []
    for b in range(n_batches):
        pts, gt, valid = synthesize_beam_scan_batch(
            jax.random.PRNGKey(seed + b), batch, **scene_kw
        )
        imgs = range_view_project_batch(pts, spec, valid)
        model_out, _ = apply_fcn(model_cfg, variables, imgs)
        out = decode_batch_direct(
            model_out, imgs, spec, dcfg, 1, center_mode
        )
        preds_all.append(np.asarray(out["poses"])[:, 0])
        truth_all.append(np.concatenate(
            [np.asarray(gt["center"]),
             np.asarray(gt["yaw"])[:, None],
             np.asarray(gt["size"])], axis=1,
        ))
    preds = np.concatenate(preds_all)
    truth = np.concatenate(truth_all)
    sc = score_poses(preds, truth, pose_frame="orbit")
    return sc, preds, {"truth": truth}


def base_condition_from_meta(meta: dict) -> dict:
    """Scene kwargs of an asset's training distribution, from its json
    metadata (written by tools/train_synthetic_detector). Missing fields
    fall back to the flagship's historical base (32k points, max_yaw
    0.05, circle surface) so pre-meta assets keep the old anchor."""
    base_kw = dict(
        n_points=int(meta.get("n_points", 32768)),
        max_yaw=float(meta.get("max_yaw", 0.05)),
    )
    scenes = str(meta.get("scenes", "beam"))
    if scenes.endswith("ellipse"):
        base_kw["vehicle_surface"] = "ellipse"
    elif scenes.endswith("box"):
        base_kw["vehicle_surface"] = "box"
    elif scenes == "mixed":
        # mixed training anchors on the circle family, whose per-family
        # yaw cap is min(max_yaw, 0.05) (train_synthetic_detector
        # fam_max_yaw: yaw is unobservable on a rotationally symmetric
        # surface) — the envelope's base row must mirror that, and the
        # explicit ellipse/box rows below cover the oriented families
        base_kw["max_yaw"] = min(base_kw["max_yaw"], 0.05)
    return base_kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--asset", default=None,
                    help="explicit detector asset npz (default: the "
                         "shipped flagship)")
    args = ap.parse_args(argv)

    # the "trained distribution" anchor comes from the asset's own
    # metadata (scenes / max_yaw / n_points recorded at training time by
    # tools/train_synthetic_detector), so the relative conditions below
    # measure degradation away from THIS asset's training distribution
    cfg, variables, meta = load_detector_asset(args.asset or DETECTOR_ASSET)
    dcfg = cfg.decode
    base_kw = base_condition_from_meta(meta)

    conditions = [
        ("trained distribution", dict(**base_kw)),
        ("clutter x2", dict(**base_kw, n_clutter=48)),
        ("clutter x4", dict(**base_kw, n_clutter=96)),
        ("dropout 0.3", dict(**base_kw, dropout=0.3)),
        ("sparse sweep (16k pts)", dict(**{**base_kw, "n_points": 16384})),
        ("dense sweep (65k pts)", dict(**{**base_kw, "n_points": 65536})),
        ("varied sizes", dict(**base_kw, vary_size=True)),
        ("yaw +-0.2", dict(**{**base_kw, "max_yaw": 0.2})),
        ("yaw +-0.4", dict(**{**base_kw, "max_yaw": 0.4})),
        # oriented-ellipse vehicle surface: the physical orientation the
        # reference's orbit-origin convention implies, where yaw IS
        # observable from geometry (the circle rows above measure the
        # symmetric-surface regime where no detector can recover yaw)
        ("ellipse yaw 0", dict(**{**base_kw, "max_yaw": 0.0,
                                  "vehicle_surface": "ellipse"})),
        ("ellipse yaw +-0.2", dict(**{**base_kw, "max_yaw": 0.2,
                                      "vehicle_surface": "ellipse"})),
        ("ellipse yaw +-0.4", dict(**{**base_kw, "max_yaw": 0.4,
                                      "vehicle_surface": "ellipse"})),
        # box (true l x w rectangle) surface: the L-shaped silhouette of
        # real vehicle scans and the one family no fit parameterizes
        ("box yaw 0", dict(**{**base_kw, "max_yaw": 0.0,
                              "vehicle_surface": "box"})),
        ("box yaw +-0.4", dict(**{**base_kw, "max_yaw": 0.4,
                                  "vehicle_surface": "box"})),
    ]
    rows = {}
    base_preds = base_truth = None
    for name, kw in conditions:
        # per-resolution operating point: the asset's json may carry a
        # decode_per_resolution calibration table (the sparse-sweep det
        # drop is a threshold mismatch, not a feature failure)
        cond_dcfg = decode_for_resolution(
            dcfg, meta, kw.get("n_points", base_kw["n_points"])
        )
        sc, preds, extra = run_condition(
            cfg.model, variables, cond_dcfg,
            n_batches=args.eval_batches, batch=args.batch, **kw,
        )
        if name == "trained distribution":
            base_preds, base_truth = preds, extra["truth"]
        rows[name] = {
            "det": sc["detection_rate"],
            "iou": round(sc["mean_iou"], 3),
            "r25": round(sc["recall@iou0.25"], 3),
            "xy": round(sc["mean_xy_err"], 3),
        }
        print(f"{name:<26} det {rows[name]['det']:.2f} "
              f"iou {rows[name]['iou']:.3f} r25 {rows[name]['r25']:.2f} "
              f"xy {rows[name]['xy']:.2f}", flush=True)

    # distance-quartile breakdown on the trained distribution
    dist = np.linalg.norm(base_truth[:, :2], axis=1)
    qs = np.quantile(dist, [0, 0.25, 0.5, 0.75, 1.0])
    for lo, hi in zip(qs[:-1], qs[1:]):
        sel = (dist >= lo) & (dist <= hi)
        sc = score_poses(base_preds[sel], base_truth[sel],
                         pose_frame="orbit")
        key = f"range {lo:.0f}-{hi:.0f} m"
        rows[key] = {
            "det": sc["detection_rate"],
            "iou": round(sc["mean_iou"], 3),
            "r25": round(sc["recall@iou0.25"], 3),
            "xy": round(sc["mean_xy_err"], 3),
        }
        print(f"{key:<26} det {rows[key]['det']:.2f} "
              f"iou {rows[key]['iou']:.3f} r25 {rows[key]['r25']:.2f} "
              f"xy {rows[key]['xy']:.2f}", flush=True)

    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
