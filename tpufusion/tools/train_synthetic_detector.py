"""Train the synthetic-scene detector asset used by the benchmarks.

BASELINE configs 4/5 need a detector that genuinely detects on unseen
synthetic scenes (quick in-benchmark training overfits and over-fires).
This tool trains the FCN to convergence on an infinite stream of fresh
synthetic scenes and exports the best-by-eval weights to
`tpufusion/assets/synthetic_detector.npz` (loaded by
tpufusion.benchmarks; small enough to ship in-repo, like the reference
shipped `modules/lidar/data/lidar_model.h5`).

Run: python -m tpufusion.tools.train_synthetic_detector [--steps 3000]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import jax
import numpy as np
import optax

from tpufusion.config import DEFAULT, LossConfig, TrainConfig
from tpufusion.data.synthetic import (
    surface_fit_params,
    synthesize_beam_scan_batch,
    synthesize_points_batch,
)


def _synth(scenes, key, batch, n_points, max_yaw, vary_size=False,
           n_clutter=24):
    """(points, gt, valid) for any scene family (valid=None for the
    legacy uniform clutter). "beam-ellipse" renders oriented-ellipse
    vehicles (yaw observable); "beam-box" renders true l x w rectangles
    (L-shaped silhouettes — the family no decode fit parameterizes);
    "beam" keeps the rotationally symmetric circle surface."""
    if scenes.startswith("beam"):
        if scenes.endswith("ellipse"):
            surface = "ellipse"
        elif scenes.endswith("box"):
            surface = "box"
        else:
            surface = "circle"
        return synthesize_beam_scan_batch(
            key, batch, n_points, max_yaw=max_yaw, vary_size=vary_size,
            n_clutter=n_clutter, vehicle_surface=surface,
        )
    pts, gt = synthesize_points_batch(
        key, batch, n_points, max_yaw=max_yaw, vary_size=vary_size
    )
    return pts, gt, None
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.decode.decode import decode_batch
from tpufusion.models.fcn import apply_fcn, init_fcn
from tpufusion.models.io import save_state_npz
from tpufusion.train.stats import population_weights
from tpufusion.train.train_step import make_train_step

ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "synthetic_detector.npz",
)


@functools.partial(jax.jit, static_argnums=0)
def _eval_forward(model_cfg, variables, imgs):
    return apply_fcn(model_cfg, variables, imgs)[0]


def prepare_eval_batches(model_cfg, variables, spec, batch=32, n_points=32768,
                         seed=999, max_yaw=0.05, scenes="beam",
                         n_batches=1):
    """Synthesize + project + FCN-forward the fixed eval batches ONCE.

    The decode operating point (min_prob/min_bbox_area/center) touches
    none of this, so sweeps over operating points (tune_detector_asset)
    reuse the prepared batches instead of re-running the forward pass
    per point. The forward is jitted with the model config static and
    cached at module level: one compile serves every batch, family and
    resolution instead of an op-by-op eager forward."""
    prepared = []
    for b in range(n_batches):
        pts, gt, vmask = _synth(scenes, jax.random.PRNGKey(seed + b),
                                batch, n_points, max_yaw)
        imgs = range_view_project_batch(pts, spec, vmask)
        preds = _eval_forward(model_cfg, variables, imgs)
        prepared.append((preds, imgs, gt))
    return prepared


def evaluate(model_cfg, variables, spec, dcfg, batch=32, n_points=32768,
             seed=999, max_yaw=0.05, head="corner", scenes="beam",
             center=None, n_batches=1, prepared=None):
    """Held-out eval on `n_batches` FIXED seed batches (seed, seed+1, ...).

    Config 4's protocol is 128 frames; a single 32-frame batch made the
    best-asset selection noisy (the round-2 asset's 'best' landed on a
    step-600 fluke), so the trainer evals 128 frames too."""
    if prepared is None:
        prepared = prepare_eval_batches(
            model_cfg, variables, spec, batch, n_points, seed, max_yaw, scenes,
            n_batches,
        )
    pos, fds, trs, yws, szs = [], [], [], [], []
    for preds, imgs, gt in prepared:
        if head == "direct":
            from tpufusion.decode.decode import decode_batch_direct

            outd = decode_batch_direct(preds, imgs, spec, dcfg, 1, center)
            pos.append(np.asarray(outd["poses"])[:, 0])
            fds.append(np.asarray(outd["found"])[:, 0])
        else:
            out = decode_batch(preds, imgs, spec, dcfg)
            pos.append(np.asarray(out["pose"]))
            fds.append(np.asarray(out["found"]))
        trs.append(np.asarray(gt["center"]))
        yws.append(np.asarray(gt["yaw"]))
        szs.append(np.asarray(gt["size"]))
    po, fd = np.concatenate(pos), np.concatenate(fds)
    tr = np.concatenate(trs)
    gt = {"center": tr, "yaw": np.concatenate(yws),
          "size": np.concatenate(szs)}
    from tpufusion.eval.scoring import orbit_to_physical, score_poses

    truth = np.concatenate(
        [tr, np.asarray(gt["yaw"])[:, None], np.asarray(gt["size"])], axis=1
    )
    # decode + synthetic GT are orbit-convention; all reported errors are
    # physical-frame (see eval/scoring module docstring)
    po_phys, truth_phys = orbit_to_physical(po), orbit_to_physical(truth)
    d = np.linalg.norm(po_phys[:, :2] - truth_phys[:, :2], axis=1)
    det = float(fd.mean())
    within2 = float((d < 2.0)[fd].mean()) if fd.any() else 0.0
    err = float(d[fd].mean()) if fd.any() else float("nan")
    sc = score_poses(po_phys, truth_phys)
    # selection score: the round-3 targets are IoU
    # >= 0.4, recall@0.25 >= 0.7, xy <= 1.5 m — weight IoU up so the
    # box-quality axis drives best-asset selection, gated by detection
    return {"det": det, "xy_err": err, "within2m": within2,
            "mean_iou": float(sc["mean_iou"]),
            "recall_iou25": float(sc["recall@iou0.25"]),
            "yaw_err": float(sc.get("mean_yaw_err", float("nan"))),
            "score": det * (within2 + float(sc["recall@iou0.25"])
                            + 2.0 * float(sc["mean_iou"]))}


def resolve_yaw_frame(yaw_frame: str, scenes: str) -> str:
    """"auto" -> the codec the scene family's surface supports: "local"
    for oriented surfaces (ellipse/box — the silhouette's ray-relative
    orientation is locally observable), "global" for rotationally
    symmetric ones (the local target degenerates to unlearnable position
    information), "both" (dual-codec head, decode gates per cluster) for
    mixed-family training."""
    if yaw_frame != "auto":
        return yaw_frame
    if scenes == "mixed":
        return "both"
    if scenes.endswith("ellipse") or scenes.endswith("box"):
        return "local"
    return "global"


def deployment_decode(base, min_prob: float, min_bbox_area: float,
                      scenes: str = "beam"):
    """The asset's decode operating point. The reference's constants
    (min_prob 0.5, min_bbox_area 100, predict.py:28-31) were tuned to its
    real Didi bags, where the obstacle footprint is large; synthetic
    scenes place vehicles at 8-30 m where exact footprints can be ~36 px
    — below the reference's area gate. A detector asset therefore ships
    WITH the thresholds it was validated at (stored in the asset json and
    applied by tpufusion.benchmarks when loading the asset). The "fit"
    center mode's boundary model follows the scene family's vehicle
    surface (DecodeConfig.fit_boundary; data/synthetic.py::
    surface_fit_params is the single source of truth)."""
    boundary, scale = surface_fit_params(scenes)
    return dataclasses.replace(
        base, min_prob=min_prob, min_bbox_area=min_bbox_area,
        fit_boundary=boundary, fit_surface_scale=scale,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n_points", type=int, default=32768)
    ap.add_argument("--eval_every", type=int, default=200)
    # 4 x batch-32 fixed seed batches = 128 held-out frames, config 4's
    # protocol size; one batch made best-asset selection fluke-prone
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=ASSET)
    # W1 background-weight boost: at ratio*1 the class-balanced loss makes
    # boundary over-painting nearly free, so the positive region dilates
    # ~4-5x and the decoded centroid drifts (measured: precision 0.21
    # even when overfitting one batch; 0.59 with boost 20 = a 1-px
    # boundary ring, the achievable limit for ~37 px footprints).
    ap.add_argument("--w1_boost", type=float, default=20.0)
    ap.add_argument("--eval_min_prob", type=float, default=0.9)
    ap.add_argument("--eval_min_bbox_area", type=float, default=20.0)
    # yaw ~ 0: the reference's orbit-origin corner convention makes yaw
    # unobservable for axis-aligned synthetic clusters (see
    # data/synthetic.synthesize_points_batch); train/eval in the regime
    # where the task is well-posed, like the reference's real data was
    ap.add_argument("--max_yaw", type=float, default=0.05)
    # regression weight: the reference's 0.01 was tuned alongside its
    # uint8 label cast that destroyed the regression targets
    # (loader.py:251) — its reg head never really trained. With intact
    # float targets the head needs real gradient share to learn box
    # size/yaw (IoU stays ~0 otherwise: the corner vote averages
    # near-zero corners into degenerate boxes)
    ap.add_argument("--weight_bb", type=float, default=1.0)
    # linear: a relu output cannot represent the signed corner targets
    # (see ModelConfig.reg_output_activation) — with it the vote's boxes
    # degenerate to ~0.1 m and IoU pins at 0
    ap.add_argument("--reg_activation", default="linear")
    ap.add_argument("--reg_clip", type=float, default=15.0)
    ap.add_argument("--width_mult", type=int, default=2)
    # "direct" is the framework's working pose-regression head (the
    # reference's corner field does not converge — NOTES.md); "corner"
    # trains the reference-faithful voting pipeline
    ap.add_argument("--head", default="direct")
    # varied sizes force the direct head to MEASURE the cluster; the
    # held-out eval keeps the challenge's fixed vehicle
    ap.add_argument("--vary_size", action=argparse.BooleanOptionalAction,
                    default=True)
    # beam = ray-cast Velodyne-like scans (discrete beams, occlusion,
    # dropout) — the benchmark distribution since round 3; uniform = the
    # legacy dense-clutter scenes (kept for comparisons)
    ap.add_argument("--scenes",
                    choices=("beam", "beam-ellipse", "beam-box", "mixed",
                             "uniform"),
                    default="beam")
    # direct head only: multiplier on the sin/cos yaw channels inside the
    # joint reg-channel L2 (LossConfig.reg_channel_weights) — the <=0.43
    # magnitude yaw targets are gradient-starved next to meter-scale dc
    ap.add_argument("--yaw_weight", type=float, default=1.0)
    # sin/cos yaw codec: "auto" = local for oriented-ellipse scenes,
    # global for circle/uniform. The local codec's target is the arc's
    # ray-relative orientation — on a rotationally SYMMETRIC surface the
    # arc looks identical at every azimuth, so that target degenerates
    # to pure position information a translation-equivariant conv trunk
    # cannot represent (measured: yaw_err 0.73 rad ~ noise on circle
    # scenes with the local codec, 0.025 with global; the ellipse case
    # is the opposite — NOTES.md round 3).
    ap.add_argument("--yaw_frame",
                    choices=("auto", "local", "global", "both"),
                    default="auto")
    ap.add_argument("--init_from", default=None,
                    help="warm-start weights from an existing asset npz "
                         "(fine-tuning, e.g. for robustness passes)")
    ap.add_argument("--clutter_mix", default="24",
                    help="comma list of per-step clutter counts to cycle "
                         "through (beam scenes); e.g. 24,48,96 trains for "
                         "the envelope's heavy-clutter conditions")
    ap.add_argument("--points_mix", default="",
                    help="comma list of per-step sweep resolutions (points "
                         "per revolution) to cycle through, e.g. "
                         "16384,32768,65536 — trains one asset across "
                         "sensor resolutions (the envelope's sparse-sweep "
                         "failure is a per-resolution operating-point "
                         "mismatch; a resolution-mixed asset flattens it). "
                         "Empty = train at --n_points only. Each distinct "
                         "count compiles its own train-step variant "
                         "(static shapes), so keep the list short. Held-"
                         "out eval stays at --n_points.")
    args = ap.parse_args(argv)

    cfg = DEFAULT
    spec = cfg.range_view
    yaw_frame = resolve_yaw_frame(args.yaw_frame, args.scenes)
    # mixed-family training cycles the scene family per step; the circle
    # family keeps the near-zero yaw regime where its pose task is
    # well-posed (orbit convention — NOTES.md round-2 session 3)
    families = (
        ["beam", "beam-ellipse", "beam-box"]
        if args.scenes == "mixed" else [args.scenes]
    )

    def fam_max_yaw(fam):
        return min(args.max_yaw, 0.05) if fam == "beam" else args.max_yaw

    model_cfg = dataclasses.replace(
        cfg.model, dtype="bfloat16",
        reg_output_activation=args.reg_activation,
        width_multiplier=args.width_mult, head=args.head,
        yaw_codec="dual" if yaw_frame == "both" else "single",
    )
    variables = init_fcn(model_cfg, jax.random.PRNGKey(0), in_channels=3)
    if args.init_from:
        from tpufusion.models.io import load_state_npz

        variables = load_state_npz(args.init_from, variables)
        print(f"warm-started from {args.init_from}", flush=True)
    warmup = min(50, max(1, args.steps // 10))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup, args.steps, args.lr * 0.03
    )
    tx = optax.adam(sched)
    opt_state = tx.init(variables["params"])

    pts, gt, _ = _synth(families[0], jax.random.PRNGKey(42), args.batch,
                        args.n_points, fam_max_yaw(families[0]))
    stats = population_weights(
        np.asarray(gt["center"]), np.asarray(gt["size"]),
        np.asarray(gt["yaw"]), spec,
    )
    n_yaw_ch = 4 if yaw_frame == "both" else 2
    step = make_train_step(
        model_cfg, tx, spec,
        LossConfig(
            obj_to_bkg_ratio=stats["positive_to_negative_ratio"]
            * args.w1_boost,
            avg_obj_size=stats["average_area"],
            weight_bb=args.weight_bb,
            reg_target_norm_clip=args.reg_clip,
            reg_channel_weights=(
                (1.0,) * 6 + (args.yaw_weight,) * n_yaw_ch
                if args.head == "direct" and args.yaw_weight != 1.0
                else None
            ),
        ),
        TrainConfig(batch_size=args.batch,
                    augment=args.head != "direct"),
        yaw_frame=yaw_frame,
    )
    dcfg = dataclasses.replace(
        deployment_decode(
            cfg.decode, args.eval_min_prob, args.eval_min_bbox_area,
            scenes=args.scenes,
        ),
        # decode-side name of the codec: the dual ("both") head decodes
        # through the per-cluster magnitude gate ("auto")
        direct_yaw_frame="auto" if yaw_frame == "both" else yaw_frame,
    )

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    best = {"score": -1.0}
    key = jax.random.PRNGKey(7)
    t0 = time.time()
    clutter_mix = [int(c) for c in args.clutter_mix.split(",")]
    points_mix = (
        [int(c) for c in args.points_mix.split(",")]
        if args.points_mix else [args.n_points]
    )
    for s in range(1, args.steps + 1):
        fam = families[s % len(families)]
        p, g, vmask = _synth(
            fam, jax.random.PRNGKey(100_000 + s), args.batch,
            points_mix[s % len(points_mix)], fam_max_yaw(fam),
            vary_size=args.vary_size,
            n_clutter=clutter_mix[s % len(clutter_mix)],
        )
        batch = {"points": p, "center": g["center"], "size": g["size"],
                 "yaw": g["yaw"]}
        if vmask is not None:
            batch["valid"] = vmask
        key, sub = jax.random.split(key)
        variables, opt_state, metrics = step(
            variables, opt_state, batch, sub
        )
        loss = metrics["loss"]
        if s % args.eval_every == 0 or s == args.steps:
            # which center estimator wins flips as the head trains (the
            # averaged head center starts biased, then overtakes the
            # geometric push once l/w/yaw converge) — evaluate all and
            # ship the winning mode in the asset json
            modes = (
                ("fit", "consensus", "silhouette", "surface", "geometric",
                 "head", "backproject")
                if args.head == "direct" else (None,)
            )
            # mixed-family assets are selected by the MEAN score across
            # families (the whole point is one asset for both); per-mode
            # metrics shown are the cross-family means too
            fam_prepared = {
                f: prepare_eval_batches(
                    model_cfg, variables, spec, args.batch, args.n_points,
                    max_yaw=fam_max_yaw(f), scenes=f,
                    n_batches=args.eval_batches,
                )
                for f in families
            }

            def _eval_mode(m):
                per_fam = [
                    evaluate(model_cfg, variables, spec, dcfg,
                             args.batch, args.n_points,
                             max_yaw=fam_max_yaw(f), head=args.head,
                             scenes=f, center=m,
                             n_batches=args.eval_batches,
                             prepared=fam_prepared[f])
                    for f in families
                ]
                if len(per_fam) == 1:
                    return per_fam[0]
                mean = {
                    k: float(np.mean([e[k] for e in per_fam]))
                    for k in per_fam[0]
                }
                mean["per_family"] = {
                    f: {"mean_iou": e["mean_iou"], "det": e["det"],
                        "recall_iou25": e["recall_iou25"],
                        "xy_err": e["xy_err"], "yaw_err": e["yaw_err"]}
                    for f, e in zip(families, per_fam)
                }
                return mean

            evs = {m: _eval_mode(m) for m in modes}
            mode = max(evs, key=lambda m: evs[m]["score"])
            ev = evs[mode]
            print(
                f"step {s}: loss {float(loss):.3f} det {ev['det']:.2f} "
                f"xy_err {ev['xy_err']:.2f} within2m {ev['within2m']:.2f} "
                f"iou {ev['mean_iou']:.2f} r25 {ev['recall_iou25']:.2f} "
                f"[{mode}"
                + "".join(f" {m}:{evs[m]['score']:.2f}" for m in evs)
                + f"] ({time.time() - t0:.0f}s)", flush=True,
            )
            if ev["score"] > best["score"]:
                best = {**ev, "step": s, "center": mode}
                save_state_npz(args.out, variables)
                _write_asset_json(args, best)
    _write_asset_json(args, best)
    print("best:", best, "->", args.out)


def _write_asset_json(args, best):
    decode = {"min_prob": args.eval_min_prob,
              "min_bbox_area": args.eval_min_bbox_area}
    if "center" in best and best["center"]:
        decode["direct_center"] = best["center"]
    yaw_frame = resolve_yaw_frame(args.yaw_frame, args.scenes)
    if args.head == "direct":
        # pin the yaw-channel frame the asset was trained with (resolved
        # per scene family — see resolve_yaw_frame; older assets are
        # global). A dual head ("both") is decoded through the magnitude
        # gate ("auto").
        decode["direct_yaw_frame"] = (
            "auto" if yaw_frame == "both" else yaw_frame
        )
        # pin the "fit" mode's boundary model to the scene family the
        # asset was validated on (used when direct_center == "fit", and
        # by anyone re-tuning the operating point later)
        boundary, scale = surface_fit_params(args.scenes)
        decode["fit_boundary"] = boundary
        decode["fit_surface_scale"] = scale
    model_json = {"reg_output_activation": args.reg_activation,
                  "width_multiplier": args.width_mult,
                  "head": args.head}
    if yaw_frame == "both":
        model_json["yaw_codec"] = "dual"
    with open(args.out + ".json", "w") as f:
        json.dump({"best": best, "steps": args.steps,
                   "scenes": args.scenes,
                   "max_yaw": args.max_yaw,
                   **({"points_mix": args.points_mix}
                      if args.points_mix else {}),
                   "batch": args.batch, "n_points": args.n_points,
                   "w1_boost": args.w1_boost,
                   "weight_bb": args.weight_bb,
                   "decode": decode,
                   "model": model_json},
                  f)


if __name__ == "__main__":
    main()
