"""tpufusion command-line interface.

One typed entry point replacing the reference's per-script argparse CLIs
(train.py, predict.py, extract_rosbag.py, generate_tracklet_predictions.py,
rosdiff.py, analyze.py, the calibration standalone). Run:

    python -m tpufusion.cli <command> --help
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _cmd_train(args):
    from tpufusion.config import DEFAULT, LossConfig, ModelConfig
    from tpufusion.data.etl import load_camera_extracted, load_extracted
    from tpufusion.data.pipeline import BatchPipeline
    from tpufusion.data.registry import load_pose_csv, read_registry
    from tpufusion.train.stats import population_weights
    from tpufusion.train.trainer import Trainer

    import dataclasses
    import os

    camera = None
    if args.source == "camera":
        # camera-source training needs the camera model to rasterize
        # footprint labels (reference train.py:109-122 + encoder.py:270-327)
        from tpufusion.geometry.camera import CameraModel

        if not args.camera_yaml:
            p_err = "--camera_yaml is required with --source camera"
            raise SystemExit(p_err)
        camera = CameraModel().load_camera_calibration(
            args.camera_yaml, args.extrinsic_yaml
        )

    def load_dirset(ds):
        data = load_extracted(ds.dir)
        poses = load_pose_csv(
            os.path.join(ds.dir, "obs_poses_interp_transform.csv")
        )
        by_ts = {p["timestamp"]: p for p in poses}
        rows = [by_ts[int(t)] for t in data["timestamps"] if int(t) in by_ts]
        keep = [i for i, t in enumerate(data["timestamps"]) if int(t) in by_ts]
        size = np.asarray(ds.obstacle_size, np.float32)
        return {
            "images": data["images"][keep],
            "center": np.asarray(
                [[r["tx"], r["ty"], r["tz"]] for r in rows], np.float32
            ),
            "yaw": np.asarray([r["rz"] for r in rows], np.float32),
            "size": np.tile(size, (len(rows), 1)),
        }

    def load_camera_dirset(ds):
        from tpufusion.geometry.camera import camera_label_footprint

        data = load_camera_extracted(ds.dir)
        poses = load_pose_csv(os.path.join(ds.dir, "obs_poses_camera.csv"))
        by_ts = {p["timestamp"]: p for p in poses}
        rows = [by_ts[int(t)] for t in data["timestamps"] if int(t) in by_ts]
        keep = [i for i, t in enumerate(data["timestamps"]) if int(t) in by_ts]
        imgs = data["images"][keep].astype(np.float32) / 255.0
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        hw = imgs.shape[1:3]
        size = np.asarray(ds.obstacle_size, np.float32)
        labels = np.zeros((len(rows), *hw, 2), np.float32)
        for i, r in enumerate(rows):
            center = np.asarray([r["tx"], r["ty"], r["tz"]])
            labels[i], _ = camera_label_footprint(
                center, size, camera, hw, crop_top=args.crop_top
            )
        return {"images": imgs, "labels": labels}

    loader = load_camera_dirset if args.source == "camera" else load_dirset
    parts = [loader(ds) for ds in read_registry(args.train_file, args.dir_prefix)]
    train_data = {
        k: np.concatenate([p[k] for p in parts]) for k in parts[0]
    }
    if args.source == "camera":
        # population stats from the rasterized footprints (pretrain.py:8-32)
        pos = train_data["labels"][..., 1]
        stats = {
            "positive_to_negative_ratio": float(
                pos.sum() / max((1.0 - pos).sum(), 1.0)
            ),
            "average_area": float(pos.sum() / max(len(pos), 1)),
        }
    else:
        stats = population_weights(
            train_data["center"], train_data["size"], train_data["yaw"]
        )
    print("population stats:", stats, file=sys.stderr)
    cfg = DEFAULT.replace(
        loss=LossConfig(
            obj_to_bkg_ratio=stats["positive_to_negative_ratio"]
            * DEFAULT.train.k_negative_sample_ratio_weight,
            avg_obj_size=stats["average_area"],
        ),
        train=dataclasses.replace(
            DEFAULT.train,
            batch_size=args.batch_size,
            epochs=args.epochs,
            learning_rate=args.lr,
            lr_schedule=args.lr_schedule,
            lr_decay_steps=args.lr_decay_steps,
        ),
    )
    in_channels = 3
    if args.source == "camera":
        # camera labels are precomputed classification footprints; the
        # regression head (either family) is off, so --head is ignored
        cfg = cfg.replace(
            model=ModelConfig(vertical_stride=2, use_regression=False)
        )
        in_channels = 1
    elif args.head != "corner":
        cfg = cfg.replace(
            model=dataclasses.replace(
                cfg.model, head=args.head,
                reg_output_activation="linear",
            ),
            train=dataclasses.replace(cfg.train, augment=False),
        )
    trainer = Trainer(cfg, outdir=args.outdir, in_channels=in_channels)
    if args.resume:
        trainer.resume()
    val_pipe = None
    if args.val_file:
        vparts = [
            loader(ds) for ds in read_registry(args.val_file, args.dir_prefix)
        ]
        val_data = {k: np.concatenate([p[k] for p in vparts]) for k in vparts[0]}
        val_pipe = BatchPipeline(val_data, cfg.train.batch_size, shuffle=False)
    trainer.fit(
        BatchPipeline(train_data, cfg.train.batch_size, seed=cfg.train.seed),
        val_pipe,
    )


def _cmd_predict(args):
    import dataclasses

    import jax

    from tpufusion.config import DEFAULT
    from tpufusion.models.fcn import init_fcn
    from tpufusion.predict import predict_dataset_dir
    from tpufusion.train.checkpoint import CheckpointManager

    cfg = DEFAULT
    if args.head != "corner":
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, head=args.head, reg_output_activation="linear"))
    variables = init_fcn(cfg.model, jax.random.PRNGKey(0), in_channels=3)
    if args.checkpoint:
        _, variables, _ = CheckpointManager(args.checkpoint).restore(
            variables
        )
    report = predict_dataset_dir(
        variables, args.dataset, args.output_dir, cfg, batch=args.batch_size
    )
    print(json.dumps(report))


def _cmd_submit(args):
    from tpufusion.eval.submission import generate_submission

    meta = {"l": args.l, "w": args.w, "h": args.h}
    offset = tuple(args.offset) if args.offset else None
    generate_submission(
        args.predictions, args.camera_timestamps, meta, args.output, offset
    )
    print(json.dumps({"output": args.output}))


def _cmd_score(args):
    import csv as _csv

    from tpufusion.eval.scoring import score_poses

    def read_poses(path):
        # prediction CSVs carry l/w/h; ground-truth pose CSVs may not —
        # fall back to the metadata size flags there
        rows = []
        with open(path) as f:
            for r in _csv.DictReader(f):
                rows.append(
                    [
                        float(r["tx"]), float(r["ty"]), float(r["tz"]),
                        float(r.get("rz", 0.0)),
                        float(r.get("l") or args.l), float(r.get("w") or args.w),
                        float(r.get("h") or args.h),
                    ]
                )
        return np.asarray(rows)

    print(json.dumps(score_poses(
        read_poses(args.predictions), read_poses(args.truth),
        pose_frame=args.pose_frame,
    )))


def _cmd_extract(args):
    if args.input.endswith(".bag"):
        from tpufusion.data.etl import extract_bag_dataset

        report = extract_bag_dataset(
            args.input,
            args.output_dir,
            tracklet_xml=args.tracklet,
            camera_yaml=args.camera_yaml,
            extrinsic_yaml=args.extrinsic_yaml,
            crop=(args.crop_top, args.crop_bottom),
            save_png=args.png,
            streaming=args.streaming,
        )
    else:
        from tpufusion.data.etl import extract_dataset

        npz = np.load(args.input)
        report = extract_dataset(
            args.output_dir,
            npz["points"],
            npz["timestamps"],
            tracklet_xml=args.tracklet,
            camera_timestamps=npz.get("camera_timestamps"),
        )
    print(json.dumps(report))


def _cmd_calibrate(args):
    from tpufusion.tools.calibrate import calibrate_from_settings

    print(json.dumps(calibrate_from_settings(args.settings, args.camera)))


def _cmd_diff(args):
    from tpufusion.tools.datadiff import diff_dirs

    diffs = diff_dirs(args.dir_a, args.dir_b, args.rel_tol)
    for d in diffs:
        print(*d)
    sys.exit(1 if diffs else 0)


def _cmd_analyze(args):
    from tpufusion.data.registry import load_pose_csv
    from tpufusion.tools.analyze import save_polar_plot

    rows = load_pose_csv(args.poses)
    centers = np.asarray([[r["tx"], r["ty"]] for r in rows])
    save_polar_plot(centers, args.output)
    print(json.dumps({"frames": len(rows), "plot": args.output}))


def _load_camera(args):
    """CameraModel from YAMLs, or the synthetic forward-facing pinhole
    when the dataset carries no calibration (synthetic extracts)."""
    from tpufusion.geometry.camera import CameraModel, synthetic_camera

    if getattr(args, "camera_yaml", None):
        return CameraModel().load_camera_calibration(
            args.camera_yaml, getattr(args, "extrinsic_yaml", None)
        )
    return synthetic_camera()


def _cmd_overlay_radar(args):
    import csv as _csv
    import os

    import cv2

    from tpufusion.tools.visualize import render_radar_boxes_on_camera

    camera = _load_camera(args)
    with open(args.radar_csv) as f:
        rows = [
            {k: float(v) for k, v in r.items()}
            for r in _csv.DictReader(f)
        ]
    by_ts = {}
    for r in rows:
        by_ts.setdefault(int(r.get("timestamp", 0)), []).append(r)
    os.makedirs(args.out_dir, exist_ok=True)
    npz = np.load(args.camera_frames)
    images, ts = npz["images"], npz["timestamps"]
    written = 0
    keys = np.asarray(sorted(by_ts))
    for img, t in zip(images, ts):
        # nearest radar burst to this frame (process_radar_data.py:103)
        near = int(keys[np.abs(keys - int(t)).argmin()]) if len(keys) else None
        if near is None:
            continue
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        canvas = render_radar_boxes_on_camera(
            img, by_ts[near], camera, crop_top=args.crop_top
        )
        cv2.imwrite(os.path.join(args.out_dir, f"image_{int(t)}.png"), canvas)
        written += 1
    print(json.dumps({"frames": written, "out_dir": args.out_dir}))


def _cmd_crops(args):
    from tpufusion.data.registry import load_pose_csv
    from tpufusion.tools.crops import extract_crops

    camera = _load_camera(args)
    npz = np.load(args.camera_frames)
    images, ts = npz["images"], npz["timestamps"]
    rows = load_pose_csv(args.poses)
    by_ts = {int(r["timestamp"]): r for r in rows}
    poses = []
    for t in ts:
        r = by_ts.get(int(t))
        poses.append(
            [r["tx"], r["ty"], r["tz"], r.get("rz", 0.0),
             r.get("l", args.l), r.get("w", args.w), r.get("h", args.h)]
            if r else [0.0] * 7
        )
    written = extract_crops(
        images, np.asarray(poses, float), camera, args.out_dir,
        label=args.label, tag=args.tag, crop_top=args.crop_top,
    )
    print(json.dumps({"crops": len(written), "out_dir": args.out_dir}))


def _cmd_edges(args):
    import cv2

    from tpufusion.tools.visualize import detect_edges

    img = cv2.imread(args.input, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise SystemExit(f"cannot read {args.input}")
    cv2.imwrite(args.output, detect_edges(img, args.t1, args.t2))
    print(json.dumps({"output": args.output}))


def _cmd_view(args):
    from tpufusion.serve.viewer import view_dataset

    view_dataset(
        args.path,
        checkpoint=args.checkpoint,
        port=args.port,
        rate_hz=args.rate,
        loop=args.loop,
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpufusion")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the lidar or camera FCN")
    t.add_argument("--train_file", required=True)
    t.add_argument("--val_file", default=None)
    t.add_argument("--dir_prefix", default="")
    t.add_argument("--outdir", default="./runs/lidar")
    t.add_argument("--batch_size", type=int, default=64)
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--lr_schedule", choices=("constant", "cosine"),
                   default="constant",
                   help="constant matches the reference (model.py:186)")
    t.add_argument("--lr_decay_steps", type=int, default=0,
                   help="cosine horizon in optimizer steps (0 = heuristic)")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--source", choices=("lidar", "camera"), default="lidar",
                   help="training data source (train.py:109-122)")
    t.add_argument("--head", choices=("corner", "direct"), default="corner",
                   help="regression head family: corner = reference parity "
                        "(encoder.py:156-238); direct = the framework's "
                        "8-channel pose head (linear output, no roll aug)")
    t.add_argument("--camera_yaml", default=None,
                   help="camera intrinsics YAML (camera source)")
    t.add_argument("--extrinsic_yaml", default=None,
                   help="lidar->camera extrinsics YAML (camera source)")
    t.add_argument("--crop_top", type=int, default=430,
                   help="camera crop offset used at extraction")
    t.set_defaults(fn=_cmd_train)

    pr = sub.add_parser("predict", help="batch inference -> pose CSV")
    pr.add_argument("dataset")
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--output_dir", default="./predictions")
    pr.add_argument("--batch_size", type=int, default=32)
    pr.add_argument("--head", choices=("corner", "direct"), default="corner",
                   help="must match the head the checkpoint was trained with")
    pr.set_defaults(fn=_cmd_predict)

    sb = sub.add_parser("submit", help="pose CSV -> tracklet XML")
    sb.add_argument("predictions")
    sb.add_argument("camera_timestamps")
    sb.add_argument("output")
    sb.add_argument("--l", type=float, required=True)
    sb.add_argument("--w", type=float, required=True)
    sb.add_argument("--h", type=float, required=True)
    sb.add_argument("--offset", type=float, nargs=3, default=None)
    sb.set_defaults(fn=_cmd_submit)

    sc = sub.add_parser("score", help="pose CSV vs truth CSV -> metrics")
    sc.add_argument("predictions")
    sc.add_argument("truth")
    sc.add_argument("--l", type=float, default=0.0,
                    help="obstacle size fallback when the CSV lacks l/w/h")
    sc.add_argument("--w", type=float, default=0.0)
    sc.add_argument("--h", type=float, default=0.0)
    sc.add_argument("--pose_frame", choices=("orbit", "physical"),
                    default="orbit",
                    help="coordinate convention of BOTH CSVs: the predict "
                         "pipeline and the GT interp CSVs are orbit-origin "
                         "(center pre-rotation by rz); metrics are always "
                         "physical-frame (see eval/scoring docstring)")
    sc.set_defaults(fn=_cmd_score)

    ex = sub.add_parser("extract", help=".bag or points NPZ -> dataset dir")
    ex.add_argument("input")
    ex.add_argument("output_dir")
    ex.add_argument("--tracklet", default=None)
    ex.add_argument("--camera_yaml", default=None,
                    help="camera intrinsics YAML (enables rectification)")
    ex.add_argument("--extrinsic_yaml", default=None,
                    help="lidar->camera extrinsics YAML")
    ex.add_argument("--crop_top", type=int, default=430)
    ex.add_argument("--crop_bottom", type=int, default=942)
    ex.add_argument("--streaming", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="two-pass memmap extraction (bounded host "
                         "memory; default: auto by bag size)")
    ex.add_argument("--png", action="store_true",
                    help="also save per-frame camera PNGs")
    ex.set_defaults(fn=_cmd_extract)

    ca = sub.add_parser("calibrate", help="SLSQP lidar->camera extrinsics")
    ca.add_argument("settings")
    ca.add_argument("camera")
    ca.set_defaults(fn=_cmd_calibrate)

    df = sub.add_parser("diff", help="compare two extracted dataset dirs")
    df.add_argument("dir_a")
    df.add_argument("dir_b")
    df.add_argument("--rel_tol", type=float, default=0.05)
    df.set_defaults(fn=_cmd_diff)

    an = sub.add_parser("analyze", help="GT distribution polar histogram")
    an.add_argument("poses")
    an.add_argument("--output", default="gt_distribution.png")
    an.set_defaults(fn=_cmd_analyze)

    ov = sub.add_parser(
        "overlay_radar",
        help="draw radar-derived 3D boxes on camera frames "
             "(process_radar_data.py:122-141)",
    )
    ov.add_argument("camera_frames", help="camera_frames.npz from extract")
    ov.add_argument("radar_csv", help="radar/radar_tracks.csv")
    ov.add_argument("out_dir")
    ov.add_argument("--camera_yaml", default=None)
    ov.add_argument("--extrinsic_yaml", default=None)
    ov.add_argument("--crop_top", type=int, default=0)
    ov.set_defaults(fn=_cmd_overlay_radar)

    cr = sub.add_parser(
        "crops",
        help="crop detected/GT boxes to JPEGs for a downstream classifier "
             "(video/extract_image.py:15-33, YOLO-free)",
    )
    cr.add_argument("camera_frames", help="camera_frames.npz from extract")
    cr.add_argument("poses", help="predictions or GT pose CSV")
    cr.add_argument("out_dir")
    cr.add_argument("--camera_yaml", default=None)
    cr.add_argument("--extrinsic_yaml", default=None)
    cr.add_argument("--crop_top", type=int, default=0)
    cr.add_argument("--label", default="Car")
    cr.add_argument("--tag", default="dataset")
    cr.add_argument("--l", type=float, default=4.2)
    cr.add_argument("--w", type=float, default=1.6)
    cr.add_argument("--h", type=float, default=1.5)
    cr.set_defaults(fn=_cmd_crops)

    ed = sub.add_parser(
        "edges", help="Canny edge demo (video/edge_detection.py:14-17)"
    )
    ed.add_argument("input")
    ed.add_argument("output")
    ed.add_argument("--t1", type=float, default=100.0)
    ed.add_argument("--t2", type=float, default=200.0)
    ed.set_defaults(fn=_cmd_edges)

    vw = sub.add_parser(
        "view",
        help="live browser viewer: replay a dataset's renders over HTTP "
        "(the headless stand-in for the pyglet bag viewers)",
    )
    vw.add_argument("path", help="extracted dataset dir or raw points .npz")
    vw.add_argument("--checkpoint", default=None,
                    help="stream the class-mask window too")
    vw.add_argument("--port", type=int, default=8642)
    vw.add_argument("--rate", type=float, default=10.0)
    vw.add_argument("--loop", action="store_true")
    vw.set_defaults(fn=_cmd_view)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    from tpufusion.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
