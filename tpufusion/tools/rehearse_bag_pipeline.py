"""Full-geometry bag -> submission rehearsal, timed (one command).

The reference's production flow was three hand-run stages on a real
Didi round-2 bag: `modules/lidar/process/extract_rosbag.py` (bag ->
range tensors + GT CSVs) -> `modules/lidar/train/train.py` ->
`modules/lidar/train/predict.py` -> `generate_tracklet_predictions.py`
(submission XML). test_integration.py exercises that chain at reduced
geometry (width 201, CPU); this tool rehearses it at the REAL geometry
on the real device: a BagWriter-synthesized multi-topic bag (velodyne
PointCloud2 + camera Image + radar tracks + GT tracklet XML) pushed
through the public CLI — extract -> train -> predict -> submit ->
score — at the full 32x1801 range view, with per-stage wall timings.

Run: python -m tpufusion.tools.rehearse_bag_pipeline
Prints one JSON line per stage + a summary.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout


def synthesize_bag(path: str, frames: int, n_points: int, seed: int,
                   cam_hw: tuple[int, int] = (1096, 1368)) -> dict:
    """Write a rosbag-v2 bag with the challenge's three sensor topics and
    return the GT arrays. Clouds are beam-structured ray-cast scans at
    the full sweep resolution; camera frames are synthetic uint8 ramps at
    the reference's raw capture height (rows 430:942 survive the crop,
    `process/globals.py:15-16`); radar tracks carry the GT range/angle
    so `cli extract`'s radar CSV has physical content."""
    import jax
    import numpy as np

    from tpufusion.data.rosbag_reader import (
        RADAR_TRACKS_DEFINITION,
        BagWriter,
        serialize_image,
        serialize_pointcloud2,
        serialize_radar_tracks,
    )
    from tpufusion.data.synthetic import synthesize_beam_scan_batch
    from tpufusion.eval.tracklet_xml import Tracklet, TrackletCollection

    pts, gt, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(seed), frames, n_points
    )
    pts = np.asarray(pts)
    valid = np.asarray(valid)
    center = np.asarray(gt["center"])
    size = np.asarray(gt["size"])
    yaw = np.asarray(gt["yaw"])

    w = BagWriter(compression="lz4")
    w.add_connection(0, "/velodyne_points", "sensor_msgs/PointCloud2")
    w.add_connection(1, "/image_raw", "sensor_msgs/Image")
    w.add_connection(2, "/radar/tracks", "radar_driver/RadarTracks",
                     RADAR_TRACKS_DEFINITION)
    t0 = 1_490_000_000_000_000_000
    dt = 100_000_000  # 10 Hz capture, like the challenge bags
    h, wd = cam_hw
    ramp = (np.arange(h, dtype=np.uint32)[:, None]
            + np.arange(wd, dtype=np.uint32)[None, :])
    cloud_bytes = 0
    for i in range(frames):
        cloud = pts[i][valid[i]]  # variable-size clouds, like real scans
        raw = serialize_pointcloud2(cloud.astype(np.float32))
        cloud_bytes += len(raw)
        w.add_message(0, t0 + i * dt, raw)
        img = ((ramp + 7 * i) % 256).astype(np.uint8)
        w.add_message(1, t0 + i * dt + 3_000_000,
                      serialize_image(img, encoding="mono8"))
        rng = float(np.hypot(center[i, 0], center[i, 1]))
        ang = float(np.degrees(np.arctan2(center[i, 1], center[i, 0])))
        w.add_message(2, t0 + i * dt + 5_000_000, serialize_radar_tracks(
            [{"number": 1, "range": rng, "angle": ang, "rate": 0.0,
              "width": float(size[i, 1]), "late_rate": 0.0}]
        ))
    w.write(path)

    t = Tracklet("Car", l=float(size[0, 0]), w=float(size[0, 1]),
                 h=float(size[0, 2]))
    for i in range(frames):
        t.poses.append({
            "tx": float(center[i, 0]), "ty": float(center[i, 1]),
            "tz": float(center[i, 2]), "rx": 0.0, "ry": 0.0,
            "rz": float(yaw[i]),
        })
    gt_xml = os.path.splitext(path)[0] + "_gt.xml"
    TrackletCollection([t]).write_xml(gt_xml)
    return {
        "gt_xml": gt_xml,
        "timestamps": [t0 + i * dt for i in range(frames)],
        "bag_bytes": os.path.getsize(path),
        "cloud_bytes": cloud_bytes,
        "mean_size": size.mean(axis=0).tolist(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--n_points", type=int, default=32768)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--head", default="direct",
                    choices=("direct", "corner"))
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--workdir", default="/tmp/rehearse_bag")
    args = ap.parse_args(argv)

    from tpufusion.cli import main as cli_main

    os.makedirs(args.workdir, exist_ok=True)
    bag = os.path.join(args.workdir, "scene.bag")
    ds = os.path.join(args.workdir, "ds")
    run = os.path.join(args.workdir, "run")
    pred = os.path.join(args.workdir, "pred")
    timings: dict[str, float] = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        timings[name] = round(time.perf_counter() - t, 2)
        print(json.dumps({"stage": name, "s": timings[name]}),
              file=sys.stderr)
        return out

    meta = stage("synthesize_bag", lambda: synthesize_bag(
        bag, args.frames, args.n_points, args.seed))

    stage("extract", lambda: cli_main(
        ["extract", bag, ds, "--tracklet", meta["gt_xml"]]))

    # registry row pointing at the extracted dir (the reference's
    # train.py consumed the same per-bag dataset-dir layout)
    reg = os.path.join(args.workdir, "registry.csv")
    mcsv = os.path.join(args.workdir, "meta.csv")
    with open(reg, "w") as f:
        f.write("ds,meta.csv\n")
    with open(mcsv, "w") as f:
        ms = meta["mean_size"]
        f.write(f"l,w,h\n{ms[0]:.3f},{ms[1]:.3f},{ms[2]:.3f}\n")

    stage("train", lambda: cli_main(
        ["train", "--train_file", reg, "--dir_prefix", args.workdir,
         "--outdir", run, "--batch_size", str(args.batch),
         "--epochs", str(args.epochs), "--head", args.head]))

    stage("predict", lambda: cli_main(
        ["predict", ds, "--checkpoint", os.path.join(run, "ckpt"),
         "--output_dir", pred, "--batch_size", str(args.batch),
         "--head", args.head]))

    pred_csv = os.path.join(pred, "objects_obs1_lidar_predictions.csv")
    sub_xml = os.path.join(args.workdir, "submission.xml")
    ms = meta["mean_size"]
    stage("submit", lambda: cli_main(
        ["submit", pred_csv, os.path.join(ds, "camera_timestamps.csv"),
         sub_xml, "--l", f"{ms[0]:.3f}", "--w", f"{ms[1]:.3f}",
         "--h", f"{ms[2]:.3f}"]))

    buf = io.StringIO()

    def _score():
        with redirect_stdout(buf):
            cli_main(["score", pred_csv,
                      os.path.join(ds, "obs_poses_interp_transform.csv"),
                      "--l", f"{ms[0]:.3f}", "--w", f"{ms[1]:.3f}",
                      "--h", f"{ms[2]:.3f}"])

    stage("score", _score)
    score = json.loads(buf.getvalue().splitlines()[-1])

    from tpufusion.eval.tracklet_xml import parse_tracklet_xml

    n_sub = len(parse_tracklet_xml(sub_xml)[0].poses)
    summary = {
        "frames": args.frames,
        "n_points": args.n_points,
        "bag_mb": round(meta["bag_bytes"] / 1e6, 1),
        "head": args.head,
        "epochs": args.epochs,
        "timings_s": timings,
        "total_s": round(sum(timings.values()), 2),
        "submission_poses": n_sub,
        "score": {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in score.items()},
    }
    print(json.dumps(summary))
    assert n_sub == args.frames, (n_sub, args.frames)
    return summary


if __name__ == "__main__":
    main()
