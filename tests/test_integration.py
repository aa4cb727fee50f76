"""End-to-end integration: synth scenes -> ETL -> train -> predict ->
submission XML -> scoring, all through the public APIs (reduced geometry
for CPU runtime)."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from tpufusion.config import (
    DecodeConfig,
    LossConfig,
    PipelineConfig,
    RangeViewSpec,
    TrainConfig,
)
from tpufusion.data.etl import extract_dataset, load_extracted
from tpufusion.data.pipeline import BatchPipeline
from tpufusion.data.synthetic import synthesize_dataset
from tpufusion.eval.scoring import score_poses
from tpufusion.eval.submission import generate_submission
from tpufusion.eval.tracklet_xml import Tracklet, TrackletCollection, parse_tracklet_xml
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.predict import predict_dataset_dir, predict_images
from tpufusion.train.stats import population_weights
from tpufusion.train.trainer import Trainer

SPEC = RangeViewSpec(res_h_deg=1.8)


@pytest.mark.slow
def test_full_pipeline(tmp_path):
    # --- synthesize + ETL ---
    raw = synthesize_dataset(seed=3, num_frames=24, n_points=4096)
    t = Tracklet("Car", l=4.2, w=1.6, h=1.5)
    for i in range(24):
        t.poses.append(
            {
                "tx": raw["center"][i, 0],
                "ty": raw["center"][i, 1],
                "tz": raw["center"][i, 2],
                "rx": 0.0,
                "ry": 0.0,
                "rz": raw["yaw"][i],
            }
        )
    gt_xml = tmp_path / "gt.xml"
    TrackletCollection([t]).write_xml(str(gt_xml))

    ds_dir = tmp_path / "ds"
    report = extract_dataset(
        str(ds_dir),
        raw["points"],
        raw["timestamp"],
        tracklet_xml=str(gt_xml),
        camera_timestamps=raw["timestamp"] + 5,  # near-lidar camera stream
        spec=SPEC,
    )
    assert report["frames"] == 24

    # --- train briefly on the extracted data ---
    data = load_extracted(str(ds_dir))
    train_data = {
        "images": data["images"],
        "center": raw["center"],
        "size": raw["size"],
        "yaw": raw["yaw"],
    }
    stats = population_weights(raw["center"], raw["size"], raw["yaw"], SPEC)
    cfg = PipelineConfig(
        range_view=SPEC,
        loss=LossConfig(
            obj_to_bkg_ratio=stats["positive_to_negative_ratio"],
            avg_obj_size=stats["average_area"],
        ),
        train=TrainConfig(batch_size=8, epochs=3, learning_rate=3e-3),
    )
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"))
    hist = trainer.fit(BatchPipeline(train_data, 8, seed=0))
    assert hist.epoch["loss"][-1] < hist.epoch["loss"][0]
    assert os.path.exists(tmp_path / "run" / "pr_curve.csv")

    # --- resume from checkpoint into a fresh trainer ---
    trainer2 = Trainer(cfg, outdir=str(tmp_path / "run"))
    assert trainer2.resume()

    # --- batch predict -> CSVs ---
    out = predict_dataset_dir(
        trainer2.variables, str(ds_dir), str(tmp_path / "pred"), cfg, batch=8
    )
    assert os.path.exists(out["predictions_csv"])
    assert os.path.exists(out["metadata_csv"])

    # --- submission XML on the camera timestamps ---
    sub_xml = tmp_path / "submission.xml"
    coll = generate_submission(
        out["predictions_csv"],
        str(ds_dir / "camera_timestamps.csv"),
        {"l": 4.2, "w": 1.6, "h": 1.5},
        str(sub_xml),
    )
    assert len(coll.tracklets[0].poses) == 24
    assert len(parse_tracklet_xml(str(sub_xml))[0].poses) == 24

    # --- scoring runs and reports a sane structure ---
    poses, found = predict_images(
        trainer2.variables, data["images"], cfg, batch=8
    )
    truth = np.concatenate(
        [
            raw["center"],
            raw["yaw"][:, None],
            raw["size"],
        ],
        axis=1,
    )
    s = score_poses(poses, truth)
    assert 0.0 <= s["detection_rate"] <= 1.0
    assert s["frames"] == 24


def test_cli_submit_score_diff(tmp_path):
    from tpufusion.cli import main as cli_main
    from tpufusion.eval.submission import write_predictions_csv

    poses = [(5.0, 3.0, -0.5, 0.3, 4.0, 1.6, 1.5)] * 3
    pred_csv = tmp_path / "p.csv"
    write_predictions_csv(poses, [100, 200, 300], str(pred_csv))

    ts_csv = tmp_path / "cam.csv"
    ts_csv.write_text("timestamp\n100\n200\n300\n")
    out_xml = tmp_path / "s.xml"
    cli_main(
        [
            "submit", str(pred_csv), str(ts_csv), str(out_xml),
            "--l", "4.0", "--w", "1.6", "--h", "1.5",
        ]
    )
    assert out_xml.exists()

    truth_csv = tmp_path / "t.csv"
    write_predictions_csv(poses, [100, 200, 300], str(truth_csv))
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["score", str(pred_csv), str(truth_csv)])
    s = json.loads(buf.getvalue().splitlines()[-1])
    assert s["detection_rate"] == 1.0 and s["mean_iou"] > 0.99

    # --pose_frame physical skips the orbit->physical rotation; with pred
    # == truth both frames are exact, but the flag must parse and route
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["score", str(pred_csv), str(truth_csv),
                  "--pose_frame", "physical"])
    s2 = json.loads(buf.getvalue().splitlines()[-1])
    assert s2["mean_iou"] > 0.99 and s2["mean_xy_err"] < 1e-9
