"""Camera-source training: vs=2 FCN on grayscale frames with precomputed
footprint labels (classification only, like the reference camera path)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import yaml

from tpufusion.config import LossConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion.geometry.camera import CameraModel, camera_label_footprint
from tpufusion.models.fcn import init_fcn
from tpufusion.train.train_step import make_train_step


def _camera(tmp_path):
    cam_yaml = {
        "image_width": 201,
        "image_height": 64,
        "camera_matrix": {"data": [100, 0, 100, 0, 100, 32, 0, 0, 1]},
        "distortion_coefficients": {"data": [0, 0, 0, 0, 0]},
        "rectification_matrix": {"data": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
        "projection_matrix": {"data": [100, 0, 100, 0, 0, 100, 32, 0, 0, 0, 1, 0]},
        "distortion_model": "plumb_bob",
    }
    p = tmp_path / "cam.yaml"
    p.write_text(yaml.dump(cam_yaml))
    cam = CameraModel().load_camera_calibration(str(p))
    # lidar (x fwd, y left, z up) -> camera (z fwd, x right, y down)
    cam.extrinsic = np.array(
        [
            [0.0, -1.0, 0.0, 0.0],
            [0.0, 0.0, -1.0, 0.0],
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    return cam


def test_camera_training_learns(tmp_path, rng):
    cam = _camera(tmp_path)
    hw = (64, 201)
    f = 16
    images = rng.random((f, *hw, 1)).astype(np.float32)
    labels = np.zeros((f, *hw, 2), np.float32)
    for i in range(f):
        center = np.array([rng.uniform(8, 20), rng.uniform(-2, 2), -0.5])
        onehot, bbox = camera_label_footprint(
            center, np.array([4.2, 1.6, 1.5]), cam, hw, crop_top=0
        )
        labels[i] = onehot
        # paint the object into the image so there is signal to learn
        images[i, :, :, 0] += onehot[..., 1] * 2.0
    assert labels[..., 1].sum() > 0, "footprints must rasterize"

    mcfg = ModelConfig(vertical_stride=2, use_regression=False)
    variables = init_fcn(mcfg, jax.random.PRNGKey(0), in_channels=1)
    tx = optax.adam(3e-3)
    opt_state = tx.init(variables["params"])
    pos_frac = labels[..., 1].mean()
    loss_cfg = LossConfig(
        obj_to_bkg_ratio=pos_frac, avg_obj_size=float(labels[..., 1].sum() / f)
    )
    step = make_train_step(
        mcfg, tx, RangeViewSpec(), loss_cfg,
        TrainConfig(batch_size=8, augment=True),
    )
    batch = {
        "images": jnp.asarray(images[:8]),
        "labels": jnp.asarray(labels[:8]),
    }
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(25):
        key, sub = jax.random.split(key)
        variables, opt_state, m = step(variables, opt_state, batch, sub)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    assert float(m["recall"]) > 0.5


def test_cli_camera_train_end_to_end(tmp_path, rng):
    """bag -> `cli extract` (camera frames) -> `cli train --source camera`:
    the reference's camera training path (train.py:109-170) as one CLI
    chain."""
    import os

    from scipy.spatial.transform import Rotation

    from tpufusion.cli import main as cli_main
    from tpufusion.data.rosbag_reader import (
        BagWriter,
        serialize_image,
        serialize_pointcloud2,
    )
    from tpufusion.eval.tracklet_xml import Tracklet, TrackletCollection
    from tpufusion.geometry.camera import CameraModel

    # camera yaml (64x201) + extrinsic yaml for the lidar->camera axis swap
    cam_yaml = {
        "image_width": 201,
        "image_height": 64,
        "camera_matrix": {"data": [100, 0, 100, 0, 100, 32, 0, 0, 1]},
        "distortion_coefficients": {"data": [0, 0, 0, 0, 0]},
        "rectification_matrix": {"data": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
        "projection_matrix": {
            "data": [100, 0, 100, 0, 0, 100, 32, 0, 0, 0, 1, 0]
        },
        "distortion_model": "plumb_bob",
    }
    cam_path = tmp_path / "cam.yaml"
    cam_path.write_text(yaml.dump(cam_yaml))
    target_r = np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]])
    # load_camera_calibration builds euler_matrix(rot[2], rot[1], rot[0],
    # 'rzxz') = intrinsic ZXZ with angles (rot[2], rot[1], rot[0])
    ai, aj, ak = Rotation.from_matrix(target_r).as_euler("ZXZ")
    ext_path = tmp_path / "ext.yaml"
    ext_path.write_text(yaml.dump({
        "translation": {"data": [0.0, 0.0, 0.0]},
        "euler_rotations": {"data": [float(ak), float(aj), float(ai)]},
    }))
    check = CameraModel().load_camera_calibration(str(cam_path), str(ext_path))
    np.testing.assert_allclose(check.extrinsic[:3, :3], target_r, atol=1e-9)

    # bag: 8 frames; vehicle ahead so its footprint lands in-image
    w = BagWriter()
    w.add_connection(0, "/velodyne_points", "sensor_msgs/PointCloud2")
    w.add_connection(1, "/image_raw", "sensor_msgs/Image")
    t0 = 1_490_000_000_000_000_000
    tr = Tracklet("Car", l=4.2, w=1.6, h=1.5, first_frame=0)
    for i in range(8):
        ts = t0 + i * 100_000_000
        pts = rng.normal(0, 20, (400, 4)).astype(np.float32)
        w.add_message(0, ts, serialize_pointcloud2(pts))
        img = rng.integers(0, 60, (64, 201)).astype(np.uint8)
        w.add_message(1, ts + 1, serialize_image(img, "mono8"))
        tr.poses.append({"tx": 12.0 + i * 0.5, "ty": float(np.sin(i) * 1.5),
                         "tz": -0.5, "rx": 0.0, "ry": 0.0, "rz": 0.0})
    bag = tmp_path / "t.bag"
    w.write(str(bag))
    gt = tmp_path / "gt.xml"
    TrackletCollection([tr]).write_xml(str(gt))

    ds = tmp_path / "ds"
    cli_main([
        "extract", str(bag), str(ds), "--tracklet", str(gt),
        "--crop_top", "0", "--crop_bottom", "64",
    ])
    assert os.path.exists(ds / "camera_frames.npz")
    assert os.path.exists(ds / "obs_poses_camera.csv")

    (tmp_path / "registry.csv").write_text("ds,meta.csv\n")
    (tmp_path / "meta.csv").write_text("l,w,h\n4.2,1.6,1.5\n")
    outdir = tmp_path / "run_cam"
    cli_main([
        "train", "--train_file", str(tmp_path / "registry.csv"),
        "--dir_prefix", str(tmp_path), "--outdir", str(outdir),
        "--source", "camera", "--camera_yaml", str(cam_path),
        "--extrinsic_yaml", str(ext_path), "--crop_top", "0",
        "--batch_size", "4", "--epochs", "2",
    ])
    assert os.path.exists(outdir / "pr_curve.csv")
    assert os.path.exists(outdir / "metrics.jsonl")
