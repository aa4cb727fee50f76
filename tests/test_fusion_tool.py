"""Protocol tests for the fusion accuracy tool and the full-size camera
bench (tools/train_fusion_synthetic.py, tools/bench_camera_full.py).

The tools themselves run on the accelerator; these tests pin the parts
that decide whether their numbers MEAN anything: the
synthetic camera actually renders the vehicle where the calibration says
it is, the aligned dataset carries consistent targets across modalities,
and the lidar-only ablation really blinds the camera/radar branches.
"""

import numpy as np
import pytest

from tpufusion.tools.train_fusion_synthetic import (
    CAM,
    build_dataset,
    make_camera,
    render_camera_frames,
)
from tpufusion.config import RangeViewSpec


@pytest.fixture(scope="module")
def tiny_data():
    # 6 frames at the tool's real geometry (512x1368 cam, 32x1801 lidar);
    # dataset building is numpy + one small jax projection — CPU-fast.
    return build_dataset(6, seed=3, spec=RangeViewSpec())


def test_camera_renders_vehicle_at_projection():
    """The rendered frame's bright box sits where the pinhole projects the
    physical vehicle — the camera branch's signal is geometric, not
    decorative."""
    cam = make_camera()
    rng = np.random.default_rng(0)
    phys = np.array([[14.0, 1.5, -0.7]], np.float32)
    size = np.array([[4.2, 1.6, 1.5]], np.float32)
    frame = render_camera_frames(phys, size, cam, rng)[0, :, :, 0]
    uv = cam.project_lidar_to_pixels(phys)  # (1, 2) u, v (full frame)
    u = int(uv[0, 0])
    v = int(uv[0, 1]) - (1024 - CAM.height) // 2  # tool's center crop
    # a patch at the projected center is bright vehicle body (>= 0.35
    # beats the 0.05-0.25 noise background even under the window shading)
    patch = frame[max(v - 3, 0) : v + 4, max(u - 3, 0) : u + 4]
    assert patch.min() >= 0.34, (patch.min(), u, v)
    # far corners stay background
    assert frame[:20, :20].max() <= 0.26


def test_camera_box_scale_tracks_distance():
    """Nearer vehicles render bigger: the camera contributes range
    information, which is what late fusion is supposed to exploit."""
    cam = make_camera()
    rng = np.random.default_rng(1)
    phys = np.array([[9.0, 0.0, -0.7], [28.0, 0.0, -0.7]], np.float32)
    size = np.broadcast_to(np.array([4.2, 1.6, 1.5], np.float32), (2, 3))
    frames = render_camera_frames(phys, size, cam, rng)
    areas = [(frames[i, :, :, 0] > 0.33).sum() for i in range(2)]
    assert areas[0] > 4 * areas[1], areas


def test_dataset_modalities_are_consistent(tiny_data):
    d = tiny_data
    n = len(d["cam"])
    assert d["cam"].shape == (n, CAM.height, CAM.width, 1)
    assert d["lidar"].shape[1:] == (32, 1801, 3)
    assert d["radar"].shape == (n, 2)
    # radar range observes the PHYSICAL cluster |Rz(yaw) @ center| =
    # |center| (rotation preserves the norm) with 0.25 m sensor noise
    gtr = np.linalg.norm(d["centroid"][:, :2], axis=1)
    err = np.abs(d["radar"][:, 0] - gtr)
    assert err.max() < 1.5, err
    assert err.mean() < 0.6
    # radar azimuth matches the physical cluster direction to ~3 sigma
    yaw = d["rz"][:, 0]
    ang_phys = np.arctan2(d["centroid"][:, 1], d["centroid"][:, 0]) + yaw
    dang = np.abs(np.angle(np.exp(1j * (d["radar"][:, 1] - ang_phys))))
    assert dang.max() < 0.05, dang
    # the lidar image contains the vehicle cluster: some occupied pixels
    # within the footprint distance of each frame's range
    occ = (d["lidar"][..., 0] > 0).mean(axis=(1, 2))
    assert (occ > 0.02).all(), occ


def test_full_camera_label_footprint_hits_projection():
    """bench_camera_full's labels mark fg where the tool renders the
    vehicle — training signal and pixels agree."""
    from tpufusion.tools.bench_camera_full import build_camera_dataset

    frames, labels = build_camera_dataset(4, seed=7)
    assert frames.shape == (4, 512, 1368, 1)
    assert labels.shape == (4, 512, 1368, 2)
    for i in range(4):
        fg = labels[i, :, :, 1] > 0
        assert fg.any(), i
        # the footprint overlaps the rendered bright box (IoU need not be
        # high — outer-rect labels pad by margin_frac — but most bright
        # vehicle pixels must be labeled fg)
        bright = frames[i, :, :, 0] > 0.33
        inter = (fg & bright).sum()
        assert inter > 0.3 * bright.sum(), i
