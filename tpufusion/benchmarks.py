"""The five benchmark configs.

  1. single Didi velodyne frame: BEV + cylindrical range projection +
     FCN forward (the reference's per-frame CPU path, modules/lidar)
  2. batched sequence replay: a 64-frame rosbag chunk through projection
     + FCN + tracklet box decode
  3. camera+lidar fused: the calibration (modules/camera-lidar-
     calibration) paints camera channels onto BEV before the FCN, plus
     the late-fusion net forward
  4. full challenge eval: predictions -> tracklet XML + pose/IoU scoring
     at batch 32, with the shipped detector asset
  5. Waymo Perception scale: 64-beam high-res clouds (128k points),
     top-4 decode and multi-frame temporal tracking

Run on a GPU: python -m tpufusion.benchmarks [--configs 1,2,...] — one
JSON line per config on stdout, each naming the device. Without a GPU it
fails; a shipped asset that does not load fails its config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.config import DEFAULT, BevSpec
from tpufusion.data.synthetic import synthesize_beam_scan_batch
from tpufusion.geometry.bev import bev_rasterize_batch
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fcn import apply_fcn, init_fcn
from tpufusion.models.io import ASSET_DIR, load_detector_asset
from tpufusion.predict import make_e2e_step
from tpufusion.utils.device import (
    device_record,
    enable_compile_cache,
    require_gpu,
)
from tpufusion.utils.profiling import measure

CFG = DEFAULT
SPEC = CFG.range_view


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _model():
    """bf16 random-init FCN, classifier biased to background (trained-net
    sparsity) -> (model cfg, variables)."""
    mcfg = dataclasses.replace(CFG.model, dtype="bfloat16")
    variables = init_fcn(mcfg, jax.random.PRNGKey(0), in_channels=3)
    variables["params"]["deconv6a"]["bias"] = jnp.asarray([2.0, -2.0])
    return mcfg, variables


def _asset(name: str = "synthetic_detector.npz"):
    """A shipped detector asset in bf16 -> (model cfg, variables,
    decode cfg, meta)."""
    cfg, variables, meta = load_detector_asset(os.path.join(ASSET_DIR, name))
    mcfg = dataclasses.replace(cfg.model, dtype="bfloat16")
    log(f"loaded detector asset {name}")
    return mcfg, variables, cfg.decode, meta


def _point_sets(n_sets, batch, n_points, n_beams=32):
    """Beam-structured Velodyne scan batches: [(points, valid), ...].

    Since round 3 every timed config runs on the beam-structured
    distribution (discrete beams, occlusion shadows, range-dependent
    dropout) — the uniform generator stays for geometry tests only."""
    synth = jax.jit(
        lambda k: synthesize_beam_scan_batch(
            k, batch, n_points, n_beams=n_beams
        )[::2]
    )
    sets = [synth(jax.random.PRNGKey(i)) for i in range(n_sets)]
    return jax.block_until_ready(sets)


def config1_single_frame() -> dict:
    """BEV + range projection + FCN forward, single frame."""
    mcfg, variables = _model()

    @jax.jit
    def fn(variables, points, valid):
        images = range_view_project_batch(points, SPEC, valid)
        bev = bev_rasterize_batch(points, CFG.bev, valid)
        preds, _ = apply_fcn(mcfg, variables, images)
        return preds, bev

    sets = _point_sets(6, 1, 32768)
    dt = measure(fn, [(variables, p, v) for p, v in sets], reps=3)
    return {
        "config": 1,
        "metric": "single-frame BEV+range+FCN forward",
        "value": round(dt * 1e3, 3),
        "unit": "ms/frame",
        "fps": round(1.0 / dt, 1),
    }


def config2_replay() -> dict:
    """64-frame chunk through projection + FCN + pose decode."""
    mcfg, variables = _model()
    fn = make_e2e_step(mcfg, SPEC, CFG.decode)

    sets = _point_sets(6, 64, 32768)
    dt = measure(fn, [(variables, p, v) for p, v in sets], reps=2)
    return {
        "config": 2,
        "metric": "64-frame replay projection+FCN+decode",
        "value": round(64 / dt, 1),
        "unit": "frames/s/device",
        "ms_per_chunk": round(dt * 1e3, 1),
    }


def config3_fused() -> dict:
    """Camera channels painted onto BEV (per-frame gather through the
    calibration table), the fused tensor through an FCN forward, plus the
    late-fusion net forward (camera+lidar+radar) — all in one timed jit."""
    from tpufusion.config import ModelConfig
    from tpufusion.geometry.camera import CameraModel, rgb_onto_bev
    from tpufusion.models.fusion import FusionConfig, apply_fusion, init_fusion
    from tpufusion.models.io import load_state_npz

    cam = CameraModel()
    cam.width, cam.height = 1368, 512
    cam.P = np.asarray(
        [[1400.0, 0, 684, 0], [0, 1400.0, 256, 0], [0, 0, 1, 0]]
    )
    cam.extrinsic = np.asarray(
        [[0.0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]]
    )

    bev_spec = BevSpec(with_height_channel=True, with_intensity_channel=False)

    # calibration paint table, built once on host: BEV cell -> camera pixel.
    # Feeding coordinate planes through rgb_onto_bev yields (v, u, valid)
    # tables with exactly the painter's projection + flips.
    hc, wc = cam.height, cam.width
    nx, ny = bev_spec.nx, bev_spec.ny
    vv = np.broadcast_to(
        np.arange(hc, dtype=np.float32)[:, None, None], (hc, wc, 1)
    )
    uu = np.broadcast_to(
        np.arange(wc, dtype=np.float32)[None, :, None], (hc, wc, 1)
    )
    v_t = jnp.asarray(rgb_onto_bev(vv, cam, nx, ny)[..., 0].astype(np.int32))
    u_t = jnp.asarray(rgb_onto_bev(uu, cam, nx, ny)[..., 0].astype(np.int32))
    ok_t = jnp.asarray(
        rgb_onto_bev(np.ones((hc, wc, 1), np.float32), cam, nx, ny)[..., 0]
        > 0
    )

    # FCN over the fused BEV tensor (density + height + camera channels);
    # BEV transposed width-major and cropped 1199 -> 1197 so the encoder/
    # decoder widths round-trip (needs even conv2 width).
    bev_cfg = ModelConfig(dtype="bfloat16")
    state_b = init_fcn(bev_cfg, jax.random.PRNGKey(1), in_channels=3)
    # the TRAINED fusion asset, at the pools its json records
    asset = os.path.join(ASSET_DIR, "fusion_net.npz")
    with open(asset + ".json") as f:
        fmeta = json.load(f)
    fcfg = FusionConfig(
        lidar_model=ModelConfig(dtype="bfloat16"),
        camera_model=ModelConfig(
            vertical_stride=2, use_regression=False, dtype="bfloat16"
        ),
        lidar_pool=tuple(fmeta["lidar_pool"]),
        cam_pool=tuple(fmeta["cam_pool"]),
    )
    state_f = load_state_npz(asset, init_fusion(fcfg, jax.random.PRNGKey(2)))

    @jax.jit
    def fn(state_b, state_f, points, valid, cam_img, radar):
        bev = bev_rasterize_batch(points, bev_spec, valid)  # (B, nx, ny, 2)
        painted = jnp.where(ok_t, cam_img[:, v_t, u_t, 0], 0.0)
        fused = jnp.concatenate([bev, painted[..., None]], axis=-1)
        fused = jnp.swapaxes(fused, 1, 2)[:, :, : nx - 2, :]
        seg, _ = apply_fcn(bev_cfg, state_b, fused)
        lidar_img = range_view_project_batch(points, SPEC, valid)
        (centroid, rz), _ = apply_fusion(
            fcfg, state_f, cam_img, lidar_img, radar
        )
        return seg, centroid, rz

    batch = 8
    sets = _point_sets(6, batch, 32768)
    rng = np.random.default_rng(7)
    args = []
    for p, v in sets:
        cam_img = jnp.asarray(
            rng.uniform(0, 1, (batch, hc, wc, 1)).astype(np.float32)
        )
        radar = jnp.asarray(
            rng.uniform(-1, 1, (batch, 2)).astype(np.float32)
        )
        args.append((state_b, state_f, p, v, cam_img, radar))
    dt = measure(fn, args, reps=3)
    return {
        "config": 3,
        "metric": "camera-painted BEV + FCN + fusion-net forward (batch 8)",
        "value": round(dt * 1e3 / batch, 3),
        "unit": "ms/frame",
        "fps": round(batch / dt, 1),
    }


def config4_full_eval() -> dict:
    """Full challenge eval at batch 32 with the shipped detector asset:
    predict -> CSV -> tracklet XML -> pose/IoU scoring against the
    synthetic generator's real ground truth.

    Timing is split: the device phase is measured with the same
    `measure` as every other config over pre-staged batches, and the
    host artifact phase (CSV -> tracklet XML -> scoring) separately."""
    import tempfile
    import time

    from tpufusion.eval.scoring import score_poses
    from tpufusion.eval.submission import (
        generate_submission,
        write_predictions_csv,
    )

    mcfg, state, dcfg, _ = _asset()
    fn = make_e2e_step(mcfg, SPEC, dcfg, head=mcfg.head)

    frames, batch = 128, 32
    sets, truths = [], []
    for i in range(frames // batch):
        # max_yaw ~ 0: with the reference's orbit-origin corner
        # convention, large yaw makes the pose target unobservable for
        # axis-aligned clusters (NOTES.md round-2 session 3)
        pts, gt, vmask = synthesize_beam_scan_batch(
            jax.random.PRNGKey(1000 + i), batch, 32768, max_yaw=0.05
        )
        sets.append((pts, vmask))
        truths.append(
            np.concatenate(
                [
                    np.asarray(gt["center"]),
                    np.asarray(gt["yaw"])[:, None],
                    np.asarray(gt["size"]),
                ],
                axis=1,
            )
        )
    truth = np.concatenate(truths)  # (F, 7) tx ty tz rz l w h
    # device phase: e2e prediction over the pre-staged batches (same
    # measurement as the headline bench)
    dt_dev = measure(fn, [(state, *s) for s in sets], reps=3)
    # one drain of the prediction outputs (not timed: the artifact phase
    # below times host work)
    poses = np.concatenate(
        [np.asarray(fn(state, *s)[0]) for s in sets]
    )
    ts = (np.arange(frames) * 100_000_000 + 1).tolist()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        csv_path = os.path.join(d, "pred.csv")
        write_predictions_csv(poses, ts, csv_path)
        generate_submission(
            csv_path, ts, {"l": 4.2, "w": 1.6, "h": 1.5},
            os.path.join(d, "sub.xml"),
        )
    scores = score_poses(poses, truth, pose_frame="orbit")
    # submission semantics: the challenge pipeline fed the obstacle's
    # METADATA l/w/h into the tracklets (reference
    # generate_tracklet_predictions.py reads them from the metadata csv;
    # cli submit --l/--w/--h mirrors it) — the decoded corner boxes were
    # never the submitted size. Score that flow too.
    found = ~np.all(poses[:, :3] == 0.0, axis=1)
    sub = poses.copy()
    sub[found, 4:7] = [4.2, 1.6, 1.5]
    sub_scores = score_poses(sub, truth, pose_frame="orbit")
    host_dt = time.perf_counter() - t0
    out = {
        "config": 4,
        "metric": "full eval: predict+XML+scoring, 128 frames @ batch 32",
        "value": round(batch / dt_dev, 1),
        "unit": "frames/s/device (device phase)",
        "host_artifacts_ms_total": round(host_dt * 1e3, 1),
        "host_artifacts_ms_per_frame": round(host_dt * 1e3 / frames, 3),
        "detection_rate": scores["detection_rate"],
        "mean_iou": round(scores["mean_iou"], 3),
        "recall@iou0.25": scores["recall@iou0.25"],
        "mean_xy_err": _round_opt(scores.get("mean_xy_err")),
        "submission_mean_iou": round(sub_scores["mean_iou"], 3),
        "submission_recall@iou0.25": sub_scores["recall@iou0.25"],
    }
    out["wide_yaw"] = _wide_yaw_eval()
    out["mixed_family"] = _mixed_family_eval()
    return out


def _round_opt(v, nd: int = 3) -> float | None:
    """Round a metric that may be absent. None (not float('nan')) for
    missing values — json.dumps of a NaN emits a non-standard token that
    downstream JSON parsers reject, and an all-miss family plausibly has
    no xy/yaw error at all."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return None
    return round(v, nd)


def _companion_asset_eval(asset_name: str, protocol) -> dict:
    """Shared scaffolding for config 4's companion rows: load a named
    shipped asset, build its e2e step, and hand (meta, fn, state) to
    `protocol`, which returns the row dict. A load failure raises: no
    substitute model's scores are published under the asset's name."""
    mcfg, state, dcfg, meta = _asset(asset_name)
    fn = make_e2e_step(mcfg, SPEC, dcfg, head=mcfg.head)
    out = protocol(meta, fn, state)
    out["asset"] = asset_name
    return out


def _protocol_scores(fn, state, n_points: int, seed_base: int,
                     scene_kw: dict, frames: int = 128,
                     batch: int = 32) -> dict:
    """The 128-frame accuracy protocol: synthesize -> e2e step -> pose
    scoring; returns the standard metric dict shared by the companion
    rows."""
    from tpufusion.eval.scoring import score_poses

    poses, truths = [], []
    for i in range(frames // batch):
        pts, gt, vmask = synthesize_beam_scan_batch(
            jax.random.PRNGKey(seed_base + i), batch, n_points, **scene_kw
        )
        p, _ = fn(state, pts, vmask)
        poses.append(np.asarray(p))
        truths.append(np.concatenate(
            [np.asarray(gt["center"]),
             np.asarray(gt["yaw"])[:, None],
             np.asarray(gt["size"])], axis=1,
        ))
    scores = score_poses(
        np.concatenate(poses), np.concatenate(truths), pose_frame="orbit"
    )
    return {
        "detection_rate": scores["detection_rate"],
        "mean_iou": round(scores["mean_iou"], 3),
        "recall@iou0.25": scores["recall@iou0.25"],
        "mean_xy_err": _round_opt(scores.get("mean_xy_err")),
        "mean_yaw_err": _round_opt(scores.get("mean_yaw_err")),
    }


def _mixed_family_eval(frames: int = 128, batch: int = 32) -> dict:
    """Config 4's mixed-family companion: the 128-frame accuracy protocol
    run PER SURFACE FAMILY (circle / ellipse / box vehicle boundaries)
    with the single mixed-family asset
    (assets/synthetic_detector_mixed.npz — dual yaw codec, per-cluster
    auto gate, trained on all three families at once). The flagship rows
    above measure one family with a family-matched asset; this row
    measures what one deployment asset does when the fleet's vehicles
    are NOT one parametric family (the cross-family wall). The circle family evaluates at yaw cap
    min(max_yaw, 0.05) exactly as trained (yaw is unobservable on a
    rotationally symmetric surface); the oriented families use the
    asset's full training cap."""
    def protocol(meta, fn, state):
        n_points = int(meta.get("n_points", 32768))
        max_yaw = float(meta.get("max_yaw", 0.45))
        per_family = {}
        for fam, surface in (("beam", "circle"),
                             ("beam-ellipse", "ellipse"),
                             ("beam-box", "box")):
            fam_yaw = min(max_yaw, 0.05) if fam == "beam" else max_yaw
            per_family[fam] = _protocol_scores(
                fn, state, n_points, 4100,
                dict(max_yaw=fam_yaw, vehicle_surface=surface),
                frames=frames, batch=batch,
            )
        return {
            "max_yaw": max_yaw,
            "cross_family_mean_iou": round(
                float(np.mean([f["mean_iou"]
                               for f in per_family.values()])), 3
            ),
            "per_family": per_family,
        }

    return _companion_asset_eval("synthetic_detector_mixed.npz", protocol)


def _wide_yaw_eval(frames: int = 128, batch: int = 32) -> dict:
    """Config 4's wide-yaw companion: the same 128-frame accuracy
    protocol run with the wide-yaw detector asset
    (assets/synthetic_detector_yaw.npz, trained on oriented-ellipse
    scenes with the local yaw codec — DecodeConfig.direct_yaw_frame) on
    ITS training distribution (scenes/max_yaw from its json). The
    flagship rows above keep the reference-regime protocol (rz ~ 0,
    like the reference's real data); this row measures the regime the
    reference never handled: large yaw, where the orbit convention
    entangles yaw into position."""
    def protocol(meta, fn, state):
        from tpufusion.tools.detector_envelope import (
            base_condition_from_meta,
        )

        scene_kw = base_condition_from_meta(meta)
        n_points = scene_kw.pop("n_points")
        out = _protocol_scores(
            fn, state, n_points, 4000, scene_kw, frames=frames, batch=batch
        )
        out["max_yaw"] = scene_kw.get("max_yaw")
        out["scenes"] = meta.get("scenes")
        return out

    return _companion_asset_eval("synthetic_detector_yaw.npz", protocol)


def config5_waymo_scale() -> dict:
    """64-beam high-res clouds (131072 pts) + multi-obstacle (top-4)
    decode + temporal tracking with the trained detector (live detections
    exercise the decode's real cost); reports single-device throughput
    of the full multi-object graph."""
    from tpufusion.serve.tracker import PoseTracker

    mcfg, state, dcfg, _ = _asset()
    fn = make_e2e_step(mcfg, SPEC, dcfg, max_obstacles=4, head=mcfg.head)

    # 64-beam Waymo-scale scans: 64 x 2048 rays
    sets = _point_sets(4, 16, 131072, n_beams=64)
    dt = measure(fn, [(state, p, v) for p, v in sets], reps=3)

    # multi-object temporal tracking: a coherent 16-frame sequence of two
    # vehicles on constant-velocity paths (not independent scenes), decoded
    # top-4 per frame, tracked host-side
    from tpufusion.data.synthetic import synthesize_beam_tracking_sequence

    # tracking quality runs at the detector's training density (32k pts;
    # 128k clouds quadruple the clutter density and spawn spurious
    # clusters the asset was never trained against) — the throughput
    # number above stays at the full Waymo-scale 131072
    seq_pts, seq_gt, seq_valid = synthesize_beam_tracking_sequence(
        jax.random.PRNGKey(77), 16, 32768, n_vehicles=2
    )
    p, fd = fn(state, seq_pts, seq_valid)
    tracker = PoseTracker(dt=0.1)
    trails = tracker.run_multi(np.asarray(p), np.asarray(fd))

    from tpufusion.serve.tracker import track_quality_metrics

    gt_c = np.asarray(seq_gt["center"])  # (F, V, 3)
    quality = track_quality_metrics(trails, gt_c)

    # per-BOX accuracy of the top-K decode on the same sequence (tracking
    # metrics above measure identity/coverage, not box quality)
    from tpufusion.eval.scoring import score_multi_poses

    box_scores = score_multi_poses(
        np.asarray(p), np.asarray(fd), gt_c,
        np.asarray(seq_gt["yaw"]), np.asarray(seq_gt["size"]),
        pose_frame="orbit",
    )

    out = {
        "config": 5,
        "metric": "Waymo-scale 128k-pt clouds + top-4 decode + tracking",
        "value": round(16 / dt, 1),
        "unit": "frames/s/device",
        "detections": int(np.asarray(fd).sum()),
        "tracks": len(trails),
        "vehicles_tracked": (
            f"{quality['vehicles_tracked']}/{quality['vehicles_total']}"
        ),
        "spurious_tracks": quality["spurious_tracks"],
        "id_switches": quality["id_switches"],
        "fragmentation": quality["fragmentation"],
        "track_coverage": quality["coverage"],
        "tracked_frames": len(
            {f for trail in trails.values() for f, _ in trail}
        ),
        **box_scores,
    }
    out["oriented"] = _oriented_tracking_eval()
    return out


def _oriented_tracking_eval(frames: int = 16) -> dict:
    """Config 5's oriented companion: the same temporal-tracking protocol
    with vehicles rendered as oriented ellipses heading along their
    velocity (synthesize_beam_tracking_sequence(oriented=True)), decoded
    top-4 with the wide-yaw asset and tracked in the PHYSICAL frame —
    the constant-velocity motion model holds for physical positions, not
    orbit tuples, and feeding the tracker orbit centers would let a yaw
    estimation error masquerade as motion."""
    from tpufusion.data.synthetic import synthesize_beam_tracking_sequence
    from tpufusion.eval.scoring import orbit_to_physical, score_multi_poses
    from tpufusion.serve.tracker import PoseTracker, track_quality_metrics

    asset = "synthetic_detector_yaw.npz"
    mcfg, state, dcfg, _ = _asset(asset)
    fn = make_e2e_step(mcfg, SPEC, dcfg, max_obstacles=4, head=mcfg.head)
    seq_pts, seq_gt, seq_valid = synthesize_beam_tracking_sequence(
        jax.random.PRNGKey(88), frames, 32768, n_vehicles=2,
        oriented=True,
    )
    p, fd = fn(state, seq_pts, seq_valid)
    pp = orbit_to_physical(np.asarray(p))  # (F, K, 7) physical
    trails = PoseTracker(dt=0.1).run_multi(pp, np.asarray(fd))
    gt_pose = np.concatenate(
        [
            np.asarray(seq_gt["center"]),
            np.asarray(seq_gt["yaw"])[..., None],
            np.asarray(seq_gt["size"]),
        ],
        axis=-1,
    )  # (F, V, 7) orbit tuples
    phys_c = orbit_to_physical(gt_pose)[..., :3]
    quality = track_quality_metrics(trails, phys_c)
    box_scores = score_multi_poses(
        np.asarray(p), np.asarray(fd),
        np.asarray(seq_gt["center"]), np.asarray(seq_gt["yaw"]),
        np.asarray(seq_gt["size"]), pose_frame="orbit",
    )
    return {
        "asset": asset,
        "vehicles_tracked": (
            f"{quality['vehicles_tracked']}/{quality['vehicles_total']}"
        ),
        "spurious_tracks": quality["spurious_tracks"],
        "id_switches": quality["id_switches"],
        "fragmentation": quality["fragmentation"],
        "track_coverage": quality["coverage"],
        **box_scores,
    }


CONFIGS = {
    1: config1_single_frame,
    2: config2_replay,
    3: config3_fused,
    4: config4_full_eval,
    5: config5_waymo_scale,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    args = ap.parse_args(argv)
    enable_compile_cache()
    require_gpu()
    device = device_record()
    for c in [int(x) for x in args.configs.split(",")]:
        log(f"running config {c} ...")
        print(json.dumps({**CONFIGS[c](), "device": device}), flush=True)


if __name__ == "__main__":
    main()
