"""Smoke test of the main path on the GPU: the quickest proof it still runs.

Drives the fused lidar pipeline (projection -> FCN -> pose decode in one
jitted step) through the entry points a user calls, at the full 32x1801
range view with batch 64 of 32768-point beam scans and the shipped
flagship detector asset (assets/synthetic_detector.npz):

  1. `predict.make_e2e_step` on 3 seeded batches;
  2. `serve.pipeline.LidarPipeline.predict_position` on single sweeps;
  3. `serve.replay.ReplayHarness.run` over 2 chunks of 64;
  4. the corner-vote decode (`decode.decode_batch`) on the same images,
     fed the label encoding of the scenes' ground truth;
  5. 3 detector train steps (`train.train_step.make_train_step`), batch 8.

Each GPU result is compared with the same function run on the CPU under
`jax.default_matmul_precision("highest")`: `found` must agree frame for
frame, poses within TOL (centre and size in metres, yaw in radians), the
first training loss within LOSS_RTOL.

`--four-cards` runs only the multi-card path on 4 GPUs: one data=4 mesh
train step against one card, and full-width flagship inference over
data=4 and over data=2 x spatial=2 against one card.

Run: python chip_smoke.py [--four-cards]. Needs a GPU: on any other
backend it exits non-zero before printing a result. The last stdout line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import numpy as np

from tpufusion.utils.device import (
    card_description,
    device_record,
    enable_compile_cache,
    require_gpu,
)

BATCH = 64
N_POINTS = 32768
N_BATCHES = 3
TRAIN_BATCH = 8
# GPU vs CPU agreement. The float32 FCN asks for full float32 products
# (models/fcn.py), so what remains is summation order: measured on an
# H100 at most 6e-6 m and 2e-6 relative loss. The bounds leave ~100x
# margin; a TF32 or bf16 product anywhere on the path moves poses by
# centimetres and fails them.
TOL = {"center": 1e-3, "yaw": 1e-3, "size": 1e-3}
LOSS_RTOL = 1e-4


def log(*a):
    print(*a, flush=True)


def _scans(key, batch):
    from tpufusion.data.synthetic import synthesize_beam_scan_batch

    return synthesize_beam_scan_batch(key, batch, N_POINTS)


def check_poses(a_pose, a_found, b_pose, b_found, what):
    """Checks that result a (the card's) agrees with reference b: found
    frame for frame, poses within TOL. Returns the largest differences."""
    a_pose, b_pose = np.asarray(a_pose), np.asarray(b_pose)
    a_found, b_found = np.asarray(a_found), np.asarray(b_found)
    flips = int((a_found != b_found).sum())
    m = a_found & b_found
    d = np.abs(a_pose[m] - b_pose[m]) if m.any() else np.zeros((0, 7))
    yaw = np.abs((d[:, 3] + np.pi) % (2 * np.pi) - np.pi) if len(d) else d
    diff = {
        "center": float(d[:, :3].max()) if len(d) else 0.0,
        "yaw": float(yaw.max()) if len(d) else 0.0,
        "size": float(d[:, 4:7].max()) if len(d) else 0.0,
    }
    log(f"{what}: found {int(a_found.sum())}/{a_found.size} "
        f"(flips {flips}); max |diff| center {diff['center']:.2e} m, "
        f"yaw {diff['yaw']:.2e} rad, size {diff['size']:.2e} m")
    if not np.isfinite(a_pose).all():
        raise SystemExit(f"{what}: non-finite poses")
    if flips:
        raise SystemExit(f"{what}: found differs on {flips} frames")
    bad = {k: v for k, v in diff.items() if v > TOL[k]}
    if bad:
        raise SystemExit(f"{what}: beyond tolerance {TOL}: {bad}")
    return diff


def one_card(cpu) -> None:
    from tpufusion.decode.decode import decode_batch
    from tpufusion.geometry.encoding import encode_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.models.io import decode_for_resolution, load_detector_asset
    from tpufusion.predict import make_e2e_step
    from tpufusion.serve.pipeline import LidarPipeline
    from tpufusion.serve.replay import ReplayHarness

    cfg, variables, meta = load_detector_asset()
    cfg = cfg.replace(decode=decode_for_resolution(cfg.decode, meta, N_POINTS))
    spec = cfg.range_view
    log(f"asset: model {cfg.model}; decode min_prob {cfg.decode.min_prob}")
    step = make_e2e_step(cfg.model, spec, cfg.decode, cfg.projection_method,
                         head=cfg.model.head)
    scans = [_scans(jax.random.PRNGKey(100 + i), BATCH)
             for i in range(N_BATCHES)]

    # CPU reference of the same jitted step, full float32 products
    cpu_vars = jax.device_put(variables, cpu)
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = [step(cpu_vars, *jax.device_put((p, v), cpu))
               for p, _, v in scans]
    ref = [(np.asarray(p), np.asarray(f)) for p, f in ref]

    # 1. the fused e2e step on the card
    gpu = [step(variables, p, v) for p, _, v in scans]
    for i, ((gp, gf), (rp, rf)) in enumerate(zip(gpu, ref)):
        check_poses(gp, gf, rp, rf, f"e2e batch {i}")
    if not any(f.any() for _, f in ref):
        raise SystemExit("the asset found nothing in any batch")

    lowered = step.lower(variables, scans[0][0], scans[0][2])
    log(f"e2e memory_analysis: {lowered.compile().memory_analysis()}")

    # 2. the online pipeline, one sweep at a time (valid returns only)
    pipe = LidarPipeline(cfg, variables)
    pts, _, valid = scans[2]
    for j in range(4):
        sweep = np.asarray(pts[j])[np.asarray(valid[j])]
        pose, found = pipe.predict_position(sweep)
        check_poses(pose[None], np.asarray([found]), ref[2][0][j:j + 1],
                   ref[2][1][j:j + 1], f"LidarPipeline sweep {j}")

    # 3. the replay harness over 2 chunks; no-return rays become NaN,
    # which the projector drops like the validity mask does
    frames = np.concatenate([
        np.where(np.asarray(v)[..., None], np.asarray(p), np.nan)
        for p, _, v in scans[:2]
    ])
    poses, founds, stats = ReplayHarness(cfg, variables, chunk=BATCH).run(
        frames
    )
    check_poses(poses, founds, np.concatenate([r[0] for r in ref[:2]]),
               np.concatenate([r[1] for r in ref[:2]]), "ReplayHarness")
    log(f"replay: {stats.summary()}")

    # 4. the corner-vote decode on the same images
    @jax.jit
    def corner(points, valid, center, size, yaw):
        images = range_view_project_batch(points, spec, valid)
        labels = encode_label_batch(center, size, yaw, images, spec)
        out = decode_batch(labels, images, spec, cfg.decode)
        return out["pose"], out["found"]

    for i, (p, gt, v) in enumerate(scans):
        args = (p, v, gt["center"], gt["size"], gt["yaw"])
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            rp, rf = corner(*jax.device_put(args, cpu))
        gp, gf = corner(*args)
        check_poses(gp, gf, rp, rf, f"corner decode batch {i}")

    # 5. detector train steps
    train_smoke(cfg, variables, cpu)

    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def _train_step(cfg, variables):
    import optax

    from tpufusion.config import TrainConfig
    from tpufusion.train.train_step import make_train_step

    tx = optax.adam(1e-3)
    step = make_train_step(
        cfg.model, tx, cfg.range_view, cfg.loss,
        TrainConfig(batch_size=TRAIN_BATCH),
        yaw_frame=cfg.decode.direct_yaw_frame,
    )
    return step, tx.init(variables["params"])


def _train_batch(seed):
    pts, gt, valid = _scans(jax.random.PRNGKey(seed), TRAIN_BATCH)
    return {"points": pts, "valid": valid, "center": gt["center"],
            "size": gt["size"], "yaw": gt["yaw"]}


def train_smoke(cfg, variables, cpu) -> None:
    step, opt_state = _train_step(cfg, variables)
    key = jax.random.PRNGKey(0)
    first = _train_batch(7)
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        cpu_args = jax.device_put((variables, opt_state, first), cpu)
        _, _, m = step(*cpu_args, key)
        cpu_loss = float(m["loss"])
    losses = []
    v, o = variables, opt_state
    for s in range(3):
        batch = first if s == 0 else _train_batch(7 + s)
        v, o, m = step(v, o, batch, key)
        losses.append(float(m["loss"]))
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    log(f"train losses {losses}; first vs cpu {cpu_loss:.6g} "
        f"(rel {rel:.2e}, bound {LOSS_RTOL})")
    if not np.isfinite(losses).all():
        raise SystemExit("non-finite training loss")
    if rel > LOSS_RTOL:
        raise SystemExit("first training loss disagrees with the cpu")


def four_cards() -> None:
    """Data-parallel training and data x spatial inference on 4 cards,
    each compared with one card."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpufusion.config import MeshConfig, TrainConfig
    from tpufusion.models.io import decode_for_resolution, load_detector_asset
    from tpufusion.parallel.mesh import make_mesh, replicate
    from tpufusion.predict import make_e2e_step
    from tpufusion.train.train_step import make_train_step

    import optax

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {jax.devices()}")
    one = jax.devices()[0]
    cfg, variables, meta = load_detector_asset()
    cfg = cfg.replace(decode=decode_for_resolution(cfg.decode, meta, N_POINTS))
    spec = cfg.range_view

    # one train step over data=4 against the same step on one card. Plain
    # SGD keeps the update proportional to the gradient, so the two
    # updates can be compared (adam's first step is ~lr * sign(grad))
    tx = optax.sgd(1e-3)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    batch = _train_batch(7)
    key = jax.random.PRNGKey(0)
    opt_state = tx.init(variables["params"])
    single = make_train_step(cfg.model, tx, spec, cfg.loss, tcfg,
                             yaw_frame=cfg.decode.direct_yaw_frame)
    v1, _, m1 = single(*jax.device_put((variables, opt_state, batch), one),
                       key)
    mesh = make_mesh(MeshConfig(n_devices=4))
    data = NamedSharding(mesh, P(mesh.axis_names[0]))
    sharded = make_train_step(cfg.model, tx, spec, cfg.loss, tcfg, mesh=mesh,
                              yaw_frame=cfg.decode.direct_yaw_frame)
    with mesh:
        v4, _, m4 = sharded(replicate(variables, mesh),
                            replicate(opt_state, mesh),
                            jax.device_put(batch, data), key)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    p0, p1, p4 = (np.concatenate([np.ravel(x) for x in jax.tree.leaves(
        v["params"])]) for v in (variables, v1, v4))
    u1, u4 = p1 - p0, p4 - p0
    dupd = float(np.abs(u1 - u4).max() / np.abs(u1).max())
    rel = abs(l1 - l4) / abs(l1)
    log(f"train step data=4: loss {l4:.6g} vs one card {l1:.6g} "
        f"(rel {rel:.2e}); max |update diff| / max |update| {dupd:.2e}")
    if not np.isfinite(l4) or rel > 1e-3 or dupd > 5e-2:
        raise SystemExit("data-parallel train step disagrees with one card")

    # full-width flagship inference: one card, data=4, data=2 x spatial=2
    pts, _, valid = _scans(jax.random.PRNGKey(100), BATCH)
    base = make_e2e_step(cfg.model, spec, cfg.decode, head=cfg.model.head)
    ref = base(*jax.device_put((variables, pts, valid), one))
    for n_spatial in (1, 2):
        mesh = make_mesh(MeshConfig(n_devices=4, n_spatial=n_spatial))
        data = NamedSharding(mesh, P(mesh.axis_names[0]))
        fn = make_e2e_step(cfg.model, spec, cfg.decode, head=cfg.model.head,
                           mesh=mesh)
        with mesh:
            out = fn(replicate(variables, mesh), jax.device_put(pts, data),
                     jax.device_put(valid, data))
        shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        check_poses(*out, *ref, f"e2e over {shape} vs one card")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path")
    args = ap.parse_args(argv)

    cache = enable_compile_cache()
    require_gpu()
    log(card_description())
    log(f"devices: {jax.devices()}")
    log(f"compile cache: {cache}")
    if args.four_cards:
        four_cards()
    else:
        one_card(jax.devices("cpu")[0])
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
