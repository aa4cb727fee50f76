"""Oracle-sensitivity A/B for the surface-fit decode.

The round-3 fit decode parameterized the exact boundary family the
scene simulator renders, making the accuracy headline partly
self-referential. This tool measures how much of the fit's gain is
geometry vs generator knowledge, on BOX scenes — the one family whose
rendered surface (true l x w rectangle, slab-method ray entry,
`data/synthetic.py::_raycast_scene` vehicle_surface='box') shares NO
inset/scale constant with any fit boundary:

  box       — rectangle-outline fit: matched GEOMETRY (what real
              vehicle scans look like; the reference's own decode
              derives pose from a rectangle model,
              `modules/lidar/train/predict.py:166-197`) but zero
              generator constants
  ellipse   — deliberately MISMATCHED boundary family
  circle    — deliberately mismatched + orientation-blind
  consensus — no boundary model at all (the oracle-free floor)

If box >> {ellipse, circle} ~ consensus, the fit's value is the
geometry model matching the actual surface, not leaked constants.

Run: python -m tpufusion.tools.fit_oracle_sensitivity \
        [--asset .../synthetic_detector_mixed.npz] [--scenes beam-box]
Prints one row per decode mode + a JSON summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from tpufusion.config import DEFAULT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--asset", default=None,
                    help="detector asset npz (default: shipped flagship)")
    ap.add_argument("--scenes", default="beam-box",
                    choices=("beam", "beam-ellipse", "beam-box"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--max_yaw", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=999)
    args = ap.parse_args(argv)

    from tpufusion.models.io import DETECTOR_ASSET, load_detector_asset
    from tpufusion.tools.train_synthetic_detector import (
        evaluate,
        prepare_eval_batches,
    )

    cfg, variables, _ = load_detector_asset(args.asset or DETECTOR_ASSET)
    model_cfg, dcfg, head = cfg.model, cfg.decode, cfg.model.head
    if head != "direct":
        raise SystemExit(f"needs a direct-pose asset, got head={head!r}")
    spec = DEFAULT.range_view

    # forward pass once; every decode mode reuses the prepared batches
    prepared = prepare_eval_batches(
        model_cfg, variables, spec, args.batch, seed=args.seed,
        max_yaw=args.max_yaw, scenes=args.scenes,
        n_batches=args.eval_batches,
    )

    # fit_surface_scale=1.0 for explicit arms: the rendered box IS the
    # true l x w footprint (no inset); the mismatched families get the
    # same no-inset treatment so the ONLY difference is boundary shape
    modes = {
        "fit:box": dataclasses.replace(
            dcfg, direct_center="fit", fit_boundary="box",
            fit_surface_scale=1.0),
        "fit:ellipse": dataclasses.replace(
            dcfg, direct_center="fit", fit_boundary="ellipse",
            fit_surface_scale=1.0),
        "fit:circle": dataclasses.replace(
            dcfg, direct_center="fit", fit_boundary="circle",
            fit_surface_scale=1.0),
        "consensus": dataclasses.replace(dcfg, direct_center="consensus"),
    }
    rows = {}
    for name, cfg_m in modes.items():
        ev = evaluate(
            model_cfg, variables, spec, cfg_m, args.batch, seed=args.seed,
            max_yaw=args.max_yaw, head="direct", scenes=args.scenes,
            center=cfg_m.direct_center, n_batches=args.eval_batches,
            prepared=prepared,
        )
        rows[name] = {k: round(float(ev[k]), 4)
                      for k in ("det", "mean_iou", "recall_iou25",
                                "xy_err", "yaw_err")}
        print(f"{name:<12} det {ev['det']:.2f} iou {ev['mean_iou']:.3f} "
              f"r25 {ev['recall_iou25']:.2f} xy {ev['xy_err']:.2f} "
              f"yaw {ev['yaw_err']:.3f}", flush=True)

    print(json.dumps({
        "probe": "fit_oracle_sensitivity",
        "scenes": args.scenes,
        "max_yaw": args.max_yaw,
        "frames": args.batch * args.eval_batches,
        "rows": rows,
    }))
    return rows


if __name__ == "__main__":
    main()
