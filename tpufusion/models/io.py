"""Portable single-file weight export/import (.npz) and the detector assets.

Complements the step-numbered training checkpoints (train/checkpoint.py)
with a flat single-file format for shipping small trained models as
fixtures/assets — the counterpart of the reference's shipped
`modules/lidar/data/lidar_model.h5` artifact.

Keys are the '/'-joined paths of the variables inside their collection
(`conv1/kernel`, `norm/mean`); every learned leaf (params and batch
stats) is stored, so a restored model is inference-identical.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.config import DEFAULT, PipelineConfig
from tpufusion.models.fcn import init_fcn

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
DETECTOR_ASSET = os.path.join(ASSET_DIR, "synthetic_detector.npz")
COLLECTIONS = ("params", "batch_stats")


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat: dict) -> dict:
    """{'a/b/c': leaf} -> nested dict (inverse of `flatten`)."""
    out: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def variables_to_flat(variables: dict) -> dict:
    """Both collections merged under their in-collection paths (the
    asset key space: a key names one leaf in exactly one collection)."""
    flat = {}
    for col in COLLECTIONS:
        flat.update(flatten(variables.get(col, {})))
    return flat


def flat_to_variables(flat: dict, template: dict) -> dict:
    """Inverse of `variables_to_flat`: `template` says which collection
    each key belongs to; keys, shapes and dtypes must match it."""
    want = {
        col: flatten(template.get(col, {})) for col in COLLECTIONS
    }
    keys = set().union(*want.values())
    mismatch = keys.symmetric_difference(flat)
    if mismatch:
        raise ValueError(f"state/file key mismatch: {sorted(mismatch)[:6]}")
    out = {}
    for col, leaves in want.items():
        restored = {}
        for k, ref in leaves.items():
            v = np.asarray(flat[k])
            if v.shape != ref.shape:
                raise ValueError(
                    f"{k}: stored shape {v.shape} != model shape {ref.shape}"
                )
            restored[k] = jnp.asarray(v, dtype=ref.dtype)
        out[col] = unflatten(restored)
    return out


def save_state_npz(path: str, variables: dict, dtype=None) -> None:
    """dtype (e.g. np.float16) downcasts stored arrays — load_state_npz
    casts back to the model dtype, so a float16 export halves asset size
    at ~1e-3 relative weight error (fine for shipped regressor assets)."""
    arrays = {k: np.asarray(v) for k, v in variables_to_flat(variables).items()}
    if dtype is not None:
        arrays = {
            k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in arrays.items()
        }
    np.savez_compressed(path, **arrays)


def load_state_npz(path: str, template: dict) -> dict:
    """Variables saved by save_state_npz, shaped like `template` (same
    architecture: same keys and shapes)."""
    with np.load(path) as z:
        return flat_to_variables({k: z[k] for k in z.files}, template)


def decode_for_resolution(dcfg, meta: dict | None, n_points: int):
    """Apply an asset's per-resolution operating-point overrides.

    Mixed-resolution training regularizes features but does NOT
    calibrate the classifier's confidence per resolution (measured,
    NOTES.md round 3: a 16k-point frame still fires below the 32k-tuned
    min_prob). Assets therefore ship a `decode_per_resolution` table in
    their json ({points_per_frame: {decode overrides}}, written by
    tools/tune_detector_asset --per_resolution); this picks the nearest
    calibrated resolution and overlays its overrides on the base decode
    config. No table -> dcfg unchanged."""
    table = (meta or {}).get("decode_per_resolution") or {}
    if not table:
        return dcfg
    key = min(table, key=lambda k: abs(int(k) - n_points))
    return dataclasses.replace(dcfg, **table[key])


def load_detector_asset(
    path: str = DETECTOR_ASSET,
    cfg: PipelineConfig = DEFAULT,
    meta: dict | None = None,
) -> tuple[PipelineConfig, dict, dict]:
    """A shipped detector asset -> (cfg, variables, meta).

    The asset's json carries the model variant (head / width / reg
    activation) and the decode operating point it was validated at; both
    are overlaid on `cfg`. `meta` passes an already-parsed json. Any
    failure to read or match the asset raises: nothing substitutes
    another model for it."""
    if meta is None:
        with open(path + ".json") as f:
            meta = json.load(f)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **meta.get("model", {})),
        decode=dataclasses.replace(cfg.decode, **meta.get("decode", {})),
    )
    template = init_fcn(cfg.model, jax.random.PRNGKey(0), in_channels=3)
    return cfg, load_state_npz(path, template), meta
