"""Camera + lidar + radar late-fusion pose regressor.

Rebuilds the fusion net of `modules/lidar/train/train_fcn.py:258-315`
(which is drift-broken in the reference — it imports symbols and calls
signatures that no longer exist, train_fcn.py:17,362-405; fixed here):

  * per-branch: the FCN's pre-softmax deconv6a feature map (camera branch
    max-pooled (4, 1) first) -> flatten -> dropout 0.2 -> dense 96 relu ->
    dense 48 relu
  * concat(cam48, lidar48, radar[range, angle])
  * two 2-path elu heads -> centroid (3) and yaw rz (1)
  * MSE loss; sub-network freezing by top-level parameter group.

Variables follow models/fcn.py: `{"params": ..., "batch_stats": ...}`
keyed `lidar_fcn/conv1/kernel`, `cam_branch/dense1/kernel`, ...
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from tpufusion.config import CameraConfig, ModelConfig
from tpufusion.models.fcn import fcn_features, init_fcn, uniform_init

_DROPOUT = 0.2
GROUPS = ("lidar_fcn", "camera_fcn", "cam_branch", "lidar_branch",
          "centroid_head", "rz_head")


@dataclass(frozen=True)
class FusionConfig:
    """lidar_pool / cam_pool: (ph, pw) max-pools over the branch feature
    maps before their dense layers. The reference pools the camera (4, 1)
    and flattens the raw 32x1801x2 lidar map into an ~11M-parameter Dense
    (train_fcn.py:258-272 — a net it never shipped weights for);
    lidar_pool (2, 8) + cam_pool (8, 8) cut the branches to ~2.8M params
    total so a trained full-camera-scale fusion asset is small enough to
    ship in-repo. The defaults keep the reference-faithful geometry."""

    lidar_model: ModelConfig = ModelConfig()
    camera_model: ModelConfig = ModelConfig(
        vertical_stride=2, use_regression=False
    )
    camera: CameraConfig = CameraConfig()
    lidar_hw: tuple[int, int] = (32, 1801)
    lidar_pool: tuple[int, int] | None = None
    cam_pool: tuple[int, int] = (4, 1)


def _dense(key, fin, fout, kernel_init=uniform_init):
    return {"kernel": kernel_init(key, (fin, fout)),
            "bias": jnp.zeros((fout,), jnp.float32)}


def _lecun_normal(key, shape):
    return jax.nn.initializers.lecun_normal()(key, shape, jnp.float32)


def init_fusion(fcfg: FusionConfig, key: jax.Array) -> dict:
    cam = fcfg.camera
    cp, lp = fcfg.cam_pool, fcfg.lidar_pool
    cam_flat = (cam.height // cp[0]) * (cam.width // cp[1]) * 2
    lh, lw = fcfg.lidar_hw
    if lp is not None:
        lh, lw = lh // lp[0], lw // lp[1]
    lidar_flat = lh * lw * 2
    k = iter(jax.random.split(key, 12))
    lidar = init_fcn(fcfg.lidar_model, next(k), in_channels=3)
    camera = init_fcn(fcfg.camera_model, next(k), in_channels=cam.channels)

    def branch(fin):
        return {"dense1": _dense(next(k), fin, 96),
                "dense2": _dense(next(k), 96, 48)}

    def head(out):
        fin = 48 + 48 + 4
        return {"a": _dense(next(k), fin, out),
                "b": _dense(next(k), fin, out),
                "out": _dense(next(k), 2 * out, out, _lecun_normal)}

    params = {
        "lidar_fcn": lidar["params"],
        "camera_fcn": camera["params"],
        "cam_branch": branch(cam_flat),
        "lidar_branch": branch(lidar_flat),
        "centroid_head": head(3),
        "rz_head": head(1),
    }
    stats = {"lidar_fcn": lidar["batch_stats"],
             "camera_fcn": camera["batch_stats"]}
    return {"params": params, "batch_stats": stats}


def _linear(p, x):
    return x @ p["kernel"] + p["bias"]


def _dropout(key, x):
    keep = jax.random.bernoulli(key, 1.0 - _DROPOUT, x.shape)
    return jnp.where(keep, x / (1.0 - _DROPOUT), 0.0)


def _branch(p, x, key):
    x = x.reshape(x.shape[0], -1)
    if key is not None:
        k1, k2 = jax.random.split(key)
        x = _dropout(k1, x)
    x = jax.nn.relu(_linear(p["dense1"], x))
    if key is not None:
        x = _dropout(k2, x)
    return jax.nn.relu(_linear(p["dense2"], x))


def _two_path_head(p, x):
    a = jax.nn.elu(_linear(p["a"], x))
    b = jax.nn.elu(_linear(p["b"], x))
    return _linear(p["out"], jnp.concatenate([a, b], axis=-1))


def _max_pool(x, window):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, *window, 1), (1, *window, 1), "VALID"
    )


def apply_fusion(
    fcfg: FusionConfig,
    variables: dict,
    cam_img: jax.Array,
    lidar_img: jax.Array,
    radar: jax.Array,
    train: bool = False,
    dropout_key: jax.Array | None = None,
):
    """cam_img (B,Hc,Wc,1), lidar_img (B,32,1801,3), radar (B,2)
    -> ((centroid (B,3), rz (B,1)), new batch stats). `train` uses and
    updates the FCNs' batch statistics; `dropout_key` turns the branch
    dropout on."""
    p, s = variables["params"], variables["batch_stats"]
    cam_feat, cam_stats = fcn_features(
        fcfg.camera_model,
        {"params": p["camera_fcn"], "batch_stats": s["camera_fcn"]},
        cam_img, train,
    )
    lidar_feat, lidar_stats = fcn_features(
        fcfg.lidar_model,
        {"params": p["lidar_fcn"], "batch_stats": s["lidar_fcn"]},
        lidar_img, train,
    )
    cam_feat = _max_pool(cam_feat, fcfg.cam_pool)
    if fcfg.lidar_pool is not None:
        lidar_feat = _max_pool(lidar_feat, fcfg.lidar_pool)
    kc = kl = None
    if dropout_key is not None:
        kc, kl = jax.random.split(dropout_key)
    c = _branch(p["cam_branch"], cam_feat, kc)
    l = _branch(p["lidar_branch"], lidar_feat, kl)
    # radar reaches the heads in BOTH frames: the reference fed raw
    # (range, angle) only (train_fcn.py:300-307), forcing the tiny elu
    # heads to learn the polar->cartesian transform the target lives
    # in; deriving r*cos(a), r*sin(a) here makes the radar->centroid
    # mapping near-linear (framework extension, A/B'd in BASELINE.md)
    radar = radar.astype(jnp.float32)
    r, a = radar[..., 0:1], radar[..., 1:2]
    radar_feats = jnp.concatenate(
        [r, a, r * jnp.cos(a), r * jnp.sin(a)], axis=-1
    )
    x = jnp.concatenate([c, l, radar_feats], axis=-1)
    out = (_two_path_head(p["centroid_head"], x),
           _two_path_head(p["rz_head"], x))
    return out, {"lidar_fcn": lidar_stats, "camera_fcn": cam_stats}


def fusion_loss(outputs, targets) -> jax.Array:
    """MSE over both heads (train_fcn.py:309-310)."""
    centroid, rz = outputs
    t_centroid, t_rz = targets
    return jnp.mean((centroid - t_centroid) ** 2) + jnp.mean((rz - t_rz) ** 2)


def trainable_groups(lock_lidar: bool = False, lock_camera: bool = False):
    """Top-level parameter groups that train; mirrors the layer freezing
    by name in train_fcn.py:303-307."""
    locked = {"lidar_fcn": lock_lidar, "camera_fcn": lock_camera}
    return tuple(g for g in GROUPS if not locked.get(g, False))
