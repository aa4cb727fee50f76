"""Fully convolutional segmentation + corner-regression network.

Same layer geometry as the reference Keras model (`modules/lidar/train/
model.py:93-192`), written as plain JAX functions over a nested dict of
arrays:

  input (H, W, C)
    -> feature-wise BatchNorm
    -> zero-pad width (0, 3)                 # 1801 -> 1804 so /4 divides
    -> conv1  4ch 5x5 stride (vs, 4) relu    # -> W/4
    -> conv2  6ch 5x5 stride (vs, 2) relu    # -> W/8
    -> conv3 12ch 5x5 stride (vs, 2) relu    # -> W/16
    -> deconv4 16ch stride (vs, 2) relu, concat conv2
    -> heads:
       cls: deconv5a 8ch (vs,2) relu -> crop left 1 -> concat conv1
            -> deconv6a 2ch (vs,4) linear -> crop right 3
            -> softmax -> clip(eps, 1)
       reg: deconv5b/6b mirror with 24 channels, relu outputs

vs = 1 for lidar (32 rows preserved), 2 for camera.

Output: (B, H, W, 2 + 24) — classification probabilities then corner
offsets — matching the reference's concatenated output tensor
(`model.py:183`) so one loss handles both heads.

Variables are `{"params": {...}, "batch_stats": {...}}`. Within each
collection the tree is keyed by layer then leaf (`conv1/kernel`,
`norm/mean`), so the `/`-joined paths are the keys of the shipped
`assets/*.npz` weight files (models/io.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpufusion.config import ModelConfig

_KERAS_EPSILON = 1e-7
_BN_EPSILON = 1e-3
_BN_MOMENTUM = 0.99
_KERNEL = (5, 5)
_DIMS = ("NHWC", "HWIO", "NHWC")


def uniform_init(key, shape, scale: float = 0.05):
    """keras kernel_initializer='random_uniform' is U(-0.05, 0.05)."""
    return jax.random.uniform(key, shape, jnp.float32, -scale, scale)


def num_reg_channels(cfg: ModelConfig) -> int:
    from tpufusion.geometry.encoding import (
        DIRECT_CHANNELS,
        DIRECT_CHANNELS_DUAL,
    )

    if cfg.head == "corner":
        return cfg.num_corner_outputs
    if cfg.yaw_codec == "dual":
        return DIRECT_CHANNELS_DUAL
    return DIRECT_CHANNELS


def _layer_shapes(cfg: ModelConfig, in_channels: int):
    """(name, in channels, out channels) of every conv layer."""
    wm = cfg.width_multiplier
    layers = [
        ("conv1", in_channels, 4 * wm),
        ("conv2", 4 * wm, 6 * wm),
        ("conv3", 6 * wm, 12 * wm),
        ("deconv4", 12 * wm, 16 * wm),
        ("deconv5a", 22 * wm, 8 * wm),
        ("deconv6a", 12 * wm, 2),
    ]
    if cfg.use_regression:
        nreg = num_reg_channels(cfg)
        layers += [
            ("deconv5b", 22 * wm, nreg),
            ("deconv6b", 4 * wm + nreg, nreg),
        ]
    return layers


def init_fcn(
    cfg: ModelConfig,
    key: jax.Array,
    in_channels: int = 3,
    image_hw: tuple[int, int] | None = None,
) -> dict:
    """Random variables for `apply_fcn`: conv kernels U(-0.05, 0.05), zero
    biases, identity normalization. `image_hw` sizes the per-position
    statistics of the sample-wise BN (cfg.sample_wise_bn)."""
    params, stats = {}, {}
    if cfg.sample_wise_bn:
        if image_hw is None:
            raise ValueError("sample_wise_bn needs image_hw")
        n = image_hw[0] * image_hw[1]
    elif cfg.batch_norm:
        n = in_channels
    if cfg.sample_wise_bn or cfg.batch_norm:
        params["norm"] = {"scale": jnp.ones((n,), jnp.float32),
                          "bias": jnp.zeros((n,), jnp.float32)}
        stats["norm"] = {"mean": jnp.zeros((n,), jnp.float32),
                         "var": jnp.ones((n,), jnp.float32)}
    layers = _layer_shapes(cfg, in_channels)
    for k, (name, cin, cout) in zip(
        jax.random.split(key, len(layers)), layers
    ):
        params[name] = {"kernel": uniform_init(k, (*_KERNEL, cin, cout)),
                        "bias": jnp.zeros((cout,), jnp.float32)}
    return {"params": params, "batch_stats": stats}


def normalize(cfg, params, stats, x, train):
    """Input normalization. Feature-wise BN normalizes per channel;
    the sample-wise flavor (the reference's USE_SAMPLE_WISE_BATCH_
    NORMALIZATION path, `model.py:110-113`) reshapes to (B, H*W, C) and
    keeps one statistic per pixel position, shared across channels — the
    shipped lidar_model.h5 carries it (57632-long normalize params).
    Training normalizes with the batch's statistics and folds them into
    the running averages like Keras; inference uses the running ones."""
    b, h, w, c = x.shape
    sample_wise = cfg.sample_wise_bn
    y = x.reshape(b, h * w, c) if sample_wise else x
    axes = (0, 2) if sample_wise else (0, 1, 2)
    if train:
        if sample_wise:
            mean, var = jnp.mean(y, axis=axes), jnp.var(y, axis=axes)
        else:
            mean = jnp.mean(y, axis=axes)
            var = jnp.maximum(0.0, jnp.mean(y * y, axis=axes) - mean * mean)
        m = _BN_MOMENTUM
        stats = {
            "mean": jax.lax.stop_gradient(m * stats["mean"] + (1 - m) * mean),
            "var": jax.lax.stop_gradient(m * stats["var"] + (1 - m) * var),
        }
    else:
        mean, var = stats["mean"], stats["var"]
    shape = (1, -1, 1) if sample_wise else (1, 1, 1, -1)
    if sample_wise:
        y = (y - mean.reshape(shape)) * jax.lax.rsqrt(
            var.reshape(shape) + _BN_EPSILON
        )
        y = y * params["scale"].reshape(shape) + params["bias"].reshape(shape)
    else:
        mul = jax.lax.rsqrt(var + _BN_EPSILON) * params["scale"]
        y = (y - mean.reshape(shape)) * mul.reshape(shape)
        y = y + params["bias"].reshape(shape)
    return y.reshape(b, h, w, c), stats


def _precision(dtype):
    """float32 convs ask for full float32 products: by default the GPU
    runs them in TF32 (10-bit mantissa), which moved decoded poses of
    the float32 flagship asset by up to 0.12 m against the CPU. A
    bfloat16 stack keeps the default."""
    if jnp.dtype(dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return None


def conv(layer, x, strides, dtype=jnp.float32, padding="SAME"):
    """5x5 NHWC conv with an HWIO kernel, computed in `dtype`."""
    kernel, bias = layer["kernel"].astype(dtype), layer["bias"].astype(dtype)
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), kernel, strides, padding, dimension_numbers=_DIMS,
        precision=_precision(dtype),
    )
    return y + bias


def deconv(layer, x, strides, dtype=jnp.float32, padding="SAME"):
    """Fractionally-strided conv (lax.conv_transpose, kernel not
    transposed) with an (kh, kw, in, out) kernel, computed in `dtype`."""
    kernel, bias = layer["kernel"].astype(dtype), layer["bias"].astype(dtype)
    y = jax.lax.conv_transpose(
        x.astype(dtype), kernel, strides, padding, dimension_numbers=_DIMS,
        precision=_precision(dtype),
    )
    return y + bias


def _trunk(cfg: ModelConfig, variables: dict, x: jax.Array, train: bool):
    """Shared encoder + deconv6a head. Crops are derived from the input
    width so both the lidar (1801 -> crop 3) and camera (1368 -> crop 4)
    geometries come out right, like the per-source Cropping2D choices at
    model.py:132-141. Returns (d6a, skip tensors, new batch stats)."""
    p = variables["params"]
    stats = variables["batch_stats"]
    vs = cfg.vertical_stride
    dtype = jnp.dtype(cfg.dtype)
    w = x.shape[2]
    if cfg.batch_norm or cfg.sample_wise_bn:
        x, norm_stats = normalize(cfg, p["norm"], stats["norm"], x, train)
        stats = {**stats, "norm": norm_stats}
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 3), (0, 0)))

    relu = jax.nn.relu
    c1 = relu(conv(p["conv1"], x, (vs, 4), dtype))
    c2 = relu(conv(p["conv2"], c1, (vs, 2), dtype))
    c3 = relu(conv(p["conv3"], c2, (vs, 2), dtype))
    d4 = relu(deconv(p["deconv4"], c3, (vs, 2), dtype))
    cat4 = jnp.concatenate([c2, d4], axis=-1)

    # 1 when conv1's width is odd; slicing the last deconv to w performs
    # the right-hand crop (3 for lidar, 4 for camera)
    crop5 = 2 * c2.shape[2] - c1.shape[2]
    d5a = relu(deconv(p["deconv5a"], cat4, (vs, 2), dtype))[:, :, crop5:, :]
    cat5a = jnp.concatenate([c1, d5a], axis=-1)
    d6a = deconv(p["deconv6a"], cat5a, (vs, 4), dtype)[:, :, :w, :]
    return d6a, (c1, cat4, crop5, w), stats


def apply_fcn(
    cfg: ModelConfig, variables: dict, x: jax.Array, train: bool = False
) -> tuple[jax.Array, dict]:
    """(B, H, W, C) images -> ((B, H, W, 2 [+ reg]) predictions, new batch
    stats). The batch stats come back unchanged unless `train`."""
    vs = cfg.vertical_stride
    dtype = jnp.dtype(cfg.dtype)
    d6a, (c1, cat4, crop5, w), stats = _trunk(cfg, variables, x, train)
    probs = jax.nn.softmax(d6a.astype(jnp.float32), axis=-1)
    probs = jnp.clip(probs, _KERAS_EPSILON, 1.0)

    if not cfg.use_regression:
        return probs, stats

    p = variables["params"]
    d5b = jax.nn.relu(deconv(p["deconv5b"], cat4, (vs, 2), dtype))
    cat5b = jnp.concatenate([c1, d5b[:, :, crop5:, :]], axis=-1)
    d6b = deconv(p["deconv6b"], cat5b, (vs, 4), dtype)[:, :, :w, :]
    if cfg.head == "corner" and cfg.reg_output_activation == "relu":
        d6b = jax.nn.relu(d6b)  # reference-compat; see ModelConfig
        # ("direct" targets are signed — always linear)
    return jnp.concatenate([probs, d6b.astype(jnp.float32)], axis=-1), stats


def fcn_features(
    cfg: ModelConfig, variables: dict, x: jax.Array, train: bool = False
) -> tuple[jax.Array, dict]:
    """Pre-softmax deconv6a feature map, the tap the fusion net consumes
    (`modules/lidar/train/train_fcn.py:371-395`), and the new batch
    stats."""
    d6a, _, stats = _trunk(cfg, variables, x, train)
    return d6a, stats
