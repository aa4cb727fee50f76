"""Import the reference's shipped Keras weights as tpufusion variables.

The reference ships a trained classification model
(`modules/lidar/data/lidar_model.h5`, Keras 2.0.4): sample-wise BN +
conv1..3 + deconv4/5a/6a. This loader reads those weights into the
variables of `apply_shipped_fcn`, the shipped network's exact graph, so
users can run the original detector on this framework's device path.

Kernel conventions:
  * Conv2D: Keras (kh, kw, in, out) == models/fcn.conv's HWIO — copied.
  * Conv2DTranspose: Keras stores (kh, kw, out, in) and computes the
    GRADIENT of a strided conv; models/fcn.deconv (lax.conv_transpose,
    kernel not transposed) computes a fractionally-strided conv with
    (kh, kw, in, out). The two agree iff the Keras kernel is spatially
    flipped and its channel axes swapped — verified against jax's own
    conv VJP in tests/test_keras_import.py.

h5py is imported only when a file is read.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpufusion.config import ModelConfig
from tpufusion.models.fcn import conv, deconv, normalize

# the shipped graph's input normalization: one statistic per pixel
_SAMPLE_WISE = ModelConfig(sample_wise_bn=True, batch_norm=False)


def keras_deconv_kernel(kernel: np.ndarray) -> np.ndarray:
    """(kh, kw, out, in) gradient-conv kernel -> (kh, kw, in, out) for
    models/fcn.deconv."""
    return kernel[::-1, ::-1].transpose(0, 1, 3, 2).copy()


def _weights_of(f, layer: str) -> dict[str, np.ndarray]:
    import h5py

    out = {}

    def visit(name, item):
        if isinstance(item, h5py.Dataset):
            out[name.split("/")[-1].split(":")[0]] = np.asarray(item)

    f[layer].visititems(visit)
    return out


def apply_shipped_fcn(variables: dict, x: jax.Array) -> jax.Array:
    """The EXACT graph of the shipped `lidar_model.h5` (wiring dumped from
    `lidar_model.json`), inference only: sample-wise BN -> zero-pad width
    (0,3) -> conv1 4ch 5x5 s(2,4) SAME -> conv2 6ch s(2,2) VALID -> conv3
    12ch s(2,2) VALID -> deconv4 16ch s(2,2) VALID, pad ((1,0),(0,1)),
    concat conv2 -> deconv5a 8ch s(2,2) VALID, pad ((1,0),(0,0)), concat
    conv1 -> deconv6a 2ch s(2,4) SAME -> crop width 3 -> softmax -> clip.

    Note this is an OLDER architecture than the reference's current
    model.py (which uses vertical stride 1 and SAME padding everywhere,
    `model.py:104-148`); the shipped artifact predates that code. Golden
    activation equivalence vs a pure-numpy h5 forward is asserted in
    tests/test_keras_import.py."""
    p = variables["params"]
    relu = jax.nn.relu
    w = x.shape[2]
    x, _ = normalize(_SAMPLE_WISE, p["norm"], variables["batch_stats"]["norm"],
                     x, train=False)
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 3), (0, 0)))
    c1 = relu(conv(p["conv1"], x, (2, 4)))
    c2 = relu(conv(p["conv2"], c1, (2, 2), padding="VALID"))
    c3 = relu(conv(p["conv3"], c2, (2, 2), padding="VALID"))
    d4 = relu(deconv(p["deconv4"], c3, (2, 2), padding="VALID"))
    d4 = jnp.pad(d4, ((0, 0), (1, 0), (0, 1), (0, 0)))
    d5 = relu(deconv(p["deconv5a"], jnp.concatenate([c2, d4], axis=-1),
                     (2, 2), padding="VALID"))
    d5 = jnp.pad(d5, ((0, 0), (1, 0), (0, 0), (0, 0)))
    d6 = deconv(p["deconv6a"], jnp.concatenate([c1, d5], axis=-1), (2, 4))
    probs = jax.nn.softmax(d6[:, :, :w, :].astype(jnp.float32), axis=-1)
    return jnp.clip(probs, 1e-7, 1.0)


def load_reference_fcn(
    h5_path: str, image_hw: tuple[int, int] = (32, 1801)
) -> dict:
    """The shipped weights as variables for `apply_shipped_fcn`.

    (An earlier revision mapped these weights onto the current-model.py
    FCN geometry — same parameter shapes, different strides/padding — so
    the loaded net computed different activations than the shipped one;
    the golden test against tests/oracle/keras_numpy.py now pins this.)"""
    import h5py

    with h5py.File(h5_path, "r") as f:
        layers = set()
        f.visit(lambda n: layers.add(n.split("/")[0]))
        if "deconv5b" in layers:
            raise ValueError(
                "regression-head h5 is not the shipped artifact layout"
            )
        norm_w = _weights_of(f, "normalize")
        if norm_w["gamma"].size != image_hw[0] * image_hw[1]:
            raise ValueError(
                f"normalize has {norm_w['gamma'].size} positions, expected "
                f"{image_hw[0] * image_hw[1]} (sample-wise BN)"
            )
        params = {"norm": {"scale": jnp.asarray(norm_w["gamma"]),
                           "bias": jnp.asarray(norm_w["beta"])}}
        stats = {"norm": {"mean": jnp.asarray(norm_w["moving_mean"]),
                          "var": jnp.asarray(norm_w["moving_variance"])}}
        for name in ("conv1", "conv2", "conv3"):
            w = _weights_of(f, name)
            params[name] = {"kernel": jnp.asarray(w["kernel"]),
                            "bias": jnp.asarray(w["bias"])}
        for name in ("deconv4", "deconv5a", "deconv6a"):
            w = _weights_of(f, name)
            params[name] = {
                "kernel": jnp.asarray(keras_deconv_kernel(w["kernel"])),
                "bias": jnp.asarray(w["bias"]),
            }
    return {"params": params, "batch_stats": stats}
