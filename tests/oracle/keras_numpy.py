"""Pure-numpy forward of the reference's shipped Keras model.

Independent restatement of the exact graph recorded in
`/root/reference/modules/lidar/data/lidar_model.json` (Keras 2.0.4),
reading weights straight from `lidar_model.h5` — no TF needed. Used as
the golden oracle for tools/import_keras.load_reference_fcn: if the
imported model and this forward agree on random inputs, the import
reproduces the shipped network's activations, not just its weights.

Graph (layer wiring dumped from the json):
    input (32, 1801, 3)
    -> flatten to (57632, 3) -> BatchNorm(axis=1) -> unflatten
       (one statistic per pixel position, eps 1e-3)
    -> ZeroPad width (0, 3)
    -> conv1 4ch 5x5 stride (2, 4) SAME relu
    -> conv2 6ch 5x5 stride (2, 2) VALID relu
    -> conv3 12ch 5x5 stride (2, 2) VALID relu
    -> deconv4 16ch 5x5 stride (2, 2) VALID relu -> pad ((1,0),(0,1))
    -> concat(conv2, .) -> deconv5a 8ch (2,2) VALID relu -> pad ((1,0),(0,0))
    -> concat(conv1, .) -> deconv6a 2ch (2,4) SAME linear
    -> crop width (0, 3) -> softmax -> clip(1e-7, 1)

Keras Conv2DTranspose kernels are stored (kh, kw, out, in) and compute
the gradient of a strided conv — implemented here as the explicit
scatter: out[i*s+di, j*s+dj, o] += x[i, j, c] * W[di, dj, o, c].
"""

from __future__ import annotations

import h5py
import numpy as np

EPSILON = 1e-7


def _weights(f: h5py.File, layer: str) -> dict[str, np.ndarray]:
    out = {}

    def visit(name, item):
        if isinstance(item, h5py.Dataset):
            out[name.split("/")[-1].split(":")[0]] = np.asarray(item)

    f[layer].visititems(visit)
    return out


def conv2d(x, w, b, strides, padding):
    """x (H, W, Cin), w (kh, kw, Cin, Cout). TF padding semantics."""
    kh, kw, cin, cout = w.shape
    sh, sw = strides
    h, w_in = x.shape[:2]
    if padding == "same":
        oh = -(-h // sh)
        ow = -(-w_in // sw)
        pad_h = max((oh - 1) * sh + kh - h, 0)
        pad_w = max((ow - 1) * sw + kw - w_in, 0)
        x = np.pad(
            x,
            (
                (pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2),
                (0, 0),
            ),
        )
        h, w_in = x.shape[:2]
    else:
        oh = (h - kh) // sh + 1
        ow = (w_in - kw) // sw + 1
    out = np.zeros((oh, ow, cout), np.float32)
    for di in range(kh):
        for dj in range(kw):
            patch = x[di : di + (oh - 1) * sh + 1 : sh,
                      dj : dj + (ow - 1) * sw + 1 : sw]
            out += patch @ w[di, dj]
    return out + b


def conv2d_transpose(x, w, b, strides, padding):
    """x (H, W, Cin), Keras kernel w (kh, kw, Cout, Cin) — gradient-of-conv
    scatter. VALID: out = (in-1)*s + k. SAME: out = in*s, cropped by
    (k - s) // 2 at top/left (TF's conv2d_transpose alignment)."""
    kh, kw, cout, cin = w.shape
    sh, sw = strides
    h, w_in = x.shape[:2]
    fh, fw = (h - 1) * sh + kh, (w_in - 1) * sw + kw
    full = np.zeros((fh, fw, cout), np.float32)
    # one scatter per kernel tap, vectorized over all input pixels
    for di in range(kh):
        for dj in range(kw):
            full[di : di + (h - 1) * sh + 1 : sh,
                 dj : dj + (w_in - 1) * sw + 1 : sw] += x @ w[di, dj].T
    if padding == "same":
        ph = max(kh - sh, 0) // 2
        pw = max(kw - sw, 0) // 2
        full = full[ph : ph + h * sh, pw : pw + w_in * sw]
    return full + b


def relu(x):
    return np.maximum(x, 0.0)


def shipped_model_forward(h5_path: str, x: np.ndarray) -> np.ndarray:
    """x (B, 32, 1801, 3) -> class probabilities (B, 32, 1801, 2)."""
    x = np.asarray(x, np.float32)
    b, h, w_in, c = x.shape
    with h5py.File(h5_path, "r") as f:
        norm = _weights(f, "normalize")
        ws = {
            name: _weights(f, name)
            for name in ("conv1", "conv2", "conv3",
                         "deconv4", "deconv5a", "deconv6a")
        }

    # sample-wise BN: one (gamma, beta, mean, var) per pixel position,
    # shared across channels
    flat = x.reshape(b, h * w_in, c)
    inv = 1.0 / np.sqrt(norm["moving_variance"] + 1e-3)
    flat = (flat - norm["moving_mean"][None, :, None]) * inv[None, :, None]
    flat = flat * norm["gamma"][None, :, None] + norm["beta"][None, :, None]
    x = flat.reshape(b, h, w_in, c)

    out = np.zeros((b, h, w_in, 2), np.float32)
    for i in range(b):
        xi = np.pad(x[i], ((0, 0), (0, 3), (0, 0)))
        c1 = relu(conv2d(xi, ws["conv1"]["kernel"], ws["conv1"]["bias"],
                         (2, 4), "same"))
        c2 = relu(conv2d(c1, ws["conv2"]["kernel"], ws["conv2"]["bias"],
                         (2, 2), "valid"))
        c3 = relu(conv2d(c2, ws["conv3"]["kernel"], ws["conv3"]["bias"],
                         (2, 2), "valid"))
        d4 = relu(conv2d_transpose(c3, ws["deconv4"]["kernel"],
                                   ws["deconv4"]["bias"], (2, 2), "valid"))
        d4 = np.pad(d4, ((1, 0), (0, 1), (0, 0)))
        cat4 = np.concatenate([c2, d4], axis=-1)
        d5 = relu(conv2d_transpose(cat4, ws["deconv5a"]["kernel"],
                                   ws["deconv5a"]["bias"], (2, 2), "valid"))
        d5 = np.pad(d5, ((1, 0), (0, 0), (0, 0)))
        cat5 = np.concatenate([c1, d5], axis=-1)
        d6 = conv2d_transpose(cat5, ws["deconv6a"]["kernel"],
                              ws["deconv6a"]["bias"], (2, 4), "same")
        d6 = d6[:, :w_in]  # crop width (0, 3)
        e = np.exp(d6 - d6.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        out[i] = np.clip(probs, EPSILON, 1.0)
    return out
