"""Keras weight import: conv-transpose semantic equivalence + full load.

The conv-transpose check uses jax itself as the oracle: Keras's
Conv2DTranspose is by definition the gradient of a strided SAME conv with
kernel (kh, kw, out, in), so models/fcn.deconv(kernel') must equal the
conv VJP after the flip+swap conversion.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpufusion.models.fcn import deconv
from tpufusion.tools.import_keras import keras_deconv_kernel

REF_H5 = "/root/reference/modules/lidar/data/lidar_model.h5"


@pytest.mark.parametrize("stride", [(1, 2), (1, 4), (2, 2)])
def test_conv_transpose_matches_conv_gradient(stride, rng):
    cin, cout, kh, kw = 6, 4, 5, 5
    h, w = 16, 32
    keras_kernel = rng.normal(size=(kh, kw, cout, cin)).astype(np.float32)
    g = rng.normal(size=(1, h, w, cin)).astype(np.float32)  # cotangent/input

    # gradient-of-conv oracle: the forward conv consumes the transpose's
    # OUTPUT channels (cout) and produces its INPUT channels (cin); the
    # stored (kh, kw, out, in) kernel reads as HWIO for that forward conv
    def conv(x):
        return jax.lax.conv_general_dilated(
            x,
            jnp.asarray(keras_kernel),  # (kh, kw, cout, cin) = (H W I O)
            window_strides=stride,
            padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )

    x0 = jnp.zeros((1, h * stride[0], w * stride[1], cout))
    _, vjp = jax.vjp(conv, x0)
    (want,) = vjp(jnp.asarray(g))  # (1, h*s, w*s, cout)

    # the FCN's deconv with the converted kernel
    layer = {"kernel": jnp.asarray(keras_deconv_kernel(keras_kernel)),
             "bias": jnp.zeros((cout,))}
    got = deconv(layer, jnp.asarray(g), stride)

    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4
    )


@pytest.mark.skipif(not os.path.exists(REF_H5), reason="reference not mounted")
def test_load_reference_weights(rng):
    from tpufusion.tools.import_keras import (
        apply_shipped_fcn,
        load_reference_fcn,
    )

    variables = load_reference_fcn(REF_H5)
    x = jnp.asarray(rng.random((1, 32, 1801, 3)).astype(np.float32) * 50)
    y = apply_shipped_fcn(variables, x)
    assert y.shape == (1, 32, 1801, 2)
    probs = np.asarray(y)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-4)
    # trained weights produce a selective detector: overwhelmingly
    # background on noise input, with the Keras epsilon clip applied.
    # (activation equivalence itself is pinned by the golden test below)
    assert probs[..., 1].mean() < 0.1
    assert probs.min() >= 1e-7


@pytest.mark.skipif(not os.path.exists(REF_H5), reason="reference not mounted")
def test_golden_activations_vs_numpy_forward(rng):
    """The imported model reproduces the shipped network's actual
    outputs: compare against an independent pure-numpy forward of the h5
    graph (tests/oracle/keras_numpy.py) on random inputs — upgrades the
    import from weight-equivalence to activation-equivalence."""
    from tests.oracle.keras_numpy import shipped_model_forward
    from tpufusion.tools.import_keras import (
        apply_shipped_fcn,
        load_reference_fcn,
    )

    variables = load_reference_fcn(REF_H5)
    # range-view-like inputs: distances / heights / intensities
    x = np.stack(
        [
            rng.uniform(0, 90, (2, 32, 1801)),
            rng.uniform(-2, 2, (2, 32, 1801)),
            rng.uniform(0, 100, (2, 32, 1801)),
        ],
        axis=-1,
    ).astype(np.float32)
    want = shipped_model_forward(REF_H5, x)
    got = np.asarray(apply_shipped_fcn(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
