"""Port parity of the convolutional building blocks vs their flax
counterparts (NHWC in JAX, NCHW in the port), shared weights carried across
with ``state_dict_from_jax``; f32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.nn import layers as jl
from bde2vid_tpu.nn import recurrent as jr
from bde2vid_tpu.utils.padding import CropParameters as JaxCrop
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.nn import layers as tl
from bde2vid_tpu_torch.nn import recurrent as tr
from bde2vid_tpu_torch.utils.padding import CropParameters
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))
nhwc = lambda t: t.detach().numpy().transpose(0, 2, 3, 1)


def _port(jmod, tmod, *jargs):
    params = jmod.init(jax.random.PRNGKey(0), *jargs)
    load_state_dict_checked(tmod, state_dict_from_jax(params))
    return params


@pytest.mark.parametrize("k,stride,act", [(5, 1, "relu"), (5, 2, "relu"), (3, 2, "gelu"), (1, 1, None)])
def test_conv_layer_matches_flax(rng, k, stride, act):
    x = rng.normal(size=(2, 13, 17, 6)).astype(np.float32)
    jmod = jl.ConvLayer(8, k, stride=stride, padding=k // 2, activation=act)
    tmod = tl.ConvLayer(6, 8, k, stride, k // 2, activation=act)
    params = _port(jmod, tmod, jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_conv_lstm_cell_matches_flax_over_steps(rng):
    xs = rng.normal(size=(4, 2, 9, 11, 6)).astype(np.float32)
    hidden = 8
    jmod = jr.ConvLSTMCell(hidden, 3)
    state0 = jr.recurrent_initial_state("convlstm", 2, 9, 11, hidden)
    tmod = tr.ConvLSTMCell(6, hidden, 3)
    params = _port(jmod, tmod, jnp.asarray(xs[0]), state0)
    jstate = state0
    tstate = tr.recurrent_initial_state("convlstm", 2, 9, 11, hidden, device="cpu")
    for x in xs:
        jh, jstate = jmod.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            th, tstate = tmod(nchw(x), tstate)
        np.testing.assert_allclose(nhwc(th), np.asarray(jh), atol=1e-5, rtol=0)
        np.testing.assert_allclose(nhwc(tstate[1]), np.asarray(jstate[1]), atol=1e-5, rtol=0)


def test_residual_block_no_bn_matches_flax(rng):
    x = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    jmod = jl.ResidualBlockNoBN(8)
    tmod = tl.ResidualBlockNoBN(8)
    params = _port(jmod, tmod, jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(7, 9), (23, 30)])
def test_resize_bilinear_2x_matches_jax(rng, hw):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jl.resize_bilinear_2x(jnp.asarray(x)))
    got = nhwc(tl.resize_bilinear_2x(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["relu", "relu6", "sigmoid", "gelu", "default", None])
def test_get_activation_matches_jax(rng, name):
    x = (rng.normal(size=(64,)) * 4).astype(np.float32)
    want = np.asarray(jl.get_activation(name)(jnp.asarray(x)))
    got = tl.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw,enc", [((180, 240), 3), ((36, 44), 2), ((17, 16), 4)])
def test_crop_parameters_pad_and_crop_match_jax(rng, hw, enc):
    h, w = hw
    x = rng.normal(size=(3, h, w, 2)).astype(np.float32)
    jc, tc = JaxCrop(w, h, enc), CropParameters(w, h, enc)
    padded = np.asarray(jc.pad(jnp.asarray(x)))
    got = nhwc(tc.pad(nchw(x)))
    np.testing.assert_array_equal(got, padded)
    np.testing.assert_array_equal(nhwc(tc.crop(nchw(padded))), x)
