"""Every registry activation through the Swin block's MLP: the port's plain
twin (what the CUDA kernel is held to on the card) against the JAX twin
``_ref_swin_block``, a small SwinTransformerBlock3D on the kernel route
against the flax block, and the two activation registries against each
other. CPU, f32; inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.nn import layers as jlayers
from bde2vid_tpu.nn import window_attention as jwa
from bde2vid_tpu.ops.window_attn_pallas import _ref_swin_block
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.nn import layers as tlayers
from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.ops import window_attn_cuda as wac
from tests.test_torch_window_attention import _block_inputs, _torch_params
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

NAMES = sorted(tlayers._ACTIVATIONS)


def test_registry_names_match_jax_and_the_kernel_codes():
    assert set(tlayers._ACTIVATIONS) == set(jlayers._ACTIVATIONS)
    assert set(tlayers._ACTIVATIONS) <= set(wac._ACT_CODES)


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_jax_registry(name):
    # scale 8: softplus crosses torch's threshold of 20
    x = np.random.default_rng(0).normal(size=(257,)).astype(np.float32) * 8
    want = np.asarray(jlayers.get_activation(name)(jnp.asarray(x)))
    got = tlayers.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_swin_block_twin_matches_jax_twin(rng, name):
    heads, q_ind = 2, 1
    x, ctr, params = _block_inputs(rng, False, h=8, w=8, c=32, heads=heads, win=(4, 4))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(_ref_swin_block(jnp.asarray(x), jnp.asarray(ctr), jparams, heads, q_ind, name))
    got = wac.swin_block_reference(torch.from_numpy(x), torch.from_numpy(ctr), _torch_params(params),
                                   heads, q_ind, activation=name)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_swin_module_on_the_kernel_route_matches_flax(rng, name):
    c, heads, wsz = 32, 2, (3, 4, 4)
    x = rng.normal(size=(3, 1, 8, 8, c)).astype(np.float32)
    jmod = jwa.SwinTransformerBlock3D(c, heads, window_size=wsz, activation=name)
    tmod = twa.SwinTransformerBlock3D(c, heads, window_size=wsz, activation=name, use_kernel=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    load_state_dict_checked(tmod, state_dict_from_jax(params))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    before = wac.launch_counts["fused_swin_block"]
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert wac.launch_counts["fused_swin_block"] == before  # the CPU runs the twin
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
