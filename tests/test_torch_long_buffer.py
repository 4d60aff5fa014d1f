"""A BDE2VID with a buffer of 31 frames (``buffer_index`` -15..15, N = 1519
keys a row), the port vs the JAX package on the CPU in f32 at small width:
the buffer whose level-2 attention needs the key-tiled kernels on the card
(ROADMAP C5). One seeded flax tree reaches the port through
``state_dict_from_jax``; both of the port's attention paths (the kernel
path takes the kernels' plain twins on the CPU) give the JAX images within
the repo's bar, atol 2e-4 (tests/test_bde2vid.py:313). ``chip_smoke.py``'s
``key_tiles`` phase holds the card's kernel path to its unfused path at
the flagship's width."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
from tests.test_torch_config_surface import BASE, _inputs, _port, nchw, seeded_variables
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401  (a fixture)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

BUFFER = list(range(-15, 16))


@pytest.fixture(autouse=True)
def _concrete(concrete_gathers):
    yield


@pytest.fixture(scope="module")
def jax_31_frames(concrete_gathers):
    """The JAX side, run once for both attention paths of the port: (cfg,
    voxels, variables, images)."""
    cfg = {"generator": dict(BASE, buffer_index=BUFFER)}
    vox, _ = _inputs(4)
    jmodel = jax_build("BDE2VID", cfg)
    variables = seeded_variables(jmodel, vox, seed=8)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(vox))[0]["image"])
    return cfg, vox, variables, want


@pytest.mark.parametrize("kernel", [False, True])
def test_31_frame_buffer_matches_jax(kernel, jax_31_frames):
    cfg, vox, variables, want = jax_31_frames
    model = _port(cfg, variables, train=False)
    set_attention_kernel(model, kernel)
    with torch.no_grad():
        got = model(nchw(vox))["image"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.transpose(0, 1, 4, 2, 3), atol=2e-4, rtol=0)
