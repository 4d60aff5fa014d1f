"""Port parity of the model-level paths the third slice brings: a BDE2VID
with even (4, 6) windows, whose dilated blocks take the WindowAttention3D
kernel route (forward and ``make_loss_fn`` gradients), ``parallel_attention``
(the JAX package's ``_AttnParallel``) on the plain and the kernel path and
with DropPath, and the ``nwindow_size`` KV token reduction (vs flax and a
torch oracle written from the reference). Weights: seeded values in the flax
tree, carried over with ``state_dict_from_jax``; JAX runs on the CPU."""

import functools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import bde2vid_tpu_torch.nn.window_attention as twa_mod
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.nn import window_attention as jwa
from bde2vid_tpu.train import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.trainer import make_loss_fn
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.nn.window_attention import SwinTransformerBlock3D, set_attention_kernel
from bde2vid_tpu_torch.train import SequenceLossComputer
from tests.test_torch_window_block import seeded_params
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

T = torch.from_numpy

# the config of tests/test_bde2vid.py::test_bde2vid_checkpoint_parity_window_variants
# with the even window: its dilated blocks at levels 1 and 2 take the B3 route
EVEN = dict(num_bins=5, basechannels=8, num_encoders=3, ks=5, num_res_blocks=1,
            buffer_index=[-2, -1, 0, 1, 2], depths=[0, 2, 2], num_heads=2, window_size=[4, 6])
# the config of tests/test_bde2vid.py::test_parallel_attention_pallas_matches_parallel_xla
# with 4x4 windows, so that its dilated blocks are even
PARALLEL = dict(num_bins=5, basechannels=8, num_encoders=2, ks=3, num_res_blocks=1,
                buffer_index=[-1, 0, 1], depths=[2, 2], num_heads=4, window_size=[4, 4],
                parallel_attention=True)
# the config of tests/test_bde2vid.py::test_bde2vid_nwindow_kv_reduction, with a dilated block
NWINDOW = dict(num_bins=5, basechannels=4, num_encoders=2, ks=3, num_res_blocks=1,
               buffer_index=[-1, 0, 1], depths=[1, 2], num_heads=2, window_size=[4, 4],
               nwindow_size=[2, 2])


def _voxels(t, h, w, seed):
    return np.random.default_rng(seed).normal(size=(t, 1, h, w, 5)).astype(np.float32)


def _nchw(a):
    return T(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3)))


@pytest.fixture(scope="module", autouse=True)
def concrete_gathers():
    """The JAX package caches its static gathers with their index arrays;
    one first built while tracing would hold a tracer that a later trace
    cannot use. Build them as concrete arrays, so that the tests can jit."""
    build = jwa._inj_take_cached.__wrapped__

    @functools.lru_cache(maxsize=128)
    def cached(*args):
        with jax.ensure_compile_time_eval():
            return build(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwa, "_inj_take_cached", cached)
        yield


@pytest.fixture(scope="module")
def init_cache():
    """Params by architecture: the tree does not depend on the kernel
    switch, training mode or the DropPath rate, so cases share one tree."""
    return {}


def _params(cache, gcfg, vox):
    arch = json.dumps({k: v for k, v in gcfg.items() if k != "drop_path_rate"}, sort_keys=True)
    if arch not in cache:
        init = jax_build("BDE2VID", {"generator": gcfg}).init
        cache[arch] = seeded_params(init, jax.random.PRNGKey(0), jnp.asarray(vox[:2]))
    return cache[arch]


def _port(gcfg, params, kernel, train=False):
    """The port's model with ``params`` carried over, on the kernel route
    with ``kernel``."""
    model = build_model("BDE2VID", {"generator": dict(gcfg, use_pallas_attention=kernel)},
                        device="cpu", train=train)
    load_state_dict_checked(model, state_dict_from_jax(params))
    set_attention_kernel(model, kernel)
    return model


def _pair(cache, gcfg, vox, kernel, train=False):
    """The JAX model (Pallas path with ``kernel``) and the port, on shared
    params."""
    jmodel = jax_build("BDE2VID", {"generator": dict(gcfg, use_pallas_attention=kernel)}, train=train)
    params = _params(cache, gcfg, vox)
    return jmodel, params, _port(gcfg, params, kernel, train)


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(twa_mod, name)
    monkeypatch.setattr(twa_mod, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.fixture(scope="module")
def even_case(init_cache):
    """The even-window model's JAX side on one input, in one jit: the
    Pallas-path image (eval) and the loss and gradients of make_loss_fn
    (training, DropPath 0)."""
    t, h, w = 3, 32, 32
    rng = np.random.default_rng(7)
    vox = rng.normal(size=(t, 1, h, w, 5)).astype(np.float32)
    tgt = rng.uniform(size=(t, 1, h, w, 1)).astype(np.float32)
    params = _params(init_cache, EVEN, vox)
    jeval = jax_build("BDE2VID", {"generator": dict(EVEN, use_pallas_attention=True)})
    jtrain = jax_build("BDE2VID", {"generator": dict(EVEN, use_pallas_attention=True, drop_path_rate=0.0)},
                       train=True)
    loss_fn = make_loss_fn(jtrain, JaxLoss([{"type": "L1Loss"}]), is_sequence_model=True)

    def image_loss_grads(p, v, g):
        image = jeval.apply(p, v)[0]["image"]
        return image, jax.value_and_grad(loss_fn, has_aux=True)(
            p, v, g, None, {"droppath": jax.random.PRNGKey(2)})

    image, ((loss, _), grads) = jax.jit(image_loss_grads)(params, jnp.asarray(vox), jnp.asarray(tgt))
    return dict(vox=vox, tgt=tgt, params=params, image=np.asarray(image)[:, 0, :, :, 0],
                loss=float(loss), grads=state_dict_from_jax(grads))


def test_even_window_bde2vid_matches_jax(even_case, monkeypatch):
    """The kernel route (B1's twin for plain blocks, B3's for the even
    dilated ones) vs the JAX package's Pallas path; the port's unfused path
    agrees with both."""
    vox, want = even_case["vox"], even_case["image"]
    t = len(vox)
    model = _port(EVEN, even_case["params"], True)
    b3 = _count_calls(monkeypatch, "fused_window_block")
    with torch.no_grad():
        got = model(_nchw(vox))["image"][:, 0, 0].numpy()
        assert len(b3) == 2 * t  # one even dilated block at each of levels 1 and 2, per frame
        set_attention_kernel(model, False)
        unfused = model(_nchw(vox))["image"][:, 0, 0].numpy()
    assert len(b3) == 2 * t
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(unfused, want, atol=2e-4, rtol=0)


def test_even_window_bde2vid_gradients_match_jax_make_loss_fn(even_case):
    """Loss and every gradient of the even-window model on the kernel path
    (WindowBlockFunction and SwinBlockFunction over their twins) vs the JAX
    package's make_loss_fn through its interpret-mode Pallas kernels, at the
    bound of tests/test_torch_train_grads.py."""
    vox, tgt = even_case["vox"], even_case["tgt"]
    model = _port(dict(EVEN, drop_path_rate=0.0), even_case["params"], True, train=True)
    loss, _ = SequenceLossComputer([{"type": "L1Loss"}])(model(_nchw(vox))["image"], _nchw(tgt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), even_case["loss"], atol=2e-5, rtol=1e-4)
    want = even_case["grads"]
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), atol=5e-5, rtol=1e-3, err_msg=key)
        if key.endswith("attn.kv.bias"):
            assert g[: g.shape[0] // 2].abs().max() <= 1e-5, key


@pytest.mark.parametrize("kernel", [False, True])
def test_parallel_attention_matches_jax(init_cache, kernel):
    """parallel_attention vs the JAX package's _AttnParallel on the same
    path: unfused vs XLA, and the kernel route (B1's twin for the plain
    blocks, B3's for the even dilated ones) vs the interpret-mode Pallas
    kernels."""
    vox = _voxels(3, 16, 16, seed=3)
    jmodel, params, model = _pair(init_cache, PARALLEL, vox, kernel)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(vox))[0]["image"])
    with torch.no_grad():
        got = model(_nchw(vox))["image"].numpy().transpose(0, 1, 3, 4, 2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_parallel_attention_droppath_draws_per_sample_frame_row(init_cache, monkeypatch):
    """Training with DropPath 0.3 on the kernel route: every block draws one
    mask per (sample, frame) row of the batched frames, in the JAX block's
    order (attention branch, then MLP branch). Both packages get the same 0/1
    draws and agree on the output."""
    t, n, keep = 3, 2, 0.7
    gcfg = dict(PARALLEL, drop_path_rate=0.6)
    vox = np.random.default_rng(4).normal(size=(t, n, 16, 16, 5)).astype(np.float32)
    jmodel, params, model = _pair(init_cache, gcfg, vox, True, train=True)
    draws = [(np.random.default_rng(i).random(n * t) < keep).astype(np.float32) for i in range(8)]

    jit = iter(draws)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(next(jit)).reshape(shape) > 0)
    # traced once under jit: each draw is taken once, in the model's order
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(vox),
                                            rngs={"droppath": jax.random.PRNGKey(5)})[0]["image"])
    sizes, tit = [], iter(draws)

    def keep_masks(self, b, device, generator):
        if self.drop_path == 0.0:
            return None
        sizes.append(b)
        return tuple(T(next(tit)) / (1.0 - self.drop_path) for _ in range(2))

    monkeypatch.setattr(SwinTransformerBlock3D, "keep_masks", keep_masks)
    with torch.no_grad():
        got = model(_nchw(vox), torch.Generator())["image"].numpy().transpose(0, 1, 3, 4, 2)
    assert sizes == [n * t] * 2  # block 1 of each level; block 0 has drop_path 0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _reference_reduction_attention(mod, x):
    """The reference WindowAttention3D with a KV token reduction
    (DTransformer.py:129,172-199) written out on the port module's
    parameters: x (D, B_, C, H, W) -> (B_, H, W, C)."""
    d, b_, c, hh, ww = x.shape
    heads = mod.num_heads
    ntok = mod.nwin_size[0] * mod.nwin_size[1]
    kv = F.conv2d(x.reshape(-1, c, hh, ww), mod.reduction_conv.weight, mod.reduction_conv.bias,
                  groups=c)
    kv = kv.view(d, b_, ntok, c)  # the reference's mixing reshape
    q = x[mod.q_ind].permute(0, 2, 3, 1).reshape(b_, -1, c)
    kv = kv.permute(1, 0, 2, 3).reshape(b_, -1, c)
    q, kv = mod.norm_q(q), mod.norm_kv(kv)
    m, n, hd = q.shape[1], kv.shape[1], c // heads
    qh = mod.q(q).reshape(b_, m, heads, hd).permute(0, 2, 1, 3)
    kvh = mod.kv(kv).reshape(b_, n, 2, heads, hd).permute(2, 0, 3, 1, 4)
    attn = (qh * hd**-0.5) @ kvh[0].transpose(-2, -1)
    qs = mod.q_ind * hh * ww
    idx = mod.relative_position_index[qs : qs + hh * ww, :n].reshape(-1)
    bias = mod.relative_position_bias_table[idx].reshape(m, n, -1).permute(2, 0, 1)
    out = ((attn + bias[None]).softmax(-1) @ kvh[1]).transpose(1, 2).reshape(b_, m, c)
    return mod.proj(out).view(b_, hh, ww, c)


def test_nwindow_attention_matches_flax_and_reference_oracle(rng):
    """The KV token reduction (grouped reduction_conv, group-major reshape,
    bias columns sliced to the reduced token count): the port module vs the
    flax module on flax params carried over (the conv kernel HWIO ->
    OIHW), and vs the reference's torch code on the port's parameters."""
    d, b_, wh, ww, c, heads = 3, 2, 5, 5, 8, 2
    x = rng.normal(size=(d, b_, wh, ww, c)).astype(np.float32)
    jmod = jwa.WindowAttention3D(c, (d, wh, ww), heads, nwin_size=(2, 2))
    params = seeded_params(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = twa_mod.WindowAttention3D(c, (d, wh, ww), heads, nwin_size=(2, 2))
    load_state_dict_checked(tmod, state_dict_from_jax(params))
    assert tuple(tmod.reduction_conv.weight.shape) == (4 * c, 1, wh, ww)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(T(x)).numpy()
        oracle = _reference_reduction_attention(tmod, T(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3))))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, oracle.numpy(), atol=2e-5, rtol=1e-4)


def test_nwindow_bde2vid_matches_jax_with_kernels_off(init_cache, monkeypatch):
    """A BDE2VID with nwindow_size vs the JAX package with the kernel switch
    on, where it keeps the kernels off (the reduction has no kernel): the
    port keeps them off too, and its output is that of its unfused path."""
    vox = _voxels(3, 16, 16, seed=5)
    jmodel, params, model = _pair(init_cache, NWINDOW, vox, True)
    routes = _count_calls(monkeypatch, "fused_window_block") + _count_calls(monkeypatch, "fused_swin_block")
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(vox))[0]["image"])
    with torch.no_grad():
        got = model(_nchw(vox))["image"]
        set_attention_kernel(model, False)
        unfused = model(_nchw(vox))["image"]
    assert routes == [] and torch.equal(got, unfused)
    np.testing.assert_allclose(got.numpy().transpose(0, 1, 3, 4, 2), want, atol=2e-5, rtol=1e-4)
