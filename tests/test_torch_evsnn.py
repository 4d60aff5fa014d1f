"""The spiking family of the port vs the JAX package on the CPU in f32.

- ``nn/spiking.py``: ``atan_spike``'s forward bit-equal to JAX's, its
  gradient within 1e-6 of ``jax.grad`` through the ``custom_vjp``; every
  neuron step within 1e-6, soft and hard reset alike.
- ``utils/norm.py::robust_norm`` within 1e-6 (random inputs, the all-zero
  pass-through, mostly-zero images), ``to_uint8_image`` bit-equal;
  ``utils/png.py`` writes byte-identical files.
- EVSNN and PAEVSNN at full width (the widths are fixed) at 32x40, batch 2,
  over 2 calls of 5 bins, with numpy-seeded flax variables (randomised BN
  statistics) carried to the port by ``state_dict_from_jax``: the image and
  every state entry (LIF and Mp membranes) within 2e-4, with at least 1 % of
  the LIF units firing, asserted. The norm is per sample (a sample's output
  does not depend on its batch neighbour), and ``normalize_input: false``
  feeds the voxel unnormalised, in both packages.
- The bare SNN dialect: ``EVSNN*.pth``, ``PAEVSNN*.pth`` and a dict under
  ``"model"`` load, the dead pooled-MLP tensors a reference checkpoint
  carries are dropped and nothing else (a renamed live ``get_theta.fc2``,
  or another extra tensor, is refused).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.nn import spiking as jsp
from bde2vid_tpu.utils.norm import robust_norm as jax_robust_norm
from bde2vid_tpu.utils.norm import to_uint8_image as jax_to_uint8_image
from bde2vid_tpu.utils.png import write_gray_png as jax_write_gray_png
from bde2vid_tpu.utils.png import write_png as jax_write_png
from bde2vid_tpu_torch.eval.checkpoint import (
    load_model_from_torch,
    load_state_dict_checked,
    state_dict_from_jax,
)
from bde2vid_tpu_torch.models import build_model, evsnn
from bde2vid_tpu_torch.nn import spiking as tsp
from bde2vid_tpu_torch.utils.norm import robust_1_99, robust_norm, to_uint8_image
from bde2vid_tpu_torch.utils.png import write_gray_png, write_png
from tests.test_torch_e2vid import nchw, seeded_tree

ATOL = 2e-4
H, W, N, B = 32, 40, 2, 5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------- neurons


def test_atan_spike_forward_is_bit_equal_and_gradient_matches_jax():
    x = np.concatenate([[-1.0, -1e-7, -0.0, 0.0, 1e-7, 3.0],
                        np.random.default_rng(0).normal(size=200)]).astype(np.float32)
    for alpha in (2.0, 4.0):
        want = np.asarray(jsp.atan_spike(jnp.asarray(x), alpha))
        xt = _t(x).requires_grad_(True)
        got = tsp.atan_spike(xt, alpha)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        assert got.dtype == torch.float32
        g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
        got.backward(_t(g))
        want_grad = jax.grad(lambda v: jnp.sum(jsp.atan_spike(v, alpha) * g))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=0)
        closed = g * alpha / 2 / (1 + (math.pi / 2 * alpha * x) ** 2)
        np.testing.assert_allclose(xt.grad.numpy(), closed, atol=1e-6, rtol=0)


NEURONS = {
    "lif-soft": (jsp.lif_step, tsp.lif_step, {"tau": 2.0}),
    "lif-hard": (jsp.lif_step, tsp.lif_step, {"tau": 2.0, "v_reset": 0.0}),
    "lif-hard-offset": (jsp.lif_step, tsp.lif_step, {"tau": 3.0, "v_reset": -0.2,
                                                     "v_threshold": 0.5}),
    "if-soft": (jsp.if_step, tsp.if_step, {}),
    "if-hard": (jsp.if_step, tsp.if_step, {"v_reset": 0.0}),
    "plif-soft": (jsp.plif_step, tsp.plif_step, {"w": 0.3}),
    "plif-hard": (jsp.plif_step, tsp.plif_step, {"w": -0.7, "v_reset": 0.1}),
    "mp-lif": (jsp.mp_lif_step, tsp.mp_lif_step, {"tau": 2.0}),
    "mp-if": (jsp.mp_if_step, tsp.mp_if_step, {}),
    "mp-ada-lif": (jsp.mp_ada_lif_step, tsp.mp_ada_lif_step, {"w": "per-sample"}),
}


@pytest.mark.parametrize("kind", sorted(NEURONS))
def test_neuron_step_matches_jax(kind):
    jfn, tfn, kw = NEURONS[kind]
    rng = np.random.default_rng(2)
    v = rng.normal(size=(3, 4, 5)).astype(np.float32)
    x = (2.0 * rng.normal(size=(3, 4, 5))).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if "w" in kw:
        w = (rng.normal(size=(3, 1, 1)) if kw["w"] == "per-sample" else np.float32(kw["w"]))
        jkw["w"], tkw["w"] = jnp.asarray(w, jnp.float32), torch.tensor(w, dtype=torch.float32)
    want = jfn(jnp.asarray(v), jnp.asarray(x), **jkw)
    got = tfn(_t(v), _t(x), **tkw)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    if kind.startswith(("lif", "if", "plif")):
        assert 0 < got[0].mean() < 1  # some fire, some do not


# ----------------------------------------------------------- norms and PNG


def _norm_inputs():
    rng = np.random.default_rng(3)
    mostly_zero = np.zeros((30, 40), np.float32)
    mostly_zero[rng.integers(0, 30, 5), rng.integers(0, 40, 5)] = 1.5
    return {"normal": rng.normal(size=(30, 40)).astype(np.float32),
            "skewed": rng.exponential(size=(1, 17, 23)).astype(np.float32),
            "zeros": np.zeros((16, 20), np.float32),
            "mostly-zero": mostly_zero,
            "negative": -np.abs(rng.normal(size=(50,))).astype(np.float32)}


@pytest.mark.parametrize("kind", sorted(_norm_inputs()))
@pytest.mark.parametrize("low,top", [(1.0, 99.0), (0.0, 95.0), (5.0, 50.0)])
def test_robust_norm_matches_jax(kind, low, top):
    x = _norm_inputs()[kind]
    want = np.asarray(jax_robust_norm(jnp.asarray(x), low, top))
    got = robust_norm(_t(x), low, top).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if kind in ("zeros", "mostly-zero"):  # both percentiles 0: passed through
        np.testing.assert_array_equal(got, x)
    if (low, top) == (1.0, 99.0):
        np.testing.assert_array_equal(robust_1_99(_t(x)).numpy(), got)
    np.testing.assert_array_equal(to_uint8_image(_t(got)), jax_to_uint8_image(want))


def test_png_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (13, 17)).astype(np.uint8)
    rgb = rng.integers(0, 256, (5, 9, 3)).astype(np.uint8)
    for name, img, ours, theirs in (("g", gray, write_gray_png, jax_write_gray_png),
                                    ("c", rgb, write_png, jax_write_png),
                                    ("c1", gray[..., None], write_png, jax_write_png)):
        ours(str(tmp_path / f"{name}_port.png"), img)
        theirs(str(tmp_path / f"{name}_jax.png"), img)
        assert (tmp_path / f"{name}_port.png").read_bytes() == (tmp_path / f"{name}_jax.png").read_bytes()
    with pytest.raises(ValueError, match="uint8"):
        write_gray_png(str(tmp_path / "bad.png"), gray.astype(np.float32))


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module", params=["EVSNN", "PAEVSNN"])
def snn_pair(request):
    """(name, JAX module, flax variables, port module) from one numpy seed."""
    name = request.param
    jm = jax_build(name, {})
    init = lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, B)), jm.initial_state(1, H, W))
    variables = seeded_tree(jax.eval_shape(init), seed=5 if name == "EVSNN" else 6)
    model = build_model(name, {}, device="cpu").eval()
    load_state_dict_checked(model, state_dict_from_jax(variables))
    return name, jm, variables, model


def _state_pairs(jstate, tstate):
    """(name, JAX NHWC array, port NCHW tensor) of every state entry."""
    pairs = [(f"lif.{k}", jstate["lif"][k], tstate["lif"][k]) for k in sorted(jstate["lif"])]
    jmp, tmp = jstate["mp"], tstate["mp"]
    if isinstance(jmp, tuple):
        pairs += [(f"mp.{i}", a, b) for i, (a, b) in enumerate(zip(jmp, tmp))]
    else:
        pairs.append(("mp", jmp, tmp))
    return pairs


def _voxels(seed):
    """Two samples of unlike density and scale, with zeros."""
    rng = np.random.default_rng(seed)
    vox = rng.normal(size=(N, H, W, B)).astype(np.float32)
    vox[0] *= 3.0
    vox[1] *= rng.random((H, W, B)) < 0.3
    return vox


def _run_port(model, vox_list, monkeypatch):
    """The port over the voxels, one call each, counting which LIF units fired."""
    fired = {}
    calls = [0]
    real = evsnn.lif_step

    def counting(v, x, *args):
        spike, v_new = real(v, x, *args)
        slot = calls[0] % 9  # 9 LIF firings a bin: the residual block fires twice
        calls[0] += 1
        fired[slot] = fired.get(slot, torch.zeros_like(spike, dtype=torch.bool)) | (spike > 0)
        return spike, v_new

    monkeypatch.setattr(evsnn, "lif_step", counting)
    state = model.initial_state(N, H, W)
    outs = []
    with torch.no_grad():
        for vox in vox_list:
            out, state = model(nchw(vox), state)
            outs.append(out["image"])
    units = sum(f.numel() for f in fired.values())
    return outs, state, sum(int(f.sum()) for f in fired.values()) / units


def test_snn_matches_jax_over_two_calls(snn_pair, monkeypatch):
    name, jm, variables, model = snn_pair
    vox_list = [_voxels(7), _voxels(8)]
    fn = jax.jit(jm.apply)
    jstate = jm.initial_state(N, H, W)
    want = []
    for vox in vox_list:
        out, jstate = fn(variables, jnp.asarray(vox), jstate)
        want.append(out["image"])
    got, tstate, fire_share = _run_port(model, vox_list, monkeypatch)
    assert fire_share >= 0.01, f"{name}: only {fire_share:.4f} of the LIF units fired"
    for g, w in zip(got, want):
        assert g.shape == (N, 1, H, W)
        np.testing.assert_allclose(g.numpy(), np.asarray(nchw(w)), atol=ATOL, rtol=0)
    pairs = _state_pairs(jstate, tstate)
    assert len(pairs) == (9 if name == "EVSNN" else 16)
    for key, a, b in pairs:
        assert b.shape == nchw(a).shape, key
        np.testing.assert_allclose(b.numpy(), np.asarray(nchw(a)), atol=ATOL, rtol=0, err_msg=key)


def test_snn_normalises_each_sample_on_its_own(snn_pair):
    _, _, _, model = snn_pair
    vox = nchw(_voxels(9))
    with torch.no_grad():
        both, _ = model(vox, model.initial_state(N, H, W))
        alone, _ = model(vox[1:], model.initial_state(1, H, W))
    np.testing.assert_allclose(both["image"][1:].numpy(), alone["image"].numpy(), atol=1e-5, rtol=0)


def test_snn_without_input_norm_matches_jax(snn_pair):
    name, _, variables, _ = snn_pair
    jm = jax_build(name, {"normalize_input": False})
    model = build_model(name, {"normalize_input": False}, device="cpu").eval()
    load_state_dict_checked(model, state_dict_from_jax(variables))
    vox = _voxels(10)[:1, ..., :2] * 2.5  # two bins, unnormalised
    want, _ = jax.jit(jm.apply)(variables, jnp.asarray(vox), jm.initial_state(1, H, W))
    with torch.no_grad():
        got, _ = model(nchw(vox), model.initial_state(1, H, W))
        normed, _ = build_model(name, {}, device="cpu").eval()(nchw(vox), model.initial_state(1, H, W))
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(nchw(want["image"])), atol=ATOL,
                               rtol=0)
    assert not np.allclose(got["image"].numpy(), normed["image"].numpy(), atol=1e-2)


def test_downsampled_state_sizes_round_up():
    model = build_model("PAEVSNN", {}, device="cpu")
    state = model.initial_state(1, 45, 61)
    assert state["lif"]["down3"].shape == (1, 256, 6, 8)
    assert [m.shape[-2:] for m in state["mp"]] == [(45, 61), (23, 31), (12, 16), (6, 8), (6, 8),
                                                   (12, 16), (23, 31), (45, 61)]


# ----------------------------------------------------------------- dialect


def dead_tensors(sd):
    """The tensors a reference SNN checkpoint carries that its forward never
    reads: each skip's conv2d_pool/fc1/fc2, get_theta.fc1, PAEVSNN's
    temporalflat.conv2d_pool."""
    dead = {}
    for key in sd:
        if key.endswith("get_theta.fc3.weight"):
            owner = key[: -len("get_theta.fc3.weight")]
            cin = sd[key].shape[1] - 32  # fc3 takes the input's and the 32 outputs' pools
            dead[f"{owner}get_theta.fc1.weight"] = torch.randn(cin // 4, cin)
            dead[f"{owner}get_theta.fc1.bias"] = torch.randn(cin // 4)
            dead[f"{owner}conv2d_pool.weight"] = torch.randn(1, 32, 1, 1)
            if not owner.startswith("temporalflat"):
                dead[f"{owner}fc1.weight"] = torch.randn(cin // 4, cin)
                dead[f"{owner}fc1.bias"] = torch.randn(cin // 4)
                dead[f"{owner}fc2.weight"] = torch.randn(4, cin // 4)
                dead[f"{owner}fc2.bias"] = torch.randn(4)
    return dead


def _seeded_port_state_dict(name, seed):
    model = build_model(name, {}, device="cpu")
    torch.manual_seed(seed)
    sd = {}
    for key, val in model.state_dict().items():
        if key.endswith("running_var"):
            sd[key] = torch.rand(val.shape) + 0.5
        elif val.is_floating_point():
            sd[key] = torch.randn(val.shape) * (0.1 if val.ndim == 1 else 1.0)
        else:
            sd[key] = val
    return sd


@pytest.mark.parametrize("fname,family,wrap", [("EVSNN_e10.pth", "EVSNN", False),
                                               ("PAEVSNN_model.pth", "PAEVSNN", False),
                                               ("EVSNN_wrapped.pth", "EVSNN", True)])
def test_bare_snn_dialect_loads_and_drops_exactly_the_dead_tensors(fname, family, wrap, tmp_path):
    sd = _seeded_port_state_dict(family, 11)
    dead = dead_tensors(sd)
    assert len(dead) == (0 if family == "EVSNN" else 7 * 7 + 3)
    path = str(tmp_path / fname)
    torch.save({"model": {**sd, **dead}} if wrap else {**sd, **dead}, path)
    spec = load_model_from_torch(path, device="cpu")
    assert (spec.name, spec.num_encoders, spec.normalize, spec.is_sequence_model) == (
        family, 3, False, False)
    loaded = spec.module.state_dict()
    assert sorted(loaded) == sorted(sd)
    for key, val in sd.items():
        assert torch.equal(loaded[key], val), key


@pytest.mark.parametrize("edit", ["rename-live-fc2", "copy-live-fc2", "extra-fc3-under-conv",
                                  "drop-one"])
def test_bare_snn_dialect_refuses_anything_but_dead_tensors(edit, tmp_path):
    """A live ``get_theta.fc2`` under another owner is never taken for a dead
    ``fc2``: renamed, or beside the right one, it is refused."""
    sd = _seeded_port_state_dict("PAEVSNN", 12)
    sd.update(dead_tensors(sd))
    if edit == "rename-live-fc2":
        sd["skip1.get_theta.fc2.weight"] = sd.pop("skip1.conv.get_theta.fc2.weight")
    elif edit == "copy-live-fc2":
        sd["skip1.get_theta.fc2.weight"] = sd["skip1.conv.get_theta.fc2.weight"].clone()
    elif edit == "extra-fc3-under-conv":
        sd["skip1.conv.fc3.weight"] = torch.zeros(8, 96)
    else:
        sd.pop("aggregation2.conv2d.weight")
    path = str(tmp_path / "PAEVSNN.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="checkpoint/model mismatch"):
        load_model_from_torch(path, device="cpu")
