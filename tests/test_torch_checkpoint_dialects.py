"""The checkpoint dialects of the E2VID family: one ``.pth`` per dialect,
saved from the port's own module with numpy-seeded weights, loads strictly
into both packages' ``load_model_from_torch`` with the same family,
``num_encoders`` and ``normalize``, and both give the same images over T=3
steps within atol 2e-4. CPU, f32.

- pytorch-template with ``config`` (a dict, or an object holding it as
  ``.config``): the model arguments under ``config.arch.args.unet_kwargs``
  or ``config.arch.args``; never normalize;
- pytorch-template with ``model`` and no ``config``: normalize;
- ``firenet_1000.pth``: FireNetOrg under ``net.``;
- mmengine with a ``type`` other than BDE2VID.

A missing or an extra tensor raises in both packages; bare SPADE and SNN
state dicts (read since those families were ported; tests/test_torch_spade.py,
tests/test_torch_evsnn.py) are loaded strictly, so a foreign one is refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.models.api import run_sequence as jax_run_sequence
from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
from bde2vid_tpu_torch.models import build_model, run_sequence
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

SMALL = {"num_bins": 5, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1}
FIRE = {"num_bins": 5, "base_num_channels": 8, "num_residual_blocks": 2}
H, W = 32, 48


class ConfigHolder:
    """The template's parsed-config object: the dict sits under ``.config``."""

    def __init__(self, config):
        self.config = config


def seeded_state_dict(model, seed):
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, size=tuple(v.shape)).astype(np.float32))
        elif v.is_floating_point():
            scale = 1.0 / np.sqrt(np.prod(v.shape[1:])) if v.ndim > 1 else 0.1
            sd[k] = torch.from_numpy((rng.normal(size=tuple(v.shape)) * scale).astype(np.float32))
        else:
            sd[k] = v
    return sd


def _template_config(cfg):
    return {"arch": {"args": {"unet_kwargs": cfg}}}


# name -> (family, config, file name, checkpoint builder, normalize, num_encoders)
DIALECTS = {
    "template-config": ("E2VIDRecurrent", dict(SMALL, norm="BN", skip_type="concat"), "e2vid.pth",
                        lambda a, c, sd: {"arch": a, "config": _template_config(c), "state_dict": sd},
                        False, 2),
    "template-config-object": ("FlowNet", dict(SMALL, kernel_size=3), "flow.pth",
                               lambda a, c, sd: {"arch": a, "config": ConfigHolder({"arch": {"args": c}}),
                                                 "state_dict": sd}, False, 2),
    "template-model": ("FireNet", FIRE, "firenet.pth",
                       lambda a, c, sd: {"arch": a, "model": c, "state_dict": sd}, True, 0),
    "template-config-wins": ("E2VID", SMALL, "e2vid_plain.pth",
                             lambda a, c, sd: {"arch": a, "config": _template_config(c),
                                               "model": {"ignored": 1}, "state_dict": sd}, False, 2),
    "firenet_1000": ("FireNetOrg", dict(FIRE, recurrent_blocks={"resblock": [0]}), "firenet_1000.pth",
                     lambda a, c, sd: {"config": {"model": c}, "state_dict": sd}, False, 0),
    "mmengine": ("E2VIDRecurrent", dict(SMALL, recurrent_block_type="convgru"), "epoch_2.pth",
                 lambda a, c, sd: {"meta": {"cfg": f"model = dict(type={a!r}, **{c!r})\n"},
                                   "state_dict": sd}, False, 2),
}


def _save(tmp_path, dialect, state_dict_edit=None):
    family, cfg, fname, make, _, _ = DIALECTS[dialect]
    model = build_model(family, cfg, device="cpu")
    sd = seeded_state_dict(model, seed=11)
    if state_dict_edit is not None:
        state_dict_edit(sd)
    path = str(tmp_path / fname)
    torch.save(make(family, cfg, sd), path)
    return path


@pytest.mark.parametrize("dialect", sorted(DIALECTS))
def test_dialect_loads_into_both_packages(dialect, tmp_path):
    family, _, _, _, normalize, num_encoders = DIALECTS[dialect]
    path = _save(tmp_path, dialect)
    jspec = jax_load(path)
    spec = load_model_from_torch(path, device="cpu")
    assert spec.name == jspec.name == family
    assert spec.num_encoders == jspec.num_encoders == num_encoders
    assert spec.normalize == jspec.normalize == normalize
    assert spec.is_sequence_model is jspec.is_sequence_model is False
    assert spec.num_params == jspec.num_params
    vox = np.random.default_rng(12).normal(size=(3, 1, H, W, 5)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jax_run_sequence(jspec.module, p, x, jspec.initial_state(1, H, W)))(
        jspec.params, jnp.asarray(vox))
    with torch.no_grad():
        got, _ = run_sequence(spec.module, torch.from_numpy(vox.transpose(0, 1, 4, 2, 3).copy()),
                              spec.initial_state(1, H, W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 1, 4, 2, 3), atol=2e-4,
                               rtol=0)


def _drop_one(sd):
    sd.pop(sorted(sd)[0])


def _add_one(sd):
    sd["unetrecurrent.extra.weight"] = torch.zeros(1)


@pytest.mark.parametrize("edit", [_drop_one, _add_one], ids=["missing", "extra"])
def test_a_missing_or_extra_tensor_raises_in_both(edit, tmp_path):
    path = _save(tmp_path, "template-config", edit)
    with pytest.raises(ValueError, match="checkpoint/model mismatch"):
        load_model_from_torch(path, device="cpu")
    with pytest.raises(ValueError, match="checkpoint/model mismatch"):
        jax_load(path)


def test_flownet_without_num_encoders_pads_to_eighths_in_both(tmp_path):
    """JAX's rule: names without "E2VID" default to 3 encoders for the
    padding, while FlowNet itself builds 4 (ROADMAP Queue C)."""
    cfg = {"num_bins": 5, "base_num_channels": 4, "num_residual_blocks": 1}
    model = build_model("FlowNet", cfg, device="cpu")
    assert len(model.unetflow.encoders) == 4
    path = str(tmp_path / "flow.pth")
    torch.save({"arch": "FlowNet", "config": _template_config(cfg),
                "state_dict": seeded_state_dict(model, 13)}, path)
    assert load_model_from_torch(path, device="cpu").num_encoders == jax_load(path).num_encoders == 3


@pytest.mark.parametrize("fname,family", [("SPADE_e2vid.pth", "SPADE"), ("EVSNN_e10.pth", "SNN"),
                                          ("PAEVSNN.pth", "SNN")])
def test_bare_spade_and_snn_state_dicts_are_not_ported_yet(fname, family, tmp_path):
    """Both families are ported now (the name is the one this test had when
    it pinned their refusal): each dialect is read by its file name, and a
    state dict of foreign tensors is refused as a mismatch."""
    path = str(tmp_path / fname)
    torch.save({"head.conv2d.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="checkpoint/model mismatch"):
        load_model_from_torch(path, device="cpu")


def test_unknown_dialect_raises(tmp_path):
    path = str(tmp_path / "mystery.pth")
    torch.save({"weights": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="unrecognized checkpoint dialect"):
        load_model_from_torch(path, device="cpu")
