"""Checkpoints for the port (counterpart of ``bde2vid_tpu/eval/checkpoint.py``).

The port's modules keep the reference torch state-dict layout, so a
reference ``.pth`` loads with ``load_state_dict`` and no converter. The
dialects read (the JAX package's ``load_model_from_torch`` dispatch):

- ``firenet_1000.pth``: FireNetOrg from ``ckpt["config"]["model"]``;
- mmengine, ``{"meta": {"cfg": <python config source>}, "state_dict": ...}``:
  BDE2VID, or any other family by its ``type``;
- pytorch-template, ``{"arch": <family>, "state_dict": ...}`` with the
  model arguments under ``config.arch.args[.unet_kwargs|.eitr_kwargs]`` or
  ``model`` (the latter asks for LegacyNorm'd voxels);
- a bare state dict whose path names "SPADE": the SPADE generator, with
  LegacyNorm'd voxels and 3 encoders' padding;
- a bare state dict, or one under ``"model"``, whose path names "SNN":
  PAEVSNN where the path names "PAEVSNN", else EVSNN, with 3 encoders'
  padding; the pooled-MLP tensors the reference's forward never uses
  (``_SNN_DEAD``) are dropped.

``state_dict_from_jax`` turns a flax param tree of a ported family into the
port's layout: the inverse of the JAX package's ``convert_state_dict`` +
``_map_module_path`` (+ ``_bde2vid_path_fixup`` for BDE2VID).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bde2vid_tpu_torch.eval.mmengine_cfg import parse_embedded_cfg
from bde2vid_tpu_torch.models.api import ModelSpec, build_model

# tensors the port makes itself: reference-layout extras that a flax tree
# does not carry (the never-called fusion convs, the relative-position index buffer)
_DERIVED = (re.compile(r"(^|\.)fusion_layers\."), re.compile(r"(^|\.)relative_position_index$"))
# tensors of reference SNN checkpoints that their forward never reads (the JAX
# package's two patterns): ConvLayer_ada_simmp's own conv2d_pool/fc1/fc2
# (snn_network.py:86-110) and get_theta's fc1 (the 'mix' forward uses fc3 and
# fc2, :144-150). get_theta's fc2 and fc3 are live and never dropped.
_SNN_DEAD = (re.compile(r"(?<!get_theta)\.(?:conv2d_pool|fc1|fc2)\."),
             re.compile(r"get_theta\.fc1\."))


def load_state_dict_checked(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> None:
    """Load ``state_dict`` into ``model``; only the derived tensors above may
    be missing, and nothing may be left over."""
    missing, unexpected = model.load_state_dict(dict(state_dict), strict=False)
    missing = [k for k in missing if not any(p.search(k) for p in _DERIVED)]
    if missing or unexpected:
        raise ValueError(
            "checkpoint/model mismatch:\n"
            f"  missing in checkpoint: {missing[:8]}\n"
            f"  unused from checkpoint: {unexpected[:8]}"
        )


def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# flax names that fold a torch list index into the parent's name: BDE2VID's,
# EITR's (DownsampleConv.N, UpsampleConv.N, layers.J, the generic
# Transformer's encoder_layers.J / decoder_layers.J), SPADE's mlp_shared.0 and
# the SNNs' static_conv.N, residualBlock.0 and final.0
_INDEXED = re.compile(r"(forward_encoder|backward_encoder|feat_attns|blocks|fusion_layers|"
                      r"DownsampleConv|UpsampleConv|layers|encoder_layers|decoder_layers|"
                      r"mlp_shared|static_conv|residualBlock|final)(\d+)")
_LISTS = re.compile(r"(encoder|decoder|resblock)(\d+)")  # the UNets' encoders.N, ...
_TRANSFORMER = re.compile(r"trans_(encoder|decoder)\d+")  # EITR's stacks nest .encoder/.decoder


def _torch_module_path(path: Tuple[str, ...], leaf: str) -> list:
    out = []
    for i, p in enumerate(path):
        last = i == len(path) - 1
        in_decode = i > 0 and path[i - 1] == "decode"  # BDE2VID's decoder
        if p == "decode":
            continue
        if in_decode and (m := re.fullmatch(r"decoder(\d+)1_norm", p)):
            out += ["decoders", m[1], "1", "norm_layer"]  # the decoder conv's sibling norm
            continue
        if in_decode and (m := re.fullmatch(r"decoder(\d+)([01])", p)):
            out += ["decoders", m[1], m[2]]
            if m[2] == "1":
                out.append("conv2d")  # the flax decoder conv is bare; torch wraps it
            continue
        if m := re.fullmatch(r"predI(\d)", p):
            out += ["predI", m[1]]
            continue
        if i > 0 and path[i - 1].startswith("feat_attns") and (m := re.fullmatch(r"res(\d+)", p)):
            out.append(m[1])  # BDE2VID's res fallback; SPADE's res0/res1 keep their names
            continue
        if m := _TRANSFORMER.fullmatch(p):
            out += [p, m[1]]
            continue
        if m := _INDEXED.fullmatch(p):
            out += [m[1], m[2]]
            continue
        if m := _LISTS.fullmatch(p):
            out += [m[1] + "s", m[2]]
            if last and m[1] == "decoder" and leaf in ("kernel", "bias"):
                out.append("transposed_conv2d")  # TransposedConvLayer's params sit on the layer
            continue
        if p == "gates":
            out.append("Gates")
            continue
        out.append("conv2d" if p == "conv" and last else p)
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of a ported family (``{"params": ..., "batch_stats":
    ...}`` or the bare param tree; numpy or JAX arrays) -> the port's state
    dict: HWIO -> OIHW, (in, out) -> (out, in), LayerNorm/BatchNorm
    ``scale`` -> ``weight``, ``batch_stats`` mean/var ->
    ``running_mean``/``running_var`` with a ``num_batches_tracked`` of 0
    (flax keeps no count), module paths renamed (``encoderN`` ->
    ``encoders.N``, ``decoderN``/``resblockN`` likewise, a leaf ``conv`` ->
    ``conv2d``, ``gates`` -> ``Gates``, ``decode/decoderN1`` ->
    ``decoders.N.1.conv2d``, ``decode/decoderN1_norm`` ->
    ``decoders.N.1.norm_layer``, ``feat_attnsL/resJ`` -> ``feat_attns.L.J``,
    EITR's ``trans_encoderN/layersJ`` -> ``trans_encoderN.encoder.layers.J``
    and ``DownsampleConvN`` -> ``DownsampleConv.N``, SPADE's ``mlp_shared0``
    -> ``mlp_shared.0``, ...); an attention's ``in_proj_kernel`` (d, 3d) goes
    to ``in_proj_weight`` (3d, d). A 4-D kernel directly on ``decoderN`` is a TransposedConvLayer's,
    kept flipped in correlation form (kh, kw, in, out): it goes to
    ``decoders.N.transposed_conv2d.weight`` as torch's (in, out, kh, kw),
    un-flipped. Load the result with :func:`load_state_dict_checked`."""
    tree = params.get("params", params)
    sd = {}
    for path, val in _flax_paths(tree):
        val = np.array(val, dtype=np.float32)
        leaf = path[-1]
        mod = _torch_module_path(path[:-1], leaf)
        if leaf == "kernel" and mod[-1] == "transposed_conv2d":
            name, val = "weight", val[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf in ("kernel", "in_proj_kernel"):
            name = "weight" if leaf == "kernel" else "in_proj_weight"
            val = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        sd[".".join(mod + [name])] = torch.from_numpy(np.ascontiguousarray(val))
    for path, val in _flax_paths(params.get("batch_stats", {})):
        mod = ".".join(_torch_module_path(path[:-1], path[-1]))
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        sd[f"{mod}.{name}"] = torch.from_numpy(np.array(val, dtype=np.float32))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_torch_file(path: str) -> Dict[str, Any]:
    # mmengine checkpoints pickle more than tensors (meta, message hub), so
    # weights_only loading would refuse them; only open trusted files
    return torch.load(path, map_location="cpu", weights_only=False)


def _template_model_args(ckpt: Mapping) -> Tuple[Optional[dict], bool]:
    """(model arguments, normalize) of a pytorch-template checkpoint: a
    ``config`` key wins and never sets normalize (without ``arch`` in it the
    arguments stay None); ``model`` is read only when ``config`` is absent,
    and then sets normalize. ``config`` may be a dict or an object holding
    one as ``.config``."""
    if "config" in ckpt:
        cp = ckpt["config"]
        if not isinstance(cp, Mapping):
            cp = cp.config
        margs = None
        if "arch" in cp:
            margs = cp["arch"]["args"]
            if "unet_kwargs" in margs:
                margs = margs["unet_kwargs"]
            elif "eitr_kwargs" in margs:
                margs = margs["eitr_kwargs"]
            margs = dict(margs)
        return margs, False
    if "model" in ckpt:
        return dict(ckpt["model"]), True
    return None, False


def load_model_from_torch(path: str, device=None, dtype=torch.float32) -> ModelSpec:
    """A reference ``.pth`` of a ported family -> ModelSpec on ``device``,
    loaded strictly."""
    ckpt = load_torch_file(path)
    if path.endswith("firenet_1000.pth"):
        return _build_spec("FireNetOrg", dict(ckpt["config"]["model"]), ckpt["state_dict"],
                           device, dtype)
    if isinstance(ckpt, Mapping) and "state_dict" in ckpt:
        if "meta" in ckpt:
            config = parse_embedded_cfg(ckpt["meta"]["cfg"])
            name = config.pop("type")
            if name.startswith("BDE2VID"):
                name = "BDE2VID"
            return _build_spec(name, config, ckpt["state_dict"], device, dtype,
                               is_sequence_model=name == "BDE2VID")
        if "arch" in ckpt:
            config, normalize = _template_model_args(ckpt)
            return _build_spec(ckpt["arch"], config or {}, ckpt["state_dict"], device, dtype,
                               normalize=normalize)
    if "SPADE" in path:
        # the reference wrapper hands load_state_dict to its generator (spade_e2v.py:14-15)
        return _build_spec("SPADEE2VID", {}, {f"generator.{k}": v for k, v in ckpt.items()},
                           device, dtype, normalize=True)
    if "SNN" in path:
        sd = ckpt.get("model", ckpt)
        sd = {k: v for k, v in sd.items() if not any(p.search(k) for p in _SNN_DEAD)}
        return _build_spec("PAEVSNN" if "PAEVSNN" in path else "EVSNN", {}, sd, device, dtype)
    raise ValueError(f"unrecognized checkpoint dialect: {path}")


def _build_spec(name: str, config: dict, state_dict: Mapping[str, Any], device, dtype,
                is_sequence_model: bool = False, normalize: bool = False) -> ModelSpec:
    config = dict(config)
    gen_cfg = config.get("generator", config)
    config.setdefault("num_bins", int(gen_cfg.get("num_bins", 5)))
    model = build_model(name, config, device=device, dtype=dtype)
    load_state_dict_checked(model, state_dict)
    # the JAX package's rule: 4 encoders by default for names with "E2VID",
    # else 3; FireNet and FireNetOrg do not downsample; SPADE takes the
    # reference driver's default of 3
    num_encoders = int(config.get("num_encoders",
                                  gen_cfg.get("num_encoders", 4 if "E2VID" in name else 3)))
    if name in ("FireNet", "FireNetOrg"):
        num_encoders = 0
    if name == "SPADEE2VID":
        num_encoders = 3
    return ModelSpec(name=name, module=model, num_bins=int(config["num_bins"]),
                     num_encoders=num_encoders, is_sequence_model=is_sequence_model,
                     normalize=normalize)
