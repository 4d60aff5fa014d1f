"""Checkpoints for the port (counterpart of ``bde2vid_tpu/eval/checkpoint.py``,
BDE2VID only).

The port's modules keep the reference torch state-dict layout, so a
reference mmengine ``.pth`` (``{"meta": {"cfg": <python config source>},
"state_dict": {...}}``) loads with ``load_state_dict`` and no converter.
``state_dict_from_jax`` turns a flax BDE2VID param tree into that layout —
the inverse of the JAX package's ``convert_state_dict`` +
``_bde2vid_path_fixup``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from bde2vid_tpu_torch.eval.mmengine_cfg import parse_embedded_cfg
from bde2vid_tpu_torch.models.api import ModelSpec, build_model

# tensors the port makes itself: reference-layout extras that a flax tree
# does not carry (the never-called fusion convs, the relative-position index buffer)
_DERIVED = (re.compile(r"(^|\.)fusion_layers\."), re.compile(r"(^|\.)relative_position_index$"))


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


_INDEXED = re.compile(r"(forward_encoder|backward_encoder|feat_attns|blocks|fusion_layers)(\d+)")


def _torch_module_path(path: Tuple[str, ...], leaf: str) -> list:
    out = []
    for i, p in enumerate(path):
        last = i == len(path) - 1
        if p == "decode":
            continue
        if m := re.fullmatch(r"decoder(\d+)([01])", p):
            out += ["decoders", m[1], m[2]]
            if m[2] == "1":
                out.append("conv2d")  # the flax decoder conv is bare; torch wraps it
            continue
        if m := re.fullmatch(r"predI(\d)", p):
            out += ["predI", m[1]]
            continue
        if m := re.fullmatch(r"res(\d+)", p):
            out.append(m[1])
            continue
        if m := _INDEXED.fullmatch(p):
            out += [m[1], m[2]]
            continue
        if p == "gates":
            out.append("Gates")
            continue
        out.append("conv2d" if p == "conv" and last else p)
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax BDE2VID params (``{"params": ...}`` or the bare tree; numpy or
    JAX arrays) -> the port's state dict: HWIO -> OIHW, (in, out) ->
    (out, in), LayerNorm ``scale`` -> ``weight``, module paths renamed
    (``decode/decoderN1`` -> ``decoders.N.1.conv2d``, ``feat_attnsL/resJ`` ->
    ``feat_attns.L.J``, ...). Load it with :func:`load_state_dict_checked`."""
    tree = params.get("params", params)
    sd = {}
    for path, val in _flax_paths(tree):
        val = np.array(val, dtype=np.float32)
        leaf = path[-1]
        mod = _torch_module_path(path[:-1], leaf)
        if leaf == "kernel":
            name, val = "weight", (val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T)
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        sd[".".join(mod + [name])] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def load_torch_file(path: str) -> Dict[str, Any]:
    # mmengine checkpoints pickle more than tensors (meta, message hub), so
    # weights_only loading would refuse them; only open trusted files
    return torch.load(path, map_location="cpu", weights_only=False)


def load_model_from_torch(path: str, device=None, dtype=torch.float32) -> ModelSpec:
    """A reference mmengine BDE2VID ``.pth`` -> ModelSpec on ``device``."""
    ckpt = load_torch_file(path)
    if not (isinstance(ckpt, dict) and "state_dict" in ckpt and "meta" in ckpt):
        raise NotImplementedError(f"{path}: only the mmengine BDE2VID checkpoint dialect is ported")
    config = parse_embedded_cfg(ckpt["meta"]["cfg"])
    name = config.pop("type")
    if not name.startswith("BDE2VID"):
        raise NotImplementedError(f"{path}: model family {name!r} is not ported yet")
    model = build_model("BDE2VID", config, device=device, dtype=dtype)
    load_state_dict_checked(model, ckpt["state_dict"])
    gen_cfg = config.get("generator", config)
    return ModelSpec(
        name="BDE2VID",
        module=model,
        num_bins=int(gen_cfg.get("num_bins", 5)),
        num_encoders=int(gen_cfg.get("num_encoders", 3)),
    )
