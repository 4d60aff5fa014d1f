"""Checkpoints in the JAX package's format: flax msgpack bytes plus a
``<path>.json`` sidecar ``{"model": name, "config": model config}`` (the
JAX package's ``train/trainer.py::save_checkpoint`` / ``load_checkpoint``),
read and written without flax or the ``msgpack`` module.

The bytes are what ``flax.serialization.to_bytes`` makes of a variables
tree ``{"params": ..., "batch_stats": ...}``: msgpack maps, arrays, str,
bin, ints, floats, nil and bool, with two extension types, 1 (an ndarray:
a packed ``(shape, dtype name, C-order bytes)`` triple) and 3 (a numpy
scalar, packed as a 0-d ndarray). A leaf above ``MAX_CHUNK_SIZE`` bytes is
stored as a ``__msgpack_chunked_array__`` record of flat chunks.
``to_bytes`` packs the way msgpack-python does (smallest encodings,
``use_bin_type``), with each map's keys sorted as ``jax.device_get``
leaves them, so the bytes equal flax's for the same tree. ``bfloat16``
leaves are read as torch ``bfloat16`` tensors (numpy has no such type),
every other leaf as a numpy array.

``flax_tree_from_state_dict`` is the port's copy of the JAX package's
``eval/checkpoint.py::convert_state_dict`` with ``_map_module_path`` (and
``_bde2vid_path_fixup`` for BDE2VID): a port state dict -> the flax tree;
``eval/checkpoint.py::state_dict_from_jax`` is its inverse. An orbax
checkpoint (a directory, the JAX CLI's ``.state``) is refused by name.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# leaves above this many bytes are chunked (flax.serialization.MAX_CHUNK_SIZE)
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def check_not_orbax(path: str) -> None:
    """Raise where ``path`` is an orbax checkpoint directory (the JAX CLI's
    ``.state`` train state, or an orbax params checkpoint): the port reads
    neither, and its own ``.state`` is a file."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory (the JAX package's "
                         "save_train_state_orbax / save_checkpoint_orbax), which the port "
                         "does not read; resume or evaluate from its epoch_N.msgpack instead")


# ---------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _dtype_leaf(shape, name: str, buf) -> Any:
    """An ndarray extension's payload -> a numpy array, or a torch bfloat16
    tensor for ``bfloat16``."""
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        raw = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: memoryview):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, name, buf = _decode(_Reader(data), raw=True)
        leaf = _dtype_leaf(shape, name.decode() if isinstance(name, bytes) else name, buf)
        return leaf if code == EXT_NDARRAY else leaf[()]
    if code == EXT_COMPLEX:
        re_, im = _decode(_Reader(data))
        return complex(re_, im)
    raise ValueError(f"unsupported msgpack extension type {code}")


def _decode(r: _Reader, raw: bool = False):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in fixed:
        return fixed[b]
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return _str(r, r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
    if b in (0xDC, 0xDD):
        return [_decode(r, raw) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    data = bytes(r.take(n))
    return data if raw else data.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> Dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        out[k] = _decode(r, raw)
    return out


def _unchunk(tree):
    """Chunked-array records -> whole leaves (flax ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = (torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
                else np.concatenate(chunks))
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def from_bytes(data) -> Any:
    """flax msgpack bytes -> the tree (``flax.serialization.msgpack_restore``)."""
    r = _Reader(data)
    tree = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return _unchunk(tree)


# ---------------------------------------------------------------- encoding


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    for lo, hi, head, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0, 0xFFFF, 0xCD, ">H"), (-0x8000, -1, 0xD1, ">h"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -1, 0xD2, ">i"),
                              (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -1, 0xD3, ">q")):
        if lo <= n <= hi:
            return bytes([head]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, heads) -> bytes:
    """A length header: a fix type up to ``fix_max``, else the smallest of
    ``heads`` ((head byte, struct format, max), ...)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for head, fmt, top in heads:
        if n <= top:
            return bytes([head]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _pack_len(len(b), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                        (0xDB, ">I", 0xFFFFFFFF))) + b


def _pack_bin(b: bytes) -> bytes:
    return _pack_len(len(b), None, -1, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                        (0xC6, ">I", 0xFFFFFFFF))) + b


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _pack_len(len(data), None, -1, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                               (0xC9, ">I", 0xFFFFFFFF)))
    return head + struct.pack(">b", code) + data


def _array_payload(x) -> bytes:
    """The packed ``(shape, dtype name, C-order bytes)`` triple of a numpy
    array or a torch tensor (bfloat16 through its uint16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name, data = tuple(x.shape), "bfloat16", x.view(torch.uint16).numpy().tobytes()
        else:
            x = x.numpy()
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        shape, name, data = x.shape, x.dtype.name, x.tobytes("C")
    return (_pack_len(3, 0x90, 15, ()) + _pack_len(len(shape), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                                                         (0xDD, ">I", 0xFFFFFFFF)))
            + b"".join(_pack_int(int(d)) for d in shape) + _pack_str(name) + _pack_bin(data))


def _chunked(x) -> Dict:
    """A leaf above ``MAX_CHUNK_SIZE`` bytes as flax's chunked record."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, flat.shape[0], size))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _encode(x, in_record: bool = False) -> bytes:
    """msgpack bytes of ``x``; ``in_record``: inside a chunked record, whose
    maps keep their order and whose leaves are not chunked again."""
    if x is None:
        return b"\xc0"
    if x is True or x is False:
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, (np.ndarray, torch.Tensor)):
        if not in_record and _nbytes(x) > MAX_CHUNK_SIZE:
            return _encode(_chunked(x), in_record=True)
        return _pack_ext(EXT_NDARRAY, _array_payload(x))
    if isinstance(x, np.generic):
        return _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x)))
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        return _pack_str(x)
    if isinstance(x, bytes):
        return _pack_bin(x)
    if isinstance(x, Mapping):
        # other maps are sorted, as jax.device_get leaves a params tree
        keys = list(x) if in_record else sorted(x)
        head = _pack_len(len(keys), 0x80, 15, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
        return head + b"".join(_pack_str(str(k)) + _encode(x[k], in_record) for k in keys)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def to_bytes(tree) -> bytes:
    """A tree of dicts with array, tensor, numpy-scalar or Python leaves ->
    flax msgpack bytes (``flax.serialization.to_bytes`` of the same tree
    after ``jax.device_get``)."""
    return _encode(tree)


# ------------------------------------------------- state dict <-> flax tree

_LIST_RENAMES = {"encoders": "encoder", "decoders": "decoder", "resblocks": "resblock"}
_FLAT_RENAMES = {"conv2d": "conv", "Gates": "gates"}


def _map_module_path(parts) -> Tuple[list, bool]:
    """A torch module path -> (the flax module path, is_transposed)."""
    out, is_transposed, i = [], False, 0
    while i < len(parts):
        p = parts[i]
        if p in _LIST_RENAMES and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{_LIST_RENAMES[p]}{parts[i + 1]}")
            i += 2
            continue
        if p == "transposed_conv2d":
            is_transposed = True
        elif p in _FLAT_RENAMES:
            out.append(_FLAT_RENAMES[p])
        elif p in ("encoder", "decoder") and out and out[-1].startswith("trans_"):
            pass  # torch transformer wrappers nest a .encoder/.decoder module; flax does not
        elif p.isdigit() and out:
            out[-1] = f"{out[-1]}{p}"  # a Sequential index folds into its parent's name
        else:
            out.append(p)
        i += 1
    return out, is_transposed


def _convert_leaf(leaf: str, val: np.ndarray, is_transposed: bool):
    """-> (collection, flax leaf name, value), or None to skip."""
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", leaf[len("running_"):], val.astype(np.float32)
    if leaf == "in_proj_weight":
        return "params", "in_proj_kernel", val.T.astype(np.float32)
    if leaf == "weight":
        if val.ndim == 4:
            k = (val[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if is_transposed
                 else val.transpose(2, 3, 1, 0))
            return "params", "kernel", np.ascontiguousarray(k, np.float32)
        if val.ndim == 2:
            return "params", "kernel", val.T.astype(np.float32)
        return "params", "scale", val.astype(np.float32)
    return "params", leaf, val.astype(np.float32)


_DECODE_SLOT = re.compile(r"decoder\d+[01]|predI[01]")


def _bde2vid_path_fixup(path):
    """BDE2VID's torch -> flax path shifts: its decoder and prediction convs
    live in the scanned ``decode`` module as bare convs, the decoder's norm
    is the sibling ``decoderN1_norm``, and the depth-0 fallback resblocks
    ``feat_attnsN{j}`` become ``feat_attnsN/res{j}``."""
    out = []
    for i, p in enumerate(path):
        if _DECODE_SLOT.fullmatch(p) and (not out or out[-1] != "decode"):
            out += ["decode", p]
            continue
        if p == "conv" and out and _DECODE_SLOT.fullmatch(out[-1]):
            continue
        if p == "norm_layer" and out and re.fullmatch(r"decoder\d+1", out[-1]):
            out[-1] += "_norm"
            continue
        m = re.fullmatch(r"(feat_attns\d)([1-9]\d*)", p)
        if m and i + 1 < len(path) and path[i + 1].startswith("conv"):
            out += [m[1], f"res{m[2]}"]
            continue
        out.append(p)
    return tuple(out)


def flax_tree_from_state_dict(state_dict: Mapping[str, Any], model_name: str) -> Dict:
    """A port state dict -> the flax variables tree ``{"params": ...,
    "batch_stats": ...}`` of the JAX package's model (f32 numpy leaves):
    OIHW -> HWIO (a transposed conv's spatially flipped), (out, in) -> (in,
    out), a 1-D ``weight`` -> ``scale``, running statistics ->
    ``batch_stats``; the tensors the port derives itself (never-called
    fusion convs, the relative-position index) are left out."""
    from bde2vid_tpu_torch.eval.checkpoint import _DERIVED

    fixup = _bde2vid_path_fixup if model_name == "BDE2VID" else tuple
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        if any(p.search(key) for p in _DERIVED):
            continue
        val = val.detach().cpu().float().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        parts = key.split(".")
        path, is_transposed = _map_module_path(parts[:-1])
        conv = _convert_leaf(parts[-1], val, is_transposed)
        if conv is None:
            continue
        coll, name, value = conv
        *mods, name = fixup(tuple(path) + (name,))
        node = tree[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = value
    if not tree["batch_stats"]:
        tree.pop("batch_stats")
    return tree


# ------------------------------------------------------------- checkpoints


def save_msgpack_checkpoint(path: str, model_or_state_dict, model_name: str,
                            config: Dict) -> None:
    """The JAX package's ``save_checkpoint`` without flax: the flax bytes of
    the model's variables tree at ``path`` and the ``{"model", "config"}``
    sidecar at ``path + ".json"``."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    with open(path, "wb") as fp:
        fp.write(to_bytes(flax_tree_from_state_dict(sd, model_name)))
    with open(path + ".json", "w") as fp:
        json.dump({"model": model_name, "config": config}, fp)


def read_msgpack_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The port state dict held by a flax msgpack checkpoint (f32)."""
    from bde2vid_tpu_torch.eval import checkpoint

    check_not_orbax(path)
    with open(path, "rb") as fp:
        tree = from_bytes(fp.read())

    def f32(x):
        if isinstance(x, dict):
            return {k: f32(v) for k, v in x.items()}
        return x.float().numpy() if isinstance(x, torch.Tensor) else x

    return checkpoint.state_dict_from_jax(f32(tree))


def load_msgpack_checkpoint(path: str, device=None, dtype=torch.float32):
    """A flax msgpack checkpoint and its sidecar -> ModelSpec on ``device``
    (CUDA unless the CPU is asked for), loaded strictly (the JAX package's
    ``load_checkpoint``): ``num_bins`` from the config, else its
    ``generator``, else 5; ``num_encoders`` from the ``generator`` or the
    top level, else 3."""
    from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked
    from bde2vid_tpu_torch.models.api import ModelSpec, build_model

    check_not_orbax(path)
    with open(path + ".json") as fp:
        meta = json.load(fp)
    name, config = meta["model"], meta["config"]
    model = build_model(name, config, device=device, dtype=dtype)
    load_state_dict_checked(model, read_msgpack_state_dict(path))
    gen_cfg = config.get("generator", config)
    nb = int(config.get("num_bins", config.get("generator", {}).get("num_bins", 5)))
    return ModelSpec(name=name, module=model, num_bins=nb,
                     num_encoders=int(gen_cfg.get("num_encoders", 3)),
                     is_sequence_model=bool(getattr(model, "is_sequence_model", False)))
