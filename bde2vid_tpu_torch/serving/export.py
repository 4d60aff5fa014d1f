"""Ahead-of-time exported serving bundles (``torch.export``); counterpart of
``bde2vid_tpu/serving/export.py``.

- :func:`export_forward` traces a built model's forward with
  ``torch.export`` into programs that take the model's weights as inputs,
  on the device the model lives on.
- :class:`ServingBundle` / :func:`save_bundle` / :func:`load_bundle` package
  the programs, the weights (stored once, whatever the number of programs)
  and the metadata into one zip file. A loader needs torch and the port's
  ``ops`` package only: no model source, no checkpoint dialects.
- :func:`run_voxels` drives a loaded bundle over a voxel sequence.

Sequence models (BDE2VID) get a ``forward`` program over (T, N, B, H, W)
voxels and one tail program for each shorter length, ``forward_tail_<t>``
for t = 1 .. T-1. The model loops over frames in Python, so a trace
specialises T: one program cannot take every length, as the JAX package's
symbolic-T ``forward_tail`` does. Zero-padding a short chunk is not exact
for BDE2VID (padded frames reach real outputs through the attention buffer
and the backward recurrence), and the eval driver runs a short chunk as it
is, so each length gets its own program. Step models get ``step(state,
voxel) -> (out, state)`` and a zero-argument ``init_state()``.

On the kernel path BDE2VID's attention blocks are the registered operators
``bde2vid_torch::swin_block`` and ``bde2vid_torch::window_block``
(``ops/window_attn_cuda.py``): a program holds one node per block call, and
running it launches the CUDA kernels on the card (their plain twins on the
CPU). The programs run where they were exported (``meta["platforms"]``,
``["cuda"]`` or ``["cpu"]``). Data-parallel bundles are not ported yet.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_WEIGHTS = "weights.pt"


# programs that take no weights
_NO_WEIGHTS = ("init_state",)


class _Program(torch.nn.Module):
    """The model's forward on ``args``, its weights the first input
    (``names`` order), its voxels cast to the model's type. The model is
    held outside the module tree, so the exported program keeps no copy of
    its weights."""

    def __init__(self, model: torch.nn.Module, names: List[str], dtype: torch.dtype):
        super().__init__()
        self.__dict__["_model"] = model
        self.names = names
        self.dtype = dtype

    def forward(self, weights: List[torch.Tensor], voxels: torch.Tensor, *state):
        return torch.func.functional_call(self._model, dict(zip(self.names, weights)),
                                          (voxels.to(self.dtype), *state))


class _InitState(torch.nn.Module):
    """The model's first state (zeros), a program of no input."""

    def __init__(self, model: torch.nn.Module, batch: int, height: int, width: int):
        super().__init__()
        self.__dict__["_model"] = model
        self.shape = (batch, height, width)

    def forward(self):
        return self._model.initial_state(*self.shape)


def _weights(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    return {k: v.detach() for k, v in named.items()}


def _platform(spec, platforms: Optional[Sequence[str]]) -> str:
    device = spec.device.type
    platforms = (device,) if platforms is None else tuple(platforms)
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"a bundle runs on one platform of {PLATFORMS}, the device it was "
                         f"exported on; got platforms={platforms}")
    if platforms[0] != device:
        raise ValueError(f"the model lives on {device}: build it on {platforms[0]} to export "
                         f"a {platforms[0]} bundle")
    return device


def _export(module: torch.nn.Module, args: tuple) -> torch.export.ExportedProgram:
    ep = torch.export.export(module, args)
    # dropped, or torch.export.save would store the inputs the trace ran on:
    # the weights again, once per program
    ep.example_inputs = None
    return ep


def export_forward(spec, height: int, width: int, *, seq_len: int = 16, batch: int = 1,
                   platforms: Optional[Sequence[str]] = None,
                   data_parallel: int = 1) -> Dict[str, torch.export.ExportedProgram]:
    """Export a ModelSpec's forward, its weights as the first input of each
    program (``[t for t in weights.values()]`` of :func:`export_spec_bundle`).

    Returns ``{"forward", "forward_tail_1", ..., "forward_tail_<seq_len-1>"}``
    for sequence models (input (T, N, B, H, W) f32 voxels) or ``{"step",
    "init_state"}`` for step models (``step(weights, voxel, state) ->
    (out, state)``, voxel (N, B, H, W); ``init_state()``). (H, W) must
    already be padded to the model's stride. The model is traced in eval
    mode under ``torch.no_grad()``, on its own device (``platforms``, when
    given, must name it)."""
    _platform(spec, platforms)
    if data_parallel != 1:
        raise ValueError(
            f"data_parallel={data_parallel}: data-parallel bundles come with the port's "
            "scale-out (ROADMAP A12, with torch.distributed); export with data_parallel=1")
    module = spec.module
    weights = _weights(module)
    names = list(weights)
    flat = list(weights.values())
    dev = spec.device
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            prog = _Program(module, names, spec.dtype)
            if spec.is_sequence_model:
                fns = {}
                for t in [seq_len, *range(1, seq_len)]:
                    v = torch.zeros((t, batch, spec.num_bins, height, width), device=dev)
                    fns["forward" if t == seq_len else f"forward_tail_{t}"] = \
                        _export(prog, (flat, v))
                return fns
            # distinct tensors: a trace takes inputs that share storage (a
            # cell's zero h and c) for one input
            state = torch.utils._pytree.tree_map(torch.clone,
                                                 module.initial_state(batch, height, width))
            v = torch.zeros((batch, spec.num_bins, height, width), device=dev)
            return {
                "step": _export(prog, (flat, v, state)),
                "init_state": _export(_InitState(module, batch, height, width), ()),
            }
    finally:
        module.train(was_training)


class _Programs(collections.abc.Mapping):
    """Program name -> ExportedProgram, each deserialised at its first use:
    a chunked run takes the forward and one tail of the bundle's programs."""

    def __init__(self, archives: Dict[str, bytes]):
        self._archives = archives
        self._loaded: Dict[str, torch.export.ExportedProgram] = {}

    def __getitem__(self, name: str) -> torch.export.ExportedProgram:
        if name not in self._loaded:
            self._loaded[name] = torch.export.load(io.BytesIO(self._archives[name]))
        return self._loaded[name]

    def __iter__(self):
        return iter(self._archives)

    def __len__(self) -> int:
        return len(self._archives)


@dataclasses.dataclass
class ServingBundle:
    """Exported programs, the weights they take and the metadata."""

    functions: Mapping[str, torch.export.ExportedProgram]
    meta: Dict[str, Any]
    weights: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    _modules: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False,
                                                 compare=False)

    def call(self, name: str, *args):
        """Run program ``name`` on ``args``, after the weights where it takes them."""
        if name not in self._modules:
            self._modules[name] = self.functions[name].module()
        if name not in _NO_WEIGHTS:
            args = (list(self.weights.values()), *args)
        with torch.no_grad():
            return self._modules[name](*args)

    @property
    def device(self) -> torch.device:
        return torch.device(self.meta["platforms"][0])


def export_spec_bundle(spec, height: int, width: int, *, seq_len: int = 16, batch: int = 1,
                       platforms: Optional[Sequence[str]] = None,
                       data_parallel: int = 1) -> ServingBundle:
    """Build the standard bundle for a loaded ModelSpec."""
    platform = _platform(spec, platforms)
    fns = export_forward(spec, height, width, seq_len=seq_len, batch=batch,
                         platforms=(platform,), data_parallel=data_parallel)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": spec.name,
        "kind": "sequence" if spec.is_sequence_model else "step",
        "num_bins": spec.num_bins,
        "num_encoders": spec.num_encoders,
        "num_params": spec.num_params,
        "height": height,
        "width": width,
        "batch": batch,
        "seq_len": seq_len if spec.is_sequence_model else None,
        "platforms": [platform],
        "data_parallel": data_parallel,
        # how partial chunks run: "exact" = the tail program of the chunk's
        # own length (module docstring)
        "tail": "exact" if spec.is_sequence_model else None,
        "dp_impl": None,
        "torch_version": torch.__version__,
        "config": getattr(spec.module, "config", None),
        # SNN/SPADE checkpoints take LegacyNorm'd voxels; recorded so that
        # `run --h5` voxelizes with the right transform
        "normalize": bool(spec.normalize),
    }
    return ServingBundle(functions=fns, meta=meta, weights=_weights(spec.module))


def save_bundle(path: str, bundle: ServingBundle) -> None:
    """Write a bundle zip: ``meta.json``, ``weights.pt`` (one ``torch.save``
    of the weights, on the CPU; stored, as floats barely deflate) and one
    ``fn/<name>.pt2`` (``torch.export.save``) per program."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        meta = {**bundle.meta, "functions": sorted(bundle.functions),
                "weights": list(bundle.weights)}
        zf.writestr("meta.json", json.dumps(meta, indent=2, default=str))
        buf = io.BytesIO()
        torch.save([t.cpu() for t in bundle.weights.values()], buf)
        zf.writestr(_WEIGHTS, buf.getvalue(), compress_type=zipfile.ZIP_STORED)
        for name, ep in bundle.functions.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            zf.writestr(f"fn/{name}.pt2", buf.getvalue())


def load_bundle(path: str) -> ServingBundle:
    """Load a bundle zip back into callable form, on its platform.

    Needs torch and the port's ``ops`` package, which registers the kernel
    operators (``bde2vid_torch::swin_block``, ``::window_block``) that a
    kernel-path program calls; model source and checkpoints are not
    consulted. A ``cuda`` bundle needs a card, and a kernel-path one builds
    its kernels with ``nvcc`` at first use; it never runs on the CPU. Each
    program is deserialised at its first call."""
    import bde2vid_tpu_torch.ops  # noqa: F401  (registers the kernel operators)

    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        platform = meta["platforms"][0]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for cuda and CUDA is not available; "
                               "a bundle runs only on the platform it was exported on")
        tensors = torch.load(io.BytesIO(zf.read(_WEIGHTS)), map_location=platform,
                             weights_only=True)
        weights = dict(zip(meta["weights"], tensors))
        fns = _Programs({name: zf.read(f"fn/{name}.pt2") for name in meta["functions"]})
    return ServingBundle(functions=fns, meta=meta, weights=weights)


def run_voxels(bundle: ServingBundle, voxels) -> np.ndarray:
    """Run a loaded bundle over a voxel sequence.

    ``voxels``: (T, B, H, W) or (T, N, B, H, W) floats (NumPy or torch),
    already padded to the bundle's (height, width). Returns the images
    (T, N, 1, H, W) as f32 NumPy. Sequence bundles call ``forward`` when T
    is the exported seq_len and ``forward_tail_<T>`` when it is shorter;
    step bundles step from ``init_state``."""
    voxels = torch.as_tensor(np.asarray(voxels) if not torch.is_tensor(voxels) else voxels)
    voxels = voxels.to(device=bundle.device, dtype=torch.float32)
    if voxels.ndim == 4:
        voxels = voxels[:, None]
    if voxels.ndim != 5:
        raise ValueError(f"expected (T,[N,]B,H,W) voxels, got {tuple(voxels.shape)}")
    if bundle.meta["kind"] == "sequence":
        t, seq_len = voxels.shape[0], bundle.meta["seq_len"]
        name = "forward" if t == seq_len else f"forward_tail_{t}"
        if name not in bundle.functions:
            raise ValueError(f"sequence bundle exported at T={seq_len} has programs for "
                             f"T=1..{seq_len}, got T={t}; chunk the input to the exported length")
        images = bundle.call(name, voxels)["image"]
    else:
        state = bundle.call("init_state")
        frames = []
        for voxel in voxels:
            out, state = bundle.call("step", voxel, state)
            frames.append(out["image"])
        images = torch.stack(frames)
    return images.float().cpu().numpy()
