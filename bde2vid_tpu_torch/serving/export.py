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
CPU). The programs run on the platform they were exported on
(``meta["platforms"]``, ``["cuda"]`` or ``["cpu"]``); on another card than
the one they were exported on (``meta["device"]``) their constants, the
window-attention index maps among them, move to the loading rank's card.

Data-parallel bundles (``data_parallel=D``): the programs take the batch's
shard, ``batch // D`` rows, and :func:`run_voxels` runs a batch of
``batch`` in D shards over the first D ranks of a ``torch.distributed``
group (``torchrun --nproc_per_node D``), one shard a rank, and gathers the
whole batch on every rank. :func:`serving_mesh` gives the 1-D "data" mesh
of those ranks.
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


def _exact(device: torch.device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _data_parallel(bundle_or_dp) -> int:
    if isinstance(bundle_or_dp, int):
        return bundle_or_dp
    return int(bundle_or_dp.meta.get("data_parallel") or 1)


def _check_ranks(dp: int) -> int:
    """The number of ranks, which must be at least ``dp``."""
    from bde2vid_tpu_torch.parallel.mesh import world_size

    ranks = world_size()
    if ranks < dp:
        raise ValueError(f"bundle exported for {dp}-way data parallelism but only {ranks} "
                         f"rank(s) are in the process group: start it with torchrun "
                         f"--nproc_per_node {dp}")
    return ranks


def serving_mesh(bundle_or_dp):
    """The 1-D "data" ``DeviceMesh`` of the first ``data_parallel`` ranks
    that serve a data-parallel bundle (or a count); every rank of the group
    must call it. Raises ValueError when fewer ranks are there; None for
    one rank outside a process group."""
    from torch.distributed.device_mesh import DeviceMesh

    from bde2vid_tpu_torch.parallel.mesh import is_distributed, mesh_device_type

    dp = _data_parallel(bundle_or_dp)
    _check_ranks(dp)
    if not is_distributed():
        return None
    return DeviceMesh(mesh_device_type(), torch.arange(dp), mesh_dim_names=("data",))


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
    given, must name it). ``data_parallel=D`` traces the shard a rank runs,
    N = ``batch // D``; the batch must divide over D. Exporting needs no
    process group."""
    _platform(spec, platforms)
    if data_parallel < 1 or batch % data_parallel:
        raise ValueError(f"batch={batch} does not divide over data_parallel={data_parallel}")
    batch //= data_parallel
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

    def __init__(self, archives: Dict[str, bytes], moves: Optional[Dict[str, str]] = None):
        self._archives = archives
        self._moves = moves  # {exported device: this rank's} where they differ
        self._loaded: Dict[str, torch.export.ExportedProgram] = {}

    def __getitem__(self, name: str) -> torch.export.ExportedProgram:
        if name not in self._loaded:
            ep = torch.export.load(io.BytesIO(self._archives[name]))
            if self._moves:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, self._moves)
            self._loaded[name] = ep
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
        "device": str(_exact(spec.device)),
        "data_parallel": data_parallel,
        # how partial chunks run: "exact" = the tail program of the chunk's
        # own length (module docstring)
        "tail": "exact" if spec.is_sequence_model else None,
        "dp_impl": "torch.distributed" if data_parallel > 1 else None,
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
    program is deserialised at its first call, and moved to the current
    card where it was exported on another."""
    import bde2vid_tpu_torch.ops  # noqa: F401  (registers the kernel operators)

    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        platform = meta["platforms"][0]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for cuda and CUDA is not available; "
                               "a bundle runs only on the platform it was exported on")
        here = str(_exact(torch.device(platform)))
        exported = meta.get("device", here)
        tensors = torch.load(io.BytesIO(zf.read(_WEIGHTS)), map_location=here,
                             weights_only=True)
        weights = dict(zip(meta["weights"], tensors))
        fns = _Programs({name: zf.read(f"fn/{name}.pt2") for name in meta["functions"]},
                        {exported: here} if exported != here else None)
    return ServingBundle(functions=fns, meta=meta, weights=weights)


def run_voxels(bundle: ServingBundle, voxels, chunked: bool = False) -> np.ndarray:
    """Run a loaded bundle over a voxel sequence.

    ``voxels``: (T, B, H, W) or (T, N, B, H, W) floats (NumPy or torch),
    already padded to the bundle's (height, width). Returns the images
    (T, N, 1, H, W) as f32 NumPy. Sequence bundles call ``forward`` when T
    is the exported seq_len and ``forward_tail_<T>`` when it is shorter;
    with ``chunked`` they run any T in chunks of seq_len (each from fresh
    state), the last through the tail program of its own length. Step
    bundles step from ``init_state``. A data-parallel bundle needs a
    process group of at least ``data_parallel`` ranks (ValueError
    otherwise) and the exported batch: every rank calls it with the whole
    batch, rank r < D runs rows [r N/D, (r+1) N/D), and every rank returns
    all N."""
    voxels = torch.as_tensor(np.asarray(voxels) if not torch.is_tensor(voxels) else voxels)
    voxels = voxels.to(device=bundle.device, dtype=torch.float32)
    if voxels.ndim == 4:
        voxels = voxels[:, None]
    if voxels.ndim != 5:
        raise ValueError(f"expected (T,[N,]B,H,W) voxels, got {tuple(voxels.shape)}")
    dp = _data_parallel(bundle)
    if dp == 1:
        return _run_local(bundle, voxels, chunked).float().cpu().numpy()
    import torch.distributed as dist

    from bde2vid_tpu_torch.parallel.mesh import rank

    ranks, index = _check_ranks(dp), rank()
    n = voxels.shape[1]
    if n != bundle.meta["batch"]:
        raise ValueError(f"data-parallel bundle exported at batch={bundle.meta['batch']}, got "
                         f"N={n}")
    per = n // dp
    if index < dp:  # one gather at the end, not one a chunk
        local = _run_local(bundle, voxels[:, index * per:(index + 1) * per], chunked).float()
    else:  # a rank past the mesh serves no shard
        local = voxels.new_zeros((voxels.shape[0], per, 1, *voxels.shape[-2:]))
    parts = [torch.empty_like(local) for _ in range(ranks)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts[:dp], dim=1).cpu().numpy()


def _run_local(bundle: ServingBundle, voxels: torch.Tensor, chunked: bool) -> torch.Tensor:
    if chunked and bundle.meta["kind"] == "sequence":
        size = bundle.meta["seq_len"]
        return torch.cat([_run_shard(bundle, voxels[s:s + size])
                          for s in range(0, voxels.shape[0], size)])
    return _run_shard(bundle, voxels)


def _run_shard(bundle: ServingBundle, voxels: torch.Tensor) -> torch.Tensor:
    """The programs over (T, n, B, H, W) voxels at their exported batch:
    the images (T, n, 1, H, W) on the bundle's device."""
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
    return images
