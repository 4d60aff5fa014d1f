"""The JAX package's checkpoint format in the port (``eval/msgpack_checkpoint.py``),
held to flax and to the JAX package on the CPU:

- the decoder reads ``flax.serialization.to_bytes`` bit for bit (a bfloat16
  leaf, numpy scalars, every msgpack width, a chunked record), the encoder
  writes flax's bytes for the same tree, and ``msgpack_restore`` reads them;
- the port's state dict -> flax tree conversion is the inverse of
  ``state_dict_from_jax`` on the variables of BDE2VID, E2VIDRecurrent with
  BatchNorm, FireNet and EVSNN;
- a small BDE2VID saved by JAX ``save_checkpoint`` and loaded by the port
  gives JAX's forward at atol 2e-4 (the bar of tests/test_bde2vid.py), and the
  port's file of it loads in JAX ``load_checkpoint`` to the same output;
- FireNet the same way, one step; ``rec_snn`` on an EVSNN ``.msgpack`` writes
  the PNGs of the same weights as a ``.pth``;
- an orbax directory is refused by name.
"""

import os

import numpy as np
import pytest
import torch

import flax.serialization as fs
import jax
import jax.numpy as jnp

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from bde2vid_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
from bde2vid_tpu_torch.eval import msgpack_checkpoint as fm
from bde2vid_tpu_torch.eval.checkpoint import state_dict_from_jax
from bde2vid_tpu_torch.eval.rec_snn import main as port_rec_snn
from tests.test_torch_e2vid import seeded_tree
from tests.test_torch_lpips import flax_init_by_shape
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401 (a fixture)

BDE2VID_CFG = {"generator": {"num_bins": 5, "basechannels": 4, "num_encoders": 2, "ks": 3,
                             "num_res_blocks": 1, "buffer_index": [-1, 0, 1], "depths": [1, 2],
                             "num_heads": 2, "window_size": [4, 4]}}
FAMILIES = {
    "BDE2VID": BDE2VID_CFG,
    "E2VIDRecurrent": {"num_bins": 5, "num_encoders": 2, "base_num_channels": 8,
                       "num_residual_blocks": 1, "norm": "BN"},
    "FireNet": {"num_bins": 5, "base_num_channels": 8, "num_residual_blocks": 2},
    "EVSNN": {},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_variables(name, seed):
    """The JAX model and its variables (by shape, filled from a numpy seed)."""
    jm = jax_build(name, FAMILIES[name])
    if getattr(jm, "is_sequence_model", False):
        x = jnp.zeros((2, 1, 16, 16, 5))
        init = lambda: jm.init(jax.random.PRNGKey(0), x)
    else:
        x = jnp.zeros((1, 16, 16, 5))
        init = lambda: jm.init(jax.random.PRNGKey(0), x, jm.initial_state(1, 16, 16))
    return jm, jax.tree_util.tree_map(np.asarray, seeded_tree(jax.eval_shape(init), seed))


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
        return
    if want is None or isinstance(want, (bool, int, float, str)):
        assert type(got) is type(want) and got == want
        return
    if isinstance(got, torch.Tensor):
        assert isinstance(want, jax.Array) and want.dtype == jnp.bfloat16
        got, want = got.view(torch.uint16).numpy(), np.asarray(want).view(np.uint16)
    want = np.asarray(want) if isinstance(want, jax.Array) else want
    assert type(got) is type(want)
    assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
    np.testing.assert_array_equal(got, want)


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                     "bias": rng.normal(size=(8,)).astype(np.float32)},
            "wide": rng.normal(size=(70000,)).astype(np.float32),  # bin32
            "half": jnp.asarray(rng.normal(size=(50, 70)), jnp.bfloat16),
            "ints": np.arange(-40, 300, dtype=np.int64),
            "flags": np.array([True, False]),
            "empty": np.zeros((0, 3), np.float16),
        },
        "scalars": {"f": np.float32(2.5), "i": np.int64(-70000), "b": np.float64(1e300)},
        "python": {"big": 2**40, "neg": -129, "small": -31, "x": 0.1, "none": None, "t": True,
                   "s": "k" * 300},
        **{f"k{i:02d}": np.float32(i) for i in range(20)},  # map16
    }


def _flax_bytes(tree):
    """flax's bytes of ``tree`` as the JAX package's save_checkpoint makes
    them (``jax.device_get`` sorts each map) where numpy scalars stay
    scalars."""
    return fs.to_bytes(jax.tree_util.tree_map(lambda x: x, tree))


def _torch_leaves(tree):
    if isinstance(tree, dict):
        return {k: _torch_leaves(v) for k, v in tree.items()}
    if isinstance(tree, jax.Array):
        return torch.from_numpy(np.asarray(tree).view(np.uint16).copy()).view(torch.bfloat16)
    return tree


@pytest.mark.parametrize("chunk", [None, 4096])
def test_flax_bytes_both_ways(monkeypatch, chunk):
    """``chunk``: flax's and the port's MAX_CHUNK_SIZE shrunk so that the
    larger leaves (the bf16 one included) go as chunked records."""
    if chunk is not None:
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    tree = _mixed_tree()
    data = _flax_bytes(tree)
    if chunk is not None:
        assert data.count(fm.CHUNKED.encode()) == 2
    _assert_same_tree(fm.from_bytes(data), tree)
    assert fm.to_bytes(_torch_leaves(tree)) == data
    _assert_same_tree(fs.msgpack_restore(fm.to_bytes(_torch_leaves(tree))),
                      jax.tree_util.tree_map(lambda x: x, tree))


def test_decoder_refuses_truncated_and_trailing_bytes():
    data = fm.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        fm.from_bytes(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        fm.from_bytes(data + b"\x00")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_state_dict_conversion_inverts_state_dict_from_jax(name):
    _, variables = jax_variables(name, seed=3)
    tree = fm.flax_tree_from_state_dict(state_dict_from_jax(variables), name)
    _assert_same_tree(tree, variables)


@pytest.fixture(scope="module")
def bde2vid_files(tmp_path_factory):
    """A small BDE2VID's variables saved by JAX ``save_checkpoint``; its JAX
    output on seeded voxels (T=3, 16x16)."""
    root = tmp_path_factory.mktemp("msgpack")
    jm, variables = jax_variables("BDE2VID", seed=4)
    path = str(root / "epoch_7.msgpack")
    jax_save_checkpoint(path, variables, "BDE2VID", BDE2VID_CFG)
    v = np.random.default_rng(5).normal(size=(3, 1, 16, 16, 5)).astype(np.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want = np.asarray(jm.apply(jvars, jnp.asarray(v))[0]["image"])[:, 0, :, :, 0]
    return root, path, v, want


def test_jax_checkpoint_gives_jax_forward_in_the_port(bde2vid_files):
    _, path, v, want = bde2vid_files
    spec = fm.load_msgpack_checkpoint(path, device="cpu")
    assert (spec.name, spec.num_bins, spec.num_encoders, spec.is_sequence_model) == (
        "BDE2VID", 5, 2, True)
    with torch.no_grad():
        got = spec.module(torch.from_numpy(v.transpose(0, 1, 4, 2, 3).copy()))["image"]
    np.testing.assert_allclose(got[:, 0, 0].numpy(), want, atol=2e-4, rtol=0)


def test_port_checkpoint_loads_in_jax(bde2vid_files):
    root, path, v, want = bde2vid_files
    spec = fm.load_msgpack_checkpoint(path, device="cpu")
    out = str(root / "port.msgpack")
    fm.save_msgpack_checkpoint(out, spec.module, "BDE2VID", BDE2VID_CFG)
    assert open(out, "rb").read() == open(path, "rb").read()
    with flax_init_by_shape():
        jspec = jax_load_checkpoint(out)
    got = np.asarray(jspec.module.apply(jspec.params, jnp.asarray(v))[0]["image"])[:, 0, :, :, 0]
    np.testing.assert_array_equal(got, want)


def test_step_model_checkpoint_matches_jax(tmp_path):
    jm, variables = jax_variables("FireNet", seed=6)
    path = str(tmp_path / "firenet.msgpack")
    jax_save_checkpoint(path, variables, "FireNet", FAMILIES["FireNet"])
    spec = fm.load_msgpack_checkpoint(path, device="cpu")
    assert (spec.name, spec.num_encoders, spec.is_sequence_model) == ("FireNet", 3, False)
    v = np.random.default_rng(7).normal(size=(1, 18, 22, 5)).astype(np.float32)
    out, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(v),
                      jm.initial_state(1, 18, 22))
    with torch.no_grad():
        got, _ = spec.module(torch.from_numpy(v.transpose(0, 3, 1, 2).copy()),
                             spec.initial_state(1, 18, 22))
    np.testing.assert_allclose(got["image"][0, 0].numpy(), np.asarray(out["image"])[0, :, :, 0],
                               atol=2e-4, rtol=0)


def _write_stream(path, rng, n, hw):
    ts = 1.6e9 + np.sort(rng.uniform(0.0, 0.5, n))
    with open(path, "w") as fp:
        fp.writelines(f"# header {i}\n" for i in range(10))
        for t, x, y, p in zip(ts, rng.integers(0, hw[1], n), rng.integers(0, hw[0], n),
                              rng.integers(0, 2, n)):
            fp.write(f"{t:.9f} {x} {y} {p}\n")


def test_rec_snn_takes_a_msgpack(tmp_path):
    """The JAX package's EVSNN checkpoint: the PNGs of the same weights as a
    bare ``.pth``."""
    _, variables = jax_variables("EVSNN", seed=8)
    msgpack = str(tmp_path / "evsnn.msgpack")
    jax_save_checkpoint(msgpack, variables, "EVSNN", {})
    pth = str(tmp_path / "EVSNN_same.pth")
    torch.save(state_dict_from_jax(variables), pth)
    hw = (20, 24)
    stream = str(tmp_path / "events.txt")
    _write_stream(stream, np.random.default_rng(9), 2 * hw[0] * hw[1] // 2 + 10, hw)
    outs = []
    for i, ckpt in enumerate((msgpack, pth)):
        out = tmp_path / f"out{i}"
        assert port_rec_snn(["-network", "EVSNN", "-path_to_pretrain_models", ckpt,
                             "-path_to_event_files", stream, "-save_path", str(out),
                             "-height", str(hw[0]), "-width", str(hw[1]),
                             "--device", "cpu"]) == 0
        names = sorted(os.listdir(out / "EVSNN"))
        outs.append({n: (out / "EVSNN" / n).read_bytes() for n in names})
    assert len(outs[0]) == 10 and outs[0] == outs[1]


def test_orbax_directory_is_refused(tmp_path):
    state = tmp_path / "epoch_2.state"
    os.makedirs(state)
    (tmp_path / "epoch_2.state.json").write_text('{"model": "FireNet", "config": {}, '
                                                 '"train_state": true}')
    with pytest.raises(ValueError, match="orbax"):
        fm.load_msgpack_checkpoint(str(state), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        fm.read_msgpack_state_dict(str(state))
