"""The port's serving bundles (``bde2vid_tpu_torch/serving``) against the
JAX package's (``bde2vid_tpu/serving``) on the CPU: the same seeded weights
(``state_dict_from_jax``) and voxels through both packages' export, save,
load and run, and through both CLIs; every tail length against the live
model; the kernel-path export (the operators' CPU twins) against the
unfused one; the repair of C15 (an export left fake tensors in the
window-attention index caches); the refusals; and a run from a bundle in a
process that never imports the port's model code. Tolerance 2e-4 against
JAX, 1e-6 between the port's bundles and its live model."""

import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models.api import ModelSpec as JaxSpec
from bde2vid_tpu.serving import export_spec_bundle as jax_export_bundle
from bde2vid_tpu.serving import load_bundle as jax_load_bundle
from bde2vid_tpu.serving import run_voxels as jax_run_voxels
from bde2vid_tpu.serving import save_bundle as jax_save_bundle
from bde2vid_tpu.serving.__main__ import main as jax_cli
from bde2vid_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import ModelSpec, build_model, run_sequence
from bde2vid_tpu_torch.nn import window_attention as twa
from bde2vid_tpu_torch.serving import (
    export_forward,
    export_spec_bundle,
    load_bundle,
    run_voxels,
    save_bundle,
)
from bde2vid_tpu_torch.serving.__main__ import main as port_cli
from bde2vid_tpu_torch.utils.padding import CropParameters
from tests.test_torch_e2vid import nchw, seeded_tree
from tests.test_torch_lpips import flax_init_by_shape
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401 (a fixture)

ATOL = 2e-4
H, W, B = 32, 48, 5
# the JAX package's serving test configurations (tests/test_serving.py:31, :44)
SEQ_GEN = {"num_bins": B, "basechannels": 8, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
           "buffer_index": [-1, 0, 1], "depths": [1, 1], "num_heads": 2, "window_size": [4, 4]}
E2VID_CFG = {"num_bins": B, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1}
# the step families and sizes of tests/test_serving.py:240-247
STEP_FAMILIES = {
    "E2VIDRecurrent": (E2VID_CFG, (H, W)),
    "FireNet": ({"num_bins": B, "base_num_channels": 8}, (H, W)),
    "SPADEE2VID": ({}, (32, 40)),
    "EITR": ({"num_bins": B, "norm": None, "d_model": 32, "dim_feedforward": 64, "nhead": 4,
              "channels": [8, 16, 32, 32]}, (H, W)),
    "EVSNN": ({}, (32, 40)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(name, cfg, h, w, seed, t=None):
    jm = jax_build(name, dict(cfg))
    if t is not None:
        init = lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((t, 1, h, w, B)))
    else:
        init = lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, B)),
                               jm.initial_state(1, h, w))
    return jm, seeded_tree(jax.eval_shape(init), seed)


def _port_model(name, cfg, variables, kernel=False):
    model = build_model(name, dict(cfg), device="cpu")
    load_state_dict_checked(model, state_dict_from_jax(variables))
    twa.set_attention_kernel(model, kernel)
    return model


@pytest.fixture(scope="module")
def bde2vid():
    """(JAX spec, port model) of the small BDE2VID from one numpy seed."""
    cfg = {"generator": SEQ_GEN}
    jm, variables = _jax_variables("BDE2VID", cfg, H, W, seed=3, t=3)
    jspec = JaxSpec(name="BDE2VID", module=jm, params=variables, num_bins=B, num_encoders=2,
                    is_sequence_model=True)
    return jspec, _port_model("BDE2VID", cfg, variables)


def _spec(model, name="BDE2VID", num_encoders=2):
    return ModelSpec(name=name, module=model, num_bins=B, num_encoders=num_encoders,
                     is_sequence_model=name == "BDE2VID")


def _voxels(seed, t, h=H, w=W):
    """(T, 1, H, W, C) f32 in the JAX layout."""
    return np.random.default_rng(seed).normal(size=(t, 1, h, w, B)).astype(np.float32)


def _live(model, vox):
    with torch.no_grad():
        return model(nchw(vox))["image"].numpy()


# ---------------------------------------------------------------- C15


@pytest.mark.parametrize("kernel,window,maps", [
    (True, [3, 3], {"partition", "taps", "bias_rows", "blend_unc", "blend_idx"}),
    (False, [4, 4], {"partition", "taps", "bias_rows"}),
])
def test_exports_leave_the_index_caches_real(kernel, window, maps):
    """C15: from cold caches, an export at T=3 and one at T=2 both succeed;
    the caches hold real tensors only, and an eager forward after the
    exports is bit-equal to one before them. Depth 2 a level: the dilated
    blocks read every cached map (the kernel path's odd 3x3 windows the
    blend maps too)."""
    torch.manual_seed(5)
    gen = dict(SEQ_GEN, depths=[2, 2], window_size=window)
    model = build_model("BDE2VID", {"generator": gen}, device="cpu")
    twa.set_attention_kernel(model, kernel)
    vox = nchw(_voxels(1, 3))
    with torch.no_grad():
        before = model(vox)["image"]
    twa._UPLOADED.clear()
    for t in (3, 2):
        fns = export_forward(_spec(model), H, W, seq_len=t)
        assert set(fns) == {"forward", *(f"forward_tail_{i}" for i in range(1, t))}
    assert {k[0] for k in twa._UPLOADED} == maps
    assert all(type(v) is torch.Tensor for v in twa._UPLOADED.values())
    with torch.no_grad():
        after = model(vox)["image"]
    assert type(after) is torch.Tensor
    assert torch.equal(after, before)


# ---------------------------------------------------------------- sequence bundles


@pytest.fixture(scope="module")
def seq_bundles(bde2vid, tmp_path_factory):
    """The small BDE2VID exported at T=3 by both packages, saved and loaded."""
    jspec, model = bde2vid
    root = tmp_path_factory.mktemp("seq")
    jpath, ppath = str(root / "jax.zip"), str(root / "port.zip")
    jax_save_bundle(jpath, jax_export_bundle(jspec, H, W, seq_len=3, platforms=("cpu",)))
    save_bundle(ppath, export_spec_bundle(_spec(model), H, W, seq_len=3, platforms=("cpu",)))
    return jax_load_bundle(jpath), load_bundle(ppath), ppath


def test_sequence_bundle_matches_jax_and_describes_itself(bde2vid, seq_bundles):
    jbundle, bundle, path = seq_bundles
    vox = _voxels(2, 3)
    got = run_voxels(bundle, nchw(vox))
    want = jax_run_voxels(jbundle, jnp.asarray(vox))
    np.testing.assert_allclose(got, nchw(want).numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _live(bde2vid[1], vox), atol=1e-6, rtol=0)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        names = zf.namelist()
    assert set(jbundle.meta) - {"jax_version"} <= set(meta)
    assert meta["functions"] == ["forward", "forward_tail_1", "forward_tail_2"]
    assert (meta["tail"], meta["platforms"], meta["seq_len"], meta["torch_version"]) == (
        "exact", ["cpu"], 3, torch.__version__)
    assert meta["num_params"] == bde2vid[0].num_params + 2608  # + the unused fusion_layers
    # each weight once: one weights file, programs that hold none
    assert sorted(names) == ["fn/forward.pt2", "fn/forward_tail_1.pt2", "fn/forward_tail_2.pt2",
                             "meta.json", "weights.pt"]
    assert all(not ep.state_dict for ep in bundle.functions.values())


@pytest.mark.parametrize("t", [1, 2])
def test_every_tail_matches_the_live_short_chunk_and_jax(bde2vid, seq_bundles, t):
    jbundle, bundle, _ = seq_bundles
    vox = _voxels(10 + t, t)
    got = run_voxels(bundle, nchw(vox))
    np.testing.assert_allclose(got, _live(bde2vid[1], vox), atol=1e-6, rtol=0)
    want = jax_run_voxels(jbundle, jnp.asarray(vox))  # JAX's symbolic-T forward_tail
    np.testing.assert_allclose(got, nchw(want).numpy(), atol=ATOL, rtol=0)


def test_sequence_bundle_refuses_a_longer_chunk(seq_bundles):
    with pytest.raises(ValueError, match="chunk the input"):
        run_voxels(seq_bundles[1], nchw(_voxels(3, 4)))


@pytest.fixture(scope="module")
def kernel_models():
    """The small BDE2VID with seeded weights, and with depths [2, 2] (its
    odd blocks even dilated 4x4 windows, the WindowAttention3D body)."""
    out = {}
    for depths in ([1, 1], [2, 2]):
        torch.manual_seed(4)
        out[str(depths)] = build_model("BDE2VID", {"generator": dict(SEQ_GEN, depths=depths)},
                                       device="cpu")
    return out


@pytest.fixture(scope="module")
def kernel_bundle(kernel_models, tmp_path_factory):
    """The [1, 1] model exported at T=2 on the kernel path, saved."""
    model = kernel_models["[1, 1]"]
    twa.set_attention_kernel(model, True)
    path = str(tmp_path_factory.mktemp("kernel") / "k.zip")
    save_bundle(path, export_spec_bundle(_spec(model), H, W, seq_len=2))
    twa.set_attention_kernel(model, False)
    return path


@pytest.mark.parametrize("depths,per_frame", [([1, 1], {"swin_block": 2}),
                                              ([2, 2], {"swin_block": 2, "window_block": 2})])
def test_kernel_path_export_holds_one_operator_node_a_block_a_frame(kernel_models, kernel_bundle,
                                                                     depths, per_frame):
    """On the kernel path every block is one operator node a frame (the
    even dilated blocks of 4x4 windows the WindowAttention3D body); the
    exported programs, run on the CPU twins, match the unfused export."""
    model = kernel_models[str(depths)]
    out = {}
    for kernel in (True, False):
        twa.set_attention_kernel(model, kernel)
        if kernel and depths == [1, 1]:
            bundle = load_bundle(kernel_bundle)
        else:
            bundle = export_spec_bundle(_spec(model), H, W, seq_len=2)
        for name, t in (("forward", 2), ("forward_tail_1", 1)):
            targets = [str(n.target) for n in bundle.functions[name].graph.nodes]
            for op in ("swin_block", "window_block"):
                n = targets.count(f"bde2vid_torch.{op}.default")
                assert n == (per_frame.get(op, 0) * t if kernel else 0), (kernel, name, op)
        out[kernel] = run_voxels(bundle, nchw(_voxels(5, 2)))
    twa.set_attention_kernel(model, False)
    np.testing.assert_allclose(out[True], out[False], atol=ATOL, rtol=0)


# ---------------------------------------------------------------- step bundles


@pytest.mark.parametrize("name", sorted(STEP_FAMILIES))
def test_step_bundle_matches_jax(name, tmp_path):
    cfg, (h, w) = STEP_FAMILIES[name]
    jm, variables = _jax_variables(name, cfg, h, w, seed=6)
    model = _port_model(name, cfg, variables)
    path = str(tmp_path / "b.zip")
    save_bundle(path, export_spec_bundle(_spec(model, name), h, w, platforms=("cpu",)))
    bundle = load_bundle(path)
    assert sorted(bundle.functions) == ["init_state", "step"] and bundle.meta["kind"] == "step"
    vox = _voxels(7, 2, h, w)
    got = run_voxels(bundle, nchw(vox))
    with torch.no_grad():
        live = run_sequence(model, nchw(vox), model.initial_state(1, h, w))[0].numpy()
    np.testing.assert_allclose(got, live, atol=1e-6, rtol=0)
    jspec = JaxSpec(name=name, module=jm, params=variables, num_bins=B)
    want = jax_run_voxels(jax_export_bundle(jspec, h, w, platforms=("cpu",)), jnp.asarray(vox))
    np.testing.assert_allclose(got, nchw(want).numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def e2vid_msgpack(tmp_path_factory):
    """An E2VIDRecurrent checkpoint written by the JAX package's trainer, and
    its port model."""
    path = str(tmp_path_factory.mktemp("ckpt") / "e2vid.msgpack")
    _, variables = _jax_variables("E2VIDRecurrent", E2VID_CFG, H, W, seed=8)
    jax_save_checkpoint(path, variables, "E2VIDRecurrent", E2VID_CFG)
    return path, _port_model("E2VIDRecurrent", E2VID_CFG, variables)


def _png(path):
    from bde2vid_tpu.metrics.lpips_util import load_image

    return load_image(path)[:, :, 0]


def test_cli_round_trip_from_a_jax_layout_npy_matches_the_jax_cli(e2vid_msgpack, tmp_path, capsys):
    """The JAX CLI's command lines, but for --platforms: export from the JAX
    package's .msgpack at 30x45 (padded to 32x48), run on a (T, H, W, C)
    .npy; the PNGs of both CLIs agree to one grey level."""
    ckpt, _ = e2vid_msgpack
    vox = np.random.default_rng(9).normal(size=(3, 30, 45, B)).astype(np.float32)
    np.save(str(tmp_path / "v.npy"), vox)
    for cli, tag in ((port_cli, "port"), (jax_cli, "jax")):
        out = str(tmp_path / f"{tag}.zip")
        with flax_init_by_shape():  # the JAX loader's init; the checkpoint overwrites it
            assert cli(["export", "--weights", ckpt, "--out", out, "--hw", "30", "45",
                        "--platforms", "cpu"]) == 0
        line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")][-1]
        info = json.loads(line)
        assert info["exported_hw"] == [32, 48] and info["kind"] == "step"
        assert cli(["run", "--bundle", out, "--voxels", str(tmp_path / "v.npy"),
                    "--out_dir", str(tmp_path / tag)]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [f"frame_{i:06d}.png" for i in range(3)]
    for n in names:
        got, want = _png(str(tmp_path / "port" / n)), _png(str(tmp_path / "jax" / n))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cli_pads_odd_sensors_like_the_eval_croper(e2vid_msgpack, tmp_path):
    """29x45 at 2 encoders: the eval driver's CropParameters pad 2 rows on
    top and 1 below; the served images are the live model's on the padded
    voxels, cropped back."""
    ckpt, model = e2vid_msgpack
    out = str(tmp_path / "m.zip")
    assert port_cli(["export", "--weights", ckpt, "--out", out, "--hw", "29", "45",
                     "--platforms", "cpu"]) == 0
    vox = np.random.default_rng(10).normal(size=(2, 29, 45, B)).astype(np.float32)
    np.save(str(tmp_path / "v.npy"), vox)
    assert port_cli(["run", "--bundle", out, "--voxels", str(tmp_path / "v.npy"),
                     "--out_npy", str(tmp_path / "img.npy")]) == 0
    cp = CropParameters(45, 29, 2)
    assert (cp.padding_top, cp.padding_bottom) == (2, 1)
    with torch.no_grad():
        want = run_sequence(model, cp.pad(nchw(vox[:, None])), model.initial_state(1, 32, 48))[0]
    np.testing.assert_allclose(np.load(str(tmp_path / "img.npy")), cp.crop(want)[:, :, 0].numpy(),
                               atol=1e-6, rtol=0)


def test_cli_keeps_the_jax_cli_errors(e2vid_msgpack, tmp_path):
    ckpt, _ = e2vid_msgpack
    out = str(tmp_path / "m.zip")
    assert port_cli(["export", "--weights", ckpt, "--out", out, "--hw", "32", "48",
                     "--platforms", "cpu"]) == 0
    rng = np.random.default_rng(11)
    cases = (((2, 2, 32, 48, B), "batch=1"), ((2, 32, 48, B + 1), "num_bins=5"),
             ((2, 40, 48, B), "exported at 32x48"))
    for shape, msg in cases:
        np.save(str(tmp_path / "bad.npy"), rng.normal(size=shape).astype(np.float32))
        with pytest.raises(SystemExit, match=msg):
            port_cli(["run", "--bundle", out, "--voxels", str(tmp_path / "bad.npy")])


def test_cli_run_from_an_h5_matches_the_live_model(e2vid_msgpack, tmp_path):
    """`run --h5` voxelizes through the eval driver's pipeline (between
    frames) and serves the bundle on it."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.events.h5_io import H5EventWriter
    from tests.conftest import make_events

    ckpt, model = e2vid_msgpack
    out = str(tmp_path / "m.zip")
    assert port_cli(["export", "--weights", ckpt, "--out", out, "--hw", str(H), str(W),
                     "--platforms", "cpu"]) == 0
    rng = np.random.default_rng(12)
    xs, ys, ts, ps = make_events(rng, n=6000, sensor_size=(H, W), t1=1.0)
    h5 = str(tmp_path / "seq.h5")
    with H5EventWriter(h5, sensor_size=(H, W)) as wr:
        wr.append_events(xs, ys, ts, ps > 0)
        for i in range(4):
            wr.add_image(rng.integers(0, 255, (H, W)).astype(np.uint8), (i + 0.5) * 0.25)
    assert port_cli(["run", "--bundle", out, "--h5", h5, "--out_npy", str(tmp_path / "i.npy"),
                     "--out_dir", str(tmp_path / "png")]) == 0
    assert len(os.listdir(tmp_path / "png")) == 3
    vox = load_sequence(h5, num_bins=B).voxels(device="cpu")[:, None]
    with torch.no_grad():
        want = run_sequence(model, vox, model.initial_state(1, H, W))[0][:, :, 0]
    np.testing.assert_allclose(np.load(str(tmp_path / "i.npy")), want.numpy(), atol=1e-6, rtol=0)


def test_cli_serves_long_sequences_in_chunks_with_the_exact_tail(bde2vid, seq_bundles, tmp_path):
    """5 frames through a T=3 bundle: a full chunk, then the 2-frame tail at
    its true length, as the eval driver runs them (and the JAX CLI)."""
    jbundle, _, path = seq_bundles
    vox = np.random.default_rng(13).normal(size=(5, H, W, B)).astype(np.float32)
    np.save(str(tmp_path / "v.npy"), vox)
    assert port_cli(["run", "--bundle", path, "--voxels", str(tmp_path / "v.npy"),
                     "--out_npy", str(tmp_path / "i.npy")]) == 0
    got = np.load(str(tmp_path / "i.npy"))[:, 0]
    live = np.concatenate([_live(bde2vid[1], vox[s:s + 3, None]) for s in (0, 3)])[:, 0, 0]
    np.testing.assert_allclose(got, live, atol=1e-6, rtol=0)
    want = np.concatenate([jax_run_voxels(jbundle, jnp.asarray(vox[s:s + 3, None]))
                           for s in (0, 3)])[:, 0, :, :, 0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------- refusals


def test_refusals(e2vid_msgpack, tmp_path):
    """Data parallelism above 1 (ROADMAP A12's scale-out), the TPU, two
    platforms at once and an orbax checkpoint directory raise ValueError,
    in the library and the CLI."""
    ckpt, model = e2vid_msgpack
    spec = _spec(model, "E2VIDRecurrent")
    with pytest.raises(ValueError, match="scale-out"):
        export_forward(spec, H, W, data_parallel=2)
    for plats in (("tpu",), ("tpu", "cpu"), ("cuda",)):
        with pytest.raises(ValueError):
            export_spec_bundle(spec, H, W, platforms=plats)
    args = ["export", "--weights", ckpt, "--out", str(tmp_path / "b.zip"), "--hw", "32", "48"]
    with pytest.raises(ValueError, match="scale-out"):
        port_cli(args + ["--platforms", "cpu", "--dp", "2"])
    for plat in ("tpu", "tpu,cpu"):
        with pytest.raises(ValueError, match="--platforms"):
            port_cli(args + ["--platforms", plat])
    os.makedirs(tmp_path / "ck_orbax")
    with pytest.raises(ValueError, match="orbax"):
        port_cli(["export", "--weights", str(tmp_path / "ck_orbax") + os.sep, "--out",
                  str(tmp_path / "o.zip"), "--hw", "32", "48", "--platforms", "cpu"])


def test_a_cuda_bundle_refuses_to_load_without_cuda(e2vid_msgpack, tmp_path):
    """A bundle whose programs were exported for cuda never runs on the CPU:
    where CUDA is absent, loading it raises."""
    ckpt, _ = e2vid_msgpack
    path = str(tmp_path / "b.zip")
    assert port_cli(["export", "--weights", ckpt, "--out", path, "--hw", "32", "48",
                     "--platforms", "cpu"]) == 0
    cuda = str(tmp_path / "cuda.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(cuda, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename == "meta.json":
                data = json.dumps(dict(json.loads(data), platforms=["cuda"])).encode()
            dst.writestr(item, data)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bundle would load")
    with pytest.raises(RuntimeError, match="exported for cuda"):
        load_bundle(cuda)


def test_a_bundle_runs_without_the_model_code(kernel_models, kernel_bundle, tmp_path):
    """A kernel-path bundle runs in a process that imports the serving
    module and the operators only: ``bde2vid_tpu_torch.models`` is never
    imported."""
    model, path = kernel_models["[1, 1]"], kernel_bundle
    vox = _voxels(14, 2)
    np.save(str(tmp_path / "v.npy"), nchw(vox).numpy())
    code = ("import sys\nimport numpy as np\nimport torch\ntorch.set_num_threads(1)\n"
            "from bde2vid_tpu_torch.serving import load_bundle, run_voxels\n"
            "b = load_bundle(sys.argv[1])\nnp.save(sys.argv[3], run_voxels(b, np.load(sys.argv[2])))\n"
            "assert 'bde2vid_tpu_torch.models' not in sys.modules\n"
            "print(sorted(m for m in sys.modules if m.startswith('bde2vid_tpu_torch')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code, path, str(tmp_path / "v.npy"),
                          str(tmp_path / "out.npy")], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": root}, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "bde2vid_tpu_torch.ops" in res.stdout
    np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")), _live(model, vox), atol=1e-6,
                               rtol=0)
