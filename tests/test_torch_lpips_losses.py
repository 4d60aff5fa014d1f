"""Port parity of what rests on LPIPS, on the CPU: PerceptualLoss and
VIPLoss (value and gradient with respect to the prediction; VIPLoss with and
without its state), ``SequenceLossComputer`` with them over T=5, the eval
CLI's ``p_loss`` and ``--lpips_*`` flags, and the train CLI with a
PerceptualLoss config, each against the JAX package.

LPIPS weights are seeded in the torchvision / LPIPS file layouts
(``tests/test_torch_lpips.py``). Tolerances: 1e-5 relative for loss values,
1e-4 for gradients (max |diff| over max |JAX|); the eval CLI's ``p_loss``
within 2e-4; the train CLI's first loss within 1e-4 relative of
``make_loss_fn``'s."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bde2vid_tpu.train.__main__ as jtm
from bde2vid_tpu.eval.__main__ import main as jax_eval_main
from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.losses import build_loss as jax_build_loss
from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.train import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.trainer import make_loss_fn
import bde2vid_tpu_torch.train.__main__ as ttm
from bde2vid_tpu_torch.eval.__main__ import main as port_eval_main
from bde2vid_tpu_torch.losses import build_loss
from bde2vid_tpu_torch.metrics.lpips import load_lpips_state
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.train import SequenceLossComputer, save_checkpoint
from tests.test_torch_eval import SENSOR, _CFG, _write_h5
from tests.test_torch_lpips import jax_params, flax_init_by_shape, one_thread  # noqa: F401
from tests.test_torch_lpips import seeded_lpips_files

T = torch.from_numpy


def nchw(a):
    """(..., H, W, C) numpy -> (..., C, H, W) torch."""
    return T(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


@pytest.fixture(scope="module")
def alex():
    """(JAX params, the port's network) of one seeded AlexNet LPIPS."""
    lin, bb = seeded_lpips_files("alex", seed=21)
    return jax_params(lin, bb), load_lpips_state(lin, bb, device="cpu")


def _close(got, want, rel):
    """max |got - want| within ``rel`` of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(),
                                                                   np.abs(want).max())


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(4)]


# --------------------------------- losses ------------------------------------


@pytest.mark.parametrize("cfg,with_state", [
    ({"type": "PerceptualLoss", "weight": 0.5}, False),
    ({"type": "VIPLoss", "w": 2.0}, False),
    ({"type": "VIPLoss", "w": 2.0}, True),
    ({"type": "VIPLoss", "normalize": False}, True),
])
def test_lpips_loss_value_and_gradient_match_jax(alex, cfg, with_state):
    params, net = alex
    pred, target, prev_pred, prev_target = _images(1, (2, 40, 48, 1))
    jfn, fn = jax_build_loss(cfg), build_loss(cfg, lpips=net)
    if cfg["type"] == "PerceptualLoss":
        jloss = lambda p: jfn(params, p, jnp.asarray(target))[0]
        loss = lambda p: fn(p, nchw(target))
    else:
        jstate = tstate = None
        if with_state:
            jstate = jfn(params, jnp.asarray(prev_pred), jnp.asarray(prev_target))[1]
            with torch.no_grad():
                tstate = fn(nchw(prev_pred), nchw(prev_target))[1]
        jloss = lambda p: jfn(params, p, jnp.asarray(target), jstate)[0]
        loss = lambda p: fn(p, nchw(target), tstate)[0]
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = nchw(pred).requires_grad_(True)
    got = loss(p)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _close(nhwc(p.grad), jgrad, 1e-4)
    assert not any(q.requires_grad for q in net.parameters())


_SEQ_CASES = {
    "l1_perceptual_inds2": ([{"type": "L1Loss"}, {"type": "PerceptualLoss"}], 2),
    "vip_l1_vip": ([{"type": "VIPLoss"}, {"type": "L1Loss", "weight": 0.5},
                    {"type": "VIPLoss", "w": 0.3}], None),
}


@pytest.mark.parametrize("case", sorted(_SEQ_CASES))
def test_sequence_loss_with_lpips_matches_jax(alex, case):
    """T=5: the total, each entry's mean and the gradient with respect to the
    predictions; each VIPLoss entry keeps its own state."""
    params, net = alex
    losses, inds = _SEQ_CASES[case]
    rng = np.random.default_rng(2)
    preds, gts = (rng.uniform(0, 1, (5, 2, 40, 48, 1)).astype(np.float32) for _ in range(2))
    jcomp = JaxLoss(losses, inds)
    (want, jdict), jgrad = jax.value_and_grad(
        lambda p: jcomp(params, p, jnp.asarray(gts)), has_aux=True)(jnp.asarray(preds))
    p = nchw(preds).requires_grad_(True)
    got, tdict = SequenceLossComputer(losses, inds, lpips=net)(p, nchw(gts))
    got.backward()
    assert sorted(tdict) == sorted(jdict)
    for k in jdict:
        assert tdict[k].item() == pytest.approx(float(jdict[k]), rel=1e-5), k
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _close(nhwc(p.grad), jgrad, 1e-4)
    if inds == 2:  # ungated steps get no gradient
        assert p.grad[1].abs().max() == 0 and p.grad[3].abs().max() == 0


def test_lpips_losses_refuse_a_wrong_network(alex):
    _, net = alex
    for name in ("PerceptualLoss", "VIPLoss"):
        with pytest.raises(ValueError, match="needs an LPIPS network"):
            build_loss({"type": name})
        with pytest.raises(ValueError, match="net 'alex'"):
            build_loss({"type": name, "net": "vgg"}, lpips=net)
        with pytest.raises(ValueError, match="loaded backbone"):
            build_loss({"type": name}, lpips=load_lpips_state({}, None, device="cpu"))
    assert build_loss({"type": "L1Loss"}, lpips=net).weight == 1.0  # others ignore it


# ---------------------------------- CLIs -------------------------------------


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    """alex.pth (torchvision layout) and lin.pth (LPIPS layout), seeded."""
    root = tmp_path_factory.mktemp("lpips_files")
    lin, bb = seeded_lpips_files("alex", seed=22)
    torch.save({k: T(v) for k, v in lin.items()}, root / "lin.pth")
    torch.save({k: T(v) for k, v in bb.items()}, root / "alex.pth")
    return str(root / "lin.pth"), str(root / "alex.pth")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One 36x44 H5 sequence (data/h5/SYN/s1.h5, 6 frames) and a small
    BDE2VID checkpoint with numpy-seeded weights (weights/epoch_3.pth)."""
    from bde2vid_tpu_torch.eval.mmengine_cfg import parse_embedded_cfg

    root = tmp_path_factory.mktemp("lpips_tree")
    rng = np.random.default_rng(23)
    os.makedirs(root / "data" / "h5" / "SYN")
    _write_h5(root / "data" / "h5" / "SYN" / "s1.h5", rng)
    cfg = parse_embedded_cfg(_CFG)
    cfg.pop("type")
    model = build_model("BDE2VID", cfg, device="cpu")
    sd = {k: T((rng.normal(size=tuple(v.shape)) * 0.3).astype(np.float32))
          if v.is_floating_point() else v for k, v in model.state_dict().items()}
    os.makedirs(root / "weights")
    torch.save({"meta": {"cfg": _CFG}, "state_dict": sd}, str(root / "weights" / "epoch_3.pth"))
    return root


def _eval_args(tree, out_dir, *extra):
    return ["--weights_dir", str(tree / "weights"), "--data_dir", str(tree / "data"),
            "--datasets", "SYN", "--subseq_L", "5", "--output_dir", str(out_dir), *extra]


def _scores(out_dir):
    with open(out_dir / "epoch_3_L5_org.txt") as fp:
        result = json.load(fp)["SYN"]["s1"]
    with open(out_dir / "epoch_3_L5_org_detail.txt") as fp:
        return result, json.load(fp)["SYN"]["s1"]


def test_eval_cli_p_loss_matches_jax_cli(tree, lpips_files):
    lin, bb = lpips_files
    flags = ["--metrics", "p_loss", "mse", "ssim", "--lpips_lin", lin, "--lpips_backbone", bb]
    with flax_init_by_shape():  # the JAX CLI's loaders overwrite every value
        assert jax_eval_main(_eval_args(tree, tree / "jax_p", *flags)) == 0
    assert port_eval_main(_eval_args(tree, tree / "port_p", *flags, "--device", "cpu")) == 0
    (want, wdetail), (got, gdetail) = _scores(tree / "jax_p"), _scores(tree / "port_p")
    assert sorted(got) == sorted(want) == ["mse", "p_loss", "ssim"]
    assert got["p_loss"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4 if k == "p_loss" else 1e-4)
        np.testing.assert_allclose(gdetail[k], wdetail[k], atol=2e-4 if k == "p_loss" else 1e-4)


def test_eval_cli_drops_p_loss_without_lin_weights_as_jax(tree, capsys, monkeypatch):
    """The default metrics (p_loss mse ssim) without --lpips_lin and nothing
    discovered: both CLIs warn alike and score mse and ssim."""
    monkeypatch.delenv("BDE2VID_LPIPS_LIN", raising=False)
    monkeypatch.setattr("bde2vid_tpu.metrics.lpips.find_default_lpips_lin", lambda net="alex": None)
    monkeypatch.setattr("bde2vid_tpu_torch.metrics.lpips.find_default_lpips_lin",
                        lambda net="alex": None)
    capsys.readouterr()
    with flax_init_by_shape():
        assert jax_eval_main(_eval_args(tree, tree / "jax_d")) == 0
    jout = capsys.readouterr().out
    assert port_eval_main(_eval_args(tree, tree / "port_d", "--device", "cpu")) == 0
    pout = capsys.readouterr().out
    warning = "warning: dropping p_loss (no --lpips_lin provided)"
    assert warning in jout and warning in pout
    (want, _), (got, _) = _scores(tree / "jax_d"), _scores(tree / "port_d")
    assert sorted(got) == sorted(want) == ["mse", "ssim"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)


_GEN = {"num_bins": 5, "basechannels": 4, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
        "buffer_index": [-1, 0, 1], "depths": [1, 1], "num_heads": 2, "window_size": [4, 4],
        "drop_path_rate": 0.0}
_DATA = {"sequence_length": 3, "num_bins": 5}


def _train_cfg(tmp_path, model, losses, **extra):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"name": "lpips", "model": model, "losses": losses,
                                "optimizer": {"type": "Adam", "args": {"lr": 1e-3}},
                                "data": _DATA, "train": {"steps": 2, "ckpt_every": 2}, **extra}))
    return str(path)


@pytest.mark.parametrize("given,message", [("backbone", "need LPIPS weights"),
                                           ("lin", "need a REAL feature backbone")])
def test_train_cli_refuses_lpips_losses_without_weights_as_jax(tree, tmp_path, lpips_files,
                                                               monkeypatch, given, message):
    """A PerceptualLoss config with only one of the two weight files: both
    CLIs refuse, for the same reason (a small E2VID: the refusal does not
    depend on the model)."""
    monkeypatch.delenv("BDE2VID_LPIPS_LIN", raising=False)
    monkeypatch.setattr("bde2vid_tpu.metrics.lpips.find_default_lpips_lin", lambda net="alex": None)
    monkeypatch.setattr("bde2vid_tpu_torch.metrics.lpips.find_default_lpips_lin",
                        lambda net="alex": None)
    model = {"type": "E2VID", "args": {"num_bins": 5, "num_encoders": 2, "base_num_channels": 4,
                                       "num_residual_blocks": 1}}
    cfg = _train_cfg(tmp_path, model, [{"type": "L1Loss"}, {"type": "PerceptualLoss"}])
    lin, bb = lpips_files
    flag = ["--lpips_lin", lin] if given == "lin" else ["--lpips_backbone", bb]
    args = ["--config", cfg, "--data_dir", str(tree / "data"), "--steps", "1", *flag]
    with flax_init_by_shape(), pytest.raises(SystemExit, match=message):
        jtm.main(args + ["--out_dir", str(tmp_path / "j")])
    with pytest.raises(SystemExit, match=message):
        ttm.main(args + ["--out_dir", str(tmp_path / "p"), "--device", "cpu"])


def test_train_cli_with_perceptual_loss_matches_jax_first_loss(tree, tmp_path, lpips_files):
    """[L1, PerceptualLoss] at loss_inds 2 (the reference's BDE2VID stack),
    a small BDE2VID from seeded weights, no augmentation: 2 steps train, and
    the first logged loss is JAX's ``make_loss_fn`` on the same window and
    weights within 1e-4 relative."""
    lin, bb = lpips_files
    model = {"type": "BDE2VID", "args": {"generator": _GEN}}
    losses = [{"type": "L1Loss"}, {"type": "PerceptualLoss"}]
    cfg = _train_cfg(tmp_path, model, losses, loss_inds=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        net = build_model("BDE2VID", model["args"], device="cpu", train=True)
    weights = str(tmp_path / "init.pth")
    save_checkpoint(weights, net, "BDE2VID", model["args"])
    out = tmp_path / "run"
    assert ttm.main(["--config", cfg, "--data_dir", str(tree / "data"), "--out_dir", str(out),
                     "--device", "cpu", "--resume", weights, "--lpips_lin", lin,
                     "--lpips_backbone", bb]) == 0
    log = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [0, 1]
    assert all(np.isfinite(r[k]) for r in log for k in ("loss", "L_LL", "L_PL"))
    assert (out / "epoch_2.pth").exists()

    vox, frames, _ = next(ttm.iterate_training_windows(
        str(tree / "data"), 3, 5, _DATA, multiple=4, device="cpu"))
    jmodel = jax_build("BDE2VID", model["args"], train=True)
    loss_fn = make_loss_fn(jmodel, JaxLoss(losses, 2), lpips_params=jax_params(
        *(torch.load(f, weights_only=True) for f in (lin, bb))), is_sequence_model=True)
    with flax_init_by_shape():
        variables = jax_load(weights).params
    want, _ = jax.jit(loss_fn)(variables, jnp.asarray(nhwc(vox)),
                               jnp.asarray(nhwc(frames)), None, {"droppath": jax.random.PRNGKey(0)})
    assert log[0]["loss"] == pytest.approx(float(want), rel=1e-4)
