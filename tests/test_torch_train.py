"""Port parity of the training path on the CPU: DropPath (the port alone),
losses and the sequence loss, optimizers and schedules, the training window
sampler and augmentation vs the JAX package, and the train CLI end to end
(its checkpoint scored by the port's eval CLI and loaded by the JAX
package). Inputs come from numpy seeds; random draws that the two
frameworks make differently are injected into both."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import bde2vid_tpu.train.__main__ as jtm
from bde2vid_tpu.data import transforms as jtr
from bde2vid_tpu.data.pipeline import load_sequence as jax_load_sequence
from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.events.h5_io import H5EventWriter
from bde2vid_tpu.events.tools import h5_to_memmap
from bde2vid_tpu.losses import build_loss as jax_build_loss
from bde2vid_tpu.losses import temporal_consistency_loss as jax_tc
from bde2vid_tpu.models.api import set_pallas_attention
from bde2vid_tpu.nn import sampling as jsm
from bde2vid_tpu.train import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.optim import build_optimizer as jax_build_optimizer
import bde2vid_tpu_torch.train.__main__ as ttm
from bde2vid_tpu_torch.data import transforms as ttr
from bde2vid_tpu_torch.eval.__main__ import main as eval_main
from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
from bde2vid_tpu_torch.losses import build_loss, temporal_consistency_loss
from bde2vid_tpu_torch.models import build_model
from bde2vid_tpu_torch.nn import sampling as tsm
from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer
from tests.conftest import make_events
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

T = torch.from_numpy


def nchw(a):
    """(..., H, W, C) numpy -> (..., C, H, W) torch."""
    return T(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


_SMALL = {"num_bins": 5, "basechannels": 8, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
          "buffer_index": [-1, 0, 1], "depths": [2, 0], "num_heads": 4, "window_size": [7, 7]}

# ------------------------------- DropPath ------------------------------------


def test_droppath_kernel_and_unfused_paths_agree_in_training():
    """One generator seed: the kernel path (twins + Function on the CPU) and
    the unfused path draw the same per-sample masks, so outputs and
    gradients agree."""
    torch.manual_seed(0)
    model = build_model("BDE2VID", {"generator": dict(_SMALL, drop_path_rate=0.5)}, device="cpu",
                        train=True)
    vox = T(np.random.default_rng(0).normal(size=(3, 2, 5, 28, 28)).astype(np.float32))
    runs = []
    for kernel in (False, True):
        set_attention_kernel(model, kernel)
        model.zero_grad()
        out = model(vox, generator=torch.Generator().manual_seed(3))["image"]
        out.square().mean().backward()
        runs.append((out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                                    if p.grad is not None}))
    (out_u, g_u), (out_k, g_k) = runs
    np.testing.assert_allclose(out_k.numpy(), out_u.numpy(), atol=1e-6, rtol=0)
    assert set(g_k) == set(g_u)
    for key in g_u:
        np.testing.assert_allclose(g_k[key].numpy(), g_u[key].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=key)


def test_droppath_masks_are_per_sample_and_unbiased():
    model = build_model("BDE2VID", {"generator": dict(_SMALL, depths=[3, 0], drop_path_rate=0.2)},
                        device="cpu", train=True)
    blocks = model.generator.feat_attns[0].blocks
    assert [b.drop_path for b in blocks] == pytest.approx([0.0, 0.1, 0.2])
    assert blocks[0].keep_masks(8, "cpu", None) is None  # rate 0: no draws
    gen = torch.Generator().manual_seed(0)
    m1, m2 = blocks[2].keep_masks(20000, "cpu", gen)
    keep = 0.8
    for mk in (m1, m2):
        assert mk.shape == (20000,) and mk.dtype == torch.float32
        assert torch.unique(mk).tolist() == pytest.approx([0.0, 1 / keep])
        assert abs(mk.mean().item() - 1.0) < 0.03
    assert not torch.equal(m1, m2)  # the two branches draw independently
    with pytest.raises(ValueError, match="Generator"):
        blocks[2].keep_masks(4, "cpu", None)


def test_eval_mode_is_deterministic_and_ignores_droppath():
    rng = np.random.default_rng(1)
    vox = T(rng.normal(size=(3, 1, 5, 28, 28)).astype(np.float32))
    with_dp = build_model("BDE2VID", {"generator": dict(_SMALL, drop_path_rate=0.3)}, device="cpu")
    no_dp = build_model("BDE2VID", {"generator": dict(_SMALL, drop_path_rate=0.0)}, device="cpu")
    no_dp.load_state_dict(with_dp.state_dict())
    with torch.no_grad():
        a = with_dp(vox, generator=torch.Generator().manual_seed(1))["image"]
        b = with_dp(vox)["image"]
        c = no_dp(vox)["image"]
    assert torch.equal(a, b) and torch.equal(b, c)


# -------------------------------- losses -------------------------------------


def test_grid_sample_and_warp_match_jax(rng):
    img = rng.normal(size=(2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(tsm.grid_sample_bilinear(T(img), T(grid)).numpy(),
                               np.asarray(jsm.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid))),
                               atol=1e-5)
    flow = rng.normal(0, 1.5, size=(2, 9, 13, 2)).astype(np.float32)
    np.testing.assert_allclose(tsm.warp_by_flow(T(img), T(flow)).numpy(),
                               np.asarray(jsm.warp_by_flow(jnp.asarray(img), jnp.asarray(flow))),
                               atol=1e-5)


def test_l1_and_temporal_consistency_losses_match_jax(rng):
    n, h, w = 2, 16, 20
    i0, i1, p0, p1 = (rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32) for _ in range(4))
    flow = rng.normal(0, 1.5, (n, h, w, 2)).astype(np.float32)
    want = float(jax_tc(*(jnp.asarray(a) for a in (i0, i1, p0, p1, flow))))
    got = temporal_consistency_loss(*(nchw(a) for a in (i0, i1, p0, p1, flow))).item()
    assert got == pytest.approx(want, abs=1e-6)
    l1 = {"type": "L1Loss", "weight": 0.5}
    want, _ = jax_build_loss(l1)(None, jnp.asarray(p0), jnp.asarray(i0))
    assert build_loss(l1)(nchw(p0), nchw(i0)).item() == pytest.approx(float(want), abs=1e-7)


@pytest.mark.parametrize("name", ["PerceptualLoss", "VIPLoss"])
def test_lpips_losses_raise_until_lpips_is_ported(name):
    """An LPIPS-backed loss builds with an LPIPS network that holds backbone
    weights, and raises without one (or with a random backbone)."""
    from bde2vid_tpu_torch.metrics.lpips import LPIPS, load_lpips_state

    with pytest.raises(ValueError, match="needs an LPIPS network"):
        build_loss({"type": name})
    with pytest.raises(ValueError, match="loaded backbone"):
        build_loss({"type": name}, lpips=load_lpips_state({}, None, device="cpu"))
    net = LPIPS("alex")
    net.load_state_dict(net.state_dict())  # the backbone's keys: weights loaded
    loss = build_loss({"type": name}, lpips=net)
    img = torch.rand(1, 1, 40, 40)
    v = loss(img, img) if name == "PerceptualLoss" else loss(img, img)[0]
    assert v.item() == pytest.approx(0.0, abs=1e-6)


_LOSS_CASES = {
    "l1": ([{"type": "L1Loss"}], None),
    "duplicate_types": ([{"type": "L1Loss", "weight": 2.0}, {"type": "L1Loss", "weight": 0.5}], None),
    "loss_inds_int": ([{"type": "L1Loss"}], 2),
    "loss_inds_list_with_tc": ([{"type": "L1Loss"}, {"type": "TemporalConsistencyLoss", "L0": 1}],
                               [0, 2, 3, 4]),
}


@pytest.mark.parametrize("case", sorted(_LOSS_CASES))
def test_sequence_loss_computer_matches_jax(rng, case):
    losses, inds = _LOSS_CASES[case]
    t, n, h, w = 5, 2, 12, 16
    preds, gts = (rng.uniform(0, 1, (t, n, h, w, 1)).astype(np.float32) for _ in range(2))
    flows = rng.normal(0, 1.0, (t, n, h, w, 2)).astype(np.float32)
    want_total, want = JaxLoss(losses, inds)(None, jnp.asarray(preds), jnp.asarray(gts),
                                             jnp.asarray(flows))
    total, got = SequenceLossComputer(losses, inds)(nchw(preds), nchw(gts), nchw(flows))
    assert set(got) == set(want)
    for key in want:
        assert got[key].item() == pytest.approx(float(want[key]), abs=1e-6), key
    assert total.item() == pytest.approx(float(want_total), abs=1e-6)


def test_temporal_consistency_without_flows_raises(rng):
    cfg = [{"type": "TemporalConsistencyLoss"}]
    x = rng.uniform(0, 1, (3, 1, 8, 8, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="flows"):
        JaxLoss(cfg)(None, jnp.asarray(x), jnp.asarray(x), None)
    with pytest.raises(ValueError, match="flows"):
        SequenceLossComputer(cfg)(nchw(x), nchw(x), None)


# ------------------------- optimizers and schedules ---------------------------

_CLIP = {"grad_clip": 1.0}
_OPTIM_CASES = {
    "adam_l2_clip": ({"type": "Adam", "args": {"lr": 1e-2, "weight_decay": 1e-2, **_CLIP}}, None),
    "adam_flat": ({"lr": 3e-3}, None),
    "adamw": ({"type": "AdamW", "args": {"lr": 1e-2, "betas": [0.8, 0.99], **_CLIP}}, None),
    "sgd_nesterov": ({"type": "SGD", "args": {"lr": 1e-2, "momentum": 0.9, "nesterov": True,
                                              "weight_decay": 1e-3, **_CLIP}}, None),
    "rmsprop_centered": ({"type": "RMSprop", "args": {"lr": 1e-3, "momentum": 0.5,
                                                      "centered": True, **_CLIP}}, None),
    "step": ({"type": "Adam", "args": {"lr": 1e-2, **_CLIP}},
             {"type": "StepLR", "args": {"step_size": 2, "gamma": 0.5}}),
    "multistep": ({"type": "SGD", "args": {"lr": 1e-2, **_CLIP}},
                  {"type": "MultiStepLR", "args": {"milestones": [1, 3], "gamma": 0.3}}),
    "exponential": ({"type": "SGD", "args": {"lr": 1e-2, **_CLIP}},
                    {"type": "ExponentialLR", "args": {"gamma": 0.7}}),
    "cosine": ({"type": "SGD", "args": {"lr": 1e-2, **_CLIP}},
               {"type": "CosineAnnealingLR", "args": {"T_max": 3, "eta_min": 1e-3}}),
    "linear": ({"type": "SGD", "args": {"lr": 1e-2, **_CLIP}},
               {"type": "LinearLR", "args": {"start_factor": 0.25, "total_iters": 3}}),
}


@pytest.mark.parametrize("case", sorted(_OPTIM_CASES))
def test_optimizer_and_schedule_match_jax_over_five_steps(rng, case):
    opt_cfg, sched_cfg = _OPTIM_CASES[case]
    shapes = [(4, 3), (5,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # gradients large enough that the clip acts
    grads = [[(rng.normal(size=s) * 2).astype(np.float32) for s in shapes] for _ in range(5)]

    tx, _ = jax_build_optimizer(opt_cfg, sched_cfg)
    jp = [jnp.asarray(a) for a in init]
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    params = [torch.nn.Parameter(T(a.copy())) for a in init]
    opt, sched, clip, _ = build_optimizer(params, json.loads(json.dumps(opt_cfg)), sched_cfg)
    for g in grads:
        for p, a in zip(params, g):
            p.grad = T(a.copy())
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(params, clip)
        opt.step()
        if sched is not None:
            sched.step()
    for p, want in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_optimizer_config_errors_match_jax():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for bad in ({"type": "Lion"}, {"type": "SGD", "args": {"momentum": 0.9, "dampening": 0.1}},
                {"type": "Adam", "args": {"lr": 1e-3}, "lr": 1e-3}):
        with pytest.raises(ValueError):
            jax_build_optimizer(bad)
        with pytest.raises(ValueError):
            build_optimizer(p, bad)
    with pytest.raises(ValueError):
        build_optimizer(p, None, {"type": "OneCycleLR"})


# ------------------------ windows and augmentation ----------------------------


def _write_h5_seq(path, rng, n_frames, sensor=(20, 24), flows=True):
    xs, ys, ts, ps = make_events(rng, n=6000, sensor_size=sensor, t1=1.0)
    with H5EventWriter(str(path), sensor_size=sensor) as w:
        w.append_events(xs, ys, ts, ps > 0)
        for i in range(n_frames):
            t = (i + 0.5) / n_frames
            w.add_image(rng.integers(0, 255, sensor).astype(np.uint8), t)
            if flows:
                w.add_flow(rng.normal(0, 0.5, (2, *sensor)).astype(np.float32), t)


@pytest.fixture(scope="module")
def h5_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tree")
    rng = np.random.default_rng(11)
    os.makedirs(root / "h5" / "SYN")
    for name, n in (("a", 8), ("b", 10)):
        _write_h5_seq(root / "h5" / "SYN" / f"{name}.h5", rng, n)
    return root


_PAUSE = {"proba_pause_when_running": 0.3, "proba_pause_when_paused": 0.7}


@pytest.mark.parametrize("rot", [False, True])
def test_training_windows_match_jax(h5_tree, rot):
    """Same seed and steps: the same files, starts, pauses, crops and
    rotations; voxels, frames and flows agree."""
    kw = dict(seq_len=3, num_bins=5, pause_cfg=_PAUSE, batch=2, seed=5, multiple=4,
              crop_size=(12, 16), want_flows=True,
              rot_cfg={"degrees": 20} if rot else None)
    jit_ = jtm.iterate_training_windows(str(h5_tree), **kw)
    pit = ttm.iterate_training_windows(str(h5_tree), **kw, device="cpu")
    for _ in range(3):
        jv, jf, jfl = next(jit_)
        pv, pf, pfl = next(pit)
        assert pv.shape == (3, 2, 5, 12, 16) and pf.shape == (3, 2, 1, 12, 16)
        np.testing.assert_allclose(nhwc(pv), np.asarray(jv), atol=1e-4 if rot else 1e-5)
        np.testing.assert_allclose(nhwc(pf), np.asarray(jf), atol=1e-6)
        np.testing.assert_allclose(nhwc(pfl), np.asarray(jfl), atol=1e-5)


def test_mmp_windows_match_jax(h5_tree, tmp_path, monkeypatch):
    """``--loader_type MMP``: a window drawn from memmap directories equals
    the JAX window sampler's on the same directories (JAX's sampler opens
    them through its own MMP loader here) for the same rng."""
    files = []
    for name in ("a", "b"):
        files.append(str(tmp_path / "mmp" / name))
        h5_to_memmap(str(h5_tree / "h5" / "SYN" / f"{name}.h5"), files[-1])
    monkeypatch.setattr(jtm, "_open_sequence",
                        lambda path, nb: jax_load_sequence(path, num_bins=nb, ltype="MMP"))
    for seed in range(3):
        args = (3, 5, _PAUSE, 1, (12, 16))
        jv, jf, _ = jtm._one_window(files, np.random.default_rng(seed), *args)
        pargs = (3, ttm.SequenceCache(5, "MMP"), _PAUSE, (12, 16))
        pv, pf, _ = ttm._one_window(files, np.random.default_rng(seed), *pargs, device="cpu")
        np.testing.assert_allclose(nhwc(pv), np.asarray(jv), atol=1e-5)
        np.testing.assert_allclose(pf[:, 0], np.asarray(jf)[..., 0], atol=1e-6)


def test_sequence_cache_closes_the_least_recently_used(h5_tree, monkeypatch):
    monkeypatch.setattr(ttm, "MAX_OPEN_SEQUENCES", 1)
    a, b = (str(h5_tree / "h5" / "SYN" / f"{name}.h5") for name in "ab")
    cache = ttm.SequenceCache(5)
    sa = cache(a)
    assert cache(a) is sa
    sb = cache(b)
    assert not sa.reader.f and sb.reader.f  # a was closed when b came in
    assert cache(b) is sb
    assert cache(a) is not sa and not sb.reader.f


def test_rotation_flip_matches_jax_host_twin(rng):
    x = rng.normal(size=(3, 14, 18)).astype(np.float32)
    for params in ((17.0, True, False), (-8.5, False, True), (0.0, True, True)):
        j, t = jtr.RandomRotationFlip(), ttr.RandomRotationFlip()
        j.set_params(*params)
        t.set_params(*params)
        np.testing.assert_array_equal(t(x), j(x))
        np.testing.assert_array_equal(t(x[:2], is_flow=True), j(x[:2], is_flow=True))
    j, t = jtr.RandomRotationFlip(30), ttr.RandomRotationFlip(30)
    j.sample_params(np.random.default_rng(4))
    t.sample_params(np.random.default_rng(4))
    np.testing.assert_array_equal(t.fwd, j._fwd)


def test_pause_mask_matches_jax():
    for seed in range(5):
        want = jtr.sample_pause_mask(9, np.random.default_rng(seed), 0.4, 0.6)
        got = ttr.sample_pause_mask(9, np.random.default_rng(seed), 0.4, 0.6)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_noise_with_injected_draws_matches_jax(rng, monkeypatch):
    vox = rng.normal(size=(3, 2, 8, 8, 5)).astype(np.float32)
    normal = rng.normal(size=vox.shape).astype(np.float32)
    uniform = rng.uniform(size=vox.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(normal))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(uniform))
    want = jtr.add_noise_to_voxel(jnp.asarray(vox), jax.random.PRNGKey(0), 0.3, 0.2)
    got = ttr.noise_from_draws(T(vox), T(normal), T(uniform), 0.3, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    # the port's own draws: a fraction of the entries moves
    moved = ttr.add_noise_to_voxel(T(vox), torch.Generator().manual_seed(0), 0.3, 0.2) != T(vox)
    assert 0.15 < moved.float().mean().item() < 0.25


def test_hot_pixels_with_injected_draws_match_jax(rng, monkeypatch):
    t_, h, w, c = 4, 12, 10, 5
    vox = rng.normal(size=(t_, h, w, c)).astype(np.float32)
    max_frac = 0.05
    max_n = int(max_frac * h * w)
    frac_u = np.float32(0.7)
    xs, ys = rng.integers(0, w, max_n), rng.integers(0, h, max_n)
    ys[:2], xs[:2] = 3, 4  # a repeated pixel sums its values
    vals = rng.normal(size=max_n).astype(np.float32)
    ints = iter([xs, ys])
    monkeypatch.setattr(jax.random, "uniform", lambda key, *a, **k: jnp.asarray(frac_u))
    monkeypatch.setattr(jax.random, "randint", lambda key, *a, **k: jnp.asarray(next(ints)))
    monkeypatch.setattr(jax.random, "normal", lambda key, *a, **k: jnp.asarray(vals))
    want = jtr.add_hot_pixels_to_sequence(jnp.asarray(vox), jax.random.PRNGKey(0), 2.0, max_frac)
    got = ttr.hot_pixels_from_draws(nchw(vox), torch.tensor(frac_u * max_frac), T(xs), T(ys),
                                    T(vals) * 2.0)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


# ------------------------------ the train CLI ---------------------------------


def _train_config(**data):
    gen = dict(_SMALL, drop_path_rate=0.2)
    return {
        "name": "cli",
        "model": {"type": "BDE2VID", "args": {"generator": gen, "use_pallas_attention": True}},
        "losses": [{"type": "L1Loss"}, {"type": "TemporalConsistencyLoss", "L0": 0}],
        "optimizer": {"type": "Adam", "args": {"lr": 1e-3, "grad_clip": 1.0}},
        "lr_scheduler": {"type": "StepLR", "args": {"step_size": 1, "gamma": 0.5}},
        "data": {"sequence_length": 3, "num_bins": 5, **_PAUSE, "noise_std": 0.1,
                 "noise_fraction": 0.1, "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.01,
                 "transforms": {"RandomRotationFlip": {"degrees": 10}}, **data},
        "train": {"steps": 2, "ckpt_every": 1},
    }


def test_train_cli_checkpoint_is_scored_and_loads_in_jax(h5_tree, tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_train_config()))
    out = tmp_path / "run"
    rc = ttm.main(["--config", str(cfg_path), "--data_dir", str(h5_tree), "--out_dir", str(out),
                   "--device", "cpu", "--batch", "2"])
    assert rc == 0
    log = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [0, 1]
    assert all(0 < r["data_seconds"] < r["seconds"] for r in log)
    assert all(np.isfinite(r[k]) for r in log for k in ("loss", "L_LL", "L_TCL"))
    assert (out / "epoch_1.pth").exists() and (out / "epoch_2.pth").exists()
    os.remove(out / "epoch_1.pth")

    # the port's eval CLI scores it
    assert eval_main(["--weights_dir", str(out), "--data_dir", str(h5_tree), "--datasets", "SYN",
                      "--metrics", "mse", "ssim", "--subseq_L", "8", "--device", "cpu",
                      "--output_dir", str(tmp_path / "eval")]) == 0
    scores = json.loads((tmp_path / "eval" / "epoch_2_L8_org.txt").read_text())["SYN"]
    assert all(np.isfinite(v) for seq in scores.values() for v in seq.values())

    # the JAX package loads the same file and its forward matches the port's
    jspec = set_pallas_attention(jax_load(str(out / "epoch_2.pth")), False)
    spec = load_model_from_torch(str(out / "epoch_2.pth"), device="cpu")
    vox = np.random.default_rng(3).normal(size=(3, 1, 16, 16, 5)).astype(np.float32)
    want = np.asarray(jspec.module.apply(jspec.params, jnp.asarray(vox))[0]["image"])
    with torch.no_grad():
        got = spec.module(nchw(vox))["image"]
    np.testing.assert_allclose(nhwc(got), want, atol=2e-4, rtol=0)


# the LPIPS flags are taken (and, as in JAX, not read without an LPIPS-backed
# loss); bf16 and remat training run a step
@pytest.mark.parametrize("flag,config", [
    (["--lpips_lin", "lin.pth"], {}),
    (["--lpips_backbone", "alex.pth"], {}),
    ([], {"train": {"bf16": True}}),
    ([], {"train": {"remat": True}}),
    ([], {"train": {"bf16": True, "remat": True}}),
])
def test_train_cli_refuses_what_is_not_ported(h5_tree, tmp_path, flag, config):
    cfg = {**_train_config(), **config}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    args = ["--config", str(cfg_path), "--data_dir", str(h5_tree), "--out_dir",
            str(tmp_path / "o"), "--device", "cpu", "--steps", "1", *flag]
    assert ttm.main(args) == 0
    log = [json.loads(line) for line in (tmp_path / "o" / "train_log.jsonl").read_text().splitlines()]
    assert len(log) == 1 and np.isfinite(log[0]["loss"])
    state = torch.load(tmp_path / "o" / "epoch_1.pth", weights_only=False)["state_dict"]
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.values())  # f32 master weights
