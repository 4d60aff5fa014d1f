"""Port parity of LPIPS and its helpers on the CPU: the metric (alex, vgg
and squeeze; v0.1 and v0.0), PNet, the features, ``lpips_distance``, the fake
distances, the perceptual-study scorers, the 2AFC pieces and one 2AFC train
step against the JAX package, the strict loader, the weights carried across
by ``lpips_state_dict_from_jax``, lin-weight discovery, and ``lpips_util``
against the JAX package's NumPy module.

Weights are seeded in the torchvision / LPIPS file layouts and loaded into
JAX by ``load_lpips_params`` and into the port by ``load_lpips_state``
(``jax_params``: the flax init inside the former is taken by shape alone,
filled with ones, since the files overwrite every value the init would
make but the lin heads' ones; an eager flax init costs ~10 s a net).
Tolerance: atol 1e-5, rtol 1e-4 (tests/test_metrics.py's LPIPS bar)."""

import contextlib
import os

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax

from bde2vid_tpu.metrics import lpips as jl
from bde2vid_tpu.metrics import lpips_util as jlu
from bde2vid_tpu_torch.metrics import lpips as tl
from bde2vid_tpu_torch.metrics import lpips_util as tlu

TOL = dict(atol=1e-5, rtol=1e-4)
NETS = ("alex", "vgg", "squeeze")
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread (beside other test processes a parallel
    region waits on descheduled threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(a):
    return T(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def seeded_lpips_files(net, seed=0):
    """(lin_state, backbone_state) as numpy in the LPIPS / torchvision file
    layouts: fan-in-scaled normal kernels, small biases, lin heads in [0, 1]."""
    rng = np.random.default_rng(seed)
    module = tl.LPIPS(net)
    backbone = {}
    for key, v in module.backbone.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith("weight"):
            backbone[key] = (rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        else:
            backbone[key] = (0.05 * rng.normal(size=shape)).astype(np.float32)
    lin = {f"lin{k}.model.1.weight": rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
           for k, c in enumerate(tl._backbone(net)[1])}
    return lin, backbone


@contextlib.contextmanager
def flax_init_by_shape():
    """Every flax ``Module.init`` by shape, filled with ones: for loaders that
    overwrite what the init makes (LPIPS's lin heads but with ``{}``, and
    every tensor of a checkpoint loaded strictly)."""
    init = flax.linen.Module.init

    def by_shape(self, *args, **kwargs):
        shapes = jax.eval_shape(lambda *a: init(self, *a, **kwargs), *args)
        return jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", by_shape)
        yield


def jax_params(lin, backbone, net="alex"):
    """``load_lpips_params(lin, backbone, net)`` with the flax init by shape."""
    with flax_init_by_shape():
        return jl.load_lpips_params(lin, backbone, net=net, image_hw=(16, 16))


@pytest.fixture(scope="module")
def weights():
    """Per net: (lin, backbone) files, the JAX params and the port's network."""
    out = {}
    for net in NETS:
        lin, bb = seeded_lpips_files(net, seed=NETS.index(net))
        params = jax_params(lin, bb, net)
        out[net] = (lin, bb, params, tl.load_lpips_state(lin, bb, net, device="cpu"))
    return out


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return [rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]


# ------------------------------- the metric ----------------------------------


@pytest.mark.parametrize("version", ["0.1", "0.0"])
@pytest.mark.parametrize("net", NETS)
def test_lpips_matches_jax(weights, images, net, version):
    lin, bb, params, _ = weights[net]
    in0, in1 = images
    want = np.asarray(jl.LPIPS(net=net, version=version).apply(params, jnp.asarray(in0),
                                                               jnp.asarray(in1)))
    module = tl.load_lpips_state(lin, bb, net, version, device="cpu")
    with torch.no_grad():
        got = module(nchw(in0), nchw(in1)).numpy()
    assert got.shape == (2,) and module.pretrained_backbone and not module.training
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("net", NETS)
def test_state_dict_from_jax_carries_the_weights(weights, images, net):
    """JAX params -> the port's state dict: the same tensors as the files
    loaded directly, and a network marked as holding a real backbone."""
    _, _, params, direct = weights[net]
    sd = tl.lpips_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(sd) == sorted(direct.state_dict())
    for key, v in direct.state_dict().items():
        assert torch.equal(sd[key], v), key
    module = tl.LPIPS(net)
    assert not module.pretrained_backbone
    module.load_state_dict(sd)
    assert module.pretrained_backbone
    in0, in1 = images
    with torch.no_grad():
        np.testing.assert_array_equal(module(nchw(in0), nchw(in1)).numpy(),
                                      direct(nchw(in0), nchw(in1)).numpy())


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_pnet_and_features_match_jax(weights, images, net):
    _, bb, params, lp = weights[net]
    in0, in1 = images
    jp = {"params": {"backbone": params["params"]["backbone"]}}
    want = np.asarray(jl.PNet(net=net).apply(jp, jnp.asarray(in0), jnp.asarray(in1)))
    pnet = tl.PNet(net)
    pnet.backbone.load_state_dict({k: T(v) for k, v in bb.items()})
    with torch.no_grad():
        np.testing.assert_allclose(pnet(nchw(in0), nchw(in1)).numpy(), want, **TOL)
        # the features from the LPIPS network, its bare trunk and a PNet agree
        jfeats = jl.lpips_features(jl.LPIPS(net=net), params, jnp.asarray(in0))
        for module in (lp, lp.backbone, pnet):
            feats = tl.lpips_features(module, nchw(in0))
            assert len(feats) == len(jfeats)
            for f, jf in zip(feats, jfeats):
                np.testing.assert_allclose(f.numpy(), np.moveaxis(np.asarray(jf), -1, 1), **TOL)


def test_lpips_distance_gray_replication_and_order(weights):
    _, _, params, module = weights["alex"]
    rng = np.random.default_rng(3)
    pred, target = (rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32) for _ in range(2))
    want = float(jl.lpips_distance(jl.LPIPS(net="alex"), params, jnp.asarray(pred),
                                   jnp.asarray(target)))
    with torch.no_grad():
        got = tl.lpips_distance(module, nchw(pred), nchw(target))
        # the network is called as (target, pred), on [-1, 1] 3-channel copies
        t3, p3 = (2 * nchw(a).expand(-1, 3, -1, -1) - 1 for a in (target, pred))
        assert torch.equal(got, module(t3, p3).mean())
        assert tl.lpips_distance(module, nchw(pred), nchw(pred)).item() == pytest.approx(0, abs=1e-6)
        raw = tl.lpips_distance(module, 2 * nchw(pred) - 1, 2 * nchw(target) - 1, normalize=False)
    assert got.item() == pytest.approx(want, rel=1e-4, abs=1e-5)
    assert raw.item() == pytest.approx(got.item(), rel=1e-5)


# -------------------------- fakes and scorers --------------------------------


def test_fake_distances_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(-1, 1, (3, 20, 24, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tl.l2_distance(nchw(a), nchw(b)).numpy(),
                               np.asarray(jl.l2_distance(jnp.asarray(a), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(tl.dssim_distance(nchw(a), nchw(b)).numpy(),
                               np.asarray(jl.dssim_distance(jnp.asarray(a), jnp.asarray(b))),
                               **TOL)
    assert tl.dssim_distance(nchw(a), nchw(a)).abs().max().item() < 1e-6


@pytest.mark.parametrize("use_07", [False, True])
def test_scorers_match_jax(use_07):
    rng = np.random.default_rng(5)
    rec = np.sort(rng.uniform(0, 1, 30))
    prec = rng.uniform(0, 1, 30)
    assert tl.voc_ap(rec, prec, use_07) == jl.voc_ap(rec, prec, use_07)
    d0, d1 = rng.uniform(0, 1, 40), rng.uniform(0, 1, 40)
    d1[:5] = d0[:5]  # ties score 0.5
    gts = rng.uniform(0, 1, 40)
    got, gd = tl.score_2afc(d0, d1, gts)
    want, wd = jl.score_2afc(d0, d1, gts)
    assert got == want
    np.testing.assert_array_equal(gd["scores"], wd["scores"])
    sames = rng.uniform(0, 1, 40)
    assert tl.score_jnd(d0, sames)[0] == jl.score_jnd(d0, sames)[0]


def test_dataset_scorers_match_jax():
    rng = np.random.default_rng(6)
    batches = [{k: rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32) for k in ("ref", "p0", "p1")}
               | {"judge": rng.uniform(0, 1, 4), "same": rng.uniform(0, 1, 4)} for _ in range(3)]
    tb = [{k: nchw(v) if v.ndim == 4 else T(v) for k, v in b.items()} for b in batches]
    jf = lambda a, b: jl.l2_distance(jnp.asarray(a), jnp.asarray(b))
    got, want = tl.score_2afc_dataset(tb, tl.l2_distance), jl.score_2afc_dataset(batches, jf)
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    np.testing.assert_allclose(got[1]["d0s"], want[1]["d0s"], **TOL)
    got, want = tl.score_jnd_dataset(tb, tl.l2_distance), jl.score_jnd_dataset(batches, jf)
    assert got[0] == pytest.approx(want[0], abs=1e-9)


# ------------------------------- 2AFC training -------------------------------


def _rank_pair(seed=7, chn_mid=32):
    """A JAX Dist2Logit's params from a numpy seed and the port's twin."""
    rng = np.random.default_rng(seed)
    sizes = [(5, chn_mid), (chn_mid, chn_mid), (chn_mid, 1)]
    jp = {"params": {f"fc{i}": {"kernel": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32),
                                "bias": (0.1 * rng.normal(size=s[1])).astype(np.float32)}
                     for i, s in enumerate(sizes)}}
    rank = tl.Dist2Logit(chn_mid)
    with torch.no_grad():
        for i in range(3):
            fc = getattr(rank, f"fc{i}")
            fc.weight.copy_(T(jp["params"][f"fc{i}"]["kernel"].T.copy()))
            fc.bias.copy_(T(jp["params"][f"fc{i}"]["bias"]))
    return jax.tree_util.tree_map(jnp.asarray, jp), rank


def test_rank_net_loss_accuracy_and_clamp_match_jax(weights):
    jp, rank = _rank_pair()
    rng = np.random.default_rng(8)
    d0, d1 = rng.uniform(0, 1, 16).astype(np.float32), rng.uniform(0, 1, 16).astype(np.float32)
    judge = rng.uniform(-1, 1, 16).astype(np.float32)
    jnet = jl.Dist2Logit()
    with torch.no_grad():
        np.testing.assert_allclose(rank(T(d0), T(d1)).numpy(),
                                   np.asarray(jnet.apply(jp, jnp.asarray(d0), jnp.asarray(d1))),
                                   **TOL)
        got = tl.bce_ranking_loss(rank, T(d0), T(d1), T(judge)).item()
    want = float(jl.bce_ranking_loss(jnet, jp, jnp.asarray(d0), jnp.asarray(d1),
                                     jnp.asarray(judge)))
    assert got == pytest.approx(want, rel=1e-5)
    j01 = (judge + 1) / 2
    assert tl.compute_2afc_accuracy(T(d0), T(d1), j01) == jl.compute_2afc_accuracy(d0, d1, j01)
    lin, bb, _, _ = weights["alex"]
    signed = {k: v - 0.5 for k, v in lin.items()}
    module = tl.load_lpips_state(signed, bb, device="cpu")
    tl.clamp_lin_nonnegative(module)
    jparams = jl.clamp_lin_nonnegative(jax_params(signed, None))
    for k, w in enumerate(module.lin_weights()):
        np.testing.assert_array_equal(w.detach().numpy().ravel(),
                                      np.asarray(jparams["params"][f"lin{k}"]))


def test_2afc_train_step_matches_jax_with_sgd(weights):
    """One step of plain SGD at one learning rate in both: the same loss,
    lin heads (clamped at 0) and rank net; the backbone does not move."""
    lin, bb, _, _ = weights["alex"]
    signed = {k: v - 0.3 for k, v in lin.items()}
    rng = np.random.default_rng(9)
    ref = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    p0 = np.clip(ref + 0.1 * rng.normal(size=ref.shape), -1, 1).astype(np.float32)
    p1 = np.clip(ref + 0.5 * rng.normal(size=ref.shape), -1, 1).astype(np.float32)
    judge = np.array([0.0, 0.25, 1.0, 0.5], np.float32)
    lr = 0.5

    params = jax_params(signed, bb)
    jp, rank = _rank_pair(seed=10)
    tx = optax.sgd(lr)
    lin_tree = {k: v for k, v in params["params"].items() if k.startswith("lin")}
    step = jl.make_2afc_train_step(jl.LPIPS(net="alex"), jl.Dist2Logit(), tx)
    params, jp, _, jloss = step(params, jp, tx.init((lin_tree, jp)), jnp.asarray(ref),
                                jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(judge))

    module = tl.load_lpips_state(signed, bb, device="cpu")
    before = {k: v.clone() for k, v in module.backbone.state_dict().items()}
    opt = torch.optim.SGD(list(module.lin_weights()) + list(rank.parameters()), lr=lr)
    loss = tl.make_2afc_train_step(module, rank, opt)(nchw(ref), nchw(p0), nchw(p1), T(judge))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k, w in enumerate(module.lin_weights()):
        got = w.detach().numpy().ravel()
        assert got.min() >= 0.0 and (got == 0).any()
        np.testing.assert_allclose(got, np.asarray(params["params"][f"lin{k}"]), **TOL)
    for i in range(3):
        fc = getattr(rank, f"fc{i}")
        np.testing.assert_allclose(fc.weight.detach().numpy().T,
                                   np.asarray(jp["params"][f"fc{i}"]["kernel"]), **TOL)
        np.testing.assert_allclose(fc.bias.detach().numpy(),
                                   np.asarray(jp["params"][f"fc{i}"]["bias"]), **TOL)
    for k, v in module.backbone.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------- loading and discovery -----------------------------


def test_loader_is_as_strict_as_jax(weights):
    lin, bb, _, _ = weights["alex"]
    with pytest.raises(KeyError, match="lin0"):
        tl.load_lpips_state({"bogus": np.ones((1, 64, 1, 1))}, device="cpu")
    with pytest.raises(KeyError, match="lin0"):
        jax_params({"bogus": np.ones((1, 64, 1, 1))}, None)
    vgg_lin = weights["vgg"][0]  # lin0 agrees (64), lin1 does not
    with pytest.raises(ValueError, match="lin1 weight has 128 channels"):
        tl.load_lpips_state(vgg_lin, device="cpu")
    missing = {k: v for k, v in lin.items() if not k.startswith("lin4")}
    with pytest.raises(KeyError, match="lin4"):
        tl.load_lpips_state(missing, device="cpu")
    # pip-lpips's layout, and a torchvision file's classifier keys, are taken
    pip = {f"lin{k}.weight": v for k, v in enumerate(lin.values())}
    full = dict(bb, **{"classifier.1.weight": np.ones((4, 9216), np.float32)})
    a, b = tl.load_lpips_state(pip, full, device="cpu"), weights["alex"][3]
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    # {} asks for the backbone alone: the heads keep their ones
    only = tl.load_lpips_state({}, bb, device="cpu")
    assert all(torch.equal(w, torch.ones_like(w)) for w in only.lin_weights())
    assert only.pretrained_backbone
    assert not tl.load_lpips_state(lin, None, device="cpu").pretrained_backbone


def test_find_default_lpips_lin(tmp_path, monkeypatch):
    path = tmp_path / "alex.pth"
    path.write_bytes(b"")
    monkeypatch.setenv("BDE2VID_LPIPS_LIN", str(path))
    assert tl.find_default_lpips_lin() == jl.find_default_lpips_lin() == str(path)
    monkeypatch.setenv("BDE2VID_LPIPS_LIN", str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError, match="BDE2VID_LPIPS_LIN"):
        tl.find_default_lpips_lin()
    monkeypatch.delenv("BDE2VID_LPIPS_LIN")
    local = os.path.join(tl._REPO_ROOT, "weights", "lpips", "alex.pth")
    assert tl.find_default_lpips_lin() == (local if os.path.isfile(local) else None)


# ------------------------------- lpips_util ----------------------------------


@pytest.fixture(scope="module")
def host_images():
    rng = np.random.default_rng(12)
    return (rng.uniform(-1, 1, (2, 16, 20, 3)).astype(np.float32),
            rng.integers(0, 256, (16, 20, 3)).astype(np.uint8),
            rng.uniform(0, 1, (16, 20, 3)))


@pytest.mark.parametrize("fn", ["tensor2im", "im2tensor", "psnr", "rgb2lab", "lab2rgb",
                                "tensor2tensorlab", "tensor2vec", "grab_patch", "resize_image",
                                "resize_image_zoom", "prep_display_image"])
def test_lpips_util_matches_jax(host_images, fn):
    t, u8, rgb = host_images
    args = {
        "tensor2im": [(t,)], "im2tensor": [(u8,)], "psnr": [(u8, u8[::-1]), (rgb, rgb)],
        "rgb2lab": [(rgb,), (rgb, True)], "lab2rgb": [(jlu.rgb2lab(rgb),)],
        "tensor2tensorlab": [(t,), (t, False), (t, True, True)],
        "tensor2vec": [(t[:, :1, :1],)], "grab_patch": [(u8, 5, 2, 3)],
        "resize_image": [(u8, 10)], "resize_image_zoom": [(rgb, 1.5, 1), (rgb, 1)],
        "prep_display_image": [(rgb * 300,), (rgb * 2, "float")],
    }[fn]
    for a in args:
        got, want = getattr(tlu, fn)(*a), getattr(jlu, fn)(*a)
        if isinstance(want, float):
            assert got == want
        else:
            assert np.asarray(got).dtype == np.asarray(want).dtype
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"pad": 0, "mm": 2}, {"nn": 3, "prime_dir": 1},
                                {"back_clr": (1, 2, 3)}])
def test_montage_matches_jax(kw):
    imgs = np.random.default_rng(13).integers(0, 200, (6, 7, 3, 5)).astype(np.uint8)
    np.testing.assert_array_equal(tlu.montage(imgs, **kw), jlu.montage(imgs, **kw))
    np.testing.assert_array_equal(tlu.montage(imgs[:, :, 0], **kw), jlu.montage(imgs[:, :, 0], **kw))


def test_random_helpers_match_jax():
    vec = np.random.default_rng(14).uniform(size=50)
    np.testing.assert_array_equal(
        tlu.bootstrap(vec, 20, rng=np.random.default_rng(1)),
        jlu.bootstrap(vec, 20, rng=np.random.default_rng(1)))
    for seed in range(6):
        assert (tlu.rand_flip("a", "b", np.random.default_rng(seed))
                == jlu.rand_flip("a", "b", np.random.default_rng(seed)))


def test_debug_and_io_helpers_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(15)
    grads = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    net[0].weight.grad, net[0].bias.grad = T(grads[0]), T(grads[1][:3])
    want = jlu.diagnose_network({"a": grads[0], "b": grads[1][:3], "c": None}, "n")
    assert tlu.diagnose_network(net, "n") == pytest.approx(want, rel=1e-6)
    assert tlu.diagnose_network([T(grads[0]), None, T(grads[1][:3])], "n") == pytest.approx(want, rel=1e-6)
    capsys.readouterr()
    for mod in (tlu, jlu):
        mod.print_numpy(grads[0], val=True, shp=True)
        mod.info(tlu.bootstrap)
    out = capsys.readouterr().out.splitlines()
    assert out[: len(out) // 2] == out[len(out) // 2:]
    my_array = grads[0]
    assert tlu.varname(my_array) == jlu.varname(my_array) == "my_array"
    tlu.mkdirs([str(tmp_path / "a" / "b"), str(tmp_path / "c")])
    tlu.mkdirs(str(tmp_path / "d"))
    assert all((tmp_path / d).is_dir() for d in ("a/b", "c", "d"))
    img = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    tlu.save_image(img, str(tmp_path / "port.png"))
    jlu.save_image(img, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(tlu.load_image(str(tmp_path / "port.png")), img)
    with pytest.raises(ValueError, match="uint8"):
        tlu.save_image(img.astype(np.float32), str(tmp_path / "f.png"))
