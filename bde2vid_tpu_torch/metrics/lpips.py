"""LPIPS (net-lin) perceptual metric (counterpart of
``bde2vid_tpu/metrics/lpips.py``; reference LPIPS/models/networks_basic.py
PNetLin :72-175 and pretrained_networks.py :11-100).

v0.1: inputs in [-1, 1] are shifted and scaled per channel, run through a
frozen AlexNet, VGG16 or SqueezeNet trunk, each tapped slice is
unit-normalised over channels, the squared differences are weighted by the
learned 1x1 "lin" heads, averaged over space and summed over slices. v0.0
skips the shift and scale (the original release's behaviour).

Images are NCHW. The trunks keep torchvision's ``features.{i}`` indices and
the heads LPIPS's ``lin{k}.model.1.weight``, so torchvision and LPIPS weight
files load with no converter (``load_lpips_state``). The modules compute in
f32; they run no hand-written kernel (cuDNN convolutions and plain torch).

Also here: the non-learned "fake" distances, the 2AFC / JND scorers of the
perceptual study, and 2AFC metric training (rank net, BCE ranking loss,
non-negative lin heads).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from bde2vid_tpu_torch.utils.device import resolve_device

# v0.1 colour normalisation (networks_basic.py:109-110)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_CHNS = [64, 192, 384, 256, 256]
VGG_CHNS = [64, 128, 256, 512, 512]
SQUEEZE_CHNS = [64, 128, 256, 384, 384, 512, 512]

# torchvision ``features`` indices of the convolutions
_ALEX_FEATURE_IDS = [0, 3, 6, 8, 10]
_VGG_FEATURE_IDS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_default_lpips_lin(net: str = "alex") -> Optional[str]:
    """The v0.1 lin-head weights when no path is given: ``$BDE2VID_LPIPS_LIN``
    (a path that does not exist raises: scoring with weights the user did not
    choose would be silent), else the repo-local ``weights/lpips/{net}.pth``,
    else None. The lin heads alone are not the metric: the backbone's
    torchvision weights come separately (``--lpips_backbone``)."""
    env = os.environ.get("BDE2VID_LPIPS_LIN")
    if env:
        if not os.path.isfile(env):
            raise FileNotFoundError(f"BDE2VID_LPIPS_LIN={env} does not exist (unset it to use "
                                    "the discovered defaults)")
        return env
    path = os.path.join(_REPO_ROOT, "weights", "lpips", f"{net}.pth")
    return path if os.path.isfile(path) else None


class _Trunk(nn.Module):
    """A torchvision ``features`` trunk that returns the outputs of the
    layers at ``taps`` (LPIPS's slices) and runs no layer past the last."""

    taps: tuple = ()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features[: self.taps[-1] + 1]):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return outs


class AlexNetFeatures(_Trunk):
    """torchvision ``alexnet().features``, tapped at relu1-5."""

    taps = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2),
        )


class VGG16Features(_Trunk):
    """torchvision ``vgg16().features``, tapped at relu1_2, 2_2, 3_3, 4_3, 5_3."""

    taps = (3, 8, 15, 22, 29)

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for width, convs in zip(VGG_CHNS, (2, 2, 3, 3, 3)):
            for _ in range(convs):
                layers += [nn.Conv2d(c_in, width, 3, padding=1), nn.ReLU()]
                c_in = width
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)


class _Fire(nn.Module):
    """torchvision squeezenet Fire: a 1x1 squeeze, then 1x1 and 3x3 expands
    concatenated, each followed by a ReLU."""

    def __init__(self, c_in: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(_Trunk):
    """torchvision ``squeezenet1_1().features`` (ceil-mode pools), tapped at
    LPIPS's 7 slices."""

    taps = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self):
        super().__init__()
        pool = lambda: nn.MaxPool2d(3, 2, ceil_mode=True)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 3, stride=2), nn.ReLU(), pool(),
            _Fire(64, 16, 64), _Fire(128, 16, 64), pool(),
            _Fire(128, 32, 128), _Fire(256, 32, 128), pool(),
            _Fire(256, 48, 192), _Fire(384, 48, 192), _Fire(384, 64, 256), _Fire(512, 64, 256),
        )


_BACKBONES = {"alex": (AlexNetFeatures, ALEX_CHNS), "vgg": (VGG16Features, VGG_CHNS),
              "vgg16": (VGG16Features, VGG_CHNS), "squeeze": (SqueezeNetFeatures, SQUEEZE_CHNS)}


def _backbone(net: str):
    if net not in _BACKBONES:
        raise ValueError(f"unsupported LPIPS net {net!r}")
    return _BACKBONES[net]


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise over channels (LPIPS util.normalize_tensor)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def cos_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-pixel cosine similarity over channels, averaged over space: (N,)
    (LPIPS util.cos_sim)."""
    return (_normalize_tensor(a) * _normalize_tensor(b)).sum(dim=1).mean(dim=(1, 2))


class _ShiftScale(nn.Module):
    """The v0.1 input normalisation (ScalingLayer), as non-persistent buffers."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class _LinHead(nn.Module):
    """NetLinLayer's 1x1 conv without bias, at LPIPS's ``model.1`` key. The
    reference's dropout at ``model.0`` is left out, as in the JAX package."""

    def __init__(self, chn: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(chn, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)


class LPIPS(nn.Module):
    """net-lin LPIPS distance of NCHW inputs in [-1, 1] with 3 channels:
    per example, (N,). ``pretrained_backbone`` says whether the trunk holds
    loaded weights (``load_lpips_state`` with a backbone, or a
    ``load_state_dict`` with the backbone's keys) or its random init."""

    def __init__(self, net: str = "alex", version: str = "0.1"):
        super().__init__()
        trunk, chns = _backbone(net)
        self.net, self.version = net, version
        self.scaling = _ShiftScale()
        self.backbone = trunk()
        for k, c in enumerate(chns):
            setattr(self, f"lin{k}", _LinHead(c))
        self.num_slices = len(chns)
        self.pretrained_backbone = False

    def lin_weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin{k}").model[1].weight for k in range(self.num_slices)]

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict, assign=assign)
        if any(k.startswith("backbone.") for k in state_dict):
            self.pretrained_backbone = True
        return result

    def forward(self, in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
        if self.version == "0.1":
            in0, in1 = self.scaling(in0), self.scaling(in1)
        total = 0.0
        for a, b, w in zip(self.backbone(in0), self.backbone(in1), self.lin_weights()):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            # the 1x1 conv without bias is a channel-weighted sum
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


def lpips_features(module: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
    """Unit-normalised backbone features of ``x`` (NCHW, in the backbone's
    input scale). ``module`` is an LPIPS or PNet network, or a bare trunk."""
    trunk = getattr(module, "backbone", module)
    return [_normalize_tensor(f) for f in trunk(x)]


def to_pm1_3ch(x: torch.Tensor, normalize: bool) -> torch.Tensor:
    """[0, 1] -> [-1, 1] (when ``normalize``), gray replicated to 3 channels."""
    if normalize:
        x = 2.0 * x - 1.0
    if x.shape[1] == 1:
        x = x.expand(-1, 3, -1, -1)
    return x


def lpips_distance(module: LPIPS, pred: torch.Tensor, target: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """The reference's perceptual_loss (evaluate/metrics.py:78-97): [0, 1]
    inputs scaled to [-1, 1], gray replicated to 3 channels, the network
    called as (target, pred); the mean distance over the batch."""
    return module(to_pm1_3ch(target, normalize), to_pm1_3ch(pred, normalize)).mean()


class PNet(nn.Module):
    """Unweighted perceptual distance (reference PNet, networks_basic.py:18-69):
    the sum over slices of the spatial mean of 1 - cosine similarity between
    backbone features, every channel weighted alike. NCHW inputs in [-1, 1];
    (N,)."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        self.net = net
        self.scaling = _ShiftScale()
        self.backbone = _backbone(net)[0]()

    def forward(self, in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
        val = 0.0
        for a, b in zip(self.backbone(self.scaling(in0)), self.backbone(self.scaling(in1))):
            cos = (_normalize_tensor(a) * _normalize_tensor(b)).sum(dim=1)
            val = val + (1.0 - cos).mean(dim=(1, 2))
        return val


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def load_lpips_state(lin_state: Mapping[str, object],
                     backbone_state: Optional[Mapping[str, object]] = None,
                     net: str = "alex", version: str = "0.1", device=None) -> LPIPS:
    """An LPIPS network from torch state dicts (tensors or numpy arrays), on
    ``device`` (CUDA unless the caller asks for the CPU), in eval mode.

    - ``lin_state``: ``lin{k}.model.1.weight`` of shape (1, C, 1, 1) (the
      LPIPS weights/v0.1/{net}.pth layout) or pip-lpips's ``lin{k}.weight``.
      Strict where not empty: a missing head raises KeyError, a head of the
      wrong width ValueError (a vgg file against net 'alex' agrees on lin0
      and only differs from lin1 on). ``{}`` asks for the backbone alone,
      with ones in the heads.
    - ``backbone_state``: torchvision ``features.{i}.weight/bias`` (other
      keys, such as a classifier's, are ignored). None keeps the trunk's
      seeded random init, and ``pretrained_backbone`` False: fit for
      architecture checks only, not for the metric.
    """
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = LPIPS(net=net, version=version)
    chns = _backbone(net)[1]
    if lin_state:
        for k, (c, w) in enumerate(zip(chns, module.lin_weights())):
            key = next((key for key in (f"lin{k}.model.1.weight", f"lin{k}.weight")
                        if key in lin_state), None)
            if key is None:
                raise KeyError(f"lin head 'lin{k}' not found in lin_state (looked for "
                               f"'lin{k}.model.1.weight' and 'lin{k}.weight'; got keys "
                               f"{sorted(lin_state)[:6]}...)")
            arr = _f32(lin_state[key]).reshape(-1)
            if arr.shape != (c,):
                raise ValueError(f"lin{k} weight has {arr.shape[0]} channels, net='{net}' "
                                 f"expects {c}: wrong-net lin file?")
            with torch.no_grad():
                w.copy_(arr.view(1, c, 1, 1))
    if backbone_state is not None:
        module.backbone.load_state_dict(
            {k: _f32(v) for k, v in backbone_state.items() if k.startswith("features.")})
        module.pretrained_backbone = True
    return module.to(resolve_device(device)).eval()


def lpips_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's LPIPS state dict of the JAX package's LPIPS params (as from
    ``load_lpips_params``; leaves as numpy or jax arrays): conv kernels HWIO
    -> OIHW under the torchvision ``features.{i}`` indices, lin vectors ->
    (1, C, 1, 1). Load it with ``LPIPS(net).load_state_dict``."""
    p = params.get("params", params)
    bb = p["backbone"]
    conv = lambda d: (_f32(np.asarray(d["kernel"]).transpose(3, 2, 0, 1)), _f32(d["bias"]))
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, d):
        out[prefix + ".weight"], out[prefix + ".bias"] = conv(d)

    if "fire3" in bb:  # squeezenet1_1
        put("backbone.features.0", bb["conv0"])
        for i in (3, 4, 6, 7, 9, 10, 11, 12):
            for sub in ("squeeze", "expand1x1", "expand3x3"):
                put(f"backbone.features.{i}.{sub}", bb[f"fire{i}"][sub])
    else:
        ids = _ALEX_FEATURE_IDS if len(bb) == len(_ALEX_FEATURE_IDS) else _VGG_FEATURE_IDS
        for j, i in enumerate(ids):
            put(f"backbone.features.{i}", bb[f"conv{j}"])
    for k in range(sum(key.startswith("lin") for key in p)):
        out[f"lin{k}.model.1.weight"] = _f32(p[f"lin{k}"]).view(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# Non-learned "fake" distances (reference networks_basic.py:223-259)
# ---------------------------------------------------------------------------


def l2_distance(in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
    """Per-example mean squared distance (FakeNet 'L2', inputs in [-1, 1])."""
    d = (in0 - in1) ** 2
    return d.mean(dim=tuple(range(1, d.ndim)))


def dssim_distance(in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM) / 2 per example of NCHW inputs in [-1, 1] (FakeNet 'DSSIM',
    RGB path): mapped to [0, 255] with tensor2im's uint8 floor and scored at
    ``data_range`` 255, channel-averaged. The reference's 'Lab' colour space
    is not implemented."""
    from bde2vid_tpu_torch.metrics.basic import structural_similarity

    to_im = lambda x: torch.floor((x + 1.0) * 127.5).clamp(0.0, 255.0)
    return torch.stack([
        (1.0 - structural_similarity(to_im(a)[None], to_im(b)[None], data_range=255.0)) / 2.0
        for a, b in zip(in0, in1)
    ])


# ---------------------------------------------------------------------------
# Perceptual-study scorers (reference LPIPS/models/dist_model.py:254-330,
# LPIPS/util/util.py:426-457), numpy
# ---------------------------------------------------------------------------


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC average precision (reference util.voc_ap :426-457): the exact
    area under the precision envelope, or with ``use_07_metric`` the
    11-point interpolation."""
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if not (rec >= t).any() else float(prec[rec >= t].max())
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def score_2afc(d0s: np.ndarray, d1s: np.ndarray, gts: np.ndarray):
    """Two-alternative forced choice score (reference :254-290): ``d0s`` /
    ``d1s`` are the distances ref->p0 / ref->p1, ``gts`` in [0, 1] the share
    of people preferring p1. (mean score, detail dict); ties score 0.5."""
    d0s = np.asarray(d0s, np.float64)
    d1s = np.asarray(d1s, np.float64)
    gts = np.asarray(gts, np.float64)
    scores = (d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts + (d1s == d0s) * 0.5
    return float(scores.mean()), dict(d0s=d0s, d1s=d1s, gts=gts, scores=scores)


def score_jnd(ds: np.ndarray, sames: np.ndarray):
    """Just-noticeable-difference mAP (reference :292-330): pairs sorted by
    distance give a PR curve with "same" as the positive class; its VOC AP."""
    ds = np.asarray(ds, np.float64)
    sames = np.asarray(sames, np.float64)
    sames_sorted = sames[np.argsort(ds)]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1.0 - sames_sorted)
    fns = sames_sorted.sum() - tps
    precs = tps / np.maximum(tps + fps, 1e-12)
    recs = tps / np.maximum(tps + fns, 1e-12)
    return voc_ap(recs, precs), dict(ds=ds, sames=sames)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(x) -> list:
    return _numpy(x).ravel().tolist()


def score_2afc_dataset(batches, func: Callable):
    """The reference loop: ``batches`` yields dicts with 'ref', 'p0', 'p1'
    and 'judge'; ``func(a, b)`` gives per-item distances."""
    d0s, d1s, gts = [], [], []
    for data in batches:
        d0s += _flat(func(data["ref"], data["p0"]))
        d1s += _flat(func(data["ref"], data["p1"]))
        gts += _flat(data["judge"])
    return score_2afc(np.array(d0s), np.array(d1s), np.array(gts))


def score_jnd_dataset(batches, func: Callable):
    """The reference loop: ``batches`` yields dicts with 'p0', 'p1', 'same'."""
    ds, sames = [], []
    for data in batches:
        ds += _flat(func(data["p0"], data["p1"]))
        sames += _flat(data["same"])
    return score_jnd(np.array(ds), np.array(sames))


# ---------------------------------------------------------------------------
# Metric training (2AFC): rank net and lin-head trainer
# ---------------------------------------------------------------------------


class Dist2Logit(nn.Module):
    """Two distances -> the probability of preferring the second (reference
    Dist2LogitLayer, networks_basic.py:177-191: 1x1 convs 5 -> mid -> mid ->
    1 with LeakyReLU(0.2) and a sigmoid; the distances are per-example
    scalars, so the convs are Linear layers over the 5 features)."""

    def __init__(self, chn_mid: int = 32):
        super().__init__()
        self.fc0 = nn.Linear(5, chn_mid)
        self.fc1 = nn.Linear(chn_mid, chn_mid)
        self.fc2 = nn.Linear(chn_mid, 1)

    def forward(self, d0: torch.Tensor, d1: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
        x = torch.stack([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], dim=-1)
        h = F.leaky_relu(self.fc0(x), 0.2)
        h = F.leaky_relu(self.fc1(h), 0.2)
        return torch.sigmoid(self.fc2(h))[..., 0]


def bce_ranking_loss(rank_net: Dist2Logit, d0, d1, judge) -> torch.Tensor:
    """BCERankingLoss (networks_basic.py:193-210): judge in [-1, 1] is the
    preference probability (judge + 1) / 2, scored by BCE against the rank
    net's output."""
    per = (judge + 1.0) / 2.0
    p = rank_net(d0, d1).clamp(1e-7, 1.0 - 1e-7)
    return -(per * torch.log(p) + (1.0 - per) * torch.log(1.0 - p)).mean()


def clamp_lin_nonnegative(module: LPIPS) -> None:
    """Reference clamp_weights (dist_model.py:173-175): the lin heads
    projected to >= 0, in place."""
    with torch.no_grad():
        for w in module.lin_weights():
            w.clamp_(min=0.0)


def compute_2afc_accuracy(d0, d1, judge) -> float:
    """dist_model.compute_accuracy :208-212: the share of human judgements
    the metric agrees with."""
    d0, d1, judge = (_numpy(a).ravel() for a in (d0, d1, judge))
    d1_lt_d0 = (d1 < d0).astype(np.float64)
    return float(np.mean(d1_lt_d0 * judge + (1 - d1_lt_d0) * (1 - judge)))


def make_2afc_train_step(module: LPIPS, rank_net: Dist2Logit, optimizer: torch.optim.Optimizer):
    """A 2AFC training step (dist_model.forward_train / optimize_parameters
    :166-206): only the lin heads and the rank net learn (the backbone is
    frozen here, the reference's 'lin' mode), and the lin heads are clamped
    to >= 0 after each update. ``optimizer`` holds the lin heads' and the
    rank net's parameters.

    step(ref, p0, p1, judge) -> loss; judge in [0, 1] is the share of people
    preferring p1 (the reference data)."""
    module.backbone.requires_grad_(False)

    def step(ref, p0, p1, judge) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        # the reference's forward_pair order: (ref, p_i)
        loss = bce_ranking_loss(rank_net, module(ref, p0), module(ref, p1), judge * 2.0 - 1.0)
        loss.backward()
        optimizer.step()
        clamp_lin_nonnegative(module)
        return loss.detach()

    return step
