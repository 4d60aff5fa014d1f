"""Plain PyTorch reference of E2VIDRecurrent in evaluation mode (uzh-rpg
rpg_e2vid, model/model.py E2VIDRecurrent over model/unet.py UNetRecurrent,
the released E2VID_lightweight), the model of the benchmark's E2VID cells.

Per frame: a 5x5 ReLU head; per encoder a stride-2 5x5 conv, BatchNorm and
ReLU, then a ConvLSTM cell (one 3x3 conv over [x, h] into the gates i, f, o,
g) whose state carries from frame to frame; residual blocks (3x3 conv, BN,
ReLU, 3x3 conv, BN, plus the input, ReLU); decoders of a stride-2
transposed 5x5 conv (output padding 1), BN and ReLU over summed skips; a
1x1 conv with BN over the sum with the head's features, then a sigmoid.
BatchNorm normalises with its running statistics. The convolutions under
BN have no bias. Weights are a flat dict under the checkpoint's names
(``unetrecurrent.*``); ``param_shapes`` lists them. Imports nothing of the
program under test.

Covered configuration: sum skips, BN, ConvLSTM cells, transposed-conv
decoders. Anything else raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_P = "unetrecurrent"


def _check(cfg: Dict) -> Dict:
    want = {"skip_type": "sum", "norm": "BN", "recurrent_block_type": "convlstm", "use_upsample_conv": False}
    if any(cfg.get(k) != v for k, v in want.items()):
        raise NotImplementedError(f"the reference covers {want} only")
    return cfg


def _bn_shapes(s: Dict, name: str, c: int) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        s[f"{name}.{k}"] = (c,)


def param_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every float tensor of the model's state dict."""
    _check(cfg)
    base, enc, bins = cfg["base_num_channels"], cfg["num_encoders"], cfg["num_bins"]
    ins = [base * 2 ** i for i in range(enc)]
    outs = [base * 2 ** (i + 1) for i in range(enc)]
    top = outs[-1]
    s = {f"{_P}.head.conv2d.weight": (base, bins, 5, 5), f"{_P}.head.conv2d.bias": (base,)}
    for i, (ci, co) in enumerate(zip(ins, outs)):
        s[f"{_P}.encoders.{i}.conv.conv2d.weight"] = (co, ci, 5, 5)
        _bn_shapes(s, f"{_P}.encoders.{i}.conv.norm_layer", co)
        s[f"{_P}.encoders.{i}.recurrent_block.Gates.weight"] = (4 * co, 2 * co, 3, 3)
        s[f"{_P}.encoders.{i}.recurrent_block.Gates.bias"] = (4 * co,)
    for r in range(cfg["num_residual_blocks"]):
        for k in (1, 2):
            s[f"{_P}.resblocks.{r}.conv{k}.weight"] = (top, top, 3, 3)
            _bn_shapes(s, f"{_P}.resblocks.{r}.bn{k}", top)
    for i, co in enumerate(reversed(outs)):
        s[f"{_P}.decoders.{i}.transposed_conv2d.weight"] = (co, co // 2, 5, 5)
        _bn_shapes(s, f"{_P}.decoders.{i}.norm_layer", co // 2)
    s[f"{_P}.pred.conv2d.weight"] = (1, base, 1, 1)
    _bn_shapes(s, f"{_P}.pred.norm_layer", 1)
    return s


def _bn(p, name, x):
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"], p[name + ".weight"],
                        p[name + ".bias"], False, 0.0, 1e-5)


class Runner:
    """Runs the reference frame by frame, its recurrent state carried from
    chunk to chunk until ``reset``, as the eval driver runs a step model
    over one sequence."""

    carries_state = True

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        self.p, self.cfg = params, _check(cfg)
        self.enc = cfg["num_encoders"]
        self.state = None

    def reset(self) -> None:
        self.state = None

    def step(self, v: torch.Tensor) -> torch.Tensor:
        """(N, bins, H, W) -> (N, 1, H, W)."""
        p = self.p
        x = head = torch.relu(F.conv2d(v, p[f"{_P}.head.conv2d.weight"], p[f"{_P}.head.conv2d.bias"], 1, 2))
        if self.state is None:
            self.state = [None] * self.enc
        blocks = []
        for i in range(self.enc):
            pre = f"{_P}.encoders.{i}"
            y = torch.relu(_bn(p, pre + ".conv.norm_layer", F.conv2d(x, p[pre + ".conv.conv2d.weight"], None, 2, 2)))
            h, c = self.state[i] if self.state[i] is not None else (torch.zeros_like(y), torch.zeros_like(y))
            gates = F.conv2d(torch.cat([y, h], 1), p[pre + ".recurrent_block.Gates.weight"],
                             p[pre + ".recurrent_block.Gates.bias"], 1, 1)
            gi, gf, go, gg = gates.chunk(4, 1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            x = torch.sigmoid(go) * torch.tanh(c)
            self.state[i] = (x, c)
            blocks.append(x)
        for r in range(self.cfg["num_residual_blocks"]):
            pre = f"{_P}.resblocks.{r}"
            y = torch.relu(_bn(p, pre + ".bn1", F.conv2d(x, p[pre + ".conv1.weight"], None, 1, 1)))
            x = torch.relu(_bn(p, pre + ".bn2", F.conv2d(y, p[pre + ".conv2.weight"], None, 1, 1)) + x)
        for i in range(self.enc):
            pre = f"{_P}.decoders.{i}"
            y = F.conv_transpose2d(x + blocks[self.enc - 1 - i], p[pre + ".transposed_conv2d.weight"], None,
                                   2, 2, 1)
            x = torch.relu(_bn(p, pre + ".norm_layer", y))
        y = F.conv2d(x + head, p[f"{_P}.pred.conv2d.weight"])
        return torch.sigmoid(_bn(p, f"{_P}.pred.norm_layer", y))

    def chunk(self, voxels: torch.Tensor) -> torch.Tensor:
        """(L, bins, H, W) -> (L, H, W), one step a frame."""
        return torch.cat([self.step(v[None])[:, 0] for v in voxels])
