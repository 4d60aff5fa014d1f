"""Entry ``train``: the train CLI's step loop on the flagship, batch after
batch of augmented windows from a seeded training set.

Set-up writes (or finds) the seeded training set (``sequences`` MMP
recordings), makes the model's and the LPIPS net's weights from the seed
on the device, builds what the train CLI builds from the mix's config (the
model in training mode on its kernels, Adam with its clip, the L1 and
Perceptual losses, the data-parallel step of one process, the window
stream of ``iterate_training_windows`` and the augment and DropPath
generators, seeded from the seed), and runs ``checked_steps`` steps. Those
are the steps the reference follows: their losses, the first step's
gradients as Adam holds them (its first moment over 1 - beta1) and the
weights' change over them are kept. The same objects then run the
window: steps until ``--seconds`` have passed, each ending on the losses'
copy to the host as the CLI's log does, so ``train_step_ms`` is the
window over its steps. ``--trace 1`` profiles ``traced_steps`` more steps
with ranges around drawing and augmenting the batch, the model and the
clip and Adam.

Once the window has closed and the program's state is freed, the reference
(``reference/train.py``) redraws the checked steps' batches from the raw
recordings and trains its own copy of the weights on them.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import bde2vid as ref_model
from benchmark.reference import scores as ref_scores
from benchmark.reference import train as ref_train
from benchmark.traffic import recording

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under Adam: they are left out of the comparison
QUIET_LEAF = 1e-3


class Setup:
    """The train step object of one run, made from the seed."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from bde2vid_tpu_torch.metrics.lpips import LPIPS
        from bde2vid_tpu_torch.models import build_model
        from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
        from bde2vid_tpu_torch.parallel.sharded_train import make_dp_train_step
        from bde2vid_tpu_torch.train.__main__ import iterate_training_windows
        from bde2vid_tpu_torch.train.optim import build_optimizer
        from bde2vid_tpu_torch.train.trainer import SequenceLossComputer

        tr, cfg = cell.traffic, cell.config
        self.cell, self.seed, self.device = cell, seed, device
        self.data = dict(tr["data"])
        self.path, self.write_s = recording.recording(cell.spec["traffic"], tr, seed)
        self.state = weights.seeded_state(ref_model.param_shapes(cfg["args"]), seed, device)
        self.lpips_state = weights.seeded_state(ref_scores.lpips_shapes(), seed ^ 0x1F1F5, device)
        self.model = build_model(cfg["model"], cfg["args"], device=device, train=True)
        self.model.load_state_dict(self.state, strict=False)
        set_attention_kernel(self.model, device.type == "cuda")
        net = LPIPS(tr["lpips_net"])
        net.load_state_dict(self.lpips_state)
        comp = SequenceLossComputer(tr["losses"], tr.get("loss_inds"), lpips=net.to(device))
        self.optimizer, sched, clip, _ = build_optimizer(self.model.parameters(), tr["optimizer"])
        self.step_fn = make_dp_train_step(self.model, self.optimizer, comp, grad_clip=clip, scheduler=sched)
        self.generators = {"augment": torch.Generator(device=device).manual_seed(self.aug_seed),
                           "droppath": torch.Generator(device=device).manual_seed(self.drop_seed)}
        crop = self.data.pop("crop_size")
        rot = self.data["transforms"]["RandomRotationFlip"]
        self.batches = iterate_training_windows(
            self.path, self.data["sequence_length"], tr["num_bins"], self.data, batch=tr["batch"],
            seed=seed & weights.SEED_MASK, multiple=2 ** cfg["num_encoders"], crop_size=(crop, crop),
            rot_cfg=rot, ltype="MMP", device=device)
        self.crop = (crop, crop)

    @property
    def aug_seed(self) -> int:
        return (self.seed ^ 0xA06) & weights.SEED_MASK

    @property
    def drop_seed(self) -> int:
        return (self.seed ^ 0xD0D) & weights.SEED_MASK

    def draw(self):
        """The next batch with its noise and hot pixels (the CLI's loop)."""
        from bde2vid_tpu_torch.data.transforms import draw_hot_pixels, hot_pixels_from_draws, noise_from_draws

        d = self.data
        voxels, frames, flows = next(self.batches)
        g = self.generators["augment"]
        normal = torch.randn(voxels.shape, dtype=voxels.dtype, generator=g, device=voxels.device)
        uniform = torch.rand(voxels.shape, generator=g, device=voxels.device)
        voxels = noise_from_draws(voxels, normal, uniform, d["noise_std"], d["noise_fraction"])
        h, w = voxels.shape[-2:]
        draws = [draw_hot_pixels(g, h, w, voxels.device, d["hot_pixel_std"], d["max_hot_pixel_fraction"])
                 for _ in range(voxels.shape[1])]
        voxels = torch.stack([hot_pixels_from_draws(voxels[:, n], *draws[n]) for n in range(len(draws))], 1)
        return voxels, frames, flows

    def train(self, batch) -> Dict[str, float]:
        """One train step; its losses, read back to the host."""
        loss_dict = self.step_fn(*batch, generator=self.generators["droppath"])
        return dict(zip(loss_dict, torch.stack(list(loss_dict.values())).tolist()))

    def step(self) -> Dict[str, float]:
        return self.train(self.draw())

    def checked_steps(self) -> Dict:
        """The first ``checked_steps`` steps and what the reference compares of them."""
        losses, first_grad = [], None
        b1 = self.optimizer.param_groups[0]["betas"][0]
        for k in range(self.cell.traffic["checked_steps"]):
            losses.append(self.step()["loss"])
            if k == 0:
                st = self.optimizer.state
                first_grad = {n: float(st[p]["exp_avg"].norm()) / (1 - b1) if p in st else 0.0
                              for n, p in self.model.named_parameters()}
        change = {n: float((p.detach() - self.state[n]).norm()) for n, p in self.model.named_parameters()}
        return {"losses": losses, "first_grad": first_grad, "change": change}

    def free_program(self) -> None:
        del self.model, self.optimizer, self.step_fn, self.batches
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, variant: str = "") -> Dict:
        """The reference's readings of the checked steps. ``variant``: a
        fault planted in it ("half_batch": the loss of half of each batch's
        rows; "grad_altered": one leaf's gradient doubled)."""
        tr, dev = self.cell.traffic, self.device
        recs = ref_train.Recordings(self.path)
        aug = torch.Generator(device=dev).manual_seed(self.aug_seed)
        drop = torch.Generator(device=dev).manual_seed(self.drop_seed)
        trainer = ref_train.Trainer(self.state, self.cell.config["args"], self.lpips_state, tr["optimizer"])
        seq_len, bins = self.data["sequence_length"], tr["num_bins"]
        sensor = tuple(recs.seqs[0]["images"].shape[1:3])
        losses, first_grad = [], None
        for k in range(tr["checked_steps"]):
            rows = ref_train.draw_rows(recs.lengths, sensor, self.seed & weights.SEED_MASK, k, tr["batch"],
                                       seq_len, self.crop, self.data)
            wins = [recs.window(r, seq_len, bins, self.crop, dev) for r in rows]
            voxels = ref_train.augment(torch.stack([v for v, _ in wins], 1), aug, self.data)
            frames = torch.stack([f for _, f in wins], 1)
            masks = ref_model.drop_path_masks(self.cell.config["args"], seq_len, tr["batch"], drop, dev)
            loss, grads = trainer.gradients(voxels, frames, masks, variant)
            grads = trainer.apply(grads)
            losses.append(loss)
            if k == 0:
                first_grad = {n: float(g.norm()) for n, g in grads.items()}
        change = {n: float((p.detach() - self.state[n]).norm()) for n, p in trainer.params.items()}
        return {"losses": losses, "first_grad": first_grad, "change": change}


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], moving: List[str]) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    median = float(np.median([want[n] for n in moving]))
    return max(abs(got.get(n, 0.0) - want[n]) / max(want[n], median) for n in moving)


def gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    """``loss_gap``: the worst checked step's |loss - reference| over the
    reference's; ``grad_gap`` and ``change_gap``: ``_leaf_gap`` of the first
    step's gradients and of the weights' change, over the leaves the
    reference's gradient moves (``QUIET_LEAF``)."""
    ref_grad = reference["first_grad"]
    median = float(np.median([v for v in ref_grad.values() if v > 0]))
    moving = sorted(n for n, v in ref_grad.items() if v >= QUIET_LEAF * median)
    if len(program["losses"]) != len(reference["losses"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gap(program["first_grad"], ref_grad, moving),
            "change_gap": _leaf_gap(program["change"], reference["change"], moving)}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    s = Setup(cell, seed, device)
    checked = s.checked_steps()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        warm_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start - s.write_s  # writing the recording is the benchmark's, not set-up
    steps = 0
    while True:
        s.step()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"attempted": steps, "failed": 0}
    if trace:
        summary = traced_steps(cell, s)
        summary.update(steps_untraced=steps, seconds_untraced=window_s,
                       flops_per_step=reference_flops_per_step(cell, s))
        result["metrics"] = harness.read_per_layer(cell, summary)
        result["breakdown"] = summary["breakdown"]
    else:
        result["metrics"] = {
            "train_step_ms": harness.metric(1e3 * window_s / steps, "ms"),
            "peak_mem_gib": harness.metric(peak / 2 ** 30, "GiB"),
            "setup_s": harness.metric(setup_s, "s"),
        }
    result["setup"] = {"recording_write_s": s.write_s}
    result["device"] = harness.device_info(device, max(peak, warm_peak) if cuda else 0, cell.chips)
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    s.free_program()
    numbers = gaps(checked, s.reference())
    result["correct"], result["checks"] = harness.judge(numbers, cell.limits)
    return result


def traced_steps(cell: harness.Cell, s: Setup) -> Dict:
    """``traced_steps`` steps under the profiler, with ranges around the
    batch's drawing and augmenting (host time with one sync at its end),
    the model, and the clip and Adam (``harness.profiled``, which takes a
    trace again where it lost device records)."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts

    ranges = harness.Ranges()
    ranges.module(s.model, "bench.model")
    ranges.function(torch.nn.utils, "clip_grad_norm_", "bench.optimizer")
    ranges.hooks(s.optimizer.register_step_pre_hook(lambda *_: ranges.enter("bench.optimizer")),
                 s.optimizer.register_step_post_hook(lambda *_: ranges.exit()))
    n, data_s = cell.traffic["traced_steps"], [0.0]
    cuda = s.device.type == "cuda"

    def steps():
        data_s[0] = 0.0
        for _ in range(n):
            t0 = time.perf_counter()
            with torch.autograd.profiler.record_function("bench.data"):
                batch = s.draw()
                if cuda:
                    torch.cuda.synchronize(s.device)
            data_s[0] += time.perf_counter() - t0
            s.train(batch)

    try:
        summary = harness.profiled(steps, s.device, lambda: sum(launch_counts.values()))
    finally:
        ranges.close()
    summary.update(steps=n, data_ms=1e3 * data_s[0])
    return summary


def reference_flops_per_step(cell: harness.Cell, s: Setup) -> float:
    """Operations of one step of the reference on one card: forward, loss
    and backward, counted by ``FlopCounterMode`` on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    tr = cell.traffic
    l, n = s.data["sequence_length"], tr["batch"]
    params = {k: torch.empty(v.shape, device="meta", requires_grad=True) for k, v in s.state.items()}
    lpips = {k: torch.empty(v.shape, device="meta") for k, v in s.lpips_state.items()}
    vox = torch.empty(l, n, tr["num_bins"], *s.crop, device="meta")
    frames = torch.empty(l, n, 1, *s.crop, device="meta")
    masks = {k: (torch.ones(n, device="meta"),) * 2
             for k in ref_model.drop_path_masks(cell.config["args"], l, n, torch.Generator(), "cpu")}
    with FlopCounterMode(display=False) as counter:
        ref_train.loss_terms(lpips, ref_model.forward(params, cell.config["args"], vox, masks), frames).backward()
    return counter.get_total_flops()


def calibration(cell: harness.Cell, seed: int, device, variants: List[str]) -> Dict[str, Dict[str, float]]:
    """The numbers of the program ("") and of the reference put in its place
    with a planted fault or in TF32 ("tf32", "half_batch", "grad_altered")
    for ``seed``, each judged by the reference in f32."""
    s = Setup(cell, seed, device)
    program = s.checked_steps() if "" in variants else None
    s.free_program()
    want = s.reference()
    out = {"": gaps(program, want)} if program is not None else {}
    for v in variants:
        if v == "tf32":
            with harness.tf32():
                out[v] = gaps(s.reference(), want)
        elif v:
            out[v] = gaps(s.reference(v), want)
    return out
