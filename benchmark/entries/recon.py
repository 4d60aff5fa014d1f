"""Entry ``recon``: the eval driver reconstructing and scoring a recording,
over and over, as ``evaluate_all`` runs it over a dataset.

Set-up writes (or finds) the seeded recording, makes the model's and the
LPIPS net's weights from the seed on the device, builds the program's
model from them as the eval CLI does (kernels on where the card is),
opens the recording through the port's ``MMP`` backend and runs
``warmup_calls`` whole calls of ``eval.driver.evaluate_sequence``. The
window then calls it until ``--seconds`` have passed, ending with the call
in progress: ``recon_fps`` is all frames of those calls over all of their
time. A forward hook keeps the images of ``checked_chunks`` chunks, drawn
from the seed, from the window's last call, and the call returns every
frame's scores. With ``--trace 1`` the profiler then records
``traced_calls`` more calls with ranges around the voxels, the model, its
Swin blocks, LPIPS and the other scores.

Once the window has closed and the program's state is freed, the
reference works the checked chunks out again from the recording's raw
events and the seeded weights (voxels, images, scores), and the run is
correct where the images and the scores agree within the cell's limits.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import events as ref_events
from benchmark.reference import scores as ref_scores
from benchmark.traffic import recording


class Capture:
    """Forward hook on the program's model: the images of the checked
    chunks of the current call, by chunk."""

    def __init__(self, chunk: int, checked: List[int], sequence_model: bool):
        self.chunk, self.checked, self.sequence_model = chunk, set(checked), sequence_model
        self.frame = 0
        self.images: Dict[int, List[torch.Tensor]] = {}

    def new_call(self) -> None:
        self.frame, self.images = 0, {}

    def __call__(self, module, args, out) -> None:
        img = (out[0] if isinstance(out, tuple) else out)["image"]  # a step model returns its state too
        frames = img.reshape(-1, *img.shape[-2:])  # (frames, H, W): batch 1, one channel
        k = self.frame // self.chunk
        if k in self.checked:
            self.images.setdefault(k, []).append(frames)
        self.frame += len(frames) if self.sequence_model else 1


def build_program(cell: harness.Cell, state: Dict[str, torch.Tensor], lpips_state, device):
    """The program's model spec and LPIPS net, loaded with the seeded weights."""
    from bde2vid_tpu_torch.metrics.lpips import LPIPS
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.models.api import ModelSpec
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel

    cfg = cell.config
    model = build_model(cfg["model"], cfg["args"], device=device)
    missing, unexpected = model.load_state_dict(state, strict=False)
    own = model.state_dict()
    if unexpected or any(own[k].is_floating_point() for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, unexpected {unexpected}")
    set_attention_kernel(model, device.type == "cuda")  # the eval CLI's default
    spec = ModelSpec(name=cfg["model"], module=model, num_bins=cell.traffic["num_bins"],
                     num_encoders=cfg["num_encoders"], is_sequence_model=cfg["sequence_model"])
    net = LPIPS(cell.traffic["lpips_net"])
    net.load_state_dict(lpips_state)
    return spec, net.to(device).eval()


def swin_bound_hook(costs: List[float]):
    """A pre-hook on a Swin block that adds the least time of its call:
    max(operations / peak, bytes / bandwidth) of ``yardstick.swin_block_cost``
    at the call's windows."""
    from benchmark.yardstick import swin_block_cost, swin_windows

    def pre(block, args):
        x = args[0]
        d, b, h, w, c = x.shape
        win = (min(h, block.window_size[1]), min(w, block.window_size[2]))
        nwin = b * swin_windows(h, w, win, block.dilate_win)
        flops, nbytes = swin_block_cost(d, nwin, win[0] * win[1], c, block.attn.num_heads, 4 * c, 4)
        costs.append(max(flops / harness.PEAK_FLOPS_F32, nbytes / harness.PEAK_BYTES) * 1e3)

    return pre


def reference_flops_per_frame(cell: harness.Cell, ref, state, lpips_state, chunk: int) -> float:
    """Operations a frame of the reference's forward and scoring, counted by
    ``FlopCounterMode`` on the meta device over one chunk."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = cell.traffic["sensor"]
    meta = {k: torch.empty(v.shape, device="meta") for k, v in state.items()}
    lp_meta = {k: torch.empty(v.shape, device="meta") for k, v in lpips_state.items()}
    vox = torch.empty(chunk, cell.traffic["num_bins"], h, w, device="meta")
    with FlopCounterMode(display=False) as counter:
        img = ref.Runner(meta, cell.config["args"]).chunk(vox)
        if "p_loss" in cell.traffic["metrics"]:
            ref_scores.p_loss(lp_meta, img, img)
    return counter.get_total_flops() / chunk


class Setup:
    """One run's recording, weights, program and eval config, made from the
    seed; ``call`` is one call of the timed path."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from bde2vid_tpu_torch.data.pipeline import load_sequence
        from bde2vid_tpu_torch.eval import driver

        tr = cell.traffic
        self.cell, self.device, self.driver = cell, device, driver
        self.ref = cell.reference()
        chunk, items = tr["subseq_L"], tr["frames"] - 1
        rng = np.random.default_rng([seed & weights.SEED_MASK, 0xC4E])
        self.checked = sorted(rng.choice(items // chunk, tr["checked_chunks"], replace=False).tolist())
        self.path, self.write_s = recording.recording(cell.spec["traffic"], tr, seed)
        self.state = weights.seeded_state(self.ref.param_shapes(cell.config["args"]), seed, device)
        self.lpips_state = weights.seeded_state(ref_scores.lpips_shapes(), seed ^ 0x1F1F5, device)
        self.spec, self.net = build_program(cell, self.state, self.lpips_state, device)
        self.seq = load_sequence(self.path, num_bins=tr["num_bins"], ltype="MMP")
        self.cfg = driver.EvalConfig(ltype="MMP", num_bins=tr["num_bins"], subseq_L=chunk,
                                     metrics=tuple(tr["metrics"]), lpips=self.net)
        self.capture = Capture(chunk, self.checked, self.spec.is_sequence_model)
        self.hook = self.spec.module.register_forward_hook(self.capture)

    def call(self) -> Dict[str, List[float]]:
        """One ``evaluate_sequence`` call; its per-frame scores. It ends on
        the scores' copy to the host, so the device has finished."""
        self.capture.new_call()
        return self.driver.evaluate_sequence(self.spec, self.seq, self.cfg)[1]

    def images(self) -> Dict[int, torch.Tensor]:
        """The checked chunks' images of the last call, (L, H, W) each."""
        return {k: torch.cat(v) for k, v in self.capture.images.items()}

    def free_program(self) -> None:
        self.hook.remove()
        del self.spec, self.net, self.capture, self.cfg
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> Dict:
        return reference_outputs(self.cell, self.ref, self.state, self.lpips_state, self.path, self.checked,
                                 self.device)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts

    s = Setup(cell, seed, device)
    for _ in range(cell.traffic["warmup_calls"]):
        s.call()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        warm_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start - s.write_s  # writing the recording is the benchmark's, not set-up
    calls = 0
    while True:
        detail = s.call()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    images = s.images()
    frames = calls * len(s.seq)

    result = {"attempted": frames, "failed": 0}
    if trace:
        summary = traced_calls(cell, s, launch_counts)
        summary.update(frames_untraced=frames, seconds_untraced=window_s,
                       flops_per_frame=reference_flops_per_frame(cell, s.ref, s.state, s.lpips_state,
                                                                 cell.traffic["subseq_L"]))
        result["metrics"] = harness.read_per_layer(cell, summary)
        result["breakdown"] = summary["breakdown"]
    else:
        result["metrics"] = {
            "recon_fps": harness.metric(frames / window_s, "frames/s"),
            "peak_mem_gib": harness.metric(peak / 2 ** 30, "GiB"),
            "setup_s": harness.metric(setup_s, "s"),
        }
    result["setup"] = {"recording_write_s": s.write_s}
    result["device"] = harness.device_info(device, max(peak, warm_peak) if cuda else 0, cell.chips)
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    s.free_program()
    numbers = gaps(cell, s.reference(), images, detail)
    result["correct"], result["checks"] = harness.judge(numbers, cell.limits)
    return result


def traced_calls(cell, s: Setup, launch_counts) -> Dict:
    """``traced_calls`` calls under the profiler with the benchmark's
    ranges (``harness.profiled``, which takes a trace again where it lost
    device records or holds fewer launches than ``launch_counts`` counted
    calls of the port's kernel libraries); the summary of the trace, its
    frames and the Swin blocks' least time."""
    from bde2vid_tpu_torch.nn.window_attention import SwinTransformerBlock3D

    spec, net, seq, cfg, driver = s.spec, s.net, s.seq, s.cfg, s.driver
    s.hook.remove()
    ranges = harness.Ranges()
    costs: List[float] = []
    ranges.function(seq, "voxels", "bench.voxels")
    ranges.module(spec.module, "bench.model")
    for m in spec.module.modules():
        if isinstance(m, SwinTransformerBlock3D):
            ranges.module(m, "bench.swin_block", on_enter=swin_bound_hook(costs))
    ranges.module(net, "bench.lpips")
    for name in cell.traffic["metrics"]:
        if name in driver._METRICS:
            ranges.function(driver._METRICS, name, f"bench.score.{name}")
    n = cell.traffic["traced_calls"]

    def calls():
        costs.clear()
        for _ in range(n):
            driver.evaluate_sequence(spec, seq, cfg)

    try:
        summary = harness.profiled(calls, s.device, lambda: sum(launch_counts.values()))
    finally:
        ranges.close()
    summary.update(frames=n * len(seq), swin_bound_ms=sum(costs) if costs else None)
    return summary


def reference_outputs(cell, ref, state, lpips_state, path, checked, device):
    """The reference's images and scores of the checked chunks, from the
    recording's raw events: {chunk: (images (L, H, W), {score: (L,)})}."""
    tr = cell.traffic
    chunk, hw = tr["subseq_L"], tuple(tr["sensor"])
    t = np.load(f"{path}/t.npy", mmap_mode="r")
    xy = np.load(f"{path}/xy.npy", mmap_mode="r")
    p = np.load(f"{path}/p.npy", mmap_mode="r")
    frame_ts = np.load(f"{path}/timestamps.npy")
    gt = np.load(f"{path}/images.npy", mmap_mode="r")
    runner = ref.Runner(state, cell.config["args"])
    out = {}
    todo = range(max(checked) + 1) if runner.carries_state else checked
    with torch.no_grad():
        for k in todo:
            vox = []
            for i in range(k * chunk, (k + 1) * chunk):
                i0, i1 = ref_events.item_bounds(t, frame_ts, i)
                vox.append(ref_events.voxel_grid(np.asarray(xy[i0:i1]), np.asarray(t[i0:i1]),
                                                 np.asarray(p[i0:i1]), tr["num_bins"], hw, device))
            images = runner.chunk(torch.stack(vox))
            if k in checked:
                target = torch.as_tensor(np.array(gt[k * chunk:(k + 1) * chunk, ..., 0]),
                                         device=device).float() / 255.0
                out[k] = (images, {n: ref_scores.score(n, lpips_state, images, target)
                                   for n in tr["metrics"]})
    return out


def gaps(cell, reference, images, detail) -> Dict[str, float]:
    """The compared numbers: ``image_gap``, the largest |program - reference|
    over the checked chunks' pixels, and ``score_gap``, over the scores the
    largest |program - reference| of a checked frame relative to the mean
    |reference| of that score. A chunk or a frame the program did not
    produce reads inf."""
    chunk = cell.traffic["subseq_L"]
    image_gap, score_gap = 0.0, 0.0
    for k, (ref_img, ref_sc) in reference.items():
        got = images.get(k)
        if got is None or got.shape != ref_img.shape:
            return {"image_gap": math.inf, "score_gap": math.inf}
        image_gap = max(image_gap, float((got.float() - ref_img).abs().max()))
        for name, want in ref_sc.items():
            vals = detail.get(name, [])
            if len(vals) < (k + 1) * chunk:
                return {"image_gap": image_gap, "score_gap": math.inf}
            want = want.double().cpu()
            have = torch.tensor(vals[k * chunk:(k + 1) * chunk], dtype=torch.float64)
            scale = float(want.abs().mean()) or 1.0
            score_gap = max(score_gap, float((have - want).abs().max()) / scale)
    return {"image_gap": image_gap, "score_gap": score_gap}


def calibration(cell: harness.Cell, seed: int, device, variants: List[str]) -> Dict[str, Dict[str, float]]:
    """The numbers of the program ("") and of the control ("tf32": the
    reference in the program's place, in TF32) for ``seed``, each judged by
    the reference in f32."""
    s = Setup(cell, seed, device)
    out = {}
    if "" in variants:
        detail = s.call()
        images = s.images()
    s.free_program()
    want = s.reference()
    if "" in variants:
        out[""] = gaps(cell, want, images, detail)
    if "tf32" in variants:
        with harness.tf32():
            got = s.reference()
        chunk, items = cell.traffic["subseq_L"], cell.traffic["frames"] - 1
        detail = {n: [math.nan] * items for n in cell.traffic["metrics"]}
        for k, (_, sc) in got.items():
            for n, v in sc.items():
                detail[n][k * chunk:(k + 1) * chunk] = v.double().cpu().tolist()
        out["tf32"] = gaps(cell, want, {k: img for k, (img, _) in got.items()}, detail)
    return out
