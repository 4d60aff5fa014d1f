#!/usr/bin/env python3
"""Drive the PyTorch port (bde2vid_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; a failure in any phase raises and the script
exits non-zero without a result line:

  build    nvcc-builds every CUDA kernel from the sources in this checkout
  kernels  each kernel vs its plain PyTorch twin on the card at the flagship
           shapes (f32 within 1e-4, bf16 within 2e-2 * max|twin|), with times:
           the Swin block (plain; masked with acc), the attention-core
           backward (with torch's SDPA backward as the library yardstick)
  model    flagship BDE2VID at full width on 184x240, T=8, seeded random
           weights: the kernel path vs the unfused path (f32, within 2e-4),
           and exactly 10 kernel launches per frame
  eval     the eval path: the eval CLI on a synthetic 180x240 MMP sequence
           with a flagship checkpoint, f32 and --bf16; result files finite
  grads    flagship at full width, 184x240, T=3, training mode: the kernel
           path's loss and gradients vs the unfused path's (relative 1e-3),
           10 launches of each kernel per frame, then 5 Adam steps (lr 1e-4)
           that lower the loss
  train    the training path: the train CLI for 6 steps on the MMP sequence
           (flagship, DropPath 0.2, pause, noise, hot pixels, Adam with
           gradient clipping); finite losses, 480 launches of each kernel, a
           checkpoint the eval CLI scores; ms per step, peak memory, and one
           profiled step's device-idle share

Then the kernel summary line, the card's name and power limit, and
{"ok": true, "device": {...}} as the last line. TF32 is off for matmuls and
convolutions, so f32 comparisons are exact-f32 on both sides.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FLAGSHIP_CFG = {
    "generator": {
        "type": "BDE2VIDCrossscalePropogationV5",
        "num_bins": 5, "basechannels": 32, "num_encoders": 3, "ks": 5, "num_res_blocks": 2,
        "buffer_index": [-3, -2, -1, 0, 1, 2, 3], "depths": [4, 0, 6], "num_heads": 16,
        "window_size": [7, 7],
    }
}
FLAGSHIP_CFG_TEXT = """
model = dict(
    type='BDE2VID',
    generator=dict(
        type='BDE2VIDCrossscalePropogationV5',
        num_bins=5, basechannels=32, num_encoders=3, ks=5, num_res_blocks=2,
        buffer_index=[-3, -2, -1, 0, 1, 2, 3], depths=[4, 0, 6], num_heads=16,
        window_size=(7, 7), drop_path_rate=0.2, activation=dict(type='Sigmoid'),
    ),
)
"""
TRAIN_STEPS, TRAIN_SEQ_LEN = 6, 8
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# flagship attention levels on a 184x240 input: (padded feature map, channels);
# both give 252 / 20 windows of 7x7 for plain and dilation-2 partitions
LEVELS = {"level0": ((98, 126), 64), "level2": ((28, 35), 256)}
BLOCKS_PER_FRAME = {"level0": 4, "level2": 6}  # depths [4, 0, 6]


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, top=12):
    """One call of ``fn`` under torch.profiler: wall ms, summed device ms of
    the CUDA kernels and copies it ran, the idle share of that wall time and
    the ``top`` entries by device time. Device fields are None when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = getattr(evt, "self_cuda_time_total", 0) if us is None else us
        if evt.device_type == DeviceType.CUDA and us > 0:
            dev[evt.key[:90]] = dev.get(evt.key[:90], 0.0) + us / 1e3
    busy = sum(dev.values()) if dev else None
    return {
        "wall_ms": wall_ms,
        "device_ms": busy,
        "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall_ms),
        "top": sorted(dev.items(), key=lambda kv: -kv[1])[:top],
    }


def swin_block_cost(d, b, m, c, heads, hidden, elem_bytes):
    """(FLOPs, bytes) one fused_swin_block call needs: 2 per multiply-add of
    the projections, attention and MLP; each input read once (x, ctr,
    weights in the operand type, vectors and the bias in f32), the output
    written once."""
    n = d * m
    hd = c // heads
    flops = (2 * d * b * m * c * 2 * c + 2 * b * m * c * c + 2 * 2 * b * heads * m * n * hd
             + 2 * b * m * c * c + 2 * 2 * b * m * c * hidden)
    nbytes = (elem_bytes * (d * b * m * c + 2 * b * m * c + 4 * c * c + 2 * c * hidden)
              + 4 * (heads * m * n + 10 * c + hidden))
    return flops, nbytes


def phase_build():
    from bde2vid_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build()
    ptxas = [line.strip() for log in build.ptxas_reports.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": ptxas[:8]})


def phase_kernels(torch):
    from bde2vid_tpu_torch.nn.window_attention import window_partition, window_partition_dilated
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        SwinBlockParams, fused_swin_block, swin_block_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d, heads, q_ind, win = 7, 16, 3, (7, 7)
    m = win[0] * win[1]
    cases = []
    split = {}
    for level, ((hp, wp), c) in LEVELS.items():
        hidden = 4 * c
        p = SwinBlockParams(
            1 + rnd(c, scale=0.1), rnd(c, scale=0.1), 1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
            rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), rnd(2 * c, c, scale=c**-0.5),
            rnd(2 * c, scale=0.1), rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1),
            1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(hidden, c, scale=c**-0.5),
            rnd(hidden, scale=0.1), rnd(c, hidden, scale=hidden**-0.5), rnd(c, scale=0.1),
            rnd(heads, m, d * m, scale=0.5),
        )
        feats = rnd(d + 1, 1, hp, wp, c)
        for layout, part in (("plain", window_partition), ("dilated", window_partition_dilated)):
            x32 = part(feats[:d], win).reshape(d, -1, m, c).contiguous()
            c32 = part(feats[d:], win)[0].reshape(-1, m, c).contiguous()
            b = x32.shape[1]
            for dt in (torch.float32, torch.bfloat16):
                x, ctr = x32.to(dt), c32.to(dt)
                out = fused_swin_block(x, ctr, p, heads, q_ind)
                ref = swin_block_reference(x, ctr, p, heads, q_ind)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ref_max = ref.float().abs().max().item()
                tol = 1e-4 if dt == torch.float32 else 2e-2 * ref_max
                if not math.isfinite(err) or err > tol:
                    raise AssertionError(f"{level} {layout} {dt}: kernel vs twin {err} > {tol}")
                name = str(dt).split(".")[-1]
                flops, nbytes = swin_block_cost(d, b, m, c, heads, hidden, x.element_size())
                t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
                cases.append({
                    "level": level, "layout": layout, "dtype": name, "windows": b, "channels": c,
                    "max_abs_err": err, "tolerance": tol, "max_abs_ref": ref_max,
                    "kernel_ms": cuda_ms(torch, lambda: fused_swin_block(x, ctr, p, heads, q_ind), 20),
                    "plain_ms": cuda_ms(torch, lambda: swin_block_reference(x, ctr, p, heads, q_ind), 5, 1),
                    "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_flops, t_bytes),
                    "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                })
            if layout == "plain":
                # device time of each of the three kernels behind one f32 launch
                x, ctr = x32, c32
                prof = device_profile(torch, lambda: [fused_swin_block(x, ctr, p, heads, q_ind)
                                                      for _ in range(5)], top=3)
                prof["top"] = [(k, ms / 5) for k, ms in prof["top"]]
                split[level] = prof["top"]
    emit({"phase": "kernels", "kernel": "fused_swin_block", "timing": "CUDA events, inputs L2-warm",
          "cases": cases, "f32_device_ms_per_launch_by_kernel": split})
    return cases


def phase_model(torch, launch_counts):
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel

    torch.manual_seed(0)
    cfg = json.loads(json.dumps(FLAGSHIP_CFG))
    cfg["use_pallas_attention"] = True
    model = build_model("BDE2VID", cfg)
    T = 8
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()

    def run():
        with torch.no_grad():
            out = model(vox)["image"]
        torch.cuda.synchronize()
        return out

    run()  # warm-up (cuDNN algorithm choice, index uploads)
    launch_counts.clear()
    t0 = time.perf_counter()
    img_kernel = run()
    kernel_s = time.perf_counter() - t0
    launches = launch_counts["fused_swin_block"]
    if launches != 10 * T:
        raise AssertionError(f"kernel launches {launches} != 10 x T = {10 * T}")
    set_attention_kernel(model, False)
    run()
    t0 = time.perf_counter()
    img_plain = run()
    plain_s = time.perf_counter() - t0
    diff = (img_kernel - img_plain).abs().max().item()
    if not (img_kernel.shape == (T, 1, 1, 184, 240) and torch.isfinite(img_kernel).all()
            and diff <= 2e-4):
        raise AssertionError(f"model: kernel vs unfused path max diff {diff} (bound 2e-4)")
    emit({"phase": "model", "T": T, "hw": [184, 240], "launches": launches,
          "max_abs_diff_vs_unfused": diff, "forward_ms_kernel_path": 1e3 * kernel_s,
          "forward_ms_unfused_path": 1e3 * plain_s})


def write_mmp_sequence(path, rng, num_frames=24, events_per_frame=40000, hw=(180, 240), fps=25.0):
    os.makedirs(path)
    h, w = hw
    n = num_frames * events_per_frame
    t_start = 1000.0
    frame_ts = t_start + (np.arange(num_frames) + 1) / fps
    ts = np.sort(rng.uniform(t_start, frame_ts[-1], size=n))
    np.save(os.path.join(path, "t.npy"), ts)
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], axis=1).astype(np.int16)
    np.save(os.path.join(path, "xy.npy"), xy)
    np.save(os.path.join(path, "p.npy"), rng.integers(0, 2, n).astype(np.uint8))
    yy, xx = np.mgrid[0:h, 0:w]
    imgs = [(127.5 + 100 * np.sin(xx / 17.0 + k / 3.0) * np.cos(yy / 13.0)).astype(np.uint8)
            for k in range(num_frames)]
    np.save(os.path.join(path, "images.npy"), np.stack(imgs)[..., None])
    np.save(os.path.join(path, "timestamps.npy"), frame_ts)
    with open(os.path.join(path, "dataset_config.json"), "w") as fp:
        json.dump({"sensor_resolution": [h, w]}, fp)
    return num_frames - 1  # between-frames items


def phase_eval(torch, launch_counts, card):
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.models import build_model

    rows = {}
    main_path_launches = None
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        rng = np.random.default_rng(1)
        items = write_mmp_sequence(os.path.join(tmp, "data", "mmp", "SYN", "seq0"), rng)
        torch.manual_seed(1)
        model = build_model("BDE2VID", FLAGSHIP_CFG)
        os.makedirs(os.path.join(tmp, "weights"))
        torch.save({"meta": {"cfg": FLAGSHIP_CFG_TEXT},
                    "state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
                   os.path.join(tmp, "weights", "epoch_1.pth"))
        del model
        for run in ("f32", "f32_warm", "bf16", "bf16_warm", "f32_profiled"):
            out_dir = os.path.join(tmp, "out_" + run)
            args = ["--weights_dir", os.path.join(tmp, "weights"),
                    "--data_dir", os.path.join(tmp, "data"), "--datasets", "SYN",
                    "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", "8",
                    "--output_dir", out_dir]
            if run.startswith("bf16"):
                args.append("--bf16")
            launch_counts.clear()
            if run == "f32_profiled":
                # a separate traced run: where the device time goes, and its idle share
                prof = device_profile(torch, lambda: eval_main(args))
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = eval_main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"eval CLI ({run}) returned {rc}")
            launches = launch_counts["fused_swin_block"]
            if run == "f32":
                main_path_launches = launches
            base = os.path.join(out_dir, "epoch_1_L8_org")
            with open(base + ".txt") as fp:
                result = json.load(fp)["SYN"]["seq0"]
            with open(base + "_detail.txt") as fp:
                detail = json.load(fp)["SYN"]["seq0"]
            if not (os.path.exists(base + "_table.txt") and set(result) == {"mse", "ssim"}
                    and all(math.isfinite(v) for v in result.values())
                    and all(len(detail[k]) == items for k in result)):
                raise AssertionError(f"eval CLI ({run}) wrote bad results: {result}")
            if launches != 10 * items:
                raise AssertionError(f"eval CLI ({run}): {launches} kernel launches, want {10 * items}")
            rows[run] = {"seconds": seconds, "frames_per_s": items / seconds,
                         "launches": launches, **result}
    emit({"phase": "eval", "items": items, "hw": [180, 240], "subseq_L": 8, "card": card,
          "runs": rows, "f32_profile": prof})
    return main_path_launches


def attn_bwd_cost(b, m, n, c, heads, elem_bytes):
    """(FLOPs, bytes) one attn_core_backward call needs: the five products
    (scores, dv, dp, dq, dk) of M*N*C multiply-adds per window; q, g, k, v
    read and dq, dk, dv written once in the operand type, bias read and dbias
    written once in f32."""
    flops = 10 * b * m * n * c
    nbytes = elem_bytes * (3 * b * m * c + 4 * b * n * c) + 4 * 2 * heads * m * n
    return flops, nbytes


def sdpa_backward_ms(torch, q, k, v, bias, g, heads, iters=10):
    """Time of the backward alone of torch's scaled_dot_product_attention on
    the same function (softmax(q k^T hd^-0.5 + bias) v per head, the bias
    broadcast over windows and requiring grad), and the backend PyTorch
    takes first. (None, reason) when no backend takes these shapes."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b_, m, c = q.shape
    hd = c // heads

    def heads_of(t):
        return t.reshape(b_, -1, heads, hd).transpose(1, 2).detach().requires_grad_()

    qh, kh, vh = heads_of(q), heads_of(k), heads_of(v)
    bh = bias[None].to(q.dtype).detach().requires_grad_()
    gh = g.reshape(b_, m, heads, hd).transpose(1, 2)
    errors = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusing backend warns why
                out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bh)

                def bwd():
                    torch.autograd.grad(out, (qh, kh, vh, bh), gh, retain_graph=True)

                return cuda_ms(torch, bwd, iters), backend.name
        except RuntimeError as exc:
            errors[backend.name] = str(exc).splitlines()[0][:80]
    return None, f"no SDPA backend takes these shapes: {errors}"


def phase_kernels_training(torch):
    """The training variants of the Swin block kernel (masks, acc) and the
    attention-core backward, each vs its twin at the flagship shapes."""
    from bde2vid_tpu_torch.nn.window_attention import window_partition, window_partition_dilated
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        SwinBlockParams, _pre_stage, attn_core_backward, attn_core_backward_reference,
        fused_swin_block, swin_block_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def check(what, got, ref, dt):
        errs = []
        for a, r in zip(got, ref):
            err = (a.float() - r.float()).abs().max().item()
            ref_max = r.float().abs().max().item()
            tol = 1e-4 * max(1.0, ref_max) if dt == torch.float32 else 2e-2 * ref_max
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"{what}: kernel vs twin {err} > {tol}")
            errs.append(err)
        return errs

    d, heads, q_ind, win = 7, 16, 3, (7, 7)
    m = win[0] * win[1]
    block_cases, bwd_cases = [], []
    for level, ((hp, wp), c) in LEVELS.items():
        hidden = 4 * c
        p = SwinBlockParams(
            1 + rnd(c, scale=0.1), rnd(c, scale=0.1), 1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
            rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), rnd(2 * c, c, scale=c**-0.5),
            rnd(2 * c, scale=0.1), rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1),
            1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(hidden, c, scale=c**-0.5),
            rnd(hidden, scale=0.1), rnd(c, hidden, scale=hidden**-0.5), rnd(c, scale=0.1),
            rnd(heads, m, d * m, scale=0.5),
        )
        feats = rnd(d + 1, 1, hp, wp, c)
        for layout, part in (("plain", window_partition), ("dilated", window_partition_dilated)):
            x32 = part(feats[:d], win).reshape(d, -1, m, c).contiguous()
            c32 = part(feats[d:], win)[0].reshape(-1, m, c).contiguous()
            b = x32.shape[1]
            keep = 0.8  # DropPath 0.2, per window
            masks = tuple(torch.bernoulli(torch.full((b,), keep, device=dev), generator=gen) / keep
                          for _ in range(2))
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                x, ctr = x32.to(dt), c32.to(dt)
                got = fused_swin_block(x, ctr, p, heads, q_ind, masks=masks, with_acc=True)
                ref = swin_block_reference(x, ctr, p, heads, q_ind, masks=masks, with_acc=True)
                torch.cuda.synchronize()
                err_out, err_acc = check(f"block {level} {layout} {name} masked+acc", got, ref, dt)
                flops, nbytes = swin_block_cost(d, b, m, c, heads, hidden, x.element_size())
                nbytes += x.element_size() * b * m * c + 4 * 2 * b  # the acc output, the masks
                t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
                block_cases.append({
                    "level": level, "layout": layout, "dtype": name, "windows": b,
                    "max_abs_err": max(err_out, err_acc), "max_abs_err_acc": err_acc,
                    "kernel_ms": cuda_ms(torch, lambda: fused_swin_block(
                        x, ctr, p, heads, q_ind, masks=masks, with_acc=True), 20),
                    "plain_ms": cuda_ms(torch, lambda: swin_block_reference(
                        x, ctr, p, heads, q_ind, masks=masks, with_acc=True), 5, 1),
                    "bound_ms": 1e3 * max(t_flops, t_bytes),
                    "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                })
                # the backward at the shapes the block's backward gives it:
                # q, k, v from the block's pre stage, a random cotangent
                q, k, v = _pre_stage(x, ctr, p, heads, q_ind)
                g = rnd(b, m, c).to(dt)
                bias = p.bias
                got = attn_core_backward(q, k, v, bias, g, heads)
                again = attn_core_backward(q, k, v, bias, g, heads)
                ref = attn_core_backward_reference(q, k, v, bias, g, heads)
                torch.cuda.synchronize()
                errs = check(f"attn_core_backward {level} {layout} {name}", got, ref, dt)
                if not all(torch.equal(a, r) for a, r in zip(got, again)):
                    raise AssertionError("attn_core_backward: two runs differ")
                flops, nbytes = attn_bwd_cost(b, m, d * m, c, heads, x.element_size())
                t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
                lib_ms, backend = sdpa_backward_ms(torch, q, k, v, bias, g, heads)
                bwd_cases.append({
                    "level": level, "layout": layout, "dtype": name, "windows": b, "channels": c,
                    "max_abs_err": max(errs), "errs_dq_dk_dv_dbias": errs, "deterministic": True,
                    "kernel_ms": cuda_ms(torch, lambda: attn_core_backward(q, k, v, bias, g, heads), 20),
                    "plain_ms": cuda_ms(torch, lambda: attn_core_backward_reference(
                        q, k, v, bias, g, heads), 5, 1),
                    "library_ms": lib_ms, "library": backend,
                    "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_flops, t_bytes),
                    "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                })
    emit({"phase": "kernels", "kernel": "fused_swin_block, masked with acc",
          "timing": "CUDA events, inputs L2-warm", "cases": block_cases})
    emit({"phase": "kernels", "kernel": "attn_core_backward",
          "timing": "CUDA events, inputs L2-warm; library = torch SDPA backward alone",
          "cases": bwd_cases})
    return bwd_cases


def phase_grads(torch, launch_counts):
    """Kernel path vs unfused path: loss and every gradient, flagship width."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer, train_step

    T = 3
    cfg = json.loads(json.dumps(FLAGSHIP_CFG))
    cfg["generator"]["drop_path_rate"] = 0.0
    cfg["use_pallas_attention"] = True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model("BDE2VID", cfg, train=True)
    rng = np.random.default_rng(3)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    tgt = torch.from_numpy(rng.uniform(size=(T, 1, 1, 184, 240)).astype(np.float32)).cuda()
    comp = SequenceLossComputer([{"type": "L1Loss"}])

    def loss_and_grads(kernel):
        set_attention_kernel(model, kernel)
        model.zero_grad(set_to_none=True)
        launch_counts.clear()
        loss, _ = comp(model(vox)["image"], tgt)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()
                             if p.grad is not None}, dict(launch_counts)

    loss_k, grads_k, launches = loss_and_grads(True)
    loss_u, grads_u, _ = loss_and_grads(False)
    if any(launches.get(k, 0) != 10 * T for k in ("fused_swin_block", "attn_core_backward")):
        raise AssertionError(f"grads: launches {launches}, want {10 * T} of each kernel")
    if set(grads_k) != set(grads_u):
        raise AssertionError("grads: the two paths give gradients to different parameters")
    loss_rel = abs(loss_k - loss_u) / abs(loss_u)
    worst, worst_key, zero_half = 0.0, None, 0.0
    for key, gu in grads_u.items():
        gk = grads_k[key]
        rel = (gk - gu).abs().max().item() / max(gu.abs().max().item(), 1e-30)
        if key.endswith("attn.kv.bias"):
            # the key half's gradient is analytically zero (softmax is shift
            # invariant per row): an absolute bound there
            c = gu.shape[0] // 2
            zero_half = max(zero_half, gk[:c].abs().max().item(), gu[:c].abs().max().item())
        if rel > worst:
            worst, worst_key = rel, key
    if not (loss_rel <= 1e-3 and worst <= 1e-3 and zero_half <= 1e-5):
        raise AssertionError(f"grads: loss rel {loss_rel}, worst gradient rel {worst} ({worst_key}), "
                             f"key-bias gradient {zero_half}")
    set_attention_kernel(model, True)
    # lr 1e-4, the train phase's rate: at 1e-3 the first Adam step from this
    # random init overshoots (0.255 -> 0.428 on the H100) and 5 steps do not
    # bring the loss back below where it started
    optimizer, _, _, _ = build_optimizer(model.parameters(), {"type": "Adam", "args": {"lr": 1e-4}})
    losses = [train_step(model, optimizer, comp, vox, tgt)["loss"].item() for _ in range(5)]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"grads: Adam steps did not lower the loss: {losses}")
    emit({"phase": "grads", "T": T, "hw": [184, 240], "launches": launches, "loss_kernel": loss_k,
          "loss_unfused": loss_u, "loss_rel_diff": loss_rel, "worst_grad_rel_diff": worst,
          "worst_grad_key": worst_key, "kv_key_bias_grad_max_abs": zero_half,
          "leaves": len(grads_u), "adam_losses": losses})


def phase_train(torch, launch_counts, card):
    """The training path: the train CLI on the MMP sequence, its checkpoint
    scored by the eval CLI, and one profiled train step."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer, train_step
    from bde2vid_tpu_torch.train.__main__ import iterate_training_windows
    from bde2vid_tpu_torch.train.__main__ import main as train_main

    model_args = json.loads(json.dumps(FLAGSHIP_CFG))
    model_args["generator"]["drop_path_rate"] = 0.2
    model_args["use_pallas_attention"] = True
    data_cfg = {"sequence_length": TRAIN_SEQ_LEN, "num_bins": 5,
                "proba_pause_when_running": 0.05, "proba_pause_when_paused": 0.9,
                "noise_std": 0.1, "noise_fraction": 0.05,
                "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.001}
    cfg = {"name": "flagship", "model": {"type": "BDE2VID", "args": model_args},
           "losses": [{"type": "L1Loss"}],
           "optimizer": {"type": "Adam", "args": {"lr": 1e-4, "grad_clip": 1.0}},
           "data": data_cfg, "train": {"steps": TRAIN_STEPS, "ckpt_every": 1000}}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data = os.path.join(tmp, "data")
        items = write_mmp_sequence(os.path.join(data, "mmp", "SYN", "seq0"), np.random.default_rng(4))
        with open(os.path.join(tmp, "cfg.json"), "w") as fp:
            json.dump(cfg, fp)
        out_dir = os.path.join(tmp, "run")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        t0 = time.perf_counter()
        rc = train_main(["--config", os.path.join(tmp, "cfg.json"), "--data_dir", data,
                         "--out_dir", out_dir, "--loader_type", "MMP"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(out_dir, "train_log.jsonl")) as fp:
            log = [json.loads(line) for line in fp]
        want = TRAIN_STEPS * 10 * TRAIN_SEQ_LEN
        if rc != 0 or len(log) != TRAIN_STEPS or not all(math.isfinite(r["loss"]) for r in log):
            raise AssertionError(f"train CLI: rc {rc}, log {log}")
        if any(launches.get(k, 0) != want for k in ("fused_swin_block", "attn_core_backward")):
            raise AssertionError(f"train CLI: launches {launches}, want {want} of each kernel")
        ckpt = os.path.join(out_dir, f"epoch_{TRAIN_STEPS}.pth")
        if not os.path.exists(ckpt):
            raise AssertionError(f"train CLI wrote no {ckpt}")
        eval_out = os.path.join(tmp, "eval")
        rc = eval_main(["--weights_dir", out_dir, "--data_dir", data, "--datasets", "SYN",
                        "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", "8",
                        "--output_dir", eval_out])
        with open(os.path.join(eval_out, f"epoch_{TRAIN_STEPS}_L8_org.txt")) as fp:
            scored = json.load(fp)["SYN"]["seq0"]
        if rc != 0 or not all(math.isfinite(v) for v in scored.values()):
            raise AssertionError(f"eval CLI on the trained checkpoint: rc {rc}, {scored}")

        # one profiled step (warm) of the same configuration
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("BDE2VID", model_args, train=True)
        optimizer, _, clip, _ = build_optimizer(model.parameters(), cfg["optimizer"])
        comp = SequenceLossComputer(cfg["losses"])
        batch = next(iterate_training_windows(data, TRAIN_SEQ_LEN, 5, data_cfg, multiple=8,
                                              ltype="MMP"))
        drop = torch.Generator(device="cuda").manual_seed(1)

        def step():
            train_step(model, optimizer, comp, *batch, generator=drop, grad_clip=clip)["loss"].item()

        step()
        prof = device_profile(torch, step)
    emit({"phase": "train", "card": card, "steps": TRAIN_STEPS, "sequence_length": TRAIN_SEQ_LEN,
          "items": items, "crop_hw": list(batch[0].shape[-2:]), "losses": [r["loss"] for r in log],
          "ms_per_step_after_first": 1e3 * float(np.mean([r["seconds"] for r in log[1:]])),
          "ms_per_step": [1e3 * r["seconds"] for r in log],
          "data_ms_per_step_after_first": 1e3 * float(np.mean([r["data_seconds"] for r in log[1:]])),
          "cli_seconds": seconds,
          "max_memory_allocated_gib": peak_gb, "launches": launches, "eval_of_checkpoint": scored,
          "profiled_step": prof})
    return launches["attn_core_backward"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase_build()
    cases = phase_kernels(torch)
    bwd_cases = phase_kernels_training(torch)
    phase_model(torch, launch_counts)
    launches = phase_eval(torch, launch_counts, card)
    phase_grads(torch, launch_counts)
    bwd_launches = phase_train(torch, launch_counts, card)

    def per_frame(cases, key):
        # per flagship frame in f32: 2 plain + 2 dilated blocks at level 0, 3 + 3 at level 2
        vals = [c[key] for c in cases]
        if any(v is None for v in vals):
            return None
        return sum(c[key] * BLOCKS_PER_FRAME[c["level"]] / 2 for c in cases)

    def summary(name, source, line, cases, n_launches, library):
        f32 = [c for c in cases if c["dtype"] == "float32"]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": f"bde2vid_tpu/ops/window_attn_pallas.py:{line}",
            "launches": n_launches,
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": per_frame(f32, "kernel_ms"),
            "plain_ms": per_frame(f32, "plain_ms"),
            "bound_ms": per_frame(f32, "bound_ms"),
            "bound_by": "operations" if all(c["bound_by"] == "operations" for c in f32) else "bytes",
            "library_ms": per_frame(f32, "library_ms") if library else None,
        }

    emit({"kernels": [
        summary("fused_swin_block", "bde2vid_tpu_torch/ops/csrc/swin_block.cu", 654, cases,
                launches, False),
        summary("attn_core_backward", "bde2vid_tpu_torch/ops/csrc/attn_core_bwd.cu", 271,
                bwd_cases, bwd_launches, True),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
