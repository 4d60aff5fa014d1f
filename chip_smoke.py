#!/usr/bin/env python3
"""Drive the PyTorch port (bde2vid_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; a failure in any phase raises and the script
exits non-zero without a result line. Two configurations run at full
width with seeded random weights: the flagship BDE2VID (7x7 windows) and
the same model with 8x8 windows, whose even dilated blocks take the
WindowAttention3D kernel; then the E2VID family at its published widths,
SPADE-E2VID, EVSNN and PAEVSNN at their fixed widths and EITR at the
reference's.

  build    nvcc-builds every CUDA kernel from the sources in this checkout,
           one process per source, all at once, then the host event packer
           with g++
  kernels  each kernel vs its plain PyTorch twin on the card (f32 within
           1e-4 x max(1, max|twin|), bf16 within 2e-2 * max|twin|), with
           times: the Swin block at the flagship and the 8x8 plain shapes
           (plain; masked with acc) and its five launches one by one at the
           flagship's plain shapes, f32 and bf16 (profiler device ms, each
           stage's bound and yardstick: F.linear(F.layer_norm) or F.linear
           for the GEMM stages, SDPA forward for the attention stage), the attention-core backward at the
           flagship and the 8x8 shapes (torch's SDPA backward as the library
           yardstick; a bitwise repeat; each instantiation's registers,
           shared memory and resident blocks per SM), the WindowAttention3D
           body at the 8x8 dilated shapes (with and without acc), the bare
           attention core at the flagship and 8x8 shapes (SDPA forward as
           the yardstick; the registers, shared memory, resident blocks per
           SM and launch plan of its instantiations and of B1's attention
           stage), and both new Functions' gradients vs the twins' autograd;
           and the backward's long rows (the tiled backward) at long-buffer shapes (21
           frames of 7x7 windows, N 1029; 17 of 8x8, N 1088; 3 of 12x12,
           M 144, N 432), f32 and bf16, with its plan, occupancy, bound and
           a bitwise repeat
  attention  the ops.fused_window_attention entry point forward and backward
           at the 8x8 shapes (2 + 3 calls: one 8x8 frame's dilated blocks)
  model    flagship at 184x240, T=8: kernel path vs unfused path (f32,
           within 2e-4), exactly 10 kernel launches per frame; the 8x8
           config the same with 5 Swin block and 5 WindowAttention3D
           launches per frame, and an even dilated block's forward and
           backward run twice for bit equality
  parallel the flagship with parallel_attention: kernel vs unfused path
           (2e-4), 10 launches per forward, timed beside the sequential one
  eval     the eval CLI on a synthetic 180x240 MMP sequence with a flagship
           checkpoint (f32 and --bf16, cold and warm, one profiled run) and
           an 8x8 checkpoint (f32 and --bf16); result files finite, launch
           counts exact
  step_models  E2VIDRecurrent (the released E2VID: base 32, 3 encoders, BN,
           transposed-conv decoders), E2VID and FlowNet at 184x240, FireNet
           and FireNetOrg (base 16, kernel 3) at 180x240, SPADE-E2VID and
           EITR (reference widths) at 184x240, T=8: card vs CPU (images and
           final state within 2e-4), forward ms, the conv and GEMM FLOPs of
           a frame and their bound at 67 TFLOP/s, one profiled forward of
           SPADE and of EITR (device ms by kernel, idle share), bf16 drift of
           E2VIDRecurrent, FireNet, SPADE and EITR (< 0.08); the eval CLI on
           template checkpoints (E2VIDRecurrent f32 and --bf16, FireNet f32,
           EITR f32 and --bf16) at subseq_L 8 (and 0 for the first two:
           detail numbers within 1e-6, the state carries across chunks);
           SPADE through the eval driver on the sequence split at ev_rate
           0.35 (2 sub-voxels an item), subseq_L 8 vs the whole sequence
           within 1e-6; EVSNN and PAEVSNN (fixed widths 32-256) at 184x240,
           T=8, held card vs CPU to the SNN gate (the first bin's pre-spike
           drive within 2e-4, at least 99.9 % of image pixels within 2e-4,
           relative L2 of the images at most 1e-2; flipped spikes and the
           share of LIF units that fired reported), bf16 drift reported; the
           eval CLI on bare EVSNN and PAEVSNN checkpoints (subseq_L 8 and 0
           within 1e-6, robust-normalised output checked against the
           driver); rec_snn on a 180x240 text stream, 10 chunks of 0.5
           events a pixel (50 PNGs); no hand-written kernel launches on
           this path
  packing  the native event packer vs its NumPy twin, bit-equal, host ms for
           a batch of 64 windows of the synthetic sequence, and the
           pipeline's buffers pinned; the eval phase checks that the eval
           CLI packed through the native packer and copied its events from
           pinned memory (the HtoD copies of its profiled run by kind)
  grads    training mode, 184x240, T=3: the kernel path's loss and gradients
           vs the unfused path's (relative 1e-3; the key half of attn.kv.bias
           absolute 1e-5), exact launch counts, for the flagship (then 5
           Adam steps that lower the loss) and the 8x8 config
  variants the flagship width with concat skips, BN, IN and ConvGRU at
           184x240, T=3: forward kernel vs unfused path (2e-4), one train
           step's loss (1e-3) and gradients (2e-2 by relative L2 distance,
           VARIANT_GRAD_L2) on both paths
  train    the train CLI on the MMP sequence: the flagship for 6 steps
           (DropPath 0.2, pause, noise, hot pixels, Adam with gradient
           clipping; ms per step, peak memory, one profiled step's
           device-idle share), the 8x8 config for 3 steps, and the flagship
           with "train" bf16, remat and both for 6 steps each; finite
           losses, exact launch counts, checkpoints the eval CLI scores;
           then a remat train step of the flagship with 21 buffer frames and
           of the 8x8 config with 17, kernel path (B2's long rows) vs
           unfused path
  key_tiles  the key-tiled variants of the attention forward and backward
           (ROADMAP C5) vs their twins: the bare core, the Swin block's and
           the WindowAttention3D body's attention stage and the backward at
           the first N past each old key limit and at far rows (61 and 151
           frames of 7x7 windows), f32 and bf16, repeated bit for bit, with
           times, bounds, SDPA forward / backward and each tiled
           instantiation's occupancy; then the flagship at full width with
           buffer_index -15..15 (N 1519: level 2 runs both kernels
           key-tiled) at 184x240, T=3, forward kernel vs unfused path
           (2e-4) and one remat train step's loss and gradients (1e-3),
           with exact launch counts of each variant
  head_dims  every head_dim and C (ROADMAP C6-C9): the three forward
           libraries and the backward vs their twins at head_dim 3, 6, 12,
           24, 48, 64, 96, 128, 256, 384, 512 and 2048, and at C 2048 over 8
           heads (B_ 20, M 49, N 343), f32 and bf16,
           repeated bit for bit, with times per launch beside the bound and
           SDPA; the key-tiled forward at TILED_TIMING with its occupancy,
           beside SDPA; then the flagship at full width with num_heads 4
           (head_dim 16 / 64) and 2 (32 / 128), and at base 64 with one
           head (128 / 512), at 184x240, T=3: eval forward kernel vs
           unfused path (2e-4), one train step's loss and gradients
           (1e-3), exact launch counts (the key-tiled forward and the wide
           backward wherever head_dim is above 32)

Then the kernel summary line, the card's name and power limit, and
{"ok": true, "device": {...}} as the last line. TF32 is off for matmuls and
convolutions, so f32 comparisons are exact-f32 on both sides.
"""

from __future__ import annotations

import contextlib
import ctypes
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
# the flagship with 8x8 windows: its dilated blocks (1 and 3 at level 0; 1, 3
# and 5 at level 2) have even windows and take the WindowAttention3D kernel
EIGHT_CFG = json.loads(json.dumps(FLAGSHIP_CFG))
EIGHT_CFG["generator"]["window_size"] = [8, 8]
EIGHT_CFG_TEXT = FLAGSHIP_CFG_TEXT.replace("window_size=(7, 7)", "window_size=(8, 8)")
# launches per frame of each kernel on the two configurations' forward
PER_FRAME = {"flagship": {"fused_swin_block": 10},
             "8x8": {"fused_swin_block": 5, "fused_window_block": 5}}
TRAIN_STEPS, TRAIN_SEQ_LEN = 6, 8
TRAIN_STEPS_8X8 = 3
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# flagship attention levels on a 184x240 input: (padded feature map, channels);
# both give 252 / 20 windows of 7x7 for plain and dilation-2 partitions
LEVELS = {"level0": ((98, 126), 64), "level2": ((28, 35), 256)}
BLOCKS_PER_FRAME = {"level0": 4, "level2": 6}  # depths [4, 0, 6]
# the 8x8 config's levels: 92x120 pads to 96x120 (180 plain windows; the
# dilated partition pads to 104x128, 12 x 15 windows again), 23x30 to 24x32
# (12 and 12); per frame 2 + 3 blocks of each kind
LEVELS_8 = {"level0": ((96, 120), 64), "level2": ((24, 32), 256)}
BLOCKS_PER_FRAME_8 = {"level0": 2, "level2": 3}
# the config variants the variants phase runs at the flagship's width
VARIANTS = {"concat": {"skip_type": "concat"}, "BN": {"norm": "BN"}, "IN": {"norm": "IN"},
            "convgru": {"recurrent_block_type": "convgru"}}
# The variants' gradient bound, kernel path vs unfused path, by relative L2
# distance per parameter. Through BN and IN a gradient is ill-conditioned: a
# ReLU input within rounding of 0 takes either side in two forwards that
# agree to 1e-7, and the norm spreads that over its channel. On the CPU at
# flagship width (112x112, T=2) the unfused path alone moved by up to 1.5e-3
# (BN) and 4.6e-3 (IN) for inputs nudged by 1e-7 relative, and on the H100
# the BN config's two paths differed by 3.8e-3 (max |diff| over max |grad|)
# at a decoder conv. A fault of the kernel path moves a gradient by O(1).
VARIANT_GRAD_L2 = 2e-2
# buffer frames of the long-buffer runs: N = 21 x 49 = 1029 and 17 x 64 = 1088
# keys a row, above the 1024 a backward lane keeps in registers
LONG_FRAMES = {"flagship": 21, "8x8": 17}
# window_size (12, 12), a config key of the BDE2VID (M 144, past the tiled
# backward's 128 rows a block): the long-row kernel cases at T=3 (N 432),
# on the 8x8 config's level sizes
TWELVE_FRAMES = 3
# key tiles (ROADMAP C5): the key_tiles phase's flagship has buffer_index
# -15..15 (31 frames, N = 1519 keys a row), whose level 2 (head_dim 16) runs
# both attention kernels key-tiled; its kernel cases take the first N past
# each old limit of the untiled kernels and far rows of 61 and 151 frames
# of 7x7 windows, by head_dim (the block kernels in whole frames of 49
# keys), and the backward's rows as (head_dim, M, N)
KEY_TILE_FRAMES = 31
TILED_FWD_KEYS = {16: (1453, 2897, 2989), 4: (7265, 7399)}
TILED_FWD_FRAMES = {16: (30, 60, 61), 4: (149, 151)}
TILED_BWD_ROWS = ((4, 49, 7197), (16, 49, 1401), (4, 64, 7177), (16, 64, 1385), (16, 49, 2989),
                  (4, 49, 7399))
# head dims (ROADMAP C6, C7): the kernel cases' head_dims between and above
# the flagship's 4 and 16 with their heads (C at most 256 up to head_dim
# 256, one head above it), and the head_dims phase's flagship versions
# (generator overrides): num_heads 4 (head_dim 16 at level 0, 64 at level
# 2), 2 (32 and 128), and base 64 with one head (128 and 512, C7's
# configuration: about 4x the flagship's parameters)
HEAD_DIM_HEADS = {3: 16, 6: 16, 12: 16, 24: 8, 48: 4, 64: 4, 96: 2, 128: 2, 256: 1, 384: 1, 512: 1,
                  2048: 1}
# the kernel cases' (head_dim, heads) pairs: HEAD_DIM_HEADS, then C 2048
# over 8 heads (ROADMAP C9: B1's and B3's LN GEMMs stream their rows above
# C 1664 in f32, 1088 in bf16; head_dim 2048 above is C8 and C9 at once)
HEAD_DIM_CASES = tuple(HEAD_DIM_HEADS.items()) + ((256, 8),)
HEAD_DIM_MODELS = {"4 heads": {"num_heads": 4}, "2 heads": {"num_heads": 2},
                   "base 64, 1 head": {"basechannels": 64, "num_heads": 1}}
# the E2VID family at published widths: E2VIDRecurrent as the released
# E2VID (rpg_e2vid E2VID_lightweight: base 32, 3 encoders of 64/128/256, 2
# residual blocks, ConvLSTM, sum skips, transposed-conv decoders, BN), E2VID
# and FlowNet at its widths, FireNet and FireNetOrg at event_cnn_minimal's
# (base 16, kernel 3); (config, padded frame size)
E2VID_WIDTHS = {"num_bins": 5, "base_num_channels": 32, "num_encoders": 3,
                "num_residual_blocks": 2, "skip_type": "sum", "recurrent_block_type": "convlstm",
                "use_upsample_conv": False, "norm": "BN"}
FIRENET_WIDTHS = {"num_bins": 5, "base_num_channels": 16, "kernel_size": 3}
# EITR at the reference's default widths (model/eitr: channels 32/64/128/256,
# d_model 256, 8 heads, FFN 1024, no norm): 23 x 30 = 690 tokens a stream at
# 184x240. SPADE-E2VID's widths are fixed by the model.
EITR_WIDTHS = {"num_bins": 5, "channels": [32, 64, 128, 256], "d_model": 256, "nhead": 8,
               "dim_feedforward": 1024, "norm": None}
STEP_MODELS = {
    "E2VIDRecurrent": (E2VID_WIDTHS, (184, 240)),
    "E2VID": (E2VID_WIDTHS, (184, 240)),
    "FlowNet": (E2VID_WIDTHS, (184, 240)),
    "FireNet": (FIRENET_WIDTHS, (180, 240)),
    "FireNetOrg": (dict(FIRENET_WIDTHS, recurrent_blocks={"resblock": [0]}), (180, 240)),
    "SPADEE2VID": ({"num_bins": 5}, (184, 240)),
    "EITR": (EITR_WIDTHS, (184, 240)),
}
STEP_MODELS["EVSNN"] = ({"num_bins": 5}, (184, 240))
STEP_MODELS["PAEVSNN"] = ({"num_bins": 5}, (184, 240))
STEP_BF16 = ("E2VIDRecurrent", "FireNet", "SPADEE2VID", "EITR")
# The spiking models fire where a membrane reaches the threshold, and a
# membrane within float rounding of it fires on one device and not on the
# other (cuDNN and oneDNN sum in other orders); one flipped spike then moves
# its neighbourhood by O(0.1-1). So card vs CPU they are held to a gate of
# their own: the first bin's drive before any spike within 2e-4, at least
# SNN_PIXEL_SHARE of the image pixels within 2e-4, the images' relative L2
# distance at most SNN_REL_L2; the flipped spikes are counted and reported.
# At least SNN_MIN_FIRE of the LIF units must fire once, or the gate would
# hold a network that never spikes. bf16 is reported as drift only.
SNN_MODELS = ("EVSNN", "PAEVSNN")
SNN_PIXEL_SHARE, SNN_REL_L2, SNN_MIN_FIRE = 0.999, 1e-2, 0.01
SNN_LIF_CALLS = 9  # LIF firings a bin: 8 layers, the residual block's fires twice
# rec_snn's synthetic stream: 10 chunks of 180 x 240 x 0.5 events
REC_SNN_HW, REC_SNN_CHUNKS, REC_SNN_EVENTS_PER_PIXEL = (180, 240), 10, 0.5
PACK_BATCH = 64  # windows a batch of the packing phase (the eval driver's voxel_batch)
# the eval CLI's runs per template checkpoint: (run, subseq_L)
STEP_CLI_RUNS = {"E2VIDRecurrent": (("f32", 8), ("f32_whole", 0), ("bf16", 8)),
                 "FireNet": (("f32", 8), ("f32_whole", 0)),
                 "EITR": (("f32", 8), ("bf16", 8))}
STEP_T = 8
# SPADE's event-rate splitting on the synthetic sequence: 180 x 240 x 0.35 =
# 15120 events a sub-voxel, and every window holds 30240-45359 events
EV_RATE, EV_SUBVOXELS = 0.35, 2
# bf16 against f32 on the same weights: the JAX package's own drift bound for
# its bf16 switch (tests/test_models_e2vid.py::test_bf16_drift_within_tolerance)
BF16_DRIFT = 0.08


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
    the CUDA kernels and copies it ran, the idle share of that wall time,
    the ``top`` entries by device time and the host-to-device copies by
    kind ({"Pageable" or "Pinned": {"ms", "count"}}). Device fields are None
    when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev, htod = {}, {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = getattr(evt, "self_cuda_time_total", 0) if us is None else us
        if evt.device_type == DeviceType.CUDA and us > 0:
            dev[evt.key[:90]] = dev.get(evt.key[:90], 0.0) + us / 1e3
            if evt.key.startswith("Memcpy HtoD"):  # "Memcpy HtoD (Pinned -> Device)"
                kind = evt.key.split("(")[-1].split(" ")[0]
                entry = htod.setdefault(kind, {"ms": 0.0, "count": 0})
                entry["ms"] += us / 1e3
                entry["count"] += evt.count
    busy = sum(dev.values()) if dev else None
    return {
        "wall_ms": wall_ms,
        "device_ms": busy,
        "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall_ms),
        "top": sorted(dev.items(), key=lambda kv: -kv[1])[:top],
        "htod": htod,
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


# B1's launches in order: (stage, kernel name) of its five kernels
B1_STAGES = (("ln_proj", "ln_gemm_kernel"), ("attn", "attn_kernel"), ("mlp_proj", "gemm_kernel"),
             ("mlp_fc1", "ln_gemm_kernel"), ("mlp_fc2", "gemm_kernel"))


def kernel_sequence(torch, fn, calls):
    """(name, device ms) of every CUDA kernel that ``calls`` runs of ``fn``
    launch, in launch order, from one torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in evts]


def b1_stage_ms(torch, fn, calls=5, traces=8):
    """Device ms per launch of each of B1's five kernels (B1_STAGES), and
    the kernel each stage ran (its tile shows in the name). A trace that
    lost kernel records (the profiler drops some or all at times, PERF.md
    section 7) is taken again, up to ``traces`` times."""
    for _ in range(traces):
        seq = [(n, ms) for n, ms in kernel_sequence(torch, fn, calls)
               if "gemm_kernel" in n or "attn_kernel" in n]
        if len(seq) == calls * len(B1_STAGES):
            break
    else:
        raise AssertionError(f"B1 stage split: {len(seq)} kernels for {calls} calls: {seq[:8]}")
    times, names = {}, {}
    for i, (name, ms) in enumerate(seq):
        stage, kernel = B1_STAGES[i % len(B1_STAGES)]
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        if kernel not in short or (kernel == "gemm_kernel" and "ln_gemm_kernel" in short):
            raise AssertionError(f"B1 stage split: launch {i} is {name}, want {kernel}")
        times.setdefault(stage, []).append(ms)
        names[stage] = short[:100]
    return {k: float(np.mean(v)) for k, v in times.items()}, names


def b1_stage_costs(d, b, m, c, heads, hidden, elem):
    """(FLOPs, bytes) of each B1 stage, each input read and each output
    written once: (a) x (D-1 frames) and ctr, the q and k|v weights, LN
    affines and biases in, kv and q out; (b) as window_attention_cost; (c1)
    acc, ctr and Wp in, y (f32) out; (c2) y, W1, LN2 and b1 in, h out; (c3)
    h, W2, y and b2 in, the block output out."""
    rows, kv_rows = b * m, d * b * m
    return {
        "ln_proj": (2 * kv_rows * c * 2 * c + 2 * rows * c * c,
                    elem * (d * rows * c + 3 * c * c + 2 * kv_rows * c + rows * c) + 4 * 7 * c),
        "attn": window_attention_cost(b, m, d * m, c, heads, elem),
        "mlp_proj": (2 * rows * c * c, elem * (2 * rows * c + c * c) + 4 * (rows * c + c)),
        "mlp_fc1": (2 * rows * c * hidden,
                    4 * (rows * c + 2 * c + hidden) + elem * (c * hidden + rows * hidden)),
        "mlp_fc2": (2 * rows * hidden * c,
                    elem * (rows * hidden + hidden * c + rows * c) + 4 * (rows * c + c)),
    }


def b1_stage_library_ms(torch, x, ctr, p, acc, y, h, heads, q_ind):
    """Yardsticks for B1's stages, timed and never called by the port:
    F.linear(F.layer_norm(.)) for (a) (k|v and q) and (c2), torch's SDPA
    forward for (b) (the bias as a float attn_mask, on the stage's own q, k
    and v, split into heads outside the timed region), F.linear for (c1)
    and (c3), all in the operand type."""
    import torch.nn.functional as F
    from bde2vid_tpu_torch.ops.window_attn_cuda import _pre_stage

    dt = x.dtype
    c = x.shape[-1]
    w = {k: getattr(p, k).to(dt) for k in p._fields if k != "bias"}

    def ln_proj():
        F.linear(F.layer_norm(x, (c,), w["norm_kv_w"], w["norm_kv_b"]), w["kv_w"], w["kv_b"])
        F.linear(F.layer_norm(ctr, (c,), w["norm_q_w"], w["norm_q_b"]), w["q_w"], w["q_b"])

    with torch.no_grad():
        q, k, v = _pre_stage(x, ctr, p, heads, q_ind)
        return {
            "ln_proj": cuda_ms(torch, ln_proj, 20),
            "attn": sdpa_forward_ms(torch, q, k, v, p.bias, heads)[0],
            "mlp_proj": cuda_ms(torch, lambda: F.linear(acc, w["proj_w"], w["proj_b"]), 20),
            "mlp_fc1": cuda_ms(torch, lambda: F.linear(
                F.layer_norm(y, (c,), w["norm2_w"], w["norm2_b"]), w["fc1_w"], w["fc1_b"]), 20),
            "mlp_fc2": cuda_ms(torch, lambda: F.linear(h, w["fc2_w"], w["fc2_b"]), 20),
        }


def phase_build():
    from bde2vid_tpu_torch.native import evpack
    from bde2vid_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build()
    libs["evpack"] = evpack.build()  # the host event packer, with g++
    ptxas = [line.strip() for log in build.ptxas_reports.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": ptxas[:8]})


def block_params(rnd, c, heads, m, n):
    """Random Swin block weights at width c (bias (heads, m, n))."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import SwinBlockParams

    hidden = 4 * c
    return SwinBlockParams(
        1 + rnd(c, scale=0.1), rnd(c, scale=0.1), 1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
        rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), rnd(2 * c, c, scale=c**-0.5),
        rnd(2 * c, scale=0.1), rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1),
        1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(hidden, c, scale=c**-0.5),
        rnd(hidden, scale=0.1), rnd(c, hidden, scale=hidden**-0.5), rnd(c, scale=0.1),
        rnd(heads, m, n, scale=0.5),
    )


def operand_weights(p, dt):
    """The block's weight matrices in the operand type, as a model cast to
    that type holds them (the wrapper would otherwise convert them on every
    call); vectors and the bias stay f32."""
    return p._replace(**{k: getattr(p, k).to(dt) for k in ("q_w", "kv_w", "proj_w", "fc1_w", "fc2_w")})


def phase_kernels(torch):
    """The Swin block kernel vs its twin: the flagship's plain and dilated
    shapes, and the 8x8 config's plain shapes (its dilated blocks take the
    WindowAttention3D kernel, phase_kernels_window)."""
    from bde2vid_tpu_torch.nn.window_attention import window_partition, window_partition_dilated
    from bde2vid_tpu_torch.ops.window_attn_cuda import fused_swin_block, swin_block_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d, heads, q_ind = 7, 16, 3
    cases = []
    split = {}
    for config, levels, win, layouts in (("flagship", LEVELS, (7, 7), ("plain", "dilated")),
                                         ("8x8", LEVELS_8, (8, 8), ("plain",))):
        m = win[0] * win[1]
        for level, ((hp, wp), c) in levels.items():
            hidden = 4 * c
            p32 = block_params(rnd, c, heads, m, d * m)
            feats = rnd(d + 1, 1, hp, wp, c)
            for layout in layouts:
                part = window_partition if layout == "plain" else window_partition_dilated
                x32 = part(feats[:d], win).reshape(d, -1, m, c).contiguous()
                c32 = part(feats[d:], win)[0].reshape(-1, m, c).contiguous()
                b = x32.shape[1]
                for dt in (torch.float32, torch.bfloat16):
                    x, ctr = x32.to(dt), c32.to(dt)
                    p = operand_weights(p32, dt)
                    out = fused_swin_block(x, ctr, p, heads, q_ind)
                    ref = swin_block_reference(x, ctr, p, heads, q_ind)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    ref_max = ref.float().abs().max().item()
                    tol = 1e-4 * max(1.0, ref_max) if dt == torch.float32 else 2e-2 * ref_max
                    if not math.isfinite(err) or err > tol:
                        raise AssertionError(f"{config} {level} {layout} {dt}: kernel vs twin {err} > {tol}")
                    name = str(dt).split(".")[-1]
                    flops, nbytes = swin_block_cost(d, b, m, c, heads, hidden, x.element_size())
                    t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
                    cases.append({
                        "config": config, "level": level, "layout": layout, "dtype": name,
                        "windows": b, "channels": c,
                        "max_abs_err": err, "tolerance": tol, "max_abs_ref": ref_max,
                        "kernel_ms": cuda_ms(torch, lambda: fused_swin_block(x, ctr, p, heads, q_ind), 20),
                        "plain_ms": cuda_ms(torch, lambda: swin_block_reference(x, ctr, p, heads, q_ind), 5, 1),
                        "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_flops, t_bytes),
                        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                    })
                    if config == "flagship" and layout == "plain":
                        # B1's five launches one by one (profiler device time),
                        # each with its bound and its PyTorch yardstick
                        ms, kernels = b1_stage_ms(torch, lambda: fused_swin_block(x, ctr, p, heads, q_ind))
                        _, acc = fused_swin_block(x, ctr, p, heads, q_ind, with_acc=True)
                        y = rnd(b, m, c).to(dt)
                        h = rnd(b, m, hidden).to(dt)
                        lib = b1_stage_library_ms(torch, x, ctr, p, acc, y, h, heads, q_ind)
                        stages = {}
                        costs = b1_stage_costs(d, b, m, c, heads, hidden, x.element_size())
                        for stage, (s_flops, s_bytes) in costs.items():
                            sf, sb = s_flops / PEAK_FLOPS[name], s_bytes / PEAK_BYTES
                            stages[stage] = {"ms": ms[stage], "kernel": kernels[stage],
                                             "bound_ms": 1e3 * max(sf, sb),
                                             "bound_by": "operations" if sf >= sb else "bytes",
                                             "library_ms": lib[stage]}
                        split.setdefault(level, {})[name] = stages
    emit({"phase": "kernels", "kernel": "fused_swin_block", "timing": "CUDA events, inputs L2-warm",
          "cases": cases,
          "stages": split, "stages_timing": "profiler device ms per launch, mean of 5 calls; "
                    "library = F.linear(F.layer_norm(.)) or F.linear in the operand type, "
                    "SDPA forward (bias as attn_mask) for attn"})
    return [c for c in cases if c["config"] == "flagship"]


def expect_launches(what, launches, want):
    """Raise unless the kernels launched exactly ``want`` (kernel -> count)
    and no other kernel."""
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def model_config(cfg, **extra):
    cfg = json.loads(json.dumps(cfg))
    cfg["use_pallas_attention"] = True
    cfg.update(extra)
    return cfg


def timed_forward(torch, model, vox, runs=1):
    """(images, mean host ms) of ``runs`` no-grad forwards, each synchronised."""
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(vox)["image"]
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, float(np.mean(ms))


def phase_model(torch, launch_counts):
    """Both configurations at 184x240, T=8: kernel path vs unfused path and
    exact launch counts; then an even dilated block of the 8x8 config, run
    twice forward and backward, for bit equality."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import SwinTransformerBlock3D, set_attention_kernel

    T = 8
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    rows = {}
    for name, cfg in (("flagship", FLAGSHIP_CFG), ("8x8", EIGHT_CFG)):
        torch.manual_seed(0)
        model = build_model("BDE2VID", model_config(cfg))
        timed_forward(torch, model, vox)  # warm-up (cuDNN algorithm choice, index uploads)
        launch_counts.clear()
        img_kernel, kernel_ms = timed_forward(torch, model, vox)
        launches = dict(launch_counts)
        expect_launches(f"model {name}", launches, {k: n * T for k, n in PER_FRAME[name].items()})
        again, _ = timed_forward(torch, model, vox)
        set_attention_kernel(model, False)
        timed_forward(torch, model, vox)
        img_plain, plain_ms = timed_forward(torch, model, vox)
        diff = (img_kernel - img_plain).abs().max().item()
        if not (img_kernel.shape == (T, 1, 1, 184, 240) and torch.isfinite(img_kernel).all()
                and diff <= 2e-4):
            raise AssertionError(f"model {name}: kernel vs unfused path max diff {diff} (bound 2e-4)")
        rows[name] = {"launches": launches, "max_abs_diff_vs_unfused": diff,
                      "forward_ms_kernel_path": kernel_ms, "forward_ms_unfused_path": plain_ms,
                      "kernel_path_repeats_bitwise": bool(torch.equal(img_kernel, again))}
        del model

    # an even dilated block at the 8x8 config's level-0 shape, forward and
    # backward twice: the dilated fold and partition sum their colliding
    # taps in a fixed order, B3 and B2 use no atomics
    torch.manual_seed(1)
    blk = SwinTransformerBlock3D(64, 16, (7, 8, 8), dilate_win=True, use_kernel=True).cuda()
    x = torch.randn(7, 1, 92, 120, 64, device="cuda")
    g = torch.randn(1, 92, 120, 64, device="cuda")
    runs = []
    for _ in range(2):
        blk.zero_grad(set_to_none=True)
        xl = x.clone().requires_grad_()
        launch_counts.clear()
        out = blk(xl)
        out.backward(g)
        torch.cuda.synchronize()
        expect_launches("even dilated block", launch_counts,
                        {"fused_window_block": 1, "attn_core_backward": 1})
        runs.append({"out": out.detach(), "x.grad": xl.grad,
                     **{k: p.grad for k, p in blk.named_parameters()}})
    same = {k: bool(torch.equal(runs[0][k], runs[1][k])) for k in runs[0]}
    if not (same["out"] and same["x.grad"]):
        raise AssertionError(f"even dilated block: two runs differ: {same}")
    emit({"phase": "model", "T": T, "hw": [184, 240], "configs": rows,
          "even_dilated_block_bitwise_repeat": same})


def phase_parallel(torch, launch_counts):
    """The flagship with parallel_attention (all T frames through the blocks
    as one batch): kernel vs unfused path, 10 launches per forward (one slab
    of up to 128 frames), timed beside the sequential forward on the same
    weights."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel

    T = 8
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    torch.manual_seed(0)
    par = build_model("BDE2VID", model_config(FLAGSHIP_CFG, parallel_attention=True))
    seq = build_model("BDE2VID", model_config(FLAGSHIP_CFG))
    seq.load_state_dict(par.state_dict())
    timed_forward(torch, par, vox)
    launch_counts.clear()
    img_par, _ = timed_forward(torch, par, vox)
    launches = dict(launch_counts)
    expect_launches("parallel", launches, {"fused_swin_block": 10})
    timed_forward(torch, seq, vox)
    # in turns: parallel, sequential, sequential, parallel
    ms = {"parallel": [], "sequential": []}
    for which in ("parallel", "sequential", "sequential", "parallel"):
        ms[which].append(timed_forward(torch, par if which == "parallel" else seq, vox)[1])
    set_attention_kernel(par, False)
    timed_forward(torch, par, vox)
    img_plain, plain_ms = timed_forward(torch, par, vox)
    diff = (img_par - img_plain).abs().max().item()
    if not (torch.isfinite(img_par).all() and diff <= 2e-4):
        raise AssertionError(f"parallel: kernel vs unfused path max diff {diff} (bound 2e-4)")
    emit({"phase": "parallel", "T": T, "hw": [184, 240], "launches": launches,
          "max_abs_diff_vs_unfused": diff, "forward_ms_parallel": ms["parallel"],
          "forward_ms_sequential": ms["sequential"], "forward_ms_parallel_unfused": plain_ms})


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
    """The eval CLI on one synthetic sequence: a flagship checkpoint (f32 and
    --bf16, cold and warm, and one profiled f32 run) and an 8x8 checkpoint
    (f32 and --bf16). Every run packs its events through the native packer,
    one batch a subseq_L chunk; the profiled run copies them from pinned
    memory (its HtoD copies by kind). Returns the launches of the f32 runs
    (the main path)."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.native import pack_counts

    rows = {}
    main_path_launches = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        rng = np.random.default_rng(1)
        items = write_mmp_sequence(os.path.join(tmp, "data", "mmp", "SYN", "seq0"), rng)
        plan = (("flagship", FLAGSHIP_CFG, FLAGSHIP_CFG_TEXT,
                 ("f32", "f32_warm", "bf16", "bf16_warm", "f32_profiled")),
                ("8x8", EIGHT_CFG, EIGHT_CFG_TEXT, ("f32", "bf16")))
        for name, cfg, cfg_text, runs in plan:
            torch.manual_seed(1)
            model = build_model("BDE2VID", cfg)
            weights = os.path.join(tmp, "weights_" + name)
            os.makedirs(weights)
            torch.save({"meta": {"cfg": cfg_text},
                        "state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
                       os.path.join(weights, "epoch_1.pth"))
            del model
            for run in runs:
                out_dir = os.path.join(tmp, f"out_{name}_{run}")
                args = ["--weights_dir", weights,
                        "--data_dir", os.path.join(tmp, "data"), "--datasets", "SYN",
                        "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", "8",
                        "--output_dir", out_dir]
                if run.startswith("bf16"):
                    args.append("--bf16")
                batches = -(-items // 8)  # one voxel batch a subseq_L chunk
                if run == "f32_profiled":
                    # a separate traced run: where the device time goes, its
                    # idle share, and the events' copies from pinned memory
                    prof = device_profile(torch, lambda: eval_main(args))
                    pinned = prof["htod"].get("Pinned", {}).get("count", 0)
                    if pinned < 5 * batches:
                        raise AssertionError(f"eval CLI ({name} {run}): {pinned} pinned HtoD "
                                             f"copies, want >= {5 * batches}: {prof['htod']}")
                    continue
                torch.cuda.synchronize()
                launch_counts.clear()
                packs = dict(pack_counts)
                t0 = time.perf_counter()
                rc = eval_main(args)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = dict(launch_counts)
                packs = {k: pack_counts[k] - packs[k] for k in packs}
                if rc != 0:
                    raise AssertionError(f"eval CLI ({name} {run}) returned {rc}")
                if packs != {"native": batches, "numpy": 0}:
                    raise AssertionError(f"eval CLI ({name} {run}) packed {packs}, want "
                                         f"{batches} native batches")
                if run == "f32":
                    main_path_launches[name] = launches
                base = os.path.join(out_dir, "epoch_1_L8_org")
                with open(base + ".txt") as fp:
                    result = json.load(fp)["SYN"]["seq0"]
                with open(base + "_detail.txt") as fp:
                    detail = json.load(fp)["SYN"]["seq0"]
                if not (os.path.exists(base + "_table.txt") and set(result) == {"mse", "ssim"}
                        and all(math.isfinite(v) for v in result.values())
                        and all(len(detail[k]) == items for k in result)):
                    raise AssertionError(f"eval CLI ({name} {run}) wrote bad results: {result}")
                expect_launches(f"eval CLI ({name} {run})", launches,
                                {k: n * items for k, n in PER_FRAME[name].items()})
                rows[f"{name}_{run}"] = {"seconds": seconds, "frames_per_s": items / seconds,
                                         "launches": launches, **result}
    emit({"phase": "eval", "items": items, "hw": [180, 240], "subseq_L": 8, "card": card,
          "runs": rows, "flagship_f32_profile": prof})
    return main_path_launches


def seeded_step_model(torch, name, cfg, seed):
    """A step model on the CPU with seeded weights and BN running statistics
    (means around 0, variances in [0.5, 1.5])."""
    from bde2vid_tpu_torch.models import build_model

    torch.manual_seed(seed)
    model = build_model(name, cfg, device="cpu")
    with torch.no_grad():
        for key, buf in model.named_buffers():
            if key.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
            elif key.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
    return model


def state_tensors(state):
    """The floating tensors of a step model's state, in order (tuples of
    LSTM states; SPADE's dict adds its f32 ``pred``)."""
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in state_tensors(state[k])]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in state_tensors(s)]
    return [state] if state.is_floating_point() else []


def step_flops(torch, model, vox, h, w):
    """Conv and GEMM FLOPs of one step of ``model`` (torch's FLOP counter:
    2 per multiply-add of convolutions and matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    from bde2vid_tpu_torch.models import run_sequence

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        run_sequence(model, vox[:1], model.initial_state(1, h, w))
    return counter.get_total_flops()


def spade_event_rate(torch, seq_path, model):
    """SPADE through the eval driver on the synthetic sequence split at
    ``EV_RATE``: ``EV_SUBVOXELS`` sub-voxels an item, subseq_L 8 against the
    whole sequence in one dispatch within 1e-6, finite numbers."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_sequence
    from bde2vid_tpu_torch.models import ModelSpec

    seq = load_sequence(seq_path, ltype="MMP", ev_rate=EV_RATE, normalize=True)
    per_item = np.diff(np.concatenate([[-1], seq.item_last]))
    if not (per_item == EV_SUBVOXELS).all():
        raise AssertionError(f"SPADE ev_rate: sub-voxels per item {per_item.tolist()}")
    spec = ModelSpec("SPADEE2VID", model, num_encoders=3, normalize=True)
    row, detail = {"items": len(seq), "sub_voxels": len(seq.windows),
                   "ev_rate": EV_RATE}, {}
    for run, subseq in (("subseq_L8", 8), ("whole", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, detail[run] = evaluate_sequence(spec, seq, EvalConfig(subseq_L=subseq, normalize=True))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not (all(math.isfinite(v) for v in result.values())
                and all(len(v) == len(seq) and all(map(math.isfinite, v))
                        for v in detail[run].values())):
            raise AssertionError(f"SPADE ev_rate ({run}): bad results {result}")
        row[run] = {"seconds": seconds, "frames_per_s": len(seq) / seconds, **result}
    diff = max(abs(a - b) for k in detail["whole"]
               for a, b in zip(detail["whole"][k], detail["subseq_L8"][k]))
    if diff > 1e-6:
        raise AssertionError(f"SPADE ev_rate: subseq_L 8 vs whole differ by {diff}")
    row["max_abs_diff_vs_whole"] = diff
    seq.reader.close()
    return row


def seeded_snn(torch, name, seed):
    """A spiking model on the CPU with seeded weights that make its LIF units
    fire: convolution and linear weights normal with variance 1 / fan-in,
    norm scales around 1 and biases around 0, running means around 0 and
    variances in [0.5, 1.5]. (torch's default initialisation leaves a
    membrane of tau 2 below its threshold of 1 almost everywhere.)"""
    from bde2vid_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(name, {"num_bins": 5}, device="cpu")
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            noise = torch.randn(t.shape, generator=gen)
            if t.ndim > 1:
                t.copy_(noise / math.sqrt(t[0].numel()))
            elif key.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            else:
                t.copy_((1.0 if key.endswith(".weight") else 0.0) + 0.1 * noise)
    return model


@contextlib.contextmanager
def record_spikes(evsnn):
    """The spikes of every LIF firing of ``evsnn``'s models inside the block,
    in call order, as bool tensors on their device."""
    real, spikes = evsnn.lif_step, []

    def recording(v, x, *args):
        spike, v_new = real(v, x, *args)
        spikes.append(spike > 0)
        return spike, v_new

    evsnn.lif_step = recording
    try:
        yield spikes
    finally:
        evsnn.lif_step = real


def step_card_vs_cpu(torch, name, card_model, model, vox, vox_d, h, w):
    """A step model's T frames on the card and on the CPU: images and final
    state within 2e-4. Returns (the card's images, row fields)."""
    from bde2vid_tpu_torch.models import run_sequence

    with torch.no_grad():
        got, got_state = run_sequence(card_model, vox_d, card_model.initial_state(1, h, w))
        want, want_state = run_sequence(model, vox, model.initial_state(1, h, w))
    img_diff = (got.cpu() - want).abs().max().item()
    got_st, want_st = state_tensors(got_state), state_tensors(want_state)
    if len(got_st) != len(want_st):
        raise AssertionError(f"step model {name}: state of {len(got_st)} tensors, want {len(want_st)}")
    state_diff = max([(a.cpu() - b).abs().max().item() for a, b in zip(got_st, want_st)],
                     default=0.0)
    if not (got.device.type == "cuda" and want.device.type == "cpu"
            and got.shape == (STEP_T, 1, 1, h, w) and torch.isfinite(got).all()
            and img_diff <= 2e-4 and state_diff <= 2e-4):
        raise AssertionError(f"step model {name}: card vs CPU images {img_diff}, "
                             f"state {state_diff}, shape {tuple(got.shape)}")
    return got, {"image_mean": want.mean().item(), "image_std": want.std().item(),
                 "max_abs_diff_images": img_diff, "max_abs_diff_state": state_diff}


def snn_card_vs_cpu(torch, name, card_model, model, vox, vox_d, h, w):
    """A spiking model's T frames on the card and on the CPU, held to the SNN
    gate (``SNN_PIXEL_SHARE``): the first bin's pre-spike drive, the share of
    close pixels, the images' relative L2; with the flipped spikes and the
    share of LIF units that fired at least once. Returns (the card's
    images, row fields)."""
    from bde2vid_tpu_torch.models import evsnn, run_sequence
    from bde2vid_tpu_torch.utils.norm import legacy_norm

    with torch.no_grad():
        drives = [m.static_conv(legacy_norm(x[0], unbiased=True, batched=True)[:, :1])
                  for m, x in ((card_model, vox_d), (model, vox))]
    drive_diff = (drives[0].cpu() - drives[1]).abs().max().item()
    runs = {}
    for key, m, x in (("card", card_model, vox_d), ("cpu", model, vox)):
        with record_spikes(evsnn) as spikes, torch.no_grad():
            images, _ = run_sequence(m, x, m.initial_state(1, h, w))
        runs[key] = (images, spikes)
    (got, card_spikes), (want, cpu_spikes) = runs["card"], runs["cpu"]
    if len(card_spikes) != len(cpu_spikes) or len(cpu_spikes) != STEP_T * 5 * SNN_LIF_CALLS:
        raise AssertionError(f"{name}: {len(card_spikes)} / {len(cpu_spikes)} LIF firings")
    flips = sum(int((a.cpu() != b).sum()) for a, b in zip(card_spikes, cpu_spikes))
    fired = [torch.zeros_like(cpu_spikes[k]) for k in range(SNN_LIF_CALLS)]
    for k, spike in enumerate(cpu_spikes):
        fired[k % SNN_LIF_CALLS] |= spike
    fire_share = sum(int(f.sum()) for f in fired) / sum(f.numel() for f in fired)
    spike_rate = sum(int(sp.sum()) for sp in cpu_spikes) / sum(sp.numel() for sp in cpu_spikes)
    diff = (got.cpu() - want).abs()
    close_share = (diff <= 2e-4).double().mean().item()
    rel_l2 = (diff.norm() / want.norm()).item()
    row = {"image_mean": want.mean().item(), "image_std": want.std().item(),
           "max_abs_diff_first_drive": drive_diff, "share_of_pixels_within_2e-4": close_share,
           "relative_l2_images": rel_l2, "max_abs_diff_images": diff.max().item(),
           "flipped_spikes": flips, "spikes": sum(int(sp.sum()) for sp in cpu_spikes),
           "lif_fired_share": fire_share, "lif_spike_rate": spike_rate}
    if not (got.device.type == "cuda" and got.shape == (STEP_T, 1, 1, h, w)
            and torch.isfinite(got).all() and drive_diff <= 2e-4
            and close_share >= SNN_PIXEL_SHARE and rel_l2 <= SNN_REL_L2
            and fire_share >= SNN_MIN_FIRE):
        raise AssertionError(f"{name}: SNN gate failed {row}, shape {tuple(got.shape)}")
    return got, row


def run_eval_cli(torch, launch_counts, weights, data, out_dir, subseq, stem, items, extra=()):
    """One eval CLI run (with ``extra`` arguments) over the MMP tree on the
    checkpoints in ``weights``: (seconds, result, detail, launches) of
    checkpoint ``stem``, whose result must be finite with one detail entry
    an item."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main

    args = ["--weights_dir", weights, "--data_dir", data, "--datasets", "SYN",
            "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", str(subseq),
            "--output_dir", out_dir, *extra]
    torch.cuda.synchronize()
    launch_counts.clear()
    t0 = time.perf_counter()
    rc = eval_main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts.items() if v}
    base = os.path.join(out_dir, f"{stem}_L8_org" if subseq else f"{stem}_org")
    if rc != 0:
        raise AssertionError(f"eval CLI ({out_dir}) returned {rc}")
    with open(base + ".txt") as fp:
        result = json.load(fp)["SYN"]["seq0"]
    with open(base + "_detail.txt") as fp:
        detail = json.load(fp)["SYN"]["seq0"]
    if not (os.path.exists(base + "_table.txt") and set(result) == {"mse", "ssim"}
            and all(math.isfinite(v) for v in result.values())
            and all(len(detail[k]) == items and all(map(math.isfinite, detail[k]))
                    for k in result)):
        raise AssertionError(f"eval CLI ({out_dir}) wrote bad results: {result}")
    return seconds, result, detail, launches


def max_detail_diff(a, b):
    return max(abs(x - y) for k in a for x, y in zip(a[k], b[k]))


def snn_eval_cli(torch, launch_counts, tmp, models, items):
    """The eval CLI on a bare ``<family>_seeded.pth`` of each SNN, subseq_L 8
    and 0 (within 1e-6); its detail numbers are those of the eval driver
    with the output robust-normalised (1e-6), and not those without."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_sequence

    rows, data = {}, os.path.join(tmp, "data")
    for name in SNN_MODELS:
        weights = os.path.join(tmp, "weights_" + name)
        os.makedirs(weights)
        ckpt = os.path.join(weights, f"{name}_seeded.pth")
        torch.save(models[name].state_dict(), ckpt)
        details = {}
        for run, subseq in (("f32", 8), ("f32_whole", 0)):
            seconds, result, details[run], launches = run_eval_cli(
                torch, launch_counts, weights, data, os.path.join(tmp, f"out_{name}_{run}"), subseq,
                f"{name}_seeded", items)
            if launches:
                raise AssertionError(f"eval CLI ({name} {run}) launched kernels: {launches}")
            rows[f"{name}_{run}"] = {"seconds": seconds, "frames_per_s": items / seconds,
                                     "subseq_L": subseq, **result}
        rows[f"{name}_f32"]["max_abs_diff_vs_whole"] = max_detail_diff(details["f32_whole"],
                                                                      details["f32"])
        spec = load_model_from_torch(ckpt)
        seq = load_sequence(os.path.join(data, "mmp", "SYN", "seq0"), ltype="MMP")
        try:
            by_norm = {on: evaluate_sequence(spec, seq, EvalConfig(subseq_L=8, robust_norm_output=on))[1]
                       for on in (True, False)}
        finally:
            seq.reader.close()
        robust = {"vs_driver_robust_norm": max_detail_diff(by_norm[True], details["f32"]),
                  "vs_driver_raw_output": max_detail_diff(by_norm[False], details["f32"])}
        rows[f"{name}_f32"].update(robust)
        if not (rows[f"{name}_f32"]["max_abs_diff_vs_whole"] <= 1e-6
                and robust["vs_driver_robust_norm"] <= 1e-6 and robust["vs_driver_raw_output"] > 1e-4):
            raise AssertionError(f"eval CLI ({name}): {rows[f'{name}_f32']}")
    return rows


def rec_snn_run(torch, launch_counts, tmp, model):
    """rec_snn over a synthetic text stream (a 10-line header, epoch-scale
    timestamps) of ``REC_SNN_CHUNKS`` chunks at ``REC_SNN_HW``: one PNG a
    bin, none uniform, no kernel launch."""
    from bde2vid_tpu_torch.eval.rec_snn import main as rec_snn

    h, w = REC_SNN_HW
    n = REC_SNN_CHUNKS * int(h * w * REC_SNN_EVENTS_PER_PIXEL)
    rng = np.random.default_rng(3)
    events = np.stack([1.6e9 + np.sort(rng.uniform(0, 2.0, n)), rng.integers(0, w, n),
                       rng.integers(0, h, n), rng.integers(0, 2, n)], axis=1)
    stream = os.path.join(tmp, "events.txt")
    np.savetxt(stream, events, fmt=["%.9f", "%d", "%d", "%d"],
               header="\n".join(f"header line {i}" for i in range(10)))
    ckpt = os.path.join(tmp, "rec_EVSNN.pth")
    torch.save(model.state_dict(), ckpt)
    out = os.path.join(tmp, "rec_out")
    torch.cuda.synchronize()
    launch_counts.clear()
    t0 = time.perf_counter()
    rc = rec_snn(["-network", "EVSNN", "-path_to_pretrain_models", ckpt,
                  "-path_to_event_files", stream, "-save_path", out, "-height", str(h),
                  "-width", str(w), "-num_events_per_pixel", str(REC_SNN_EVENTS_PER_PIXEL)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts.items() if v}
    pngs = sorted(os.listdir(os.path.join(out, "EVSNN")))
    want = [f"result-idx{i:04d}{j:04d}.png" for i in range(REC_SNN_CHUNKS) for j in range(5)]
    sizes = {os.path.getsize(os.path.join(out, "EVSNN", p)) for p in pngs}
    if rc != 0 or pngs != want or launches or len(sizes) < 2:
        raise AssertionError(f"rec_snn: rc {rc}, {len(pngs)} PNGs, launches {launches}")
    return {"hw": [h, w], "chunks": REC_SNN_CHUNKS, "events": n, "pngs": len(pngs),
            "seconds": seconds}


def phase_step_models(torch, launch_counts, card):
    """The step models: each over T=8 frames on the card and on the CPU
    (images and final state within 2e-4, the SNNs within their own gate;
    forward ms and the bound of a frame's FLOPs on the card; bf16 against
    f32 for the ``STEP_BF16`` models within the JAX package's drift bound,
    and for the SNNs reported), then the eval CLI on the synthetic MMP
    sequence with template checkpoints (``STEP_CLI_RUNS``; subseq_L 8 and 0
    within 1e-6 where both run) and bare SNN checkpoints, SPADE through the
    eval driver on the sequence split by event rate, and rec_snn. No
    hand-written kernel may launch on this path."""
    import copy

    from bde2vid_tpu_torch.models import run_sequence

    rows, models = {}, {}
    launch_counts.clear()
    for i, (name, (cfg, (h, w))) in enumerate(STEP_MODELS.items()):
        snn = name in SNN_MODELS
        model = (seeded_snn(torch, name, seed=20 + i) if snn
                 else seeded_step_model(torch, name, cfg, seed=20 + i))
        models[name] = model
        vox = torch.from_numpy(np.random.default_rng(30 + i).normal(
            size=(STEP_T, 1, 5, h, w)).astype(np.float32))
        card_model = copy.deepcopy(model).cuda()
        vox_d = vox.cuda()

        def forward(m=card_model, x=vox_d):
            with torch.no_grad():
                return run_sequence(m, x, m.initial_state(1, h, w))

        got, gate = (snn_card_vs_cpu if snn else step_card_vs_cpu)(
            torch, name, card_model, model, vox, vox_d, h, w)
        fwd_ms = cuda_ms(torch, forward, iters=3, warmup=1)
        flops = step_flops(torch, card_model, vox_d, h, w)
        row = {"hw": [h, w], "T": STEP_T, "params": sum(p.numel() for p in model.parameters()),
               "forward_ms": fwd_ms, "ms_per_frame": fwd_ms / STEP_T,
               "gflop_per_frame": flops / 1e9,
               "bound_ms_per_frame": 1e3 * flops / PEAK_FLOPS["float32"], **gate}
        if name in STEP_BF16 or snn:
            bf16, vox_b = copy.deepcopy(card_model).to(torch.bfloat16), vox_d.to(torch.bfloat16)
            low, _ = forward(bf16, vox_b)
            drift = (low.float() - got).abs().max().item()
            if not snn and not drift < BF16_DRIFT:
                raise AssertionError(f"step model {name}: bf16 drift {drift} >= {BF16_DRIFT}")
            row["bf16_max_abs_drift"] = drift
            row["forward_ms_bf16"] = cuda_ms(torch, lambda: forward(bf16, vox_b), iters=3, warmup=1)
        if name in ("SPADEE2VID", "EITR") or snn:  # where a new family's forward time goes
            row["profile"] = device_profile(torch, forward, top=8)
        rows[name] = row
        del card_model
    torch.cuda.synchronize()
    forward_launches = {k: v for k, v in launch_counts.items() if v}

    cli = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        items = write_mmp_sequence(os.path.join(tmp, "data", "mmp", "SYN", "seq0"),
                                   np.random.default_rng(2))
        for name, runs in STEP_CLI_RUNS.items():
            weights = os.path.join(tmp, "weights_" + name)
            os.makedirs(weights)
            kwargs = "eitr_kwargs" if name == "EITR" else "unet_kwargs"
            torch.save({"arch": name, "config": {"arch": {"args": {kwargs: STEP_MODELS[name][0]}}},
                        "state_dict": models[name].state_dict()}, os.path.join(weights, "model.pth"))
            details = {}
            for run, subseq in runs:
                out_dir = os.path.join(tmp, f"out_{name}_{run}")
                seconds, result, details[run], launches = run_eval_cli(
                    torch, launch_counts, weights, os.path.join(tmp, "data"), out_dir, subseq,
                    "model", items, ["--bf16"] if run == "bf16" else [])
                if launches:
                    raise AssertionError(f"eval CLI ({name} {run}) launched kernels: {launches}")
                cli[f"{name}_{run}"] = {"seconds": seconds, "frames_per_s": items / seconds,
                                        "subseq_L": subseq, **result}
            if "f32_whole" not in details:
                continue
            diff = max_detail_diff(details["f32_whole"], details["f32"])
            if diff > 1e-6:
                raise AssertionError(f"eval CLI ({name}): subseq_L 8 vs 0 differ by {diff}")
            cli[f"{name}_f32"]["max_abs_diff_vs_whole"] = diff
        cli.update(snn_eval_cli(torch, launch_counts, tmp, models, items))
        launch_counts.clear()
        spade = spade_event_rate(torch, os.path.join(tmp, "data", "mmp", "SYN", "seq0"),
                                 copy.deepcopy(models["SPADEE2VID"]).cuda())
        spade_launches = {k: v for k, v in launch_counts.items() if v}
        rec = rec_snn_run(torch, launch_counts, tmp, models["EVSNN"])
    if forward_launches or spade_launches:
        raise AssertionError(f"step models launched kernels: {forward_launches} {spade_launches}")
    emit({"phase": "step_models", "card": card, "models": rows, "eval": cli, "items": items,
          "hw": [180, 240], "spade_event_rate": spade, "rec_snn": rec,
          "launches": forward_launches})


def phase_packing(torch, card):
    """The native packer against its NumPy twin on ``PACK_BATCH`` windows of
    the synthetic sequence's stream (bit-equal; host ms, the median of 5
    calls each), and the sequence's packed buffers pinned for the card."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.native import pack_windows

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "seq0")
        write_mmp_sequence(path, np.random.default_rng(4))
        seq = load_sequence(path, ltype="MMP")
        n = int(seq.windows[-1, 1])
        edges = np.linspace(0, n, PACK_BATCH + 1).astype(np.int64)
        windows = np.stack([edges[:-1], edges[1:]], axis=1)
        capacity = int((windows[:, 1] - windows[:, 0]).max())
        stream = seq.reader.raw_events(0, n)
        row = {"windows": PACK_BATCH, "events": n, "capacity": capacity}
        packed = {}
        for packer in ("native", "numpy"):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                packed[packer] = pack_windows(*stream, windows, capacity, packer=packer)
                times.append(1e3 * (time.perf_counter() - t0))
            row[f"{packer}_host_ms"] = float(np.median(times))
        if not all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(packed["native"], packed["numpy"])):
            raise AssertionError("packing: the native packer and its NumPy twin differ")
        bufs = seq._pack(0, len(seq.windows), pin=True)
        if not all(b.is_pinned() for b in bufs):
            raise AssertionError("packing: the pipeline's buffers are not pinned")
        t0 = time.perf_counter()
        vox = seq.voxels(device="cuda")
        torch.cuda.synchronize()
        row["sequence_voxels_ms"] = 1e3 * (time.perf_counter() - t0)
        row["sequence_windows"] = len(seq.windows)
        if not (vox.is_cuda and torch.isfinite(vox).all()):
            raise AssertionError("packing: bad voxels")
        seq.reader.close()
    emit({"phase": "packing", "card": card, **row})


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
    attention-core backward, each vs its twin at the flagship shapes; the
    backward also at the 8x8 config's shapes, with its occupancy. Returns
    the flagship's backward cases."""
    from bde2vid_tpu_torch.nn.window_attention import window_partition, window_partition_dilated
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        _pre_stage, fused_swin_block, swin_block_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d, heads, q_ind, win = 7, 16, 3, (7, 7)
    m = win[0] * win[1]
    block_cases, bwd_cases = [], []
    for level, ((hp, wp), c) in LEVELS.items():
        hidden = 4 * c
        p = block_params(rnd, c, heads, m, d * m)
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
                err_out, err_acc = check_close(f"block {level} {layout} {name} masked+acc", got, ref, dt)
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
                bwd_cases.append(bwd_case(torch, q, k, v, p.bias, g, heads, config="flagship",
                                          level=level, layout=layout))
    bwd_cases += bwd_random_cases(torch, rnd)
    emit({"phase": "kernels", "kernel": "fused_swin_block, masked with acc",
          "timing": "CUDA events, inputs L2-warm", "cases": block_cases})
    emit({"phase": "kernels", "kernel": "attn_core_backward",
          "timing": "CUDA events, inputs L2-warm; library = torch SDPA backward alone",
          "cases": bwd_cases})
    emit({"phase": "kernels", "kernel": "attn_core_backward occupancy",
          "instantiations": bwd_occupancy(torch, heads)})
    return [c for c in bwd_cases if c["config"] == "flagship"]


def bwd_case(torch, q, k, v, bias, g, heads, **labels):
    """One attn_core_backward case: the kernel vs its twin (gate and bitwise
    repeat), its time (back to back, and device ms behind a spin kernel),
    the twin's, torch's SDPA backward and the bound."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        attn_core_backward, attn_core_backward_reference)

    name = str(q.dtype).split(".")[-1]
    b, m, c = q.shape
    n = k.shape[1]
    what = f"attn_core_backward {' '.join(labels.values())} {name}"
    got = attn_core_backward(q, k, v, bias, g, heads)
    again = attn_core_backward(q, k, v, bias, g, heads)
    ref = attn_core_backward_reference(q, k, v, bias, g, heads)
    torch.cuda.synchronize()
    errs = check_close(what, got, ref, q.dtype)
    if not all(torch.equal(a, r) for a, r in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ")
    flops, nbytes = attn_bwd_cost(b, m, n, c, heads, q.element_size())
    t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
    lib_ms, backend = sdpa_backward_ms(torch, q, k, v, bias, g, heads)
    return {
        **labels, "dtype": name, "windows": b, "queries": m, "keys": n, "channels": c,
        "max_abs_err": max(errs), "errs_dq_dk_dv_dbias": errs, "deterministic": True,
        "kernel_ms": cuda_ms(torch, lambda: attn_core_backward(q, k, v, bias, g, heads), 20),
        "kernel_device_ms": device_ms(torch, lambda: attn_core_backward(q, k, v, bias, g, heads)),
        "plain_ms": cuda_ms(torch, lambda: attn_core_backward_reference(q, k, v, bias, g, heads), 5, 1),
        "library_ms": lib_ms, "library": backend,
        "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_flops, t_bytes),
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
    }


def bwd_random_cases(torch, rnd, heads=16):
    """attn_core_backward cases on random q, k, v, cotangent and bias at the
    8x8 configuration's levels (M 64, N 448; a level's plain and dilated
    partitions have the same windows), f32 and bf16."""
    win, cases = 8, []
    m, n = win * win, 7 * win * win
    for level, ((hp, wp), c) in LEVELS_8.items():
        b = (hp // win) * (wp // win)
        q32, k32, v32, g32 = rnd(b, m, c), rnd(b, n, c), rnd(b, n, c), rnd(b, m, c)
        bias = rnd(heads, m, n, scale=0.5)
        for dt in (torch.float32, torch.bfloat16):
            cases.append(bwd_case(torch, *(t.to(dt) for t in (q32, k32, v32)), bias, g32.to(dt),
                                  heads, config="8x8", level=level, layout="plain"))
    return cases


def bwd_occupancy(torch, heads):
    """Registers, spill bytes, shared memory per block and resident blocks
    per SM of each attn_core_backward instantiation the four level shapes
    take on card 0, with its row share J, pass-2 lanes per key S and the
    card's SMs."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import attn_core_backward_occupancy

    rows = []
    for config, m, n, levels in (("flagship", 49, 343, LEVELS), ("8x8", 64, 448, LEVELS_8)):
        for level, (_, c) in levels.items():
            for dt in (torch.float32, torch.bfloat16):
                rows.append({"config": config, "level": level, "dtype": str(dt).split(".")[-1],
                             **attn_core_backward_occupancy(m, n, c, heads, dt, 0)})
    return rows


def fwd_core_case(torch, q, k, v, bias, heads, **labels):
    """One fused_window_attention case: the kernel vs its twin (gate), the
    launch counter of the kernel its plan picks, its time (CUDA events over
    calls, and device_ms), the twin's, torch's SDPA forward and the bound."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        attn_plan_for, fused_window_attention, launch_counts, window_attention_reference)

    name = str(q.dtype).split(".")[-1]
    b, m, c = q.shape
    n = k.shape[1]
    plan = attn_plan_for("window_attention", b, m, n, c, heads, q.dtype, 0)
    counter = "fused_window_attention" + ("_key_tiles" if plan.key_tiled else "")
    before = launch_counts[counter]
    with torch.no_grad():
        got = fused_window_attention(q, k, v, bias, heads)
        ref = window_attention_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    if launch_counts[counter] != before + 1:
        raise AssertionError(f"window attention {labels} {name}: {counter} did not count the launch")
    (err,) = check_close(f"window attention {' '.join(map(str, labels.values()))} {name}",
                         (got,), (ref,), q.dtype)
    flops, nbytes = window_attention_cost(b, m, n, c, heads, q.element_size())
    t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
    lib_ms, backend, lib_dev = sdpa_forward_ms(torch, q, k, v, bias, heads)
    call = lambda: fused_window_attention(q, k, v, bias, heads)
    with torch.no_grad():
        return {
            **labels, "dtype": name, "windows": b, "queries": m, "keys": n, "channels": c,
            "plan": plan._asdict(), "max_abs_err": err,
            "kernel_ms": cuda_ms(torch, call, 20), "kernel_device_ms": device_ms(torch, call),
            "plain_ms": cuda_ms(torch, lambda: window_attention_reference(q, k, v, bias, heads), 5, 1),
            "library_ms": lib_ms, "library": backend, "library_device_ms": lib_dev,
            "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        }


def key_tiled_block_cases(torch, rnd, heads=16, m=49, b=4):
    """The Swin block's and the WindowAttention3D body's attention stage
    (the k|v scratch layout) above the old key limits (TILED_FWD_FRAMES),
    f32 and bf16, with acc: each vs its twin, repeated bit for bit, the
    tiled launch counted, the block's time beside the twin's."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        WindowBlockParams, attn_key_tiled, fused_swin_block, fused_window_block, launch_counts,
        swin_block_reference, window_block_reference)

    cases = []
    for hd, frame_counts in TILED_FWD_FRAMES.items():
        c = heads * hd
        for frames in frame_counts:
            p32 = block_params(rnd, c, heads, m, frames * m)
            x32, c32, q_ind = rnd(frames, b, m, c), rnd(b, m, c), frames // 2
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                x, ctr, p = x32.to(dt), c32.to(dt), operand_weights(p32, dt)
                pw = WindowBlockParams(*p[:10], p.bias)
                tiled = attn_key_tiled(m, frames * m, hd, dt == torch.bfloat16)
                for lib, fn, twin in (
                        ("swin_block", lambda: fused_swin_block(x, ctr, p, heads, q_ind, with_acc=True),
                         lambda: swin_block_reference(x, ctr, p, heads, q_ind, with_acc=True)),
                        ("window_block", lambda: fused_window_block(x, pw, heads, q_ind, with_acc=True),
                         lambda: window_block_reference(x, pw, heads, q_ind, with_acc=True))):
                    counter = f"fused_{lib}" + ("_key_tiles" if tiled else "")
                    before = launch_counts[counter]
                    with torch.no_grad():
                        got, again, ref = fn(), fn(), twin()
                    torch.cuda.synchronize()
                    what = f"{lib} {frames} frames head_dim {hd} {name}"
                    if launch_counts[counter] != before + 2:
                        raise AssertionError(f"{what}: {counter} did not count its launches")
                    if not all(torch.equal(a, r) for a, r in zip(got, again)):
                        raise AssertionError(f"{what}: two runs differ")
                    errs = check_close(what, got, ref, dt)
                    with torch.no_grad():
                        cases.append({"library": lib, "frames": frames, "keys": frames * m,
                                      "head_dim": hd, "dtype": name, "windows": b, "key_tiles": tiled,
                                      "max_abs_err": max(errs), "bitwise_repeat": True,
                                      "kernel_ms": cuda_ms(torch, fn, 10),
                                      "plain_ms": cuda_ms(torch, twin, 3, 1)})
    return cases


def phase_kernels_key_tiles(torch):
    """The key-tiled variants (ROADMAP C5) vs their twins on the card: the
    bare attention core (k, v in their own layout) at the flagship's level 2
    with 31 buffer frames (B_ 20, M 49, N 1519, C 256: the key_tiles
    phase's main-path shape) and at the rows of TILED_FWD_KEYS, the block
    kernels' attention stage at TILED_FWD_FRAMES (key_tiled_block_cases),
    and the backward at the main-path shape and at TILED_BWD_ROWS, each
    repeated bit for bit (bwd_case), f32 and bf16, with times, bounds and
    SDPA forward / backward as the library yardstick; then the occupancy
    of each tiled instantiation at the main-path shape. Returns the
    main-path forward and backward cases."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        attn_core_backward_occupancy, attn_core_bwd_plan, attn_forward_occupancy)

    gen = torch.Generator(device="cuda").manual_seed(8)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    heads, m = 16, 49
    (hp, wp), c2 = LEVELS["level2"]
    b2, n_main = (hp // 7) * (wp // 7), KEY_TILE_FRAMES * m
    fwd_cases, bwd_cases = [], []
    q32, k32, v32, g32 = rnd(b2, m, c2), rnd(b2, n_main, c2), rnd(b2, n_main, c2), rnd(b2, m, c2)
    bias = rnd(heads, m, n_main, scale=0.5)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))
        fwd_cases.append(fwd_core_case(torch, q, k, v, bias, heads, config="flagship",
                                       level="level2", frames=KEY_TILE_FRAMES))
        if not attn_core_bwd_plan(m, n_main, c2, heads).key_tiles:
            raise AssertionError("key tiles: the backward plan does not count key tiles at the main-path shape")
        bwd_cases.append(bwd_case(torch, q, k, v, bias, g, heads, config="flagship", level="level2",
                                  frames=str(KEY_TILE_FRAMES)))
    if not fwd_cases[0]["plan"]["key_tiled"]:
        raise AssertionError("key tiles: the f32 forward plan is not key-tiled at the main-path shape")
    edge_fwd, edge_bwd = [], []
    for hd, keys in TILED_FWD_KEYS.items():
        c = heads * hd
        for n in keys:
            q32, k32, v32 = rnd(b2, m, c), rnd(b2, n, c), rnd(b2, n, c)
            bias = rnd(heads, m, n, scale=0.5)
            for dt in (torch.float32, torch.bfloat16):
                edge_fwd.append(fwd_core_case(torch, *(t.to(dt) for t in (q32, k32, v32)), bias, heads,
                                              config="edge", head_dim=hd))
    for hd, mq, n in TILED_BWD_ROWS:
        c, b = heads * hd, 5
        if not attn_core_bwd_plan(mq, n, c, heads).key_tiles:
            raise AssertionError(f"key tiles: the backward does not count key tiles at M {mq}, N {n}, head_dim {hd}")
        q32, k32, v32, g32 = rnd(b, mq, c), rnd(b, n, c), rnd(b, n, c), rnd(b, mq, c)
        bias = rnd(heads, mq, n, scale=0.5)
        for dt in (torch.float32, torch.bfloat16):
            edge_bwd.append(bwd_case(torch, *(t.to(dt) for t in (q32, k32, v32)), bias, g32.to(dt),
                                     heads, config="edge", head_dim=str(hd)))
    blocks = key_tiled_block_cases(torch, rnd)
    occupancy = {"forward": {lib: attn_forward_occupancy(lib, m, n_main, c2, heads, torch.float32, 0)
                             for lib in ("window_attention", "swin_block", "window_block")},
                 "backward": {str(dt).split(".")[-1]: attn_core_backward_occupancy(m, n_main, c2, heads, dt, 0)
                              for dt in (torch.float32, torch.bfloat16)}}
    emit({"phase": "kernels", "kernel": "attention key tiles",
          "timing": "CUDA events over calls, inputs L2-warm, and device ms (CUDA events around "
                    "calls queued behind a spin kernel); library = torch SDPA forward (bias as "
                    "attn_mask) / SDPA backward alone",
          "forward_main": fwd_cases, "backward_main": bwd_cases, "forward_edges": edge_fwd,
          "backward_edges": edge_bwd, "block_stages": blocks, "occupancy_main": occupancy})
    return fwd_cases, bwd_cases


def phase_key_tiles(torch, launch_counts):
    """ROADMAP C5 on the main path: the flagship at full width with
    buffer_index -15..15 (N 1519) at 184x240, T=3, eval forward on the
    kernel path (level 0's blocks untiled, level 2's key-tiled) vs the
    unfused path within 2e-4, then one train-mode step with remat (DropPath
    0) whose loss and gradients are within 1e-3 of the unfused path's
    (compare_grads), with exact launch counts of each variant. Returns the
    launches of the tiled forward (the eval run) and backward (the step)."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.train import SequenceLossComputer

    T = 3
    rng = np.random.default_rng(9)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    tgt = torch.from_numpy(rng.uniform(size=(T, 1, 1, 184, 240)).astype(np.float32)).cuda()
    half = KEY_TILE_FRAMES // 2
    cfg = model_config(FLAGSHIP_CFG, remat=True)
    cfg["generator"].update(buffer_index=list(range(-half, half + 1)), drop_path_rate=0.0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        model = build_model("BDE2VID", cfg, train=True)
    model.eval()
    timed_forward(torch, model, vox)  # warm-up
    launch_counts.clear()
    img_kernel, kernel_ms = timed_forward(torch, model, vox)
    fwd_launches = dict(launch_counts)
    per_frame = {"fused_swin_block": 4 * T, "fused_swin_block_key_tiles": 6 * T}
    expect_launches("key tiles forward", fwd_launches, per_frame)
    set_attention_kernel(model, False)
    img_plain, plain_ms = timed_forward(torch, model, vox)
    diff = (img_kernel - img_plain).abs().max().item()
    if not (img_kernel.shape == (T, 1, 1, 184, 240) and torch.isfinite(img_kernel).all()
            and diff <= 2e-4):
        raise AssertionError(f"key tiles: kernel vs unfused forward max diff {diff} (bound 2e-4)")
    model.train()
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_k, grads_k, step_launches = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, True)
    step_ms = 1e3 * (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # remat runs each block's forward twice: in the step and in its recompute
    expect_launches("key tiles step", step_launches,
                    {**{k: 2 * v for k, v in per_frame.items()},
                     "attn_core_backward_long_rows": 4 * T, "attn_core_backward_key_tiles": 6 * T})
    loss_u, grads_u, _ = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, False)
    row = {"frames": KEY_TILE_FRAMES, "keys": KEY_TILE_FRAMES * 49, "T": T, "hw": [184, 240],
           "forward_launches": fwd_launches, "forward_max_abs_diff_vs_unfused": diff,
           "forward_ms_kernel_path": kernel_ms, "forward_ms_unfused_path": plain_ms,
           "step_launches": step_launches, "remat_step_ms_kernel_path": step_ms,
           "max_memory_allocated_gib": peak_gb,
           **compare_grads("key tiles step", loss_k, grads_k, loss_u, grads_u)}
    del model
    emit({"phase": "key_tiles", **row})
    return fwd_launches["fused_swin_block_key_tiles"], step_launches["attn_core_backward_key_tiles"]


def phase_kernels_head_dims(torch):
    """ROADMAP C6, C8 and C9 on the card: the three forward libraries (the
    bare core, the Swin block's and the WindowAttention3D body's attention
    stage, with acc) and the backward vs their twins at every HEAD_DIM_CASES
    head_dim and head count (head_dim 3 to 2048, and C 2048 over 8 heads),
    f32 and bf16, at the flagship's level-2 windows over 7 frames (B_ 20, M
    49, N 343), each repeated bit for bit, the launch counted on the
    variant its plan names (key-tiled forward and wide backward above
    head_dim 32), with times per launch beside the bound; then the
    key-tiled forward at TILED_TIMING through attn_tiled_times. Returns
    the backward cases at the head_dims phase's level-2 shapes (head_dim 64
    and 128 at C 256), which take the wide kernel."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        WindowBlockParams, attn_core_bwd_plan, attn_key_tiled, bwd_counter, fused_swin_block,
        fused_window_attention, fused_window_block, launch_counts, swin_block_reference,
        window_block_reference)

    gen = torch.Generator(device="cuda").manual_seed(16)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    b, m, d = 20, 49, 7
    n = d * m
    fwd, blocks, bwd = [], [], []
    for hd, heads in HEAD_DIM_CASES:
        c = heads * hd
        q32, k32, v32, g32 = rnd(b, m, c), rnd(b, n, c), rnd(b, n, c), rnd(b, m, c)
        bias = rnd(heads, m, n, scale=0.5)
        p32 = block_params(rnd, c, heads, m, n)
        x32, c32 = rnd(d, b, m, c), rnd(b, m, c)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))
            case = fwd_core_case(torch, q, k, v, bias, heads, config="head_dims", head_dim=hd)
            with torch.no_grad():
                if not torch.equal(fused_window_attention(q, k, v, bias, heads),
                                   fused_window_attention(q, k, v, bias, heads)):
                    raise AssertionError(f"head_dim {hd} {name}: two window attention runs differ")
            fwd.append({**case, "bitwise_repeat": True})
            x, ctr, p = x32.to(dt), c32.to(dt), operand_weights(p32, dt)
            pw = WindowBlockParams(*p[:10], p.bias)
            tiled = attn_key_tiled(m, n, hd, dt == torch.bfloat16)
            for lib, fn, twin in (
                    ("swin_block", lambda: fused_swin_block(x, ctr, p, heads, d // 2, with_acc=True),
                     lambda: swin_block_reference(x, ctr, p, heads, d // 2, with_acc=True)),
                    ("window_block", lambda: fused_window_block(x, pw, heads, d // 2, with_acc=True),
                     lambda: window_block_reference(x, pw, heads, d // 2, with_acc=True))):
                counter = f"fused_{lib}" + ("_key_tiles" if tiled else "")
                before = launch_counts[counter]
                with torch.no_grad():
                    got, again, ref = fn(), fn(), twin()
                torch.cuda.synchronize()
                what = f"{lib} head_dim {hd} {name}"
                if launch_counts[counter] != before + 2:
                    raise AssertionError(f"{what}: {counter} did not count its launches")
                if not all(torch.equal(a, r) for a, r in zip(got, again)):
                    raise AssertionError(f"{what}: two runs differ")
                errs = check_close(what, got, ref, dt)
                flops, nbytes = (swin_block_cost(d, b, m, c, heads, 4 * c, x.element_size())
                                 if lib == "swin_block" else
                                 window_block_cost(d, b, m, c, heads, x.element_size(), True))
                with torch.no_grad():
                    blocks.append({"library": lib, "head_dim": hd, "heads": heads, "dtype": name,
                                   "key_tiles": tiled, "max_abs_err": max(errs), "bitwise_repeat": True,
                                   "kernel_ms": cuda_ms(torch, fn, 10), "plain_ms": cuda_ms(torch, twin, 3, 1),
                                   "bound_ms": 1e3 * max(flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES)})
            counter = bwd_counter(attn_core_bwd_plan(m, n, c, heads), hd)
            before = launch_counts[counter]
            case = bwd_case(torch, q, k, v, bias, g, heads, config="head_dims", level="level2",
                            head_dim=str(hd))
            if launch_counts[counter] < before + 2:
                raise AssertionError(f"backward head_dim {hd} {name}: {counter} did not count its launches")
            bwd.append({**case, "kernel": counter})
    tiled = attn_tiled_times(torch)
    emit({"phase": "kernels", "kernel": "attention head dims",
          "timing": "CUDA events over calls, inputs L2-warm, and device ms (CUDA events around "
                    "calls queued behind a spin kernel); library = torch SDPA forward (bias as "
                    "attn_mask) / SDPA backward alone; tiled_forward: attn_tiled_times",
          "forward": fwd, "block_stages": blocks, "backward": bwd, "tiled_forward": tiled})
    return [c for c in bwd if c["head_dim"] in ("64", "128")]


def phase_head_dims(torch, launch_counts):
    """ROADMAP C6 and C7 on the main path: the flagship at full width with
    num_heads 4 (head_dim 16 at level 0, 64 at level 2) and 2 (32 and 128),
    and at base 64 with one head (128 and 512), at 184x240, T=3: the eval
    forward on the kernel path (the key-tiled forward at every level whose
    head_dim is above 32) vs the unfused path within 2e-4, then one
    train-mode step (DropPath 0) whose loss and gradients are within 1e-3 of
    the unfused path's (compare_grads; the wide backward there), with exact
    launch counts. Returns the wide backward's launches."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.train import SequenceLossComputer

    T = 3
    rng = np.random.default_rng(16)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    tgt = torch.from_numpy(rng.uniform(size=(T, 1, 1, 184, 240)).astype(np.float32)).cuda()
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    rows, wide = [], 0
    for label, gen_cfg in HEAD_DIM_MODELS.items():
        cfg = model_config(FLAGSHIP_CFG)
        cfg["generator"].update(gen_cfg, drop_path_rate=0.0)
        base, heads = cfg["generator"]["basechannels"], cfg["generator"]["num_heads"]
        head_dims = [2 * base // heads, 8 * base // heads]  # levels 0 and 2
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(16 + heads)
            model = build_model("BDE2VID", cfg, train=True)
        model.eval()
        timed_forward(torch, model, vox)  # warm-up
        launch_counts.clear()
        img_kernel, kernel_ms = timed_forward(torch, model, vox)
        fwd_launches = dict(launch_counts)
        # launches per level (4 and 6 blocks a frame): key-tiled forward and
        # wide backward above head_dim 32
        per_frame, step_want = {}, {}
        for hd, blocks in zip(head_dims, (4 * T, 6 * T)):
            fwd_key = "fused_swin_block_key_tiles" if hd > 32 else "fused_swin_block"
            bwd_key = "attn_core_backward_wide" if hd > 32 else "attn_core_backward"
            per_frame[fwd_key] = per_frame.get(fwd_key, 0) + blocks
            step_want[bwd_key] = step_want.get(bwd_key, 0) + blocks
        expect_launches(f"head dims {label} forward", fwd_launches, per_frame)
        if not torch.equal(timed_forward(torch, model, vox)[0], img_kernel):
            raise AssertionError(f"head dims {label}: two kernel-path forwards differ")
        set_attention_kernel(model, False)
        img_plain, plain_ms = timed_forward(torch, model, vox)
        diff = (img_kernel - img_plain).abs().max().item()
        if not (img_kernel.shape == (T, 1, 1, 184, 240) and torch.isfinite(img_kernel).all()
                and diff <= 2e-4):
            raise AssertionError(f"head dims {label}: kernel vs unfused forward max diff {diff}")
        model.train()
        loss_k, grads_k, step_launches = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, True)
        expect_launches(f"head dims {label} step", step_launches, {**per_frame, **step_want})
        loss_u, grads_u, _ = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, False)
        wide += step_launches["attn_core_backward_wide"]
        rows.append({"model": label, "basechannels": base, "num_heads": heads, "head_dims": head_dims,
                     "parameters": sum(p.numel() for p in model.parameters()), "T": T,
                     "hw": [184, 240], "forward_launches": fwd_launches,
                     "forward_max_abs_diff_vs_unfused": diff, "forward_ms_kernel_path": kernel_ms,
                     "forward_ms_unfused_path": plain_ms, "step_launches": step_launches,
                     "forward_repeats_bitwise": True,
                     **compare_grads(f"head dims {label} step", loss_k, grads_k, loss_u, grads_u)})
        del model
    emit({"phase": "head_dims", "models": rows})
    return wide


def phase_kernels_long_rows(torch):
    """The attention backward at the shapes of long buffers, where it takes
    the tiled backward, counted as long rows: 21 frames of 7x7 windows at
    the flagship's levels (M 49, N 1029), 17 of 8x8 at the 8x8 config's
    (M 64, N 1088) and TWELVE_FRAMES of 12x12 (M 144 in two row groups, N
    432), f32 and bf16, each vs its twin, repeated for bit
    equality, timed beside its bound and SDPA's backward, with the plan and
    the instantiation's occupancy. Returns the flagship's cases."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        attn_core_backward_occupancy, attn_core_bwd_plan)

    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    heads, cases = 16, []
    for config, levels, win in (("flagship", LEVELS, 7), ("8x8", LEVELS_8, 8), ("12x12", LEVELS_8, 12)):
        m = win * win
        frames = LONG_FRAMES.get(config, TWELVE_FRAMES)
        n = frames * m
        for level, ((hp, wp), c) in levels.items():
            b = (hp // win) * (wp // win)
            plan = attn_core_bwd_plan(m, n, c, heads)
            if plan.row_share:
                raise AssertionError(f"long rows {config} {level}: the plan took row share {plan.row_share}")
            q32, k32, v32, g32 = rnd(b, m, c), rnd(b, n, c), rnd(b, n, c), rnd(b, m, c)
            bias = rnd(heads, m, n, scale=0.5)
            for dt in (torch.float32, torch.bfloat16):
                case = bwd_case(torch, *(t.to(dt) for t in (q32, k32, v32)), bias, g32.to(dt), heads,
                                config=config, level=level, layout="plain")
                occ = attn_core_backward_occupancy(m, n, c, heads, dt, 0)
                cases.append({**case, "frames": frames, "plan": plan._asdict(),
                              "occupancy": {k: occ[k] for k in ("registers", "spill_bytes",
                                                                "blocks_per_sm", "slices")}})
    emit({"phase": "kernels", "kernel": "attn_core_backward, long rows",
          "timing": "CUDA events, inputs L2-warm; library = torch SDPA backward alone",
          "cases": cases})
    return [c for c in cases if c["config"] == "flagship"]


def fwd_occupancy(torch, heads):
    """Registers, spill bytes, shared memory per block and resident blocks
    per SM of the forward attention's instantiation at each level shape of
    both configurations on card 0, with J (0 on the tensor cores) and the
    launch plan it takes there (tiles a window): for B4 (the
    window_attention library) and for B1's attention stage (swin_block)."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import attn_forward_occupancy, attn_plan_for

    rows = []
    for lib in ("window_attention", "swin_block"):
        for config, win, levels in (("flagship", 7, LEVELS), ("8x8", 8, LEVELS_8)):
            m = win * win
            for level, ((hp, wp), c) in levels.items():
                b = (hp // win) * (wp // win)
                for dt in (torch.float32, torch.bfloat16):
                    plan = attn_plan_for(lib, b, m, 7 * m, c, heads, dt, 0)
                    rows.append({"library": lib, "config": config, "level": level,
                                 "dtype": str(dt).split(".")[-1], "windows": b,
                                 **attn_forward_occupancy(lib, m, 7 * m, c, heads, dt, 0),
                                 "plan": plan._asdict()})
    return rows


def window_block_cost(d, b, m, c, heads, elem_bytes, with_acc):
    """(FLOPs, bytes) one fused_window_block call needs: 2 per multiply-add
    of the k|v, q and out projections and 4 B_ M N C for the attention; x
    read and the output (and acc) written once in the operand type, the
    weights once in the operand type, vectors and the bias in f32."""
    n = d * m
    flops = 2 * d * b * m * c * 2 * c + 2 * b * m * c * c + 4 * b * m * n * c + 2 * b * m * c * c
    nbytes = (elem_bytes * (d * b * m * c + (2 if with_acc else 1) * b * m * c + 4 * c * c)
              + 4 * (heads * m * n + 8 * c))
    return flops, nbytes


def window_attention_cost(b, m, n, c, heads, elem_bytes):
    """(FLOPs, bytes) one fused_window_attention call needs: 4 B_ M N C (the
    scores and the weighted sum, each 2 per multiply-add over head_dim for
    H heads); q, k, v read and the output written once in the operand type,
    the bias once in f32."""
    return 4 * b * m * n * c, elem_bytes * (2 * b * m * c + 2 * b * n * c) + 4 * heads * m * n


def sdpa_forward_ms(torch, q, k, v, bias, heads, iters=20):
    """Time of torch's scaled_dot_product_attention forward on the same
    function (the bias as a float attn_mask broadcast over windows): CUDA
    events over calls, the backend PyTorch takes first, and the device ms
    of its kernels (profiler); (None, reason, None) when none takes the
    shapes."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b_, m, c = q.shape
    hd = c // heads

    def heads_of(t):
        return t.reshape(b_, -1, heads, hd).transpose(1, 2)

    qh, kh, vh = heads_of(q), heads_of(k), heads_of(v)
    mask = bias[None].to(q.dtype)
    errors = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings(), torch.no_grad():
                warnings.simplefilter("ignore")  # each refusing backend warns why
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
                call = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
                return cuda_ms(torch, call, iters), backend.name, device_ms(torch, call)
        except RuntimeError as exc:
            errors[backend.name] = str(exc).splitlines()[0][:80]
    return None, f"no SDPA backend takes these shapes: {errors}", None


def device_ms(torch, fn, calls=5, spin_cycles=20_000_000):
    """Device ms per call of the CUDA kernels that ``fn`` launches, without
    the host's time: ``calls`` calls enqueued behind a spin kernel
    (``torch.cuda._sleep``), so the card runs them back to back, timed by
    CUDA events around them. If the spin ended before the host had
    enqueued them all, the card may have waited on the host: the spin
    doubles and the calls run again. (Profiler traces on the card lose
    kernel records in long runs, PERF.md section 7.)"""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if not start.query():  # the card still spins: it never waited on the host
            end.synchronize()
            return start.elapsed_time(end) / calls
        spin_cycles *= 2
    raise AssertionError(f"device_ms: the host took longer to enqueue {calls} calls than a spin "
                         f"of {spin_cycles // 2} cycles")


def check_close(what, got, ref, dt):
    """Max abs error of each pair; raises past f32 1e-4 x max(1, max|ref|)
    or bf16 2e-2 x max|ref|."""
    errs = []
    for a, r in zip(got, ref):
        err = (a.float() - r.float()).abs().max().item()
        ref_max = r.float().abs().max().item()
        tol = 1e-4 * max(1.0, ref_max) if str(dt) == "torch.float32" else 2e-2 * ref_max
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{what}: kernel vs twin {err} > {tol}")
        errs.append(err)
    return errs


def phase_kernels_window(torch):
    """The WindowAttention3D body at the 8x8 config's dilated shapes (with
    and without acc) and the bare attention core at the flagship's and the
    8x8 config's shapes, each vs its twin, with times; then both Functions'
    gradients on the card vs autograd through the twins."""
    from bde2vid_tpu_torch.nn.window_attention import window_partition, window_partition_dilated
    from bde2vid_tpu_torch.ops.window_attn_cuda import (
        WindowBlockParams, _pre_stage, fused_window_attention, fused_window_block,
        window_attention_reference, window_block_reference)

    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d, heads, q_ind = 7, 16, 3
    block_cases, attn_cases, grads = [], [], {}
    for config, levels, win, part in (("flagship", LEVELS, (7, 7), window_partition),
                                      ("8x8", LEVELS_8, (8, 8), window_partition_dilated)):
        m = win[0] * win[1]
        for level, ((hp, wp), c) in levels.items():
            sp = block_params(rnd, c, heads, m, d * m)
            p = WindowBlockParams(*sp[:10], sp.bias)
            x32 = part(rnd(d, 1, hp, wp, c), win).reshape(d, -1, m, c).contiguous()
            b = x32.shape[1]
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                x = x32.to(dt)
                if config == "8x8":
                    for with_acc in (False, True):
                        got = fused_window_block(x, p, heads, q_ind, with_acc=with_acc)
                        ref = window_block_reference(x, p, heads, q_ind, with_acc=with_acc)
                        torch.cuda.synchronize()
                        got, ref = (got, ref) if with_acc else ((got,), (ref,))
                        errs = check_close(f"window block {level} {name} acc={with_acc}", got, ref, dt)
                        flops, nbytes = window_block_cost(d, b, m, c, heads, x.element_size(), with_acc)
                        t_flops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
                        block_cases.append({
                            "config": config, "level": level, "layout": "dilated", "dtype": name,
                            "with_acc": with_acc, "windows": b, "channels": c,
                            "max_abs_err": max(errs),
                            "kernel_ms": cuda_ms(torch, lambda: fused_window_block(
                                x, p, heads, q_ind, with_acc=with_acc), 20),
                            "plain_ms": cuda_ms(torch, lambda: window_block_reference(
                                x, p, heads, q_ind, with_acc=with_acc), 5, 1),
                            "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_flops, t_bytes),
                            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
                            "library_ms": None,
                        })
                # the attention core at the shapes the block gives it
                q, k, v = _pre_stage(x, x[q_ind], p, heads, q_ind)
                attn_cases.append(fwd_core_case(torch, q, k, v, p.bias, heads, config=config, level=level))
            if config == "8x8" and level == "level0":
                # both Functions' gradients (f32) vs autograd through the twins
                g = rnd(b, m, c)
                qkv = _pre_stage(x32, x32[q_ind], p, heads, q_ind)
                for fname, ins, kernel_fn, twin_fn in (
                        ("WindowBlockFunction", (x32, *p),
                         lambda t: fused_window_block(t[0], WindowBlockParams(*t[1:]), heads, q_ind),
                         lambda t: window_block_reference(t[0], WindowBlockParams(*t[1:]), heads, q_ind)),
                        ("WindowAttentionFunction", (*qkv, p.bias),
                         lambda t: fused_window_attention(*t, heads),
                         lambda t: window_attention_reference(*t, heads))):
                    res = []
                    for fn in (kernel_fn, twin_fn):
                        leaves = [t.detach().clone().requires_grad_() for t in ins]
                        res.append(torch.autograd.grad(fn(leaves), leaves, g))
                    torch.cuda.synchronize()
                    grads[fname] = max(check_close(f"{fname} gradients", *res, torch.float32))
    emit({"phase": "kernels", "kernel": "fused_window_block", "timing": "CUDA events, inputs L2-warm",
          "cases": block_cases})
    emit({"phase": "kernels", "kernel": "fused_window_attention",
          "timing": "CUDA events over calls, inputs L2-warm, and device ms of the kernels alone "
                    "(CUDA events around calls queued behind a spin kernel); library = torch SDPA "
                    "forward, bias as attn_mask",
          "cases": attn_cases, "gradients_max_abs_err_vs_twin_autograd": grads})
    emit({"phase": "kernels", "kernel": "attention forward occupancy",
          "instantiations": fwd_occupancy(torch, heads)})
    return block_cases, attn_cases


def attn_forward_times(torch, calls=5):
    """Device ms of the attention core's forward in the package on sys.path:
    B4 (fused_window_attention, CUDA events) at the flagship's and the 8x8
    config's level shapes, f32 and bf16, beside torch's SDPA forward on the
    same inputs; and B1's attention stage (profiler device ms of its
    attn_kernel launch, mean of ``calls`` calls) at the flagship's plain
    level shapes. Seeded random inputs, so two checkouts see the same ones:
    to compare trees, call it from each tree's root in turn."""
    from bde2vid_tpu_torch.nn.window_attention import window_partition
    from bde2vid_tpu_torch.ops.window_attn_cuda import fused_swin_block, fused_window_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d, heads, q_ind = 7, 16, 3
    b4, b1 = [], []
    for config, levels, win in (("flagship", LEVELS, 7), ("8x8", LEVELS_8, 8)):
        m = win * win
        for level, ((hp, wp), c) in levels.items():
            b = (hp // win) * (wp // win)
            q32, k32, v32 = rnd(b, m, c), rnd(b, d * m, c), rnd(b, d * m, c)
            bias = rnd(heads, m, d * m, scale=0.5)
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dt) for t in (q32, k32, v32))
                with torch.no_grad():
                    ms = cuda_ms(torch, lambda: fused_window_attention(q, k, v, bias, heads), 50, 5)
                lib_ms, backend, _ = sdpa_forward_ms(torch, q, k, v, bias, heads, iters=50)
                b4.append({"config": config, "level": level, "dtype": str(dt).split(".")[-1],
                           "ms": ms, "sdpa_ms": lib_ms, "sdpa": backend})
            if config == "flagship":
                p32 = block_params(rnd, c, heads, m, d * m)
                feats = rnd(d + 1, 1, hp, wp, c)
                x32 = window_partition(feats[:d], (win, win)).reshape(d, -1, m, c).contiguous()
                c32 = window_partition(feats[d:], (win, win))[0].reshape(-1, m, c).contiguous()
                for dt in (torch.float32, torch.bfloat16):
                    x, ctr, p = x32.to(dt), c32.to(dt), operand_weights(p32, dt)
                    with torch.no_grad():
                        fused_swin_block(x, ctr, p, heads, q_ind)
                        ms, _ = b1_stage_ms(torch, lambda: fused_swin_block(x, ctr, p, heads, q_ind), calls)
                    b1.append({"level": level, "dtype": str(dt).split(".")[-1], "attn_ms": ms["attn"]})
    return {"b4": b4, "b1_attn_stage": b1}


# the key-tiled forward's timing shapes (PERF.md section 6): (head_dim, N)
# at B_ 20, M 49 and 16 heads, the flagship's level 2 with 31 buffer frames
# first
TILED_TIMING = ((16, 1519), (16, 2989), (4, 7399))


def attn_tiled_times(torch, iters=50):
    """Ms per launch (CUDA events) of the key-tiled forward at
    TILED_TIMING, f32 and bf16, launched through the bare core's library
    key-tiled also where the plan takes the untiled kernel (bf16 at N 1519,
    then at the f32 plan's tiles), each checked against the twin and
    repeated bit for bit, beside the plan's own kernel and torch's SDPA
    forward on the same seeded inputs; the key tile and occupancy are the
    key-tiled instantiation's, from the library's occupancy query."""
    from bde2vid_tpu_torch.ops import window_attn_cuda as wac

    gen = torch.Generator(device="cuda").manual_seed(15)
    dev = torch.device("cuda")
    heads, m, b = 16, 49, 20
    lib = wac._lib("window_attention")
    rows = []
    for hd, n in TILED_TIMING:
        c = heads * hd
        q32, k32, v32 = (torch.randn(b, r, c, generator=gen, device=dev) for r in (m, n, n))
        bias = torch.randn(heads, m, n, generator=gen, device=dev) * 0.5
        f32_plan = wac.attn_plan_for("window_attention", b, m, n, c, heads, torch.float32, 0)
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            plan = wac.attn_plan_for("window_attention", b, m, n, c, heads, dt, 0)
            tiles = plan.tiles if plan.key_tiled else f32_plan.tiles
            occ = (ctypes.c_longlong * 7)()
            if lib.window_attention_occupancy(int(bf16), m, n, c, heads, 1, occ):
                raise RuntimeError("window_attention_occupancy failed")
            out = torch.empty_like(q)

            def tiled():
                rc = lib.window_attention_forward(
                    int(bf16), b, m, n, c, heads, tiles, 1, float(hd ** -0.5),
                    *[t.data_ptr() for t in (q, k, v, bias, out)], wac._stream(q))
                if rc:
                    raise RuntimeError(f"window_attention_forward: CUDA error {rc}")

            with torch.no_grad():
                tiled()
                ref = wac.window_attention_reference(q, k, v, bias, heads)
                torch.cuda.synchronize()
                (err,) = check_close(f"tiled forward head_dim {hd} N {n}", (out,), (ref,), dt)
                first = out.clone()
                tiled()
                torch.cuda.synchronize()
                if not torch.equal(first, out):
                    raise AssertionError(f"tiled forward head_dim {hd} N {n}: two runs differ")
                ms = cuda_ms(torch, tiled, iters, 5)
                plan_ms = cuda_ms(torch, lambda: wac.fused_window_attention(q, k, v, bias, heads), iters, 5)
            lib_ms, backend, _ = sdpa_forward_ms(torch, q, k, v, bias, heads, iters=iters)
            flops, nbytes = window_attention_cost(b, m, n, c, heads, q.element_size())
            rows.append({"head_dim": hd, "keys": n, "dtype": str(dt).split(".")[-1], "key_tile": occ[6],
                         "registers": occ[0], "spill_bytes": occ[1], "smem_bytes": occ[2],
                         "blocks_per_sm": occ[4], "tiles": tiles, "max_abs_err": err, "tiled_ms": ms,
                         "plan_key_tiled": plan.key_tiled,
                         "plan_ms": plan_ms, "sdpa_ms": lib_ms, "sdpa": backend,
                         "bound_ms": 1e3 * max(flops / PEAK_FLOPS[str(dt).split(".")[-1]],
                                               nbytes / PEAK_BYTES)})
    return rows


def phase_attention(torch, launch_counts):
    """The ops.fused_window_attention entry point, forward and backward, at
    one 8x8 frame's dilated attention shapes (2 calls at level 0, 3 at
    level 2): B4 forward and B2 backward, each launched once per call."""
    from bde2vid_tpu_torch.ops import fused_window_attention

    gen = torch.Generator(device="cuda").manual_seed(6)
    d, heads, m = 7, 16, 64
    calls = []
    for level, ((hp, wp), c) in LEVELS_8.items():
        b = ((hp + 8 - 15) // 8 + 1) * ((wp + 8 - 15) // 8 + 1)  # dilated 8x8 windows
        f = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        ins = (f(b, m, c), f(b, d * m, c), f(b, d * m, c), f(heads, m, d * m) * 0.5)
        calls += [(ins, f(b, m, c))] * BLOCKS_PER_FRAME_8[level]
    launch_counts.clear()
    norms = []
    for ins, g in calls:
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fused_window_attention(*leaves, heads)
        out.backward(g)
        norms.append(max(t.grad.abs().max().item() for t in leaves))
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    want = {"fused_window_attention": len(calls), "attn_core_backward": len(calls)}
    if launches != want or not all(math.isfinite(v) for v in norms):
        raise AssertionError(f"attention entry point: launches {launches}, want {want}; grads {norms}")
    emit({"phase": "attention", "calls": len(calls), "launches": launches,
          "max_abs_grad": max(norms)})
    return launches["fused_window_attention"]


def compare_grads(what, loss_k, grads_k, loss_u, grads_u, zero_keys=(), l2_bound=None):
    """Gate the kernel path's loss and gradients against the unfused
    path's: the loss and every gradient within 1e-3 relative (max |diff| over
    max |unfused|). Gradients that are analytically zero get an absolute
    bound of 1e-5 instead: the key half of ``attn.kv.bias`` (softmax is shift
    invariant per row) and ``zero_keys`` (the conv biases an affine-free
    InstanceNorm cancels). With ``l2_bound`` each gradient is held to that
    bound on its relative L2 distance (|diff| over |unfused|) instead."""
    if set(grads_k) != set(grads_u):
        raise AssertionError(f"{what}: the two paths give gradients to different parameters")
    loss_rel = abs(loss_k - loss_u) / abs(loss_u)
    bound = 1e-3 if l2_bound is None else l2_bound
    worst, worst_key, zero = 0.0, None, 0.0
    for key, gu in grads_u.items():
        gk = grads_k[key]
        if key in zero_keys:
            zero = max(zero, gk.abs().max().item(), gu.abs().max().item())
            continue
        if key.endswith("attn.kv.bias"):
            c = gu.shape[0] // 2
            zero = max(zero, gk[:c].abs().max().item(), gu[:c].abs().max().item())
            gk, gu = gk[c:], gu[c:]
        if l2_bound is None:
            rel = (gk - gu).abs().max().item() / max(gu.abs().max().item(), 1e-30)
        else:
            rel = (gk - gu).norm().item() / max(gu.norm().item(), 1e-30)
        if rel > worst:
            worst, worst_key = rel, key
    if not (loss_rel <= 1e-3 and worst <= bound and zero <= 1e-5):
        raise AssertionError(f"{what}: loss rel {loss_rel}, worst gradient rel {worst} ({worst_key}, "
                             f"bound {bound}), analytically zero gradients {zero}")
    return {"loss_kernel": loss_k, "loss_unfused": loss_u, "loss_rel_diff": loss_rel,
            "worst_grad_rel_diff": worst, "worst_grad_key": worst_key,
            "grad_metric": "max" if l2_bound is None else "l2", "grad_bound": bound,
            "zero_grads_max_abs": zero, "leaves": len(grads_u)}


def phase_grads(torch, launch_counts):
    """Kernel path vs unfused path, loss and every gradient, for both
    configurations at full width; the flagship then takes 5 Adam steps."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer, train_step

    T = 3
    rng = np.random.default_rng(3)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    tgt = torch.from_numpy(rng.uniform(size=(T, 1, 1, 184, 240)).astype(np.float32)).cuda()
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    rows = {}
    for name, cfg in (("flagship", FLAGSHIP_CFG), ("8x8", EIGHT_CFG)):
        cfg = model_config(cfg)
        cfg["generator"]["drop_path_rate"] = 0.0
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(3)
            model = build_model("BDE2VID", cfg, train=True)

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
        want = {k: n * T for k, n in PER_FRAME[name].items()}
        want["attn_core_backward"] = 10 * T  # one per attention block, whichever kernel ran it
        expect_launches(f"grads {name}", launches, want)
        rows[name] = {"launches": launches,
                      **compare_grads(f"grads {name}", loss_k, grads_k, loss_u, grads_u)}
        if name == "flagship":
            set_attention_kernel(model, True)
            # lr 1e-4, the train phase's rate: at 1e-3 the first Adam step from
            # this random init overshoots (0.255 -> 0.428 on the H100) and 5
            # steps do not bring the loss back below where it started
            optimizer, _, _, _ = build_optimizer(model.parameters(), {"type": "Adam", "args": {"lr": 1e-4}})
            losses = [train_step(model, optimizer, comp, vox, tgt)["loss"].item() for _ in range(5)]
            if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
                raise AssertionError(f"grads: Adam steps did not lower the loss: {losses}")
            rows[name]["adam_losses"] = losses
        del model
    emit({"phase": "grads", "T": T, "hw": [184, 240], "configs": rows})


def _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, kernel):
    """Loss, gradients and launches of one train-mode step of ``model`` on
    the kernel or the unfused path (no optimizer step)."""
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel

    set_attention_kernel(model, kernel)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    launch_counts.clear()
    loss, _ = comp(model(vox)["image"], tgt)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()
                         if p.grad is not None}, dict(launch_counts)


def phase_variants(torch, launch_counts):
    """The flagship width (base 32, depths [4, 0, 6], 16 heads, 7x7) with each
    config variant the JAX package trains: concat skips, BN, IN, ConvGRU.
    At 184x240, T=3: the eval forward on the kernel path vs the unfused path
    (2e-4) with 10 launches a frame, then one train-mode step's loss (1e-3)
    and gradients on both paths, each gradient within VARIANT_GRAD_L2 of
    the unfused path's by relative L2 distance."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.train import SequenceLossComputer

    T = 3
    rng = np.random.default_rng(6)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    tgt = torch.from_numpy(rng.uniform(size=(T, 1, 1, 184, 240)).astype(np.float32)).cuda()
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    rows = {}
    for name, extra in VARIANTS.items():
        cfg = model_config(FLAGSHIP_CFG)
        cfg["generator"].update(extra, drop_path_rate=0.0)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(6)
            model = build_model("BDE2VID", cfg, train=True)
        model.eval()
        images = []
        for kernel in (True, False):
            set_attention_kernel(model, kernel)
            launch_counts.clear()
            with torch.no_grad():
                images.append(model(vox)["image"])
            torch.cuda.synchronize()
            if kernel:
                expect_launches(f"variant {name} forward", launch_counts,
                                {k: n * T for k, n in PER_FRAME["flagship"].items()})
        diff = (images[0] - images[1]).abs().max().item()
        if not (torch.isfinite(images[0]).all() and diff <= 2e-4):
            raise AssertionError(f"variant {name}: kernel vs unfused forward max diff {diff} (bound 2e-4)")
        model.train()
        loss_k, grads_k, launches = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, True)
        expect_launches(f"variant {name} step", launches,
                        {"fused_swin_block": PER_FRAME["flagship"]["fused_swin_block"] * T,
                         "attn_core_backward": PER_FRAME["flagship"]["fused_swin_block"] * T})
        loss_u, grads_u, _ = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, False)
        state = model.state_dict()
        zero = {k for k in grads_u if k.endswith("conv2d.bias")
                and k[:-11] + "norm_layer.running_mean" in state}
        rows[name] = {"config": extra, "forward_max_abs_diff": diff, "launches": launches,
                      **compare_grads(f"variant {name}", loss_k, grads_k, loss_u, grads_u, zero,
                                      l2_bound=VARIANT_GRAD_L2)}
        del model
    emit({"phase": "variants", "T": T, "hw": [184, 240], "configs": rows})


def phase_train(torch, launch_counts, card):
    """The training path: the train CLI on the MMP sequence for the flagship
    (6 steps) and the 8x8 config (3 steps), each checkpoint scored by the
    eval CLI, and one profiled flagship train step. Returns the flagship
    run's launches of the attention-core backward."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer, train_step
    from bde2vid_tpu_torch.train.__main__ import iterate_training_windows
    from bde2vid_tpu_torch.train.__main__ import main as train_main

    data_cfg = {"sequence_length": TRAIN_SEQ_LEN, "num_bins": 5,
                "proba_pause_when_running": 0.05, "proba_pause_when_paused": 0.9,
                "noise_std": 0.1, "noise_fraction": 0.05,
                "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.001}
    optimizer_cfg = {"type": "Adam", "args": {"lr": 1e-4, "grad_clip": 1.0}}
    rows = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data = os.path.join(tmp, "data")
        items = write_mmp_sequence(os.path.join(data, "mmp", "SYN", "seq0"), np.random.default_rng(4))
        for name, base, steps, flags in (
                ("flagship", FLAGSHIP_CFG, TRAIN_STEPS, {}),
                ("8x8", EIGHT_CFG, TRAIN_STEPS_8X8, {}),
                ("flagship_bf16", FLAGSHIP_CFG, TRAIN_STEPS, {"bf16": True}),
                ("flagship_remat", FLAGSHIP_CFG, TRAIN_STEPS, {"remat": True}),
                ("flagship_bf16_remat", FLAGSHIP_CFG, TRAIN_STEPS, {"bf16": True, "remat": True})):
            model_args = model_config(base)
            model_args["generator"]["drop_path_rate"] = 0.2
            cfg = {"name": name, "model": {"type": "BDE2VID", "args": model_args},
                   "losses": [{"type": "L1Loss"}], "optimizer": optimizer_cfg,
                   "data": data_cfg, "train": {"steps": steps, "ckpt_every": 1000, **flags}}
            cfg_path = os.path.join(tmp, f"cfg_{name}.json")
            with open(cfg_path, "w") as fp:
                json.dump(cfg, fp)
            out_dir = os.path.join(tmp, "run_" + name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launch_counts.clear()
            t0 = time.perf_counter()
            rc = train_main(["--config", cfg_path, "--data_dir", data, "--out_dir", out_dir,
                             "--loader_type", "MMP"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(launch_counts)
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            with open(os.path.join(out_dir, "train_log.jsonl")) as fp:
                log = [json.loads(line) for line in fp]
            if rc != 0 or len(log) != steps or not all(math.isfinite(r["loss"]) for r in log):
                raise AssertionError(f"train CLI ({name}): rc {rc}, log {log}")
            # remat runs each block's forward twice: in the step and in its recompute
            forwards = 2 if flags.get("remat") else 1
            want = {k: forwards * n * steps * TRAIN_SEQ_LEN
                    for k, n in PER_FRAME[name.split("_")[0]].items()}
            want["attn_core_backward"] = 10 * steps * TRAIN_SEQ_LEN
            expect_launches(f"train CLI ({name})", launches, want)
            ckpt = os.path.join(out_dir, f"epoch_{steps}.pth")
            if not os.path.exists(ckpt):
                raise AssertionError(f"train CLI ({name}) wrote no {ckpt}")
            eval_out = os.path.join(tmp, "eval_" + name)
            rc = eval_main(["--weights_dir", out_dir, "--data_dir", data, "--datasets", "SYN",
                            "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", "8",
                            "--output_dir", eval_out])
            with open(os.path.join(eval_out, f"epoch_{steps}_L8_org.txt")) as fp:
                scored = json.load(fp)["SYN"]["seq0"]
            if rc != 0 or not all(math.isfinite(v) for v in scored.values()):
                raise AssertionError(f"eval CLI on the trained {name} checkpoint: rc {rc}, {scored}")
            rows[name] = {
                "train_flags": flags, "steps": steps, "losses": [r["loss"] for r in log],
                "ms_per_step_after_first": 1e3 * float(np.mean([r["seconds"] for r in log[1:]])),
                "ms_per_step": [1e3 * r["seconds"] for r in log],
                "data_ms_per_step_after_first": 1e3 * float(np.mean([r["data_seconds"] for r in log[1:]])),
                "cli_seconds": seconds, "max_memory_allocated_gib": peak_gb, "launches": launches,
                "eval_of_checkpoint": scored,
            }
            if name == "flagship":
                flagship_args = model_args

        # one profiled step (warm) of the flagship configuration
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("BDE2VID", flagship_args, train=True)
        optimizer, _, clip, _ = build_optimizer(model.parameters(), optimizer_cfg)
        comp = SequenceLossComputer([{"type": "L1Loss"}])
        batch = next(iterate_training_windows(data, TRAIN_SEQ_LEN, 5, data_cfg, multiple=8,
                                              ltype="MMP"))
        drop = torch.Generator(device="cuda").manual_seed(1)

        def step():
            train_step(model, optimizer, comp, *batch, generator=drop, grad_clip=clip)["loss"].item()

        step()
        prof = device_profile(torch, step)
        del model, optimizer
    long_rows = long_buffer_steps(torch, launch_counts)
    emit({"phase": "train", "card": card, "sequence_length": TRAIN_SEQ_LEN, "items": items,
          "crop_hw": list(batch[0].shape[-2:]), "configs": rows, "flagship_profiled_step": prof,
          "long_buffers": long_rows})
    return (rows["flagship"]["launches"]["attn_core_backward"],
            long_rows["flagship"]["launches"]["attn_core_backward_long_rows"])


def long_buffer_steps(torch, launch_counts):
    """A train-mode step with remat of the flagship with 21 buffer frames
    (buffer_index -10..10, N 1029) and of the 8x8 config with 17 (N 1088), at
    184x240, T=3: the kernel path (B2 on its tiled backward, long rows; each block's
    forward twice, in the step and in its recompute) vs the unfused path
    (compare_grads), with the kernel path's step ms and peak memory, and
    both without remat beside them. Returns a row per configuration."""
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer

    T = 3
    rng = np.random.default_rng(7)
    vox = torch.from_numpy(rng.normal(size=(T, 1, 5, 184, 240)).astype(np.float32)).cuda()
    tgt = torch.from_numpy(rng.uniform(size=(T, 1, 1, 184, 240)).astype(np.float32)).cuda()
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    rows = {}
    for name, base in (("flagship", FLAGSHIP_CFG), ("8x8", EIGHT_CFG)):
        frames = LONG_FRAMES[name]
        cfg = model_config(base, remat=True)
        cfg["generator"].update(buffer_index=list(range(-(frames // 2), frames // 2 + 1)),
                                drop_path_rate=0.0)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(7)
            model = build_model("BDE2VID", cfg, train=True)
        _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, True)  # warm-up
        ms, peak_gb = {}, {}
        for remat in (False, True):  # the step's time and peak memory without remat, then with
            model.generator.remat = remat
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss_k, grads_k, launches = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts,
                                                        True)
            ms[remat] = 1e3 * (time.perf_counter() - t0)
            peak_gb[remat] = torch.cuda.max_memory_allocated() / 2**30
        want = {k: 2 * n * T for k, n in PER_FRAME[name].items()}
        want["attn_core_backward_long_rows"] = sum(PER_FRAME[name].values()) * T  # one per block
        expect_launches(f"long buffer {name}", launches, want)
        loss_u, grads_u, _ = _loss_and_grads(torch, model, comp, vox, tgt, launch_counts, False)
        win = base["generator"]["window_size"][0]
        rows[name] = {"frames": frames, "keys": frames * win * win, "T": T, "hw": [184, 240],
                      "kernel_path_step_ms": ms[True], "max_memory_allocated_gib": peak_gb[True],
                      "no_remat_step_ms": ms[False], "no_remat_max_memory_allocated_gib": peak_gb[False],
                      "launches": launches,
                      **compare_grads(f"long buffer {name}", loss_k, grads_k, loss_u, grads_u)}
        del model
    return rows


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
    long_cases = phase_kernels_long_rows(torch)
    block_cases, attn_cases = phase_kernels_window(torch)
    attn_launches = phase_attention(torch, launch_counts)
    phase_model(torch, launch_counts)
    phase_parallel(torch, launch_counts)
    eval_launches = phase_eval(torch, launch_counts, card)
    phase_step_models(torch, launch_counts, card)
    phase_packing(torch, card)
    phase_grads(torch, launch_counts)
    phase_variants(torch, launch_counts)
    bwd_launches, long_launches = phase_train(torch, launch_counts, card)
    tiled_fwd_cases, tiled_bwd_cases = phase_kernels_key_tiles(torch)
    tiled_fwd_launches, tiled_bwd_launches = phase_key_tiles(torch, launch_counts)
    wide_cases = phase_kernels_head_dims(torch)
    wide_launches = phase_head_dims(torch, launch_counts)

    def per_frame(cases, key, blocks):
        # f32, per frame of the configuration: ``blocks`` launches per level,
        # shared evenly among the cases (layouts) listed for that level
        vals = [c[key] for c in cases]
        if any(v is None for v in vals):
            return None
        per_level = {lvl: sum(c["level"] == lvl for c in cases) for lvl in blocks}
        return sum(c[key] * blocks[c["level"]] / per_level[c["level"]] for c in cases)

    def summary(name, source, line, cases, n_launches, blocks, library):
        f32 = [c for c in cases if c["dtype"] == "float32"]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": f"bde2vid_tpu/ops/window_attn_pallas.py:{line}",
            "launches": n_launches,
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": per_frame(f32, "kernel_ms", blocks),
            "plain_ms": per_frame(f32, "plain_ms", blocks),
            "bound_ms": per_frame(f32, "bound_ms", blocks),
            "bound_by": "operations" if all(c["bound_by"] == "operations" for c in f32) else "bytes",
            "library_ms": per_frame(f32, "library_ms", blocks) if library else None,
        }

    # times per frame in f32: B1 and B2 per flagship frame (4 + 6 launches),
    # B2's long rows per frame of the flagship with 21 buffer frames, B3 per
    # 8x8 frame (its 2 + 3 even dilated blocks, without acc), B4 at the same
    # 8x8 shapes, and the two key-tiled variants per frame of the flagship
    # with 31 buffer frames (its 6 level-2 blocks; the forward timed as the
    # bare core, the kernel B1's attention stage runs there), and the wide
    # backward per level-2 frame of the flagship with num_heads 4 and 2 (6
    # launches, the mean of head_dim 64 and 128 at C 256)
    no_acc = [c for c in block_cases if not c["with_acc"]]
    attn_8 = [c for c in attn_cases if c["config"] == "8x8"]
    emit({"kernels": [
        summary("fused_swin_block", "bde2vid_tpu_torch/ops/csrc/swin_block.cu", 654, cases,
                eval_launches["flagship"]["fused_swin_block"], BLOCKS_PER_FRAME, False),
        summary("attn_core_backward", "bde2vid_tpu_torch/ops/csrc/attn_core_bwd.cu", 271,
                bwd_cases, bwd_launches, BLOCKS_PER_FRAME, True),
        summary("attn_core_backward_long_rows", "bde2vid_tpu_torch/ops/csrc/attn_core_bwd.cu", 271,
                long_cases, long_launches, BLOCKS_PER_FRAME, True),
        summary("fused_window_block", "bde2vid_tpu_torch/ops/csrc/window_block.cu", 377, no_acc,
                eval_launches["8x8"]["fused_window_block"], BLOCKS_PER_FRAME_8, False),
        summary("fused_window_attention", "bde2vid_tpu_torch/ops/csrc/window_attention.cu", 89,
                attn_8, attn_launches, BLOCKS_PER_FRAME_8, True),
        summary("attn_forward_key_tiles", "bde2vid_tpu_torch/ops/csrc/window_common.cuh", 89,
                tiled_fwd_cases, tiled_fwd_launches, {"level2": 6}, True),
        summary("attn_core_backward_key_tiles", "bde2vid_tpu_torch/ops/csrc/attn_core_bwd.cu", 271,
                tiled_bwd_cases, tiled_bwd_launches, {"level2": 6}, True),
        summary("attn_core_backward_wide", "bde2vid_tpu_torch/ops/csrc/attn_core_bwd.cu", 271,
                wide_cases, wide_launches, {"level2": 6}, True),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
