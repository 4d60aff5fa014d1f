#!/usr/bin/env python3
"""Drive the PyTorch port (bde2vid_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--only scale_out|scale_out_torchrun|spatial]

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
  backends the other event backends (ROADMAP A11) on one synthetic 180x240
           recording written as MMP, ENPY (raw NPY) and NPY (pre-voxelized
           by the NumPy oracle on the host): ENPY voxels bit-equal to MMP's
           on the card under deterministic algorithms, NPY's within 1e-5 of
           the card's; k_events (with and without a sliding window),
           t_seconds and HFR windows (k_framerate 3) on the card within 1e-5
           of the CPU, with their voxel ms; the eval CLI with the flagship
           checkpoint (f32, subseq_L 8) over MMP, ENPY and NPY, frames/s and
           exact launches (ENPY's scores within 1e-6 of MMP's on the chunks
           both hold whole, NPY's within 1e-4); the flagship's weights as
           epoch_1.pth and as the JAX package's epoch_1.msgpack in one
           weights directory: equal state dicts, and one eval CLI call
           scoring both bit-equal; then the train CLI resumed from each for
           2 steps under deterministic algorithms, losses bit-equal, exact B1
           and B2 launches
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
           device-idle share), validating every 3 steps on 2 windows of a
           second sequence and writing its full train state, with
           --prefetch 0 and 2 (data ms share), one timed validation round,
           the 8x8 config for 3 steps, and the flagship with "train" bf16,
           remat and both for 6 steps each; finite losses, exact launch
           counts (validation's B1 launches too), checkpoints (best.pth
           too) the eval CLI scores; under deterministic algorithms the
           flagship for 6 steps, resumed from its epoch_3.state and run with
           --prefetch 2, each bit-equal to it (losses, weights, train
           state; the ops without a deterministic version listed); then
           E2VIDRecurrent at the released widths, FireNet and EVSNN for 3
           steps each through the CLI (no hand kernel); then a remat train
           step of the flagship with 21 buffer frames and of the 8x8 config
           with 17, kernel path (B2's long rows) vs unfused path
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
  lpips    LPIPS (ROADMAP A9) with seeded weights, alex, vgg and squeeze:
           card vs CPU at 180x240 (1e-5 relative), one 32-frame chunk timed
           beside its bound; on seeded alex.pth / lin.pth files the eval CLI
           with p_loss on the flagship checkpoint (f32 and --bf16, beside the
           runs without it; each frame's p_loss within 1e-5 of the port's
           LPIPS on the same prediction, 230 B1 launches for 23 items) and
           the train CLI on the flagship for 6 steps with [L1,
           PerceptualLoss] at loss_inds 2, [L1, VIPLoss] and L1 alone (finite
           losses, 480 B1 and 480 B2 launches each, ms per step, peak memory)
  serving  the serving CLI (ROADMAP A12): a flagship checkpoint exported
           at full width (180x240, padded to 184x240), f32, kernel path, at
           --T 4 (the CLI's default 16 traces 136 frames at export: 16 for
           the forward and 1..15 for the exact tails; 4 traces 10), and an
           E2VIDRecurrent template checkpoint at the released widths; each
           bundle runs the eval phase's 23-item recording through `serving
           run` (BDE2VID: 5 chunks of 4 and a 3-frame tail), held to the eval
           driver's forward at subseq_L 4 (step model: run_sequence) on the
           same voxels (2e-4); 230 B1 launches for the flagship and none for
           E2VIDRecurrent, 10 swin_block nodes a frame in each flagship
           program; export seconds, bundle bytes and serving frames/s beside
           the eval CLI's at subseq_L 4
  scale_out  data-parallel training, chunk-sharded eval and data-parallel
           serving (ROADMAP A8 item 6, A12) over torch.distributed: two
           spawned ranks on one gloo group on the one card (one NCCL rank a
           card where there are several, `--only scale_out`, and then the
           three CLIs as `torchrun` starts them, each held to one process),
           after the collectives on CUDA tensors are checked: the flagship's
           data-parallel train step (T=8, 176x240, batch 2, one window a
           rank, no clip) held to one process's step on the same batch on
           rank 0 and the last rank (loss 1e-6; by the relative L2 of all
           of them, weights 1e-5 and Adam's first moments 1e-2); the eval CLI
           with --shard_data on a flagship checkpoint over a 23-item
           recording at subseq_L 8 (two chunks and a 7-item tail) held to
           the one-process CLI's files (1e-6), and the eval driver timed
           alone; a --dp 2 flagship bundle at batch 2 (--T 4) held to a
           --dp 1 bundle (1e-6); exact B1 and B2 launches on every rank;
           step ms, the gradient all_reduce's ms, frames/s of both
  spatial  the row-sharded forward and train step (ROADMAP A16, A17) over
           spawned ranks on a (1, ranks) mesh: two gloo ranks on the one
           card (halos staged through host memory; one NCCL rank a card
           where there are several, `--only spatial`), after the halo
           exchange on CUDA tensors is checked: spatial_forward of the
           flagship and the 8x8 config at 184x240 and of the flagship at
           720x1280 (a 1280x720 camera), T=8, held to one process's forward
           (1e-5), and one flagship train step at T=4 (loss 1e-6 relative;
           by relative L2, gradients 1e-3 and the weights after Adam's step
           1e-5); exact B1 / B3 / B2 launches a rank; then SPADE-E2VID,
           EITR, EVSNN and PAEVSNN at their published widths, T=2: the
           forward at both sizes and one train step at 184x240, held to one
           process (EVSNN and PAEVSNN by the SNN gate of step_models, with
           the flipped spikes of every rank's bands counted, and their step
           within its relative L2 bound; EITR by the flagship's bars,
           SPADE-E2VID's ill-conditioned step by gradients 1e-2 and weights
           5e-5, its one-process spread printed beside them); forward and
           step ms, peak memory, halo exchanges and bytes, group reductions
           and token gathers of each rank beside one process's, and the
           B1 / B3 windows a launch of each rank's band
  events   the event side (ROADMAP A11) at 180x240 with 150 000 events:
           the event images, drv planes, timestamp images, flow warp and
           voxel helpers card vs CPU (1e-5 relative) with their ms; every
           cmax objective's value and gradient card vs CPU (1e-4) on a
           moving texture; one optimize_contrast on the card recovering the
           texture's velocity within 2 px/s (seconds, evaluations); the rows
           of bench_voxel; no hand-written kernel launches (rosbag and the
           h5 paths need h5py, absent on a card's machine: CPU tests only)
  deform   AlignAdd2 (ROADMAP A10) at C 64 on 92x120, the flagship's level-0
           features: card vs CPU (1e-5), forward and forward+backward ms;
           no hand-written kernel launches

Then the kernel summary line, the card's name and power limit, and
{"ok": true, "device": {...}} as the last line. TF32 is off for matmuls and
convolutions, so f32 comparisons are exact-f32 on both sides.
"""

from __future__ import annotations

import collections
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
# the flagship's train runs validate every VAL_EVERY steps on VAL_WINDOWS
# held-out windows; the deterministic pair resumes from epoch_RESUME_AT.state
VAL_EVERY, VAL_WINDOWS, RESUME_AT = 3, 2, 3
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
# the step models the train phase trains through the CLI, STEP_TRAIN_STEPS steps each
STEP_TRAIN = {"E2VIDRecurrent": E2VID_WIDTHS, "FireNet": FIRENET_WIDTHS, "EVSNN": {"num_bins": 5}}
STEP_TRAIN_STEPS = 3
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


def write_checkpoint(torch, folder, cfg, cfg_text, seed=1):
    """``folder``/epoch_1.pth: a BDE2VID of ``cfg`` with weights from ``seed``,
    in the mmengine layout the eval CLI loads; returns ``folder``."""
    from bde2vid_tpu_torch.models import build_model

    torch.manual_seed(seed)
    model = build_model("BDE2VID", cfg)
    os.makedirs(folder)
    torch.save({"meta": {"cfg": cfg_text},
                "state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
               os.path.join(folder, "epoch_1.pth"))
    return folder


def phase_eval(torch, launch_counts, card):
    """The eval CLI on one synthetic sequence: a flagship checkpoint (f32 and
    --bf16, cold and warm, and one profiled f32 run) and an 8x8 checkpoint
    (f32 and --bf16). Every run packs its events through the native packer,
    one batch a subseq_L chunk; the profiled run copies them from pinned
    memory (its HtoD copies by kind). Returns the launches of the f32 runs
    (the main path)."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
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
            weights = write_checkpoint(torch, os.path.join(tmp, "weights_" + name), cfg, cfg_text)
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


# the windowing policies the backends phase voxelizes on the card and the
# CPU over the synthetic recording (24 frames of 40000 events, ~0.96 s)
BACKEND_POLICIES = {
    "k_events": {"voxel_method": {"method": "k_events", "k": 40000}},
    "k_events_sliding": {"voxel_method": {"method": "k_events", "k": 40000,
                                          "sliding_window_w": 20000}},
    "t_seconds": {"voxel_method": {"method": "t_seconds", "t": 0.04}},
    "hfr_k3": {"k_framerate": 3},
}


def write_enpy_sequence(path, mmp):
    """The memmap recording ``mmp`` in the raw-NPY layout: the same events
    (uint8 0/1 polarity) and frames, one explicit window a frame, the events
    before it; returns its items (one a frame)."""
    from bde2vid_tpu_torch.data.windowing import between_frames_windows
    from bde2vid_tpu_torch.events.tools import MemMapEventReader

    r = MemMapEventReader(mmp)
    os.makedirs(os.path.join(path, "events"))
    os.makedirs(os.path.join(path, "frames"))
    for name, a in (("xs", r.xy[:, 0]), ("ys", r.xy[:, 1]), ("ts", r.t), ("ps", r.p)):
        np.save(os.path.join(path, "events", f"{name}.npy"), np.asarray(a))
    np.save(os.path.join(path, "frames", "frames.npy"), np.asarray(r.images)[..., 0])
    np.savetxt(os.path.join(path, "frames", "frame_ts.txt"), r.frame_ts)
    np.savetxt(os.path.join(path, "frames", "frame_event_idxes.txt"),
               between_frames_windows(r.frame_event_indices), fmt="%d")
    return r.num_frames


def phase_backends(torch, launch_counts, card):
    """The other event backends (ROADMAP A11) on one synthetic 180x240
    recording written as MMP, ENPY and NPY (the NPY voxels made by the NumPy
    oracle on the host): ENPY voxels on the card bit-equal to MMP's under
    deterministic algorithms, NPY's within 1e-5 of the card's; k_events with
    and without a sliding window, t_seconds and HFR windows on the card
    within 1e-5 of the CPU; the eval CLI with the flagship checkpoint over
    each layout (ENPY within 1e-6 of MMP on the chunks both hold whole, NPY
    within 1e-4); the flagship's weights as epoch_1.pth beside
    epoch_1.msgpack, loaded alike and scored bit-equal in one CLI call; and
    2 train steps resumed from each, bit-equal. Launch counts exact."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.eval.checkpoint import _DERIVED, load_model_from_torch, load_torch_file
    from bde2vid_tpu_torch.eval.msgpack_checkpoint import load_msgpack_checkpoint, save_msgpack_checkpoint
    from bde2vid_tpu_torch.events.tools import MemMapEventReader, write_prevoxelized_npy

    voxels, layouts, msgpack, resume = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data = os.path.join(tmp, "data")
        paths = {"MMP": os.path.join(data, "mmp", "SYN", "seq0"),
                 "ENPY": os.path.join(data, "npy", "SYN", "raw0"),
                 "NPY": os.path.join(data, "npy", "SYN", "vox0")}
        items = write_mmp_sequence(paths["MMP"], np.random.default_rng(1))
        n_items = {"MMP": items, "ENPY": write_enpy_sequence(paths["ENPY"], paths["MMP"]),
                   "NPY": items}
        t0 = time.perf_counter()
        write_prevoxelized_npy(MemMapEventReader(paths["MMP"]), paths["NPY"])
        voxels["npy_oracle_host_seconds"] = time.perf_counter() - t0

        # voxels: ENPY vs MMP bit for bit, NPY's oracle vs the card
        with deterministic_algorithms(torch) as alerts:
            got = {k: load_sequence(p, ltype=k).voxels() for k, p in paths.items()}
        torch.cuda.synchronize()
        if len(got["ENPY"]) != items + 1 or not torch.equal(got["ENPY"][:items], got["MMP"]):
            raise AssertionError(f"ENPY voxels differ from MMP's on the card "
                                 f"({len(got['ENPY'])} vs {items} items), alerts {sorted(alerts)}")
        npy_diff = (got["NPY"] - got["MMP"]).abs().max().item()
        if not npy_diff <= 1e-5:
            raise AssertionError(f"NPY oracle voxels {npy_diff} from the card's, want <= 1e-5")
        voxels.update({"enpy_vs_mmp_bit_equal": True, "npy_oracle_max_abs_diff": npy_diff,
                       "deterministic_alerts": sorted(alerts)})
        for name, kw in (("between_frames_mmp", {}), *BACKEND_POLICIES.items()):
            seq = load_sequence(paths["MMP"], ltype="MMP", **kw)
            card_v = seq.voxels()
            diff = (card_v.cpu() - seq.voxels(device="cpu")).abs().max().item()
            if not diff <= 1e-5:
                raise AssertionError(f"{name} voxels: card {diff} from the CPU, want <= 1e-5")
            ms = cuda_ms(torch, seq.voxels, iters=3, warmup=1)
            voxels[name] = {"windows": len(seq.windows), "max_abs_diff_card_vs_cpu": diff,
                            "overlapping": bool((seq.windows[1:, 0] < seq.windows[:-1, 1]).any()),
                            "ms": ms, "ms_per_window": ms / len(seq.windows)}

        # the eval CLI over each layout
        weights = write_checkpoint(torch, os.path.join(tmp, "weights"), FLAGSHIP_CFG,
                                   FLAGSHIP_CFG_TEXT)
        detail = {}
        for layout, path in paths.items():
            out_dir = os.path.join(tmp, "out_" + layout)
            seq_name = os.path.basename(path)
            torch.cuda.synchronize()
            launch_counts.clear()
            t0 = time.perf_counter()
            rc = eval_main(["--weights_dir", weights, "--data_dir", data, "--datasets", seq_name,
                            "--loader_type", layout, "--metrics", "mse", "ssim",
                            "--subseq_L", "8", "--output_dir", out_dir])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            n = n_items[layout]
            expect_launches(f"eval CLI ({layout})", dict(launch_counts), {"fused_swin_block": 10 * n})
            with open(os.path.join(out_dir, "epoch_1_L8_org_detail.txt")) as fp:
                detail[layout] = json.load(fp)["SYN"][seq_name]
            if rc != 0 or any(len(v) != n or not all(map(math.isfinite, v))
                              for v in detail[layout].values()):
                raise AssertionError(f"eval CLI ({layout}): rc {rc}, {detail[layout]}")
            layouts[layout] = {"items": n, "seconds": seconds, "frames_per_s": n / seconds,
                               "launches": dict(launch_counts)}
        whole = min(n_items.values()) // 8 * 8  # the chunks of 8 both hold whole
        for layout, bound, upto in (("ENPY", 1e-6, whole), ("NPY", 1e-4, items)):
            diff = max(abs(a - b) for m in ("mse", "ssim")
                       for a, b in zip(detail[layout][m][:upto], detail["MMP"][m][:upto]))
            if not diff <= bound:
                raise AssertionError(f"eval CLI ({layout}): scores {diff} from MMP's, want <= {bound}")
            layouts[layout].update({"max_abs_diff_vs_mmp": diff, "items_compared": upto})

        # the flagship's weights as .pth and .msgpack in one weights directory
        both = os.path.join(tmp, "weights_both")
        write_checkpoint(torch, both, FLAGSHIP_CFG, FLAGSHIP_CFG_TEXT)
        save_msgpack_checkpoint(os.path.join(both, "epoch_1.msgpack"),
                                load_torch_file(os.path.join(both, "epoch_1.pth"))["state_dict"],
                                "BDE2VID", FLAGSHIP_CFG)
        sd_pth = load_model_from_torch(os.path.join(both, "epoch_1.pth")).module.state_dict()
        sd_msg = load_msgpack_checkpoint(os.path.join(both, "epoch_1.msgpack")).module.state_dict()
        compared = [k for k in sd_pth if not any(p.search(k) for p in _DERIVED)]
        if sd_pth.keys() != sd_msg.keys() or not all(torch.equal(sd_pth[k], sd_msg[k])
                                                     for k in compared):
            raise AssertionError("the .msgpack and the .pth load different state dicts")
        out_dir = os.path.join(tmp, "out_both")
        with deterministic_algorithms(torch) as alerts:
            launch_counts.clear()
            rc = eval_main(["--weights_dir", both, "--data_dir", data, "--datasets", "seq0",
                            "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", "8",
                            "--output_dir", out_dir])
            torch.cuda.synchronize()
        expect_launches("eval CLI (.pth and .msgpack)", dict(launch_counts),
                        {"fused_swin_block": 2 * 10 * items})
        scored = {}
        for fmt in ("pth", "msgpack"):
            for kind in ("", "_detail"):
                with open(os.path.join(out_dir, f"epoch_1_{fmt}_L8_org{kind}.txt")) as fp:
                    scored[fmt + kind] = json.load(fp)
        if rc != 0 or scored["pth"] != scored["msgpack"] \
                or scored["pth_detail"] != scored["msgpack_detail"]:
            raise AssertionError(f"eval CLI: .msgpack and .pth scores differ: {scored}, "
                                 f"alerts {sorted(alerts)}")
        msgpack.update({"state_dict_tensors_equal": len(compared),
                        "state_dict_tensors_derived": len(sd_pth) - len(compared),
                        "file_bytes": os.path.getsize(os.path.join(both, "epoch_1.msgpack")),
                        "scores": scored["pth"]["SYN"]["seq0"], "alerts": sorted(alerts)})

        # 2 train steps resumed from each, under deterministic algorithms
        logs = {}
        with deterministic_algorithms(torch) as alerts:
            for fmt in ("msgpack", "pth"):
                log, launches, seconds, peak_gb, _ = train_cli_run(
                    torch, launch_counts, tmp, data, "resume_" + fmt, "BDE2VID",
                    model_config(FLAGSHIP_CFG), 2, {},
                    ["--resume", os.path.join(both, f"epoch_1.{fmt}")])
                expect_launches(f"train CLI (--resume .{fmt})", launches,
                                {"fused_swin_block": 10 * 2 * TRAIN_SEQ_LEN,
                                 "attn_core_backward": 10 * 2 * TRAIN_SEQ_LEN})
                logs[fmt] = log
                resume[fmt] = train_row(log, launches, seconds, peak_gb)
        loss_keys = lambda log: [{k: v for k, v in r.items() if k.startswith("L") or k == "loss"}
                                 for r in log]
        compare_states(torch, "losses resumed from .msgpack and .pth", loss_keys(logs["msgpack"]),
                       loss_keys(logs["pth"]), set())
        resume["alerts"] = sorted(alerts)
    emit({"phase": "backends", "card": card, "items": items, "hw": [180, 240], "subseq_L": 8,
          "voxels": voxels, "eval_cli": layouts, "msgpack": msgpack, "train_resume": resume})


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


def lif_fired_share(torch, spikes):
    """The share of LIF units that fired at least once in ``spikes``, the
    firings of whole bins in call order (``SNN_LIF_CALLS`` a bin)."""
    fired = [torch.zeros_like(spikes[k]) for k in range(SNN_LIF_CALLS)]
    for k, spike in enumerate(spikes):
        fired[k % SNN_LIF_CALLS] |= spike
    return sum(int(f.sum()) for f in fired) / sum(f.numel() for f in fired)


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
    fire_share = lif_fired_share(torch, cpu_spikes)
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


def run_eval_cli(torch, launch_counts, weights, data, out_dir, subseq, stem, items, extra=(),
                 metrics=("mse", "ssim")):
    """One eval CLI run (with ``extra`` arguments) over the MMP tree on the
    checkpoints in ``weights``: (seconds, result, detail, launches) of
    checkpoint ``stem``, whose result must hold ``metrics``, finite, with one
    detail entry an item."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main

    args = ["--weights_dir", weights, "--data_dir", data, "--datasets", "SYN",
            "--loader_type", "MMP", "--metrics", *metrics, "--subseq_L", str(subseq),
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
    if not (os.path.exists(base + "_table.txt") and set(result) == set(metrics)
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


def val_steps(steps):
    """The steps after which a run of ``steps`` steps validates: every
    VAL_EVERY and at the end."""
    return [s for s in range(1, steps + 1) if s % VAL_EVERY == 0 or s == steps]


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside;
    yields a set that holds, on leaving, the first line of each alert that an
    op without a deterministic version raised."""
    import warnings

    alerts = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield alerts
        finally:
            torch.use_deterministic_algorithms(False)
            alerts.update(str(w.message).strip().splitlines()[0][:240] for w in caught
                          if "determinis" in str(w.message))


def state_leaves(tree, prefix=""):
    """Every tensor and number of a nested checkpoint or train state, by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(state_leaves(v, f"{prefix}/{k}"))
    return out


def compare_states(torch, what, a, b, alerts):
    """Bit equality of two nested states; where ops without a deterministic
    version ran (``alerts``), within 2e-4 instead. Returns the max abs diff."""
    la, lb = state_leaves(a), state_leaves(b)
    if la.keys() != lb.keys():
        raise AssertionError(f"{what}: keys differ: {sorted(la.keys() ^ lb.keys())[:8]}")
    worst = 0.0
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape:
                raise AssertionError(f"{what}: {k} {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
            if not torch.equal(x, y):
                worst = max(worst, float((x.double() - y.double()).abs().max())
                            if x.is_floating_point() else math.inf)
        elif x != y:
            worst = max(worst, abs(x - y) if isinstance(x, float) else math.inf)
    if worst and (not alerts or worst > 2e-4):
        raise AssertionError(f"{what}: not bit-equal (max abs diff {worst}), alerts {sorted(alerts)}")
    return worst


TRAIN_DATA_CFG = {"sequence_length": TRAIN_SEQ_LEN, "num_bins": 5,
                  "proba_pause_when_running": 0.05, "proba_pause_when_paused": 0.9,
                  "noise_std": 0.1, "noise_fraction": 0.05,
                  "hot_pixel_std": 2.0, "max_hot_pixel_fraction": 0.001}
TRAIN_OPTIMIZER_CFG = {"type": "Adam", "args": {"lr": 1e-4, "grad_clip": 1.0}}


def train_cli_run(torch, launch_counts, tmp, data, name, model_type, model_args, steps, flags,
                  cli=(), ckpt_every=1000, losses=({"type": "L1Loss"},), loss_inds=None):
    """One train CLI run on the MMP tree ``data`` (TRAIN_DATA_CFG, Adam):
    its log, launches, wall seconds, peak GiB and out dir; every logged loss
    must be finite."""
    from bde2vid_tpu_torch.train.__main__ import main as train_main

    cfg = {"name": name, "model": {"type": model_type, "args": model_args},
           "losses": list(losses), "loss_inds": loss_inds, "optimizer": TRAIN_OPTIMIZER_CFG,
           "data": TRAIN_DATA_CFG, "train": {"steps": steps, "ckpt_every": ckpt_every, **flags}}
    cfg_path = os.path.join(tmp, f"cfg_{name}.json")
    with open(cfg_path, "w") as fp:
        json.dump(cfg, fp)
    out_dir = os.path.join(tmp, "run_" + name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    t0 = time.perf_counter()
    rc = train_main(["--config", cfg_path, "--data_dir", data, "--out_dir", out_dir,
                     "--loader_type", "MMP", *cli])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(out_dir, "train_log.jsonl")) as fp:
        log = [json.loads(line) for line in fp]
    first = int(log[0]["step"]) if log else -1
    if rc != 0 or [r["step"] for r in log] != list(range(first, steps)) \
            or not all(math.isfinite(v) for r in log for k, v in r.items() if k.startswith("L")
                       or k == "loss"):
        raise AssertionError(f"train CLI ({name}): rc {rc}, log {log}")
    return log, launches, seconds, peak_gb, out_dir


def train_row(log, launches, seconds, peak_gb, **extra):
    return {
        "steps": len(log), "losses": [r["loss"] for r in log],
        "ms_per_step_after_first": 1e3 * float(np.mean([r["seconds"] for r in log[1:]])),
        "ms_per_step": [1e3 * r["seconds"] for r in log],
        "data_ms_per_step_after_first": 1e3 * float(np.mean([r["data_seconds"] for r in log[1:]])),
        "cli_seconds": seconds, "max_memory_allocated_gib": peak_gb, "launches": launches,
        **extra,
    }


def phase_train(torch, launch_counts, card):
    """The training path: the train CLI on the MMP sequence for the flagship
    (6 steps, validating on a held-out sequence every 3 steps, full train
    states) with --prefetch 0 and 2, the 8x8 config (3 steps), the
    flagship's bf16, remat and both, each checkpoint scored by the eval CLI,
    one timed validation round and one profiled flagship train step; then,
    under deterministic algorithms, the flagship for 6 steps, resumed from
    its epoch_3.state and run with --prefetch 2, each bit-equal to it; then
    E2VIDRecurrent at the released widths, FireNet and EVSNN. Returns the
    flagship run's launches of the attention-core backward."""
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.models import build_model
    from bde2vid_tpu_torch.train import SequenceLossComputer, build_optimizer, train_step
    from bde2vid_tpu_torch.train.__main__ import iterate_training_windows
    from bde2vid_tpu_torch.train.validate import Validator

    data_cfg, optimizer_cfg = TRAIN_DATA_CFG, TRAIN_OPTIMIZER_CFG
    rows = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data = os.path.join(tmp, "data")
        items = write_mmp_sequence(os.path.join(data, "mmp", "SYN", "seq0"), np.random.default_rng(4))
        val = os.path.join(tmp, "val")
        write_mmp_sequence(os.path.join(val, "mmp", "SYN", "seq1"), np.random.default_rng(5))
        val_flags = ["--val_dir", val, "--val_every", str(VAL_EVERY), "--val_windows",
                     str(VAL_WINDOWS), "--save_state"]

        def train_run(name, model_type, model_args, steps, flags, cli=(), ckpt_every=1000):
            return train_cli_run(torch, launch_counts, tmp, data, name, model_type, model_args,
                                 steps, flags, cli, ckpt_every)

        def score(name, out_dir, stems):
            """The eval CLI over a run's checkpoints: each one's scores."""
            eval_out = os.path.join(tmp, "eval_" + name)
            rc = eval_main(["--weights_dir", out_dir, "--data_dir", data, "--datasets", "SYN",
                            "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", "8",
                            "--output_dir", eval_out])
            scored = {}
            for stem in stems:
                with open(os.path.join(eval_out, f"{stem}_L8_org.txt")) as fp:
                    scored[stem] = json.load(fp)["SYN"]["seq0"]
            if rc != 0 or not all(math.isfinite(v) for sc in scored.values() for v in sc.values()):
                raise AssertionError(f"eval CLI on the trained {name} checkpoints: rc {rc}, {scored}")
            return scored

        for name, base, steps, flags, cli in (
                ("flagship", FLAGSHIP_CFG, TRAIN_STEPS, {}, val_flags),
                ("flagship_prefetch2", FLAGSHIP_CFG, TRAIN_STEPS, {}, val_flags + ["--prefetch", "2"]),
                ("8x8", EIGHT_CFG, TRAIN_STEPS_8X8, {}, []),
                ("flagship_bf16", FLAGSHIP_CFG, TRAIN_STEPS, {"bf16": True}, []),
                ("flagship_remat", FLAGSHIP_CFG, TRAIN_STEPS, {"remat": True}, []),
                ("flagship_bf16_remat", FLAGSHIP_CFG, TRAIN_STEPS, {"bf16": True, "remat": True}, [])):
            model_args = model_config(base)
            model_args["generator"]["drop_path_rate"] = 0.2
            log, launches, seconds, peak_gb, out_dir = train_run(name, "BDE2VID", model_args, steps,
                                                                 flags, cli)
            # remat runs each block's forward twice: in the step and in its recompute
            forwards = 2 if flags.get("remat") else 1
            rounds = len(val_steps(steps)) if "--val_dir" in cli else 0
            want = {k: n * TRAIN_SEQ_LEN * (forwards * steps + VAL_WINDOWS * rounds)
                    for k, n in PER_FRAME[name.split("_")[0]].items()}
            want["attn_core_backward"] = 10 * steps * TRAIN_SEQ_LEN
            expect_launches(f"train CLI ({name})", launches, want)
            stems = [f"epoch_{steps}"]
            extra = {"train_flags": flags, "cli_flags": cli}
            if rounds:
                stems.append("best")
                with open(os.path.join(out_dir, "val_log.jsonl")) as fp:
                    recs = [json.loads(line) for line in fp]
                if [r["step"] for r in recs] != val_steps(steps) \
                        or not all(math.isfinite(r["mse"]) and math.isfinite(r["ssim"]) for r in recs):
                    raise AssertionError(f"train CLI ({name}) validation log: {recs}")
                extra["validation"] = recs
                extra["state_file_bytes"] = os.path.getsize(os.path.join(out_dir, f"epoch_{steps}.state"))
            extra["eval_of_checkpoints"] = score(name, out_dir, stems)
            rows[name] = train_row(log, launches, seconds, peak_gb, **extra)
            if name == "flagship":
                flagship_args = model_args
        for name in ("flagship", "flagship_prefetch2"):
            r = rows[name]
            r["data_share"] = r["data_ms_per_step_after_first"] / r["ms_per_step_after_first"]
        # the two runs differ in the voxelizer's float atomics only
        rows["flagship_prefetch2"]["loss_max_abs_diff_vs_prefetch0"] = max(
            abs(a - b) for a, b in zip(rows["flagship"]["losses"], rows["flagship_prefetch2"]["losses"]))

        # one validation round of the flagship (2 windows of 8 frames), timed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("BDE2VID", flagship_args, train=True)
        validator = Validator("BDE2VID", flagship_args, val, seq_len=TRAIN_SEQ_LEN, num_bins=5,
                              windows=VAL_WINDOWS, multiple=8, ltype="MMP")
        launch_counts.clear()
        round_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            validator(model)
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
        expect_launches("validation rounds", dict(launch_counts),
                        {"fused_swin_block": 3 * 10 * TRAIN_SEQ_LEN * VAL_WINDOWS})
        validation_round = {"windows": VAL_WINDOWS, "T": TRAIN_SEQ_LEN, "seconds": round_s}

        # one profiled step (warm) of the flagship configuration
        optimizer, _, clip, _ = build_optimizer(model.parameters(), optimizer_cfg)
        comp = SequenceLossComputer([{"type": "L1Loss"}])
        batch = next(iterate_training_windows(data, TRAIN_SEQ_LEN, 5, data_cfg, multiple=8,
                                              ltype="MMP"))
        drop = torch.Generator(device="cuda").manual_seed(1)

        def step():
            train_step(model, optimizer, comp, *batch, generator=drop, grad_clip=clip)["loss"].item()

        step()
        prof = device_profile(torch, step)
        del model, optimizer, validator

        # exact resume and prefetch under deterministic algorithms
        det = {}
        with deterministic_algorithms(torch) as alerts:
            full = train_run("flagship_det", "BDE2VID", flagship_args, TRAIN_STEPS, {},
                             ["--save_state"], ckpt_every=RESUME_AT)
            state = os.path.join(full[4], f"epoch_{RESUME_AT}.state")
            resumed = train_run("flagship_det_resumed", "BDE2VID", flagship_args, TRAIN_STEPS, {},
                                ["--save_state", "--resume", state], ckpt_every=RESUME_AT)
            prefetched = train_run("flagship_det_prefetch2", "BDE2VID", flagship_args, TRAIN_STEPS,
                                   {}, ["--prefetch", "2"], ckpt_every=RESUME_AT)
        for name, run, steps in (("flagship_det", full, TRAIN_STEPS),
                                 ("flagship_det_resumed", resumed, TRAIN_STEPS - RESUME_AT),
                                 ("flagship_det_prefetch2", prefetched, TRAIN_STEPS)):
            expect_launches(f"train CLI ({name})", run[1],
                            {"fused_swin_block": 10 * steps * TRAIN_SEQ_LEN,
                             "attn_core_backward": 10 * steps * TRAIN_SEQ_LEN})
            det[name] = train_row(*run[:4])
        if [r["step"] for r in resumed[0]] != list(range(RESUME_AT, TRAIN_STEPS)):
            raise AssertionError(f"resumed run: {resumed[0]}")
        loss_keys = lambda log: [{k: v for k, v in r.items() if k.startswith("L") or k == "loss"}
                                 for r in log]
        load = lambda run, f: torch.load(os.path.join(run[4], f), map_location="cpu",
                                         weights_only=False)
        final = f"epoch_{TRAIN_STEPS}"
        det["resume_max_abs_diff"] = {
            "losses": compare_states(torch, "resumed losses", loss_keys(resumed[0]),
                                     loss_keys(full[0][RESUME_AT:]), alerts),
            "weights": compare_states(torch, "resumed weights", load(resumed, final + ".pth"),
                                      load(full, final + ".pth"), alerts),
            "train_state": compare_states(torch, "resumed train state", load(resumed, final + ".state"),
                                          load(full, final + ".state"), alerts),
        }
        det["prefetch_max_abs_diff"] = {
            "losses": compare_states(torch, "prefetched losses", loss_keys(prefetched[0]),
                                     loss_keys(full[0]), alerts),
            "weights": compare_states(torch, "prefetched weights", load(prefetched, final + ".pth"),
                                      load(full, final + ".pth"), alerts),
        }
        det["alerts"] = sorted(alerts)
        det["state_file_bytes"] = os.path.getsize(os.path.join(full[4], final + ".state"))

        # the step models train through the same CLI, on no hand-written kernel
        steps_rows = {}
        for name, args in STEP_TRAIN.items():
            log, launches, seconds, peak_gb, out_dir = train_run(name, name, dict(args),
                                                                 STEP_TRAIN_STEPS, {})
            expect_launches(f"train CLI ({name})", launches, {})
            steps_rows[name] = train_row(log, launches, seconds, peak_gb, config=args,
                                   eval_of_checkpoints=score(name, out_dir,
                                                             [f"epoch_{STEP_TRAIN_STEPS}"]))
    long_rows = long_buffer_steps(torch, launch_counts)
    emit({"phase": "train", "card": card, "sequence_length": TRAIN_SEQ_LEN, "items": items,
          "crop_hw": list(batch[0].shape[-2:]), "configs": rows,
          "validation_round": validation_round, "flagship_profiled_step": prof,
          "deterministic": det, "step_models": steps_rows, "long_buffers": long_rows})
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


LPIPS_NETS = ("alex", "vgg", "squeeze")
# frame pairs each net is held to card vs CPU on (the CPU's VGG at 180x240
# costs ~3 s a pair), and the bound: max |card - CPU| over max |CPU|
LPIPS_PAIRS, LPIPS_REL = 4, 1e-5


def seeded_lpips_state(torch, net, seed):
    """(lin, backbone) state dicts of seeded random LPIPS weights in the
    LPIPS (``lin{k}.model.1.weight``) and torchvision (``features.*``)
    layouts: fan-in-scaled normal kernels, small biases, heads in [0, 1]."""
    from bde2vid_tpu_torch.metrics.lpips import LPIPS

    rng = np.random.default_rng(seed)
    module = LPIPS(net)
    backbone = {}
    for key, v in module.backbone.state_dict().items():
        shape = tuple(v.shape)
        scale = 1.0 / np.sqrt(np.prod(shape[1:])) if key.endswith("weight") else 0.05
        backbone[key] = torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))
    lin = {f"lin{k}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 1, (1, w.shape[1], 1, 1)).astype(np.float32))
        for k, w in enumerate(module.lin_weights())}
    return lin, backbone


def lpips_chunk_cost(torch, net, g, p):
    """(FLOPs, bytes) of one call of ``net`` on the pair: the convolutions'
    FLOPs (torch's counter), each input read and each weight read once and
    the distances written once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        out = net(g, p)
    weights = sum(t.numel() * t.element_size() for t in net.parameters())
    return counter.get_total_flops(), 2 * p.numel() * 4 + weights + out.numel() * 4


def phase_lpips(torch, launch_counts, card):
    """LPIPS and what rests on it (ROADMAP A9, A6's p_loss, A8 item 7). Each
    net (alex, vgg, squeeze) with seeded weights on the card vs the CPU at
    180x240 (LPIPS_PAIRS pairs, LPIPS_REL) and one 32-frame chunk timed
    beside its bound; then seeded alex.pth (torchvision layout) and lin.pth
    (LPIPS layout) files, and on the MMP sequence with a flagship checkpoint
    the eval CLI with ``--metrics p_loss mse ssim --lpips_lin --lpips_backbone``
    (f32 and --bf16) beside the same runs without p_loss: p_loss in the
    result files, each frame's within 1e-5 of the port's LPIPS on the same
    prediction and target, 230 B1 launches for 23 items; then the train CLI
    on the flagship for 6 steps with [L1, PerceptualLoss] at loss_inds 2,
    with [L1, VIPLoss] and with L1 alone: finite losses, exact B1 and B2
    launches, ms per step and peak memory."""
    from bde2vid_tpu_torch.eval import driver
    from bde2vid_tpu_torch.metrics.lpips import load_lpips_state, lpips_distance, to_pm1_3ch

    h, w, chunk = 180, 240, driver.LPIPS_CHUNK
    rng = np.random.default_rng(9)
    pred, gt = (torch.from_numpy(rng.uniform(size=(chunk, 1, h, w)).astype(np.float32))
                for _ in range(2))
    nets = {}
    for i, name in enumerate(LPIPS_NETS):
        lin, backbone = seeded_lpips_state(torch, name, seed=30 + i)
        cpu_net = load_lpips_state(lin, backbone, name, device="cpu")
        card_net = load_lpips_state(lin, backbone, name)
        p3, g3 = to_pm1_3ch(pred.cuda(), True), to_pm1_3ch(gt.cuda(), True)
        with torch.no_grad():
            want = cpu_net(to_pm1_3ch(gt[:LPIPS_PAIRS], True), to_pm1_3ch(pred[:LPIPS_PAIRS], True))
            got = card_net(g3[:LPIPS_PAIRS], p3[:LPIPS_PAIRS]).cpu()
            rel = (got - want).abs().max().item() / want.abs().max().item()
            ms = cuda_ms(torch, lambda: card_net(g3, p3), iters=10)
        if not (torch.isfinite(got).all() and rel <= LPIPS_REL):
            raise AssertionError(f"LPIPS {name}: card vs CPU relative {rel} (bound {LPIPS_REL})")
        flops, nbytes = lpips_chunk_cost(torch, card_net, g3, p3)
        nets[name] = {"card_vs_cpu_rel": rel, "pairs": LPIPS_PAIRS, "chunk_frames": chunk,
                      "ms_per_chunk": ms, "ms_per_frame": ms / chunk,
                      "gflop_per_frame": flops / chunk / 1e9,
                      "bound_ms_per_chunk": 1e3 * max(flops / PEAK_FLOPS["float32"],
                                                      nbytes / PEAK_BYTES),
                      "bound_by": "operations" if flops / PEAK_FLOPS["float32"] >= nbytes / PEAK_BYTES
                      else "bytes"}
        del cpu_net, card_net

    evals, trains = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        data = os.path.join(tmp, "data")
        items = write_mmp_sequence(os.path.join(data, "mmp", "SYN", "seq0"), np.random.default_rng(1))
        lin, backbone = seeded_lpips_state(torch, "alex", seed=30)
        lin_path, backbone_path = os.path.join(tmp, "lin.pth"), os.path.join(tmp, "alex.pth")
        torch.save(lin, lin_path)
        torch.save(backbone, backbone_path)
        weights = write_checkpoint(torch, os.path.join(tmp, "weights"), FLAGSHIP_CFG,
                                   FLAGSHIP_CFG_TEXT)
        net = load_lpips_state(lin, backbone)
        lpips_flags = ["--lpips_lin", lin_path, "--lpips_backbone", backbone_path]
        captured = []
        p_loss = driver._p_loss

        def recording_p_loss(lpips, preds, gts):
            captured.append((preds.clone(), gts.clone()))
            return p_loss(lpips, preds, gts)

        driver._p_loss = recording_p_loss
        try:
            # the first run warms the path up; then without and with p_loss in turns
            for run in ("f32_p_loss_first", "f32", "f32_p_loss", "f32_p_loss_2", "f32_2", "bf16",
                        "bf16_p_loss"):
                with_p = "p_loss" in run
                extra = (["--bf16"] if run.startswith("bf16") else []) + (lpips_flags if with_p else [])
                metrics = ("p_loss", "mse", "ssim") if with_p else ("mse", "ssim")
                seconds, result, detail, launches = run_eval_cli(
                    torch, launch_counts, weights, data, os.path.join(tmp, "eval_" + run), 8,
                    "epoch_1", items, extra, metrics)
                expect_launches(f"eval CLI ({run})", launches, {"fused_swin_block": 10 * items})
                row = {"seconds": seconds, "frames_per_s": items / seconds, "launches": launches,
                       **result}
                if with_p:
                    preds, gts = captured.pop()
                    with torch.no_grad():
                        alone = [lpips_distance(net, p[None, None], g[None, None]).item()
                                 for p, g in zip(preds, gts)]
                    diff = max(abs(a - b) for a, b in zip(alone, detail["p_loss"]))
                    if not (len(alone) == items and diff <= 1e-5):
                        raise AssertionError(f"eval CLI ({run}): p_loss {detail['p_loss']} vs "
                                             f"LPIPS frame by frame {alone}: {diff}")
                    row["p_loss_vs_lpips_max_abs_diff"] = diff
                evals[run] = row
        finally:
            driver._p_loss = p_loss

        model_args = model_config(FLAGSHIP_CFG)
        model_args["generator"]["drop_path_rate"] = 0.2
        for name, losses, loss_inds in (
                ("l1", [{"type": "L1Loss"}], None),
                ("perceptual", [{"type": "L1Loss"}, {"type": "PerceptualLoss"}], 2),
                ("vip", [{"type": "L1Loss"}, {"type": "VIPLoss"}], None)):
            log, launches, seconds, peak_gb, _ = train_cli_run(
                torch, launch_counts, tmp, data, name, "BDE2VID", model_args, TRAIN_STEPS, {},
                [] if name == "l1" else lpips_flags, losses=losses, loss_inds=loss_inds)
            n = 10 * TRAIN_SEQ_LEN * TRAIN_STEPS
            expect_launches(f"train CLI ({name})", launches,
                            {"fused_swin_block": n, "attn_core_backward": n})
            trains[name] = train_row(log, launches, seconds, peak_gb, losses_cfg=losses,
                                     loss_inds=loss_inds, loss_terms=log[-1])
    emit({"phase": "lpips", "card": card, "hw": [h, w], "nets": nets, "items": items,
          "eval": evals, "train": trains})


# the serving phase's --T (the CLI's default 16 traces 136 frames at export)
SERVING_T = 4


def op_nodes(torch, bundle):
    """{program: {operator: nodes}} of the port's kernel operators."""
    from bde2vid_tpu_torch.ops.window_attn_cuda import OP_NAMESPACE

    out = {}
    for name, ep in bundle.functions.items():
        nodes = collections.Counter(
            str(n.target).split(".")[1] for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith(OP_NAMESPACE + "."))
        out[name] = dict(nodes)
    return out


def phase_serving(torch, launch_counts, card):
    """The serving CLI: export a flagship checkpoint (kernel path, f32, --T
    SERVING_T) and an E2VIDRecurrent one at the released widths, run each
    bundle over the 23-item recording, hold the images to the eval driver's
    forward at subseq_L SERVING_T (step model: ``run_sequence``) on the same
    voxels, count launches and operator nodes, and time export, serving and
    the eval CLI."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
    from bde2vid_tpu_torch.models import run_sequence
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.serving import load_bundle
    from bde2vid_tpu_torch.serving.__main__ import main as serving_main, serve
    from bde2vid_tpu_torch.utils.padding import CropParameters

    rows = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        seq_dir = os.path.join(tmp, "data", "mmp", "SYN", "seq0")
        items = write_mmp_sequence(seq_dir, np.random.default_rng(1))
        vox = load_sequence(seq_dir, ltype="MMP").voxels(device="cuda")  # (T, C, H, W)
        vpath = os.path.join(tmp, "voxels.npy")
        np.save(vpath, vox.permute(0, 2, 3, 1).cpu().numpy())  # the JAX CLI's (T, H, W, C)
        weights = write_checkpoint(torch, os.path.join(tmp, "weights_BDE2VID"), FLAGSHIP_CFG,
                                   FLAGSHIP_CFG_TEXT)
        e2vid = os.path.join(tmp, "weights_E2VIDRecurrent")
        os.makedirs(e2vid)
        torch.save({"arch": "E2VIDRecurrent",
                    "config": {"arch": {"args": {"unet_kwargs": E2VID_WIDTHS}}},
                    "state_dict": seeded_step_model(torch, "E2VIDRecurrent", E2VID_WIDTHS,
                                                    3).state_dict()},
                   os.path.join(e2vid, "model.pth"))
        plan = (("BDE2VID", os.path.join(weights, "epoch_1.pth"), {"fused_swin_block": 10}),
                ("E2VIDRecurrent", os.path.join(e2vid, "model.pth"), {}))
        for name, ckpt, per_frame in plan:
            bundle_path = os.path.join(tmp, name + ".zip")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = serving_main(["export", "--weights", ckpt, "--out", bundle_path,
                               "--hw", "180", "240", "--T", str(SERVING_T), "--pallas"])
            export_s = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"serving export ({name}) returned {rc}")
            bundle = load_bundle(bundle_path)
            nodes = op_nodes(torch, bundle)
            for prog, got in nodes.items():
                frames = (SERVING_T if prog == "forward" else int(prog.rsplit("_", 1)[1])
                          if prog.startswith("forward_tail_") else 0)
                want = {"swin_block": 10 * frames} if per_frame else {}
                if got != want:
                    raise AssertionError(f"serving ({name}) program {prog}: operator nodes "
                                         f"{got}, want {want}")
            out_npy = os.path.join(tmp, name + "_images.npy")
            runs = []
            for _ in range(2):  # cold (the programs' first calls), then warm
                torch.cuda.synchronize()
                launch_counts.clear()
                t0 = time.perf_counter()
                rc = serving_main(["run", "--bundle", bundle_path, "--voxels", vpath,
                                   "--out_npy", out_npy, "--out_dir", os.path.join(tmp, "png")])
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
                if rc != 0:
                    raise AssertionError(f"serving run ({name}) returned {rc}")
                expect_launches(f"serving run ({name})", launch_counts,
                                {k: n * items for k, n in per_frame.items()})
            t0 = time.perf_counter()
            serve(bundle, vox[:, None])  # deserialises and builds the programs it calls
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            serve(bundle, vox[:, None])
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            # where a warm serve's time goes; its HtoD copies (the voxels are
            # on the card already, the index maps are program constants)
            profile = device_profile(torch, lambda: serve(bundle, vox[:, None]), top=8)
            got = torch.from_numpy(np.load(out_npy)).cuda()  # (T, 1, 180, 240)

            # the eval driver's forward on the same voxels: chunks of
            # SERVING_T, padded with its CropParameters, cropped back
            spec = load_model_from_torch(ckpt, device="cuda")
            set_attention_kernel(spec.module, True)
            crop = CropParameters(240, 180, spec.num_encoders)
            x = crop.pad(vox[:, None])
            with torch.no_grad():
                if spec.is_sequence_model:
                    want = torch.cat([spec.module(x[s:s + SERVING_T])["image"]
                                      for s in range(0, items, SERVING_T)])
                else:
                    want = run_sequence(spec.module, x, spec.initial_state(
                        1, crop.height_crop_size, crop.width_crop_size))[0]
            diff = (got - crop.crop(want)[:, :, 0]).abs().max().item()
            if not (torch.isfinite(got).all() and got.shape == (items, 1, 180, 240)
                    and diff <= 2e-4):
                raise AssertionError(f"serving ({name}): {tuple(got.shape)}, max diff {diff} "
                                     "vs the eval driver's forward (bound 2e-4)")
            out_dir = os.path.join(tmp, "eval_" + name)
            t0 = time.perf_counter()
            rc = eval_main(["--weights_dir", os.path.dirname(ckpt),
                            "--data_dir", os.path.join(tmp, "data"), "--datasets", "SYN",
                            "--loader_type", "MMP", "--metrics", "mse",
                            "--subseq_L", str(SERVING_T), "--output_dir", out_dir])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"eval CLI ({name}) returned {rc}")
            rows[name] = {
                "export_seconds": export_s, "bundle_bytes": os.path.getsize(bundle_path),
                "programs": sorted(bundle.functions), "operator_nodes": nodes,
                "launches": {k: n * items for k, n in per_frame.items()},
                "max_abs_diff_vs_eval_forward": diff,
                "run_cli_seconds": runs, "run_cli_frames_per_s": [items / r for r in runs],
                "serve_first_call_seconds": first_s, "serve_frames_per_s": items / serve_s,
                "serve_profile": profile,
                "eval_cli_seconds": eval_s, "eval_cli_frames_per_s": items / eval_s,
            }
    emit({"phase": "serving", "card": card, "items": items, "hw": [180, 240],
          "exported_hw": [184, 240], "T": SERVING_T, "runs": rows})


EVENTS_HW = (180, 240)
EVENTS_N = 150_000
TEXTURE_V = (160.0, -100.0)  # px/s, the moving texture's planted velocity
DEFORM_C, DEFORM_HW = 64, (92, 120)  # the flagship's level-0 width and feature size at 184x240


def events_180x240(seed):
    """EVENTS_N events over 180x240: float coordinates (some out of range),
    sorted ts over 50 ms, +-1 polarity; numpy."""
    rng = np.random.default_rng(seed)
    h, w = EVENTS_HW
    xs = rng.uniform(-2, w + 2, EVENTS_N).astype(np.float32)
    ys = rng.uniform(-2, h + 2, EVENTS_N).astype(np.float32)
    ts = np.sort(rng.uniform(0, 0.05, EVENTS_N)).astype(np.float32)
    ps = rng.choice(np.array([-1.0, 1.0], np.float32), EVENTS_N)
    return xs, ys, ts, ps


def moving_texture(seed, points=1500, duration=0.05):
    """EVENTS_N events of a texture of ``points`` dots translating at
    TEXTURE_V over ``duration`` s (0.3 px of jitter), those inside the
    sensor kept; positive polarity."""
    rng = np.random.default_rng(seed)
    h, w = EVENTS_HW
    p0 = np.stack([rng.uniform(10, w - 10, points), rng.uniform(10, h - 10, points)], 1)
    k = rng.integers(0, points, EVENTS_N)
    ts = np.sort(rng.uniform(0, duration, EVENTS_N))
    xs = p0[k, 0] + TEXTURE_V[0] * ts + rng.normal(0, 0.3, EVENTS_N)
    ys = p0[k, 1] + TEXTURE_V[1] * ts + rng.normal(0, 0.3, EVENTS_N)
    keep = (xs >= 0) & (xs < w - 1) & (ys >= 0) & (ys < h - 1)
    return (xs[keep].astype(np.float32), ys[keep].astype(np.float32), ts[keep].astype(np.float32),
            np.ones(int(keep.sum()), np.float32))


def rel_err(got, want):
    """max |got - want| over max |want|, tensors or tuples of them."""
    if isinstance(want, (tuple, list)):
        return max(rel_err(g, w) for g, w in zip(got, want))
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def phase_events(torch, launch_counts, card):
    """The event side (ROADMAP A11) at 180x240 with EVENTS_N events: each
    event image and voxel helper on the card vs the CPU (1e-5 relative;
    ``index_add`` adds in no fixed order on the card) with its CUDA-event
    ms; each cmax objective's value and gradient on the card vs the CPU
    (1e-4 relative) with the ms of one value and gradient; one
    ``optimize_contrast`` (variance, blur 1) on the card from (0, 0) on a
    moving texture, within 2 px/s of TEXTURE_V, with its seconds and
    evaluations; and bench_voxel's rows. No hand-written kernel may launch.
    rosbag and the h5 paths need h5py and stay in the CPU tests."""
    from bde2vid_tpu_torch.events import bench_voxel, cmax
    from bde2vid_tpu_torch.events import voxel as tv

    launch_counts.clear()
    xs, ys, ts, ps = events_180x240(40)
    *bufs, n = tv.pad_events(xs, ys, ts, ps)
    rng = np.random.default_rng(41)
    cpu = {k: torch.from_numpy(v) for k, v in zip(("xs", "ys", "ts", "ps"), bufs)}
    cpu.update(ix=cpu["xs"].floor().int(), iy=cpu["ys"].floor().int(),
               jx=torch.from_numpy(rng.normal(size=(2, len(bufs[0]))).astype(np.float32)),
               jy=torch.from_numpy(rng.normal(size=(2, len(bufs[0]))).astype(np.float32)),
               flow=torch.from_numpy(rng.normal(size=EVENTS_HW + (2,)).astype(np.float32) * 50))
    card_in = {k: v.cuda() for k, v in cpu.items()}
    images = {
        "events_to_image": lambda a: tv.events_to_image(a["ix"], a["iy"], a["ps"], n,
                                                        sensor_size=EVENTS_HW),
        "events_to_image_bilinear": lambda a: tv.events_to_image_bilinear(
            a["xs"], a["ys"], a["ps"], n, sensor_size=EVENTS_HW),
        "events_to_image_drv": lambda a: tv.events_to_image_drv(
            a["xs"], a["ys"], a["ps"], a["jx"], a["jy"], n, sensor_size=EVENTS_HW),
        "events_to_timestamp_image": lambda a: tv.events_to_timestamp_image(
            a["xs"], a["ys"], a["ts"], a["ps"], n, sensor_size=EVENTS_HW),
        "warp_events_by_flow": lambda a: tv.warp_events_by_flow(
            a["xs"].clamp(0, EVENTS_HW[1] - 1), a["ys"].clamp(0, EVENTS_HW[0] - 1), a["ts"],
            a["flow"], n_events=n),
        "events_to_voxel_accumulate": lambda a: tv.events_to_voxel_accumulate(
            a["ix"], a["iy"], a["ts"], a["ps"], n, sensor_size=EVENTS_HW),
    }
    stream = (np.clip(xs, 0, EVENTS_HW[1] - 1).astype(np.int32),
              np.clip(ys, 0, EVENTS_HW[0] - 1).astype(np.int32), ts.astype(np.float64), ps)
    host = {
        "voxel_grids_fixed_n": lambda d: tv.voxel_grids_fixed_n(*stream, num_bins=5, n=16384,
                                                                sensor_size=EVENTS_HW, device=d),
        "voxel_grids_fixed_t": lambda d: tv.voxel_grids_fixed_t(*stream, num_bins=5, t=0.005,
                                                                sensor_size=EVENTS_HW, device=d),
        "events_to_voxel_timesync": lambda d: tv.events_to_voxel_timesync(
            *stream, num_bins=5, t0=0.01, t1=0.03, sensor_size=EVENTS_HW, device=d),
    }
    rows = {}
    for name, fn in images.items():
        err = rel_err(fn(card_in), fn(cpu))
        if not err <= 1e-5:
            raise AssertionError(f"events: {name} card vs CPU {err}")
        rows[name] = {"rel_err": err, "ms": cuda_ms(torch, lambda: fn(card_in), iters=10)}
    for name, fn in host.items():
        got, want = fn("cuda"), fn("cpu")
        if isinstance(got, list) and len(got) != len(want):
            raise AssertionError(f"events: {name} made {len(got)} grids, the CPU {len(want)}")
        err = rel_err(got, want)
        if not err <= 1e-5:
            raise AssertionError(f"events: {name} card vs CPU {err}")
        rows[name] = {"rel_err": err, "ms_from_numpy": cuda_ms(torch, lambda: fn("cuda"), iters=3),
                      "grids": len(got) if isinstance(got, list) else 1}

    tex = moving_texture(42)
    *tbufs, tn = tv.pad_events(*tex)
    tcpu = [torch.from_numpy(b) for b in tbufs]
    tcard = [b.cuda() for b in tcpu]
    objectives = {}
    for name in list(cmax.OBJECTIVES) + ["zhu"]:
        f = cmax.objective_fn(name, EVENTS_HW, True, None if name == "zhu" else 1.0)

        def value_and_grad(ev, dev):
            p = torch.tensor([0.8 * TEXTURE_V[0], 0.8 * TEXTURE_V[1]], device=dev,
                             requires_grad=True)
            v = f(p, *ev, tn)
            return (v,) + torch.autograd.grad(v, p)

        got, want = value_and_grad(tcard, "cuda"), value_and_grad(tcpu, "cpu")
        err = rel_err(got, want)
        if not err <= 1e-4:
            raise AssertionError(f"events: cmax {name} card vs CPU {err}")
        objectives[name] = {"rel_err": err, "value": want[0].item(),
                            "ms": cuda_ms(torch, lambda: value_and_grad(tcard, "cuda"), iters=5)}
    t0 = time.perf_counter()
    out = cmax.optimize_contrast(*tex, objective="variance", img_size=EVENTS_HW, blur_sigma=1.0,
                                 device="cuda", full_output=True)
    seconds = time.perf_counter() - t0
    est = [float(v) for v in out[0]]
    if not max(abs(e - v) for e, v in zip(est, TEXTURE_V)) <= 2.0:
        raise AssertionError(f"events: optimize_contrast found {est}, planted {TEXTURE_V}")
    optimize = {"estimate": est, "planted": list(TEXTURE_V), "seconds": seconds,
                "function_evaluations": int(out[4]), "gradient_evaluations": int(out[5]),
                "warnflag": int(out[6]), "events": int(tn)}
    bench = bench_voxel.run(*bench_voxel.synthetic_events(EVENTS_N, EVENTS_HW), EVENTS_HW, 5, 20,
                            torch.device("cuda"))
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts.items() if v}
    if launches:
        raise AssertionError(f"events: hand-written kernels launched: {launches}")
    emit({"phase": "events", "card": card, "hw": list(EVENTS_HW), "events": EVENTS_N,
          "functions": rows, "cmax": objectives, "optimize_contrast": optimize,
          "bench_voxel": bench, "launches": launches})


def phase_deform(torch, launch_counts, card):
    """AlignAdd2 (ROADMAP A10) at C DEFORM_C on DEFORM_HW, 2 deform groups,
    seeded weights with offsets of about a pixel: card vs CPU (1e-5
    relative, TF32 off), forward ms and a forward and backward's ms on the
    card, peak memory; no hand-written kernel may launch."""
    import copy

    from bde2vid_tpu_torch.nn.deform import AlignAdd2

    launch_counts.clear()
    torch.manual_seed(50)
    model = AlignAdd2(2 * DEFORM_C, DEFORM_C, deform_groups=2)
    for prm in model.parameters():
        torch.nn.init.normal_(prm, std=0.02)
    feats = torch.from_numpy(np.random.default_rng(51).normal(
        size=(1, 2 * DEFORM_C) + DEFORM_HW).astype(np.float32))
    card_model = copy.deepcopy(model).cuda()
    fd = feats.cuda()
    with torch.no_grad():
        want, got = model(feats), card_model(fd)
        offsets = model.pack.conv_offset(feats)
    err = rel_err(got, want)
    if not (err <= 1e-5 and torch.isfinite(got).all()):
        raise AssertionError(f"deform: AlignAdd2 card vs CPU {err}")

    def forward():
        with torch.no_grad():
            return card_model(fd)

    def train_step():
        card_model.zero_grad(set_to_none=True)
        card_model(fd.requires_grad_()).square().mean().backward()

    torch.cuda.reset_peak_memory_stats()
    row = {"C": DEFORM_C, "hw": list(DEFORM_HW), "deform_groups": 2, "rel_err": err,
           "offset_abs_mean": offsets.abs().mean().item(),
           "forward_ms": cuda_ms(torch, forward, iters=10),
           "forward_backward_ms": cuda_ms(torch, train_step, iters=5)}
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts.items() if v}
    if launches:
        raise AssertionError(f"deform: hand-written kernels launched: {launches}")
    emit({"phase": "deform", "card": card, **row, "launches": launches})


# --------------------------------------------------------------- scale_out

SCALE_OUT_T, SCALE_OUT_HW, SCALE_OUT_L, SCALE_OUT_STEPS = 8, (176, 240), 8, 2


def scale_out_layout(torch):
    """(ranks, backend, items) of the scale_out phase: two ranks on one gloo
    group on the one card (NCCL refuses two ranks on one device), or one rank
    a card on NCCL where there are several; 23 items (two full chunks of 8
    and a 7-item tail) for two ranks, else two chunks a rank and the tail."""
    cards = torch.cuda.device_count()
    if cards > 1:
        return cards, "nccl", 2 * SCALE_OUT_L * cards + 7
    return 2, "gloo", 23


def scale_out_batch(torch, ranks, seed=3):
    """The train batch: voxels (T, ranks, 5, H, W) and targets, on the host."""
    rng = np.random.default_rng(seed)
    h, w = SCALE_OUT_HW
    vox = rng.normal(size=(SCALE_OUT_T, ranks, 5, h, w)).astype(np.float32)
    tgt = rng.uniform(size=(SCALE_OUT_T, ranks, 1, h, w)).astype(np.float32)
    return torch.from_numpy(vox), torch.from_numpy(tgt)


def scale_out_model(torch):
    """The flagship in training mode, kernel path, DropPath off (the ranks'
    own DropPath streams would differ from one process's)."""
    from bde2vid_tpu_torch.models import build_model

    cfg = model_config(FLAGSHIP_CFG)
    cfg["generator"]["drop_path_rate"] = 0.0
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        return build_model("BDE2VID", cfg, train=True)


def scale_out_train_state(torch, model, opt):
    """The weights and Adam's first moments (``exp_avg``, (1 - b1) g after
    one step) by name, on the host."""
    return {"weights": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "moments": {k: opt.state[p]["exp_avg"].cpu() for k, p in model.named_parameters()
                        if p in opt.state}}


def rel_l2(torch, got, want):
    """(relative L2 of all of ``want``'s float tensors, the tensor furthest
    apart by its own relative L2, that distance)."""
    norms = {k: ((got[k].float() - v.float()).norm().item(), v.float().norm().item())
             for k, v in want.items() if v.is_floating_point()}
    total = math.sqrt(sum(d * d for d, _ in norms.values())
                      / sum(n * n for _, n in norms.values()))
    worst = max(norms, key=lambda k: norms[k][0] / max(norms[k][1], 1e-12))
    return total, worst, norms[worst][0] / max(norms[worst][1], 1e-12)


def timed_steps(torch, step, n):
    """Host ms of ``n`` calls of ``step()``, each synchronised."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def chunk_frames(items, chunk, ranks, index):
    """Frames that rank ``index`` runs in a sharded eval of a sequence model
    (``parallel.sharded_eval.ChunkPlan``: contiguous blocks of chunks, the
    ragged tail on the last rank)."""
    from bde2vid_tpu_torch.parallel.sharded_eval import ChunkPlan

    plan = ChunkPlan(items, chunk, ranks, True)
    tail = plan.t - plan.t_full if index == plan.tail_rank else 0
    return sum(b - a for a, b in plan.chunks(index)) + tail


def scale_out_rank(index, ranks, backend, tmp):
    """One rank of the scale_out phase (a spawned process): the collectives
    on CUDA tensors, a data-parallel train step, the eval CLI with
    --shard_data and the data-parallel bundle; writes rank<index>.json."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = index if backend == "nccl" else 0
    torch.cuda.set_device(card)
    kw = {"device_id": torch.device("cuda", card)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), ranks),
                            rank=index, world_size=ranks,
                            timeout=datetime.timedelta(seconds=600), **kw)
    try:
        out = {"rank": index, "card": card,
               "collectives": scale_out_collectives(torch, dist, index, ranks)}
        out["train"] = scale_out_rank_train(torch, dist, index, ranks, tmp)
        out["eval"] = scale_out_rank_eval(torch, index, tmp)
        out["serving"] = scale_out_rank_serving(torch, index, ranks, tmp)
        with open(os.path.join(tmp, f"rank{index}.json"), "w") as fp:
            json.dump(out, fp)
    finally:
        dist.destroy_process_group()


def scale_out_collectives(torch, dist, index, ranks):
    """all_reduce, broadcast and all_gather on CUDA tensors (the three the
    port's scale-out calls; gloo runs them on CUDA tensors too), checked."""
    x = torch.full((5,), float(index + 1), device="cuda")
    dist.all_reduce(x)
    b = torch.arange(5, device="cuda", dtype=torch.float32) * (index + 1)
    dist.broadcast(b, src=ranks - 1)
    parts = [torch.empty(3, device="cuda") for _ in range(ranks)]
    dist.all_gather(parts, torch.full((3,), float(index), device="cuda"))
    ok = (x.eq(ranks * (ranks + 1) / 2).all().item()
          and b.eq(torch.arange(5, device="cuda") * ranks).all().item()
          and all(p.eq(r).all().item() for r, p in enumerate(parts)))
    if not ok:
        raise AssertionError(f"rank {index}: collectives on CUDA tensors gave {x}, {b}, {parts}")
    return ["all_reduce", "broadcast", "all_gather"]


def scale_out_rank_train(torch, dist, index, ranks, tmp):
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts
    from bde2vid_tpu_torch.parallel import make_dp_train_step, shard_batch
    from bde2vid_tpu_torch.train import SequenceLossComputer

    model = scale_out_model(torch)
    model.load_state_dict(torch.load(os.path.join(tmp, "init.pt"), map_location="cpu",
                                     weights_only=True))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_dp_train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]))
    vox, tgt = (t.cuda() for t in shard_batch(None, scale_out_batch(torch, ranks), batch_axis=1))
    torch.cuda.synchronize()
    launch_counts.clear()
    loss = step(vox, tgt)["loss"].item()
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts.items() if v}
    if index in (0, ranks - 1):
        torch.save(scale_out_train_state(torch, model, opt),
                   os.path.join(tmp, f"dp_state{index}.pt"))
    ms = timed_steps(torch, lambda: step(vox, tgt), SCALE_OUT_STEPS)
    # the gradient all_reduce alone: one flat f32 buffer of every parameter
    flat = torch.ones(sum(p.numel() for p in model.parameters()), device="cuda")
    dist.all_reduce(flat)
    allreduce_ms = timed_steps(torch, lambda: dist.all_reduce(flat), 5)
    return {"loss": loss, "launches": launches, "step_ms": ms, "allreduce_ms": allreduce_ms,
            "grad_bytes": 4 * flat.numel(), "rows": int(vox.shape[1])}


def scale_out_rank_eval(torch, index, tmp):
    from bde2vid_tpu_torch.eval.__main__ import main as eval_main
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts

    runs = []
    for run in ("cold", "warm"):
        args = ["--weights_dir", os.path.join(tmp, "weights"), "--data_dir",
                os.path.join(tmp, "data"), "--datasets", "SYN", "--loader_type", "MMP",
                "--metrics", "mse", "ssim", "--subseq_L", str(SCALE_OUT_L), "--output_dir",
                os.path.join(tmp, f"sharded_{run}"), "--shard_data"]
        torch.cuda.synchronize()
        launch_counts.clear()
        t0 = time.perf_counter()
        if eval_main(args) != 0:
            raise AssertionError(f"rank {index}: eval CLI --shard_data failed")
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t0,
                     "launches": {k: v for k, v in launch_counts.items() if v}})
    return {"cli": runs, "driver_seconds": scale_out_driver_seconds(torch, tmp, True)}


def scale_out_driver_seconds(torch, tmp, shard):
    """Seconds of the eval driver's evaluate_sequence on the recording (the
    model loaded once, the second of two runs): the forward, the gathers
    and rank 0's scoring, without the CLI's checkpoint load."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence
    from bde2vid_tpu_torch.eval.checkpoint import load_model_from_torch
    from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_sequence
    from bde2vid_tpu_torch.nn.window_attention import set_attention_kernel
    from bde2vid_tpu_torch.parallel.mesh import barrier

    spec = load_model_from_torch(os.path.join(tmp, "weights", "epoch_1.pth"), device="cuda")
    set_attention_kernel(spec.module, True)
    seq = load_sequence(os.path.join(tmp, "data", "mmp", "SYN", "seq0"), ltype="MMP")
    cfg = EvalConfig(ltype="MMP", num_bins=spec.num_bins, subseq_L=SCALE_OUT_L,
                     metrics=("mse", "ssim"), shard_data=shard)
    seconds = []
    for _ in range(2):
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_sequence(spec, seq, cfg)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    seq.reader.close()
    return seconds


def scale_out_rank_serving(torch, index, ranks, tmp):
    from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts
    from bde2vid_tpu_torch.serving import load_bundle
    from bde2vid_tpu_torch.serving.__main__ import main as serving_main, serve

    path = os.path.join(tmp, f"dp{ranks}.zip")
    t0 = time.perf_counter()
    if serving_main(["run", "--bundle", path, "--voxels", os.path.join(tmp, "serve_vox.npy"),
                     "--out_npy", os.path.join(tmp, "serve_dp.npy")]) != 0:
        raise AssertionError(f"rank {index}: serving run failed")
    cli_s = time.perf_counter() - t0
    bundle = load_bundle(path)
    vox = torch.load(os.path.join(tmp, "serve_vox.pt"), weights_only=True).cuda()
    serve(bundle, vox)  # deserialises the programs it calls
    torch.cuda.synchronize()
    launch_counts.clear()
    ms = timed_steps(torch, lambda: serve(bundle, vox), 1)
    return {"cli_seconds": cli_s, "serve_ms": ms,
            "launches": {k: v for k, v in launch_counts.items() if v}}


def scale_out_inputs(torch, tmp, ranks, items):
    """The phase's recording (``items`` + 1 frames) and flagship checkpoint
    under ``tmp``, and the --dp 1 and --dp ``ranks`` bundles at batch
    ``ranks`` exporting in the background: (weights folder, exports)."""
    write_mmp_sequence(os.path.join(tmp, "data", "mmp", "SYN", "seq0"),
                       np.random.default_rng(5), num_frames=items + 1)
    weights = write_checkpoint(torch, os.path.join(tmp, "weights"), FLAGSHIP_CFG,
                               FLAGSHIP_CFG_TEXT)
    exports = {}
    for dp in (1, ranks):
        log = open(os.path.join(tmp, f"export_dp{dp}.log"), "w")
        cmd = [sys.executable, "-m", "bde2vid_tpu_torch.serving", "export", "--weights",
               os.path.join(weights, "epoch_1.pth"), "--out", os.path.join(tmp, f"dp{dp}.zip"),
               "--hw", "180", "240", "--T", str(SERVING_T), "--batch", str(ranks), "--dp",
               str(dp), "--pallas"]
        exports[dp] = (subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                       time.perf_counter(), log)
    return weights, exports


def scale_out_serve_voxels(torch, tmp, ranks):
    """The serving batch, the recording and its mirror images, (T, ranks, C,
    H, W) on the card; saved as serve_vox.pt and (T, N, H, W, C) .npy."""
    from bde2vid_tpu_torch.data.pipeline import load_sequence

    one = load_sequence(os.path.join(tmp, "data", "mmp", "SYN", "seq0"),
                        ltype="MMP").voxels(device="cuda")  # (T, C, H, W)
    serve_vox = torch.stack([one.flip(-1) if n % 2 else one for n in range(ranks)], dim=1)
    torch.save(serve_vox.cpu(), os.path.join(tmp, "serve_vox.pt"))
    np.save(os.path.join(tmp, "serve_vox.npy"), serve_vox.permute(0, 1, 3, 4, 2).cpu().numpy())
    return serve_vox


def wait_exports(exports):
    """Wait for scale_out_inputs' exports: {dp: seconds}; raises on a failed one."""
    seconds = {}
    for dp, (proc, t0, log) in exports.items():
        rc = proc.wait()
        seconds[dp] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            with open(log.name) as fp:
                raise AssertionError(f"scale_out: export --dp {dp} returned {rc}:\n{fp.read()}")
    return seconds


def scale_out_torchrun(torch, launch_counts, tmp, ranks, want_eval, want_images):
    """The documented launch on several cards: `torchrun --nproc_per_node
    ranks` starts NCCL ranks of each CLI, which join their group from the
    environment (`parallel.init_distributed`, a card a rank): the eval CLI
    with --shard_data held to the one-process files, the train CLI at
    --batch `ranks` for 2 steps held to the one-process CLI (weights by
    relative L2 1e-5, logged losses 1e-6 relative), and `serving run` of
    the --dp bundle held to --dp 1's images (``want_images()``, called
    last). Returns (row, failures)."""
    def torchrun(module, args):
        # the CLIs leave cuDNN's TF32 default (on); the references here run
        # with TF32 off, so the children get it off too
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", str(ranks), "-m", module, *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=600,
                             env={**os.environ, "NVIDIA_TF32_OVERRIDE": "0"})
        if res.returncode != 0:
            raise AssertionError(f"torchrun {module} returned {res.returncode}:\n"
                                 f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        return time.perf_counter() - t0

    failures, row = [], {}
    data = os.path.join(tmp, "data")
    out = os.path.join(tmp, "torchrun_eval")
    row["eval_seconds"] = torchrun("bde2vid_tpu_torch.eval", [
        "--weights_dir", os.path.join(tmp, "weights"), "--data_dir", data, "--datasets", "SYN",
        "--loader_type", "MMP", "--metrics", "mse", "ssim", "--subseq_L", str(SCALE_OUT_L),
        "--output_dir", out, "--shard_data"])
    base = os.path.join(out, f"epoch_1_L{SCALE_OUT_L}_org")
    with open(base + "_detail.txt") as fp:
        row["eval_max_diff"] = max_detail_diff(json.load(fp)["SYN"]["seq0"], want_eval)
    if not row["eval_max_diff"] <= 1e-6:
        failures.append(f"torchrun eval: {row['eval_max_diff']} from one process (bound 1e-6)")

    cfg = model_config(FLAGSHIP_CFG)
    cfg["generator"]["drop_path_rate"] = 0.0
    log, _, one_s, _, one_dir = train_cli_run(torch, launch_counts, tmp, data, "dp_one", "BDE2VID",
                                              cfg, 2, {}, cli=["--batch", str(ranks)])
    dp_dir = os.path.join(tmp, "run_dp_torchrun")
    row["train_seconds"] = torchrun("bde2vid_tpu_torch.train", [
        "--config", os.path.join(tmp, "cfg_dp_one.json"), "--data_dir", data, "--out_dir", dp_dir,
        "--loader_type", "MMP", "--batch", str(ranks)])
    row["train_one_process_seconds"] = one_s
    with open(os.path.join(dp_dir, "train_log.jsonl")) as fp:
        dp_log = [json.loads(line) for line in fp]
    row["train_loss_rel_diff"] = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                     for a, b in zip(dp_log, log))
    got, want = (torch.load(os.path.join(d, "epoch_2.pth"), weights_only=True)["state_dict"]
                 for d in (dp_dir, one_dir))
    keys = [k for k, v in want.items() if v.is_floating_point()]
    row["train_weight_rel_l2"] = math.sqrt(
        sum((got[k].float() - want[k].float()).norm().item() ** 2 for k in keys)
        / sum(want[k].float().norm().item() ** 2 for k in keys))
    if not (len(dp_log) == len(log) == 2 and row["train_loss_rel_diff"] <= 1e-6
            and row["train_weight_rel_l2"] <= 1e-5):
        failures.append(f"torchrun train: losses {row['train_loss_rel_diff']:.3g} (1e-6), weights "
                        f"{row['train_weight_rel_l2']:.3g} (1e-5) relative to one process")

    want = want_images()
    npy = os.path.join(tmp, "torchrun_serve.npy")
    row["serve_seconds"] = torchrun("bde2vid_tpu_torch.serving", [
        "run", "--bundle", os.path.join(tmp, f"dp{ranks}.zip"), "--voxels",
        os.path.join(tmp, "serve_vox.npy"), "--out_npy", npy])
    row["serve_max_diff"] = (torch.from_numpy(np.load(npy)) - want).abs().max().item()
    if not row["serve_max_diff"] <= 1e-6:
        failures.append(f"torchrun serving: {row['serve_max_diff']} from --dp 1 (bound 1e-6)")
    return row, failures


def phase_scale_out_torchrun(torch, launch_counts, card):
    """`--only scale_out_torchrun`, on several cards: the three CLIs as
    `torchrun` starts them (scale_out_torchrun) and the one-process runs
    they are held to, without the spawned ranks of phase_scale_out."""
    from bde2vid_tpu_torch.serving import load_bundle
    from bde2vid_tpu_torch.serving.__main__ import serve

    ranks, backend, items = scale_out_layout(torch)
    if backend != "nccl":
        raise SystemExit("--only scale_out_torchrun needs several cards")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        weights, exports = scale_out_inputs(torch, tmp, ranks, items)
        want_eval = run_eval_cli(torch, launch_counts, weights, os.path.join(tmp, "data"),
                                 os.path.join(tmp, "one"), SCALE_OUT_L, "epoch_1", items)[2]

        def want_images():
            serve_vox = scale_out_serve_voxels(torch, tmp, ranks)
            wait_exports(exports)
            return torch.from_numpy(serve(load_bundle(os.path.join(tmp, "dp1.zip")), serve_vox))

        row, failures = scale_out_torchrun(torch, launch_counts, tmp, ranks, want_eval,
                                           want_images)
    emit({"phase": "scale_out_torchrun", "card": card, "cards": torch.cuda.device_count(),
          "ranks": ranks, "backend": backend, "items": items,
          "seconds": time.perf_counter() - t_phase, "torchrun": row, "failures": failures})
    if failures:
        raise AssertionError("; ".join(failures))


def phase_scale_out(torch, launch_counts, card):
    """Data-parallel training, chunk-sharded eval and data-parallel serving
    (ROADMAP A8 item 6, A12) over a torch.distributed group of spawned ranks,
    each held to one process on the same inputs, with exact launch counts a
    rank; see scale_out_layout for the ranks."""
    import torch.multiprocessing as mp

    from bde2vid_tpu_torch.serving import load_bundle
    from bde2vid_tpu_torch.serving.__main__ import serve
    from bde2vid_tpu_torch.train import SequenceLossComputer, train_step

    ranks, backend, items = scale_out_layout(torch)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        weights, exports = scale_out_inputs(torch, tmp, ranks, items)

        # one process, while the exports run: the train step at batch `ranks`
        # and the eval CLI (held); nothing is timed before the exports end.
        # The held step takes no clip: a clip to norm 1 would give a gradient
        # that is wrong by a factor the right norm again
        model = scale_out_model(torch)
        torch.save(model.state_dict(), os.path.join(tmp, "init.pt"))
        vox, tgt = (t.cuda() for t in scale_out_batch(torch, ranks))
        comp = SequenceLossComputer([{"type": "L1Loss"}])
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        torch.cuda.synchronize()
        launch_counts.clear()
        ref_loss = train_step(model, opt, comp, vox, tgt)["loss"].item()
        torch.cuda.synchronize()
        expect_launches("scale_out one-process step", launch_counts,
                        {"fused_swin_block": 10 * SCALE_OUT_T, "attn_core_backward": 10 * SCALE_OUT_T})
        ref_state = scale_out_train_state(torch, model, opt)
        ref_eval = [run_eval_cli(torch, launch_counts, weights, os.path.join(tmp, "data"),
                                 os.path.join(tmp, "one_cold"), SCALE_OUT_L, "epoch_1", items)]
        serve_vox = scale_out_serve_voxels(torch, tmp, ranks)
        export_s = wait_exports(exports)

        # one process, timed: train steps at batch `ranks` and 1, the eval CLI
        # warm and the driver's evaluate_sequence warm, then the --dp 1 bundle
        ref_ms = {}
        for n in sorted({1, ranks}):
            v, t = vox[:, :n].contiguous(), tgt[:, :n].contiguous()
            ref_ms[n] = timed_steps(torch, lambda: train_step(model, opt, comp, v, t),
                                    SCALE_OUT_STEPS)
        del model, opt
        ref_eval.append(run_eval_cli(torch, launch_counts, weights, os.path.join(tmp, "data"),
                                     os.path.join(tmp, "one_warm"), SCALE_OUT_L, "epoch_1", items))
        for _, _, _, launches in ref_eval:
            expect_launches("scale_out one-process eval", launches,
                            {"fused_swin_block": 10 * items})
        ref_driver_s = scale_out_driver_seconds(torch, tmp, False)
        bundle = load_bundle(os.path.join(tmp, "dp1.zip"))
        want_images = torch.from_numpy(serve(bundle, serve_vox))  # (T, N, h, w)
        torch.cuda.synchronize()
        launch_counts.clear()
        ref_serve_ms = timed_steps(torch, lambda: serve(bundle, serve_vox), 1)
        expect_launches("scale_out one-process serving", launch_counts,
                        {"fused_swin_block": 10 * items})
        del bundle

        t_ranks = time.perf_counter()
        mp.start_processes(scale_out_rank, args=(ranks, backend, tmp), nprocs=ranks, join=True,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t_ranks
        got = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as fp:
                got.append(json.load(fp))

        # every gate is checked and the figures written before any failure raises
        failures = []

        def gate(what, fn):
            try:
                fn()
            except AssertionError as err:
                failures.append(f"{what}: {err}")

        # the train step, on rank 0 and the last rank: the loss, Adam's first
        # moments (0.1 g: a gradient averaged wrongly, or a rank's rows
        # missing, is off by 0.5 or more; the reduction orders and the
        # library's atomics move some tensors by ~1e-3) and the weights
        # (relative L2 of all of them: Adam's first step is about lr sign(g),
        # blind to the gradient's scale; a component near zero rounded to
        # the other sign moves its weight by 2 lr, most of a zero-initialised
        # bias's norm, so the tensor furthest apart is named beside them;
        # 1.65e-6 and 1.86e-6 measured), each against the one process's
        loss_rel = max(abs(g["train"]["loss"] - ref_loss) / abs(ref_loss) for g in got)
        train_rel = {}
        for r in sorted({0, ranks - 1}):
            dp_state = torch.load(os.path.join(tmp, f"dp_state{r}.pt"), weights_only=True)
            train_rel[r] = {what: rel_l2(torch, dp_state[what], ref_state[what])
                            for what in ("weights", "moments")}

        def train_gate():
            bad = {r: {what: rel[what][0] for what in rel} for r, rel in train_rel.items()
                   if not (rel["weights"][0] <= 1e-5 and rel["moments"][0] <= 1e-2)}
            if not loss_rel <= 1e-6 or bad:
                raise AssertionError(f"loss {loss_rel:.3g} (bound 1e-6); relative L2 by rank "
                                     f"{bad} (weights 1e-5, Adam moments 1e-2) from one process")

        gate("scale_out train", train_gate)
        for g in got:
            gate("scale_out train", lambda: expect_launches(
                f"rank {g['rank']}", g["train"]["launches"],
                {"fused_swin_block": 10 * SCALE_OUT_T, "attn_core_backward": 10 * SCALE_OUT_T}))

        # the sharded eval CLI: rank 0's files against the one process's
        eval_diffs = []
        for run in ("cold", "warm"):
            base = os.path.join(tmp, f"sharded_{run}", f"epoch_1_L{SCALE_OUT_L}_org")
            with open(base + ".txt") as fp:
                result = json.load(fp)["SYN"]["seq0"]
            with open(base + "_detail.txt") as fp:
                detail = json.load(fp)["SYN"]["seq0"]
            _, want_result, want_detail, _ = ref_eval[0]
            eval_diffs.append(max(max_detail_diff(detail, want_detail),
                                  max(abs(result[k] - want_result[k]) for k in want_result)))
        if not max(eval_diffs) <= 1e-6:
            failures.append(f"scale_out eval: --shard_data files {eval_diffs} from the one "
                            "process's (bound 1e-6)")
        for g in got:
            frames = chunk_frames(items, SCALE_OUT_L, ranks, g["rank"])
            for run in g["eval"]["cli"]:
                gate("scale_out eval", lambda: expect_launches(
                    f"rank {g['rank']}", run["launches"],
                    {"fused_swin_block": 10 * frames} if frames else {}))

        # the data-parallel bundle against --dp 1
        got_images = torch.from_numpy(np.load(os.path.join(tmp, "serve_dp.npy")))
        serve_diff = (got_images - want_images).abs().max().item()
        if not (got_images.shape == want_images.shape and serve_diff <= 1e-6):
            failures.append(f"scale_out serving: --dp {ranks} {tuple(got_images.shape)} max "
                            f"diff {serve_diff} from --dp 1 (bound 1e-6)")
        for g in got:
            gate("scale_out serving", lambda: expect_launches(
                f"rank {g['rank']}", g["serving"]["launches"], {"fused_swin_block": 10 * items}))
        torchrun_row = None
        if backend == "nccl":  # the CLIs as torchrun starts them, a card a rank
            torchrun_row, more = scale_out_torchrun(torch, launch_counts, tmp, ranks,
                                                    ref_eval[0][2], lambda: want_images)
            failures += more

    rank0 = got[0]
    dp_ms = float(np.mean(rank0["train"]["step_ms"]))
    emit({"phase": "scale_out", "card": card, "cards": torch.cuda.device_count(), "ranks": ranks,
          "backend": backend, "hw": list(SCALE_OUT_HW), "T": SCALE_OUT_T,
          "seconds": time.perf_counter() - t_phase, "ranks_seconds": ranks_s,
          "collectives": rank0["collectives"],
          "train": {"batch": ranks, "rows_a_rank": rank0["train"]["rows"],
                    "loss_rel_diff": loss_rel,
                    "rel_l2": {str(r): {what: {"all": v[0], "worst_tensor": [v[1], v[2]]}
                                        for what, v in rel.items()}
                               for r, rel in train_rel.items()},
                    "dp_step_ms": [g["train"]["step_ms"] for g in got],
                    "one_process_step_ms": {str(n): v for n, v in ref_ms.items()},
                    "allreduce_ms": rank0["train"]["allreduce_ms"],
                    "grad_bytes": rank0["train"]["grad_bytes"],
                    "allreduce_share": float(np.mean(rank0["train"]["allreduce_ms"])) / dp_ms,
                    "launches_a_rank": rank0["train"]["launches"]},
          "eval": {"items": items, "subseq_L": SCALE_OUT_L, "max_diff": max(eval_diffs),
                   "one_process_seconds": [r[0] for r in ref_eval],
                   "one_process_frames_per_s": items / ref_eval[1][0],
                   "sharded_seconds": [[run["seconds"] for run in g["eval"]["cli"]] for g in got],
                   "sharded_frames_per_s": items / max(g["eval"]["cli"][1]["seconds"] for g in got),
                   "one_process_driver_seconds": ref_driver_s,
                   "one_process_driver_frames_per_s": items / ref_driver_s[1],
                   "sharded_driver_seconds": [g["eval"]["driver_seconds"] for g in got],
                   "sharded_driver_frames_per_s": items / max(g["eval"]["driver_seconds"][1]
                                                              for g in got),
                   "launches": [g["eval"]["cli"][1]["launches"] for g in got]},
          "serving": {"batch": ranks, "T": SERVING_T, "max_diff": serve_diff,
                      "export_seconds": {str(k): v for k, v in export_s.items()},
                      "dp1_frames_per_s": ranks * items / (ref_serve_ms[0] / 1e3),
                      "dp_frames_per_s": ranks * items / (max(g["serving"]["serve_ms"][0]
                                                              for g in got) / 1e3),
                      "dp_cli_seconds": [g["serving"]["cli_seconds"] for g in got],
                      "launches": [g["serving"]["launches"] for g in got]},
          "torchrun": torchrun_row, "failures": failures})
    if failures:
        raise AssertionError("; ".join(failures))


SPATIAL_T, SPATIAL_TRAIN_T = 8, 4
SPATIAL_HW, SPATIAL_LARGE_HW = (184, 240), (720, 1280)  # the flagship's, a 1280x720 camera's
SPATIAL_CONFIGS = {"flagship": FLAGSHIP_CFG, "8x8": EIGHT_CFG}
# Adam's rate in the held train step: its first step moves each weight by
# about lr sign(g), so a near-zero gradient component that the sharded and
# the one-process sums round to opposite signs moves a weight by 2 lr; the
# weights' relative L2 gate (1e-5) then counts such flips (9.8e-6 at 1e-4)
SPATIAL_LR = 1e-5
# the step families on the row-sharded path (PR 26) at their published
# widths (SPADE-E2VID's and the SNNs' fixed, EITR_WIDTHS), over
# SPATIAL_FAMILY_T steps a forward and a train step (the SNNs run 5 bins a
# step); the SNNs are held to their gate (SNN_PIXEL_SHARE), the others to
# the flagship's bars
SPATIAL_FAMILIES = ("SPADEE2VID", "EITR", "EVSNN", "PAEVSNN")
SPATIAL_FAMILY_T = 2
# (loss, gradients, weights) bars of a family's row-sharded step where they
# are not the flagship's. SPADE-E2VID's step is ill-conditioned on the card:
# voxels moved by a relative 1e-7 move the one-process step's gradients by
# 3.40e-3 and its weights after Adam's step by 1.91e-5 by relative L2 (the
# same step repeated: 2.3e-5 and 1.8e-7; one H100 at 700 W), spread over its
# encoder convs and LSTM gates, which feed its train-mode BNs; the sharded
# step lies 3.77e-3 and 1.96e-5 from it. A missing or doubled row sum
# misses by O(0.5). Every run prints that spread ("spread") beside the
# sharded step's distance.
SPATIAL_FAMILY_BARS = {"SPADEE2VID": (1e-6, 1e-2, 5e-5)}


def spatial_layout(torch):
    """(ranks, backend) of the spatial phase: two ranks on one gloo group on
    the one card, or one NCCL rank a card where there are several."""
    cards = torch.cuda.device_count()
    return (cards, "nccl") if cards > 1 else (2, "gloo")


def spatial_model(torch, name, train=False):
    """The configuration on the kernel path (DropPath off in training: the
    one-process and the sharded step must draw alike), seeded."""
    from bde2vid_tpu_torch.models import build_model

    cfg = model_config(SPATIAL_CONFIGS[name])
    cfg["generator"]["drop_path_rate"] = 0.0
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(25)
        return build_model("BDE2VID", cfg, train=train)


def spatial_family_model(torch, name, train=False):
    """A family of ``SPATIAL_FAMILIES`` on the card, seeded (the SNNs so
    that their units fire)."""
    if name in SNN_MODELS:
        model = seeded_snn(torch, name, 26)
    else:
        model = seeded_step_model(torch, name, STEP_MODELS[name][0], 26)
    return model.cuda().train(train)


def family_forward(torch, model, vox):
    """A step family's images of ``vox`` (T, N, B, H, W) from its initial state."""
    from bde2vid_tpu_torch.models import run_sequence

    return run_sequence(model, vox, model.initial_state(vox.shape[1], *vox.shape[-2:]))[0]


def band_flips(torch, spikes, whole, plan, index):
    """The spikes of rank ``index``'s bands that differ from one process's
    whole-map spikes of the same firings."""
    if len(spikes) != len(whole):
        raise AssertionError(f"rank {index}: {len(spikes)} LIF firings, one process {len(whole)}")
    flips = 0
    for band, full in zip(spikes, whole):
        lo, hi = plan.band(index, plan.level_of(index, band.shape[2]))
        flips += int((band.cpu() != full[:, :, lo:hi]).sum())
    return flips


def spatial_inputs(tmp):
    """Voxels at both sizes and the train targets, on the host and on disk."""
    rng = np.random.default_rng(25)
    arrays = {"vox": rng.normal(size=(SPATIAL_T, 1, 5, *SPATIAL_HW)),
              "large": rng.normal(size=(SPATIAL_T, 1, 5, *SPATIAL_LARGE_HW)),
              "tgt": rng.uniform(size=(SPATIAL_TRAIN_T, 1, 1, *SPATIAL_HW))}
    for k, a in arrays.items():
        np.save(os.path.join(tmp, f"{k}.npy"), a.astype(np.float32))
    return {k: a.astype(np.float32) for k, a in arrays.items()}


def spatial_run(torch, fn, launch_counts):
    """(result, host ms, launches, exchanges, peak GB) of one synchronised
    call of ``fn`` from zeroed counts and peak."""
    from bde2vid_tpu_torch.parallel.spatial import exchange_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    exchange_counts.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return (out, ms, {k: v for k, v in launch_counts.items() if v}, dict(exchange_counts),
            torch.cuda.max_memory_allocated() / 2**30)


def spatial_rank(index, ranks, backend, tmp):
    """One rank of the spatial phase (a spawned process): the transport's
    check, then spatial_forward of both configurations at 184x240 and of the
    flagship at 720x1280, and one row-sharded train step, on a (1, ranks)
    mesh, then each of ``SPATIAL_FAMILIES`` (spatial_rank_family); writes
    rank<index>.json and rank 0's images."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = index if backend == "nccl" else 0
    torch.cuda.set_device(card)
    kw = {"device_id": torch.device("cuda", card)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), ranks),
                            rank=index, world_size=ranks,
                            timeout=datetime.timedelta(seconds=600), **kw)
    try:
        from bde2vid_tpu_torch.ops.window_attn_cuda import launch_counts
        from bde2vid_tpu_torch.parallel import make_dp_train_step, make_mesh, spatial_forward
        from bde2vid_tpu_torch.train import SequenceLossComputer

        out = {"rank": index, "card": card, "transport": spatial_transport(torch, index, ranks)}
        mesh = make_mesh(1, ranks)
        arrays = {k: torch.from_numpy(np.load(os.path.join(tmp, f"{k}.npy"))).cuda()
                  for k in ("vox", "large", "tgt")}
        for name, key in (("flagship", "vox"), ("8x8", "vox"), ("flagship", "large")):
            model = spatial_model(torch, name)
            model.load_state_dict(torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=True))
            fwd = lambda: spatial_forward(model, arrays[key], mesh)  # noqa: E731
            with torch.no_grad():
                fwd()  # warm-up
                images, ms, launches, exchanges, peak = spatial_run(torch, fwd, launch_counts)
            row = f"{name}_{key}"
            out[row] = {"ms": ms, "launches": launches, "exchanges": exchanges, "peak_gb": peak}
            if index == 0:
                torch.save(images.cpu(), os.path.join(tmp, f"images_{row}.pt"))
            del model, images
        model = spatial_model(torch, "flagship", train=True)
        model.load_state_dict(torch.load(os.path.join(tmp, "flagship.pt"), weights_only=True))
        opt = torch.optim.Adam(model.parameters(), lr=SPATIAL_LR)
        step = make_dp_train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]), mesh)
        vox = arrays["vox"][:SPATIAL_TRAIN_T]
        loss, ms, launches, exchanges, peak = spatial_run(
            torch, lambda: step(vox, arrays["tgt"])["loss"].item(), launch_counts)
        if index in (0, ranks - 1):
            torch.save(spatial_train_state(model), os.path.join(tmp, f"train_state{index}.pt"))
        out["train"] = {"loss": loss, "ms": ms, "launches": launches, "exchanges": exchanges,
                        "peak_gb": peak,
                        "next_ms": timed_steps(torch, lambda: step(vox, arrays["tgt"]), 1)[0]}
        del model, opt, step
        for name in SPATIAL_FAMILIES:
            out[name] = spatial_rank_family(torch, name, index, ranks, mesh, arrays, tmp,
                                            launch_counts)
        with open(os.path.join(tmp, f"rank{index}.json"), "w") as fp:
            json.dump(out, fp)
    finally:
        dist.destroy_process_group()


def spatial_rank_family(torch, name, index, ranks, mesh, arrays, tmp, launch_counts):
    """A rank's part of one family of ``SPATIAL_FAMILIES``: spatial_forward
    at both sizes (the first at 184x240 recording its spikes, held to one
    process's spikes of its bands) and one row-sharded train step, T =
    SPATIAL_FAMILY_T; saves rank 0's images and rank 0's and the last
    rank's train state."""
    from bde2vid_tpu_torch.models import evsnn
    from bde2vid_tpu_torch.parallel import make_dp_train_step, spatial_forward
    from bde2vid_tpu_torch.parallel.spatial import RowPlan, model_levels
    from bde2vid_tpu_torch.train import SequenceLossComputer

    t = SPATIAL_FAMILY_T
    snn = name in SNN_MODELS
    weights = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=True)
    model = spatial_family_model(torch, name)
    model.load_state_dict(weights)
    out = {}
    for key in ("vox", "large"):
        vox = arrays[key][:t]
        fwd = lambda: spatial_forward(model, vox, mesh)  # noqa: E731
        record = snn and key == "vox"
        with (record_spikes(evsnn) if record else contextlib.nullcontext()) as spikes:
            with torch.no_grad():
                fwd()  # warm-up, its spikes recorded
        with torch.no_grad():
            images, ms, launches, exchanges, peak = spatial_run(torch, fwd, launch_counts)
        out[key] = {"ms": ms, "launches": launches, "exchanges": exchanges, "peak_gb": peak}
        if record:
            plan = RowPlan(vox.shape[-2], model_levels(model), ranks)
            whole = torch.load(os.path.join(tmp, f"spikes_{name}_forward.pt"), weights_only=True)
            out[key]["flipped_spikes"] = band_flips(torch, spikes, whole, plan, index)
        if index == 0:
            torch.save(images.cpu(), os.path.join(tmp, f"images_{name}_{key}.pt"))
        del images
    del model
    model = spatial_family_model(torch, name, train=True)
    model.load_state_dict(weights)
    opt = torch.optim.Adam(model.parameters(), lr=SPATIAL_LR)
    step = make_dp_train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]), mesh)
    vox, tgt = arrays["vox"][:t], arrays["tgt"][:t]
    with record_spikes(evsnn) as spikes:
        loss, ms, launches, exchanges, peak = spatial_run(
            torch, lambda: step(vox, tgt)["loss"].item(), launch_counts)
    out["train"] = {"loss": loss, "ms": ms, "launches": launches, "exchanges": exchanges,
                    "peak_gb": peak}
    if snn:
        plan = RowPlan(vox.shape[-2], model_levels(model), ranks)
        whole = torch.load(os.path.join(tmp, f"spikes_{name}_train.pt"), weights_only=True)
        out["train"]["flipped_spikes"] = band_flips(torch, spikes, whole, plan, index)
    if index in (0, ranks - 1):
        torch.save(spatial_train_state(model), os.path.join(tmp, f"train_state_{name}{index}.pt"))
    return out


def spatial_family_refs(torch, launch_counts, tmp, arrays):
    """One process's side of ``SPATIAL_FAMILIES``: each family's weights
    written for the ranks, its forward at both sizes (ms, peak, images; the
    SNNs' spikes at 184x240 written for the ranks) and one train step
    (loss, state; the SNNs' spikes written)."""
    from bde2vid_tpu_torch.models import evsnn
    from bde2vid_tpu_torch.parallel.spatial import model_levels
    from bde2vid_tpu_torch.train import SequenceLossComputer, train_step

    t = SPATIAL_FAMILY_T
    comp = SequenceLossComputer([{"type": "L1Loss"}])
    ref = {}
    for name in SPATIAL_FAMILIES:
        model = spatial_family_model(torch, name)
        torch.save(model.state_dict(), os.path.join(tmp, f"{name}.pt"))
        ref[f"{name}_levels"] = model_levels(model)
        for key in ("vox", "large"):
            vox = arrays[key][:t].cuda()
            record = name in SNN_MODELS and key == "vox"
            with (record_spikes(evsnn) if record else contextlib.nullcontext()) as spikes:
                with torch.no_grad():
                    family_forward(torch, model, vox)  # warm-up, its spikes recorded
            with torch.no_grad():
                images, ms, launches, _, peak = spatial_run(
                    torch, lambda: family_forward(torch, model, vox), launch_counts)
            ref[f"{name}_{key}"] = {"images": images.cpu(), "ms": ms, "launches": launches,
                                    "peak_gb": peak}
            if record:
                spikes = [sp.cpu() for sp in spikes]
                torch.save(spikes, os.path.join(tmp, f"spikes_{name}_forward.pt"))
                ref[f"{name}_{key}"]["lif_fired_share"] = lif_fired_share(torch, spikes)
            del vox, images
        model = spatial_family_model(torch, name, train=True)
        opt = torch.optim.Adam(model.parameters(), lr=SPATIAL_LR)
        vox, tgt = arrays["vox"][:t].cuda(), arrays["tgt"][:t].cuda()
        with record_spikes(evsnn) as spikes:
            loss, ms, launches, _, peak = spatial_run(
                torch, lambda: train_step(model, opt, comp, vox, tgt)["loss"].item(), launch_counts)
        if name in SNN_MODELS:
            torch.save([sp.cpu() for sp in spikes], os.path.join(tmp, f"spikes_{name}_train.pt"))
        state = spatial_train_state(model)
        # the one-process step's own spread, beside which the sharded step's
        # distance reads: the same step again ("repeat": the libraries'
        # nondeterminism) and on voxels moved by a relative 1e-7 ("perturbed":
        # how far rounding-size changes carry through the step)
        gen = torch.Generator(device=vox.device).manual_seed(26)
        noise = torch.randn(vox.shape, generator=gen, device=vox.device)
        spread = {}
        for what, v in (("repeat", vox), ("perturbed", vox * (1 + 1e-7 * noise))):
            again = spatial_family_model(torch, name, train=True)
            train_step(again, torch.optim.Adam(again.parameters(), lr=SPATIAL_LR), comp, v, tgt)
            other = spatial_train_state(again)
            spread[what] = {w: rel_l2(torch, other[w], state[w])[0] for w in ("grads", "weights")}
            del again
        ref[f"{name}_train"] = {"loss": loss, "ms": ms, "launches": launches, "peak_gb": peak,
                                "state": state, "spread": spread}
        del model, opt, vox, tgt, spikes, noise
        torch.cuda.empty_cache()
    return ref


def largest_diffs(torch, got, want, k=3):
    """The ``k`` float tensors of ``want`` farthest from ``got`` by L2
    distance: [name, distance, its relative L2]."""
    dist = {n: ((got[n].float() - v.float()).norm().item(), v.float().norm().item())
            for n, v in want.items() if v.is_floating_point()}
    top = sorted(dist, key=lambda n: -dist[n][0])[:k]
    return [[n, dist[n][0], dist[n][0] / max(dist[n][1], 1e-12)] for n in top]


def spatial_family_gates(torch, tmp, ref, got, ranks):
    """Each family's readings and its failures: images at both sizes (the
    SNNs by their gate, with the flipped spikes of every rank's bands
    counted at 184x240; the others within 1e-5), the train step's loss,
    reduced gradients and weights on rank 0 and the last rank (the SNNs
    within SNN_REL_L2, relative and by relative L2; SPADE-E2VID at
    SPATIAL_FAMILY_BARS; EITR at 1e-6, 1e-3 and 1e-5, the flagship's bars),
    ms and peak memory of both sides."""
    from bde2vid_tpu_torch.parallel.spatial import RowPlan

    rows, failures = {}, []
    for name in SPATIAL_FAMILIES:
        snn = name in SNN_MODELS
        levels = ref[f"{name}_levels"]
        row = {"levels": levels, "rows_a_rank": {str(h): RowPlan(h, levels, ranks).rows(0)
                               for h in (SPATIAL_HW[0], SPATIAL_LARGE_HW[0])}}
        for key, hw in (("vox", SPATIAL_HW), ("large", SPATIAL_LARGE_HW)):
            want = ref[f"{name}_{key}"]
            images = torch.load(os.path.join(tmp, f"images_{name}_{key}.pt"), weights_only=True)
            diff = (images - want["images"]).abs()
            gate = {"max_abs_diff": diff.max().item()}
            ok = (images.shape == (SPATIAL_FAMILY_T, 1, 1, *hw) and torch.isfinite(images).all())
            if snn:
                gate.update({"share_of_pixels_within_2e-4": (diff <= 2e-4).double().mean().item(),
                             "relative_l2_images": (diff.norm() / want["images"].norm()).item()})
                ok = (ok and gate["share_of_pixels_within_2e-4"] >= SNN_PIXEL_SHARE
                      and gate["relative_l2_images"] <= SNN_REL_L2)
                if key == "vox":
                    gate["flipped_spikes"] = sum(g[name][key]["flipped_spikes"] for g in got)
                    gate["lif_fired_share"] = want["lif_fired_share"]
                    ok = ok and gate["lif_fired_share"] >= SNN_MIN_FIRE
            else:
                ok = ok and gate["max_abs_diff"] <= 1e-5
            if not ok:
                failures.append(f"spatial {name} {hw[0]}x{hw[1]}: images {tuple(images.shape)}, "
                                f"{gate} from one process's")
            row[f"{hw[0]}x{hw[1]}"] = {
                "gate": gate,
                "one_process": {k: want[k] for k in ("ms", "peak_gb", "launches")},
                "ranks": [{k: g[name][key][k] for k in ("ms", "peak_gb", "launches", "exchanges")}
                          for g in got]}
        want = ref[f"{name}_train"]
        loss_rel = max(abs(g[name]["train"]["loss"] - want["loss"]) / abs(want["loss"])
                       for g in got)
        rel, largest = {}, {}
        for r in sorted({0, ranks - 1}):
            state = torch.load(os.path.join(tmp, f"train_state_{name}{r}.pt"), weights_only=True)
            rel[r] = {what: rel_l2(torch, state[what], want["state"][what])
                      for what in ("grads", "weights")}
            largest[r] = {what: largest_diffs(torch, state[what], want["state"][what])
                          for what in ("grads", "weights")}
        bars = (SNN_REL_L2,) * 3 if snn else SPATIAL_FAMILY_BARS.get(name, (1e-6, 1e-3, 1e-5))
        if not (loss_rel <= bars[0] and all(v["grads"][0] <= bars[1] and v["weights"][0] <= bars[2]
                                            for v in rel.values())):
            failures.append(f"spatial {name} train: loss {loss_rel:.3g}, relative L2 by rank "
                            f"{ {r: {w: x[0] for w, x in v.items()} for r, v in rel.items()} } "
                            f"(bounds {bars}) from one process")
        row["train"] = {
            "loss_rel_diff": loss_rel,
            "rel_l2": {str(r): {what: {"all": v[0], "worst_tensor": [v[1], v[2]]}
                                for what, v in x.items()} for r, x in rel.items()},
            "largest_diffs": {str(r): v for r, v in largest.items()},
            "one_process": {k: want[k] for k in ("ms", "peak_gb", "launches", "spread")},
            "ranks": [g[name]["train"] for g in got]}
        if snn:
            row["train"]["flipped_spikes"] = sum(g[name]["train"]["flipped_spikes"] for g in got)
        rows[name] = row
    return rows, failures


def spatial_train_state(model):
    """The weights and the gradients of a step, by name, on the host."""
    return {"weights": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}}


def spatial_transport(torch, index, ranks):
    """The halo exchange on CUDA tensors, checked: each rank's band of a
    known map with two rows beyond each edge, from its neighbours (staged
    through host memory under gloo, on the device under NCCL), and the
    gradient sent back."""
    from bde2vid_tpu_torch.parallel.spatial import RowPlan, halo_rows, row_sharded

    plan = RowPlan(4 * ranks, 0, ranks)
    whole = torch.arange(4 * ranks * 3, dtype=torch.float32, device="cuda").reshape(4 * ranks, 3)
    lo, hi = plan.band(index, 0)
    x = whole[lo:hi].clone().requires_grad_()
    with row_sharded(plan):
        got = halo_rows(x, 2, 2, dim=0)
    got.sum().backward()
    want = torch.nn.functional.pad(whole, (0, 0, 2, 2))[lo:hi + 4]
    reads = torch.zeros(4 * ranks, device="cuda")  # the ranks that read each row
    for r in range(ranks):
        a, b = plan.band(r, 0)
        reads[max(a - 2, 0):b + 2] += 1
    if not (torch.equal(got, want) and torch.equal(x.grad[:, 0], reads[lo:hi])):
        raise AssertionError(f"rank {index}: halo rows {got.tolist()}, gradient "
                             f"{x.grad[:, 0].tolist()}")
    return "staged through host memory" if torch.distributed.get_backend() == "gloo" else "device"


def spatial_windows():
    """B1 / B3 windows a launch of each rank against the whole map's, at
    both attention levels of both configurations at 184x240, two and four
    ranks: {config: {ranks: {level: {plain|dilated: [rank windows...,
    whole]}}}} (a frame of a batch of one: a launch runs every frame's
    windows of one block)."""
    from bde2vid_tpu_torch.nn.window_attention import band_windows
    from bde2vid_tpu_torch.parallel.spatial import RowPlan

    out = {}
    for name, cfg in SPATIAL_CONFIGS.items():
        win = cfg["generator"]["window_size"]
        out[name] = {}
        for ranks in (2, 4):
            plan = RowPlan(SPATIAL_HW[0], 3, ranks)
            levels = {}
            for lvl in (0, 2):
                h, w = plan.height(lvl + 1), SPATIAL_HW[1] >> (lvl + 1)
                levels[f"level{lvl}"] = {
                    kind: [band_windows(h, w, *win, dilate, *plan.band(r, lvl + 1)).windows
                           for r in range(ranks)] + [band_windows(h, w, *win, dilate, 0, h).windows]
                    for kind, dilate in (("plain", False), ("dilated", True))}
            out[name][str(ranks)] = levels
    return out


def phase_spatial(torch, launch_counts, card):
    """The row-sharded forward and train step (ROADMAP A16, A17) over
    spawned ranks (see spatial_layout), each held to one process on the same
    inputs: the flagship and the 8x8 config at 184x240 and the flagship at
    720x1280, T=8, eval forward (images within 1e-5), and one flagship train
    step at T=4 (loss 1e-6 relative; by relative L2, gradients 1e-3 and
    weights 1e-5), with exact launch counts a rank; then SPADE-E2VID, EITR
    (EITR_WIDTHS), EVSNN and PAEVSNN at their published widths, T=2, forward
    at both sizes and one train step at 184x240, EVSNN and PAEVSNN held to
    the SNN gate (SNN_PIXEL_SHARE, SNN_REL_L2, SNN_MIN_FIRE; flipped spikes
    of every rank's bands counted; the step within SNN_REL_L2), EITR to the
    flagship's bars, SPADE-E2VID's step to SPATIAL_FAMILY_BARS
    (spatial_family_gates); times, peak memory, halo exchanges and group
    collectives of both sides."""
    import torch.multiprocessing as mp

    from bde2vid_tpu_torch.parallel.spatial import RowPlan
    from bde2vid_tpu_torch.train import SequenceLossComputer, train_step

    ranks, backend = spatial_layout(torch)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        arrays = {k: torch.from_numpy(a) for k, a in spatial_inputs(tmp).items()}
        ref = {}
        for name, key in (("flagship", "vox"), ("8x8", "vox"), ("flagship", "large")):
            model = spatial_model(torch, name)
            torch.save(model.state_dict(), os.path.join(tmp, f"{name}.pt"))
            vox = arrays[key].cuda()
            with torch.no_grad():
                model(vox)  # warm-up
                images, ms, launches, _, peak = spatial_run(
                    torch, lambda: model(vox)["image"], launch_counts)
            ref[f"{name}_{key}"] = {"images": images.cpu(), "ms": ms, "launches": launches,
                                    "peak_gb": peak}
            del model, vox, images
        model = spatial_model(torch, "flagship", train=True)
        opt = torch.optim.Adam(model.parameters(), lr=SPATIAL_LR)
        vox, tgt = arrays["vox"][:SPATIAL_TRAIN_T].cuda(), arrays["tgt"].cuda()
        comp = SequenceLossComputer([{"type": "L1Loss"}])
        loss, ms, launches, _, peak = spatial_run(
            torch, lambda: train_step(model, opt, comp, vox, tgt)["loss"].item(), launch_counts)
        ref["train"] = {"loss": loss, "ms": ms, "launches": launches, "peak_gb": peak,
                        "state": spatial_train_state(model),
                        "next_ms": timed_steps(torch, lambda: train_step(model, opt, comp, vox, tgt),
                                               1)[0]}
        del model, opt, vox, tgt
        torch.cuda.empty_cache()
        ref.update(spatial_family_refs(torch, launch_counts, tmp, arrays))

        t_ranks = time.perf_counter()
        mp.start_processes(spatial_rank, args=(ranks, backend, tmp), nprocs=ranks, join=True,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t_ranks
        got = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as fp:
                got.append(json.load(fp))

        # every gate is checked and the figures written before any failure raises
        failures = []
        per_frame = {"flagship": {"fused_swin_block": 10},
                     "8x8": {"fused_swin_block": 5, "fused_window_block": 5}}
        diffs = {}
        for row in ("flagship_vox", "8x8_vox", "flagship_large"):
            name = row.split("_")[0]
            want = {k: n * SPATIAL_T for k, n in per_frame[name].items()}
            images = torch.load(os.path.join(tmp, f"images_{row}.pt"), weights_only=True)
            diffs[row] = (images - ref[row]["images"]).abs().max().item()
            if not (images.shape == ref[row]["images"].shape and torch.isfinite(images).all()
                    and diffs[row] <= 1e-5):
                failures.append(f"spatial {row}: images {tuple(images.shape)} max diff "
                                f"{diffs[row]} from one process's (bound 1e-5)")
            sides = [("one process", ref[row]["launches"])] + [
                (f"rank {g['rank']}", g[row]["launches"]) for g in got]
            for who, launches in sides:
                if launches != want:
                    failures.append(f"spatial {row}: {who} launched {launches}, want {want}")
        want = {k: 10 * SPATIAL_TRAIN_T for k in ("fused_swin_block", "attn_core_backward")}
        loss_rel = max(abs(g["train"]["loss"] - ref["train"]["loss"]) / abs(ref["train"]["loss"])
                       for g in got)
        # the loss; the reduced gradients (a rank's rows counted twice or
        # missing moves them by 0.5 or more; reduction orders and cuDNN's
        # algorithms for the slabs' shapes by 9.8e-5 over four ranks, most of
        # it the head conv's weight, whose terms cancel, C11); the weights
        # after Adam's first step, about lr sign(g), blind to the gradient's
        # scale but not to its sign (by the relative L2 of all of them: a
        # near-zero component rounded to the other sign moves its weight by
        # 2 lr)
        train_rel = {}
        for r in sorted({0, ranks - 1}):
            state = torch.load(os.path.join(tmp, f"train_state{r}.pt"), weights_only=True)
            train_rel[r] = {what: rel_l2(torch, state[what], ref["train"]["state"][what])
                            for what in ("grads", "weights")}
        if not (loss_rel <= 1e-6 and all(v["grads"][0] <= 1e-3 and v["weights"][0] <= 1e-5
                                         for v in train_rel.values())):
            rel = {r: {w: x[0] for w, x in v.items()} for r, v in train_rel.items()}
            failures.append(f"spatial train: loss {loss_rel:.3g} (bound 1e-6 relative); relative "
                            f"L2 by rank {rel} (gradients 1e-3, weights 1e-5) from one process")
        for who, g in [("one process", ref["train"])] + [(f"rank {g['rank']}", g["train"])
                                                          for g in got]:
            if g["launches"] != want:
                failures.append(f"spatial train: {who} launched {g['launches']}, want {want}")
        families, family_failures = spatial_family_gates(torch, tmp, ref, got, ranks)
        failures += family_failures

    def side(row):
        return {"one_process": {k: ref[row][k] for k in ("ms", "peak_gb", "launches")},
                "ranks": [{k: g[row][k] for k in ("ms", "peak_gb", "launches", "exchanges")}
                          for g in got]}

    emit({"phase": "spatial", "card": card, "cards": torch.cuda.device_count(), "ranks": ranks,
          "backend": backend, "transport": got[0]["transport"],
          "rows_a_rank": {str(h): RowPlan(h, 3, ranks).rows(0)
                          for h in (SPATIAL_HW[0], SPATIAL_LARGE_HW[0])},
          "T": SPATIAL_T, "train_T": SPATIAL_TRAIN_T,
          "seconds": time.perf_counter() - t_phase, "ranks_seconds": ranks_s,
          "max_diff": diffs,
          "forward": {"flagship_184x240": side("flagship_vox"), "8x8_184x240": side("8x8_vox"),
                      "flagship_720x1280": side("flagship_large")},
          "train": {"loss_rel_diff": loss_rel,
                    "rel_l2": {str(r): {what: {"all": v[0], "worst_tensor": [v[1], v[2]]}
                                        for what, v in rel.items()}
                               for r, rel in train_rel.items()},
                    "one_process": {k: ref["train"][k]
                                    for k in ("ms", "next_ms", "peak_gb", "launches")},
                    "ranks": [g["train"] for g in got]},
          "families_T": SPATIAL_FAMILY_T, "families": families,
          "windows_a_launch": spatial_windows(), "failures": failures})
    if failures:
        raise AssertionError("; ".join(failures))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="drive the port on the card and check it")
    parser.add_argument("--only", choices=["scale_out", "scale_out_torchrun", "spatial"],
                        default=None,
                        help="build the kernels and run this phase alone (on every visible "
                        "card: one NCCL rank a card where there are several); "
                        "scale_out_torchrun, on several cards: only the CLIs under torchrun "
                        "and their one-process references")
    args = parser.parse_args(argv)

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
    if args.only is not None:
        {"scale_out": phase_scale_out, "scale_out_torchrun": phase_scale_out_torchrun,
         "spatial": phase_spatial}[args.only](torch, launch_counts, card)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    cases = phase_kernels(torch)
    bwd_cases = phase_kernels_training(torch)
    long_cases = phase_kernels_long_rows(torch)
    block_cases, attn_cases = phase_kernels_window(torch)
    attn_launches = phase_attention(torch, launch_counts)
    phase_model(torch, launch_counts)
    phase_parallel(torch, launch_counts)
    eval_launches = phase_eval(torch, launch_counts, card)
    phase_backends(torch, launch_counts, card)
    phase_step_models(torch, launch_counts, card)
    phase_packing(torch, card)
    phase_grads(torch, launch_counts)
    phase_variants(torch, launch_counts)
    bwd_launches, long_launches = phase_train(torch, launch_counts, card)
    tiled_fwd_cases, tiled_bwd_cases = phase_kernels_key_tiles(torch)
    tiled_fwd_launches, tiled_bwd_launches = phase_key_tiles(torch, launch_counts)
    wide_cases = phase_kernels_head_dims(torch)
    wide_launches = phase_head_dims(torch, launch_counts)
    phase_lpips(torch, launch_counts, card)
    phase_serving(torch, launch_counts, card)
    phase_scale_out(torch, launch_counts, card)
    phase_spatial(torch, launch_counts, card)
    phase_events(torch, launch_counts, card)
    phase_deform(torch, launch_counts, card)

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
