// Window attention core, hand-written for Hopper (sm_90a), f32 or bf16
// operands with f32 accumulation.
//
// Replaces: bde2vid_tpu/ops/window_attn_pallas.py::_kernel (the TPU kernel
// behind fused_window_attention; its math is _attn_core).
//
// What it computes, per window w of B_ and head h (heads split the C
// channels, head_dim = C / H):
//   out_h = round(softmax(q_h k_h^T * hd^-0.5 + bias_h)) @ v_h
// with q (B_, M, C), k and v (B_, N, C), bias (H, M, N) f32, and round() the
// cast to the operand type where _attn_core casts (identity for f32).
//
// What bounds it on the H100: 4*B_*M*N*C operations against B_*(2M + 2N)*C
// elements and the (H, M, N) f32 bias. At the BDE2VID shapes (M = 49 or 64,
// N = 7M, head_dim 4 or 16) f32 is bound by operations (67 TFLOP/s without
// tensor cores; no TF32 so that f32 stays exact), bf16 by bytes.
//
// What the design does about it: the attention core of the Swin block
// kernels (window_common.cuh), reading k and v in their own (B_, N, C)
// layout. A block per (window, head, row tile) stages the head's k and v
// columns in shared memory once; in f32, and below head_dim 16, a warp per
// query row keeps its lane's share of the 1 x N score row in registers (FMA
// dot products: head_dim 4 is below an MMA's K), with one ex2.approx an
// element and one reciprocal a row; bf16 at head_dim >= 16 runs 16-row
// tiles on the tensor cores (mma.sync m16n8k16). No score plane reaches
// device memory. The wrapper's plan (attn_forward_plan) splits a window's
// rows into tiles where there are too few windows to fill the card, and
// sends windows whose k and v rows do not fit in one block's shared memory,
// and every head_dim from 33 to 256, to the key-tiled variant
// (attn_flash_kernel), which sweeps the keys once, a tile at a time, with
// an online softmax. A head_dim between the instantiated ones (1, 2, 4,
// ..., 256) runs at the next one up with zero columns past it. Above head_dim
// 256 the wide forward runs (attn_wide_scores_kernel, attn_wide_out_kernel):
// q k^T once per (window, head, row, key) into an f32 score plane in the
// wrapper's scratch, then p v per 64-column chunk of head_dim.

#include "window_common.cuh"

extern "C" {

// Shared memory (bytes) the kernel that a launch, key-tiled or not, takes
// asks for; the wrapper checks it against the card's per-block limit
// before launching.
long long window_attention_smem_bytes(int is_bf16, int m, int n, int c, int heads, int key_tiled) {
  return (long long)attn_launch_smem_bytes(is_bf16, m, n, c / heads, key_tiled);
}

// The occupancy of the instantiation these shapes take, key-tiled or not:
// info[0..6] = registers, local (spill) bytes per thread, dynamic shared
// memory per block, threads per block, resident blocks per SM, J (keys a
// lane keeps of a score row; 0 on the tensor cores), the key tile. Returns
// the CUDA error code (0 on success).
int window_attention_occupancy(int is_bf16, int m, int n, int c, int heads, int key_tiled,
                               long long* info) {
  return attn_occupancy<false>(is_bf16, m, n, c, heads, key_tiled, info);
}

// Floats of f32 scratch a launch at these shapes needs: the wide
// forward's score plane and row statistics above head_dim 256, else 0.
long long window_attention_scratch_floats(int b, int m, int n, int c, int heads) {
  return heads < 1 ? 0 : (long long)attn_scratch_floats(b, m, n, c / heads, heads);
}

// Launches the kernel on `stream`, each window's rows in `tiles` tiles, by
// the key-tiled kernel (key_tiled 1) or all keys at once (0), or above
// head_dim 256 the wide forward over `scratch`
// (window_attention_scratch_floats floats; null where that is 0); returns
// the CUDA error code (0 on success). q, k, v, out are f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1) device arrays, bias and scratch are f32.
int window_attention_forward(int is_bf16, int b, int m, int n, int c, int heads, int tiles,
                             int key_tiled, float scale, const void* q, const void* k,
                             const void* v, const float* bias, void* out, float* scratch,
                             void* stream) {
  AttnArgs a{};
  a.b = b;
  a.m = m;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.tiles = tiles;
  a.key_tiled = key_tiled;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.out = out;
  a.scratch = scratch;
  return (int)launch_attn<false>(is_bf16, a, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
