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
// What the design does about it: the per-(window, head) attention of the
// Swin block kernels (window_common.cuh), reading k and v in their own
// (B_, N, C) layout: one block per (window, head) stages the head's q, k and
// v columns in shared memory once, and a warp per query row keeps its 1 x N
// score row there, so no score plane reaches device memory. head_dim 4 is
// below an MMA's K and runs as FMA dot products; tensor-core MMAs for the
// wider heads are later work.

#include "window_common.cuh"

extern "C" {

// Shared memory (bytes) the kernel asks for; the wrapper checks it against
// the card's per-block limit before launching.
long long window_attention_smem_bytes(int m, int n, int c, int heads) {
  return (long long)attn_smem_bytes(m, n, c / heads);
}

// Launches the kernel on `stream`; returns the CUDA error code (0 on
// success). q, k, v, out are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1) device
// arrays, bias is f32.
int window_attention_forward(int is_bf16, int b, int m, int n, int c, int heads, float scale,
                             const void* q, const void* k, const void* v, const float* bias,
                             void* out, void* stream) {
  AttnArgs a;
  a.b = b;
  a.m = m;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_attn<__nv_bfloat16, false>(a, scale, s) : launch_attn<float, false>(a, scale, s);
  return (int)err;
}

}  // extern "C"
