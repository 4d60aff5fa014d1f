// Whole Swin transformer block for a group of windows, hand-written for
// Hopper (sm_90a), f32 or bf16 operands with f32 accumulation.
//
// Replaces: bde2vid_tpu/ops/window_attn_pallas.py::_fused_swin_kernel (the
// TPU kernel behind fused_swin_block), with its two training variants: the
// stochastic-depth masks and the saved `acc` output.
//
// What it computes, per window w of B_ and token m of M (N = D*M kv tokens):
//   kv  = round(LN_kv(x with frame q_ind replaced by ctr) @ Wkv^T + bkv)
//   q   = round(LN_q(ctr) @ Wq^T + bq)
//   acc = per head h: round(softmax(q_h k_h^T * hd^-0.5 + bias_h)) @ v_h
//   y   = ctr + m1[w] * (round(acc) @ Wp^T + bp)
//   out = y + m2[w] * (round(act(round(LN2(y)) @ W1^T + b1)) @ W2^T + b2)
// where m1, m2 are the per-window stochastic-depth multipliers (null
// pointers: no masks, and no multiply), acc is written out, so the training
// forward returns it for the backward, and act is any activation of the
// registry (window_common.cuh, Act). round() casts to the operand type
// exactly where the Pallas body casts (identity for f32); y stays f32, as in
// the Pallas body.
//
// What bounds it on the H100: per flagship launch ~3.5 GFLOP against
// ~22 MB (level 0, f32) or ~10 MB (level 2) of input, so f32 is bound by
// operations (67 TFLOP/s without tensor cores, no TF32 so that f32 stays
// exact) and bf16 sits near the memory line.
//
// What the design does about it: five launches, four of them GEMMs on the
// core of window_common.cuh (register-blocked FMA tiles in f32, mma.sync
// tensor-core tiles in bf16, cp.async operand stages, a tile shape chosen
// per launch so that the grid covers the SMs without split-K):
//   (a) LN + k|v and q projections: the LayerNorm prologue keeps the block's
//       rows resident (or, at a C where they do not fit, normalises each k
//       stage as it streams in: ln_gemm_stream_kernel), the centre frame
//       substituted by choosing the row's source pointer; a bias epilogue;
//   (b) attn_kernel (window_common.cuh): a block per (window, head, row
//       tile); a warp per query row keeps its lane's share of the score row
//       in registers (the TPU kept all 16 heads' (H*M, N) plane resident,
//       which does not fit in 227 KB), so head_dim 4 (below an MMA's K)
//       runs as FMA dot products; bf16 at head_dim 16 takes 16-row tiles on
//       the tensor cores (attn_kernel_mma); windows whose k and v rows do
//       not fit in one block, and every head_dim from 33 to 256, take the
//       one-sweep key-tiled variant (attn_flash_kernel), every head_dim
//       above 256 the two launches of the wide forward over the attention
//       scratch;
//   (c1) y = ctr + m1 (acc @ Wp^T + bp), y into an f32 scratch;
//   (c2) h = round(act(LN2(y) @ W1^T + b1)): the LN prologue on y (resident
//        or streamed as in (a)) and the activation in the epilogue, h into a
//        scratch in the operand type;
//   (c3) out = y + m2 (h @ W2^T + b2).
// y and h stay in L2 between the launches at these sizes (h: 12.6 MB at
// the flagship's level 0 in f32).

#include "window_common.cuh"

namespace {

struct BlockArgs {
  int b, m, c, hidden, act;
  const void* ctr;                     // (B_, M, C) live centre tokens
  const void* acc;                     // (B_, M, C) attention output
  const float *g_2, *b_2_ln;           // (C,) LN2 affines
  const void *w_p, *w_1, *w_2;         // (out, in) weights
  const float *b_p, *b_1, *b_2;        // biases
  const float *m1, *m2;                // (B_,) f32 masks, or null
  float* y;                            // scratch (B_, M, C) f32: the residual stream
  void* h;                             // scratch (B_, M, hidden): the MLP's hidden rows
  void* out;                           // (B_, M, C)
};

template <typename T>
cudaError_t launch_mlp(const BlockArgs& a, cudaStream_t stream) {
  const int rows = a.b * a.m;
  // (c1) y = ctr + m1 * (acc @ Wp^T + bp)
  GemmArgs g{};
  g.rows = rows;
  g.k = a.c;
  g.o_total = a.c;
  g.a = a.acc;
  g.w = a.w_p;
  g.vec = vec_ok(a.c, {a.acc, a.w_p});
  g.epi = Epilogue{a.b_p, kActIdentity, a.m1, a.m, a.ctr, false, a.y, true, a.c};
  cudaError_t err = launch_gemm<T>(g, stream);
  if (err != cudaSuccess) return err;

  // (c2) h = round(act(round(LN2(y)) @ W1^T + b1))
  LnGemmArgs l{};
  l.c = a.c;
  l.rows_per_frame = rows;
  l.q_ind = -1;
  l.x = a.y;
  l.vec = vec_ok(a.c, {a.y, a.w_1});
  l.part[0] = LnPart{rows, a.hidden, a.g_2, a.b_2_ln, a.w_1,
                     Epilogue{a.b_1, a.act, nullptr, 1, nullptr, false, a.h, false, a.hidden}};
  err = launch_ln_gemm<T, float>(l, stream);
  if (err != cudaSuccess) return err;

  // (c3) out = y + m2 * (h @ W2^T + b2)
  g.k = a.hidden;
  g.a = a.h;
  g.w = a.w_2;
  g.vec = vec_ok(a.hidden, {a.h, a.w_2});
  g.epi = Epilogue{a.b_2, kActIdentity, a.m2, a.m, a.y, true, a.out, false, a.c};
  return launch_gemm<T>(g, stream);
}

template <typename T>
cudaError_t launch_all(const LnProjArgs& p, const BlockArgs& a, const float* bias, int heads,
                       int attn_tiles, int attn_key_tiled, float* attn_scratch, float scale,
                       cudaStream_t stream) {
  cudaError_t err = launch_ln_proj<T>(p, stream);
  if (err != cudaSuccess) return err;
  err = launch_block_attn<T>(p, heads, attn_tiles, attn_key_tiled, bias,
                             const_cast<void*>(a.acc), attn_scratch, scale, stream);
  if (err != cudaSuccess) return err;
  return launch_mlp<T>(a, stream);
}

// c3 streams its hidden rows, so no tile grows with the hidden width
template <typename T>
void smem_bytes(int d, int m, int c, int heads, int key_tiled, long long* out3) {
  out3[0] = (long long)ln_proj_smem_bytes<T>(c);
  out3[1] = (long long)attn_launch_smem_bytes(std::is_same<T, __nv_bfloat16>::value, m, d * m,
                                              c / heads, key_tiled);
  out3[2] = (long long)std::max(gemm_smem<T, TileS>(), ln_gemm_launch_smem<T, float>(c));
}

}  // namespace

extern "C" {

// Shared memory (bytes) the LN + projection GEMM, the attention (key-tiled
// or not) and the largest MLP GEMM ask for at most; the wrapper
// checks these against the card's per-block limit before launching.
void swin_block_smem_bytes(int is_bf16, int d, int m, int c, int heads, int key_tiled,
                           long long* out3) {
  if (is_bf16) {
    smem_bytes<__nv_bfloat16>(d, m, c, heads, key_tiled, out3);
  } else {
    smem_bytes<float>(d, m, c, heads, key_tiled, out3);
  }
}

// The occupancy of the attention stage's instantiation at these shapes,
// key-tiled or not (window_attention_occupancy's info).
int swin_block_attn_occupancy(int is_bf16, int m, int n, int c, int heads, int key_tiled,
                              long long* info) {
  return attn_occupancy<true>(is_bf16, m, n, c, heads, key_tiled, info);
}

// Launches the five kernels on `stream` (six above head_dim 256, where the
// attention is the wide forward's two over attn_scratch, which holds
// attn_scratch_floats floats and is null below), the attention with each
// window's rows in attn_tiles tiles, by the key-tiled kernel
// (attn_key_tiled 1) or all keys at once (0); returns the first CUDA error
// code (0 on success). Pointers are device pointers; vectors, the bias, the
// masks, the y scratch and attn_scratch are f32, x/ctr/weights/kv/q/acc/h/out
// are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). m1 and m2 are both null or
// both (B_,) arrays. act: an Act code.
int swin_block_forward(int is_bf16, int act, int d, int b, int m, int c, int heads, int hidden,
                       int q_ind, int attn_tiles, int attn_key_tiled, float scale, const void* x,
                       const void* ctr, const float* g_q,
                       const float* b_q_ln, const float* g_kv, const float* b_kv_ln,
                       const void* w_q, const float* b_q, const void* w_kv, const float* b_kv,
                       const void* w_p, const float* b_p, const float* g_2, const float* b_2_ln,
                       const void* w_1, const float* b_1, const void* w_2, const float* b_2,
                       const float* bias, void* kv, void* q, void* acc, void* out, float* y,
                       void* h, const float* m1, const float* m2, float* attn_scratch,
                       void* stream) {
  LnProjArgs p;
  p.d = d;
  p.b = b;
  p.m = m;
  p.c = c;
  p.q_ind = q_ind;
  p.x = x;
  p.ctr = ctr;
  p.g_q = g_q;
  p.b_q_ln = b_q_ln;
  p.g_kv = g_kv;
  p.b_kv_ln = b_kv_ln;
  p.w_q = w_q;
  p.w_kv = w_kv;
  p.b_q = b_q;
  p.b_kv = b_kv;
  p.kv = kv;
  p.q = q;
  BlockArgs a;
  a.b = b;
  a.m = m;
  a.c = c;
  a.hidden = hidden;
  a.act = act;
  a.ctr = ctr;
  a.acc = acc;
  a.g_2 = g_2;
  a.b_2_ln = b_2_ln;
  a.w_p = w_p;
  a.w_1 = w_1;
  a.w_2 = w_2;
  a.b_p = b_p;
  a.b_1 = b_1;
  a.b_2 = b_2;
  a.m1 = m1;
  a.m2 = m2;
  a.y = y;
  a.h = h;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(p, a, bias, heads, attn_tiles, attn_key_tiled,
                                          attn_scratch, scale, s)
              : launch_all<float>(p, a, bias, heads, attn_tiles, attn_key_tiled, attn_scratch,
                                  scale, s);
  return (int)err;
}

}  // extern "C"
