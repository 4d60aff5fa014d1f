// The WindowAttention3D body for a group of windows, hand-written for Hopper
// (sm_90a), f32 or bf16 operands with f32 accumulation.
//
// Replaces: bde2vid_tpu/ops/window_attn_pallas.py::_fused_block_kernel (the
// TPU kernel behind fused_window_block), with its optional `acc` output.
//
// What it computes, per window w of B_ and token m of M (N = D*M kv tokens):
//   kv  = round(LN_kv(x) @ Wkv^T + bkv)           all D frames
//   q   = round(LN_q(x[q_ind]) @ Wq^T + bq)
//   acc = per head h: round(softmax(q_h k_h^T * hd^-0.5 + bias_h)) @ v_h
//   out = round(acc) @ Wp^T + bp
// where round() casts to the operand type where the Pallas body casts
// (identity for f32). No residual, LN2 or MLP: the caller folds the window
// outputs back onto the map and adds those (even-size dilated windows
// overlap, so the fold sums them before the residual).
//
// What bounds it on the H100: at the 8x8 BDE2VID shapes (level 0: 180
// windows, C = 64, N = 448; level 2: 12 windows, C = 256) the attention's
// 4*B_*M*N*C operations dominate; in f32 (67 TFLOP/s without tensor cores,
// no TF32 so that f32 stays exact) the kernel is bound by operations, in
// bf16 by the bytes of x.
//
// What the design does about it: B1's launches without the tail
// (window_common.cuh): the LN + q and k|v projection GEMM, fed the query
// frame x[q_ind] as the centre, the per-(window, head) attention (key-tiled
// where a window's k and v rows do not fit in one block; above head_dim 256
// the wide forward's two launches over the attention scratch), then the
// out projection on the same GEMM core with a plain prologue and a bias
// epilogue (register-blocked FMA tiles in f32, mma.sync tensor-core tiles in
// bf16). Fusing the three launches is later work.

#include "window_common.cuh"

namespace {

// out = round(acc) @ Wp^T + bp, on the GEMM core
template <typename T>
cudaError_t launch_all(const LnProjArgs& p, const void* w_p, const float* b_p, void* acc,
                       void* out, const float* bias, int heads, int attn_tiles,
                       int attn_key_tiled, float* attn_scratch, float scale, cudaStream_t stream) {
  cudaError_t err = launch_ln_proj<T>(p, stream);
  if (err != cudaSuccess) return err;
  err = launch_block_attn<T>(p, heads, attn_tiles, attn_key_tiled, bias, acc, attn_scratch, scale,
                             stream);
  if (err != cudaSuccess) return err;
  const int rows = p.b * p.m;
  const GemmArgs g{rows, p.c, p.c, acc, w_p, vec_ok(p.c, {acc, w_p}), bias_epilogue(b_p, out, p.c)};
  return launch_gemm<T>(g, stream);
}

template <typename T>
void smem_bytes(int d, int m, int c, int heads, int key_tiled, long long* out3) {
  out3[0] = (long long)ln_proj_smem_bytes<T>(c);
  out3[1] = (long long)attn_launch_smem_bytes(std::is_same<T, __nv_bfloat16>::value, m, d * m,
                                              c / heads, key_tiled);
  out3[2] = (long long)gemm_smem<T, TileS>();
}

}  // namespace

extern "C" {

// Shared memory (bytes) of the three launches at their smallest tile (the
// attention key-tiled or not); the wrapper checks these against the
// card's per-block limit before launching.
void window_block_smem_bytes(int is_bf16, int d, int m, int c, int heads, int key_tiled,
                             long long* out3) {
  if (is_bf16) {
    smem_bytes<__nv_bfloat16>(d, m, c, heads, key_tiled, out3);
  } else {
    smem_bytes<float>(d, m, c, heads, key_tiled, out3);
  }
}

// The occupancy of the attention stage's instantiation at these shapes,
// key-tiled or not (window_attention_occupancy's info).
int window_block_attn_occupancy(int is_bf16, int m, int n, int c, int heads, int key_tiled,
                                long long* info) {
  return attn_occupancy<true>(is_bf16, m, n, c, heads, key_tiled, info);
}

// Launches the three kernels on `stream` (four above head_dim 256, where
// the attention is the wide forward's two over attn_scratch, which holds
// attn_scratch_floats floats and is null below), the attention with each
// window's rows in attn_tiles tiles, by the key-tiled kernel
// (attn_key_tiled 1) or all keys at once (0); returns the first CUDA error
// code (0 on success). Pointers are device pointers; the LN affines,
// biases, the attention bias and attn_scratch are f32, x/weights/kv/q/acc/out
// are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
int window_block_forward(int is_bf16, int d, int b, int m, int c, int heads, int q_ind,
                         int attn_tiles, int attn_key_tiled, float scale, const void* x,
                         const float* g_q, const float* b_q_ln,
                         const float* g_kv, const float* b_kv_ln, const void* w_q,
                         const float* b_q, const void* w_kv, const float* b_kv, const void* w_p,
                         const float* b_p, const float* bias, void* kv, void* q, void* acc,
                         void* out, float* attn_scratch, void* stream) {
  const size_t elem = is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  LnProjArgs p;
  p.d = d;
  p.b = b;
  p.m = m;
  p.c = c;
  p.q_ind = q_ind;
  p.x = x;
  // the query frame is the centre: its kv rows read the same tokens
  p.ctr = static_cast<const char*>(x) + elem * (size_t)q_ind * b * m * c;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(p, w_p, b_p, acc, out, bias, heads, attn_tiles,
                                          attn_key_tiled, attn_scratch, scale, s)
              : launch_all<float>(p, w_p, b_p, acc, out, bias, heads, attn_tiles, attn_key_tiled,
                                  attn_scratch, scale, s);
  return (int)err;
}

}  // extern "C"
