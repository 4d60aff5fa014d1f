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
// pointers: no masks, and no multiply), and acc is written out, so the
// training forward returns it for the backward.
// where round() casts to the operand type exactly where the Pallas body
// casts (identity for f32). GELU uses the Abramowitz & Stegun 7.1.26 erf
// (|err| <= 1.5e-7), the same form as the Pallas body and the plain twin.
//
// What bounds it on the H100: per flagship launch ~3.5 GFLOP against
// ~22 MB (level 0, f32) or ~10 MB (level 2) of input, so f32 is bound by
// operations (67 TFLOP/s without tensor cores, no TF32 so that f32 stays
// exact) and bf16 sits near the memory line.
//
// What the design does about it: three launches, each a plain FMA kernel.
//   (a) ln_proj_kernel (window_common.cuh): LayerNorm + k|v and q
//       projections for 64-row tiles, the centre frame substituted by
//       choosing the row's source pointer; weights stream through a 64x32
//       shared tile (the next tile prefetched into registers), each thread
//       owns a 4x4 register tile of outputs.
//   (b) attn_kernel (window_common.cuh): one block per (window, head); a
//       warp per query row keeps its 1 x N score row in shared memory (the
//       TPU kept all 16 heads' (H*M, N) plane resident, which does not fit in
//       227 KB), so head_dim 4 (below an MMA's K) runs as FMA dot products.
//   (c) mlp_kernel: out projection + residual + LN2 + fc1 + act + fc2 +
//       residual for 16-row tiles (8-row tiles when there are too few rows
//       to give every SM two blocks); the 4C-wide hidden rows stay in shared
//       memory, weights stream through the same 64x32 tile.
// Tensor-core MMAs, TMA and fusing (a)-(c) into one kernel are later work.

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
  void* out;                           // (B_, M, C)
};

__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) *
      t;
  return s * (1.0f - poly * expf(-a * a));
}

// act: 0 = exact-erf GELU (A&S erf), 1 = ReLU
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  return 0.5f * v * (1.0f + erf_as(v * 0.7071067811865476f));
}

// (c) out projection + residual + LN2 + MLP + residual for ROWS-row tiles
// (16, or 8 when 16-row tiles would leave SMs idle).
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads) mlp_kernel(BlockArgs a) {
  constexpr int TX = kThreads / ROWS;  // threads across the 64 output columns
  constexpr int CPT = kTileO / TX;
  extern __shared__ float smem[];
  const int c = a.c, hid = a.hidden;
  const int lda = c + 1, ldh = hid + 1;
  float* As = smem;               // (ROWS, C+1): acc rows, then LN2 output
  float* ys = As + ROWS * lda;    // (ROWS, C): residual stream y
  float* hs = ys + ROWS * c;      // (ROWS, Hd+1): hidden rows
  float* Ws = hs + ROWS * ldh;    // weight tile
  const int n_rows = a.b * a.m;
  const int r0 = blockIdx.x * ROWS;
  const T* accg = static_cast<const T*>(a.acc);
  const T* ctr = static_cast<const T*>(a.ctr);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  for (int e = threadIdx.x; e < ROWS * c; e += kThreads) {
    const int lr = e / c, k = e % c;
    const int r = r0 + lr;
    As[lr * lda + k] = r < n_rows ? load(accg, (size_t)r * c + k) : 0.f;
  }

  float acc[1][CPT];
  const int r = r0 + ty;
  const bool row_ok = r < n_rows;
  // stochastic-depth multipliers of the row's window (rows are window-major)
  const bool masked = a.m1 != nullptr;
  const float m1 = masked && row_ok ? a.m1[r / a.m] : 1.f;
  const float m2 = masked && row_ok ? a.m2[r / a.m] : 1.f;
  for (int o0 = 0; o0 < c; o0 += kTileO) {
    tile_gemm<T, TX, 1>(As, lda, c, static_cast<const T*>(a.w_p), c, o0, Ws, acc);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = o0 + tx + TX * j;
      if (o < c) {
        float proj = acc[0][j] + a.b_p[o];
        if (masked) proj *= m1;
        ys[ty * c + o] = (row_ok ? load(ctr, (size_t)r * c + o) : 0.f) + proj;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int lr = warp; lr < ROWS; lr += kThreads / 32)
    warp_layernorm<T>(ys + lr * c, As + lr * lda, c, a.g_2, a.b_2_ln, lane);

  for (int o0 = 0; o0 < hid; o0 += kTileO) {
    tile_gemm<T, TX, 1>(As, lda, c, static_cast<const T*>(a.w_1), hid, o0, Ws, acc);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = o0 + tx + TX * j;
      if (o < hid) hs[ty * ldh + o] = round_to<T>(activate(acc[0][j] + a.b_1[o], a.act));
    }
  }

  T* out = static_cast<T*>(a.out);
  for (int o0 = 0; o0 < c; o0 += kTileO) {
    tile_gemm<T, TX, 1>(hs, ldh, hid, static_cast<const T*>(a.w_2), c, o0, Ws, acc);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int o = o0 + tx + TX * j;
      if (o < c && row_ok) {
        float mlp = acc[0][j] + a.b_2[o];
        if (masked) mlp *= m2;
        out[(size_t)r * c + o] = store_cast<T>(ys[ty * c + o] + mlp);
      }
    }
  }
}

size_t mlp_smem_bytes(int rows, int c, int hidden) {
  return sizeof(float) * ((size_t)rows * (c + 1) + (size_t)rows * c + (size_t)rows * (hidden + 1)) +
         ws_bytes();
}

template <typename T, int ROWS>
cudaError_t launch_mlp(const BlockArgs& a, cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes(ROWS, a.c, a.hidden);
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_kernel<T, ROWS><<<(a.b * a.m + ROWS - 1) / ROWS, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const LnProjArgs& p, const BlockArgs& a, const float* bias, int heads,
                       float scale, cudaStream_t stream) {
  cudaError_t err = launch_ln_proj<T>(p, stream);
  if (err != cudaSuccess) return err;
  err = launch_block_attn<T>(p, heads, bias, const_cast<void*>(a.acc), scale, stream);
  if (err != cudaSuccess) return err;

  // 16-row tiles unless that gives fewer than two blocks per SM (the 20
  // windows of the flagship's level 2: 62 tiles of 16 rows for 132 SMs)
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int rows = a.b * a.m;
  return (rows + 15) / 16 >= 2 * sms ? launch_mlp<T, 16>(a, stream)
                                     : launch_mlp<T, 8>(a, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) each of the three kernels asks for; the wrapper
// checks these against the card's per-block limit before launching.
void swin_block_smem_bytes(int d, int m, int c, int heads, int hidden, long long* out3) {
  out3[0] = (long long)ln_proj_smem_bytes(c);
  out3[1] = (long long)attn_smem_bytes(m, d * m, c / heads);
  out3[2] = (long long)mlp_smem_bytes(16, c, hidden);
}

// Launches the three kernels on `stream`; returns the first CUDA error code
// (0 on success). Pointers are device pointers; vectors, the bias and the
// masks are f32, x/ctr/weights/scratch/acc/out are f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1). m1 and m2 are both null or both (B_,) arrays.
int swin_block_forward(int is_bf16, int act, int d, int b, int m, int c, int heads, int hidden,
                       int q_ind, float scale, const void* x, const void* ctr, const float* g_q,
                       const float* b_q_ln, const float* g_kv, const float* b_kv_ln,
                       const void* w_q, const float* b_q, const void* w_kv, const float* b_kv,
                       const void* w_p, const float* b_p, const float* g_2, const float* b_2_ln,
                       const void* w_1, const float* b_1, const void* w_2, const float* b_2,
                       const float* bias, void* kv, void* q, void* acc, void* out,
                       const float* m1, const float* m2, void* stream) {
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
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_all<__nv_bfloat16>(p, a, bias, heads, scale, s)
                                  : launch_all<float>(p, a, bias, heads, scale, s);
  return (int)err;
}

}  // extern "C"
