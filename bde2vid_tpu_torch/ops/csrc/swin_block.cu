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
//   (a) ln_proj_kernel: LayerNorm + k|v and q projections for 64-row tiles,
//       the centre frame substituted by choosing the row's source pointer;
//       weights stream through a 64x32 shared tile (the next tile prefetched
//       into registers), each thread owns a 4x4 register tile of outputs.
//   (b) attn_kernel: one block per (window, head); a warp per query row keeps
//       its 1 x N score row in shared memory (the TPU kept all 16 heads'
//       (H*M, N) plane resident, which does not fit in 227 KB), so head_dim 4
//       (below an MMA's K) runs as FMA dot products.
//   (c) mlp_kernel: out projection + residual + LN2 + fc1 + act + fc2 +
//       residual for 16-row tiles (8-row tiles when there are too few rows
//       to give every SM two blocks); the 4C-wide hidden rows stay in shared
//       memory, weights stream through the same 64x32 tile.
// Tensor-core MMAs, TMA and fusing (a)-(c) into one kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileO = 64;  // output columns per weight tile
constexpr int kTileK = 32;  // reduction depth per weight tile
constexpr int kWsStride = kTileK + 1;
static_assert((kTileK & (kTileK - 1)) == 0 && (kTileO * kTileK) % kThreads == 0, "tile shape");
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ T store_cast(float v);
template <>
__device__ __forceinline__ float store_cast<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value v takes after a cast to the operand type T and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

// LayerNorm of one C-wide row by one warp: dst[k] = round(LN(src)[k]).
// `src` may alias `dst` (both in shared memory).
template <typename T>
__device__ void warp_layernorm(const float* src, float* dst, int c, const float* g,
                               const float* b, int lane) {
  float s = 0.f;
  for (int k = lane; k < c; k += 32) s += src[k];
  const float mean = warp_sum(s) / c;
  float v = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float d = src[k] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / c + kLnEps);
  for (int k = lane; k < c; k += 32) dst[k] = round_to<T>((src[k] - mean) * rstd * g[k] + b[k]);
}

// acc[i][j] = sum_k A[ty + TY i][k] * W[o0 + tx + TX j][k], TY = kThreads / TX
// A: shared, row stride lda, values already in their rounded form; the block
// covers TY * RPT rows and kTileO columns. W: global (O, K) row-major ((out,
// in) like torch.nn.Linear), streamed through the shared tile Ws (kTileO x
// kWsStride). tx = tid % TX, ty = tid / TX. The next weight tile is fetched
// into registers while the current one is used, so the L2 latency of the
// stream overlaps the FMAs. Each output sums k in order, whatever TX and RPT.
template <typename T, int TX, int RPT>
__device__ void tile_gemm(const float* __restrict__ As, int lda, int k_total,
                          const T* __restrict__ W, int o_total, int o0, float* __restrict__ Ws,
                          float (&acc)[RPT][kTileO / TX]) {
  constexpr int kPerThread = kTileO * kTileK / kThreads;
  constexpr int CPT = kTileO / TX;
  constexpr int TY = kThreads / TX;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  float next[kPerThread];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + r * kThreads;
      const int o = o0 + e / kTileK, k = k0 + e % kTileK;
      next[r] = (o < o_total && k < k_total) ? load(W, (size_t)o * k_total + k) : 0.f;
    }
  };
  auto step = [&](int k) {
    float w[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) w[j] = Ws[(tx + TX * j) * kWsStride + (k & (kTileK - 1))];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = As[(ty + TY * i) * lda + k];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < k_total; k0 += kTileK) {
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + r * kThreads;
      Ws[(e / kTileK) * kWsStride + e % kTileK] = next[r];
    }
    __syncthreads();
    if (k0 + kTileK < k_total) fetch(k0 + kTileK);
    if (k_total - k0 >= kTileK) {
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) step(k0 + kk);
    } else {
      for (int kk = 0; kk < k_total - k0; ++kk) step(k0 + kk);
    }
  }
}

struct BlockArgs {
  int d, b, m, c, heads, hidden, q_ind, act;
  const void* x;    // (D, B_, M, C) buffer tokens, row q_ind ignored
  const void* ctr;  // (B_, M, C) live centre tokens
  const float *g_q, *b_q_ln, *g_kv, *b_kv_ln, *g_2, *b_2_ln;  // (C,) LN affines
  const void *w_q, *w_kv, *w_p, *w_1, *w_2;                   // (out, in) weights
  const float *b_q, *b_kv, *b_p, *b_1, *b_2;                  // biases
  const float* bias;                                          // (H, M, N) f32
  void* kv;                                                   // scratch (D, B_, M, 2C)
  void* q;                                                    // scratch (B_, M, C)
  void* acc;                                                  // (B_, M, C)
  const float *m1, *m2;                                       // (B_,) f32 masks, or null
  void* out;                                                  // (B_, M, C)
};

// (a) LN + projection. grid.x: 64-row tiles of the kv rows (D*B_*M) followed
// by 64-row tiles of the q rows (B_*M); grid.y: 64-column output tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_proj_kernel(BlockArgs a, int kv_tiles) {
  extern __shared__ float smem[];
  const int c = a.c;
  const int lda = c + 1;
  float* As = smem;
  float* Ws = smem + 64 * lda;
  const bool is_kv = blockIdx.x < (unsigned)kv_tiles;
  const int r0 = (is_kv ? blockIdx.x : blockIdx.x - kv_tiles) * 64;
  const int rows_per_frame = a.b * a.m;
  const int n_rows = is_kv ? a.d * rows_per_frame : rows_per_frame;
  const int o_total = is_kv ? 2 * c : c;
  const int o0 = blockIdx.y * kTileO;
  if (o0 >= o_total) return;
  const T* x = static_cast<const T*>(a.x);
  const T* ctr = static_cast<const T*>(a.ctr);
  const float* g = is_kv ? a.g_kv : a.g_q;
  const float* bl = is_kv ? a.b_kv_ln : a.b_q_ln;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int lr = warp; lr < 64; lr += kThreads / 32) {
    const int r = r0 + lr;
    float* row = As + lr * lda;
    if (r >= n_rows) {
      for (int k = lane; k < c; k += 32) row[k] = 0.f;
      continue;
    }
    // centre substitution by pointer: the kv rows of frame q_ind read ctr
    const T* src;
    if (!is_kv) {
      src = ctr + (size_t)r * c;
    } else if (r / rows_per_frame == a.q_ind) {
      src = ctr + (size_t)(r - a.q_ind * rows_per_frame) * c;
    } else {
      src = x + (size_t)r * c;
    }
    for (int k = lane; k < c; k += 32) row[k] = load(src, k);
    __syncwarp();
    warp_layernorm<T>(row, row, c, g, bl, lane);
  }

  float acc[4][4];
  tile_gemm<T, 16, 4>(As, lda, c, static_cast<const T*>(is_kv ? a.w_kv : a.w_q), o_total, o0, Ws,
                      acc);

  const float* bias = is_kv ? a.b_kv : a.b_q;
  T* out = static_cast<T*>(is_kv ? a.kv : a.q);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < o_total) out[(size_t)r * o_total + o] = store_cast<T>(acc[i][j] + bias[o]);
    }
  }
}

// (b) attention for one (window, head); a warp per query row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_kernel(BlockArgs a, float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const int m_tok = a.m, c = a.c;
  const int n_tok = a.d * m_tok;
  constexpr int KS = HD + 1;  // odd row stride: lanes on consecutive rows hit distinct banks
  float* qs = smem;                       // (M, HD)
  float* ks = qs + m_tok * HD;            // (N, KS)
  float* vs = ks + n_tok * KS;            // (N, KS)
  float* prow = vs + n_tok * KS;          // (warps, N)
  const T* kv = static_cast<const T*>(a.kv);
  const T* q = static_cast<const T*>(a.q);

  for (int e = threadIdx.x; e < n_tok * HD; e += kThreads) {
    const int n = e / HD, dd = e % HD;
    const int frame = n / m_tok, tok = n % m_tok;
    const size_t row = ((size_t)frame * a.b + w) * m_tok + tok;
    ks[n * KS + dd] = load(kv, row * 2 * c + h * HD + dd);
    vs[n * KS + dd] = load(kv, row * 2 * c + c + h * HD + dd);
  }
  for (int e = threadIdx.x; e < m_tok * HD; e += kThreads) {
    const int mm = e / HD, dd = e % HD;
    qs[e] = load(q, ((size_t)w * m_tok + mm) * c + h * HD + dd);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* srow = prow + warp * n_tok;
  const float* bias_h = a.bias + (size_t)h * m_tok * n_tok;
  T* acc_out = static_cast<T*>(a.acc);
  for (int mm = warp; mm < m_tok; mm += kThreads / 32) {
    float qv[HD];
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) qv[dd] = qs[mm * HD + dd];
    float mx = __int_as_float(0xff800000);  // -inf
    for (int n = lane; n < n_tok; n += 32) {
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) s = fmaf(qv[dd], ks[n * KS + dd], s);
      s = s * scale + bias_h[(size_t)mm * n_tok + n];
      srow[n] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int n = lane; n < n_tok; n += 32) {
      const float e = expf(srow[n] - mx);
      srow[n] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float o[HD];
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) o[dd] = 0.f;
    for (int n = lane; n < n_tok; n += 32) {
      const float p = round_to<T>(srow[n] / sum);
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) o[dd] = fmaf(p, vs[n * KS + dd], o[dd]);
    }
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) o[dd] = warp_sum(o[dd]);
    if (lane == 0) {
#pragma unroll
      for (int dd = 0; dd < HD; ++dd)
        acc_out[((size_t)w * m_tok + mm) * c + h * HD + dd] = store_cast<T>(o[dd]);
    }
  }
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

size_t ws_bytes() { return sizeof(float) * kTileO * kWsStride; }

template <typename T, int HD>
cudaError_t launch_attn(const BlockArgs& a, float scale, cudaStream_t stream) {
  const int n_tok = a.d * a.m;
  const size_t smem =
      sizeof(float) * ((size_t)a.m * HD + 2 * (size_t)n_tok * (HD + 1) + (kThreads / 32) * (size_t)n_tok);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_kernel<T, HD><<<dim3(a.b, a.heads), kThreads, smem, stream>>>(a, scale);
  return cudaGetLastError();
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
cudaError_t launch_all(const BlockArgs& a, float scale, cudaStream_t stream) {
  const int rows_per_frame = a.b * a.m;
  const int kv_tiles = (a.d * rows_per_frame + 63) / 64;
  const int q_tiles = (rows_per_frame + 63) / 64;
  const size_t smem_a = sizeof(float) * 64 * (size_t)(a.c + 1) + ws_bytes();
  cudaError_t err = cudaFuncSetAttribute(ln_proj_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  ln_proj_kernel<T><<<dim3(kv_tiles + q_tiles, (2 * a.c + kTileO - 1) / kTileO), kThreads, smem_a,
                      stream>>>(a, kv_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  switch (a.c / a.heads) {
    case 1: err = launch_attn<T, 1>(a, scale, stream); break;
    case 2: err = launch_attn<T, 2>(a, scale, stream); break;
    case 4: err = launch_attn<T, 4>(a, scale, stream); break;
    case 8: err = launch_attn<T, 8>(a, scale, stream); break;
    case 16: err = launch_attn<T, 16>(a, scale, stream); break;
    case 32: err = launch_attn<T, 32>(a, scale, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  // 16-row tiles unless that gives fewer than two blocks per SM (the 20
  // windows of the flagship's level 2: 62 tiles of 16 rows for 132 SMs)
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return (rows_per_frame + 15) / 16 >= 2 * sms ? launch_mlp<T, 16>(a, stream)
                                                : launch_mlp<T, 8>(a, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) each of the three kernels asks for; the wrapper
// checks these against the card's per-block limit before launching.
void swin_block_smem_bytes(int d, int m, int c, int heads, int hidden, long long* out3) {
  const int n_tok = d * m;
  const int hd = c / heads;
  out3[0] = (long long)(sizeof(float) * 64 * (size_t)(c + 1) + ws_bytes());
  out3[1] = (long long)(sizeof(float) * ((size_t)m * hd + 2 * (size_t)n_tok * (hd + 1) +
                                         (kThreads / 32) * (size_t)n_tok));
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
  BlockArgs a;
  a.d = d;
  a.b = b;
  a.m = m;
  a.c = c;
  a.heads = heads;
  a.hidden = hidden;
  a.q_ind = q_ind;
  a.act = act;
  a.x = x;
  a.ctr = ctr;
  a.g_q = g_q;
  a.b_q_ln = b_q_ln;
  a.g_kv = g_kv;
  a.b_kv_ln = b_kv_ln;
  a.g_2 = g_2;
  a.b_2_ln = b_2_ln;
  a.w_q = w_q;
  a.w_kv = w_kv;
  a.w_p = w_p;
  a.w_1 = w_1;
  a.w_2 = w_2;
  a.b_q = b_q;
  a.b_kv = b_kv;
  a.b_p = b_p;
  a.b_1 = b_1;
  a.b_2 = b_2;
  a.bias = bias;
  a.kv = kv;
  a.q = q;
  a.acc = acc;
  a.out = out;
  a.m1 = m1;
  a.m2 = m2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(a, scale, s) : launch_all<float>(a, scale, s);
  return (int)err;
}

}  // extern "C"
