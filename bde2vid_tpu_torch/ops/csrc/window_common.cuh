// Device code shared by the window-attention kernels (swin_block.cu,
// window_block.cu, window_attention.cu): operand loads and casts, warp
// reductions, the LayerNorm + projection tile loop and the per-(window,
// head) attention with a warp per query row. f32 or bf16 operands, f32
// accumulation; round() below means a cast to the operand type and back,
// placed where the Pallas bodies in bde2vid_tpu/ops/window_attn_pallas.py
// cast.
#pragma once

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

size_t ws_bytes() { return sizeof(float) * kTileO * kWsStride; }

// ---------------------------------------------------------------------------
// LayerNorm + q and k|v projections
// ---------------------------------------------------------------------------

struct LnProjArgs {
  int d, b, m, c, q_ind;
  const void* x;    // (D, B_, M, C) buffer tokens; the rows of frame q_ind are not read
  const void* ctr;  // (B_, M, C) centre tokens: the query rows and frame q_ind's kv rows
  const float *g_q, *b_q_ln, *g_kv, *b_kv_ln;  // (C,) LN affines
  const void *w_q, *w_kv;                      // (C, C), (2C, C) weights, (out, in)
  const float *b_q, *b_kv;                     // (C,), (2C,) biases
  void* kv;                                    // out: (D, B_, M, 2C) k|v rows
  void* q;                                     // out: (B_, M, C)
};

// kv = round(LN_kv(x with frame q_ind replaced by ctr) @ Wkv^T + bkv),
// q = round(LN_q(ctr) @ Wq^T + bq). grid.x: 64-row tiles of the kv rows
// (D*B_*M) followed by 64-row tiles of the q rows (B_*M); grid.y: 64-column
// output tiles. Each thread owns a 4x4 register tile of outputs.
// kGemmBlocksPerSm: three blocks per SM (at most 85 registers). Left to
// itself nvcc takes 128 registers here, two blocks fit, and the flagship's
// level-0 launch runs 25 % longer.
constexpr int kGemmBlocksPerSm = 3;

template <typename T>
__global__ void __launch_bounds__(kThreads, kGemmBlocksPerSm)
    ln_proj_kernel(LnProjArgs a, int kv_tiles) {
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

size_t ln_proj_smem_bytes(int c) { return sizeof(float) * 64 * (size_t)(c + 1) + ws_bytes(); }

template <typename T>
cudaError_t launch_ln_proj(const LnProjArgs& a, cudaStream_t stream) {
  const int rows_per_frame = a.b * a.m;
  const int kv_tiles = (a.d * rows_per_frame + 63) / 64;
  const int q_tiles = (rows_per_frame + 63) / 64;
  const size_t smem = ln_proj_smem_bytes(a.c);
  cudaError_t err = cudaFuncSetAttribute(ln_proj_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_proj_kernel<T><<<dim3(kv_tiles + q_tiles, (2 * a.c + kTileO - 1) / kTileO), kThreads, smem,
                      stream>>>(a, kv_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// attention core: per window w and head h,
//   out_h = round(softmax(q_h k_h^T * scale + bias_h)) @ v_h
// ---------------------------------------------------------------------------

// The kv tokens of window w come in one of two layouts. The block kernels
// read the (D, B_, M, 2C) k|v scratch that ln_proj_kernel writes (kKvScratch:
// token n is frame n / M, token n % M, with v C elements after k); the bare
// attention reads separate (B_, N, C) k and v.
struct AttnArgs {
  int b, m, n, c, heads;
  const void* q;  // (B_, M, C)
  const void* k;  // k|v scratch (kKvScratch), else (B_, N, C)
  const void* v;  // (B_, N, C) (unused with kKvScratch)
  const float* bias;  // (H, M, N) f32
  void* out;          // (B_, M, C)
};

// One block per (window, head); a warp per query row keeps its 1 x N score
// row in shared memory, so head_dim 4 (below an MMA's K) runs as FMA dot
// products.
template <typename T, int HD, bool kKvScratch>
__global__ void __launch_bounds__(kThreads) attn_kernel(AttnArgs a, float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const int m_tok = a.m, n_tok = a.n, c = a.c;
  constexpr int KS = HD + 1;  // odd row stride: lanes on consecutive rows hit distinct banks
  float* qs = smem;                       // (M, HD)
  float* ks = qs + m_tok * HD;            // (N, KS)
  float* vs = ks + n_tok * KS;            // (N, KS)
  float* prow = vs + n_tok * KS;          // (warps, N)
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = kKvScratch ? kg + c : static_cast<const T*>(a.v);
  const T* q = static_cast<const T*>(a.q);

  for (int e = threadIdx.x; e < n_tok * HD; e += kThreads) {
    const int n = e / HD, dd = e % HD;
    size_t off;
    if (kKvScratch) {
      const int frame = n / m_tok, tok = n % m_tok;
      off = (((size_t)frame * a.b + w) * m_tok + tok) * 2 * c + h * HD + dd;
    } else {
      off = ((size_t)w * n_tok + n) * c + h * HD + dd;
    }
    ks[n * KS + dd] = load(kg, off);
    vs[n * KS + dd] = load(vg, off);
  }
  for (int e = threadIdx.x; e < m_tok * HD; e += kThreads) {
    const int mm = e / HD, dd = e % HD;
    qs[e] = load(q, ((size_t)w * m_tok + mm) * c + h * HD + dd);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* srow = prow + warp * n_tok;
  const float* bias_h = a.bias + (size_t)h * m_tok * n_tok;
  T* out = static_cast<T*>(a.out);
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
        out[((size_t)w * m_tok + mm) * c + h * HD + dd] = store_cast<T>(o[dd]);
    }
  }
}

size_t attn_smem_bytes(int m, int n, int hd) {
  return sizeof(float) *
         ((size_t)m * hd + 2 * (size_t)n * (hd + 1) + (kThreads / 32) * (size_t)n);
}

template <typename T, int HD, bool kKvScratch>
cudaError_t launch_attn_hd(const AttnArgs& a, float scale, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(a.m, a.n, HD);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T, HD, kKvScratch>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_kernel<T, HD, kKvScratch><<<dim3(a.b, a.heads), kThreads, smem, stream>>>(a, scale);
  return cudaGetLastError();
}

template <typename T, bool kKvScratch>
cudaError_t launch_attn(const AttnArgs& a, float scale, cudaStream_t stream) {
  switch (a.c / a.heads) {
    case 1: return launch_attn_hd<T, 1, kKvScratch>(a, scale, stream);
    case 2: return launch_attn_hd<T, 2, kKvScratch>(a, scale, stream);
    case 4: return launch_attn_hd<T, 4, kKvScratch>(a, scale, stream);
    case 8: return launch_attn_hd<T, 8, kKvScratch>(a, scale, stream);
    case 16: return launch_attn_hd<T, 16, kKvScratch>(a, scale, stream);
    case 32: return launch_attn_hd<T, 32, kKvScratch>(a, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The attention over the k|v scratch that ln_proj_kernel writes.
template <typename T>
cudaError_t launch_block_attn(const LnProjArgs& p, int heads, const float* bias, void* out,
                              float scale, cudaStream_t stream) {
  AttnArgs a;
  a.b = p.b;
  a.m = p.m;
  a.n = p.d * p.m;
  a.c = p.c;
  a.heads = heads;
  a.q = p.q;
  a.k = p.kv;
  a.v = nullptr;
  a.bias = bias;
  a.out = out;
  return launch_attn<T, true>(a, scale, stream);
}

}  // namespace
