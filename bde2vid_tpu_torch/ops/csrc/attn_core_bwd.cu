// Backward of the windowed multi-head attention core, hand-written for
// Hopper (sm_90a), f32 or bf16 operands with f32 accumulation.
//
// Replaces: bde2vid_tpu/ops/window_attn_pallas.py::_bwd_kernel (math in
// _attn_core_bwd_body), the TPU kernel behind every custom_vjp backward of
// that file.
//
// What it computes, per window w of B_ and head h (head_dim HD, scale =
// HD^-0.5), with q, g (M, C) and k, v (N, C) sliced to the head's channels:
//   p32 = softmax(q k^T * scale + bias_h)         (f32, recomputed)
//   p   = round(p32)
//   dv  = p^T g,   dp = g v^T
//   ds  = p32 * (dp - rowsum(dp * p32))            (f32)
//   dsc = round(ds * scale)
//   dq  = dsc k,   dk = dsc^T q
//   dbias_h = sum over all windows of ds          (f32)
// round() casts to the operand type exactly where the Pallas body casts
// (identity for f32).
//
// What bounds it on the H100: 5 products of M*N*HD multiply-adds per
// (window, head), 2.7 GFLOP at the flagship's level 0 in f32 against about
// 100 MB of inputs and outputs, so f32 is bound by operations (67 TFLOP/s
// without tensor cores) and bf16 near the memory line.
//
// What the design does about it (a simple first version; speed is later
// work): one block per (group of windows, head), 16 groups by default.
//   - The TPU kernel summed dbias into one output block that every grid
//     step revisits, which is safe only because the TPU grid runs in order.
//     Here a block loops over its group's windows and sums its (M, N) ds
//     plane in shared memory (49 x 343 f32 = 67 KB), writes one partial per
//     group, and dbias_reduce_kernel sums the partials in a fixed order:
//     two runs give bit-identical gradients, with no float atomics.
//   - Pass 1, a warp per query row: scores, softmax, dp, ds, dq for the row;
//     the row's max, sum and rowsum(dp * p32) go to shared memory.
//   - Pass 2, a thread per key token: recompute p32 and ds for its column
//     from those row statistics (the same float operations in the same
//     order, so the values are the bits of pass 1) and accumulate dk and dv
//     in registers. Nothing of size (M, N) leaves the SM.
//   - head_dim 4 (level 0) is below an MMA's K, so every product is an FMA
//     dot product templated on head_dim 1-32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

struct BwdArgs {
  int b, m, n, c, heads, groups;
  float scale;
  const void *q, *k, *v, *g;  // (B_, M, C), (B_, N, C), (B_, N, C), (B_, M, C)
  const float* bias;          // (H, M, N) f32
  void *dq, *dk, *dv;         // like q, k, v
  float* partial;             // (groups, H, M, N) f32 scratch
};

size_t bwd_smem_floats(int m, int n, int hd) {
  return 2 * (size_t)n * (hd + 1) + 2 * (size_t)m * hd + 3 * (size_t)m +
         2 * (size_t)kWarps * n + (size_t)m * n;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int grp = blockIdx.x, h = blockIdx.y;
  const int m_tok = a.m, n_tok = a.n, c = a.c;
  constexpr int KS = HD + 1;  // odd row stride: lanes on consecutive rows hit distinct banks
  float* ks = smem;                        // (N, KS)
  float* vs = ks + n_tok * KS;             // (N, KS)
  float* qs = vs + n_tok * KS;             // (M, HD)
  float* gs = qs + m_tok * HD;             // (M, HD)
  float* row_max = gs + m_tok * HD;        // (M)
  float* row_sum = row_max + m_tok;        // (M)
  float* row_dot = row_sum + m_tok;        // (M): rowsum(dp * p32)
  float* pbuf = row_dot + m_tok;           // (warps, N): the warp's p32 row
  float* dpbuf = pbuf + kWarps * n_tok;    // (warps, N): the warp's dp row
  float* dbias = dpbuf + kWarps * n_tok;   // (M, N): ds summed over this block's windows

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const float* bias_h = a.bias + (size_t)h * m_tok * n_tok;
  const float scale = a.scale;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w_begin = (int)((long long)grp * a.b / a.groups);
  const int w_end = (int)((long long)(grp + 1) * a.b / a.groups);

  for (int e = tid; e < m_tok * n_tok; e += kThreads) dbias[e] = 0.f;

  for (int w = w_begin; w < w_end; ++w) {
    __syncthreads();  // the previous window is done with ks/vs/qs/gs
    for (int e = tid; e < n_tok * HD; e += kThreads) {
      const int nn = e / HD, dd = e % HD;
      const size_t src = ((size_t)w * n_tok + nn) * c + h * HD + dd;
      ks[nn * KS + dd] = load(k, src);
      vs[nn * KS + dd] = load(v, src);
    }
    for (int e = tid; e < m_tok * HD; e += kThreads) {
      const int i = e / HD, dd = e % HD;
      const size_t src = ((size_t)w * m_tok + i) * c + h * HD + dd;
      qs[e] = load(q, src);
      gs[e] = load(g, src);
    }
    __syncthreads();

    // pass 1: a warp per query row
    float* prow = pbuf + warp * n_tok;
    float* dprow = dpbuf + warp * n_tok;
    for (int i = warp; i < m_tok; i += kWarps) {
      float qv[HD], gv[HD];
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        qv[dd] = qs[i * HD + dd];
        gv[dd] = gs[i * HD + dd];
      }
      const float* brow = bias_h + (size_t)i * n_tok;
      float mx = __int_as_float(0xff800000);  // -inf
      for (int nn = lane; nn < n_tok; nn += 32) {
        const float s = fmaf(dot<HD>(qv, ks + nn * KS), scale, brow[nn]);
        prow[nn] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int nn = lane; nn < n_tok; nn += 32) {
        const float e = expf(prow[nn] - mx);
        prow[nn] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float rdot = 0.f;
      for (int nn = lane; nn < n_tok; nn += 32) {
        const float p32 = prow[nn] / sum;
        const float dp = dot<HD>(gv, vs + nn * KS);
        prow[nn] = p32;
        dprow[nn] = dp;
        rdot = fmaf(dp, p32, rdot);
      }
      rdot = warp_sum(rdot);
      float dqa[HD];
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) dqa[dd] = 0.f;
      float* drow = dbias + (size_t)i * n_tok;
      for (int nn = lane; nn < n_tok; nn += 32) {
        const float ds = prow[nn] * (dprow[nn] - rdot);
        drow[nn] += ds;
        const float dsc = round_to<T>(ds * scale);
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) dqa[dd] = fmaf(dsc, ks[nn * KS + dd], dqa[dd]);
      }
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) dqa[dd] = warp_sum(dqa[dd]);
      if (lane == 0) {
        row_max[i] = mx;
        row_sum[i] = sum;
        row_dot[i] = rdot;
        const size_t dst = ((size_t)w * m_tok + i) * c + h * HD;
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) dq[dst + dd] = store_cast<T>(dqa[dd]);
      }
    }
    __syncthreads();

    // pass 2: a thread per key token; dk and dv accumulate in registers
    for (int nn = tid; nn < n_tok; nn += kThreads) {
      float kv_[HD], vv[HD], dka[HD], dva[HD];
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        kv_[dd] = ks[nn * KS + dd];
        vv[dd] = vs[nn * KS + dd];
        dka[dd] = 0.f;
        dva[dd] = 0.f;
      }
      for (int i = 0; i < m_tok; ++i) {
        const float* qi = qs + i * HD;
        const float* gi = gs + i * HD;
        const float s = fmaf(dot<HD>(qi, kv_), scale, bias_h[(size_t)i * n_tok + nn]);
        const float p32 = expf(s - row_max[i]) / row_sum[i];
        const float dp = dot<HD>(gi, vv);
        const float ds = p32 * (dp - row_dot[i]);
        const float p = round_to<T>(p32);
        const float dsc = round_to<T>(ds * scale);
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) {
          dva[dd] = fmaf(p, gi[dd], dva[dd]);
          dka[dd] = fmaf(dsc, qi[dd], dka[dd]);
        }
      }
      const size_t dst = ((size_t)w * n_tok + nn) * c + h * HD;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        dk[dst + dd] = store_cast<T>(dka[dd]);
        dv[dst + dd] = store_cast<T>(dva[dd]);
      }
    }
  }
  __syncthreads();
  float* part = a.partial + ((size_t)grp * a.heads + h) * m_tok * n_tok;
  for (int e = tid; e < m_tok * n_tok; e += kThreads) part[e] = dbias[e];
}

// dbias[e] = sum over groups of partial[group][e], in group order.
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                                    int groups, long long plane) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  float s = 0.f;
  for (int gi = 0; gi < groups; ++gi) s += partial[gi * plane + e];
  dbias[e] = s;
}

template <typename T, int HD>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(a.m, a.n, HD);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_kernel<T, HD><<<dim3(a.groups, a.heads), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const BwdArgs& a, float* dbias, cudaStream_t stream) {
  cudaError_t err;
  switch (a.c / a.heads) {
    case 1: err = launch_bwd<T, 1>(a, stream); break;
    case 2: err = launch_bwd<T, 2>(a, stream); break;
    case 4: err = launch_bwd<T, 4>(a, stream); break;
    case 8: err = launch_bwd<T, 8>(a, stream); break;
    case 16: err = launch_bwd<T, 16>(a, stream); break;
    case 32: err = launch_bwd<T, 32>(a, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long plane = (long long)a.heads * a.m * a.n;
  dbias_reduce_kernel<<<(unsigned)((plane + 255) / 256), 256, 0, stream>>>(a.partial, dbias,
                                                                           a.groups, plane);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) the backward kernel asks for; the wrapper checks it
// against the card's per-block limit before launching.
long long attn_core_bwd_smem_bytes(int m, int n, int c, int heads) {
  return (long long)(sizeof(float) * bwd_smem_floats(m, n, c / heads));
}

// Launches the backward and the dbias reduction on `stream`; returns the
// first CUDA error code (0 on success). q/k/v/g/dq/dk/dv are f32 (is_bf16 =
// 0) or bf16 (is_bf16 = 1); bias, partial and dbias are f32.
int attn_core_backward(int is_bf16, int b, int m, int n, int c, int heads, int groups, float scale,
                       const void* q, const void* k, const void* v, const float* bias,
                       const void* g, void* dq, void* dk, void* dv, float* partial, float* dbias,
                       void* stream) {
  if (groups < 1 || groups > b) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.b = b;
  a.m = m;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.groups = groups;
  a.scale = scale;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.bias = bias;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.partial = partial;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(a, dbias, s) : launch_all<float>(a, dbias, s);
  return (int)err;
}

}  // extern "C"
