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
// What the design does about it: one block of 512 threads per (group of
// windows, head); the wrapper picks the groups.
//   - The TPU kernel summed dbias into one output block that every grid
//     step revisits, which is safe only because the TPU grid runs in order.
//     Here a block loops over its group's windows and sums its (M, N) ds
//     plane in shared memory (49 x 343 f32 = 67 KB), writes one partial per
//     group, and dbias_reduce_kernel sums the partials in a fixed order:
//     two runs give bit-identical gradients, with no float atomics.
//   - Pass 1, a warp per query row: a lane keeps its share of the row's
//     scores and dp (J = 12, 16 or 32 keys, which the wrapper's plan
//     chooses from N, so at most 1024 keys a row) in registers through
//     softmax, dp, ds and dq (dq's head_dim sums in one butterfly per
//     component); the row's max, 1 / sum and rowsum(dp * p32) go to shared
//     memory.
//   - Pass 2, S lanes per key token (S = 1..8, chosen at launch so that the
//     key rounds leave few lanes idle; two tokens a lane at head_dim <= 4
//     where one block fills an SM, so that each q and g row read feeds
//     both), each over every S-th query row:
//     recompute p32 and ds for its column from those row statistics (the
//     same float operations in the same order, so the values are the bits
//     of pass 1), accumulate dk and dv in registers, and add the S partial
//     sums with a fixed butterfly of warp shuffles. Nothing of size (M, N)
//     leaves the SM.
//   - Per element, both passes take exp as one ex2.approx of
//     fmaf(s, log2 e, -max log2 e) and multiply by one reciprocal of the
//     row's sum, kept per row; q, g, k
//     and v rows load as float4 from shared memory where head_dim is a
//     multiple of 4 (rows padded against bank conflicts), and pass 2 loads
//     each bias element one row ahead of its use.
//   - Occupancy: 16 warps a block, and two blocks per SM where shared
//     memory allows (head_dim <= 8 at N <= 384: `__launch_bounds__` caps
//     registers at 64 there).
//   - Long rows (J = 0, the variant the wrapper's attn_core_bwd_plan picks
//     where a row has more than 32 x 32 keys or the (M, N) plane does not
//     fit in shared memory beside the k/v rows): pass 1 keeps nothing of
//     the row in registers and sweeps its keys three times, recomputing
//     the scores each time: the row's max; its sum of exponentials and of
//     dp times them; then ds, dq and the dbias sums. The ds sums go to the
//     block's own (M, N) slice of the global partial buffer instead of
//     shared memory: one block owns the slice and walks its windows in
//     order, so a plain read-modify-write needs no atomics and two runs
//     stay bit-identical. Pass 2 is the one above with a key a lane. Only
//     the k/v and q/g rows stay in shared memory, so the row length is
//     bounded by those alone. It is right first and not tuned.
//   - head_dim 4 (level 0) is below an MMA's K, so every product is an FMA
//     dot product templated on head_dim 1-32.

#include "device_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct BwdArgs {
  int b, m, n, c, heads, groups;
  int slices;  // pass 2: lanes per key token
  float scale;
  const void *q, *k, *v, *g;  // (B_, M, C), (B_, N, C), (B_, N, C), (B_, M, C)
  const float* bias;          // (H, M, N) f32
  void *dq, *dk, *dv;         // like q, k, v
  float* partial;             // (groups, H, M, N) f32 scratch
};

// The k, v, q and g rows, three row statistics, and with J > 0 the
// block's (M, N) dbias plane.
size_t bwd_smem_floats(int m, int n, int hd, int j) {
  return 2 * ((size_t)n + m) * key_stride(hd) + 3 * (size_t)m + (j ? (size_t)m * n : 0);
}

// Keys a pass-2 lane takes: two at head_dim <= 4 where one block fills an
// SM (J > 12: 128 registers), so that each q and g row loaded from shared
// memory feeds both; else one, as registers run out (and for long rows, J = 0).
__host__ __device__ constexpr int keys_per_lane(int hd, int j) { return hd <= 4 && j > 12 ? 2 : 1; }

// Lanes per key in pass 2 (1, 2, 4 or 8): the fewest that minimise one
// warp's share, (rounds of key groups) x (rows per lane).
int pass2_slices(int m, int n, int hd, int j) {
  const int kpt = keys_per_lane(hd, j);
  int best = 1;
  long long best_t = -1;
  for (int s = 1; s <= 8; s <<= 1) {
    const int keys = kpt * 32 / s;
    const long long rounds = ((n + keys - 1) / keys + kWarps - 1) / kWarps;
    const long long t = rounds * ((m + s - 1) / s);
    if (best_t < 0 || t < best_t) {
      best_t = t;
      best = s;
    }
  }
  return best;
}

// Two blocks per SM where a lane's row share and head_dim leave room in 64
// registers, else one. J = 0 is the long-row variant.
template <typename T, int HD, int J>
__global__ void __launch_bounds__(kThreads, (HD <= 8 && J <= 12) ? 2 : 1)
    attn_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int grp = blockIdx.x, h = blockIdx.y;
  const int m_tok = a.m, n_tok = a.n, c = a.c;
  constexpr int KS = key_stride(HD);
  float* ks = smem;                        // (N, KS)
  float* vs = ks + n_tok * KS;             // (N, KS)
  float* qs = vs + n_tok * KS;             // (M, KS)
  float* gs = qs + m_tok * KS;             // (M, KS)
  float* row_mxl = gs + m_tok * KS;        // (M): the row's max score * log2 e
  float* row_inv = row_mxl + m_tok;        // (M): 1 / the row's sum of exponentials
  float* row_dot = row_inv + m_tok;        // (M): rowsum(dp * p32)
  // (M, N): ds summed over this block's windows, in shared memory, or for
  // long rows in the block's slice of the global partial buffer
  float* dbias = J ? row_dot + m_tok : a.partial + ((size_t)grp * a.heads + h) * m_tok * n_tok;

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
  // pass 2: lane = key slot * S + slice; a warp covers KPT * 32 / S keys
  constexpr int KPT = keys_per_lane(HD, J);
  const int S = a.slices, keys_per_warp = KPT * 32 / S;
  const int slot = lane / S, slice = lane % S;

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
      qs[i * KS + dd] = load(q, src);
      gs[i * KS + dd] = load(g, src);
    }
    __syncthreads();

    if constexpr (J > 0) {
      // pass 1: a warp per query row, the lane's keys lane + 32 j in registers
      for (int i = warp; i < m_tok; i += kWarps) {
        float qv[HD], gv[HD];
        load_row<HD>(qv, qs + i * KS);
        load_row<HD>(gv, gs + i * KS);
        const float* brow = bias_h + (size_t)i * n_tok;
        float sv[J], dpv[J];
        float mx = __int_as_float(0xff800000);  // -inf
  #pragma unroll
        for (int j = 0; j < J; ++j) {
          const int nn = lane + 32 * j;
          sv[j] = 0.f;
          dpv[j] = 0.f;
          if (nn < n_tok) {
            float kr[HD], vr[HD];
            load_row<HD>(kr, ks + nn * KS);
            load_row<HD>(vr, vs + nn * KS);
            sv[j] = fmaf(dot<HD>(qv, kr), scale, brow[nn]);
            dpv[j] = dot<HD>(gv, vr);
            mx = fmaxf(mx, sv[j]);
          }
        }
        const float mxl = warp_max(mx) * kLog2e;
        float sum = 0.f;
  #pragma unroll
        for (int j = 0; j < J; ++j) {
          if (lane + 32 * j < n_tok) {
            sv[j] = fast_exp2(fmaf(sv[j], kLog2e, -mxl));
            sum += sv[j];
          }
        }
        const float inv = 1.f / warp_sum(sum);
        float rdot = 0.f;
  #pragma unroll
        for (int j = 0; j < J; ++j) {
          if (lane + 32 * j < n_tok) {
            sv[j] *= inv;  // p32
            rdot = fmaf(dpv[j], sv[j], rdot);
          }
        }
        rdot = warp_sum(rdot);
        float dqa[HD];
  #pragma unroll
        for (int dd = 0; dd < HD; ++dd) dqa[dd] = 0.f;
        float* drow = dbias + (size_t)i * n_tok;
  #pragma unroll
        for (int j = 0; j < J; ++j) {
          const int nn = lane + 32 * j;
          if (nn < n_tok) {
            const float ds = sv[j] * (dpv[j] - rdot);
            drow[nn] += ds;
            const float dsc = round_to<T>(ds * scale);
            float kr[HD];
            load_row<HD>(kr, ks + nn * KS);
  #pragma unroll
            for (int dd = 0; dd < HD; ++dd) dqa[dd] = fmaf(dsc, kr[dd], dqa[dd]);
          }
        }
  #pragma unroll
        for (int dd = 0; dd < HD; ++dd) dqa[dd] = warp_sum(dqa[dd]);
        if (lane == 0) {
          row_mxl[i] = mxl;
          row_inv[i] = inv;
          row_dot[i] = rdot;
          const size_t dst = ((size_t)w * m_tok + i) * c + h * HD;
  #pragma unroll
          for (int dd = 0; dd < HD; ++dd) dq[dst + dd] = store_cast<T>(dqa[dd]);
        }
      }
    } else {
      // pass 1, long rows: a warp per query row sweeps the lane's keys
      // lane + 32 t three times, recomputing the scores
      for (int i = warp; i < m_tok; i += kWarps) {
        float qv[HD], gv[HD];
        load_row<HD>(qv, qs + i * KS);
        load_row<HD>(gv, gs + i * KS);
        const float* brow = bias_h + (size_t)i * n_tok;
        float mx = __int_as_float(0xff800000);  // -inf
        for (int nn = lane; nn < n_tok; nn += 32) {
          float kr[HD];
          load_row<HD>(kr, ks + nn * KS);
          mx = fmaxf(mx, fmaf(dot<HD>(qv, kr), scale, brow[nn]));
        }
        const float mxl = warp_max(mx) * kLog2e;
        float sum = 0.f, dpe = 0.f;
        for (int nn = lane; nn < n_tok; nn += 32) {
          float kr[HD], vr[HD];
          load_row<HD>(kr, ks + nn * KS);
          load_row<HD>(vr, vs + nn * KS);
          const float e = fast_exp2(fmaf(fmaf(dot<HD>(qv, kr), scale, brow[nn]), kLog2e, -mxl));
          sum += e;
          dpe = fmaf(dot<HD>(gv, vr), e, dpe);
        }
        const float inv = 1.f / warp_sum(sum);
        const float rdot = warp_sum(dpe) * inv;  // rowsum(dp * p32)
        float dqa[HD];
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) dqa[dd] = 0.f;
        float* drow = dbias + (size_t)i * n_tok;
        for (int nn = lane; nn < n_tok; nn += 32) {
          float kr[HD], vr[HD];
          load_row<HD>(kr, ks + nn * KS);
          load_row<HD>(vr, vs + nn * KS);
          // the float operations of pass 2, so both passes see the same p32 and ds
          const float s = fmaf(dot<HD>(qv, kr), scale, brow[nn]);
          const float p32 = fast_exp2(fmaf(s, kLog2e, -mxl)) * inv;
          const float ds = p32 * (dot<HD>(gv, vr) - rdot);
          drow[nn] += ds;
          const float dsc = round_to<T>(ds * scale);
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) dqa[dd] = fmaf(dsc, kr[dd], dqa[dd]);
        }
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) dqa[dd] = warp_sum(dqa[dd]);
        if (lane == 0) {
          row_mxl[i] = mxl;
          row_inv[i] = inv;
          row_dot[i] = rdot;
          const size_t dst = ((size_t)w * m_tok + i) * c + h * HD;
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) dq[dst + dd] = store_cast<T>(dqa[dd]);
        }
      }
    }
    __syncthreads();

    // pass 2: S lanes per KPT key tokens, each over rows slice, slice + S,
    // ...; dk and dv accumulate in registers and the S partial sums meet
    // in a fixed butterfly
    for (int base = warp * keys_per_warp; base < n_tok; base += kWarps * keys_per_warp) {
      int nn[KPT], nc[KPT];
      float kv_[KPT][HD], vv[KPT][HD], dka[KPT][HD], dva[KPT][HD], b_next[KPT];
#pragma unroll
      for (int t = 0; t < KPT; ++t) {
        nn[t] = base + slot + t * (32 / S);
        nc[t] = nn[t] < n_tok ? nn[t] : n_tok - 1;  // idle lanes still join the shuffles
        load_row<HD>(kv_[t], ks + nc[t] * KS);
        load_row<HD>(vv[t], vs + nc[t] * KS);
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) {
          dka[t][dd] = 0.f;
          dva[t][dd] = 0.f;
        }
        // the bias column streams from L2: its next element loads one row ahead
        b_next[t] = slice < m_tok ? __ldg(bias_h + (size_t)slice * n_tok + nc[t]) : 0.f;
      }
      for (int i = slice; i < m_tok; i += S) {
        float b_i[KPT];
#pragma unroll
        for (int t = 0; t < KPT; ++t) {
          b_i[t] = b_next[t];
          if (i + S < m_tok) b_next[t] = __ldg(bias_h + (size_t)(i + S) * n_tok + nc[t]);
        }
        float qi[HD], gi[HD];
        load_row<HD>(qi, qs + i * KS);
        load_row<HD>(gi, gs + i * KS);
        const float mxl = row_mxl[i], inv = row_inv[i], rdot = row_dot[i];
#pragma unroll
        for (int t = 0; t < KPT; ++t) {
          const float s = fmaf(dot<HD>(qi, kv_[t]), scale, b_i[t]);
          const float p32 = fast_exp2(fmaf(s, kLog2e, -mxl)) * inv;
          const float dp = dot<HD>(gi, vv[t]);
          const float ds = p32 * (dp - rdot);
          const float p = round_to<T>(p32);
          const float dsc = round_to<T>(ds * scale);
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) {
            dva[t][dd] = fmaf(p, gi[dd], dva[t][dd]);
            dka[t][dd] = fmaf(dsc, qi[dd], dka[t][dd]);
          }
        }
      }
      for (int o = 1; o < S; o <<= 1) {
#pragma unroll
        for (int t = 0; t < KPT; ++t) {
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) {
            dka[t][dd] += __shfl_xor_sync(0xffffffffu, dka[t][dd], o);
            dva[t][dd] += __shfl_xor_sync(0xffffffffu, dva[t][dd], o);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < KPT; ++t) {
        if (nn[t] < n_tok && slice == 0) {
          const size_t dst = ((size_t)w * n_tok + nn[t]) * c + h * HD;
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) {
            dk[dst + dd] = store_cast<T>(dka[t][dd]);
            dv[dst + dd] = store_cast<T>(dva[t][dd]);
          }
        }
      }
    }
  }
  if constexpr (J > 0) {
    __syncthreads();
    float* part = a.partial + ((size_t)grp * a.heads + h) * m_tok * n_tok;
    for (int e = tid; e < m_tok * n_tok; e += kThreads) part[e] = dbias[e];
  }
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

// Launches the instantiation for (T, HD, J) when `a` is given; otherwise
// writes its occupancy at `smem` bytes to info: registers, local (spill)
// bytes per thread, dynamic shared memory per block, threads per block,
// resident blocks per SM.
template <typename T, int HD, int J>
cudaError_t run(const BwdArgs* a, size_t smem, long long* info, cudaStream_t stream) {
  auto kernel = attn_bwd_kernel<T, HD, J>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a != nullptr) {
    kernel<<<dim3(a->groups, a->heads), kThreads, smem, stream>>>(*a);
    return cudaGetLastError();
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (long long)attr.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = kThreads;
  info[4] = blocks;
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t run_j(int j, const BwdArgs* a, size_t smem, long long* info, cudaStream_t stream) {
  switch (j) {
    case 0: return run<T, HD, 0>(a, smem, info, stream);
    case 12: return run<T, HD, 12>(a, smem, info, stream);
    case 16: return run<T, HD, 16>(a, smem, info, stream);
    case 32: return run<T, HD, 32>(a, smem, info, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_hd(int hd, int j, const BwdArgs* a, size_t smem, long long* info,
                   cudaStream_t stream) {
  switch (hd) {
    case 1: return run_j<T, 1>(j, a, smem, info, stream);
    case 2: return run_j<T, 2>(j, a, smem, info, stream);
    case 4: return run_j<T, 4>(j, a, smem, info, stream);
    case 8: return run_j<T, 8>(j, a, smem, info, stream);
    case 16: return run_j<T, 16>(j, a, smem, info, stream);
    case 32: return run_j<T, 32>(j, a, smem, info, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Launches the variant with row share j (0: long rows; the wrapper's
// attn_core_bwd_plan picks it from the shapes) with `a` (setting its pass-2
// slices), or writes the occupancy and J, S to info[0..6] when `a` is null.
cudaError_t dispatch(int is_bf16, int m, int n, int c, int heads, int j, BwdArgs* a,
                     long long* info, cudaStream_t stream) {
  if (heads < 1 || c % heads || (j && n > 32 * j)) return cudaErrorInvalidValue;
  const int hd = c / heads, slices = pass2_slices(m, n, hd, j);
  if (a != nullptr) {
    a->slices = slices;
  } else {
    info[5] = j;
    info[6] = slices;
  }
  const size_t smem = sizeof(float) * bwd_smem_floats(m, n, hd, j);
  return is_bf16 ? run_hd<__nv_bfloat16>(hd, j, a, smem, info, stream)
                 : run_hd<float>(hd, j, a, smem, info, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) the backward kernel with row share j asks for (the
// wrapper's attn_core_bwd_smem_bytes computes the same).
long long attn_core_bwd_smem_bytes(int m, int n, int c, int heads, int j) {
  return (long long)(sizeof(float) * bwd_smem_floats(m, n, c / heads, j));
}

// The instantiation a launch at these shapes with row share j takes:
// info[0..6] = registers, local (spill) bytes per thread, dynamic shared
// memory per block, threads per block, resident blocks per SM, J (keys a
// lane keeps of a row; 0 for long rows) and S (lanes per key in pass 2).
// Returns the CUDA error code (0 on success).
int attn_core_bwd_occupancy(int is_bf16, int m, int n, int c, int heads, int j, long long* info) {
  return (int)dispatch(is_bf16, m, n, c, heads, j, nullptr, info, nullptr);
}

// Launches the backward with row share j (12, 16 or 32 keys a lane, N <=
// 32 j; or 0, long rows) and the dbias reduction on `stream`; returns the
// first CUDA error code (0 on success). q/k/v/g/dq/dk/dv are f32 (is_bf16 =
// 0) or bf16 (is_bf16 = 1); bias, partial and dbias are f32.
int attn_core_backward(int is_bf16, int b, int m, int n, int c, int heads, int groups, int j,
                       float scale,
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
  cudaError_t err = dispatch(is_bf16, m, n, c, heads, j, &a, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)heads * m * n;
  dbias_reduce_kernel<<<(unsigned)((plane + 255) / 256), 256, 0, s>>>(partial, dbias, groups,
                                                                      plane);
  return (int)cudaGetLastError();
}

}  // extern "C"
