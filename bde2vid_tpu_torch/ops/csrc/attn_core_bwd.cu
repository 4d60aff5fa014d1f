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
//   - Key tiles (attn_bwd_tiled_kernel, which the plan picks where even
//     the long rows' k/v rows do not fit; the JAX kernel holds them whole
//     in VMEM): shared memory holds the block's q and g rows, the three
//     row statistics and an (M, HD) f32 dq accumulator, and k and v come
//     in one key tile at a time. Pass 1 sweeps the tiles for each row's
//     running max, sum of exponentials and sum of dp times them; pass 2
//     takes each tile's ds into the dbias partials and its share of dq into
//     the accumulator, as the long rows do, then dk and dv for the tile's
//     keys with the pass 2 above. Every sum runs in a fixed order, so two
//     runs give bit-identical gradients.
//   - head_dim 4 (level 0) is below an MMA's K, so every product is an FMA
//     dot product templated on head_dim 1-32; a head_dim between them runs
//     at the next one up with zero columns past it (staged, never written).
//   - Above head_dim 32 (the wide backward, any head_dim in chunks of 64
//     columns): four launches that split each (window, head) over key
//     tiles, row tiles and head_dim chunks, f32 by register-tiled FMA and
//     bf16 on the tensor cores; see attn_bwd_scores_kernel below.

#include <algorithm>
#include <type_traits>

#include "device_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct BwdArgs {
  int b, m, n, c, heads, groups;
  int hd;        // head_dim C / heads; kernels instantiated at a larger HD see zeros past it
  int slices;    // pass 2: lanes per key token
  int key_tile;  // 0, or the keys attn_bwd_tiled_kernel stages at a time
  float scale;
  const void *q, *k, *v, *g;  // (B_, M, C), (B_, N, C), (B_, N, C), (B_, M, C)
  const float* bias;          // (H, M, N) f32
  void *dq, *dk, *dv;         // like q, k, v
  float* partial;             // (groups, H, M, N) f32; the wide backward's ds planes (groups = B_)
  float* scratch;             // the wide backward's planes and statistics (WidePlanes), aligned
  bool vec;                   // the wide backward: 16-byte copies (aligned rows and head_dim)
};

// The k, v, q and g rows, three row statistics, and with J > 0 the
// block's (M, N) dbias plane; with a key tile, the k and v rows of one tile
// and the (M, HD) dq sums instead of the plane. hd is the instantiated HD
// (at most 32; the wide backward's blocks are wide_*_smem below).
size_t bwd_smem_floats(int m, int n, int hd, int j, int key_tile) {
  if (key_tile)
    return 2 * ((size_t)key_tile + m) * key_stride(hd) + 3 * (size_t)m + (size_t)m * hd;
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

// The key-tiled variant's pass 2 over keys 0 .. cnt - 1 of the staged rows
// ks, vs (token key0 + nn of the window, out0 = w N + key0): attn_bwd_kernel's
// pass 2 below over one tile, S lanes per KPT key tokens, each over rows
// slice, slice + S, ...; dk and dv accumulate in registers and the S
// partial sums meet in a fixed butterfly. bias_h points at the key0 column
// of the head's bias plane. attn_bwd_kernel keeps its own copy inline:
// calling this function from it slowed its long rows at head_dim 4 by half
// on the H100 (PERF.md, section 6).
template <typename T, int HD, int KPT>
__device__ __forceinline__ void pass2_dk_dv(const BwdArgs& a, const float* ks, const float* vs,
                                            const float* qs, const float* gs,
                                            const float* row_mxl, const float* row_inv,
                                            const float* row_dot, const float* bias_h, int cnt,
                                            size_t out0, int warp, int lane) {
  constexpr int KS = key_stride(HD);
  const int m_tok = a.m, n_tok = a.n, c = a.c, h = blockIdx.y, hd = a.hd;
  const float scale = a.scale;
  const int S = a.slices, keys_per_warp = KPT * 32 / S;
  const int slot = lane / S, slice = lane % S;
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (int base = warp * keys_per_warp; base < cnt; base += kWarps * keys_per_warp) {
    int nn[KPT], nc[KPT];
    float kv_[KPT][HD], vv[KPT][HD], dka[KPT][HD], dva[KPT][HD], b_next[KPT];
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      nn[t] = base + slot + t * (32 / S);
      nc[t] = nn[t] < cnt ? nn[t] : cnt - 1;  // idle lanes still join the shuffles
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
      if (nn[t] < cnt && slice == 0) {
        const size_t dst = (out0 + nn[t]) * c + h * hd;
#pragma unroll
        for (int dd = 0; dd < HD; ++dd) {
          if (dd < hd) {
            dk[dst + dd] = store_cast<T>(dka[t][dd]);
            dv[dst + dd] = store_cast<T>(dva[t][dd]);
          }
        }
      }
    }
  }
}

// Two blocks per SM where a lane's row share and head_dim leave room in 64
// registers, else one. J = 0 is the long-row variant.
template <typename T, int HD, int J>
__global__ void __launch_bounds__(kThreads, (HD <= 8 && J <= 12) ? 2 : 1)
    attn_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int grp = blockIdx.x, h = blockIdx.y;
  const int m_tok = a.m, n_tok = a.n, c = a.c, hd = a.hd;
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
      const size_t src = ((size_t)w * n_tok + nn) * c + h * hd + dd;
      ks[nn * KS + dd] = dd < hd ? load(k, src) : 0.f;
      vs[nn * KS + dd] = dd < hd ? load(v, src) : 0.f;
    }
    for (int e = tid; e < m_tok * HD; e += kThreads) {
      const int i = e / HD, dd = e % HD;
      const size_t src = ((size_t)w * m_tok + i) * c + h * hd + dd;
      qs[i * KS + dd] = dd < hd ? load(q, src) : 0.f;
      gs[i * KS + dd] = dd < hd ? load(g, src) : 0.f;
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
          const size_t dst = ((size_t)w * m_tok + i) * c + h * hd;
  #pragma unroll
          for (int dd = 0; dd < HD; ++dd)
            if (dd < hd) dq[dst + dd] = store_cast<T>(dqa[dd]);
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
          const size_t dst = ((size_t)w * m_tok + i) * c + h * hd;
#pragma unroll
          for (int dd = 0; dd < HD; ++dd)
            if (dd < hd) dq[dst + dd] = store_cast<T>(dqa[dd]);
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
          const size_t dst = ((size_t)w * n_tok + nn[t]) * c + h * hd;
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) {
            if (dd < hd) {
              dk[dst + dd] = store_cast<T>(dka[t][dd]);
              dv[dst + dd] = store_cast<T>(dva[t][dd]);
            }
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

// The key-tiled variant (see the header): block (group, head) walks its
// windows in order; per window, pass 1 and pass 2 each stage the key tiles
// in order. Two blocks per SM at head_dim <= 8, as the long rows run.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 8 ? 2 : 1) attn_bwd_tiled_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int grp = blockIdx.x, h = blockIdx.y;
  const int m_tok = a.m, n_tok = a.n, c = a.c, kt = a.key_tile, hd = a.hd;
  constexpr int KS = key_stride(HD);
  float* ks = smem;                     // (key_tile, KS)
  float* vs = ks + kt * KS;             // (key_tile, KS)
  float* qs = vs + kt * KS;             // (M, KS)
  float* gs = qs + m_tok * KS;          // (M, KS)
  float* row_mxl = gs + m_tok * KS;     // (M): the row's running max score * log2 e
  float* row_inv = row_mxl + m_tok;     // (M): its running sum of exp, then 1 / the sum
  float* row_dot = row_inv + m_tok;     // (M): its running sum of dp exp, then rowsum(dp * p32)
  float* dq_acc = row_dot + m_tok;      // (M, HD): dq summed over the tiles
  // ds summed over this block's windows, in its slice of the partial buffer
  float* dbias = a.partial + ((size_t)grp * a.heads + h) * m_tok * n_tok;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  T* dq = static_cast<T*>(a.dq);
  const float* bias_h = a.bias + (size_t)h * m_tok * n_tok;
  const float scale = a.scale;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w_begin = (int)((long long)grp * a.b / a.groups);
  const int w_end = (int)((long long)(grp + 1) * a.b / a.groups);

  for (size_t e = tid; e < (size_t)m_tok * n_tok; e += kThreads) dbias[e] = 0.f;

  for (int w = w_begin; w < w_end; ++w) {
    __syncthreads();  // the previous window is done with qs/gs and dq_acc
    for (int e = tid; e < m_tok * HD; e += kThreads) {
      const int i = e / HD, dd = e % HD;
      const size_t src = ((size_t)w * m_tok + i) * c + h * hd + dd;
      qs[i * KS + dd] = dd < hd ? load(q, src) : 0.f;
      gs[i * KS + dd] = dd < hd ? load(g, src) : 0.f;
      dq_acc[e] = 0.f;
    }
    for (int i = tid; i < m_tok; i += kThreads) {
      row_mxl[i] = __int_as_float(0xff800000);  // -inf
      row_inv[i] = 0.f;
      row_dot[i] = 0.f;
    }
    for (int pass = 1; pass <= 2; ++pass) {
      for (int t0 = 0; t0 < n_tok; t0 += kt) {
        const int cnt = min(kt, n_tok - t0);
        __syncthreads();  // the block is done with the previous tile (and the statistics)
        for (int e = tid; e < cnt * HD; e += kThreads) {
          const int nn = e / HD, dd = e % HD;
          const size_t src = ((size_t)w * n_tok + t0 + nn) * c + h * hd + dd;
          ks[nn * KS + dd] = dd < hd ? load(k, src) : 0.f;
          vs[nn * KS + dd] = dd < hd ? load(v, src) : 0.f;
        }
        __syncthreads();
        if (pass == 1) {
          // a warp per query row: the tile's max, then its sums of exp and of
          // dp times exp under the new running max
          for (int i = warp; i < m_tok; i += kWarps) {
            float qv[HD], gv[HD];
            load_row<HD>(qv, qs + i * KS);
            load_row<HD>(gv, gs + i * KS);
            const float* brow = bias_h + (size_t)i * n_tok + t0;
            float mx = __int_as_float(0xff800000);  // -inf
            for (int nn = lane; nn < cnt; nn += 32) {
              float kr[HD];
              load_row<HD>(kr, ks + nn * KS);
              mx = fmaxf(mx, fmaf(dot<HD>(qv, kr), scale, brow[nn]));
            }
            const float m0 = row_mxl[i];
            const float mxl = fmaxf(m0, warp_max(mx) * kLog2e);
            float sum = 0.f, dpe = 0.f;
            for (int nn = lane; nn < cnt; nn += 32) {
              float kr[HD], vr[HD];
              load_row<HD>(kr, ks + nn * KS);
              load_row<HD>(vr, vs + nn * KS);
              const float e = fast_exp2(fmaf(fmaf(dot<HD>(qv, kr), scale, brow[nn]), kLog2e, -mxl));
              sum += e;
              dpe = fmaf(dot<HD>(gv, vr), e, dpe);
            }
            const float r = fast_exp2(m0 - mxl);
            const float tsum = fmaf(row_inv[i], r, warp_sum(sum));
            const float tdot = fmaf(row_dot[i], r, warp_sum(dpe));
            __syncwarp();  // every lane has read the row's statistics
            if (lane == 0) {
              row_mxl[i] = mxl;
              row_inv[i] = tsum;
              row_dot[i] = tdot;
            }
          }
          if (t0 + cnt == n_tok) {
            __syncthreads();
            for (int i = tid; i < m_tok; i += kThreads) {
              const float inv = 1.f / row_inv[i];
              row_inv[i] = inv;
              row_dot[i] *= inv;
            }
          }
          continue;
        }
        // pass 2, a warp per query row: ds into the dbias partial and the
        // tile's share of dq into the accumulator (the float operations of
        // pass2_dk_dv, so both see the same p32 and ds)
        for (int i = warp; i < m_tok; i += kWarps) {
          float qv[HD], gv[HD];
          load_row<HD>(qv, qs + i * KS);
          load_row<HD>(gv, gs + i * KS);
          const float* brow = bias_h + (size_t)i * n_tok + t0;
          float* drow = dbias + (size_t)i * n_tok + t0;
          const float mxl = row_mxl[i], inv = row_inv[i], rdot = row_dot[i];
          float dqa[HD];
#pragma unroll
          for (int dd = 0; dd < HD; ++dd) dqa[dd] = 0.f;
          for (int nn = lane; nn < cnt; nn += 32) {
            float kr[HD], vr[HD];
            load_row<HD>(kr, ks + nn * KS);
            load_row<HD>(vr, vs + nn * KS);
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
#pragma unroll
            for (int dd = 0; dd < HD; ++dd) dq_acc[i * HD + dd] += dqa[dd];
          }
        }
        pass2_dk_dv<T, HD, 1>(a, ks, vs, qs, gs, row_mxl, row_inv, row_dot, bias_h + t0, cnt,
                              (size_t)w * n_tok + t0, warp, lane);
      }
    }
    __syncthreads();
    for (int e = tid; e < m_tok * HD; e += kThreads) {
      const int i = e / HD, dd = e % HD;
      if (dd < hd) dq[((size_t)w * m_tok + i) * c + h * hd + dd] = store_cast<T>(dq_acc[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// head_dim above 32 (the wide backward): four launches and the dbias
// reduction, in 128-thread blocks that split each (window, head) over key
// tiles, row tiles and head_dim chunks of 64 columns, so that any head_dim
// runs (zero columns past it, staged and never written) and the grid fills
// the card (B_ 20 with one head: 220 blocks of dk/dv at head_dim 64):
//   1. attn_bwd_scores_kernel, block (key tile of 32, row tile of 64,
//      window x head): s = q k^T scale + bias and dp = g v^T, summed over the
//      head_dim chunks in registers; it writes s and dp to two (B_, H, M, N)
//      f32 planes in device memory, and for each row the tile's max score,
//      sum of exp and sum of dp times exp (a warp per row, a lane per key).
//   2. attn_bwd_probs_kernel, a warp a row: the row's statistics merged over
//      the key tiles in order, then p32 and ds for each key: ds to the (B_,
//      H, M, N) plane that dbias reads, round(p) and round(ds scale) to
//      planes in the operand type.
//   3. attn_bwd_dkdv_kernel, block (key tile of 32, head_dim chunk, window x
//      head): per 64 rows at a time it copies round(p), round(ds scale), g
//      and q in (cp.async) and adds the chunk's dv = p^T g and dk = dsc^T q
//      for its keys in registers.
//   4. attn_bwd_dq_kernel, block (row tile of 32, head_dim chunk, window x
//      head): dq = round(ds scale) k over key tiles of 64, the next tile's
//      copies in flight (cp.async, two stages) while this one multiplies.
//   5. dbias_reduce_kernel sums the ds planes over the windows in order.
// Products: f32 by FMA with no TF32, each thread a 4 x 4 register tile from
// float4 rows in shared memory, 8 FMAs a load; bf16 on the tensor cores
// (mma.sync m16n8k16, f32 accumulators, ldmatrix fragments), a warp 16 x 32.
// Every output element and every partial has one owner and sums in a fixed
// order, so two runs give bit-identical gradients, with no float atomics; no
// (M, N) plane stays in shared memory across launches.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 128;
constexpr int kWideKeys = 32;   // keys of a scores tile and of a dk/dv block
constexpr int kWideRows = 64;   // rows of a scores tile; rows a dk/dv block takes at a time
constexpr int kWideCols = 64;   // head_dim columns of one chunk
constexpr int kWideQRows = 32;  // rows of a dq block
constexpr int kWideQKeys = 64;  // keys a dq block takes at a time
static_assert(kWideKeys == 32, "a lane per key of a scores tile");

// Row stride (elements) of a staged tile of `cols` columns: an odd number of
// 16-byte chunks, so eight rows read at one column fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int wide_ld(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// Shared memory of each wide launch (bytes): the scores tile's q, g, k and v
// chunks (its f32 (64, 33) s and dp planes alias them after the products);
// the dk/dv block's g and q chunks and its round(p) and round(ds scale)
// tiles; two stages of the dq block's round(ds scale) tile and k chunk.
template <typename T>
constexpr size_t wide_scores_smem() {
  return sizeof(T) * (size_t)(2 * kWideRows + 2 * kWideKeys) * wide_ld<T>(kWideCols);
}
template <typename T>
constexpr size_t wide_dkdv_smem() {
  return sizeof(T) * (size_t)kWideRows * (2 * wide_ld<T>(kWideCols) + 2 * wide_ld<T>(kWideKeys));
}
template <typename T>
constexpr size_t wide_dq_smem() {
  return sizeof(T) * 2 *
         (size_t)(kWideQRows * wide_ld<T>(kWideQKeys) + kWideQKeys * wide_ld<T>(kWideCols));
}
static_assert(wide_scores_smem<__nv_bfloat16>() >= sizeof(float) * 2 * kWideRows * (kWideKeys + 1),
              "the s and dp planes fit over the staged chunks");

// Rows [0, nrows) x columns [0, COLS) of dst (row stride ldd) from src row r
// at src + r * lds, zero past `rows` rows and `cols` columns. vec: 16-byte
// cp.async (src rows 16-byte aligned, cols a multiple of 16 bytes), which
// the caller commits and waits for; else plain loads.
template <typename T, int COLS>
__device__ __forceinline__ void wide_stage(T* dst, int ldd, const T* src, size_t lds, int nrows,
                                           int rows, int cols, bool vec) {
  constexpr int CH = 16 / (int)sizeof(T), PER = COLS / CH;
  if (vec) {
    for (int e = threadIdx.x; e < nrows * PER; e += kWideThreads) {
      const int r = e / PER, col = (e - r * PER) * CH;
      const bool in = r < rows && col < cols;
      cp_async16(dst + r * ldd + col, in ? src + r * lds + col : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * COLS; e += kWideThreads) {
      const int r = e / COLS, col = e - r * COLS;
      dst[r * ldd + col] = r < rows && col < cols ? src[r * lds + col] : store_cast<T>(0.f);
    }
  }
}

// The three products of the wide backward, each into acc[4][4] of a
// 128-thread block, and where each accumulator lands (row, column of the
// block's tile). f32: thread tiles of 4 x 4 by FMA; bf16: warp tiles of 16 x
// 32 by mma.sync (acc[j] is the 16 x 8 fragment j: rows lane / 4 and 8
// below, columns 2 (lane % 4) and the next).
//
// NT: acc (64 x 32) += a (64 x K) b (32 x K)^T, a and b row-major.
template <int K>
__device__ __forceinline__ void wide_nt(float (&acc)[4][4], const float* as, const float* bs,
                                        int ld) {
  // thread (tr, tc): rows tr + 16 i, columns tc + 8 j; a warp reads eight
  // rows of a and four of b at each k, one 128-byte wavefront each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = (lane & 7) + 8 * (warp & 1), tc = (lane >> 3) + 4 * (warp >> 1);
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(as + (tr + 16 * i) * ld + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(bs + (tc + 8 * j) * ld + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}
template <int K>
__device__ __forceinline__ void wide_nt(float (&acc)[4][4], const __nv_bfloat16* as,
                                        const __nv_bfloat16* bs, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, as + (16 * warp + (lane & 15)) * ld + k + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, bs + (8 * j + (lane >> 4) * 8 + (lane & 7)) * ld + k + ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16(acc[j], a, b0);
      mma_bf16(acc[j + 1], a, b1);
    }
  }
}
template <typename T, class F>
__device__ __forceinline__ void wide_nt_each(const float (&acc)[4][4], F&& f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(16 * warp + (lane >> 2) + 8 * (e >> 1), 8 * j + 2 * (lane & 3) + (e & 1), acc[j][e]);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tr = (lane & 7) + 8 * (warp & 1), tc = (lane >> 3) + 4 * (warp >> 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(tr + 16 * i, tc + 8 * j, acc[i][j]);
  }
}

// TN: acc (32 x 64) += a^T b over R rows, a (R x 32) and b (R x 64)
// row-major: dv = p^T g and dk = dsc^T q for a key tile.
template <int R>
__device__ __forceinline__ void wide_tn(float (&acc)[4][4], const float* as, int lda,
                                        const float* bs, int ldb) {
  // thread (tk, td): rows 4 tk .. 4 tk + 3 of the result, columns 4 td ..;
  // a warp reads four float4 of a and eight of b at each row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int td = (lane & 7) + 8 * (warp & 1), tk = (lane >> 3) + 4 * (warp >> 1);
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(as + r * lda + 4 * tk);
    const float4 y = *reinterpret_cast<const float4*>(bs + r * ldb + 4 * td);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}
template <int R>
__device__ __forceinline__ void wide_tn(float (&acc)[4][4], const __nv_bfloat16* as, int lda,
                                        const __nv_bfloat16* bs, int ldb) {
  // warp (wk, wd): result rows 16 wk .., columns 32 wd ..; a^T's fragments
  // by ldmatrix.trans of a's rows, b's as the B operand by ldmatrix.trans
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wk = warp & 1, wd = warp >> 1;
#pragma unroll
  for (int r = 0; r < R; r += 16) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, as + (r + (lane & 7) + ((lane >> 4) << 3)) * lda + 16 * wk +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bs + (r + (lane & 15)) * ldb + 32 * wd + 8 * j + (lane >> 4) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[j], a, b0);
      mma_bf16(acc[j + 1], a, b1);
    }
  }
}

// NN: acc (32 x 64) += a (32 x K) b (K x 64), a and b row-major: dq = dsc k.
template <int K>
__device__ __forceinline__ void wide_nn(float (&acc)[4][4], const float* as, int lda,
                                        const float* bs, int ldb) {
  // thread (tr, td): rows tr + 8 i, columns 4 td ..
  const int tr = threadIdx.x & 7, td = threadIdx.x >> 3;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(as + (tr + 8 * i) * lda + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = *reinterpret_cast<const float4*>(bs + (k + e) * ldb + 4 * td);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][0] = fmaf(xs[e], y[e].x, acc[i][0]);
        acc[i][1] = fmaf(xs[e], y[e].y, acc[i][1]);
        acc[i][2] = fmaf(xs[e], y[e].z, acc[i][2]);
        acc[i][3] = fmaf(xs[e], y[e].w, acc[i][3]);
      }
    }
  }
}
template <int K>
__device__ __forceinline__ void wide_nn(float (&acc)[4][4], const __nv_bfloat16* as, int lda,
                                        const __nv_bfloat16* bs, int ldb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wr = warp & 1, wd = warp >> 1;
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, as + (16 * wr + (lane & 15)) * lda + k + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bs + (k + (lane & 15)) * ldb + 32 * wd + 8 * j + (lane >> 4) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[j], a, b0);
      mma_bf16(acc[j + 1], a, b1);
    }
  }
}

// Where the TN (tn = true) or NN accumulators land in the 32 x 64 result.
template <typename T, bool kTn, class F>
__device__ __forceinline__ void wide_out_each(const float (&acc)[4][4], F&& f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = 16 * (warp & 1), c0 = 32 * (warp >> 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(r0 + (lane >> 2) + 8 * (e >> 1), c0 + 8 * j + 2 * (lane & 3) + (e & 1), acc[j][e]);
  } else if constexpr (kTn) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int td = (lane & 7) + 8 * (warp & 1), tk = (lane >> 3) + 4 * (warp >> 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(4 * tk + i, 4 * td + j, acc[i][j]);
  } else {
    const int tr = threadIdx.x & 7, td = threadIdx.x >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(tr + 8 * i, 4 * td + j, acc[i][j]);
  }
}

// The wide backward's scratch (in a.scratch, 16-byte aligned): round(ds
// scale) and round(p) in the operand type, rows padded to np keys (zeros
// past N, so that whole 16-byte chunks copy); the s and dp planes (B_ H, M,
// N) f32; the key tiles' row statistics (B_ H, tiles, M) three times.
struct WidePlanes {
  void *dsc, *p;
  float *s, *dp, *tmx, *tsum, *tdot;
  int tiles, np;
  __host__ __device__ WidePlanes(const BwdArgs& a) {
    tiles = cdiv(a.n, kWideKeys);
    np = tiles * kWideKeys;
    const size_t rows = (size_t)a.b * a.heads * a.m;
    dsc = a.scratch;  // room for f32
    p = a.scratch + rows * np;
    s = a.scratch + 2 * rows * np;
    dp = s + rows * a.n;
    tmx = dp + rows * a.n;
    tsum = tmx + rows * tiles;
    tdot = tsum + rows * tiles;
  }
  static size_t floats(int b, int m, int n, int heads) {
    const int t = cdiv(n, kWideKeys);
    return (size_t)b * heads * m * (2 * (size_t)t * kWideKeys + 2 * (size_t)n + 3 * (size_t)t);
  }
};

template <typename T>
__global__ void __launch_bounds__(kWideThreads) attn_bwd_scores_kernel(BwdArgs a) {
  constexpr int LD = wide_ld<T>(kWideCols), SP = kWideKeys + 1;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* qs = reinterpret_cast<T*>(wide_smem);  // (64, LD): the tile's q rows, one chunk
  T* gs = qs + kWideRows * LD;              // (64, LD): its g rows
  T* ks = gs + kWideRows * LD;              // (32, LD): the key tile's k rows
  T* vs = ks + kWideKeys * LD;              // (32, LD): its v rows
  float* sp = reinterpret_cast<float*>(wide_smem);  // after the products: (64, SP) q k^T
  float* dpp = sp + kWideRows * SP;                 // and (64, SP) dp
  const int kt = blockIdx.x, r0 = blockIdx.y * kWideRows, bh = blockIdx.z;
  const int m = a.m, n = a.n, c = a.c, hd = a.hd, n0 = kt * kWideKeys;
  const int w = bh / a.heads, h = bh - w * a.heads;
  const T* q = static_cast<const T*>(a.q) + ((size_t)w * m + r0) * c + h * hd;
  const T* g = static_cast<const T*>(a.g) + ((size_t)w * m + r0) * c + h * hd;
  const T* k = static_cast<const T*>(a.k) + ((size_t)w * n + n0) * c + h * hd;
  const T* v = static_cast<const T*>(a.v) + ((size_t)w * n + n0) * c + h * hd;
  float s[4][4] = {}, dp[4][4] = {};
  for (int d0 = 0; d0 < hd; d0 += kWideCols) {
    __syncthreads();  // the block is done with the previous chunk
    wide_stage<T, kWideCols>(qs, LD, q + d0, c, kWideRows, m - r0, hd - d0, a.vec);
    wide_stage<T, kWideCols>(gs, LD, g + d0, c, kWideRows, m - r0, hd - d0, a.vec);
    wide_stage<T, kWideCols>(ks, LD, k + d0, c, kWideKeys, n - n0, hd - d0, a.vec);
    wide_stage<T, kWideCols>(vs, LD, v + d0, c, kWideKeys, n - n0, hd - d0, a.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    wide_nt<kWideCols>(s, qs, ks, LD);
    wide_nt<kWideCols>(dp, gs, vs, LD);
  }
  __syncthreads();  // the planes lie over the staged chunks
  wide_nt_each<T>(s, [&](int r, int col, float x) { sp[r * SP + col] = x; });
  wide_nt_each<T>(dp, [&](int r, int col, float x) { dpp[r * SP + col] = x; });
  __syncthreads();
  // a warp per row, a lane per key: scale and bias, the planes out, and the
  // tile's max, sum of exp and sum of dp times exp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, key = n0 + lane;
  const WidePlanes pl(a);
  const size_t plane0 = (size_t)bh * m * n;
  const float* bias_h = a.bias + (size_t)h * m * n;
  for (int r = warp; r < kWideRows && r0 + r < m; r += kWideThreads / 32) {
    const int row = r0 + r;
    const bool in = key < n;
    const float sv = in ? fmaf(sp[r * SP + lane], a.scale, __ldg(bias_h + (size_t)row * n + key))
                        : __int_as_float(0xff800000);  // -inf
    const float dv = dpp[r * SP + lane];
    if (in) {
      pl.s[plane0 + (size_t)row * n + key] = sv;
      pl.dp[plane0 + (size_t)row * n + key] = dv;
    }
    const float mxl = warp_max(sv) * kLog2e;
    const float e = in ? fast_exp2(fmaf(sv, kLog2e, -mxl)) : 0.f;
    const float sum = warp_sum(e), dot = warp_sum(in ? dv * e : 0.f);
    if (lane == 0) {
      const size_t o = ((size_t)bh * pl.tiles + kt) * m + row;
      pl.tmx[o] = mxl;
      pl.tsum[o] = sum;
      pl.tdot[o] = dot;
    }
  }
}

// A warp a row: its statistics merged over the key tiles in order (lane 0:
// the max score times log2 e, 1 / the sum of exp, rowsum(dp * p32)), then
// for every key, a lane a key, p32 = exp(s - max) / sum and ds = p32 (dp -
// rowsum(dp * p32)): ds to the plane that dbias sums, round(p) and round(ds
// scale) to the padded operand-typed planes (zeros past N).
template <typename T>
__global__ void __launch_bounds__(kWideThreads) attn_bwd_probs_kernel(BwdArgs a) {
  const WidePlanes pl(a);
  const int lane = threadIdx.x & 31;
  const size_t rows = (size_t)a.b * a.heads * a.m;
  const size_t i = (size_t)blockIdx.x * (kWideThreads / 32) + (threadIdx.x >> 5);
  if (i >= rows) return;
  const size_t bh = i / a.m, o = bh * pl.tiles * a.m + (i - bh * a.m);
  float mx = 0.f, inv = 0.f, rdot = 0.f;
  if (lane == 0) {
    mx = __int_as_float(0xff800000);  // -inf
    for (int t = 0; t < pl.tiles; ++t) mx = fmaxf(mx, pl.tmx[o + (size_t)t * a.m]);
    float sum = 0.f, dot = 0.f;
    for (int t = 0; t < pl.tiles; ++t) {
      const float f = fast_exp2(pl.tmx[o + (size_t)t * a.m] - mx);
      sum = fmaf(pl.tsum[o + (size_t)t * a.m], f, sum);
      dot = fmaf(pl.tdot[o + (size_t)t * a.m], f, dot);
    }
    inv = 1.f / sum;
    rdot = dot * inv;
  }
  mx = __shfl_sync(0xffffffffu, mx, 0);
  inv = __shfl_sync(0xffffffffu, inv, 0);
  rdot = __shfl_sync(0xffffffffu, rdot, 0);
  const float* srow = pl.s + i * a.n;
  const float* dprow = pl.dp + i * a.n;
  float* dsrow = a.partial + i * a.n;
  T* prow = static_cast<T*>(pl.p) + i * pl.np;
  T* dscrow = static_cast<T*>(pl.dsc) + i * pl.np;
  for (int key = lane; key < pl.np; key += 32) {
    float p = 0.f, dsc = 0.f;
    if (key < a.n) {
      const float p32 = fast_exp2(fmaf(srow[key], kLog2e, -mx)) * inv;
      const float ds = p32 * (dprow[key] - rdot);
      dsrow[key] = ds;
      p = p32;
      dsc = ds * a.scale;
    }
    prow[key] = store_cast<T>(p);
    dscrow[key] = store_cast<T>(dsc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads) attn_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int LD = wide_ld<T>(kWideCols), LP = wide_ld<T>(kWideKeys);
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* gs = reinterpret_cast<T*>(wide_smem);  // (64, LD): g rows, the block's chunk
  T* qs = gs + kWideRows * LD;              // (64, LD): q rows
  T* ps = qs + kWideRows * LD;              // (64, LP): round(p) against the tile's keys
  T* dss = ps + kWideRows * LP;             // (64, LP): round(ds scale)
  const int kt = blockIdx.x, d0 = blockIdx.y * kWideCols, bh = blockIdx.z;
  const int m = a.m, n = a.n, c = a.c, hd = a.hd, n0 = kt * kWideKeys;
  const int w = bh / a.heads, h = bh - w * a.heads;
  const T* q = static_cast<const T*>(a.q) + (size_t)w * m * c + h * hd + d0;
  const T* g = static_cast<const T*>(a.g) + (size_t)w * m * c + h * hd + d0;
  const WidePlanes pl(a);
  const T* p = static_cast<const T*>(pl.p) + (size_t)bh * m * pl.np + n0;
  const T* dsc = static_cast<const T*>(pl.dsc) + (size_t)bh * m * pl.np + n0;
  float dv[4][4] = {}, dk[4][4] = {};
  for (int r0 = 0; r0 < m; r0 += kWideRows) {
    __syncthreads();  // the block is done with the previous rows
    wide_stage<T, kWideCols>(gs, LD, g + (size_t)r0 * c, c, kWideRows, m - r0, hd - d0, a.vec);
    wide_stage<T, kWideCols>(qs, LD, q + (size_t)r0 * c, c, kWideRows, m - r0, hd - d0, a.vec);
    // the padded planes copy in whole 16-byte chunks (zeros past N)
    wide_stage<T, kWideKeys>(ps, LP, p + (size_t)r0 * pl.np, pl.np, kWideRows, m - r0, kWideKeys,
                             true);
    wide_stage<T, kWideKeys>(dss, LP, dsc + (size_t)r0 * pl.np, pl.np, kWideRows, m - r0, kWideKeys,
                             true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    wide_tn<kWideRows>(dv, ps, LP, gs, LD);
    wide_tn<kWideRows>(dk, dss, LP, qs, LD);
  }
  T* dvo = static_cast<T*>(a.dv) + ((size_t)w * n + n0) * c + h * hd + d0;
  T* dko = static_cast<T*>(a.dk) + ((size_t)w * n + n0) * c + h * hd + d0;
  wide_out_each<T, true>(dv, [&](int r, int col, float x) {
    if (n0 + r < n && d0 + col < hd) dvo[(size_t)r * c + col] = store_cast<T>(x);
  });
  wide_out_each<T, true>(dk, [&](int r, int col, float x) {
    if (n0 + r < n && d0 + col < hd) dko[(size_t)r * c + col] = store_cast<T>(x);
  });
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads) attn_bwd_dq_kernel(BwdArgs a) {
  constexpr int LA = wide_ld<T>(kWideQKeys), LD = wide_ld<T>(kWideCols);
  constexpr int STAGE = kWideQRows * LA + kWideQKeys * LD;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  // two stages of: (32, LA) round(ds scale) of the rows against one key
  // tile, then (64, LD) the tile's k rows, the block's chunk
  T* smem = reinterpret_cast<T*>(wide_smem);
  const int r0 = blockIdx.x * kWideQRows, d0 = blockIdx.y * kWideCols, bh = blockIdx.z;
  const int m = a.m, n = a.n, c = a.c, hd = a.hd;
  const int w = bh / a.heads, h = bh - w * a.heads;
  const T* k = static_cast<const T*>(a.k) + (size_t)w * n * c + h * hd + d0;
  const WidePlanes pl(a);
  const T* dsc = static_cast<const T*>(pl.dsc) + ((size_t)bh * m + r0) * pl.np;
  // the padded dsc rows copy in whole 16-byte chunks (zeros past N)
  auto stage = [&](T* st, int n0) {
    wide_stage<T, kWideQKeys>(st, LA, dsc + n0, pl.np, kWideQRows, m - r0, pl.np - n0, true);
    wide_stage<T, kWideCols>(st + kWideQRows * LA, LD, k + (size_t)n0 * c, c, kWideQKeys, n - n0,
                             hd - d0, a.vec);
  };
  float acc[4][4] = {};
  stage(smem, 0);
  cp_async_commit();
  for (int n0 = 0, it = 0; n0 < n; n0 += kWideQKeys, ++it) {
    T* cur = smem + (it & 1) * STAGE;
    if (n0 + kWideQKeys < n) stage(smem + ((it + 1) & 1) * STAGE, n0 + kWideQKeys);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    wide_nn<kWideQKeys>(acc, cur, LA, cur + kWideQRows * LA, LD);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  T* dq = static_cast<T*>(a.dq) + ((size_t)w * m + r0) * c + h * hd + d0;
  wide_out_each<T, false>(acc, [&](int r, int col, float x) {
    if (r0 + r < m && d0 + col < hd) dq[(size_t)r * c + col] = store_cast<T>(x);
  });
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

// The kernel for (T, HD, J) at head_dim <= 32: J < 0 names the key-tiled
// variant.
template <typename T, int HD, int J>
auto bwd_kernel() {
  if constexpr (J < 0) {
    return attn_bwd_tiled_kernel<T, HD>;
  } else {
    return attn_bwd_kernel<T, HD, J>;
  }
}

// Writes the occupancy of `kernel` at `smem` bytes and `threads` to info:
// registers, local (spill) bytes per thread, dynamic shared memory per
// block, threads per block, resident blocks per SM.
template <class K>
cudaError_t occupancy(K kernel, int threads, size_t smem, long long* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (long long)attr.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = threads;
  info[4] = blocks;
  return cudaSuccess;
}

// Launches the instantiation for (T, HD, J) when `a` is given; otherwise
// writes its occupancy at `smem` bytes to info.
template <typename T, int HD, int J>
cudaError_t run(const BwdArgs* a, size_t smem, long long* info, cudaStream_t stream) {
  auto kernel = bwd_kernel<T, HD, J>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a != nullptr) {
    kernel<<<dim3(a->groups, a->heads), kThreads, smem, stream>>>(*a);
    return cudaGetLastError();
  }
  return occupancy(kernel, kThreads, smem, info);
}

template <typename T, int HD>
cudaError_t run_j(int j, const BwdArgs* a, size_t smem, long long* info, cudaStream_t stream) {
  switch (j) {
    case -1: return run<T, HD, -1>(a, smem, info, stream);
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

// The wide backward's four launches (and not the reduction) with `a`, or,
// when `a` is null, the occupancy of its three tiled kernels in info: the
// most registers, spill bytes and shared memory of the three, their threads
// and the fewest resident blocks per SM.
template <typename T>
cudaError_t run_wide(const BwdArgs* a, long long* info, cudaStream_t stream) {
  constexpr size_t smem[3] = {wide_scores_smem<T>(), wide_dkdv_smem<T>(), wide_dq_smem<T>()};
  static_assert(std::max(wide_scores_smem<T>(), wide_dkdv_smem<T>()) <= 232448, "wide blocks fit");
  void (*kernels[3])(BwdArgs) = {attn_bwd_scores_kernel<T>, attn_bwd_dkdv_kernel<T>,
                                 attn_bwd_dq_kernel<T>};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem[i]);
    if (err != cudaSuccess) return err;
  }
  if (a == nullptr) {
    for (int i = 0; i < 3; ++i) {
      long long one[5];
      const cudaError_t err = occupancy(kernels[i], kWideThreads, smem[i], one);
      if (err != cudaSuccess) return err;
      for (int f = 0; f < 3; ++f) info[f] = i ? std::max(info[f], one[f]) : one[f];
      info[3] = kWideThreads;
      info[4] = i ? std::min(info[4], one[4]) : one[4];
    }
    return cudaSuccess;
  }
  const int bh = a->b * a->heads, chunks = cdiv(a->hd, kWideCols);
  attn_bwd_scores_kernel<T><<<dim3(cdiv(a->n, kWideKeys), cdiv(a->m, kWideRows), bh), kWideThreads,
                              smem[0], stream>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_probs_kernel<T><<<(unsigned)cdiv(bh * a->m, kWideThreads / 32), kWideThreads, 0,
                             stream>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T><<<dim3(cdiv(a->n, kWideKeys), chunks, bh), kWideThreads, smem[1],
                            stream>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T><<<dim3(cdiv(a->m, kWideQRows), chunks, bh), kWideThreads, smem[2],
                          stream>>>(*a);
  return cudaGetLastError();
}


// The wide backward's 16-byte copies: every head row starts on a 16-byte
// boundary (q, k, v, g, C and the head offsets) and head_dim fills whole
// chunks.
template <typename T>
bool wide_vec_ok(const BwdArgs& a) {
  constexpr int CH = 16 / (int)sizeof(T);
  if (a.hd % CH || a.c % CH) return false;
  for (const void* p : {a.q, a.k, a.v, a.g})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Launches the variant with row share j (0: long rows) or, with a key tile,
// the key-tiled variant (the wrapper's attn_core_bwd_plan picks both from
// the shapes), or above head_dim 32 the wide backward (j and key_tile 0),
// with `a` (setting its head_dim, pass-2 slices and key tile), or writes the
// occupancy and J, S and the key tile to info[0..7] when `a` is null (for
// the wide backward all three 0). A head_dim
// between the instantiated ones runs at the next one up (padded_hd).
cudaError_t dispatch(int is_bf16, int m, int n, int c, int heads, int j, int key_tile, BwdArgs* a,
                     long long* info, cudaStream_t stream) {
  if (heads < 1 || c % heads || (j && n > 32 * j) || (key_tile && (j || key_tile < 8)))
    return cudaErrorInvalidValue;
  const int hd = padded_hd(c / heads);
  if (hd == 0) return cudaErrorInvalidValue;
  if (hd > 32) {
    if (j || key_tile) return cudaErrorInvalidValue;
    if (a != nullptr) {
      a->hd = c / heads;
      a->vec = is_bf16 ? wide_vec_ok<__nv_bfloat16>(*a) : wide_vec_ok<float>(*a);
    } else {
      info[5] = 0;
      info[6] = 0;
      info[7] = 0;  // its tiles are its own (kWideKeys keys)
    }
    return is_bf16 ? run_wide<__nv_bfloat16>(a, info, stream) : run_wide<float>(a, info, stream);
  }
  const int slices = pass2_slices(m, key_tile ? key_tile : n, hd, j);
  if (a != nullptr) {
    a->hd = c / heads;
    a->slices = slices;
    a->key_tile = key_tile;
  } else {
    info[5] = j;
    info[6] = slices;
    info[7] = key_tile;
  }
  const size_t smem = sizeof(float) * bwd_smem_floats(m, n, hd, j, key_tile);
  const int variant = key_tile ? -1 : j;
  return is_bf16 ? run_hd<__nv_bfloat16>(hd, variant, a, smem, info, stream)
                 : run_hd<float>(hd, variant, a, smem, info, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) the backward kernel with row share j or key tile
// key_tile asks for (the wrapper's attn_core_bwd_smem_bytes computes the
// same); above head_dim 32 the largest of the wide backward's blocks (f32).
long long attn_core_bwd_smem_bytes(int m, int n, int c, int heads, int j, int key_tile) {
  const int hd = padded_hd(c / heads);
  if (hd > 32)
    return (long long)std::max(
        {wide_scores_smem<float>(), wide_dkdv_smem<float>(), wide_dq_smem<float>()});
  return (long long)(sizeof(float) * bwd_smem_floats(m, n, hd, j, key_tile));
}

// Floats of f32 scratch the backward needs at these shapes: the wide
// backward's s and dp planes and row statistics above head_dim 32, else 0.
long long attn_core_bwd_scratch_floats(int b, int m, int n, int c, int heads) {
  return padded_hd(c / heads) > 32 ? (long long)WidePlanes::floats(b, m, n, heads) : 0;
}

// The instantiation a launch at these shapes with row share j and key tile
// key_tile takes: info[0..7] = registers, local (spill) bytes per thread,
// dynamic shared memory per block, threads per block, resident blocks per
// SM, J (keys a lane keeps of a row; 0 for long rows, key tiles and the wide
// backward), S (lanes per key in pass 2) and the key tile (0 for the wide
// backward, whose other numbers are the extremes of its three tiled
// kernels). Returns the CUDA error code (0 on success).
int attn_core_bwd_occupancy(int is_bf16, int m, int n, int c, int heads, int j, int key_tile,
                            long long* info) {
  return (int)dispatch(is_bf16, m, n, c, heads, j, key_tile, nullptr, info, nullptr);
}

// Launches the backward with row share j (12, 16 or 32 keys a lane, N <=
// 32 j; or 0, long rows) or, with key_tile > 0 (and j 0), the key-tiled
// variant, or above head_dim 32 (j and key_tile 0) the wide backward, and
// the dbias reduction on `stream`; returns the first CUDA error code (0 on
// success). q/k/v/g/dq/dk/dv are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// bias, partial, dbias and scratch are f32. partial is (groups, H, M, N);
// the wide backward takes groups = B_ (a ds plane a window) and scratch of
// attn_core_bwd_scratch_floats floats, which the others do not read.
int attn_core_backward(int is_bf16, int b, int m, int n, int c, int heads, int groups, int j,
                       int key_tile, float scale,
                       const void* q, const void* k, const void* v, const float* bias,
                       const void* g, void* dq, void* dk, void* dv, float* partial, float* dbias,
                       float* scratch, void* stream) {
  if (groups < 1 || groups > b) return (int)cudaErrorInvalidValue;
  const bool wide = heads >= 1 && c % heads == 0 && padded_hd(c / heads) > 32;
  if (wide && (groups != b || scratch == nullptr)) return (int)cudaErrorInvalidValue;
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
  a.scratch = scratch;
  a.vec = false;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch(is_bf16, m, n, c, heads, j, key_tile, &a, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)heads * m * n;
  dbias_reduce_kernel<<<(unsigned)((plane + 255) / 256), 256, 0, s>>>(partial, dbias, groups,
                                                                      plane);
  return (int)cudaGetLastError();
}

}  // extern "C"
