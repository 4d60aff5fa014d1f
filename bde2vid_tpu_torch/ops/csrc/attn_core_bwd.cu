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
//   - Rows the register kernel cannot take (J = 0: more than 32 x 32 keys,
//     or an (M, N) plane that does not fit beside the k/v rows), at head_dim
//     <= 32: the tiled backward, three launches that tile the keys and keep
//     nothing of size (M, N) in shared memory (attn_bwd_rows_kernel,
//     attn_bwd_keys_kernel and attn_bwd_dq_reduce_kernel below; the JAX
//     kernel holds the rows whole in VMEM). The wrapper still counts long
//     rows (a window's k/v, q/g rows would fit in one block) apart from key
//     tiles (they would not).
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
  float scale;
  const void *q, *k, *v, *g;  // (B_, M, C), (B_, N, C), (B_, N, C), (B_, M, C)
  const float* bias;          // (H, M, N) f32
  void *dq, *dk, *dv;         // like q, k, v
  float* partial;             // (groups, H, M, N) f32; the wide backward's ds planes (groups = B_)
  float* dbias;               // (H, M, N) f32: the tiled backward writes it (no partials)
  float* scratch;             // the wide backward's planes and statistics (WidePlanes), or the
                              // tiled backward's row statistics ((B_, H, M) float4), aligned
  bool vec;                   // 16-byte copies (the wide backward), or whole-row chunk loads
                              // of the tiled backward (aligned rows, head_dim its HD)
};

// The k, v, q and g rows, three row statistics and the block's (M, N)
// dbias plane of the register kernel (J > 0; hd is the instantiated HD, at
// most 32).
size_t bwd_smem_floats(int m, int n, int hd) {
  return 2 * ((size_t)n + m) * key_stride(hd) + 3 * (size_t)m + (size_t)m * n;
}

// Keys a pass-2 lane takes: two at head_dim <= 4 where one block fills an
// SM (J > 12: 128 registers), so that each q and g row loaded from shared
// memory feeds both; else one, as registers run out.
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
// registers, else one.
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
  float* dbias = row_dot + m_tok;          // (M, N): ds summed over this block's windows

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
  __syncthreads();
  float* part = a.partial + ((size_t)grp * a.heads + h) * m_tok * n_tok;
  for (int e = tid; e < m_tok * n_tok; e += kThreads) part[e] = dbias[e];
}

// ---------------------------------------------------------------------------
// The tiled backward (head_dim <= 32, the rows the register kernel cannot
// take): FlashAttention-2's backward with the windows kept apart and every
// sum in a fixed order, in three launches.
//   1. attn_bwd_rows_kernel: the rows' softmax statistics in one sweep. A
//      block per (window, head, 8 R rows) stages its q and g rows (in f32)
//      and, two stages deep by cp.async, each 64-key tile's k and v rows and
//      the rows' bias against it; a warp takes R rows (8, 4 at head_dim 32)
//      and a lane a key of the tile. Each lane keeps a running max, sum of
//      exp and sum of dp times exp for each row over its keys, rescaled only
//      when a score raises its max; the lanes merge in a fixed butterfly, and
//      the row's max, 1 / sum and rowsum(dp * p32) go to the statistics
//      scratch ((B_, H, M) float4).
//   2. attn_bwd_keys_kernel: a block per (32-key tile, head), a warp per 16
//      rows (at most 8 warps) and a lane per key. It walks the B_ windows
//      in order, the next window's q and g rows, k and v tile and row
//      statistics in flight (cp.async, two stages) while this one computes
//      p32 and ds for the lane's key against the warp's rows, dv = p^T g and
//      dk = dsc^T q in registers; the warps' partial dk and dv then add in
//      warp order through shared memory. round(ds scale) of the (row, key)
//      tile goes to shared memory too, and a thread a row sums dq's share of
//      the tile's keys in key order into a partial plane of the tile. dbias
//      of the lane's (row, key) elements sums in registers over all windows
//      and is written once at the end: no (M, N) partial buffer,
//      read-modify-write or dbias reduction remains. Past 128 rows the rows
//      split into groups of at most 128 (keys_groups), a grid dimension: a
//      block per (key tile, head, row group) writes its rows' dbias and an
//      f32 partial plane of dk and dv for its group.
//   3. attn_bwd_dq_reduce_kernel adds the tiles' dq planes in tile order
//      and, past 128 rows, the row groups' dk and dv planes in group order.
// p32, ds, round(p) and round(ds scale) are the float operations of the
// register kernel's pass 2. The products are FMA dot products over head_dim
// (4 is below an MMA's K); bf16 rows convert to f32 once per stage where a
// row feeds many products.
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;  // attn_bwd_rows_kernel: 8 warps
constexpr int kRowsKeys = 64;      // keys of its staged tiles, two a lane
constexpr int kRowsBias = kRowsKeys + 4;  // row stride (floats) of its staged bias tiles
constexpr int kTileKeys = 32;      // keys of an attn_bwd_keys_kernel block, a lane each
constexpr int kKeysRows = 16;      // rows an attn_bwd_keys_kernel warp takes
constexpr int kKeysWarps = 8;      // its most warps: a row group of at most 128 rows

// Row groups of attn_bwd_keys_kernel at M rows (a block each): the fewest of
// at most kKeysWarps warps of 16 rows; its warps, the rows split evenly over
// the groups (M 144: two groups of five warps, 80 rows); and the rows of the
// largest group: M itself in one group, else 16 rows a warp.
__host__ __device__ inline int keys_groups(int m) { return cdiv(m, kKeysWarps * kKeysRows); }
__host__ __device__ inline int keys_warps(int m) { return cdiv(cdiv(m, keys_groups(m)), kKeysRows); }
__host__ __device__ inline int keys_group_rows(int m) {
  return keys_groups(m) == 1 ? m : kKeysRows * keys_warps(m);
}

// The HD the tiled backward runs head_dim hd at (4, 8, 16 or 32).
__host__ __device__ constexpr int tiled_hd(int hd) { return hd < 4 ? 4 : hd; }
// Rows of an attn_bwd_rows_kernel warp (its q and g rows are read from
// shared memory): 8, and 4 at head_dim 32, where the k and v rows a lane
// holds take 64 registers.
__host__ __device__ constexpr int tiled_rows(int hd) { return hd <= 16 ? 8 : 4; }
// Row stride (elements) of a staged row: 16 bytes of padding.
template <typename T>
__host__ __device__ constexpr int tiled_ld(int hd) {
  return hd + 16 / (int)sizeof(T);
}

// One stage of attn_bwd_keys_kernel (bytes, a multiple of 16): the
// statistics (float4) and q and g rows of the window's m rows of a row
// group, the tile's k and v.
template <typename T>
__host__ __device__ inline size_t tiled_stage_bytes(int m, int hd) {
  const size_t b = 16 * (size_t)m + sizeof(T) * (size_t)(2 * m + 2 * kTileKeys) * tiled_ld<T>(hd);
  return (b + 15) / 16 * 16;
}
// Two stages, then the warps' partial dk and dv ((warps, 32, 2 HD + 4) f32),
// round(ds scale) of the tile ((rows, 33) f32, rounded up to 16 bytes) and,
// for bf16, the window's q and g rows in f32, for a row group of
// keys_group_rows(M) rows.
__host__ __device__ inline int tiled_dst_floats(int m) { return cdiv(m * (kTileKeys + 1), 4) * 4; }
template <typename T>
size_t tiled_keys_smem(int m, int hd) {
  const int warps = keys_warps(m), mg = keys_group_rows(m);
  return 2 * tiled_stage_bytes<T>(mg, hd) + sizeof(float) * (size_t)warps * kTileKeys * (2 * hd + 4) +
         sizeof(float) * (size_t)tiled_dst_floats(mg) +
         (std::is_same<T, float>::value ? 0 : sizeof(float) * 2 * (size_t)mg * (hd + 4));
}
// attn_bwd_rows_kernel: its 8 R q and g rows (f32), two stages of kRowsKeys
// k and v rows and of the 8 R rows' bias against them.
template <typename T>
size_t tiled_rows_smem(int hd) {
  return sizeof(float) * (size_t)(hd + 4) * 2 * 8 * tiled_rows(hd) + sizeof(T) * (size_t)tiled_ld<T>(hd) * 4 * kRowsKeys +
         sizeof(float) * 2 * 8 * tiled_rows(hd) * kRowsBias;
}
// The larger block of the two.
template <typename T>
size_t tiled_smem(int m, int hd) {
  return std::max(tiled_keys_smem<T>(m, hd), tiled_rows_smem<T>(hd));
}

__device__ __forceinline__ float2 bf16x2_to_float2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// r = p[0 .. HD) in f32 by whole 16-byte (bf16 at HD 4: 8-byte) loads from
// shared memory, p aligned to them.
template <typename T, int HD>
__device__ __forceinline__ void tiled_row(float (&r)[HD], const T* p) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + d);
      r[d] = t.x;
      r[d + 1] = t.y;
      r[d + 2] = t.z;
      r[d + 3] = t.w;
    }
  } else if constexpr (HD == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 x = bf16x2_to_float2(u.x), y = bf16x2_to_float2(u.y);
    r[0] = x.x;
    r[1] = x.y;
    r[2] = y.x;
    r[3] = y.y;
  } else {
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + d);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = bf16x2_to_float2(w[e]);
        r[d + 2 * e] = x.x;
        r[d + 2 * e + 1] = x.y;
      }
    }
  }
}

// CB-byte asynchronous copy into shared memory (src_bytes 0: zeros).
template <int CB>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem), "n"(CB),
               "r"(src_bytes)
               : "memory");
}

// rows [0, rows) of a head's columns (row r at src + r * c) into dst (row
// stride LD): one CB-byte cp.async a row chunk when vec, else plain loads
// with zeros past hd; rows [rows, nrows) zero.
template <typename T, int HD>
__device__ __forceinline__ void tiled_stage_rows(T* dst, const T* src, int c, int nrows, int rows,
                                                 int hd, bool vec) {
  constexpr int LD = tiled_ld<T>(HD), CB = HD * (int)sizeof(T) < 16 ? HD * (int)sizeof(T) : 16;
  constexpr int CH = CB / (int)sizeof(T), PER = HD / CH;
  if (vec) {
    for (int e = threadIdx.x; e < nrows * PER; e += blockDim.x) {
      const int r = e / PER, d = (e - r * PER) * CH;
      const bool in = r < rows;
      cp_async_n<CB>(dst + r * LD + d, in ? src + (size_t)r * c + d : src, in ? CB : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * HD; e += blockDim.x) {
      const int r = e / HD, d = e - r * HD;
      dst[r * LD + d] = r < rows && d < hd ? src[(size_t)r * c + d] : store_cast<T>(0.f);
    }
  }
}

// The same rows in f32 (row stride HD + 4): f32 rows by tiled_stage_rows'
// copies, bf16 rows converted by plain loads, so that the products read
// them without conversions.
template <typename T, int HD>
__device__ __forceinline__ void tiled_stage_rows_f32(float* dst, const T* src, int c, int nrows, int rows,
                                                     int hd, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    tiled_stage_rows<float, HD>(dst, src, c, nrows, rows, hd, vec);
  } else {
    for (int e = threadIdx.x; e < nrows * HD; e += blockDim.x) {
      const int r = e / HD, d = e - r * HD;
      dst[r * (HD + 4) + d] = r < rows && d < hd ? load(src, (size_t)r * c + d) : 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRowsThreads, 2) attn_bwd_rows_kernel(BwdArgs a) {
  constexpr int R = tiled_rows(HD), LD = tiled_ld<T>(HD), LDF = HD + 4, ROWS = (kRowsThreads / 32) * R;
  extern __shared__ __align__(16) unsigned char rows_smem[];
  float* qs = reinterpret_cast<float*>(rows_smem);  // (ROWS, LDF): the block's q rows in f32
  float* gs = qs + ROWS * LDF;                      // (ROWS, LDF): its g rows
  T* kv = reinterpret_cast<T*>(gs + ROWS * LDF);    // 2 stages of (kRowsKeys, LD) k, then v rows
  float* bs = reinterpret_cast<float*>(kv + 4 * kRowsKeys * LD);  // 2 stages of (ROWS, kRowsBias) bias
  const int w = blockIdx.x, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.z * ROWS, m = a.m, n = a.n, c = a.c, hd = a.hd;
  const int tiles = cdiv(n, kRowsKeys);
  const float scale = a.scale;
  const T* kg = static_cast<const T*>(a.k) + (size_t)w * n * c + h * hd;
  const T* vg = static_cast<const T*>(a.v) + (size_t)w * n * c + h * hd;
  const float* bias_h = a.bias + (size_t)h * m * n;
  // step st stages key tile st
  auto stage = [&](int st) {
    const int t0 = st * kRowsKeys;
    T* ks = kv + (st & 1) * 2 * kRowsKeys * LD;
    tiled_stage_rows<T, HD>(ks, kg + (size_t)t0 * c, c, kRowsKeys, n - t0, hd, a.vec);
    tiled_stage_rows<T, HD>(ks + kRowsKeys * LD, vg + (size_t)t0 * c, c, kRowsKeys, n - t0, hd, a.vec);
    // the rows' bias against the tile's keys, 4 bytes a copy (rows of N
    // floats are not 16-byte aligned); zero past M and N
    float* bd = bs + (st & 1) * ROWS * kRowsBias;
    for (int e = threadIdx.x; e < ROWS * kRowsKeys; e += kRowsThreads) {
      const int r = e / kRowsKeys, kk = e - r * kRowsKeys;
      const bool in = r0 + r < m && t0 + kk < n;
      cp_async_n<4>(bd + r * kRowsBias + kk, in ? bias_h + (size_t)(r0 + r) * n + t0 + kk : bias_h, in ? 4 : 0);
    }
  };
  const size_t row0 = ((size_t)w * m + r0) * c + h * hd;
  tiled_stage_rows_f32<T, HD>(qs, static_cast<const T*>(a.q) + row0, c, ROWS, m - r0, hd, a.vec);
  tiled_stage_rows_f32<T, HD>(gs, static_cast<const T*>(a.g) + row0, c, ROWS, m - r0, hd, a.vec);
  stage(0);
  cp_async_commit();

  // a warp's rows r0 + warp + 8 t: the lane's running max (times log2 e),
  // sum of exp and sum of dp exp over its keys
  float ml[R], sum[R], dpe[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    ml[t] = -1e30f;
    sum[t] = 0.f;
    dpe[t] = 0.f;
  }
  for (int st = 0; st < tiles; ++st) {
    if (st + 1 < tiles) stage(st + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's tile has landed
    __syncthreads();
    const int t0 = st * kRowsKeys;
    const T* ks = kv + (st & 1) * 2 * kRowsKeys * LD;
    const float* bt = bs + (st & 1) * ROWS * kRowsBias;
#pragma unroll
    for (int u = 0; u < kRowsKeys / 32; ++u) {
      const int kk = lane + 32 * u;
      if (t0 + kk >= n) break;
      float kr[HD], vr[HD];
      tiled_row<T, HD>(kr, ks + kk * LD);
      tiled_row<T, HD>(vr, ks + (kRowsKeys + kk) * LD);
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int li = warp + (kRowsThreads / 32) * t;
        if (r0 + li < m) {
          float qi[HD], gi[HD];
          tiled_row<float, HD>(qi, qs + li * LDF);
          tiled_row<float, HD>(gi, gs + li * LDF);
          const float s = fmaf(dot<HD>(qi, kr), scale, bt[li * kRowsBias + kk]);
          const float tl = s * kLog2e;
          if (tl > ml[t]) {
            const float f = fast_exp2(ml[t] - tl);
            sum[t] *= f;
            dpe[t] *= f;
            ml[t] = tl;
          }
          const float e = fast_exp2(fmaf(s, kLog2e, -ml[t]));
          sum[t] += e;
          dpe[t] = fmaf(dot<HD>(gi, vr), e, dpe[t]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  // the lanes' statistics merged in a fixed butterfly; lane 0's are the row's:
  // its max * log2 e, 1 / sum and rowsum(dp * p32)
#pragma unroll
  for (int t = 0; t < R; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, ml[t], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, sum[t], o);
      const float d2 = __shfl_xor_sync(0xffffffffu, dpe[t], o);
      const float mn = fmaxf(ml[t], m2);
      const float f1 = fast_exp2(ml[t] - mn), f2 = fast_exp2(m2 - mn);
      sum[t] = fmaf(sum[t], f1, s2 * f2);
      dpe[t] = fmaf(dpe[t], f1, d2 * f2);
      ml[t] = mn;
    }
    const int i = r0 + warp + (kRowsThreads / 32) * t;
    if (lane == 0 && i < m) {
      const float inv = 1.f / sum[t];
      reinterpret_cast<float4*>(a.scratch)[((size_t)w * a.heads + h) * m + i] =
          make_float4(ml[t], inv, dpe[t] * inv, 0.f);
    }
  }
}

// kGroups: more than one row group (blockIdx.z), whose dk and dv go to
// its f32 partial plane ((groups, B_, N, H, 2 HD), after the dq planes).
template <typename T, int HD, bool kGroups>
__global__ void __launch_bounds__(kKeysWarps * 32, 2) attn_bwd_keys_kernel(BwdArgs a) {
  constexpr int LD = tiled_ld<T>(HD), LDF = HD + 4, LR = 2 * HD + 4;
  extern __shared__ __align__(16) unsigned char keys_smem[];
  const int m = a.m, n = a.n, c = a.c, hd = a.hd, heads = a.heads;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kTileKeys, h = blockIdx.y, key = n0 + lane;
  // the block's rows: r0 .. r0 + rows - 1 of a group of mg
  const int mg = kGroups ? kKeysRows * warps : m, r0 = kGroups ? blockIdx.z * mg : 0;
  const int rows = kGroups ? min(mg, m - r0) : m;
  const size_t stage_bytes = tiled_stage_bytes<T>(mg, HD);
  float* red = reinterpret_cast<float*>(keys_smem + 2 * stage_bytes);  // (warps, 32, LR)
  float* dst = red + warps * kTileKeys * LR;  // (mg, 33): round(ds scale) of the tile's (row, key)
  float* qgf = dst + tiled_dst_floats(mg);    // bf16: (2 mg, HD + 4) the window's q, g rows in f32
  // dq's partial sums over this block's keys, (B_, H, M, HD) a key tile, after the statistics
  float* dqp = a.scratch + 4 * (size_t)a.b * heads * m + (size_t)blockIdx.x * a.b * heads * m * HD;
  const float scale = a.scale;
  const bool live = key < n;

  // the bias of the lane's (row, key) elements, and their dbias sums
  float bv[kKeysRows], db[kKeysRows];
#pragma unroll
  for (int t = 0; t < kKeysRows; ++t) {
    const int i = warp + warps * t;
    bv[t] = i < rows && live ? __ldg(a.bias + ((size_t)h * m + r0 + i) * n + key) : 0.f;
    db[t] = 0.f;
  }
  auto stats_of = [&](unsigned char* st) { return reinterpret_cast<float4*>(st); };
  auto rows_of = [&](unsigned char* st) { return reinterpret_cast<T*>(st + 16 * (size_t)mg); };
  // window w's statistics and q and g rows of the block's rows, and the tile's k and v
  auto fetch = [&](int w, unsigned char* st) {
    const float4* sg = reinterpret_cast<const float4*>(a.scratch) + ((size_t)w * heads + h) * m + r0;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) cp_async16(stats_of(st) + i, sg + i, 16);
    T* qs = rows_of(st);
    const size_t row0 = ((size_t)w * m + r0) * c + h * hd, key0 = ((size_t)w * n + n0) * c + h * hd;
    tiled_stage_rows<T, HD>(qs, static_cast<const T*>(a.q) + row0, c, rows, rows, hd, a.vec);
    tiled_stage_rows<T, HD>(qs + mg * LD, static_cast<const T*>(a.g) + row0, c, rows, rows, hd, a.vec);
    tiled_stage_rows<T, HD>(qs + 2 * mg * LD, static_cast<const T*>(a.k) + key0, c, kTileKeys, n - n0, hd,
                            a.vec);
    tiled_stage_rows<T, HD>(qs + (2 * mg + kTileKeys) * LD, static_cast<const T*>(a.v) + key0, c, kTileKeys,
                            n - n0, hd, a.vec);
  };

  unsigned char* buf[2] = {keys_smem, keys_smem + stage_bytes};
  fetch(0, buf[0]);
  cp_async_commit();
  for (int w = 0; w < a.b; ++w) {
    if (w + 1 < a.b) fetch(w + 1, buf[(w + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();  // this window's copies have landed
    __syncthreads();
    const float4* st = stats_of(buf[w & 1]);
    const T* qs = rows_of(buf[w & 1]);
    const float *qf, *gf;  // the window's q and g rows in f32 (row stride LDF)
    if constexpr (std::is_same<T, float>::value) {
      qf = qs;
      gf = qs + mg * LD;
    } else {
      for (int e = threadIdx.x; e < 2 * mg * HD; e += blockDim.x) {
        const int r = e / HD, d = e - r * HD;
        qgf[r * LDF + d] = load(qs, (size_t)r * LD + d);
      }
      __syncthreads();
      qf = qgf;
      gf = qgf + mg * LDF;
    }
    float kr[HD], vr[HD], dka[HD], dva[HD];
    tiled_row<T, HD>(kr, qs + (2 * mg + lane) * LD);
    tiled_row<T, HD>(vr, qs + (2 * mg + kTileKeys + lane) * LD);
#pragma unroll
    for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysRows; ++t) {
      const int i = warp + warps * t;
      if (i < rows) {
        float qi[HD], gi[HD];
        tiled_row<float, HD>(qi, qf + i * LDF);
        tiled_row<float, HD>(gi, gf + i * LDF);
        const float4 sti = st[i];  // max * log2 e, 1 / sum, rowsum(dp * p32)
        const float s = fmaf(dot<HD>(qi, kr), scale, bv[t]);
        const float p32 = fast_exp2(fmaf(s, kLog2e, -sti.x)) * sti.y;
        const float ds = p32 * (dot<HD>(gi, vr) - sti.z);
        db[t] += ds;
        const float p = round_to<T>(p32);
        const float dsc = round_to<T>(ds * scale);
        dst[i * (kTileKeys + 1) + lane] = live ? dsc : 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dva[d] = fmaf(p, gi[d], dva[d]);
          dka[d] = fmaf(dsc, qi[d], dka[d]);
        }
      }
    }
    float* mine = red + (warp * kTileKeys + lane) * LR;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      *reinterpret_cast<float4*>(mine + d) = make_float4(dka[d], dka[d + 1], dka[d + 2], dka[d + 3]);
      *reinterpret_cast<float4*>(mine + HD + d) = make_float4(dva[d], dva[d + 1], dva[d + 2], dva[d + 3]);
    }
    __syncthreads();
    // the warps' partial sums, added in warp order
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    for (int e = threadIdx.x; e < kTileKeys * 2 * HD; e += blockDim.x) {
      const int kk = e / (2 * HD), col = e - kk * 2 * HD, d = col < HD ? col : col - HD;
      float x = red[kk * LR + col];
      for (int ws = 1; ws < warps; ++ws) x += red[(ws * kTileKeys + kk) * LR + col];
      if (n0 + kk >= n) continue;
      if constexpr (kGroups) {
        float* dkv = a.scratch + (size_t)a.b * heads * m * (4 + (size_t)cdiv(n, kTileKeys) * HD);
        dkv[((((size_t)blockIdx.z * a.b + w) * n + n0 + kk) * heads + h) * 2 * HD + col] = x;
      } else if (d < hd) {
        (col < HD ? dk : dv)[((size_t)w * n + n0 + kk) * c + h * hd + d] = store_cast<T>(x);
      }
    }
    // dq's share of the tile's keys, a row a thread, summed over the keys in
    // order (attn_bwd_dq_reduce_kernel adds the tiles in order)
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      float acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kTileKeys; ++kk) {
        float kt[HD];
        tiled_row<T, HD>(kt, qs + (2 * mg + kk) * LD);
        const float x = dst[i * (kTileKeys + 1) + kk];
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(x, kt[d], acc[d]);
      }
      float* o = dqp + (((size_t)w * heads + h) * m + r0 + i) * HD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) *reinterpret_cast<float4*>(o + d) = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
    }
    __syncthreads();  // the k rows of this stage are read: the next window's copies may refill it
  }
#pragma unroll
  for (int t = 0; t < kKeysRows; ++t) {
    const int i = warp + warps * t;
    if (i < rows && live) a.dbias[((size_t)h * m + r0 + i) * n + key] = db[t];
  }
}

// dq = the keys kernel's partial sums added over the key tiles in order, a
// thread an element; past 128 rows (groups > 1) the threads past dq's
// elements add the row groups' dk and dv planes in group order.
template <typename T, int HD>
__global__ void attn_bwd_dq_reduce_kernel(BwdArgs a, int groups) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t rows = (size_t)a.b * a.heads * a.m;
  const int tiles = cdiv(a.n, kTileKeys);
  if (e >= rows * HD) {
    // (w, key, h, col) of the (B_, N, H, 2 HD) planes
    const size_t f = e - rows * HD, plane = (size_t)a.b * a.n * a.heads * 2 * HD;
    if (groups == 1 || f >= plane) return;
    const int col = (int)(f % (2 * HD)), d = col < HD ? col : col - HD;
    if (d >= a.hd) return;
    const size_t wkh = f / (2 * HD);
    const int h = (int)(wkh % a.heads);
    const size_t wk = wkh / a.heads;  // w * N + key
    const float* p = a.scratch + rows * (4 + (size_t)tiles * HD) + f;
    float x = 0.f;
    for (int gr = 0; gr < groups; ++gr) x += p[(size_t)gr * plane];
    static_cast<T*>(col < HD ? a.dk : a.dv)[wk * a.c + h * a.hd + d] = store_cast<T>(x);
    return;
  }
  const int d = (int)(e % HD);
  if (d >= a.hd) return;
  const size_t r = e / HD;  // ((w, h), i)
  const int i = (int)(r % a.m), wh = (int)(r / a.m), h = wh % a.heads, w = wh / a.heads;
  const float* p = a.scratch + 4 * rows + e;
  float x = 0.f;
  for (int t = 0; t < tiles; ++t) x += p[(size_t)t * rows * HD];
  static_cast<T*>(a.dq)[((size_t)w * a.m + i) * a.c + h * a.hd + d] = store_cast<T>(x);
}

// Whole-row chunk loads and copies of the tiled backward: head_dim its HD and
// every head row aligned to the chunk (min(16, HD sizeof(T)) bytes).
template <typename T>
bool tiled_vec_ok(const BwdArgs& a, int hd_inst) {
  const int cb = std::min(16, hd_inst * (int)sizeof(T));
  if (a.hd != hd_inst || (a.c * (int)sizeof(T)) % cb) return false;
  for (const void* p : {a.q, a.k, a.v, a.g})
    if (reinterpret_cast<uintptr_t>(p) % cb) return false;
  return true;
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

constexpr int kWideKeys = 32;   // keys of a scores tile and of a dk/dv block
constexpr int kWideRows = 64;   // rows of a scores tile; rows a dk/dv block takes at a time
constexpr int kWideQRows = 32;  // rows of a dq block
constexpr int kWideQKeys = 64;  // keys a dq block takes at a time
static_assert(kWideKeys == 32, "a lane per key of a scores tile");

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

// Launches the register kernel for (T, HD, J) when `a` is given; otherwise
// writes its occupancy at `smem` bytes to info.
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
  return occupancy(kernel, kThreads, smem, info);
}

template <typename T, int HD>
cudaError_t run_j(int j, const BwdArgs* a, size_t smem, long long* info, cudaStream_t stream) {
  switch (j) {
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

// The tiled backward's three launches at M rows with `a`, or, when `a` is
// null, the occupancy of its rows and keys kernels in info: the most
// registers, spill bytes and shared memory of the two, the keys kernel's
// threads and the fewest resident blocks per SM.
template <typename T, int HD>
cudaError_t run_tiled(int m, const BwdArgs* a, long long* info, cudaStream_t stream) {
  const int warps = keys_warps(m), groups = keys_groups(m);
  auto keys = groups > 1 ? attn_bwd_keys_kernel<T, HD, true> : attn_bwd_keys_kernel<T, HD, false>;
  const size_t smem = tiled_keys_smem<T>(m, HD), rsmem = tiled_rows_smem<T>(HD);
  cudaError_t err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_rows_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rsmem);
  if (err != cudaSuccess) return err;
  if (a == nullptr) {
    long long rows[5];
    err = occupancy(attn_bwd_rows_kernel<T, HD>, kRowsThreads, rsmem, rows);
    if (err != cudaSuccess) return err;
    err = occupancy(keys, 32 * warps, smem, info);
    if (err != cudaSuccess) return err;
    for (int f = 0; f < 3; ++f) info[f] = std::max(info[f], rows[f]);
    info[4] = std::min(info[4], rows[4]);
    return cudaSuccess;
  }
  attn_bwd_rows_kernel<T, HD><<<dim3(a->b, a->heads, cdiv(m, (kRowsThreads / 32) * tiled_rows(HD))),
                                kRowsThreads, rsmem, stream>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys<<<dim3(cdiv(a->n, kTileKeys), a->heads, groups), 32 * warps, smem, stream>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)a->b * a->heads * m * HD +
                       (groups > 1 ? (size_t)a->b * a->n * a->heads * 2 * HD : 0);
  attn_bwd_dq_reduce_kernel<T, HD><<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(*a, groups);
  return cudaGetLastError();
}
template <typename T>
cudaError_t run_tiled_hd(int hd, int m, const BwdArgs* a, long long* info, cudaStream_t stream) {
  switch (tiled_hd(hd)) {
    case 4: return run_tiled<T, 4>(m, a, info, stream);
    case 8: return run_tiled<T, 8>(m, a, info, stream);
    case 16: return run_tiled<T, 16>(m, a, info, stream);
    case 32: return run_tiled<T, 32>(m, a, info, stream);
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

// Launches the register kernel with row share j or, with j 0, the tiled
// backward, or above head_dim 32 (j 0) the wide backward, with `a` (setting
// its head_dim, pass-2 slices and copy width), or writes the occupancy and
// J, S and the key tile to info[0..7] when `a` is null (J and S 0 for the
// tiled and the wide backward, key tile 0 for the wide). A head_dim between
// the instantiated ones runs at the next one up (padded_hd).
cudaError_t dispatch(int is_bf16, int m, int n, int c, int heads, int j, BwdArgs* a,
                     long long* info, cudaStream_t stream) {
  if (heads < 1 || c % heads || (j && n > 32 * j)) return cudaErrorInvalidValue;
  const int hd = padded_hd(c / heads);
  if (hd > 32) {
    if (j) return cudaErrorInvalidValue;
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
  if (!j) {
    if (a != nullptr) {
      a->hd = c / heads;
      a->vec = is_bf16 ? tiled_vec_ok<__nv_bfloat16>(*a, tiled_hd(hd)) : tiled_vec_ok<float>(*a, tiled_hd(hd));
    } else {
      info[5] = 0;
      info[6] = 0;
      info[7] = kTileKeys;
    }
    return is_bf16 ? run_tiled_hd<__nv_bfloat16>(hd, m, a, info, stream)
                   : run_tiled_hd<float>(hd, m, a, info, stream);
  }
  const int slices = pass2_slices(m, n, hd, j);
  if (a != nullptr) {
    a->hd = c / heads;
    a->slices = slices;
  } else {
    info[5] = j;
    info[6] = slices;
    info[7] = 0;
  }
  const size_t smem = sizeof(float) * bwd_smem_floats(m, n, hd);
  return is_bf16 ? run_hd<__nv_bfloat16>(hd, j, a, smem, info, stream)
                 : run_hd<float>(hd, j, a, smem, info, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) of the backward's largest block in f32: the register
// kernel with row share j, or with j 0 the tiled backward's keys kernel, or
// above head_dim 32 the wide backward's (the wrapper's
// attn_core_bwd_smem_bytes computes the same).
long long attn_core_bwd_smem_bytes(int m, int n, int c, int heads, int j) {
  const int hd = padded_hd(c / heads);
  if (hd > 32)
    return (long long)std::max(
        {wide_scores_smem<float>(), wide_dkdv_smem<float>(), wide_dq_smem<float>()});
  if (!j) return (long long)tiled_smem<float>(m, tiled_hd(hd));
  return (long long)(sizeof(float) * bwd_smem_floats(m, n, hd));
}

// Floats of f32 scratch the backward needs at these shapes: the wide
// backward's s and dp planes and row statistics above head_dim 32, the tiled
// backward's row statistics ((B_, H, M) float4), dq partial sums (a
// (B_, H, M, HD) plane a 32-key tile) and, past 128 rows, each row group's
// dk and dv ((groups, B_, N, H, 2 HD)) with row share 0, else 0.
long long attn_core_bwd_scratch_floats(int b, int m, int n, int c, int heads, int j) {
  const int hd = padded_hd(c / heads);
  if (hd > 32) return (long long)WidePlanes::floats(b, m, n, heads);
  if (j) return 0;
  const long long thd = tiled_hd(hd), groups = keys_groups(m);
  const long long dkv = groups > 1 ? groups * b * n * heads * 2 * thd : 0;
  return (long long)b * heads * m * (4 + (long long)cdiv(n, kTileKeys) * thd) + dkv;
}

// The instantiation a launch at these shapes with row share j takes:
// info[0..7] = registers, local (spill) bytes per thread, dynamic shared
// memory per block, threads per block, resident blocks per SM, J (keys a
// lane keeps of a row; 0 for the tiled and the wide backward), S (lanes per
// key in pass 2) and the key tile (the tiled backward's keys kernel's; 0 for
// the wide backward). The tiled and the wide backward report the extremes of
// their kernels. Returns the CUDA error code (0 on success).
int attn_core_bwd_occupancy(int is_bf16, int m, int n, int c, int heads, int j, long long* info) {
  return (int)dispatch(is_bf16, m, n, c, heads, j, nullptr, info, nullptr);
}

// Launches the backward with row share j (12, 16 or 32 keys a lane, N <=
// 32 j) and the dbias reduction, or with j 0 the tiled backward (which
// writes dbias itself), or above head_dim 32 (j 0) the wide backward and the
// reduction, on `stream`; returns the first CUDA error code (0 on success).
// q/k/v/g/dq/dk/dv are f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); bias,
// partial, dbias and scratch are f32. partial is (groups, H, M, N): the wide
// backward takes groups = B_ (a ds plane a window), the tiled backward none
// (null); scratch holds attn_core_bwd_scratch_floats floats (null where
// that is 0).
int attn_core_backward(int is_bf16, int b, int m, int n, int c, int heads, int groups, int j,
                       float scale, const void* q, const void* k, const void* v, const float* bias,
                       const void* g, void* dq, void* dk, void* dv, float* partial, float* dbias,
                       float* scratch, void* stream) {
  if (heads < 1 || c % heads || groups < 1 || groups > b) return (int)cudaErrorInvalidValue;
  const int hd = padded_hd(c / heads);
  const bool tiled = hd <= 32 && !j;
  if ((hd > 32 && groups != b) || ((hd > 32 || tiled) && scratch == nullptr) ||
      (!tiled && partial == nullptr))
    return (int)cudaErrorInvalidValue;
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
  a.dbias = dbias;
  a.scratch = scratch;
  a.vec = false;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch(is_bf16, m, n, c, heads, j, &a, nullptr, s);
  if (err != cudaSuccess || tiled) return (int)err;
  const long long plane = (long long)heads * m * n;
  dbias_reduce_kernel<<<(unsigned)((plane + 255) / 256), 256, 0, s>>>(partial, dbias, groups,
                                                                      plane);
  return (int)cudaGetLastError();
}

}  // extern "C"
