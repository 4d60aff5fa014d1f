// Device code shared by the window-attention kernels (swin_block.cu,
// window_block.cu, window_attention.cu): the GEMM core behind every
// projection and MLP stage, and the attention core with a warp per query
// row. f32 or bf16 operands, f32 accumulation; round() below means a cast to
// the operand type and back (device_common.cuh), placed where the Pallas
// bodies in bde2vid_tpu/ops/window_attn_pallas.py cast.
#pragma once

#include <string.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "device_common.cuh"

namespace {

constexpr float kLnEps = 1e-5f;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one Hopper block may use

// ---------------------------------------------------------------------------
// epilogue: out = cast(res + mask * act(acc + bias)), each of act, mask and
// res optional
// ---------------------------------------------------------------------------

// The registry activations (bde2vid_tpu_torch/nn/layers.py); GELU is the
// exact-erf form with the Abramowitz & Stegun 7.1.26 erf (|err| <= 1.5e-7),
// as in the Pallas body and the plain twin.
enum Act : int {
  kActGelu = 0,
  kActRelu = 1,
  kActRelu6 = 2,
  kActSigmoid = 3,
  kActTanh = 4,
  kActLeakyRelu = 5,
  kActElu = 6,
  kActSoftplus = 7,
  kActIdentity = 8,
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

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kActGelu: return 0.5f * v * (1.0f + erf_as(v * 0.7071067811865476f));
    case kActRelu: return fmaxf(v, 0.f);
    case kActRelu6: return fminf(fmaxf(v, 0.f), 6.f);
    case kActSigmoid: return 1.f / (1.f + expf(-v));
    case kActTanh: return tanhf(v);
    case kActLeakyRelu: return v > 0.f ? v : 0.01f * v;
    case kActElu: return v > 0.f ? v : expm1f(v);
    case kActSoftplus: return v > 20.f ? v : log1pf(expf(v));  // torch's threshold
    default: return v;
  }
}

struct Epilogue {
  const float* bias;   // (O,)
  int act;             // Act; kActIdentity: none
  const float* mask;   // (rows / mask_rows,) per-window multipliers, or null
  int mask_rows;       // rows that share one mask entry (a window's M tokens)
  const void* res;     // (rows, ld) residual, or null
  bool res_f32;        // the residual is f32 (else the operand type)
  void* out;           // (rows, ld)
  bool out_f32;        // the output is f32 (else the operand type)
  int ld;              // row stride of res and out
};

template <typename T>
__device__ __forceinline__ void apply_epilogue(const Epilogue& e, int r, int o, float v) {
  v = activate(v + __ldg(e.bias + o), e.act);
  if (e.mask) v *= __ldg(e.mask + r / e.mask_rows);
  const size_t i = (size_t)r * e.ld + o;
  if (e.res) v += e.res_f32 ? ldg(static_cast<const float*>(e.res), i) : ldg(static_cast<const T*>(e.res), i);
  if (e.out_f32) {
    static_cast<float*>(e.out)[i] = v;
  } else {
    static_cast<T*>(e.out)[i] = store_cast<T>(v);
  }
}

Epilogue bias_epilogue(const float* bias, void* out, int ld) {
  return Epilogue{bias, kActIdentity, nullptr, 1, nullptr, false, out, false, ld};
}

// ---------------------------------------------------------------------------
// GEMM core: C[r][o] = sum_k A[r][k] * W[o][k] for a BM x BN block tile, W
// (O, K) row-major ((out, in) like torch.nn.Linear). Four warps; operand
// tiles reach shared memory through cp.async, two stages of 128-byte rows,
// so the copy of k-tile kt+1 overlaps the products of k-tile kt. A either
// stays resident over all of K (filled by a LayerNorm prologue) or streams
// beside W. The epilogue runs from shared memory (store_tile).
//   f32:  FMA only, no TF32 (f32 stays exact); each thread accumulates a
//         TM x TN register tile (8x8, 8x4 or 4x4) from float4 shared loads.
//   bf16: mma.sync m16n8k16 on the tensor cores with ldmatrix fragments and
//         f32 accumulators; each warp owns a (BM/2) x (BN/2) tile.
// No split-K and no atomics: each output sums its k-tiles in order, so a
// launch repeats bit for bit.
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 128;
// at most 168 registers a thread: left to itself nvcc gives the f32 64x128
// tile 238-252 and only two blocks fit on an SM
constexpr int kGemmBlocksPerSm = 3;

template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
};
using TileL = Tile<64, 128>;
using TileM = Tile<64, 64>;
using TileS = Tile<32, 64>;

// Elements in 16 bytes: the row padding of every shared tile. It makes a
// row's stride an odd number of 16-byte chunks, so eight consecutive rows
// read at one k fall in eight distinct bank groups (float4 loads, ldmatrix).
template <typename T>
constexpr int kPad = 16 / (int)sizeof(T);
// reduction depth of one pipeline stage: 128-byte rows (32 f32, 64 bf16)
template <typename T>
constexpr int kBK = 128 / (int)sizeof(T);
template <typename T>
constexpr int kLd = kBK<T> + kPad<T>;  // row stride of a pipeline stage

// row stride of a resident A tile over k (K rounded up to kBK, zero-filled)
template <typename T>
__host__ __device__ inline int resident_ld(int k) {
  return (k + kBK<T> - 1) / kBK<T> * kBK<T> + kPad<T>;
}

// rows [0, rows) x columns [k0, k0 + kBK<T>) of a row-major global matrix (row
// stride ld) into a ROWS x kLd<T> shared tile; rows past `rows` and columns
// past k_total are zero. vec: 16-byte cp.async (base and ld 16-byte aligned,
// k_total a multiple of 16 bytes), else plain loads.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows, int ld, int k0,
                                          int k_total, bool vec) {
  constexpr int kChunks = kBK<T> / kPad<T>;
  static_assert(ROWS * kChunks % kGemmThreads == 0, "tile copy");
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * kChunks / kGemmThreads; ++i) {
      const int e = threadIdx.x + i * kGemmThreads;
      const int r = e / kChunks, kc = (e % kChunks) * kPad<T>;
      const bool ok = r < rows && k0 + kc < k_total;
      cp_async16(dst + r * kLd<T> + kc, ok ? src + (size_t)r * ld + k0 + kc : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kBK<T>; e += kGemmThreads) {
      const int r = e / kBK<T>, kk = e % kBK<T>;
      dst[r * kLd<T> + kk] =
          (r < rows && k0 + kk < k_total) ? src[(size_t)r * ld + k0 + kk] : store_cast<T>(0.f);
    }
  }
}

// f32: thread (tx, ty) = (tid % 16, tid / 16) owns rows ty + 8 i and columns
// tx + 16 j; per 4 k it reads TM + TN float4 and issues 4 TM TN FMAs.
template <class S>
struct FmaAcc {
  static constexpr int TM = S::BM / 8, TN = S::BN / 16;
  float acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  // one k-tile: A rows at as (row stride lda), W rows at ws (row stride ldw)
  __device__ __forceinline__ void step(const float* as, int lda, const float* ws, int ldw) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int k = 0; k < kBK<float>; k += 4) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * ldw + k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(as + (ty + 8 * i) * lda + k);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }

  // f(row in tile, column in tile, sum)
  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) f(ty + 8 * i, tx + 16 * j, acc[i][j]);
  }
};

// bf16: warps 2 x 2, warp (wm, wn) owns rows wm BM/2.. and columns wn BN/2..
// as MF x NF fragments of 16 x 8. A is row-major (ldmatrix x4 gives a 16x16
// fragment); W's (out, in) rows are the col-major B operand as they are
// (ldmatrix x4 gives two 8-column fragments).
template <class S>
struct MmaAcc {
  static constexpr int WTM = S::BM / 2, WTN = S::BN / 2;
  static constexpr int MF = WTM / 16, NF = WTN / 8;
  static_assert(MF >= 1 && NF % 2 == 0, "warp tile");
  float acc[MF][NF][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void step(const __nv_bfloat16* as, int lda, const __nv_bfloat16* ws,
                                       int ldw) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int k = 0; k < kBK<__nv_bfloat16>; k += 16) {
      uint32_t a[MF][4], b[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        ldmatrix_x4(a[i], as + (wm * WTM + i * 16 + (lane & 15)) * lda + k + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, ws + (wn * WTN + j * 8 + (lane >> 4) * 8 + (lane & 7)) * ldw + k +
                           ((lane >> 3) & 1) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wm * WTM + i * 16 + (lane >> 2) + (e >> 1) * 8, wn * WTN + j * 8 + (lane & 3) * 2 + (e & 1),
            acc[i][j][e]);
  }
};

template <typename T, class S>
struct AccFor;
template <class S>
struct AccFor<float, S> {
  using type = FmaAcc<S>;
};
template <class S>
struct AccFor<__nv_bfloat16, S> {
  using type = MmaAcc<S>;
};

// The k loop. The caller has issued and committed stage 0 (issue(0)).
template <typename T, class S, bool kResidentA>
struct Pipeline {
  T* as;               // resident A (row stride lda), or A's two stages
  int lda;
  T* ws;               // W's two stages
  const T* a;          // streamed A: the block's first row (row stride k)
  int a_rows;          //   rows in range
  const T* w;          // W: the block's first output row (row stride k)
  int w_rows;          //   rows in range
  int k;
  bool vec;

  __device__ __forceinline__ void issue(int kt) const {
    const int s = kt & 1;
    load_tile<T, S::BN>(ws + s * S::BN * kLd<T>, w, w_rows, k, kt * kBK<T>, k, vec);
    if constexpr (!kResidentA)
      load_tile<T, S::BM>(as + s * S::BM * kLd<T>, a, a_rows, k, kt * kBK<T>, k, vec);
  }

  template <class Acc>
  __device__ __forceinline__ void run(Acc& acc) const {
    const int nk = cdiv(k, kBK<T>);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        issue(kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int s = kt & 1;
      if constexpr (kResidentA) {
        acc.step(as + kt * kBK<T>, lda, ws + s * S::BN * kLd<T>, kLd<T>);
      } else {
        acc.step(as + s * S::BM * kLd<T>, kLd<T>, ws + s * S::BN * kLd<T>, kLd<T>);
      }
      __syncthreads();
    }
  }
};

// The epilogue through shared memory: the block's sums are staged as an f32
// BM x (BN + 4) tile over the spent operand stages, then applied in a rolled
// loop, consecutive threads on consecutive columns. Unrolled per register,
// each copy would inline the whole activation switch and the kernel
// outgrows the instruction cache (its stores then ran at a tenth of the
// card's write rate); here the code exists once and the loads and stores
// are coalesced.
template <class S>
constexpr size_t epilogue_smem() {
  return sizeof(float) * S::BM * (S::BN + 4);
}

template <typename T, class S, class Acc>
__device__ __forceinline__ void store_tile(const Acc& acc, float* cs, const Epilogue& e, int r0,
                                           int o0, int n_valid, int o_valid) {
  constexpr int ld = S::BN + 4;
  acc.for_each([&](int lr, int lo, float v) { cs[lr * ld + lo] = v; });
  __syncthreads();
#pragma unroll 1
  for (int i = threadIdx.x; i < S::BM * S::BN; i += kGemmThreads) {
    const int lr = i / S::BN, lo = i % S::BN;
    if (lr < n_valid && lo < o_valid) apply_epilogue<T>(e, r0 + lr, o0 + lo, cs[lr * ld + lo]);
  }
}

// ---------------------------------------------------------------------------
// the two GEMM kernels on the core
// ---------------------------------------------------------------------------

// out = epi(A @ W^T), A (rows, k) in the operand type, streamed.
struct GemmArgs {
  int rows, k, o_total;
  const void* a;
  const void* w;
  bool vec;  // 16-byte copies (k a multiple of 8, a and w 16-byte aligned)
  Epilogue epi;
};

template <typename T, class S>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm) gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(16) unsigned char gemm_smem_raw[];
  T* as = reinterpret_cast<T*>(gemm_smem_raw);
  T* ws = as + 2 * S::BM * kLd<T>;
  const int r0 = blockIdx.x * S::BM, o0 = blockIdx.y * S::BN;
  const int n_valid = min(S::BM, g.rows - r0);
  const int o_valid = min(S::BN, g.o_total - o0);
  const Pipeline<T, S, false> pipe{as, kLd<T>, ws, static_cast<const T*>(g.a) + (size_t)r0 * g.k,
                                   n_valid, static_cast<const T*>(g.w) + (size_t)o0 * g.k,
                                   o_valid, g.k, g.vec};
  pipe.issue(0);
  cp_async_commit();
  typename AccFor<T, S>::type acc;
  acc.zero();
  pipe.run(acc);  // ends on a barrier: the stages are free
  store_tile<T, S>(acc, reinterpret_cast<float*>(gemm_smem_raw), g.epi, r0, o0, n_valid, o_valid);
}

// One row set of a LayerNorm-prologue GEMM.
struct LnPart {
  int rows, o_total;
  const float *g, *b;  // (C,) LN affines
  const void* w;       // (O, C)
  Epilogue epi;
};

// out = epi(round(LN(row)) @ W^T) for up to two row sets: part 0 reads x,
// except that its rows of frame q_ind (rows_per_frame rows each) read ctr
// (the centre substitution, by source pointer; q_ind < 0: none); part 1
// reads ctr. A block normalises its rows once and keeps them resident over
// k = C while it loops over column tiles y, y + gridDim.y, ... (grid.y is
// only as wide as filling the card needs). grid.x: part 0's row tiles,
// then part 1's.
struct LnGemmArgs {
  int c, rows_per_frame, q_ind, tiles0;
  const void* x;
  const void* ctr;
  bool vec;  // 16-byte copies (c a multiple of 8, x, ctr and the weights 16-byte aligned)
  LnPart part[2];
};

// Shared memory: resident A, then W's two stages and (when the source rows
// are f32 and the operands bf16) an f32 stage for the raw rows, or the
// epilogue's tile over them.
template <typename T, typename Src, class S>
size_t ln_gemm_smem(int c) {
  size_t rest = sizeof(T) * 2 * (size_t)S::BN * kLd<T>;
  if (!std::is_same<Src, T>::value) rest += sizeof(Src) * (size_t)S::BM * (c + kPad<Src>);
  return sizeof(T) * (size_t)S::BM * resident_ld<T>(c) + std::max(rest, epilogue_smem<S>());
}

template <typename T, class S>
size_t gemm_smem() {
  return std::max(sizeof(T) * 2 * (size_t)(S::BM + S::BN) * kLd<T>, epilogue_smem<S>());
}

// dst row r = round(LN(src row r)) for rows [0, n_valid) of a block's tile,
// zero past C (up to the tile's k extent) and in rows [n_valid, BM). lpr
// lanes share a row (about C/16, a power of two), so a warp normalises
// 32/lpr rows at once and reduces over log2(lpr) shuffles. src may alias
// dst.
template <typename T, int BM, typename Src>
__device__ __forceinline__ void layernorm_rows(const Src* src, int lds, T* dst, int ldd, int n_valid,
                                               int c, const float* g, const float* b) {
  int lpr = 32;
  while (lpr > 1 && lpr * 16 > c) lpr >>= 1;
  const int kpad = ldd - kPad<T>;
  const int lane = threadIdx.x & 31, li = lane & (lpr - 1);
  const int rows_per_pass = kGemmThreads / lpr;
  for (int r = threadIdx.x / lpr, pass = 0; pass < BM; r += rows_per_pass, pass += rows_per_pass) {
    const bool valid = r < n_valid;
    const Src* x = src + r * lds;
    float s = 0.f;
    if (valid)
      for (int k = li; k < c; k += lpr) s += load(x, k);
    for (int o = lpr >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / c;
    float v = 0.f;
    if (valid)
      for (int k = li; k < c; k += lpr) {
        const float d = load(x, k) - mean;
        v += d * d;
      }
    for (int o = lpr >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float rstd = rsqrtf(v / c + kLnEps);
    if (r >= BM) continue;
    T* y = dst + r * ldd;
    if (valid)
      for (int k = li; k < c; k += lpr)
        y[k] = store_cast<T>((load(x, k) - mean) * rstd * __ldg(g + k) + __ldg(b + k));
    for (int k = (valid ? c : 0) + li; k < kpad; k += lpr) y[k] = store_cast<T>(0.f);
  }
}

// Source row r of part 1 (ctr) or part 0 (x, its frame q_ind read from ctr).
template <typename Src>
__device__ __forceinline__ const Src* ln_row(const LnGemmArgs& a, bool second, int r) {
  const Src* ctr = static_cast<const Src*>(a.ctr);
  if (second) return ctr + (size_t)r * a.c;
  if (r / a.rows_per_frame == a.q_ind) return ctr + (size_t)(r - a.q_ind * a.rows_per_frame) * a.c;
  return static_cast<const Src*>(a.x) + (size_t)r * a.c;
}

template <typename T, typename Src, class S>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm) ln_gemm_kernel(LnGemmArgs a) {
  extern __shared__ __align__(16) unsigned char gemm_smem_raw[];
  const bool second = blockIdx.x >= (unsigned)a.tiles0;
  const LnPart p = second ? a.part[1] : a.part[0];
  const int r0 = (second ? blockIdx.x - a.tiles0 : blockIdx.x) * S::BM;
  int o0 = blockIdx.y * S::BN;
  if (o0 >= p.o_total) return;
  const int c = a.c, lda = resident_ld<T>(c);
  T* as = reinterpret_cast<T*>(gemm_smem_raw);
  T* ws = as + S::BM * lda;
  const int n_valid = min(S::BM, p.rows - r0);
  auto row = [&](int lr) { return ln_row<Src>(a, second, r0 + lr); };

  // the raw rows: in place in the A tile when they have its type, else in an
  // f32 stage after W's stages
  Src* raw;
  int ldr;
  if constexpr (std::is_same<Src, T>::value) {
    raw = as;
    ldr = lda;
  } else {
    raw = reinterpret_cast<Src*>(ws + 2 * S::BN * kLd<T>);
    ldr = c + kPad<Src>;
  }
  if (a.vec) {
    const int chunks = c / kPad<Src>;
    for (int e = threadIdx.x; e < n_valid * chunks; e += kGemmThreads) {
      const int lr = e / chunks, kc = (e % chunks) * kPad<Src>;
      cp_async16(raw + lr * ldr + kc, row(lr) + kc, 16);
    }
  } else {
    for (int e = threadIdx.x; e < n_valid * c; e += kGemmThreads) {
      const int lr = e / c, k = e % c;
      raw[lr * ldr + k] = row(lr)[k];
    }
  }
  cp_async_commit();
  auto pipe_at = [&](int o) {
    return Pipeline<T, S, true>{as, lda, ws, nullptr, 0, static_cast<const T*>(p.w) + (size_t)o * c,
                                min(S::BN, p.o_total - o), c, a.vec};
  };
  pipe_at(o0).issue(0);  // the first W tile streams in while the rows are normalised
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  layernorm_rows<T, S::BM>(raw, ldr, as, lda, n_valid, c, p.g, p.b);

  typename AccFor<T, S>::type acc;
  for (;;) {
    acc.zero();
    pipe_at(o0).run(acc);  // its first barrier publishes the normalised rows
    store_tile<T, S>(acc, reinterpret_cast<float*>(ws), p.epi, r0, o0, n_valid,
                     min(S::BN, p.o_total - o0));
    o0 += gridDim.y * S::BN;
    if (o0 >= p.o_total) break;
    __syncthreads();  // the epilogue's tile lies over W's stages
    pipe_at(o0).issue(0);
    cp_async_commit();
  }
}

// The same GEMM where even the smallest tile's resident A rows do not fit in
// shared memory (f32 above C 1664; bf16 B1's LN2 -> MLP, whose f32 y rows
// are staged beside them, above C 1088): A streams over k like the plain
// GEMM core. The block first takes its rows' LayerNorm statistics in one
// sweep from device memory (a warp a row at a time: sums of x - x0 and of
// its square, x0 the row's first element, so that the variance does not
// cancel), then normalises each k stage of raw rows as it lands: in place
// when the rows have the operand type, else from an f32 stage into the
// operand-typed A stage. Shared memory no longer grows with C.
template <typename T, typename Src>
__host__ __device__ constexpr int stream_raw_ld() {
  return kBK<T> + kPad<Src>;  // row stride of an f32 raw stage (Src != T)
}

template <typename T, typename Src, class S>
constexpr size_t ln_stream_stage_bytes() {
  size_t b = sizeof(T) * 2 * (size_t)(S::BM + S::BN) * kLd<T>;
  if (!std::is_same<Src, T>::value) b += sizeof(Src) * 2 * (size_t)S::BM * stream_raw_ld<T, Src>();
  return b;
}

// the rows' (mean, rstd), then the stages or the epilogue's tile over them
template <typename T, typename Src, class S>
constexpr size_t ln_gemm_stream_smem() {
  return sizeof(float) * 2 * S::BM + std::max(ln_stream_stage_bytes<T, Src, S>(), epilogue_smem<S>());
}

template <typename T, typename Src, class S>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm) ln_gemm_stream_kernel(LnGemmArgs a) {
  extern __shared__ __align__(16) unsigned char gemm_smem_raw[];
  constexpr bool kSame = std::is_same<Src, T>::value;
  constexpr int RLD = kSame ? kLd<T> : stream_raw_ld<T, Src>();
  const bool second = blockIdx.x >= (unsigned)a.tiles0;
  const LnPart p = second ? a.part[1] : a.part[0];
  const int r0 = (second ? blockIdx.x - a.tiles0 : blockIdx.x) * S::BM;
  int o0 = blockIdx.y * S::BN;
  if (o0 >= p.o_total) return;
  const int c = a.c;
  float* mean = reinterpret_cast<float*>(gemm_smem_raw);  // (BM)
  float* rstd = mean + S::BM;                             // (BM)
  unsigned char* stages = gemm_smem_raw + sizeof(float) * 2 * S::BM;
  T* ws = reinterpret_cast<T*>(stages);  // W's two stages
  T* as = ws + 2 * S::BN * kLd<T>;       // A's two stages (normalised)
  // the raw rows' two stages: A's own when they have its type
  Src* raw = kSame ? reinterpret_cast<Src*>(as) : reinterpret_cast<Src*>(as + 2 * S::BM * kLd<T>);
  const int n_valid = min(S::BM, p.rows - r0);
  auto row = [&](int lr) { return ln_row<Src>(a, second, r0 + lr); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int lr = warp; lr < S::BM; lr += kGemmThreads / 32) {
    float s1 = 0.f, s2 = 0.f;
    if (lr < n_valid) {
      const Src* xr = row(lr);
      const float x0 = load(xr, 0);
      for (int k = lane; k < c; k += 32) {
        const float d = load(xr, k) - x0;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float dm = s1 / c;
      if (lane == 0) {
        mean[lr] = x0 + dm;
        rstd[lr] = rsqrtf(fmaxf(s2 / c - dm * dm, 0.f) + kLnEps);
      }
    } else if (lane == 0) {
      mean[lr] = 0.f;
      rstd[lr] = 0.f;
    }
  }

  const T* w_all = static_cast<const T*>(p.w);
  const int nk = cdiv(c, kBK<T>);
  // k-tile kt of W's rows o .. o + BN - 1 and of the raw rows into stage kt & 1
  auto fetch = [&](int o, int kt) {
    const int s = kt & 1, k0 = kt * kBK<T>;
    load_tile<T, S::BN>(ws + s * S::BN * kLd<T>, w_all + (size_t)o * c, min(S::BN, p.o_total - o), c, k0,
                        c, a.vec);
    constexpr int CH = kPad<Src>, PER = kBK<T> / CH;
    Src* dst = raw + s * S::BM * RLD;
    if (a.vec) {
      for (int e = threadIdx.x; e < S::BM * PER; e += kGemmThreads) {
        const int lr = e / PER, kc = (e - lr * PER) * CH;
        const bool ok = lr < n_valid && k0 + kc < c;
        cp_async16(dst + lr * RLD + kc, ok ? static_cast<const void*>(row(lr) + k0 + kc) : a.x, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < S::BM * kBK<T>; e += kGemmThreads) {
        const int lr = e / kBK<T>, kk = e - lr * kBK<T>;
        dst[lr * RLD + kk] = lr < n_valid && k0 + kk < c ? row(lr)[k0 + kk] : store_cast<Src>(0.f);
      }
    }
  };

  typename AccFor<T, S>::type acc;
  for (;;) {
    acc.zero();
    fetch(o0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        fetch(o0, kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the stage has landed (and, the first time, the statistics)
      const int s = kt & 1, k0 = kt * kBK<T>;
      const Src* rs = raw + s * S::BM * RLD;
      T* ad = as + s * S::BM * kLd<T>;
      for (int e = threadIdx.x; e < S::BM * kBK<T>; e += kGemmThreads) {
        const int lr = e / kBK<T>, kk = e - lr * kBK<T>, k = k0 + kk;
        const float v = lr < n_valid && k < c
                            ? (load(rs, lr * RLD + kk) - mean[lr]) * rstd[lr] * __ldg(p.g + k) + __ldg(p.b + k)
                            : 0.f;
        ad[lr * kLd<T> + kk] = store_cast<T>(v);
      }
      __syncthreads();
      acc.step(ad, kLd<T>, ws + s * S::BN * kLd<T>, kLd<T>);
      __syncthreads();
    }
    store_tile<T, S>(acc, reinterpret_cast<float*>(stages), p.epi, r0, o0, n_valid,
                     min(S::BN, p.o_total - o0));
    o0 += gridDim.y * S::BN;
    if (o0 >= p.o_total) break;
    __syncthreads();  // the epilogue's tile lies over the stages
  }
}

// 16-byte copies need k a multiple of 8 elements and 16-byte aligned bases.
bool vec_ok(int k, std::initializer_list<const void*> ptrs) {
  if (k % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The tile of a launch: the largest of L, M, S that gives every SM at least
// two blocks, is no wider than the output (rounded up to 64) and fits in
// shared memory; else S. blocks(bm, bn): the launch's working blocks;
// smem: each tile's bytes.
template <class Blocks>
cudaError_t pick_tile(int o_max, Blocks blocks, const size_t (&smem)[3], int* tile, int* sms_out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *sms_out = sms;
  const int shape[2][2] = {{TileL::BM, TileL::BN}, {TileM::BM, TileM::BN}};
  for (int t = 0; t < 2; ++t) {
    const int bm = shape[t][0], bn = shape[t][1];
    if (bn <= cdiv(o_max, 64) * 64 && smem[t] <= kMaxSmem && blocks(bm, bn) >= 2 * sms) {
      *tile = t;
      return cudaSuccess;
    }
  }
  *tile = 2;
  return smem[2] <= kMaxSmem ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, class S>
cudaError_t launch_gemm_tile(const GemmArgs& g, cudaStream_t stream) {
  const size_t smem = gemm_smem<T, S>();
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_kernel<T, S><<<dim3(cdiv(g.rows, S::BM), cdiv(g.o_total, S::BN)), kGemmThreads, smem,
                      stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  int tile = 0, sms = 0;
  const cudaError_t err = pick_tile(
      g.o_total, [&](int bm, int bn) { return cdiv(g.rows, bm) * cdiv(g.o_total, bn); },
      {gemm_smem<T, TileL>(), gemm_smem<T, TileM>(), gemm_smem<T, TileS>()}, &tile, &sms);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 0: return launch_gemm_tile<T, TileL>(g, stream);
    case 1: return launch_gemm_tile<T, TileM>(g, stream);
    default: return launch_gemm_tile<T, TileS>(g, stream);
  }
}

// grid.y: the column tiles, or as many as give every SM two blocks
template <typename T, typename Src, class S>
cudaError_t launch_ln_gemm_tile(LnGemmArgs a, int sms, cudaStream_t stream) {
  a.tiles0 = cdiv(a.part[0].rows, S::BM);
  const int tiles1 = cdiv(a.part[1].rows, S::BM);
  const int cols = std::min(std::max(cdiv(a.part[0].o_total, S::BN), cdiv(a.part[1].o_total, S::BN)),
                            std::max(1, cdiv(2 * sms, a.tiles0 + tiles1)));
  const size_t smem = ln_gemm_smem<T, Src, S>(a.c);
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_kernel<T, Src, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_gemm_kernel<T, Src, S><<<dim3(a.tiles0 + tiles1, cols), kGemmThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// grid.y as launch_ln_gemm_tile's, for the streamed variant
template <typename T, typename Src, class S>
cudaError_t launch_ln_gemm_stream_tile(LnGemmArgs a, int sms, cudaStream_t stream) {
  a.tiles0 = cdiv(a.part[0].rows, S::BM);
  const int tiles1 = cdiv(a.part[1].rows, S::BM);
  const int cols = std::min(std::max(cdiv(a.part[0].o_total, S::BN), cdiv(a.part[1].o_total, S::BN)),
                            std::max(1, cdiv(2 * sms, a.tiles0 + tiles1)));
  constexpr size_t smem = ln_gemm_stream_smem<T, Src, S>();
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_stream_kernel<T, Src, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_gemm_stream_kernel<T, Src, S><<<dim3(a.tiles0 + tiles1, cols), kGemmThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Whether the LN-prologue GEMM at width c streams A (ln_gemm_stream_kernel):
// where not even the smallest tile's resident rows fit.
template <typename T, typename Src>
bool ln_gemm_streams(int c) {
  return ln_gemm_smem<T, Src, TileS>(c) > kMaxSmem;
}

// Shared memory of the smallest tile of the LN-prologue GEMM a launch at
// width c takes, resident or streamed: it fails unless this fits (a larger
// tile is taken only where it fits too).
template <typename T, typename Src>
size_t ln_gemm_launch_smem(int c) {
  return ln_gemm_streams<T, Src>(c) ? ln_gemm_stream_smem<T, Src, TileS>() : ln_gemm_smem<T, Src, TileS>(c);
}

// part[1].rows = 0: one row set
template <typename T, typename Src>
cudaError_t launch_ln_gemm(const LnGemmArgs& a, cudaStream_t stream) {
  const LnPart &p0 = a.part[0], &p1 = a.part[1];
  auto blocks = [&](int bm, int bn) {
    return cdiv(p0.rows, bm) * cdiv(p0.o_total, bn) + cdiv(p1.rows, bm) * cdiv(p1.o_total, bn);
  };
  const int o_max = std::max(p0.o_total, p1.o_total);
  int tile = 0, sms = 0;
  if (ln_gemm_streams<T, Src>(a.c)) {
    const cudaError_t err = pick_tile(o_max, blocks,
                                      {ln_gemm_stream_smem<T, Src, TileL>(), ln_gemm_stream_smem<T, Src, TileM>(),
                                       ln_gemm_stream_smem<T, Src, TileS>()},
                                      &tile, &sms);
    if (err != cudaSuccess) return err;
    switch (tile) {
      case 0: return launch_ln_gemm_stream_tile<T, Src, TileL>(a, sms, stream);
      case 1: return launch_ln_gemm_stream_tile<T, Src, TileM>(a, sms, stream);
      default: return launch_ln_gemm_stream_tile<T, Src, TileS>(a, sms, stream);
    }
  }
  const cudaError_t err = pick_tile(
      o_max, blocks,
      {ln_gemm_smem<T, Src, TileL>(a.c), ln_gemm_smem<T, Src, TileM>(a.c),
       ln_gemm_smem<T, Src, TileS>(a.c)},
      &tile, &sms);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 0: return launch_ln_gemm_tile<T, Src, TileL>(a, sms, stream);
    case 1: return launch_ln_gemm_tile<T, Src, TileM>(a, sms, stream);
    default: return launch_ln_gemm_tile<T, Src, TileS>(a, sms, stream);
  }
}

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
// q = round(LN_q(ctr) @ Wq^T + bq): one LN-prologue GEMM launch over both
// row sets.
LnGemmArgs ln_proj_gemm(const LnProjArgs& p) {
  LnGemmArgs a{};
  a.c = p.c;
  a.rows_per_frame = p.b * p.m;
  a.q_ind = p.q_ind;
  a.x = p.x;
  a.ctr = p.ctr;
  a.vec = vec_ok(p.c, {p.x, p.ctr, p.w_q, p.w_kv});
  a.part[0] = LnPart{p.d * p.b * p.m, 2 * p.c, p.g_kv, p.b_kv_ln, p.w_kv,
                     bias_epilogue(p.b_kv, p.kv, 2 * p.c)};
  a.part[1] = LnPart{p.b * p.m, p.c, p.g_q, p.b_q_ln, p.w_q, bias_epilogue(p.b_q, p.q, p.c)};
  return a;
}

template <typename T>
cudaError_t launch_ln_proj(const LnProjArgs& p, cudaStream_t stream) {
  return launch_ln_gemm<T, T>(ln_proj_gemm(p), stream);
}

// shared memory of the smallest tile (ln_gemm_launch_smem)
template <typename T>
size_t ln_proj_smem_bytes(int c) {
  return ln_gemm_launch_smem<T, T>(c);
}

// ---------------------------------------------------------------------------
// attention core: per window w and head h,
//   out_h = round(softmax(q_h k_h^T * scale + bias_h)) @ v_h
// Block (window, head, tile) stages the window's k and v columns of head h
// in shared memory (f32, rows padded by key_stride) and takes every tiles-th
// group of 8 query rows, a warp per row. The warp keeps its lane's J
// keys of the score row in registers (lane + 32 j), takes exp as one
// ex2.approx of fmaf(s, log2 e, -max log2 e), multiplies by one reciprocal
// of the row's sum, and sums p v over its keys in registers; the warp's
// partial outputs meet in one reduce-scatter of shuffles. Rows longer than
// 32 J keys run the same code over chunks of 32 J keys: one sweep for the
// running max and sum, a second for p v. head_dim 4 is below an MMA's K,
// so every product is an FMA; bf16 at head_dim >= 16 takes the tensor
// cores (attn_kernel_mma). Windows whose k and v rows do not fit in one
// block's shared memory, and every head_dim from 33 to 256, take the
// key-tiled variant (attn_flash_kernel); every head_dim above 256 the wide
// forward (attn_wide_scores_kernel, attn_wide_out_kernel). A head_dim
// between the instantiated ones (1, 2, 4, ..., 256) runs at the next one
// up with zero columns past it. The wrapper picks the tiles and whether the
// keys are tiled (attn_forward_plan in ops/window_attn_cuda.py); the
// launchers take both from its plan.
// ---------------------------------------------------------------------------

// 8 warps a block. A warp takes one query row at a time (attn_kernel) or,
// on the tensor cores, 16 rows (attn_kernel_mma). A thread keeps to 64
// registers at head_dim <= 4 (four blocks an SM) and to 128 (two) below
// head_dim 32.
constexpr int kAttnThreads = 256;
__host__ __device__ constexpr int attn_min_blocks(int hd) { return hd <= 4 ? 4 : hd <= 16 ? 2 : 1; }

// The kv tokens of window w come in one of two layouts. The block kernels
// read the (D, B_, M, 2C) k|v scratch that the LN + projection GEMM writes
// (kKvScratch: token n is frame n / M, token n % M, with v C elements after
// k); the bare attention reads separate (B_, N, C) k and v.
struct AttnArgs {
  int b, m, n, c, heads;
  int hd;     // head_dim C / heads; kernels instantiated at a larger HD see zeros past it
  int tiles;  // block (w, h, tile) takes rows 8 (tile + tiles k) + warp, k = 0, 1, ...
  int key_tiled;  // 1: attn_flash_kernel (flash_key_tile keys a staged tile); 0: all keys at once
  const void* q;  // (B_, M, C)
  const void* k;  // k|v scratch (kKvScratch), else (B_, N, C)
  const void* v;  // (B_, N, C) (unused with kKvScratch)
  const float* bias;  // (H, M, N) f32
  void* out;          // (B_, M, C)
  float* scratch;     // the wide forward's planes (head_dim > 256; WideFwdPlanes), else null
  bool vec;           // q, k and v are aligned for kChunk-element loads (and hd == HD)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Elements of T in one load of a head's row: 16 bytes where head_dim
// allows, else the whole row.
template <typename T, int HD>
constexpr int kChunk = HD * (int)sizeof(T) < 16 ? HD : 16 / (int)sizeof(T);

// r = p[0 .. CH) in f32 from one load of CH * sizeof(T) bytes (p aligned to
// that many bytes).
template <typename T, int CH>
__device__ __forceinline__ void load_chunk(float (&r)[CH], const T* p) {
  constexpr int kBytes = CH * (int)sizeof(T);
  using V = typename std::conditional<
      kBytes == 16, uint4,
      typename std::conditional<
          kBytes == 8, uint2,
          typename std::conditional<kBytes == 4, unsigned, unsigned short>::type>::type>::type;
  const V u = *reinterpret_cast<const V*>(p);
  T t[CH];
  memcpy(t, &u, kBytes);
#pragma unroll
  for (int i = 0; i < CH; ++i) r[i] = to_f32(t[i]);
}

// r = p[0 .. HD) in f32: kChunk-element loads when vec, else one by one,
// zero past the head's hd columns.
template <typename T, int HD>
__device__ __forceinline__ void load_head_row(float (&r)[HD], const T* p, bool vec, int hd) {
  constexpr int CH = kChunk<T, HD>;
  if (vec) {
#pragma unroll
    for (int d = 0; d < HD; d += CH) {
      float t[CH];
      load_chunk<T, CH>(t, p + d);
#pragma unroll
      for (int i = 0; i < CH; ++i) r[d + i] = t[i];
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) r[d] = d < hd ? load(p, d) : 0.f;
  }
}

// Offset of kv token nn of window w (head 0, k half) in the layout.
template <bool kKvScratch>
__device__ __forceinline__ size_t kv_offset(const AttnArgs& a, int w, int nn) {
  if (kKvScratch) {
    const int frame = nn / a.m, tok = nn - frame * a.m;
    return (((size_t)frame * a.b + w) * a.m + tok) * 2 * a.c;
  }
  return ((size_t)w * a.n + nn) * a.c;
}

// Keys n0 .. n0 + cnt - 1 of window w's k and v columns of head h into ks
// and vs, (cnt, KS) f32 each, zero past the head's hd columns.
template <typename T, int HD, bool kKvScratch>
__device__ __forceinline__ void stage_keys(float* ks, float* vs, const AttnArgs& a, int w, int h,
                                           int n0, int cnt) {
  constexpr int CH = kChunk<T, HD>, KS = key_stride(HD), PER = HD / CH;
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = kKvScratch ? kg + a.c : static_cast<const T*>(a.v);
#pragma unroll 4
  for (int e = threadIdx.x; e < cnt * PER; e += blockDim.x) {
    const int nn = e / PER, d0 = (e - nn * PER) * CH;
    const size_t off = kv_offset<kKvScratch>(a, w, n0 + nn) + h * a.hd + d0;
    float kr[CH], vr[CH];
    if (a.vec) {
      load_chunk<T, CH>(kr, kg + off);
      load_chunk<T, CH>(vr, vg + off);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const bool in = d0 + i < a.hd;
        kr[i] = in ? load(kg, off + i) : 0.f;
        vr[i] = in ? load(vg, off + i) : 0.f;
      }
    }
    float* kd = ks + nn * KS + d0;
    float* vd = vs + nn * KS + d0;
    if constexpr (CH % 4 == 0) {
#pragma unroll
      for (int i = 0; i < CH; i += 4) {
        *reinterpret_cast<float4*>(kd + i) = make_float4(kr[i], kr[i + 1], kr[i + 2], kr[i + 3]);
        *reinterpret_cast<float4*>(vd + i) = make_float4(vr[i], vr[i + 1], vr[i + 2], vr[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        kd[i] = kr[i];
        vd[i] = vr[i];
      }
    }
  }
}

// Window w's k and v columns of head h into ks and vs, (N, KS) f32 each.
template <typename T, int HD, bool kKvScratch>
__device__ __forceinline__ void stage_window(float* ks, float* vs, const AttnArgs& a, int w,
                                             int h) {
  stage_keys<T, HD, kKvScratch>(ks, vs, a, w, h, 0, a.n);
}

// b[j] = brow[base + lane + 32 j] for the keys below n (0 past them).
template <int J>
__device__ __forceinline__ void load_bias_share(float (&b)[J], const float* brow, int base, int n,
                                                int lane) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int nn = base + lane + 32 * j;
    b[j] = nn < n ? __ldg(brow + nn) : 0.f;
  }
}

// sv[j] = q . k[base + lane + 32 j] * scale + b[j] for the keys below n;
// returns the lane's largest score (-inf if it has none).
template <int HD, int J>
__device__ __forceinline__ float chunk_scores(float (&sv)[J], const float (&qv)[HD],
                                              const float (&b)[J], const float* ks, int base,
                                              int n, int lane, float scale) {
  constexpr int KS = key_stride(HD);
  float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int nn = base + lane + 32 * j;
    sv[j] = 0.f;
    if (nn < n) {
      float kr[HD];
      load_row<HD>(kr, ks + nn * KS);
      sv[j] = fmaf(dot<HD>(qv, kr), scale, b[j]);
      mx = fmaxf(mx, sv[j]);
    }
  }
  return mx;
}

// o += round(p[j]) v[base + lane + 32 j] over the keys below n.
template <typename T, int HD, int J>
__device__ __forceinline__ void accumulate_pv(float (&o)[HD], const float (&p)[J],
                                              const float* vs, int base, int n, int lane) {
  constexpr int KS = key_stride(HD);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int nn = base + lane + 32 * j;
    if (nn < n) {
      const float pj = round_to<T>(p[j]);
      float vr[HD];
      load_row<HD>(vr, vs + nn * KS);
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = fmaf(pj, vr[d], o[d]);
    }
  }
}

// One step of warp_reduce_scatter: lanes with bit O set keep the upper
// HALF of v[0 .. 2 HALF) and take the partner's upper half; the others keep
// and take the lower half. Recursion, not a loop, so that every index
// stays a constant and v stays in registers.
template <int HALF, int O, int HD>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[HD], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_scatter_step<HALF / 2, O / 2, HD>(v, lane);
  }
}

// s plus its copies in the lanes O, O / 2, ..., 1 apart.
template <int O>
__device__ __forceinline__ float butterfly_sum(float s) {
  if constexpr (O >= 1) return butterfly_sum<O / 2>(s + __shfl_xor_sync(0xffffffffu, s, O));
  return s;
}

// Sums v[0 .. HD) over the warp's lanes in a fixed order: each step hands
// half of the components to the lane `o` apart, so a lane ends with the
// sum of component lane / (32 / HD), in HD - 1 + 5 - log2(HD) shuffles.
template <int HD>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[HD], int lane) {
  reduce_scatter_step<HD / 2, 16, HD>(v, lane);
  return butterfly_sum<16 / HD>(v[0]);
}

// Query row i of window w, head h: scores, softmax and p v, written to out.
// b holds the lane's share of the row's bias when the row fits in 32 J
// keys; longer rows read it from brow one chunk at a time.
template <typename T, int HD, int J>
__device__ __forceinline__ void attend_row(const AttnArgs& a, int w, int h, int i,
                                           const float (&b)[J], const float* brow,
                                           const float* ks, const float* vs, float scale,
                                           int lane) {
  const int n = a.n;
  const size_t row = ((size_t)w * a.m + i) * a.c + h * a.hd;
  float qv[HD];
  load_head_row<T, HD>(qv, static_cast<const T*>(a.q) + row, a.vec, a.hd);
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  float sv[J];
  if (n <= 32 * J) {
    const float mxl = warp_max(chunk_scores<HD, J>(sv, qv, b, ks, 0, n, lane, scale)) * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j < n) {
        sv[j] = fast_exp2(fmaf(sv[j], kLog2e, -mxl));
        sum += sv[j];
      }
    }
    const float inv = 1.f / warp_sum(sum);
#pragma unroll
    for (int j = 0; j < J; ++j) sv[j] *= inv;
    accumulate_pv<T, HD, J>(o, sv, vs, 0, n, lane);
  } else {
    // sweep 1: the running max (times log2 e) and the lane's sum under it
    float bc[J];
    float mxl = __int_as_float(0xff800000), sum = 0.f;
    for (int base = 0; base < n; base += 32 * J) {
      load_bias_share<J>(bc, brow, base, n, lane);
      const float cm = warp_max(chunk_scores<HD, J>(sv, qv, bc, ks, base, n, lane, scale)) * kLog2e;
      const float nm = fmaxf(mxl, cm);
      sum *= fast_exp2(mxl - nm);
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (base + lane + 32 * j < n) sum += fast_exp2(fmaf(sv[j], kLog2e, -nm));
      mxl = nm;
    }
    const float inv = 1.f / warp_sum(sum);
    // sweep 2: the scores again, p and p v
    for (int base = 0; base < n; base += 32 * J) {
      load_bias_share<J>(bc, brow, base, n, lane);
      chunk_scores<HD, J>(sv, qv, bc, ks, base, n, lane, scale);
#pragma unroll
      for (int j = 0; j < J; ++j) sv[j] = fast_exp2(fmaf(sv[j], kLog2e, -mxl)) * inv;
      accumulate_pv<T, HD, J>(o, sv, vs, base, n, lane);
    }
  }
  const float s = warp_reduce_scatter<HD>(o, lane);
  constexpr int kLanesPerComponent = 32 / HD;
  if (lane % kLanesPerComponent == 0 && lane / kLanesPerComponent < a.hd)
    static_cast<T*>(a.out)[row + lane / kLanesPerComponent] = store_cast<T>(s);
}

template <typename T, int HD, int J, bool kKvScratch>
__global__ void __launch_bounds__(kAttnThreads, attn_min_blocks(HD))
    attn_kernel(AttnArgs a, float scale) {
  extern __shared__ float smem[];
  constexpr int KS = key_stride(HD);
  const int w = blockIdx.x, h = blockIdx.y;
  float* ks = smem;           // (N, KS)
  float* vs = ks + a.n * KS;  // (N, KS)
  stage_window<T, HD, kKvScratch>(ks, vs, a, w, h);
  __syncthreads();

  // tile t's warp w takes rows t 8 + w, then every 8 tiles-th row on
  const int lane = threadIdx.x & 31;
  const float* bias_h = a.bias + (size_t)h * a.m * a.n;
  for (int i = blockIdx.z * (kAttnThreads / 32) + (threadIdx.x >> 5); i < a.m;
       i += a.tiles * (kAttnThreads / 32)) {
    const float* brow = bias_h + (size_t)i * a.n;
    float b[J];
    load_bias_share<J>(b, brow, 0, a.n, lane);
    attend_row<T, HD, J>(a, w, h, i, b, brow, ks, vs, scale, lane);
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim >= 16: the same function on the tensor cores. A warp
// takes 16 query rows of one window, the A operand of mma.sync m16n8k16
// (f32 accumulators), with q's fragments loaded once. Sweep 1 runs q k^T
// over the keys 8 at a time and keeps each row's running max and sum of
// exp (a lane holds two rows; the four lanes of a row then combine theirs
// in a fixed order); sweep 2 recomputes q k^T 16 keys at a time, forms
// p = round(exp(s - max) / sum) in the A layout of the next product and
// adds p v. Shared memory holds k as rows of head_dim (q k^T's B operand
// as it is) and v transposed (p v's B operand), both bf16. The bias comes
// from L2 once a sweep.
// ---------------------------------------------------------------------------

// Row strides (bf16) of the staged k rows and v^T rows: eight lanes on
// consecutive rows reading 4 bytes at one column hit distinct banks.
__host__ __device__ constexpr int mma_k_stride(int hd) { return hd + 8; }
__host__ __device__ inline int mma_keys(int n) { return cdiv(n, 16) * 16; }
__host__ __device__ inline int mma_v_stride(int n) { return mma_keys(n) + 8; }

size_t attn_mma_smem_bytes(int n, int hd) {
  return sizeof(__nv_bfloat16) *
         ((size_t)mma_keys(n) * mma_k_stride(hd) + (size_t)hd * mma_v_stride(n));
}

// Window w's k rows and v^T columns of head h, zero past N and past the
// head's hd columns.
template <int HD, bool kKvScratch>
__device__ __forceinline__ void stage_window_mma(__nv_bfloat16* ks, __nv_bfloat16* vt,
                                                 const AttnArgs& a, int w, int h) {
  constexpr int KST = mma_k_stride(HD), PER = HD / 8;
  const int npad = mma_keys(a.n), vst = mma_v_stride(a.n);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vg = kKvScratch ? kg + a.c : static_cast<const __nv_bfloat16*>(a.v);
  for (int e = threadIdx.x; e < npad * PER; e += blockDim.x) {
    const int nn = e / PER, d0 = (e - nn * PER) * 8;
    __nv_bfloat16 kr[8], vr[8];
    if (nn < a.n) {
      const size_t off = kv_offset<kKvScratch>(a, w, nn) + h * a.hd + d0;
      if (a.vec) {
        const uint4 ku = *reinterpret_cast<const uint4*>(kg + off);
        const uint4 vu = *reinterpret_cast<const uint4*>(vg + off);
        memcpy(kr, &ku, 16);
        memcpy(vr, &vu, 16);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool in = d0 + i < a.hd;
          kr[i] = in ? kg[off + i] : __float2bfloat16_rn(0.f);
          vr[i] = in ? vg[off + i] : __float2bfloat16_rn(0.f);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kr[i] = vr[i] = __float2bfloat16_rn(0.f);
    }
    uint4 ku;
    memcpy(&ku, kr, 16);
    *reinterpret_cast<uint4*>(ks + nn * KST + d0) = ku;
#pragma unroll
    for (int i = 0; i < 8; ++i) vt[(d0 + i) * vst + nn] = vr[i];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &t, 4);
  return u;
}

// The bf16 at p, p + 1 of head columns col, col + 1 (p 4-byte aligned when
// vec, which implies hd even), zero past the head's hd columns.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool vec, int col, int hd) {
  if (col >= hd) return 0u;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  const __nv_bfloat16 t[2] = {p[0], col + 1 < hd ? p[1] : __float2bfloat16_rn(0.f)};
  uint32_t u;
  memcpy(&u, t, 4);
  return u;
}

// out[col], out[col + 1] = (lo, hi) in T, as one 4-byte store (bf16) when
// vec, each column below hd alone otherwise.
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int col, int hd, bool vec, float lo, float hi) {
  if (col >= hd) return;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec) {
      *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(lo, hi);
      return;
    }
  }
  out[col] = store_cast<T>(lo);
  if (col + 1 < hd) out[col + 1] = store_cast<T>(hi);
}

// The 16-row tile's scores against keys n0 .. n0 + 7: s[e] for the lane's
// row e / 2 (lane / 4, then 8 below it; its bias row brow[e / 2], null past
// M) and key n0 + 2 (lane % 4) + e % 2, q k^T scale + bias, -inf past N.
template <int HD>
__device__ __forceinline__ void mma_scores(float (&s)[4], const uint32_t (&qa)[HD / 16][4],
                                           const __nv_bfloat16* ks, int n0,
                                           const float* const (&brow)[2], int n, float scale,
                                           int lane) {
  constexpr int KST = mma_k_stride(HD);
  const int g = lane >> 2, t4 = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* kr = ks + (n0 + g) * KST + 16 * kk + 2 * t4;
    const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                           *reinterpret_cast<const uint32_t*>(kr + 8)};
    mma_bf16(c, qa[kk], b);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = n0 + 2 * t4 + (e & 1);
    const float* br = brow[e >> 1];
    const float bias = (col < n && br != nullptr) ? __ldg(br + col) : 0.f;
    s[e] = col < n ? fmaf(c[e], scale, bias) : __int_as_float(0xff800000);
  }
}

// Query rows r0 .. r0 + 15 (those below M) of window w, head h.
template <int HD>
__device__ __forceinline__ void attend_tile_mma(const AttnArgs& a, int w, int h, int r0,
                                                const __nv_bfloat16* ks,
                                                const __nv_bfloat16* vt, float scale, int lane) {
  const int g = lane >> 2, t4 = lane & 3, n = a.n, vst = mma_v_stride(a.n);
  const int rows[2] = {r0 + g, r0 + g + 8};
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const float* bias_h = a.bias + (size_t)h * a.m * n;
  const float* const brow[2] = {rows[0] < a.m ? bias_h + (size_t)rows[0] * n : nullptr,
                                rows[1] < a.m ? bias_h + (size_t)rows[1] * n : nullptr};
  // q's A fragments: registers (row g, cols 2 t4 ..), (row g + 8, ..),
  // (row g, cols 2 t4 + 8 ..), (row g + 8, ..) of each 16 columns
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1], col = 16 * kk + 2 * t4 + 8 * (r >> 1);
      qa[kk][r] = row < a.m
                      ? load_pair(q + ((size_t)w * a.m + row) * a.c + h * a.hd + col, a.vec, col, a.hd)
                      : 0u;
    }
  }

  // sweep 1: each row's running max and sum of exp over the lane's keys,
  // then over the row's four lanes
  float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < n; n0 += 8) {
    float s[4];
    mma_scores<HD>(s, qa, ks, n0, brow, n, scale, lane);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float nm = fmaxf(mx[hr], fmaxf(s[2 * hr], s[2 * hr + 1]));
      const float nml = nm * kLog2e;
      sum[hr] = sum[hr] * fast_exp2(fmaf(mx[hr], kLog2e, -nml)) +
                fast_exp2(fmaf(s[2 * hr], kLog2e, -nml)) +
                fast_exp2(fmaf(s[2 * hr + 1], kLog2e, -nml));
      mx[hr] = nm;
    }
  }
  float mxl[2], inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[hr], o);
      const float os = __shfl_xor_sync(0xffffffffu, sum[hr], o);
      const float nm = fmaxf(mx[hr], om), nml = nm * kLog2e;
      sum[hr] = sum[hr] * fast_exp2(fmaf(mx[hr], kLog2e, -nml)) +
                os * fast_exp2(fmaf(om, kLog2e, -nml));
      mx[hr] = nm;
    }
    mxl[hr] = mx[hr] * kLog2e;
    inv[hr] = 1.f / sum[hr];
  }

  // sweep 2: p = round(exp(s - max) / sum), 16 keys at a time, and p v
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int n0 = 0; n0 < n; n0 += 16) {
    float s0[4], s1[4];
    mma_scores<HD>(s0, qa, ks, n0, brow, n, scale, lane);
    mma_scores<HD>(s1, qa, ks, n0 + 8, brow, n, scale, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s0[e] = fast_exp2(fmaf(s0[e], kLog2e, -mxl[e >> 1])) * inv[e >> 1];
      s1[e] = fast_exp2(fmaf(s1[e], kLog2e, -mxl[e >> 1])) * inv[e >> 1];
    }
    const uint32_t pa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                            pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const __nv_bfloat16* vr = vt + (8 * dt + g) * vst + n0 + 2 * t4;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(vr),
                             *reinterpret_cast<const uint32_t*>(vr + 8)};
      mma_bf16(o[dt], pa, b);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= a.m) continue;
    __nv_bfloat16* out =
        static_cast<__nv_bfloat16*>(a.out) + ((size_t)w * a.m + rows[hr]) * a.c + h * a.hd;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      store_pair(out, 8 * dt + 2 * t4, a.hd, a.vec, o[dt][2 * hr], o[dt][2 * hr + 1]);
  }
}

template <int HD, bool kKvScratch>
__global__ void __launch_bounds__(kAttnThreads, 2) attn_kernel_mma(AttnArgs a, float scale) {
  extern __shared__ __align__(16) unsigned char attn_smem_raw[];
  const int w = blockIdx.x, h = blockIdx.y;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(attn_smem_raw);
  __nv_bfloat16* vt = ks + mma_keys(a.n) * mma_k_stride(HD);
  stage_window_mma<HD, kKvScratch>(ks, vt, a, w, h);
  __syncthreads();

  // the window's 16-row tiles, a warp per tile, dealt as attn_kernel deals rows
  const int tiles16 = cdiv(a.m, 16);
  for (int t = blockIdx.z * (kAttnThreads / 32) + (threadIdx.x >> 5); t < tiles16;
       t += a.tiles * (kAttnThreads / 32))
    attend_tile_mma<HD>(a, w, h, 16 * t, ks, vt, scale, threadIdx.x & 31);
}

template <int HD, bool kKvScratch>
cudaError_t attn_mma_run(const AttnArgs& a, float scale, long long* info, cudaStream_t stream) {
  auto kernel = attn_kernel_mma<HD, kKvScratch>;
  const size_t smem = attn_mma_smem_bytes(a.n, HD);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info == nullptr) {
    kernel<<<dim3(a.b, a.heads, a.tiles), kAttnThreads, smem, stream>>>(a, scale);
    return cudaGetLastError();
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kAttnThreads, smem);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (long long)attr.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = kAttnThreads;
  info[4] = blocks;
  info[5] = 0;  // no row share: the tensor cores hold the scores
  info[6] = 0;  // no key tile
  return cudaSuccess;
}

// Shared memory of a block that stages a window of n keys.
size_t attn_smem_bytes(int n, int hd) { return sizeof(float) * 2 * (size_t)n * key_stride(hd); }

// Launches the instantiation for (T, HD, J) with a's plan when info is
// null; otherwise writes its occupancy at a's plan to info: registers,
// local (spill) bytes per thread, dynamic shared memory per block, threads
// per block, resident blocks per SM.
template <typename T, int HD, int J, bool kKvScratch>
cudaError_t attn_run(const AttnArgs& a, float scale, long long* info, cudaStream_t stream) {
  auto kernel = attn_kernel<T, HD, J, kKvScratch>;
  const size_t smem = attn_smem_bytes(a.n, HD);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info == nullptr) {
    kernel<<<dim3(a.b, a.heads, a.tiles), kAttnThreads, smem, stream>>>(a, scale);
    return cudaGetLastError();
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kAttnThreads, smem);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (long long)attr.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = kAttnThreads;
  info[4] = blocks;
  info[5] = J;
  info[6] = 0;  // no key tile
  return cudaSuccess;
}


// ---------------------------------------------------------------------------
// Key-tiled variant (attn_flash_kernel), for windows whose k and v rows do
// not fit in one block's shared memory (the JAX kernel stages them whole in
// VMEM, which caps it only at 96 MB) and for every head_dim from 33 to 256.
// One sweep over the keys with an online softmax: a warp takes 16 query
// rows, laid out as an mma.sync m16n8 accumulator (a lane holds rows lane /
// 4 and lane / 4 + 8, columns 2 (lane % 4) and the next of each 8), and
// keeps each row's running max, its lane's share of the running sum of exp,
// and its (16, HD) output sums in registers. A tile's scores raise the max;
// the sums and outputs are rescaled by exp(old max - new max), p = exp(s -
// max) is added into the outputs, and the division by the row's sum comes
// once, at the end. The block's four warps (64 rows) share each tile of KT
// keys, which cp.async double-buffers in shared memory in the operand type,
// so the next tile loads while this one computes; in f32 the tile's (64,
// KT) bias columns come with it, so that no score waits on a load from L2.
// In bf16, where a tile costs a few mma, the 4-byte copies cost more than
// the loads they hide, and each score reads its bias element from L2 where
// it is added (one load of the lane's pair before the pair's scores took 40
// % more time on the H100: PERF.md, section 6).
//   bf16: q k^T and p v on the tensor cores (m16n8k16, f32 accumulators):
//         q's A fragments stay in registers, k rows are the B operand as
//         they are, v rows reach p v's B operand through ldmatrix.trans;
//         p is rounded to bf16 before its division by the sum (the twin
//         rounds p after it: within the bf16 gate, PERF.md section 6).
//   f32:  the same fragments by FMA (no TF32, so f32 stays exact): a lane's
//         four scores of each 8 keys from float4 rows of q (staged once) and
//         k, and its outputs from p gathered over the four lanes of its row
//         by shuffles and float2 rows of v.
// head_dim is padded to the instantiated HD (f32 >= 8, bf16 >= 16) with
// zeros in the staged rows. The wrapper's plan picks this kernel
// (attn_key_tiled in ops/window_attn_cuda.py); its tile is flash_key_tile's,
// which the occupancy query reports. Above head_dim 256 the wide forward
// below runs instead.
// ---------------------------------------------------------------------------

constexpr int kFlashWarps = 4;  // 16-row tiles a block, sharing each key tile
constexpr int kFlashThreads = 32 * kFlashWarps;

// Keys of one staged tile: the (16, KT) scores of a warp stay in registers
// beside its (16, HD) outputs.
__host__ __device__ constexpr int flash_key_tile(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 32 : 16; }
// The HD a head_dim's key-tiled kernel runs at: 8-column groups in f32, the
// 16-deep mma in bf16.
template <typename T>
constexpr int flash_hd(int hd) {
  return hd > (std::is_same<T, __nv_bfloat16>::value ? 16 : 8) ? hd
                                                               : (std::is_same<T, __nv_bfloat16>::value ? 16 : 8);
}
// Row stride (elements) of a staged k or v row: 16-byte rows whose stride
// is an odd number of 16-byte chunks (f32: key_stride; bf16: mma_k_stride).
template <typename T>
__host__ __device__ constexpr int flash_stride(int hd) {
  return std::is_same<T, __nv_bfloat16>::value ? mma_k_stride(hd) : key_stride(hd);
}

// Row stride (floats) of a staged bias tile: float2 reads of 8 rows at one
// column fall in distinct bank pairs but for one 2-way conflict.
__host__ __device__ constexpr int flash_bias_stride(int hd) { return flash_key_tile(hd) + 4; }

// Two stages of k and v tiles in T; for f32 two stages of the (64, KT) bias
// tile and the block's 64 q rows.
template <typename T>
constexpr size_t flash_smem_bytes(int hd) {
  const size_t kv = sizeof(T) * 2 * (size_t)flash_key_tile(hd) * 2 * flash_stride<T>(hd);
  if (std::is_same<T, __nv_bfloat16>::value) return kv;
  return kv + sizeof(float) * 16 * kFlashWarps * (2 * flash_bias_stride(hd) + key_stride(hd));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes)
               : "memory");
}

// The bias of the block's 64 rows from row r0 against keys t0 .. t0 + KT -
// 1 into bd ((64, KBS) f32) by 4-byte cp.async, zero past M and N.
template <int HD>
__device__ __forceinline__ void flash_stage_bias(float* bd, const float* bias_h, const AttnArgs& a,
                                                 int r0, int t0) {
  constexpr int KT = flash_key_tile(HD), KBS = flash_bias_stride(HD);
  for (int e = threadIdx.x; e < 16 * kFlashWarps * KT; e += kFlashThreads) {
    const int r = e / KT, key = e - r * KT;
    const bool in = r0 + r < a.m && t0 + key < a.n;
    cp_async4(bd + r * KBS + key, in ? bias_h + (size_t)(r0 + r) * a.n + t0 + key : bias_h, in ? 4 : 0);
  }
}

// CH = 16 bytes of T from src to dst: a 16-byte cp.async when vec, plain
// loads otherwise; zero past N (key) and past hd (column d0 + i).
template <typename T>
__device__ __forceinline__ void flash_copy16(T* dst, const T* src, const AttnArgs& a, int key, int d0) {
  constexpr int CH = 16 / (int)sizeof(T);
  if (a.vec) {
    const bool in = key < a.n && d0 < a.hd;
    cp_async16(dst, src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool in = key < a.n && d0 + i < a.hd;
      dst[i] = in ? src[i] : store_cast<T>(0.f);
    }
  }
}

// Keys t0 .. t0 + KT - 1 of window w's k and v columns of head h into kd
// and vd ((KT, KST) each): 16-byte cp.async when vec (rows aligned and hd a
// multiple of 16 bytes), plain loads otherwise; zero past N and past hd.
template <typename T, int HD, bool kKvScratch>
__device__ __forceinline__ void flash_stage(T* kd, T* vd, const AttnArgs& a, int w, int h, int t0) {
  constexpr int KT = flash_key_tile(HD), KST = flash_stride<T>(HD);
  constexpr int CH = 16 / (int)sizeof(T), PER = HD / CH;
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = kKvScratch ? kg + a.c : static_cast<const T*>(a.v);
  for (int e = threadIdx.x; e < KT * PER; e += kFlashThreads) {
    const int nn = e / PER, d0 = (e - nn * PER) * CH, key = t0 + nn;
    const size_t off = key < a.n ? kv_offset<kKvScratch>(a, w, key) + h * a.hd + d0 : 0;
    flash_copy16(kd + nn * KST + d0, kg + off, a, key, d0);
    flash_copy16(vd + nn * KST + d0, vg + off, a, key, d0);
  }
}

// bf16: s[j] = q k^T of the warp's 16 rows against the tile's keys 8 j ..
// 8 j + 7, from q's A fragments and the staged k rows.
template <int HD, int KT>
__device__ __forceinline__ void flash_scores(float (&s)[KT / 8][4], const uint32_t (&qa)[HD / 16][4],
                                             const __nv_bfloat16* ks, int lane) {
  constexpr int KST = mma_k_stride(HD);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* kr = ks + (8 * j + g) * KST + 16 * kk + 2 * t4;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                             *reinterpret_cast<const uint32_t*>(kr + 8)};
      mma_bf16(s[j], qa[kk], b);
    }
  }
}

// The f32 q rows a lane scores with: up to head_dim 16 in registers
// (loaded once a row group), above it read from the staged rows each time.
template <int HD>
struct FlashQ {
  static constexpr bool kRegs = HD <= 16;
  float4 r[kRegs ? 2 : 1][kRegs ? HD / 4 : 1];
  const float* q0;
  const float* q1;

  __device__ __forceinline__ void init(const float* row0, const float* row1) {
    q0 = row0;
    q1 = row1;
    if constexpr (kRegs) {
#pragma unroll
      for (int d = 0; d < HD / 4; ++d) {
        r[0][d] = *reinterpret_cast<const float4*>(row0 + 4 * d);
        r[1][d] = *reinterpret_cast<const float4*>(row1 + 4 * d);
      }
    }
  }
  __device__ __forceinline__ float4 get(int row, int d) const {
    if constexpr (kRegs) return r[row][d / 4];
    return *reinterpret_cast<const float4*>((row ? q1 : q0) + d);
  }
};

// f32: the same scores by FMA from the warp's q rows (row lane / 4 and 8
// below it) and the staged k rows.
template <int HD, int KT>
__device__ __forceinline__ void flash_scores(float (&s)[KT / 8][4], const FlashQ<HD>& q,
                                             const float* ks, int lane) {
  constexpr int KS = key_stride(HD);
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const float* k0 = ks + (8 * j + 2 * t4) * KS;
    const float* k1 = k0 + KS;
    float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      const float4 x = q.get(0, d);
      const float4 y = q.get(1, d);
      const float4 u = *reinterpret_cast<const float4*>(k0 + d);
      const float4 v = *reinterpret_cast<const float4*>(k1 + d);
      c00 = fmaf(x.x, u.x, fmaf(x.y, u.y, fmaf(x.z, u.z, fmaf(x.w, u.w, c00))));
      c01 = fmaf(x.x, v.x, fmaf(x.y, v.y, fmaf(x.z, v.z, fmaf(x.w, v.w, c01))));
      c10 = fmaf(y.x, u.x, fmaf(y.y, u.y, fmaf(y.z, u.z, fmaf(y.w, u.w, c10))));
      c11 = fmaf(y.x, v.x, fmaf(y.y, v.y, fmaf(y.z, v.z, fmaf(y.w, v.w, c11))));
    }
    s[j][0] = c00;
    s[j][1] = c01;
    s[j][2] = c10;
    s[j][3] = c11;
  }
}

// bf16: o += round(p) v over the tile's keys, 16 at a time: p's A
// fragments are the score fragments of two 8-key groups as they are.
template <int HD, int KT>
__device__ __forceinline__ void flash_pv(float (&o)[HD / 8][4], const float (&p)[KT / 8][4],
                                         const __nv_bfloat16* vs, int lane) {
  constexpr int KST = mma_k_stride(HD);
  // ldmatrix.trans: lanes 8 i .. 8 i + 7 address the rows of matrix i =
  // (keys 0-7 | 8-15) x (columns 0-7 | 8-15) of a 16 x 16 block
  const int key = lane & 15, col = (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KT / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]), pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                            pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dt = 0; dt < HD / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (16 * kc + key) * KST + 8 * dt + col);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(o[dt], pa, b0);
      mma_bf16(o[dt + 1], pa, b1);
    }
  }
}

// f32: o += p v by FMA, p of the lane's two rows gathered over the row's
// four lanes, 8 keys at a time.
template <int HD, int KT>
__device__ __forceinline__ void flash_pv(float (&o)[HD / 8][4], const float (&p)[KT / 8][4],
                                         const float* vs, int lane) {
  constexpr int KS = key_stride(HD);
  const int t4 = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      // keys 8 j + 2 src (p0: row lane / 4, p2: 8 below) and the next (p1, p3)
      const float p0 = __shfl_sync(0xffffffffu, p[j][0], quad | src);
      const float p1 = __shfl_sync(0xffffffffu, p[j][1], quad | src);
      const float p2 = __shfl_sync(0xffffffffu, p[j][2], quad | src);
      const float p3 = __shfl_sync(0xffffffffu, p[j][3], quad | src);
      const float* v0 = vs + (8 * j + 2 * src) * KS + 2 * t4;
      const float* v1 = v0 + KS;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const float2 x = *reinterpret_cast<const float2*>(v0 + 8 * dt);
        const float2 y = *reinterpret_cast<const float2*>(v1 + 8 * dt);
        o[dt][0] = fmaf(p1, y.x, fmaf(p0, x.x, o[dt][0]));
        o[dt][1] = fmaf(p1, y.y, fmaf(p0, x.y, o[dt][1]));
        o[dt][2] = fmaf(p3, y.x, fmaf(p2, x.x, o[dt][2]));
        o[dt][3] = fmaf(p3, y.y, fmaf(p2, x.y, o[dt][3]));
      }
    }
  }
}

// One key tile's online-softmax step for a lane's two rows: s (q k^T) ->
// scale and bias, -inf past N; the tile's max of each row over its four
// lanes raises the running max mx; the sums and outputs o are rescaled by
// exp(old max - new max), and s becomes p = exp(s - max). The bias comes
// from the staged f32 tile bs (row lane / 4, 8 below it at 8 KBS) or, in
// bf16, from L2 (brow: the rows' bias rows, null past M).
template <typename T, int KT, int KBS, int HD>
__device__ __forceinline__ void flash_softmax_tile(float (&s)[KT / 8][4], float (&mx)[2], float (&sum)[2],
                                                   float (&o)[HD / 8][4], const float* bs,
                                                   const float* const (&brow)[2], int t0, int n,
                                                   float scale, int t4) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float tm = mx[hr];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float2 bf = make_float2(0.f, 0.f);
      if constexpr (!kBf16) bf = *reinterpret_cast<const float2*>(bs + 8 * hr * KBS + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t0 + 8 * j + 2 * t4 + e;
        const float b = !kBf16 ? (e ? bf.y : bf.x)
                               : (key < n && brow[hr] != nullptr) ? __ldg(brow[hr] + key) : 0.f;
        float& v = s[j][2 * hr + e];
        v = key < n ? fmaf(v, scale, b) : __int_as_float(0xff800000);
        tm = fmaxf(tm, v);
      }
    }
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    const float ml = tm * kLog2e;
    const float alpha = fast_exp2(fmaf(mx[hr], kLog2e, -ml));
    mx[hr] = tm;
    float ts = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[j][2 * hr + e];
        v = fast_exp2(fmaf(v, kLog2e, -ml));
        ts += v;
      }
    }
    sum[hr] = fmaf(sum[hr], alpha, ts);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][2 * hr] *= alpha;
      o[dt][2 * hr + 1] *= alpha;
    }
  }
}

// The lane's two rows' outputs o / (their sums over the row's four lanes)
// into out (row r of window w at rows[r]; nothing past M).
template <typename T, int HD>
__device__ __forceinline__ void flash_store(const AttnArgs& a, const float (&o)[HD / 8][4], const float (&sum)[2],
                                            const int (&rows)[2], int w, int h, int t4) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = sum[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (rows[hr] >= a.m) continue;
    const float inv = 1.f / l;
    T* out = static_cast<T*>(a.out) + ((size_t)w * a.m + rows[hr]) * a.c + h * a.hd;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      store_pair(out, 8 * dt + 2 * t4, a.hd, a.vec, o[dt][2 * hr] * inv, o[dt][2 * hr + 1] * inv);
  }
}

template <typename T, int HD, bool kKvScratch>
__global__ void __launch_bounds__(kFlashThreads) attn_flash_kernel(AttnArgs a, float scale) {
  constexpr int KT = flash_key_tile(HD), KST = flash_stride<T>(HD), KS = key_stride(HD);
  constexpr int KBS = flash_bias_stride(HD), BT = 16 * kFlashWarps * KBS;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  T* kbuf = reinterpret_cast<T*>(flash_smem);  // 2 stages of (KT, KST)
  T* vbuf = kbuf + 2 * KT * KST;               // 2 stages of (KT, KST)
  float* bbuf = reinterpret_cast<float*>(vbuf + 2 * KT * KST);  // f32: 2 stages of (64, KBS) bias
  float* qs = bbuf + 2 * BT;                                     // f32: the block's (64, KS) q rows
  const int w = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles16 = cdiv(a.m, 16), ntiles = cdiv(a.n, KT);
  const float* bias_h = a.bias + (size_t)h * a.m * a.n;
  // block z takes the window's 64-row groups z, z + tiles, ...; a warp past
  // M computes on zero rows and writes nothing, so every warp joins the syncs
  for (int rg = blockIdx.z; rg * kFlashWarps < tiles16; rg += a.tiles) {
    const int r0 = 16 * (rg * kFlashWarps + warp), rb = 16 * rg * kFlashWarps;
    const int rows[2] = {r0 + g, r0 + g + 8};
    const float* const brow[2] = {rows[0] < a.m ? bias_h + (size_t)rows[0] * a.n : nullptr,
                                  rows[1] < a.m ? bias_h + (size_t)rows[1] * a.n : nullptr};
    uint32_t qa[kBf16 ? HD / 16 : 1][4];
    if constexpr (kBf16) {
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = rows[r & 1], col = 16 * kk + 2 * t4 + 8 * (r >> 1);
          qa[kk][r] = row < a.m ? load_pair(q + ((size_t)w * a.m + row) * a.c + h * a.hd + col,
                                            a.vec, col, a.hd)
                                : 0u;
        }
      }
    } else {
      const float* q = static_cast<const float*>(a.q);
      for (int e = threadIdx.x; e < 16 * kFlashWarps * HD; e += kFlashThreads) {
        const int r = e / HD, d = e - r * HD, row = 16 * rg * kFlashWarps + r;
        qs[r * KS + d] = row < a.m && d < a.hd ? q[((size_t)w * a.m + row) * a.c + h * a.hd + d] : 0.f;
      }
    }
    float mx[2] = {-1e30f, -1e30f}, sum[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    FlashQ<HD> fq;

    flash_stage<T, HD, kKvScratch>(kbuf, vbuf, a, w, h, 0);
    if constexpr (!kBf16) flash_stage_bias<HD>(bbuf, bias_h, a, rb, 0);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, t0 = it * KT;
      if (it + 1 < ntiles) {
        flash_stage<T, HD, kKvScratch>(kbuf + (buf ^ 1) * KT * KST, vbuf + (buf ^ 1) * KT * KST, a, w,
                                       h, t0 + KT);
        if constexpr (!kBf16) flash_stage_bias<HD>(bbuf + (buf ^ 1) * BT, bias_h, a, rb, t0 + KT);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies have landed
      __syncthreads();
      const T* ks = kbuf + buf * KT * KST;
      const T* vs = vbuf + buf * KT * KST;
      const float* bs = bbuf + buf * BT + (16 * warp + g) * KBS + 2 * t4;  // row lane / 4
      float s[KT / 8][4];
      if constexpr (kBf16) {
        flash_scores<HD, KT>(s, qa, ks, lane);
      } else {
        if (it == 0) fq.init(qs + (16 * warp + g) * KS, qs + (16 * warp + g + 8) * KS);
        flash_scores<HD, KT>(s, fq, ks, lane);
      }
      flash_softmax_tile<T, KT, KBS, HD>(s, mx, sum, o, bs, brow, t0, a.n, scale, t4);
      flash_pv<HD, KT>(o, s, vs, lane);
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    flash_store<T, HD>(a, o, sum, rows, w, h, t4);
  }
}

// Registers, local (spill) bytes per thread, dynamic shared memory, threads
// and resident blocks per SM of `kernel` at smem bytes, into info[0..4].
template <class K>
cudaError_t block_occupancy(K kernel, int threads, size_t smem, long long* info) {
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

template <typename T, int HD, bool kKvScratch>
cudaError_t attn_flash_run(const AttnArgs& a, float scale, long long* info, cudaStream_t stream) {
  auto kernel = attn_flash_kernel<T, HD, kKvScratch>;
  constexpr size_t smem = flash_smem_bytes<T>(HD);
  static_assert(smem <= kMaxSmem, "a key-tiled block must fit in one SM's shared memory");
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (info == nullptr) {
    kernel<<<dim3(a.b, a.heads, a.tiles), kFlashThreads, smem, stream>>>(a, scale);
    return cudaGetLastError();
  }
  err = block_occupancy(kernel, kFlashThreads, smem, info);
  info[5] = 0;  // a warp's scores are 16-row fragments
  info[6] = flash_key_tile(HD);
  return err;
}

// ---------------------------------------------------------------------------
// Above head_dim 256 (the wide forward): two launches of 128-thread blocks
// that split each (window, head) over key tiles, row tiles and 64-column
// chunks of head_dim, as the wide backward does (attn_core_bwd.cu), so that
// any head_dim runs as itself (zero columns past it within its last chunk,
// no padding to a power of two) and the grid fills the card (B_ 20 with one
// head at M 49, N 343: 220 score blocks, and 200 or more output blocks from
// head_dim 257 on). q k^T is computed once per (window, head, row, key),
// whatever the head_dim: no launch repeats it for its output columns.
//   1. attn_wide_scores_kernel, block (key tile of 32, row tile of 64,
//      window x head): s = q k^T summed over the head_dim chunks, each
//      chunk's q and k rows in flight by cp.async (two stages) while the
//      previous chunk multiplies; then s scale + bias to an f32 (B_ H, M,
//      np) plane in device memory, and for each row the tile's max and sum
//      of exp (a warp per row, a lane per key).
//   2. attn_wide_out_kernel, block (row tile of 32, head_dim chunk of 64,
//      window x head): its rows' tile statistics merged in tile order, then
//      for each key tile of 64 (s rows and v rows in flight by cp.async,
//      two stages) p = exp(s - max) / sum, rounded to the operand type
//      after the division as the twin rounds, and out += round(p) v; its
//      (32, 64) block of out written once.
// What bounds it on the H100: 4 B_ H M N hd operations against the q, k, v
// and out rows and the bias (at head_dim 384-2048 operations in f32, bytes
// in bf16); the f32 s plane and the statistics (B_ H M (np + 2 tiles)
// floats, 1.5 MB at B_ 20, M 49, N 343) are written once and read hd / 64
// times from L2. Products: f32 by FMA with no TF32, each thread a 4 x 4
// register tile from float4 rows in shared memory; bf16 on the tensor cores
// (mma.sync m16n8k16 from ldmatrix fragments, f32 accumulators). Every
// output element and every statistic has one owner and sums in a fixed
// order, so two runs are bit-identical, with no float atomics. The planes
// live in scratch that the wrapper allocates (attn_forward_scratch_floats in
// ops/window_attn_cuda.py mirrors WideFwdPlanes::floats).
// ---------------------------------------------------------------------------

// The wide forward takes every head_dim above this; the key-tiled kernel
// stays below it, where it was faster in bf16 (PERF.md, section 6).
constexpr int kWideFwdMinHd = 256;
constexpr int kWideFwdKeys = 32;    // keys of a scores tile (a lane per key in its epilogue)
constexpr int kWideFwdRows = 64;    // rows of a scores tile
constexpr int kWideOutRows = 32;    // rows of an output block
constexpr int kWideOutKeys = 64;    // keys an output block takes at a time
constexpr int kWideOutLs = kWideOutKeys + 4;  // row stride (floats) of a staged s tile

// The wide forward's scratch (f32, 16-byte aligned): the s plane (B_ H, M,
// np), rows padded to np = tiles x 32 keys (-inf past N) so that whole
// 16-byte chunks copy; the key tiles' row max (times log2 e) and sum of exp
// (B_ H, tiles, M) each.
struct WideFwdPlanes {
  float *s, *tmx, *tsum;
  int tiles, np;
  __host__ __device__ WideFwdPlanes(const AttnArgs& a) {
    tiles = cdiv(a.n, kWideFwdKeys);
    np = tiles * kWideFwdKeys;
    const size_t rows = (size_t)a.b * a.heads * a.m;
    s = a.scratch;
    tmx = s + rows * np;
    tsum = tmx + rows * tiles;
  }
  static size_t floats(int b, int m, int n, int heads) {
    const int t = cdiv(n, kWideFwdKeys);
    return (size_t)b * heads * m * ((size_t)t * kWideFwdKeys + 2 * (size_t)t);
  }
};

// Shared memory (bytes): two stages of the scores tile's q chunk (64 rows)
// and k chunk (32 keys), its f32 (64, 33) s tile over them after the
// products; two stages of the output block's f32 s tile (32, 68) and v
// chunk (64 keys), its round(p) tile and its rows' statistics.
template <typename T>
constexpr size_t wide_fwd_scores_smem() {
  return sizeof(T) * 2 * (size_t)(kWideFwdRows + kWideFwdKeys) * wide_ld<T>(kWideCols);
}
template <typename T>
__host__ __device__ constexpr size_t wide_fwd_out_stage() {
  return sizeof(float) * (size_t)kWideOutRows * kWideOutLs +
         sizeof(T) * (size_t)kWideOutKeys * wide_ld<T>(kWideCols);
}
template <typename T>
constexpr size_t wide_fwd_out_smem() {
  return 2 * wide_fwd_out_stage<T>() + sizeof(T) * (size_t)kWideOutRows * wide_ld<T>(kWideOutKeys) +
         sizeof(float) * 2 * kWideOutRows;
}
static_assert(wide_fwd_scores_smem<__nv_bfloat16>() >= sizeof(float) * kWideFwdRows * (kWideFwdKeys + 1),
              "the s tile fits over the staged chunks");
static_assert(wide_fwd_out_stage<__nv_bfloat16>() % 16 == 0 && wide_fwd_out_stage<float>() % 16 == 0,
              "stages start on 16-byte boundaries");

// Keys n0 .. n0 + nrows - 1 of window w's columns d0 .. d0 + COLS - 1 of
// head h from src (k, or v: the k|v scratch's v half or the separate v)
// into dst (row stride ldd), zero past N and past hd: 16-byte cp.async when
// a.vec, which the caller commits and waits for; else plain loads.
template <typename T, bool kKvScratch, int COLS>
__device__ __forceinline__ void wide_stage_keys(T* dst, int ldd, const AttnArgs& a, const T* src, int w,
                                                int h, int n0, int nrows, int d0) {
  constexpr int CH = 16 / (int)sizeof(T), PER = COLS / CH;
  const int rows = a.n - n0, cols = a.hd - d0;
  if (a.vec) {
    for (int e = threadIdx.x; e < nrows * PER; e += kWideThreads) {
      const int r = e / PER, col = (e - r * PER) * CH;
      const bool in = r < rows && col < cols;
      const T* p = in ? src + kv_offset<kKvScratch>(a, w, n0 + r) + h * a.hd + d0 + col : src;
      cp_async16(dst + r * ldd + col, p, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * COLS; e += kWideThreads) {
      const int r = e / COLS, col = e - r * COLS;
      dst[r * ldd + col] = r < rows && col < cols
                               ? src[kv_offset<kKvScratch>(a, w, n0 + r) + h * a.hd + d0 + col]
                               : store_cast<T>(0.f);
    }
  }
}

template <typename T, bool kKvScratch>
__global__ void __launch_bounds__(kWideThreads) attn_wide_scores_kernel(AttnArgs a, float scale) {
  constexpr int LD = wide_ld<T>(kWideCols), SP = kWideFwdKeys + 1;
  constexpr int STAGE = (kWideFwdRows + kWideFwdKeys) * LD;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* smem = reinterpret_cast<T*>(wide_smem);        // two stages of (64, LD) q, then (32, LD) k
  float* sp = reinterpret_cast<float*>(wide_smem);  // after the products: (64, SP) q k^T
  const int kt = blockIdx.x, r0 = blockIdx.y * kWideFwdRows, bh = blockIdx.z;
  const int m = a.m, n = a.n, hd = a.hd, n0 = kt * kWideFwdKeys;
  const int w = bh / a.heads, h = bh - w * a.heads;
  const T* q = static_cast<const T*>(a.q) + ((size_t)w * m + r0) * a.c + h * hd;
  const T* kg = static_cast<const T*>(a.k);
  auto stage = [&](T* st, int d0) {
    wide_stage<T, kWideCols>(st, LD, q + d0, a.c, kWideFwdRows, m - r0, hd - d0, a.vec);
    wide_stage_keys<T, kKvScratch, kWideCols>(st + kWideFwdRows * LD, LD, a, kg, w, h, n0,
                                              kWideFwdKeys, d0);
  };
  float s[4][4] = {};
  stage(smem, 0);
  cp_async_commit();
  for (int d0 = 0, it = 0; d0 < hd; d0 += kWideCols, ++it) {
    const T* cur = smem + (it & 1) * STAGE;
    if (d0 + kWideCols < hd) stage(smem + ((it + 1) & 1) * STAGE, d0 + kWideCols);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    wide_nt<kWideCols>(s, cur, cur + kWideFwdRows * LD, LD);
    __syncthreads();  // every warp is done with this stage before it is refilled (or overlaid)
  }
  wide_nt_each<T>(s, [&](int r, int col, float x) { sp[r * SP + col] = x; });
  __syncthreads();
  // a warp per row, a lane per key: scale and bias, the plane out (-inf
  // past N), and the tile's max and sum of exp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, key = n0 + lane;
  const WideFwdPlanes pl(a);
  const float* bias_h = a.bias + (size_t)h * m * n;
  for (int r = warp; r < kWideFwdRows && r0 + r < m; r += kWideThreads / 32) {
    const int row = r0 + r;
    const bool in = key < n;
    const float sv = in ? fmaf(sp[r * SP + lane], scale, __ldg(bias_h + (size_t)row * n + key))
                        : __int_as_float(0xff800000);  // -inf
    pl.s[((size_t)bh * m + row) * pl.np + key] = sv;
    const float mxl = warp_max(sv) * kLog2e;
    const float e = in ? fast_exp2(fmaf(sv, kLog2e, -mxl)) : 0.f;
    const float sum = warp_sum(e);
    if (lane == 0) {
      const size_t o = ((size_t)bh * pl.tiles + kt) * m + row;
      pl.tmx[o] = mxl;
      pl.tsum[o] = sum;
    }
  }
}

template <typename T, bool kKvScratch>
__global__ void __launch_bounds__(kWideThreads) attn_wide_out_kernel(AttnArgs a) {
  constexpr int LS = kWideOutLs, LD = wide_ld<T>(kWideCols), LA = wide_ld<T>(kWideOutKeys);
  constexpr size_t STAGE = wide_fwd_out_stage<T>();
  extern __shared__ __align__(16) unsigned char wide_smem[];
  // two stages of: (32, LS) f32 s rows against one key tile, then (64, LD)
  // the tile's v rows, the block's chunk; then (32, LA) round(p) and the
  // rows' merged max (times log2 e) and sum of exp
  T* ps = reinterpret_cast<T*>(wide_smem + 2 * STAGE);
  float* rmx = reinterpret_cast<float*>(ps + kWideOutRows * LA);
  float* rsum = rmx + kWideOutRows;
  const int r0 = blockIdx.x * kWideOutRows, d0 = blockIdx.y * kWideCols, bh = blockIdx.z;
  const int m = a.m, n = a.n, hd = a.hd;
  const int w = bh / a.heads, h = bh - w * a.heads;
  const WideFwdPlanes pl(a);
  const float* srows = pl.s + ((size_t)bh * m + r0) * pl.np;
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = kKvScratch ? kg + a.c : static_cast<const T*>(a.v);
  // the padded s rows copy in whole 16-byte chunks (zeros past np)
  auto stage = [&](unsigned char* st, int n0) {
    wide_stage<float, kWideOutKeys>(reinterpret_cast<float*>(st), LS, srows + n0, pl.np, kWideOutRows,
                                    m - r0, pl.np - n0, true);
    wide_stage_keys<T, kKvScratch, kWideCols>(
        reinterpret_cast<T*>(st + sizeof(float) * kWideOutRows * LS), LD, a, vg, w, h, n0,
        kWideOutKeys, d0);
  };
  stage(wide_smem, 0);
  cp_async_commit();
  if (threadIdx.x < kWideOutRows) {
    // the row's statistics merged over the key tiles in order (rows past M
    // keep 0 and 1: their p is 0 and never written)
    const int row = r0 + threadIdx.x;
    float mx = 0.f, sum = 1.f;
    if (row < m) {
      const size_t o = (size_t)bh * pl.tiles * m + row;
      mx = __int_as_float(0xff800000);  // -inf
      for (int t = 0; t < pl.tiles; ++t) mx = fmaxf(mx, pl.tmx[o + (size_t)t * m]);
      sum = 0.f;
      for (int t = 0; t < pl.tiles; ++t)
        sum = fmaf(pl.tsum[o + (size_t)t * m], fast_exp2(pl.tmx[o + (size_t)t * m] - mx), sum);
    }
    rmx[threadIdx.x] = mx;
    rsum[threadIdx.x] = sum;
  }
  float acc[4][4] = {};
  for (int n0 = 0, it = 0; n0 < n; n0 += kWideOutKeys, ++it) {
    unsigned char* cur = wide_smem + (it & 1) * STAGE;
    if (n0 + kWideOutKeys < n) stage(wide_smem + ((it + 1) & 1) * STAGE, n0 + kWideOutKeys);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const float* ss = reinterpret_cast<const float*>(cur);
    for (int e = threadIdx.x; e < kWideOutRows * kWideOutKeys; e += kWideThreads) {
      const int r = e / kWideOutKeys, key = e - r * kWideOutKeys;
      float p = 0.f;
      if (r0 + r < m && n0 + key < n)
        p = fast_exp2(fmaf(ss[r * LS + key], kLog2e, -rmx[r])) / rsum[r];
      ps[r * LA + key] = store_cast<T>(p);
    }
    __syncthreads();
    wide_nn<kWideOutKeys>(acc, ps, LA, reinterpret_cast<const T*>(cur + sizeof(float) * kWideOutRows * LS),
                          LD);
    __syncthreads();  // every warp is done with this stage and with ps before they are refilled
  }
  T* out = static_cast<T*>(a.out) + ((size_t)w * m + r0) * a.c + h * hd + d0;
  wide_out_each<T, false>(acc, [&](int r, int col, float x) {
    if (r0 + r < m && d0 + col < hd) out[(size_t)r * a.c + col] = store_cast<T>(x);
  });
}

// The wide forward's two launches with a's scratch, or, with info, the
// occupancy of its two kernels: the most registers, spill bytes and shared
// memory, their threads, the fewest resident blocks per SM, J 0 and the
// scores tile's keys.
template <typename T, bool kKvScratch>
cudaError_t attn_wide_run(const AttnArgs& a, float scale, long long* info, cudaStream_t stream) {
  constexpr size_t smem_s = wide_fwd_scores_smem<T>(), smem_o = wide_fwd_out_smem<T>();
  static_assert(smem_s <= kMaxSmem && smem_o <= kMaxSmem, "wide forward blocks fit");
  auto scores = attn_wide_scores_kernel<T, kKvScratch>;
  auto outk = attn_wide_out_kernel<T, kKvScratch>;
  cudaError_t err = cudaFuncSetAttribute(scores, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(outk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_o);
  if (err != cudaSuccess) return err;
  if (info != nullptr) {
    long long other[5];
    err = block_occupancy(scores, kWideThreads, smem_s, info);
    if (err != cudaSuccess) return err;
    err = block_occupancy(outk, kWideThreads, smem_o, other);
    if (err != cudaSuccess) return err;
    for (int f = 0; f < 3; ++f) info[f] = std::max(info[f], other[f]);
    info[4] = std::min(info[4], other[4]);
    info[5] = 0;
    info[6] = kWideFwdKeys;
    return cudaSuccess;
  }
  const int bh = a.b * a.heads;
  if (a.scratch == nullptr || bh > 65535 || cdiv(a.m, kWideFwdRows) > 65535 ||
      cdiv(a.hd, kWideCols) > 65535)
    return cudaErrorInvalidValue;
  scores<<<dim3(cdiv(a.n, kWideFwdKeys), cdiv(a.m, kWideFwdRows), bh), kWideThreads, smem_s, stream>>>(
      a, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  outk<<<dim3(cdiv(a.m, kWideOutRows), cdiv(a.hd, kWideCols), bh), kWideThreads, smem_o, stream>>>(a);
  return cudaGetLastError();
}

// Shared memory of the kernel a launch takes: the wide forward's larger
// block above head_dim 256, else key-tiled or untiled (attn_smem_bytes in
// ops/window_attn_cuda.py for the untiled kernels).
size_t attn_launch_smem_bytes(int is_bf16, int m, int n, int hd, int key_tiled) {
  if (hd > kWideFwdMinHd)
    return is_bf16 ? std::max(wide_fwd_scores_smem<__nv_bfloat16>(), wide_fwd_out_smem<__nv_bfloat16>())
                   : std::max(wide_fwd_scores_smem<float>(), wide_fwd_out_smem<float>());
  const int p = padded_hd(hd);
  if (key_tiled)
    return is_bf16 ? flash_smem_bytes<__nv_bfloat16>(flash_hd<__nv_bfloat16>(p))
                   : flash_smem_bytes<float>(flash_hd<float>(p));
  return is_bf16 && p >= 16 ? attn_mma_smem_bytes(n, p) : attn_smem_bytes(n, p);
}

// Floats of scratch a launch at these shapes needs: the wide forward's
// planes above head_dim 256, else none.
size_t attn_scratch_floats(int b, int m, int n, int hd, int heads) {
  return hd > kWideFwdMinHd ? WideFwdPlanes::floats(b, m, n, heads) : 0;
}

// q, k and v start on kChunk-element boundaries (the head offsets and row
// strides are multiples of head_dim, so every row does too) and head_dim is
// the instantiation's own.
template <typename T, int HD>
bool attn_vec_ok(const AttnArgs& a, bool kv_scratch) {
  if (a.hd != HD) return false;
  const uintptr_t align = kChunk<T, HD> * sizeof(T);
  for (const void* p : {a.q, a.k, kv_scratch ? a.k : a.v})
    if (reinterpret_cast<uintptr_t>(p) % align) return false;
  return true;
}

// The key-tiled and the wide forward's 16-byte copies: every row starts on
// a 16-byte boundary (q, k, v, C and the head offsets) and hd fills whole
// chunks.
template <typename T>
bool flash_vec_ok(const AttnArgs& a, bool kv_scratch) {
  constexpr int CH = 16 / (int)sizeof(T);
  if (a.hd % CH || a.c % CH) return false;
  for (const void* p : {a.q, a.k, kv_scratch ? a.k : a.v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The kernel the plan names: key-tiled, else bf16 at head_dim >= 16 on
// the tensor cores, else the scalar kernel at the row share N asks.
// Above head_dim 32 only the key-tiled kernel is instantiated.
template <typename T, int HD, bool kKvScratch>
cudaError_t attn_run_hd(AttnArgs a, float scale, long long* info, cudaStream_t stream) {
  if (a.key_tiled) {
    if (info == nullptr) a.vec = flash_vec_ok<T>(a, kKvScratch);
    return attn_flash_run<T, flash_hd<T>(HD), kKvScratch>(a, scale, info, stream);
  }
  if (info == nullptr) a.vec = attn_vec_ok<T, HD>(a, kKvScratch);
  if constexpr (HD > 32) {
    return cudaErrorInvalidValue;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 16) {
    return attn_mma_run<HD, kKvScratch>(a, scale, info, stream);
  } else {
    const int j = row_share(a.n);
    switch (j ? j : kMaxRowShare) {
      case 12: return attn_run<T, HD, 12, kKvScratch>(a, scale, info, stream);
      case 16: return attn_run<T, HD, 16, kKvScratch>(a, scale, info, stream);
      case 32: return attn_run<T, HD, 32, kKvScratch>(a, scale, info, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, bool kKvScratch>
cudaError_t attn_run_t(AttnArgs a, float scale, long long* info, cudaStream_t stream) {
  if (a.heads < 1 || a.c % a.heads || a.tiles < 1 || a.tiles > 65535)
    return cudaErrorInvalidValue;
  a.hd = a.c / a.heads;
  if (a.hd > kWideFwdMinHd) {
    if (info == nullptr) a.vec = flash_vec_ok<T>(a, kKvScratch);
    return attn_wide_run<T, kKvScratch>(a, scale, info, stream);
  }
  switch (padded_hd(a.hd)) {
    case 1: return attn_run_hd<T, 1, kKvScratch>(a, scale, info, stream);
    case 2: return attn_run_hd<T, 2, kKvScratch>(a, scale, info, stream);
    case 4: return attn_run_hd<T, 4, kKvScratch>(a, scale, info, stream);
    case 8: return attn_run_hd<T, 8, kKvScratch>(a, scale, info, stream);
    case 16: return attn_run_hd<T, 16, kKvScratch>(a, scale, info, stream);
    case 32: return attn_run_hd<T, 32, kKvScratch>(a, scale, info, stream);
    case 64: return attn_run_hd<T, 64, kKvScratch>(a, scale, info, stream);
    case 128: return attn_run_hd<T, 128, kKvScratch>(a, scale, info, stream);
    case 256: return attn_run_hd<T, 256, kKvScratch>(a, scale, info, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kKvScratch>
cudaError_t launch_attn(int is_bf16, const AttnArgs& a, float scale, cudaStream_t stream) {
  return is_bf16 ? attn_run_t<__nv_bfloat16, kKvScratch>(a, scale, nullptr, stream)
                 : attn_run_t<float, kKvScratch>(a, scale, nullptr, stream);
}

// The occupancy of the instantiation that a launch at these shapes, key-
// tiled or not, takes (attn_run's info, then J and the key tile).
template <bool kKvScratch>
int attn_occupancy(int is_bf16, int m, int n, int c, int heads, int key_tiled, long long* info) {
  AttnArgs a{};
  a.b = 1;
  a.m = m;
  a.n = n;
  a.c = c;
  a.heads = heads;
  a.tiles = 1;
  a.key_tiled = key_tiled;
  return (int)(is_bf16 ? attn_run_t<__nv_bfloat16, kKvScratch>(a, 0.f, info, nullptr)
                       : attn_run_t<float, kKvScratch>(a, 0.f, info, nullptr));
}

// The attention over the k|v scratch that the LN + projection GEMM
// writes: above head_dim 256 the wide forward over `scratch`
// (attn_scratch_floats floats), else each window's rows in `tiles` tiles,
// by the key-tiled kernel (key_tiled 1) or all keys at once (0).
template <typename T>
cudaError_t launch_block_attn(const LnProjArgs& p, int heads, int tiles, int key_tiled,
                              const float* bias, void* out, float* scratch, float scale,
                              cudaStream_t stream) {
  AttnArgs a{};
  a.b = p.b;
  a.m = p.m;
  a.n = p.d * p.m;
  a.c = p.c;
  a.heads = heads;
  a.tiles = tiles;
  a.key_tiled = key_tiled;
  a.q = p.q;
  a.k = p.kv;
  a.v = nullptr;
  a.bias = bias;
  a.out = out;
  a.scratch = scratch;
  return attn_run_t<T, true>(a, scale, nullptr, stream);
}

}  // namespace
