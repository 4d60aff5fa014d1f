// Device code shared by the window-attention kernels (swin_block.cu,
// window_block.cu, window_attention.cu): operand loads and casts, warp
// reductions, the GEMM core behind every projection and MLP stage, and the
// per-(window, head) attention with a warp per query row. f32 or bf16
// operands, f32 accumulation; round() below means a cast to the operand type
// and back, placed where the Pallas bodies in
// bde2vid_tpu/ops/window_attn_pallas.py cast.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // attention kernels
constexpr float kLnEps = 1e-5f;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one Hopper block may use

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

// Read-only loads through the non-coherent path: the compiler may move them
// past the kernel's stores, which might otherwise alias them.
__device__ __forceinline__ float ldg(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(__ldg(p + i));
}

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

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// row stride of a resident A tile over k (K rounded up to kBK, zero-filled)
template <typename T>
__host__ __device__ inline int resident_ld(int k) {
  return (k + kBK<T> - 1) / kBK<T> * kBK<T> + kPad<T>;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
  const Src* x = static_cast<const Src*>(a.x);
  const Src* ctr = static_cast<const Src*>(a.ctr);
  auto row = [&](int lr) -> const Src* {
    const int r = r0 + lr;
    if (second) return ctr + (size_t)r * c;
    if (r / a.rows_per_frame == a.q_ind) return ctr + (size_t)(r - a.q_ind * a.rows_per_frame) * c;
    return x + (size_t)r * c;
  };

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

// part[1].rows = 0: one row set
template <typename T, typename Src>
cudaError_t launch_ln_gemm(const LnGemmArgs& a, cudaStream_t stream) {
  const LnPart &p0 = a.part[0], &p1 = a.part[1];
  int tile = 0, sms = 0;
  const cudaError_t err = pick_tile(
      std::max(p0.o_total, p1.o_total),
      [&](int bm, int bn) {
        return cdiv(p0.rows, bm) * cdiv(p0.o_total, bn) + cdiv(p1.rows, bm) * cdiv(p1.o_total, bn);
      },
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

// shared memory of the smallest tile: a launch of these shapes fails unless
// it fits (the launcher takes a larger tile only where that fits too)
template <typename T>
size_t ln_proj_smem_bytes(int c) {
  return ln_gemm_smem<T, T, TileS>(c);
}

// ---------------------------------------------------------------------------
// attention core: per window w and head h,
//   out_h = round(softmax(q_h k_h^T * scale + bias_h)) @ v_h
// ---------------------------------------------------------------------------

// The kv tokens of window w come in one of two layouts. The block kernels
// read the (D, B_, M, 2C) k|v scratch that the LN + projection GEMM writes
// (kKvScratch: token n is frame n / M, token n % M, with v C elements after
// k); the bare attention reads separate (B_, N, C) k and v.
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

// The attention over the k|v scratch that the LN + projection GEMM writes.
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
