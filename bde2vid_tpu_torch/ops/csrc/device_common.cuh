// Helpers shared by every kernel under csrc/: operand loads and casts, warp
// reductions, the pieces of the attention core's softmax that its forward
// (window_common.cuh) and its backward (attn_core_bwd.cu) must run alike
// (the fast exp, the padded k/v rows and a lane's share of a score row),
// and the tile products of their wide kernels. f32 or bf16 operands;
// round() below means a cast to the operand type and back, placed where
// the Pallas bodies in bde2vid_tpu/ops/window_attn_pallas.py cast.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0, which a softmax cannot feel).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Row stride (floats) of k and v in shared memory: 16-byte rows for float4
// loads, padded so that 8 lanes on consecutive rows (one phase of a 128-bit
// load) hit distinct banks; an odd stride below head_dim 4.
__host__ __device__ constexpr int key_stride(int hd) {
  return hd < 4 ? hd + 1 : (hd / 4) % 2 ? hd : hd + 4;
}

// r = p[0 .. HD), as float4 loads where HD is a multiple of 4 (p is then
// 16-byte aligned).
template <int HD>
__device__ __forceinline__ void load_row(float (&r)[HD], const float* p) {
  if constexpr (HD % 4 == 0) {
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + d);
      r[d] = t.x;
      r[d + 1] = t.y;
      r[d + 2] = t.z;
      r[d + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) r[d] = p[d];
  }
}

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// The head_dim a kernel instantiated at powers of two runs hd at: the least
// power of two that holds it (the forward up to head_dim 256, the backward
// up to 32; above those the wide kernels take any head_dim as it is).
__host__ __device__ inline int padded_hd(int hd) {
  int p = 1;
  while (p < hd) p <<= 1;
  return p;
}

// The instantiated J (keys a lane keeps of a score row in registers, lane +
// 32 j for j < J); a row of the backward holds at most 32 lanes x the last.
constexpr int kRowShares[] = {12, 16, 32};
constexpr int kMaxRowShare = kRowShares[sizeof(kRowShares) / sizeof(int) - 1];

// Keys a lane keeps of its row: ceil(N / 32) rounded up to an instantiated
// J; 0 when a row holds more than 32 x kMaxRowShare keys.
int row_share(int n) {
  for (int j : kRowShares)
    if (n <= 32 * j) return j;
  return 0;
}

// 16-byte asynchronous copies into shared memory (src_bytes 0: zeros) and
// their groups.
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

// Tensor-core fragments: ldmatrix of four 8x8 bf16 matrices (transposed
// with .trans) and mma.sync m16n8k16.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// ---------------------------------------------------------------------------
// Tile products of 128-thread blocks, shared by the wide backward
// (attn_core_bwd.cu) and the wide forward (window_common.cuh): operands staged
// in shared memory in 64-column chunks of head_dim, f32 by FMA (no TF32) and
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 128;
constexpr int kWideCols = 64;  // head_dim columns of one chunk

// Row stride (elements) of a staged tile of `cols` columns: an odd number of
// 16-byte chunks, so eight rows read at one column fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int wide_ld(int cols) {
  return cols + 16 / (int)sizeof(T);
}

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

// Products into acc[4][4] of a 128-thread block, and where each
// accumulator lands (row, column of the block's tile; the backward's TN
// product, wide_tn, is in attn_core_bwd.cu). f32: thread tiles of 4 x 4 by FMA; bf16: warp tiles of 16 x
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

}  // namespace
