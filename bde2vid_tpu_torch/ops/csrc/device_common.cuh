// Helpers shared by every kernel under csrc/: operand loads and casts, warp
// reductions, and the pieces of the attention core's softmax that its
// forward (window_common.cuh) and its backward (attn_core_bwd.cu) must run
// alike: the fast exp, the padded k/v rows and a lane's share of a score
// row. f32 or bf16 operands; round() below means a cast to the operand type
// and back, placed where the Pallas bodies in
// bde2vid_tpu/ops/window_attn_pallas.py cast.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The head_dim a kernel runs hd at: the least of 1, 2, 4, ..., 1024 that
// holds it, and above 1024 hd rounded up to a multiple of 256 (the forward's
// chunked key-tiled kernel, attn_flash_chunked_kernel, takes any of those;
// the backward above 32 any head_dim).
__host__ __device__ inline int padded_hd(int hd) {
  if (hd > 1024) return cdiv(hd, 256) * 256;
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

}  // namespace
