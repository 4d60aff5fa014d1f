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

// The head_dim a kernel is instantiated at: the least of 1, 2, 4, ..., 256
// that holds hd (0 above 256).
__host__ __device__ inline int padded_hd(int hd) {
  int p = 1;
  while (p < hd && p < 256) p <<= 1;
  return p >= hd ? p : 0;
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

}  // namespace
