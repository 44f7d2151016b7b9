// Shared helpers for the hand-written Hopper kernels of ovmr_tpu_torch.
//
// Each .cu file in this directory builds into its own shared library with
// a plain C interface (ovmr_tpu_torch/ops/cuda_lib.py loads it with ctypes).
// Launchers take raw device pointers and a cudaStream_t, allocate nothing,
// never synchronise, and return cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define OVMR_EXPORT extern "C" __attribute__((visibility("default")))

namespace ovmr {

// dtype codes shared with cuda_lib.DTYPE_CODES
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

// round to nearest even, as PyTorch and XLA cast
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// N consecutive elements moved as one aligned vector load/store
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

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

// 16-byte global -> shared copy; zero-fills when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

}  // namespace ovmr

OVMR_EXPORT const char* ovmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
