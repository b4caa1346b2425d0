// Shared helpers for the hand-written Hopper kernels: fp32/bf16 (and int8)
// loads and fp32/bf16 stores, and warp reductions. Every kernel computes in
// fp32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ceigm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dtype codes shared with ops/_build.py DTYPE_CODES
enum { kF32 = 0, kBF16 = 1 };

}  // namespace ceigm
