// Shared helpers for the hand-written Hopper kernels: fp32/bf16 (and int8)
// loads and fp32/bf16 stores, warp reductions, the ex2/lg2 approximations
// and the scans' walk over a direction's pixels. Every kernel computes in
// fp32.
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ceigm {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// int8 through the magic-number add (1.5 * 2^23 + x is exact for |x| <
// 2^22): two full-rate instructions, where I2F issues at a quarter rate
__device__ __forceinline__ float to_f(int8_t x) {
  return __int_as_float(0x4B400000 + (int)x) - 12582912.f;
}

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

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A direction's walk over the H*W pixels (1 row-major, 2 column-major, 3/4
// those reversed): the pixel at step t, and the pixel after p step by step
// (p += inc; where that leaves [0, L), a column walk passing the end of a
// column, p += wrap), or before it (the inverse).
struct Walk {
  int H, W, L, inc, wrap;
  bool rev, col;
  float invH;
  __device__ __forceinline__ Walk(int dir, int H_, int W_)
      : H(H_), W(W_), L(H_ * W_) {
    rev = dir == 3 || dir == 4;
    col = dir == 2 || dir == 4;
    inc = dir == 1 ? 1 : dir == 3 ? -1 : dir == 2 ? W : -W;
    wrap = dir == 2 ? 1 - L : dir == 4 ? L - 1 : 0;
    invH = 1.f / H;
  }
  __device__ __forceinline__ int at(int t) const {
    if (rev) t = L - 1 - t;
    if (!col) return t;
    // t / H through the fp32 reciprocal, corrected to the exact quotient
    // (t < 2^24)
    int q = __float2int_rz((float)t * invH);
    const int r = t - q * H;
    q += r < 0 ? -1 : (r >= H ? 1 : 0);
    return (t - q * H) * W + q;
  }
  __device__ __forceinline__ int next(int p) const {
    p += inc;
    return (unsigned)p >= (unsigned)L ? p + wrap : p;
  }
  __device__ __forceinline__ int prev(int p) const {
    p -= inc;
    return (unsigned)p >= (unsigned)L ? p - wrap : p;
  }
};

// V-wide fp32 items (V = 4, 2, 1: 16-, 8- and 4-byte accesses)
template <int V> struct VecOf;
template <> struct VecOf<4> { typedef float4 T; };
template <> struct VecOf<2> { typedef float2 T; };
template <> struct VecOf<1> { typedef float T; };

template <int V>
__device__ __forceinline__ void load_v(float (&x)[V], const float* p) {
  const typename VecOf<V>::T t =
      __ldg(reinterpret_cast<const typename VecOf<V>::T*>(p));
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = f[v];
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&x)[V]) {
  typename VecOf<V>::T t;
  float* f = reinterpret_cast<float*>(&t);
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = x[v];
  *reinterpret_cast<typename VecOf<V>::T*>(p) = t;
}

// The widest item of 4, 2, 1 floats that divides each of ns (channel
// counts, offsets, strides) and aligns each of ptrs.
inline int vec_width(std::initializer_list<long long> ns,
                     std::initializer_list<const void*> ptrs) {
  for (int V = 4; V > 1; V >>= 1) {
    bool ok = true;
    for (long long n : ns) ok = ok && n % V == 0;
    for (const void* x : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(x) % (4 * V) == 0;
    if (ok) return V;
  }
  return 1;
}

// dtype codes shared with ops/_build.py DTYPE_CODES
enum { kF32 = 0, kBF16 = 1 };

}  // namespace ceigm
