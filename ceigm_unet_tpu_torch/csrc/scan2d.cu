// First-order linear recurrence along a direction's pixel order: the quad
// scan's backward (K8).
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _scan2d_kernel (used by scan2d,
// _scan2d_bwd and _quad_ln_bwd_impl) and its batch-last twin
// ceigm_unet_tpu/ops/quad_scan_bl.py _scan_flat_bl (_scan2d_bl,
// _scan2d_bl_adj). Same function, one layout.
//
// a, b, out: (B, K, L, D) fp32, contiguous, L = H*W pixels in row-major
// order. Group k is walked in direction dirs[k] (1 row-major, 2
// column-major, 3/4 those reversed), as the forward kernel K1 walks it.
//   scan mode:    h_t = a_t * h_{t-1} + b_t,     h_{-1} = 0;  out = h
//   adjoint mode: g_t = b_t + a_{t+1} * g_{t+1}, g_L = 0;     out = g
// The adjoint is the same recurrence walked in the reversed order, with a
// taken one step behind (the a of the pixel visited just before); it is a
// mode of this kernel, not a shifted copy of a.
//
// What bounds it on the H100: each chain is serial in L (3136 steps at
// 56x56) and there are only B*K*D chains (3,072 at b48 stage 1), so it is
// latency bound; the bytes (12 per element: a and b read, out written) are
// ~0.86 ms per b48 train step at 3.35 TB/s. Design, as K1's: one block of
// 128 threads per (b, k) walks the group's pixel order in chunks. Per chunk,
// all threads stage a and b into shared memory (coalesced: consecutive
// threads take consecutive channels of a pixel), one thread per channel
// runs only the dependent FMA chain and writes its result back into the
// staged b, and all threads write the chunk out. The chunk is as long as
// 48 KB of shared memory allows (256 pixels at D = 16), so each block waits
// for global memory ~L/chunk times, not L times.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr int kSmemBytes = 48 * 1024;

struct Scan2dArgs {
  const float* a; const float* b; float* out;
  int K, H, W, D, chunk, adjoint;
  int dirs[4];
};

__device__ __forceinline__ int pixel_at(int t, int dir, int H, int W) {
  const int L = H * W;
  if (dir == 3 || dir == 4) t = L - 1 - t;
  if (dir == 2 || dir == 4) return (t % H) * W + t / H;
  return t;
}

__global__ void __launch_bounds__(kThreads) scan2d_kernel(Scan2dArgs p) {
  extern __shared__ float smem[];
  const int D = p.D, H = p.H, W = p.W, L = H * W, chunk = p.chunk;
  const int Dp = D | 1;                    // odd row stride
  float* sa = smem;                        // [chunk][Dp] a
  float* sb = sa + chunk * Dp;             // [chunk][Dp] b, then the result
  int* sP = reinterpret_cast<int*>(sb + chunk * Dp);   // [chunk] pixel

  const int k = blockIdx.x % p.K;
  int dir = p.dirs[k];
  if (p.adjoint) dir = dir <= 2 ? dir + 2 : dir - 2;   // the reversed walk
  const long long base = (long long)blockIdx.x * L * D;
  const float* a = p.a + base;
  const float* b = p.b + base;
  float* out = p.out + base;
  const int tid = threadIdx.x;
  float h = 0.f;
  float a_behind = 0.f;    // adjoint: a of the pixel visited one step before

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int n = min(chunk, L - t0);
    for (int e = tid; e < n * D; e += kThreads) {
      const int i = e / D, c = e - i * D;
      const int px = pixel_at(t0 + i, dir, H, W);
      sa[i * Dp + c] = a[(long long)px * D + c];
      sb[i * Dp + c] = b[(long long)px * D + c];
      if (c == 0) sP[i] = px;
    }
    __syncthreads();
    if (tid < D) {
      if (!p.adjoint) {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          h = fmaf(sa[i * Dp + tid], h, sb[i * Dp + tid]);
          sb[i * Dp + tid] = h;
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          h = fmaf(a_behind, h, sb[i * Dp + tid]);
          a_behind = sa[i * Dp + tid];
          sb[i * Dp + tid] = h;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n * D; e += kThreads) {
      const int i = e / D, c = e - i * D;
      out[(long long)sP[i] * D + c] = sb[i * Dp + c];
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace ceigm

extern "C" int scan2d(const float* a, const float* b, float* out, int B,
                      int K, int H, int W, int D, int dir0, int dir1,
                      int dir2, int dir3, int adjoint, cudaStream_t stream) {
  using namespace ceigm;
  if (B < 1 || K < 1 || K > 4 || D < 1 || D > kMaxD || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int Dp = D | 1;
  // the longest power-of-two chunk (<= 256 pixels) whose a, b and pixel
  // index rows fit in 48 KB
  int chunk = 256;
  while (chunk > 1 && (size_t)chunk * (2 * Dp + 1) * 4 > kSmemBytes)
    chunk >>= 1;
  Scan2dArgs p{a, b, out, K, H, W, D, chunk, adjoint != 0,
               {dir0, dir1, dir2, dir3}};
  const size_t smem = (size_t)chunk * (2 * Dp + 1) * 4;
  scan2d_kernel<<<B * K, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
