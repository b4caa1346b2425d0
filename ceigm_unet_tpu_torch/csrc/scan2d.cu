// First-order linear recurrence along a direction's pixel order: the quad
// scan's backward and the legacy directional scan's backward (K8).
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _scan2d_kernel (used by scan2d,
// _scan2d_bwd, _quad_ln_bwd_impl and _sscan_bwd) and its batch-last twin
// ceigm_unet_tpu/ops/quad_scan_bl.py _scan_flat_bl (_scan2d_bl,
// _scan2d_bl_adj). Same function, one layout.
//
// a, b, out: (B, K, L, D) fp32, contiguous, L = H*W pixels in row-major
// order. Group k is walked in direction dirs[k] (1 row-major, 2
// column-major, 3/4 those reversed), as the forward kernels K1 and K10
// walk it.
//   scan mode:    h_t = a_t * h_{t-1} + b_t,     h_{-1} = 0;  out = h
//   adjoint mode: g_t = b_t + a_{t+1} * g_{t+1}, g_L = 0;     out = g
// The adjoint is the same recurrence walked in the reversed order, with a
// taken one step behind (the a of the pixel visited just before); it is a
// mode of this kernel, not a shifted copy of a.
//
// What bounds it on the H100: each chain is serial in L (3136 steps at
// 56x56) and the chains are few (B*K*D: 3,072 at gm_tiny's b48 stage 1), so
// it is latency bound; the bytes (12 per element: a and b read, out
// written) are ~0.86 ms per gm_tiny b48 train step and ~3.6 ms per legacy
// tiny_0230s one at 3.35 TB/s. Design, as K1's: one block of 256 threads
// per (b, k, channel tile) walks the group's pixel order in chunks. Per
// chunk, all threads stage the tile's a and b into shared memory
// (coalesced: consecutive threads take consecutive channels of a pixel, and
// a pixel's tile is contiguous), 8 elements per thread into registers
// before any is stored, so 16 loads per thread are in flight; one thread
// per channel then runs only the dependent FMA chain and writes its result
// back into the staged b, and all threads write the chunk out. The chunk is
// as long as 48 KB of shared memory allows (256 pixels at D = 16), so each
// block waits for global memory ~L/chunk times, not L times. The blocks
// are few (B*K per tile: 192 at b48), one or two per SM, so the loads in
// flight per block are what the bandwidth comes from.
//
// Channel tiles: D splits into ceil(D/128) tiles of equal width (D 96 one
// tile, 192 two of 96, 768 six of 128), so any D runs; at D <= 128 (all of
// gm_tiny) one tile, as before.
//
// Versions (b48 fp32, K8's time per unfrozen train step, python -m
// ceigm_unet_tpu_torch.kernel_ab on an H100 80GB HBM3 at 700 W; PERF.md):
// 128 threads staging one element per thread per loop iteration (each
// iteration waited for its own two loads): gm_tiny 7.365 ms, tiny_0230s
// 19.410 ms (another call); this one 3.404 ms and 9.725 ms, against
// bounds of 0.856 and 3.623 ms.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxTile = 128;
constexpr int kSmemBytes = 48 * 1024;

struct Scan2dArgs {
  const float* a; const float* b; float* out;
  int K, H, W, D, tiles, tw, chunk, adjoint;
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
  const int tile = blockIdx.x % p.tiles;
  const long long bk = blockIdx.x / p.tiles;
  const int c0 = tile * p.tw;
  const int tw = min(p.tw, D - c0);        // this tile's channels
  const int Dp = p.tw | 1;                 // odd row stride
  float* sa = smem;                        // [chunk][Dp] a
  float* sb = sa + chunk * Dp;             // [chunk][Dp] b, then the result
  int* sP = reinterpret_cast<int*>(sb + chunk * Dp);   // [chunk] pixel

  const int k = (int)(bk % p.K);
  int dir = p.dirs[k];
  if (p.adjoint) dir = dir <= 2 ? dir + 2 : dir - 2;   // the reversed walk
  const long long base = bk * L * D + c0;
  const float* a = p.a + base;
  const float* b = p.b + base;
  float* out = p.out + base;
  const int tid = threadIdx.x;
  float h = 0.f;
  float a_behind = 0.f;    // adjoint: a of the pixel visited one step before

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int n = min(chunk, L - t0);
    // kUnroll elements per thread in registers first, then into shared
    // memory: 2 * kUnroll loads in flight per thread, not 2
    for (int e0 = tid; e0 < n * tw; e0 += kThreads * kUnroll) {
      float ra[kUnroll], rb[kUnroll];
      int ri[kUnroll], rp[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int e = min(e0 + j * kThreads, n * tw - 1);
        const int i = e / tw, c = e - i * tw;
        rp[j] = pixel_at(t0 + i, dir, H, W);
        ri[j] = i * Dp + c;
        ra[j] = a[(long long)rp[j] * D + c];
        rb[j] = b[(long long)rp[j] * D + c];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int e = e0 + j * kThreads;
        if (e < n * tw) {
          sa[ri[j]] = ra[j];
          sb[ri[j]] = rb[j];
          if (e % tw == 0) sP[e / tw] = rp[j];
        }
      }
    }
    __syncthreads();
    if (tid < tw) {
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
    for (int e = tid; e < n * tw; e += kThreads) {
      const int i = e / tw, c = e - i * tw;
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
  if (B < 1 || K < 1 || K > 4 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (D + kMaxTile - 1) / kMaxTile;
  const int tw = (D + tiles - 1) / tiles;
  const long long blocks = (long long)B * K * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int Dp = tw | 1;
  // the longest power-of-two chunk (<= 256 pixels) whose a, b and pixel
  // index rows fit in 48 KB
  int chunk = 256;
  while (chunk > 1 && (size_t)chunk * (2 * Dp + 1) * 4 > kSmemBytes)
    chunk >>= 1;
  Scan2dArgs p{a, b, out, K, H, W, D, tiles, tw, chunk, adjoint != 0,
               {dir0, dir1, dir2, dir3}};
  const size_t smem = (size_t)chunk * (2 * Dp + 1) * 4;
  scan2d_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
