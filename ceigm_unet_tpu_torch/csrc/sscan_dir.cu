// Directional d_state = 1 selective scan, no LayerNorm: the legacy VMamba
// SS2D's scan (K10).
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _sscan_dir_kernel (body
// _fused_kernel, entry sscan_dir), which the JAX package calls once per
// direction; here all K directions run in one launch.
//
// For direction k (1 row-major, 2 column-major, 3/4 those reversed), over
// the H*W pixels in that order, per channel c:
//   d = softplus(dt + bias);  h = exp(d*A)*h_prev + d*u*B;  y = C*h + D*u
// u, dt: (B, K, L, D) addressed by strides (u may be a stride-0 view over
// K: the four directions read the same activation); Bs, Cs: (B, K, L)
// per-pixel scalars by strides; A, bias, Dv: (K, D) fp32. y: (B, K, L, D)
// fp32, contiguous, in row-major pixel order. u/dt/Bs/Cs are fp32 or bf16;
// all arithmetic is fp32.
//
// What bounds it on the H100: bytes. A chain is serial in L (3136 steps at
// 56x56), but at b128 there are B*K*D = 49,152 chains and each step is one
// FMA, while the op moves ~1 GB per call (dt and the fp32 y dominate):
// ~0.3 ms at 3.35 TB/s against ~15 us of dependent FMAs per chain. Design:
// without K1's LayerNorm no thread needs another channel's values, so one
// warp owns one (b, k, 32-channel tile) and lane c owns channel c end to
// end: it loads its channel of 16 pixels of the direction's walk at once
// (a warp load is the tile's 32 contiguous channels of one pixel, whatever
// the direction, so column walks stay coalesced; the per-pixel B and C are
// warp-wide broadcasts), then runs the 16 steps from registers and stores
// y (128 contiguous bytes per pixel per warp). There is no shared memory
// and no barrier: warps overlap one another's loads and chains freely, and
// each lane keeps 64 loads in flight. Tiling channels over warps lifts K1's
// D <= 128 limit (D reaches 768). The TPU kernel's lane padding to 2^k
// channels with A = -1 has no counterpart: lanes past D load a clamped
// channel and store nothing.
//
// Versions tried, b128 bf16 56x56 D96, bound 0.301 ms (chip_smoke.py phase
// 10 on an H100 80GB HBM3 at 700 W; PERF.md): 64-pixel chunks staged
// in shared memory as K1 does (128 threads load, one warp runs the chain,
// three barriers per chunk) 2.132 ms; this one 1.248 ms; prefetching the
// next 8-pixel batch while computing the current one, with the ex2/lg2
// approximations, 1.536 ms (fewer loads in flight per lane).
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kTile = 32;      // channels per warp, one per lane
constexpr int kWarps = 4;      // warps per block
constexpr int kSteps = 16;     // pixels per lane whose loads go out at once

struct DirArgs {
  const void* u; const void* dt; const void* Bs; const void* Cs;
  const float* A; const float* bias; const float* Dv; float* out;
  long long su[4], sdt[4], sbs[3], scs[3];
  long long warps;
  int K, H, W, D, tiles;
  int dirs[4];
};

__device__ __forceinline__ int pixel_of(int t, int dir, int H, int W) {
  const int L = H * W;
  if (dir == 3 || dir == 4) t = L - 1 - t;
  if (dir == 2 || dir == 4) return (t % H) * W + t / H;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) sscan_dir_kernel(DirArgs a) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= a.warps) return;                     // warp-uniform
  const int lane = threadIdx.x & 31;
  const int tile = (int)(w % a.tiles);
  const long long bk = w / a.tiles;
  const int b = (int)(bk / a.K), k = (int)(bk % a.K);
  const int H = a.H, W = a.W, L = H * W, D = a.D;
  const int dir = a.dirs[k];
  const int c = tile * kTile + lane;
  const bool live = c < D;
  const int cl = live ? c : D - 1;              // in-bounds loads only

  const float A_c = a.A[k * D + cl];
  const float bias_c = a.bias[k * D + cl];
  const float D_c = a.Dv[k * D + cl];
  const T* u = static_cast<const T*>(a.u) + b * a.su[0] + k * a.su[1]
               + (long long)cl * a.su[3];
  const T* dt = static_cast<const T*>(a.dt) + b * a.sdt[0] + k * a.sdt[1]
                + (long long)cl * a.sdt[3];
  const T* Bs = static_cast<const T*>(a.Bs) + b * a.sbs[0] + k * a.sbs[1];
  const T* Cs = static_cast<const T*>(a.Cs) + b * a.scs[0] + k * a.scs[1];
  float* out = a.out + bk * L * D + c;
  float h = 0.f;

  for (int t0 = 0; t0 < L; t0 += kSteps) {
    float uu[kSteps], xx[kSteps], bb[kSteps], cv[kSteps];
    int pp[kSteps];
    // 1. every load of the next kSteps pixels (past the end: the last
    // pixel again, not used)
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int p = pixel_of(min(t0 + j, L - 1), dir, H, W);
      pp[j] = p;
      uu[j] = to_f(u[p * a.su[2]]);
      xx[j] = to_f(dt[p * a.sdt[2]]);
      bb[j] = to_f(Bs[p * a.sbs[2]]);
      cv[j] = to_f(Cs[p * a.scs[2]]);
    }
    // 2. the steps: all but the FMA on h are independent across j
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (t0 + j < L) {                          // warp-uniform
        const float x = xx[j] + bias_c;
        const float delta = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        h = fmaf(expf(delta * A_c), h, delta * uu[j] * bb[j]);
        if (live) out[(long long)pp[j] * D] = fmaf(cv[j], h, D_c * uu[j]);
      }
    }
  }
}

}  // namespace
}  // namespace ceigm

extern "C" int sscan_dir(
    const void* u, const void* dt, const void* Bs, const void* Cs,
    const float* A, const float* bias, const float* Dv, float* out,
    long long su0, long long su1, long long su2, long long su3,
    long long sd0, long long sd1, long long sd2, long long sd3,
    long long sb0, long long sb1, long long sb2,
    long long sc0, long long sc1, long long sc2,
    int B, int K, int H, int W, int D, int dir0, int dir1, int dir2,
    int dir3, int dtype, cudaStream_t stream) {
  using namespace ceigm;
  if (B < 1 || K < 1 || K > 4 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (D + kTile - 1) / kTile;
  const long long warps = (long long)B * K * tiles;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  DirArgs a{u, dt, Bs, Cs, A, bias, Dv, out,
            {su0, su1, su2, su3}, {sd0, sd1, sd2, sd3}, {sb0, sb1, sb2},
            {sc0, sc1, sc2}, warps, K, H, W, D, tiles,
            {dir0, dir1, dir2, dir3}};
  if (dtype == kF32)
    sscan_dir_kernel<float><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(a);
  else
    sscan_dir_kernel<bf16><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
