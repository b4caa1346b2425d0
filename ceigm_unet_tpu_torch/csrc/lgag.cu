// Fused eval-mode LGAG attention gate: x * psi with
//   psi = sigmoid(a2 * (sum_c2 relu(a1*conv(g) + b1) * psi_w + psi_b) + c2)
// where conv is the six grouped 2-in/1-out convs (k 1/3/5, both branches
// reading g) folded on the host into one 5x5x2xC2 tap stack, and a1/b1,
// a2/c2 the folded batch norms (ops/tapconv.py lgag_gate_eval).
//
// Replaces: ceigm_unet_tpu/ops/tapconv.py _lgag_call / _lgag_kernel (entry
// lgag_gate_eval).
//
// What bounds it on the H100: bytes (g and x read once, the result written
// once: 283 MB over the three gates of a b128 bf16 forward, 0.085 ms at
// 3.35 TB/s); its 50*C2 FMAs per pixel (1.2e9 per forward, ~0.035 ms) come
// next, and the loads that feed them if each FMA loads its operands.
//
// Design: each g value and each tap is loaded once per block and reused
// from shared memory and registers. A block takes one image's strip of
// kRows = 7 output rows (7 divides 14, 28 and 56) by up to 28 columns
// (whole width at 14x14 and 28x28, two tiles at 56x56), and all of C2 for
// those pixels, so psi's sum over c2 stays in the block. It walks C2 in
// chunks of 32, one output channel per lane, through two staging buffers:
// the next chunk's copies are in flight while the current one computes.
// - staging: asynchronous copies of the 11 x (tw+4) halo of g's 64 input
//   channels of the chunk (zeros outside the image), in 16-byte items where
//   C and the pointers allow (8 at C 348 in bf16), and of the chunk's 50
//   taps, a1, b1 and psi_w;
// - compute: the taps in registers; a thread (one c2, columns wid, wid+8,
//   ...) walks the 11 staged rows, reading each row's 5 channel pairs once
//   (one 4-byte word a lane in bf16, so a warp reads 128 conflict-free
//   bytes) and adding them into the up to 5 output rows they reach: 10
//   shared reads per output pixel and c2 instead of 50 loads. The column's
//   7 relu(...) * psi_w are summed over the warp's 32 c2 by a reduce-scatter
//   (9 shuffles for the 7) and added into the pixels' partial psi in shared
//   memory, which only the warp owning that column touches.
// Then the sigmoid per pixel, and x * psi over all C channels of the
// strip's pixels: during the last chunk x is copied into the free staging
// buffer where it fits (at 28x28 and 56x56), else read with 8 loads in
// flight a thread. Taps and arithmetic are fp32, the sigmoid's exponential
// the accurate expf.
//
// Versions (b128 bf16 per forward, device ms, python
// tools/port_stencil_variants.py --lgag on copies of each one's csrc/, all
// in one call, on an H100 80GB HBM3, 700 W; the parent's warp per pixel,
// two loads per FMA: 0.7567 in kernel_ab, bound 0.0847): one staging batch
// per chunk at three blocks per SM, spilling: 0.2783; at two: 0.2371; two
// buffers and the taps staged with g, 28-column tiles: 0.2199; 8 warps:
// 0.2124; the reduce-scatter: 0.2018 (this one). No gain and dropped:
// asynchronous copies of g alone (0.2434), copying the part of x that
// fits at 14x14 (0.2057), and, in another call, 16 x loads in flight
// (spilling: 0.2095 against this one's 0.2020).
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kRows = 7;                 // output rows per block
constexpr int kReach = 2;                // the 5x5's reach
constexpr int kSR = kRows + 2 * kReach;  // staged rows
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTw = 28;               // tile columns (2 blocks per SM)
constexpr int kPitch = kMaxTw + 2 * kReach;   // staged columns (compile-time
                                              // offsets)
constexpr int kChunk = 32;               // output channels per chunk
constexpr int kXBatch = 8;               // x loads in flight a thread
constexpr int kPrm = 53;                 // 50 taps, a1, b1, psi_w

template <typename T> struct PairOf;
template <> struct PairOf<float> { typedef float2 T; };
template <> struct PairOf<bf16> { typedef __nv_bfloat162 T; };

__device__ __forceinline__ float2 pair_f(float2 v) { return v; }
__device__ __forceinline__ float2 pair_f(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// VB-byte raw items (VB = 16, 8, 4)
template <int VB> struct RawOf;
template <> struct RawOf<16> { typedef int4 T; };
template <> struct RawOf<8> { typedef int2 T; };
template <> struct RawOf<4> { typedef int T; };

// A walk over n items of rows x cols pixels, ipp items a pixel, kThreads
// items a step: (e, item, row, column) advanced by increments.
struct ItemWalk {
  int e, it, r, c;
  int n, ipp, cols, dit, dr, dc;
  __device__ __forceinline__ ItemWalk(int rows, int cols_, int ipp_)
      : ipp(ipp_), cols(cols_) {
    n = rows * cols * ipp;
    e = threadIdx.x;
    const int pix = e / ipp;
    it = e - pix * ipp;
    r = pix / cols;
    c = pix - r * cols;
    const int dpix = kThreads / ipp;
    dit = kThreads - dpix * ipp;
    dr = dpix / cols;
    dc = dpix - dr * cols;
  }
  __device__ __forceinline__ void next() {
    e += kThreads;
    it += dit;
    const int carry = it >= ipp;
    it -= carry ? ipp : 0;
    c += dc + carry;
    r += dr;
    if (c >= cols) c -= cols, ++r;
  }
};

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  // src-size 0 fills the item with zeros and reads nothing
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(VB), "r"(valid ? VB : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, 2)
lgag_kernel(const T* __restrict__ g, const T* __restrict__ x,
            const float* __restrict__ taps, const float* __restrict__ a1,
            const float* __restrict__ b1, const float* __restrict__ psi_w,
            const float* __restrict__ sc, T* __restrict__ out, int H, int W,
            int C, int tw, int tiles_x, int tiles_y) {
  typedef typename RawOf<VB>::T Raw;
  typedef typename PairOf<T>::T Pair;
  constexpr int kPixB = 2 * kChunk * sizeof(T);   // a staged pixel's bytes
  constexpr int kBuf = kSR * kPitch * kPixB;      // a staging buffer's bytes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float psi[kRows * kMaxTw];
  // per buffer: the chunk's 50 taps, a1, b1 and psi_w, 32 lanes each
  __shared__ float prm[2][kPrm][kChunk];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  int blk = blockIdx.x;
  const int tx = blk % tiles_x;
  blk /= tiles_x;
  const int ty = blk % tiles_y;
  const long long bi = blk / tiles_y;
  const int y0 = ty * kRows, x0 = tx * tw;
  const int C2 = C >> 1;
  const long long pix_b = (long long)C * sizeof(T);
  const unsigned char* gi = reinterpret_cast<const unsigned char*>(g) +
                            bi * H * W * pix_b;
  for (int i = tid; i < kRows * kMaxTw; i += kThreads) psi[i] = 0.f;
  // the tile's x: its rows x cols pixels of C channels, prefetched into the
  // free staging buffer during the last chunk when it fits there
  const int rows = min(kRows, H - y0), cols = min(tw, W - x0);
  const int ipx = (int)(pix_b / VB);
  const long long base = ((bi * H + y0) * W + x0) * pix_b;
  const unsigned char* xs = reinterpret_cast<const unsigned char*>(x) + base;
  const bool x_early = (long long)rows * cols * pix_b <= kBuf;

  // stage chunk c2_0's g over image rows y0-2 .. y0+8, columns x0-2 ..
  // x0+tw+1 into buffer buf (zeros outside the image and past C)
  auto stage = [&](int c2_0, unsigned char* buf) {
    // the chunk's parameters: 4-byte copies, lanes past the chunk repeat
    // its last channel
    const int last = min(kChunk, C2 - c2_0) - 1;
    float(*pb)[kChunk] = prm[buf == smem ? 0 : 1];
    for (int i = tid; i < kPrm * kChunk; i += kThreads) {
      const int k = i / kChunk, cl = c2_0 + min(i - k * kChunk, last);
      const float* src = k < 50 ? taps + k * C2 + cl
                       : (k == 50 ? a1 : k == 51 ? b1 : psi_w) + cl;
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(&pb[k][i - k * kChunk]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src));
    }
    constexpr int ipp = kPixB / VB;
    const int valid = 2 * min(kChunk, C2 - c2_0) * (int)sizeof(T);
    const unsigned char* src = gi + 2 * c2_0 * sizeof(T);
    for (ItemWalk w(kSR, tw + 2 * kReach, ipp); w.e < w.n; w.next()) {
      const int yy = y0 - kReach + w.r, xx = x0 - kReach + w.c;
      const bool in = w.it * VB < valid && yy >= 0 && yy < H && xx >= 0 &&
                      xx < W;
      cp_async<VB>(buf + (w.r * kPitch + w.c) * kPixB + w.it * VB,
                   in ? src + ((long long)yy * W + xx) * pix_b + w.it * VB
                      : src, in);
    }
    cp_async_commit();
  };

  const int n_chunks = (C2 + kChunk - 1) / kChunk;
  stage(0, smem);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c2_0 = ci * kChunk;
    const int nc2 = min(kChunk, C2 - c2_0);
    unsigned char* buf = smem + (ci & 1) * kBuf;
    unsigned char* other = smem + ((ci + 1) & 1) * kBuf;
    if (ci + 1 < n_chunks) {
      // the other buffer's chunk (ci - 1) is done: every thread passed the
      // barrier after it
      stage(c2_0 + kChunk, other);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
      if (x_early) {
        for (ItemWalk w(rows, cols, ipx); w.e < w.n; w.next())
          cp_async<VB>(other + (long long)w.e * VB,
                       xs + ((long long)w.r * W + w.c) * pix_b + w.it * VB,
                       true);
        cp_async_commit();
      }
    }
    __syncthreads();

    // the 5x5 and psi's partial sums: thread -> (c2 lane, columns wid,
    // wid + kWarps, ...)
    const float(*pb)[kChunk] = prm[ci & 1];
    float t[50];
#pragma unroll
    for (int k = 0; k < 50; ++k) t[k] = pb[k][lane];
    const float ac = pb[50][lane], bc = pb[51][lane];
    const float pw = lane < nc2 ? pb[52][lane] : 0.f;
    const Pair* tp = reinterpret_cast<const Pair*>(buf) + lane;
    for (int col = wid; col < cols; col += kWarps) {
      float acc[kRows];
#pragma unroll
      for (int o = 0; o < kRows; ++o) acc[o] = 0.f;
#pragma unroll
      for (int s = 0; s < kSR; ++s) {
        float2 v[5];
#pragma unroll
        for (int kx = 0; kx < 5; ++kx)
          v[kx] = pair_f(tp[(s * kPitch + col + kx) * kChunk]);
        // staged row s reaches output rows s - 4 .. s (tap row s - o)
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          if (o <= s && s - o < 5) {
#pragma unroll
            for (int kx = 0; kx < 5; ++kx) {
              const int k = ((s - o) * 5 + kx) * 2;
              acc[o] = fmaf(v[kx].x, t[k], acc[o]);
              acc[o] = fmaf(v[kx].y, t[k + 1], acc[o]);
            }
          }
        }
      }
      // psi's partials of the column's 7 outputs (and a zero eighth),
      // summed over the warp's 32 c2 by a reduce-scatter: lanes exchange
      // halves of the 8 values at xor 16, 8 and 4, then the one value each
      // lane keeps is summed at xor 2 and 1; lanes past nc2 add zeros
      float v8[8];
#pragma unroll
      for (int o = 0; o < 8; ++o)
        v8[o] = o < kRows && lane < nc2
            ? fmaxf(fmaf(ac, acc[o < kRows ? o : 0], bc), 0.f) * pw : 0.f;
      const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
      float v4[4], v2[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v4[i] = (b16 ? v8[i + 4] : v8[i]) +
                __shfl_xor_sync(0xffffffffu, b16 ? v8[i] : v8[i + 4], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v2[i] = (b8 ? v4[i + 2] : v4[i]) +
                __shfl_xor_sync(0xffffffffu, b8 ? v4[i] : v4[i + 2], 8);
      float v1 = (b4 ? v2[1] : v2[0]) +
                 __shfl_xor_sync(0xffffffffu, b4 ? v2[0] : v2[1], 4);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
      // lane 4o holds output o's sum
      const int o = (b16 ? 4 : 0) + (b8 ? 2 : 0) + (b4 ? 1 : 0);
      if ((lane & 3) == 0 && o < kRows) psi[o * kMaxTw + col] += v1;
    }
    __syncthreads();   // buf is free for chunk ci + 2
  }
  // psi per pixel; sc = [psi_b, a2, c2]: psi conv bias and the folded psi
  // batch norm
  const float s0 = sc[0], s1 = sc[1], s2 = sc[2];
  for (int i = tid; i < kRows * kMaxTw; i += kThreads)
    psi[i] = 1.f / (1.f + expf(-(s1 * (psi[i] + s0) + s2)));
  __syncthreads();

  // x * psi over the tile's pixels, all C channels, in VB-byte items: from
  // the prefetched buffer (each thread reads back the items it copied), or
  // from x with kXBatch loads in flight
  constexpr int kPer = VB / sizeof(T);
  unsigned char* os = reinterpret_cast<unsigned char*>(out) + base;
  auto scale = [&](Raw raw, const ItemWalk& w) {
    union { Raw raw; T e[kPer]; } u;
    u.raw = raw;
    const float p = psi[w.r * kMaxTw + w.c];
#pragma unroll
    for (int k = 0; k < kPer; ++k) u.e[k] = from_f<T>(to_f(u.e[k]) * p);
    *reinterpret_cast<Raw*>(os + ((long long)w.r * W + w.c) * pix_b +
                            w.it * VB) = u.raw;
  };
  if (x_early) {
    const unsigned char* xb = smem + (n_chunks & 1) * kBuf;
    cp_async_wait<0>();
    for (ItemWalk w(rows, cols, ipx); w.e < w.n; w.next())
      scale(*reinterpret_cast<const Raw*>(xb + (long long)w.e * VB), w);
    return;
  }
  ItemWalk w(rows, cols, ipx);
  while (w.e < w.n) {
    Raw r[kXBatch];
    {
      ItemWalk v = w;
#pragma unroll
      for (int j = 0; j < kXBatch; ++j) {
        if (v.e < v.n)
          r[j] = __ldg(reinterpret_cast<const Raw*>(
              xs + ((long long)v.r * W + v.c) * pix_b + v.it * VB));
        v.next();
      }
    }
#pragma unroll
    for (int j = 0; j < kXBatch; ++j) {
      if (w.e < w.n) scale(r[j], w);
      w.next();
    }
  }
}

template <typename T, int VB>
cudaError_t launch(const void* g, const void* x, const float* taps,
                   const float* a1, const float* b1, const float* psi_w,
                   const float* sc, void* out, int B, int H, int W, int C,
                   cudaStream_t s) {
  // tiles of at most kMaxTw columns of equal width, strips of kRows rows
  const int tiles_x = (W + kMaxTw - 1) / kMaxTw;
  const int tw = (W + tiles_x - 1) / tiles_x;
  const int tiles_y = (H + kRows - 1) / kRows;
  const long long blocks = (long long)B * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // two staging buffers
  const size_t smem = 2 * (size_t)kSR * kPitch * 2 * kChunk * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      lgag_kernel<T, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  lgag_kernel<T, VB><<<(int)blocks, kThreads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), taps, a1, b1, psi_w,
      sc, static_cast<T*>(out), H, W, C, tw, tiles_x, tiles_y);
  return cudaGetLastError();
}

// The widest item of 16, 8, 4 bytes that divides a pixel's bytes and aligns
// each pointer.
inline int item_bytes(long long pix_b, std::initializer_list<const void*> ptrs) {
  for (int VB = 16; VB > 4; VB >>= 1) {
    bool ok = pix_b % VB == 0;
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % VB == 0;
    if (ok) return VB;
  }
  return 4;
}

template <typename T>
cudaError_t launch_t(const void* g, const void* x, const float* taps,
                     const float* a1, const float* b1, const float* psi_w,
                     const float* sc, void* out, int B, int H, int W, int C,
                     cudaStream_t s) {
  const int VB = item_bytes((long long)C * sizeof(T), {g, x, out});
  if (VB == 16)
    return launch<T, 16>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W, C, s);
  if (VB == 8)
    return launch<T, 8>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W, C, s);
  return launch<T, 4>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W, C, s);
}

}  // namespace
}  // namespace ceigm

extern "C" int lgag_gate(const void* g, const void* x, const float* taps,
                         const float* a1, const float* b1,
                         const float* psi_w, const float* sc, void* out,
                         int B, int H, int W, int C, int dtype,
                         cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 2 != 0)
    return (int)cudaErrorInvalidValue;
  // items of 4 bytes or more: the wrapper aligns g and x
  for (const void* p : {g, x, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 4) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch_t<float>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W,
                                C, s);
  return (int)launch_t<bf16>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W, C,
                             s);
}
