// DySample's grouped bilinear grid-sample (align_corners=False, border
// clamp), one grid per group of C/g consecutive channels; and the same op
// with one grid for all channels, for any output size.
//
// Replaces: ceigm_unet_tpu/ops/grid_sample.py:432 _gs_banded_groups_impl
// (via _gs_banded_groups; entry dysample_grid_sample) as
// dysample_grid_sample, and the single-grid kernels of
// grid_sample_bilinear_fused, :527 _gs_banded_impl (2x outputs, banded) and
// :259 _gs_fused_impl (any output size, dense), as grid_sample_bilinear:
// the same device code with g = 1.
//
// The TPU kernels build hat-weight tiles and contract them against the
// image (or an input band) on the MXU, with the hat weights rounded to
// bf16, and the banded ones clamp coordinates that leave their band. This
// kernel computes the exact op (grid_sample_bilinear) at any offset: four
// taps per output element, unnormalised and clamped as in
// grid_sample_bilinear, weights and interpolation in fp32, written in x's
// dtype. It copies neither the band clamp nor the bf16 hat weights.
//
// What bounds it on the H100: memory. The op writes each output once and
// reads the input a few times over (neighbouring outputs share taps, so
// most tap reads hit L1/L2); at b128 bf16 the three DySample calls move
// ~260 MB, ~78 us at 3.35 TB/s. Its instruction count comes close behind:
// ~10 per bf16 output element for the four taps' conversion and the
// interpolation alone. A thread per output element would pay the index
// divisions and the whole coordinate computation per element and move 2
// bytes per access (~200 instructions per element with 64-bit indices).
//
// Design: a block takes a run of P consecutive output pixels (b, oy, ox)
// across all C channels, ~kItems (pixel, item) pairs.
// 1. Its threads compute, once per (pixel, group), the clamped tap offsets
//    (32-bit, within one image) and the two weights into shared memory,
//    and once per pixel the image's 64-bit base offset. Each thread starts
//    all its grid loads before it uses any: one round trip per block.
// 2. Its threads then walk (pixel, item) pairs, an item being 16 bytes of
//    channels (V of them; 4 channels where only one-element access is
//    aligned), read and written A channels per access: 16, 8 or 4 bytes
//    where the row pitch and both pointers allow, else one element. The
//    last item of a pixel is cut at C. No division per element: item ->
//    (pixel, item) and channel -> group by multiply-shift.
// An item that straddles two groups (cg not a multiple of V) loads the
// second group's taps as well and takes each element from its own group.
// Groups narrower than an item take one channel per item.
// At most 64 registers, so four 256-thread blocks share an SM: other
// blocks' loads hide each block's two round trips to memory.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;         // resident blocks per SM: <= 64 regs
constexpr int kItems = 8 * kThreads;  // (pixel, item) pairs per block
constexpr int kGridLoads = 8;         // grid entries a thread loads at once
constexpr int kSmemBytes = 48 * 1024;

// n / d for 0 <= n < 2^31 by multiply and shift (Granlund-Montgomery, as
// PyTorch's IntDivider)
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the four taps of channels [c0, c0 + V) at offsets o from xb, A channels
// per access; accesses at or past `left` (= C - c0) are skipped
template <typename T, int V, int A>
__device__ __forceinline__ void load_taps(Vec<T, V> (&t)[4], const T* xb,
                                          int4 o, int left) {
  const T* p[4] = {xb + o.x + o.z, xb + o.x + o.w, xb + o.y + o.z,
                   xb + o.y + o.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int a = 0; a < V; a += A)
      if (a < left)
        *reinterpret_cast<Vec<T, A>*>(&t[k].v[a]) =
            *reinterpret_cast<const Vec<T, A>*>(p[k] + a);
}

template <typename T, int V, int A>
__device__ __forceinline__ void store(T* dst, const Vec<T, V>& r,
                                      int left) {
#pragma unroll
  for (int a = 0; a < V; a += A)
    if (a < left)
      *reinterpret_cast<Vec<T, A>*>(dst + a) =
          *reinterpret_cast<const Vec<T, A>*>(&r.v[a]);
}

// elements j0.. of one tap set's bilinear combination, as
// grid_sample_bilinear, into r
template <typename T, int V>
__device__ __forceinline__ void combine(Vec<T, V>& r,
                                        const Vec<T, V> (&t)[4], float2 w,
                                        int j0) {
  const float ax = 1.f - w.x, ay = 1.f - w.y;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < j0) continue;
    const float top = to_f(t[0].v[j]) * ax + to_f(t[1].v[j]) * w.x;
    const float bot = to_f(t[2].v[j]) * ax + to_f(t[3].v[j]) * w.x;
    r.v[j] = from_f<T>(top * ay + bot * w.y);
  }
}

// x (B, H, W, C), grid (B*Ho*Wo, g, 2) -> out (B*Ho*Wo, C); P pixels per
// block; items of V channels, A per access (V % A == 0, C % A == 0; the
// last item of a pixel is cut at C). Shared memory: per (pixel, group) the
// tap offsets (y0*W*C, y1*W*C, x0*C, x1*C) and weights (wx, wy); per pixel
// the image's base offset. kStraddle: cg is not a multiple of V, so an
// item may span two groups (never more: cg >= V).
template <typename T, int V, int A, bool kStraddle>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    grid_sample_kernel(const T* __restrict__ x,
                       const float* __restrict__ grid, T* __restrict__ out,
                       int H, int W, int C, int HoWo, int npix, int g, int P,
                       FastDiv div_nv, FastDiv div_cg) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* offs = reinterpret_cast<int4*>(smem);
  float2* wts = reinterpret_cast<float2*>(offs + P * g);
  long long* base = reinterpret_cast<long long*>(wts + P * g);

  const int p0 = blockIdx.x * P;
  const int np = min(P, npix - p0);
  const int WC = W * C;
  const float* gb = grid + (long long)p0 * g * 2;
  // all of a thread's grid loads are started before any is used: one
  // round trip to memory per block
  for (int t0 = threadIdx.x; t0 < np * g; t0 += kThreads * kGridLoads) {
    float2 gv[kGridLoads];
#pragma unroll
    for (int k = 0; k < kGridLoads; ++k) {
      const int t = t0 + k * kThreads;
      if (t < np * g) gv[k] = make_float2(gb[2 * t], gb[2 * t + 1]);
    }
#pragma unroll
    for (int k = 0; k < kGridLoads; ++k) {
      const int t = t0 + k * kThreads;
      if (t >= np * g) break;
      float gx = (gv[k].x + 1.f) * (float)W / 2.f - 0.5f;
      float gy = (gv[k].y + 1.f) * (float)H / 2.f - 0.5f;
      gx = fminf(fmaxf(gx, 0.f), (float)(W - 1));
      gy = fminf(fmaxf(gy, 0.f), (float)(H - 1));
      const float x0 = floorf(gx), y0 = floorf(gy);
      const int x0i = min(max((int)x0, 0), W - 1);
      const int y0i = min(max((int)y0, 0), H - 1);
      offs[t] = make_int4(y0i * WC, min(y0i + 1, H - 1) * WC, x0i * C,
                          min(x0i + 1, W - 1) * C);
      wts[t] = make_float2(gx - x0, gy - y0);
    }
  }
  for (int t = threadIdx.x; t < np; t += kThreads)
    base[t] = (long long)((p0 + t) / HoWo) * H * WC;
  __syncthreads();

  const int nv = (int)div_nv.d, cg = (int)div_cg.d;
  T* outb = out + (long long)p0 * C;
  typedef Vec<T, V> VT;
  for (int i = threadIdx.x; i < np * nv; i += kThreads) {
    const int lp = (int)fdiv((unsigned)i, div_nv);
    const int c0 = (i - lp * nv) * V, left = C - c0;
    const int grp = g > 1 ? (int)fdiv((unsigned)c0, div_cg) : 0;
    const int e = lp * g + grp;
    const T* xb = x + base[lp] + c0;
    VT taps[4], r;
    load_taps<T, V, A>(taps, xb, offs[e], left);
    combine<T, V>(r, taps, wts[e], 0);
    if (kStraddle) {
      // channels past the end of group grp take the next group's taps
      const int split = (grp + 1) * cg - c0;
      if (split < V && split < left) {
        load_taps<T, V, A>(taps, xb, offs[e + 1], left);
        combine<T, V>(r, taps, wts[e + 1], split);
      }
    }
    store<T, V, A>(outb + (long long)lp * C + c0, r, left);
  }
}

// the current device's SM count, read once per device
int sm_count() {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (!sms[dev]) {
    int n = 132;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n;
  }
  return sms[dev];
}

template <typename T, int V, int A, bool kStraddle>
cudaError_t launch_va(const T* x, const float* grid, T* out, int H, int W,
                      int C, int HoWo, int npix, int g, cudaStream_t s) {
  const int nv = (C + V - 1) / V;
  // ~kItems items per block, within the shared memory
  const int per_pix = g * (int)(sizeof(int4) + sizeof(float2)) + 8;
  int P = max(1, min(kItems / nv, kSmemBytes / per_pix));
  // but at least two waves of resident blocks where the pixels allow
  P = max(1, min(P, npix / (2 * kMinBlocks * sm_count())));
  const unsigned blocks = (unsigned)(((long long)npix + P - 1) / P);
  grid_sample_kernel<T, V, A, kStraddle>
      <<<blocks, kThreads, (size_t)P * per_pix, s>>>(
          x, grid, out, H, W, C, HoWo, npix, g, P, make_div(nv),
          make_div(C / g));
  return cudaGetLastError();
}

template <typename T, int V, int A>
cudaError_t launch_v(const T* x, const float* grid, T* out, int H, int W,
                     int C, int HoWo, int npix, int g, cudaStream_t s) {
  if constexpr (V > 1)
    if (g > 1 && (C / g) % V)
      return launch_va<T, V, A, true>(x, grid, out, H, W, C, HoWo, npix, g,
                                      s);
  return launch_va<T, V, A, false>(x, grid, out, H, W, C, HoWo, npix, g, s);
}

// Items of 16 bytes (4 elements where only one-element access is aligned),
// accessed as widely as the row pitch and both pointers allow (16, 8, 4
// bytes, else one element); one element per item where groups are
// narrower than an item.
template <typename T>
cudaError_t launch(const void* xv, const float* grid, void* outv, int B,
                   int H, int W, int C, int Ho, int Wo, int g,
                   cudaStream_t s) {
  const long long npix = (long long)B * Ho * Wo;
  // 32-bit pixel indices and in-image offsets; the image base is 64-bit
  if (H <= 0 || W <= 0 || C <= 0 || npix <= 0 || npix >= (1LL << 31)
      || (long long)H * W * C >= (1LL << 31))
    return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int HoWo = Ho * Wo, n = (int)npix;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(xv)
                         | reinterpret_cast<uintptr_t>(outv);
  int bytes = 16;
  while (bytes > (int)sizeof(T)
         && ((C * sizeof(T)) % bytes || ptrs % bytes))
    bytes /= 2;
  constexpr int v16 = 16 / sizeof(T);
  const int vec = bytes == (int)sizeof(T) ? 4 : v16;
  if (g > 1 && C / g < vec)
    return launch_v<T, 1, 1>(x, grid, out, H, W, C, HoWo, n, g, s);
  if (bytes == 16)
    return launch_v<T, v16, v16>(x, grid, out, H, W, C, HoWo, n, g, s);
  if (bytes == 8)
    return launch_v<T, v16, v16 / 2>(x, grid, out, H, W, C, HoWo, n, g, s);
  if constexpr (sizeof(T) == 2)
    if (bytes == 4)
      return launch_v<T, v16, 2>(x, grid, out, H, W, C, HoWo, n, g, s);
  return launch_v<T, 4, 1>(x, grid, out, H, W, C, HoWo, n, g, s);
}

}  // namespace
}  // namespace ceigm

extern "C" int dysample_grid_sample(const void* x, const float* grid,
                                    void* out, int B, int H, int W, int C,
                                    int Ho, int Wo, int g, int dtype,
                                    cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || g <= 0 || C % g != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch<float>(x, grid, out, B, H, W, C, Ho, Wo, g, s);
  return (int)launch<bf16>(x, grid, out, B, H, W, C, Ho, Wo, g, s);
}

// x (B, H, W, C), grid (B, Ho, Wo, 2) -> out (B, Ho, Wo, C): one grid for
// every channel, any output size.
extern "C" int grid_sample_bilinear(const void* x, const float* grid,
                                    void* out, int B, int H, int W, int C,
                                    int Ho, int Wo, int dtype,
                                    cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || C <= 0 || Ho <= 0 || Wo <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch<float>(x, grid, out, B, H, W, C, Ho, Wo, 1, s);
  return (int)launch<bf16>(x, grid, out, B, H, W, C, Ho, Wo, 1, s);
}
