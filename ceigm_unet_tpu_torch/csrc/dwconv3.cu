// Depthwise 3x3 'SAME' convolution plus bias over NHWC, and its transpose.
//
// Replaces: ceigm_unet_tpu/ops/quad_scan_bl.py _dwconv_bl_kernel (body
// _dw_body; entry dwconv_bl), forward and flip=True (the dx of
// _dwconv_bl_bwd). The TPU kernel works on batch-last (C, H, W, B) blocks,
// where each tap is a shift along H or W; here the layout is the quad
// block's own NHWC, read in place through strides (the block hands in a
// channel slice of its in-projection output, row stride 2*C).
//
//   dwconv3x3:      out[b,y,x,c] = bias[c] + sum_t w[c,t] * x[b,y+dy,x+dx,c]
//   dwconv3x3_flip: out[b,y,x,c] =           sum_t w[c,8-t] * g[b,y+dy,x+dx,c]
//
// with t = (dy+1)*3 + (dx+1) row-major over dy, dx in {-1, 0, 1}, zeros
// outside the image, fp32 accumulation starting from the bias (0 in flip
// mode) in tap order, written in the input's dtype. Flip mode correlates
// with the taps turned by 180 degrees and no bias: the exact transpose of
// the forward, which is what _dwconv_bl_bwd uses for dx. w is torch's
// (C, 1, 3, 3) fp32 weight as it is stored, read as (C, 9).
//
// What bounds it on the H100: memory. Each output reads one input value and
// does 9 FMAs; at b128 the 56x56, C 64 call moves ~100 MB in bf16 (30.7 us
// at 3.35 TB/s). Design: a thread owns one item (8 bytes of a pixel's
// channels: 4 in bf16, 2 in fp32) of one column and a strip of kR = 7
// output rows (every gm_tiny side is a multiple of 7). It first issues
// every load of its strip at once, the 3 x (kR + 2) items of input rows
// y0-1 .. y0+kR at columns x-1, x, x+1 (the neighbours are the
// neighbouring threads' items, read again through L1), so each thread has
// ~27 loads in flight instead of one row's. Then it walks the rows: input
// row r starts the accumulator of output row r+1 from the bias with taps
// 0-2, adds taps 3-5 to row r and completes row r-1 with taps 6-8, which is
// stored; three rows of accumulators stay in registers and the sum runs in
// tap order. Its 9 taps per channel are consecutive floats of torch's
// (C, 9) weight, loaded once and kept in registers with the bias; there is
// no shared memory and no barrier. Consecutive threads take consecutive
// items of a pixel, then the next column, so a warp's access is contiguous
// under any pixel stride. Items are read and written as one 8-byte access
// when the pointers, the pixel strides and C allow it (every gm_tiny
// shape), else element by element, the last item cut at C. The item stays
// at 8 bytes where a pitch allows 16: a bf16 thread then keeps 36 taps and
// 54 registers of loads in flight, inside 128 registers at 16 warps per SM.
//
// Versions (b128 bf16 gm_tiny, device time per forward / per backward,
// bound 0.381 ms each; kernel_ab with the parent in the same call, on an
// H100 80GB HBM3 at 700 W): a block per 8x8 pixel tile of 32 channels
// staging the 10x10 halo in shared memory as fp32 (one 2-byte load, a
// divide and a modulo per element, a barrier per tile; the taps transposed
// to (9, C) by the wrapper on every call) 1.964 / 1.919 ms; this design
// with each row loaded only when reached (one row's 3 loads in flight per
// thread; latency-bound, ~0.7 us per row) 1.096 / 1.035; every load of the
// strip first 0.597 / 0.575 (strips of 4 rows: 0.726 / 0.700; without the
// 2-blocks-per-SM register cap: 0.599 / 0.577).
#include "common.cuh"

namespace ceigm {
namespace {

// An item: 8 bytes of one pixel's channels, 4 bf16 or 2 fp32.
constexpr int kItemBytes = 8;
constexpr int kR = 7;          // output rows per thread (a strip)
constexpr int kThreads = 256;

template <typename T> struct Dw3 {
  static constexpr int kV = kItemBytes / sizeof(T);   // channels per item
};

// One item's raw bits, loaded as one 8-byte access (kVec) or element by
// element (n valid channels, zeros past them).
template <typename T, bool kVec>
__device__ __forceinline__ uint2 load_item(const T* p, int n) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    uint2 q = make_uint2(0u, 0u);
    if constexpr (sizeof(T) == 4) {
      if (n > 0) q.x = __float_as_uint(to_f(p[0]));
      if (n > 1) q.y = __float_as_uint(to_f(p[1]));
    } else {
      unsigned e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = j < n ? (unsigned)__bfloat16_as_ushort(p[j]) : 0u;
      q.x = e[0] | (e[1] << 16);
      q.y = e[2] | (e[3] << 16);
    }
    return q;
  }
}

template <typename T>
__device__ __forceinline__ void unpack(uint2 q, float (&v)[Dw3<T>::kV]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
  } else {
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_item(T* p, int n,
                                           const float (&v)[Dw3<T>::kV]) {
  constexpr int kV = Dw3<T>::kV;
  if constexpr (kVec) {
    uint2 q;
    if constexpr (sizeof(T) == 4) {
      q = make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      q.x = *reinterpret_cast<const unsigned*>(&lo);
      q.y = *reinterpret_cast<const unsigned*>(&hi);
    }
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (j < n) p[j] = from_f<T>(v[j]);
  }
}

struct Dw3Args {
  const void* x; const float* w; const float* bias; void* out;
  long long sb, sh, sw;
  int H, W, C, items, strips, threads;
};

// taps for output row y from input row y+dy (dy = -1, 0, 1 -> t0 = 0, 3,
// 6): acc = fma(w[t0+2], right, fma(w[t0+1], mid, fma(w[t0], left, acc)))
// (flip mode: w[8-t] for w[t])
template <bool kFlip, int kV>
__device__ __forceinline__ void add_row(float (&acc)[kV],
                                        const float (&wt)[kV][9], int t0,
                                        const float (&l)[kV],
                                        const float (&m)[kV],
                                        const float (&r)[kV]) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int a = kFlip ? 8 - t0 : t0;
    const int s = kFlip ? -1 : 1;
    float v = acc[j];
    v = fmaf(wt[j][a], l[j], v);
    v = fmaf(wt[j][a + s], m[j], v);
    v = fmaf(wt[j][a + 2 * s], r[j], v);
    acc[j] = v;
  }
}

template <typename T, bool kFlip, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dwconv3_kernel(Dw3Args a) {
  constexpr int kV = Dw3<T>::kV;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= a.threads) return;
  const int item = tid % a.items;
  int rest = tid / a.items;
  const int x = rest % a.W;
  rest /= a.W;
  const int strip = rest % a.strips;
  const long long b = rest / a.strips;
  const int H = a.H, W = a.W, C = a.C;
  const int c0 = item * kV;
  const int n = min(kV, C - c0);
  const int y0 = strip * kR;

  // 1. every load of the strip at once: input rows y0-1 .. y0+kR, columns
  // x-1, x, x+1 (zeros outside the image)
  const T* xp = static_cast<const T*>(a.x) + b * a.sb + (long long)x * a.sw
                + c0;
  const bool has_l = x > 0, has_r = x + 1 < W;
  uint2 raw[kR + 2][3];
#pragma unroll
  for (int j = 0; j < kR + 2; ++j) {
    const int r = y0 - 1 + j;
    const bool in = r >= 0 && r < H;
    const T* p = xp + (long long)r * a.sh;
    raw[j][0] = in && has_l ? load_item<T, kVec>(p - a.sw, n)
                            : make_uint2(0u, 0u);
    raw[j][1] = in ? load_item<T, kVec>(p, n) : make_uint2(0u, 0u);
    raw[j][2] = in && has_r ? load_item<T, kVec>(p + a.sw, n)
                            : make_uint2(0u, 0u);
  }

  // 2. this thread's 9*kV taps: floats c0*9 .. of the (C, 9) weight,
  // consecutive (16-byte loads when the item is whole and aligned)
  float wt[kV][9];
  const float* wp = a.w + (long long)c0 * 9;
  bool whole = false;
  if constexpr ((kV * 9) % 4 == 0)
    whole = n == kV && (reinterpret_cast<uintptr_t>(wp) & 15) == 0;
  if (whole) {
#pragma unroll
    for (int q = 0; q < kV * 9 / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(wp) + q);
      const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) wt[(4 * q + i) / 9][(4 * q + i) % 9] = e[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        wt[j][t] = j < n ? __ldg(wp + j * 9 + t) : 0.f;
  }
  float b0[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j)
    b0[j] = (!kFlip && j < n) ? __ldg(a.bias + c0 + j) : 0.f;

  // 3. the rows in order: input row r starts output row r+1 (taps 0-2,
  // from the bias), adds to row r (taps 3-5) and completes row r-1 (taps
  // 6-8), which is stored; acc[(y - y0 + 1) % 3] holds output row y
  T* op = static_cast<T*>(a.out) + ((b * H) * W + x) * (long long)C + c0;
  const long long rowC = (long long)W * C;
  float acc[3][kV];
#pragma unroll
  for (int j = 0; j < kR + 2; ++j) {
    const int r = y0 - 1 + j;
    if (j >= 2 && r - 1 >= H) return;        // no output row r - 1
    float l[kV], m[kV], rr[kV];
    unpack<T>(raw[j][0], l);
    unpack<T>(raw[j][1], m);
    unpack<T>(raw[j][2], rr);
    if (j < kR) {
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[(j + 1) % 3][i] = b0[i];
      add_row<kFlip, kV>(acc[(j + 1) % 3], wt, 0, l, m, rr);
    }
    if (j >= 1 && j <= kR)
      add_row<kFlip, kV>(acc[j % 3], wt, 3, l, m, rr);
    if (j >= 2) {
      add_row<kFlip, kV>(acc[(j - 1) % 3], wt, 6, l, m, rr);
      store_item<T, kVec>(op + (r - 1) * rowC, n, acc[(j - 1) % 3]);
    }
  }
}

template <typename T, bool kFlip>
cudaError_t launch(const void* x, const float* w, const float* bias,
                   void* out, long long sb, long long sh, long long sw,
                   int B, int H, int W, int C, cudaStream_t s) {
  const int items = (C + Dw3<T>::kV - 1) / Dw3<T>::kV;
  const int strips = (H + kR - 1) / kR;
  const long long threads = (long long)B * strips * W * items;
  if (threads > 0x7fffffffLL - kThreads) return cudaErrorInvalidValue;
  Dw3Args a{x, w, bias, out, sb, sh, sw, H, W, C, items, strips,
            (int)threads};
  const int blocks = (a.threads + kThreads - 1) / kThreads;
  // one 8-byte access per item: C a multiple of the item, and every pixel
  // of x and of out, with both base pointers, aligned to it
  const long long vb = kItemBytes;
  const bool vec = C % Dw3<T>::kV == 0
      && reinterpret_cast<uintptr_t>(x) % vb == 0
      && reinterpret_cast<uintptr_t>(out) % vb == 0
      && (sb * (long long)sizeof(T)) % vb == 0
      && (sh * (long long)sizeof(T)) % vb == 0
      && (sw * (long long)sizeof(T)) % vb == 0;
  if (vec)
    dwconv3_kernel<T, kFlip, true><<<blocks, kThreads, 0, s>>>(a);
  else
    dwconv3_kernel<T, kFlip, false><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int C) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0;
}

}  // namespace
}  // namespace ceigm

// x (B, H, W, C) at element strides (sb, sh, sw, 1); w torch's (C, 1, 3, 3)
// fp32 weight, contiguous; bias (C,) fp32; out (B, H, W, C) contiguous, in
// x's dtype.
extern "C" int dwconv3x3(const void* x, const float* w, const float* bias,
                         void* out, long long sb, long long sh, long long sw,
                         int B, int H, int W, int C, int dtype,
                         cudaStream_t s) {
  using namespace ceigm;
  if (bad_shape(B, H, W, C)) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch<float, false>(x, w, bias, out, sb, sh, sw, B, H, W,
                                     C, s);
  return (int)launch<bf16, false>(x, w, bias, out, sb, sh, sw, B, H, W, C,
                                  s);
}

// The transpose of dwconv3x3 (no bias): g at strides (sb, sh, sw, 1).
extern "C" int dwconv3x3_flip(const void* g, const float* w, void* out,
                              long long sb, long long sh, long long sw,
                              int B, int H, int W, int C, int dtype,
                              cudaStream_t s) {
  using namespace ceigm;
  if (bad_shape(B, H, W, C)) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch<float, true>(g, w, nullptr, out, sb, sh, sw, B, H, W,
                                    C, s);
  return (int)launch<bf16, true>(g, w, nullptr, out, sb, sh, sw, B, H, W, C,
                                 s);
}
