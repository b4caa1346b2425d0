// Depthwise 3x3 'SAME' convolution plus bias over NHWC, and its transpose.
//
// Replaces: ceigm_unet_tpu/ops/quad_scan_bl.py _dwconv_bl_kernel (body
// _dw_body; entry dwconv_bl), forward and flip=True (the dx of
// _dwconv_bl_bwd). The TPU kernel works on batch-last (C, H, W, B) blocks,
// where each tap is a shift along H or W; here the layout is the quad
// block's own NHWC, read in place through strides (the block hands in a
// channel slice of its in-projection output, row stride 2*C).
//
//   dwconv3x3:      out[b,y,x,c] = bias[c] + sum_t w[t,c] * x[b,y+dy,x+dx,c]
//   dwconv3x3_flip: out[b,y,x,c] =           sum_t w[8-t,c] * g[b,y+dy,x+dx,c]
//
// with t = (dy+1)*3 + (dx+1) row-major over dy, dx in {-1, 0, 1}, zeros
// outside the image, fp32 accumulation starting from the bias (0 in flip
// mode), written in the input's dtype. Flip mode correlates with the taps
// turned by 180 degrees and no bias: the exact transpose of the forward,
// which is what _dwconv_bl_bwd uses for dx. w is (9, C) fp32 (torch's
// (C, 1, 3, 3) weight, transposed by the wrapper).
//
// What bounds it on the H100: memory. Each output reads one input value
// (the 8 neighbours come from shared memory) and does 9 FMAs; at b128 the
// 56x56, C 64 call moves ~100 MB in bf16. Design (the CustomFfn stencil's,
// csrc/cffn.cu): a block takes an 8x8 pixel tile of 32 channels, stages the
// 10x10 halo in shared memory with consecutive threads on consecutive
// channels of a pixel (coalesced under any pixel stride), then each of its
// 8 warps computes one tile row, a lane per channel, the 9 taps in
// registers.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kTile = 8;
constexpr int kCh = 32;
constexpr int kHalo = kTile + 2;

template <typename T, bool kFlip>
__global__ void __launch_bounds__(256)
dwconv3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               long long sb, long long sh, long long sw, int H, int W,
               int C) {
  __shared__ float tile[kHalo][kHalo][kCh];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int cb = blockIdx.y * kCh;
  const T* xb = x + blockIdx.z * sb;
  for (int e = threadIdx.x; e < kHalo * kHalo * kCh; e += 256) {
    const int cc = e % kCh, pix = e / kCh;
    const int yy = y0 + pix / kHalo - 1, xx = x0 + pix % kHalo - 1;
    tile[pix / kHalo][pix % kHalo][cc] =
        (yy >= 0 && yy < H && xx >= 0 && xx < W && cb + cc < C)
            ? to_f(xb[yy * sh + xx * sw + cb + cc]) : 0.f;
  }
  __syncthreads();
  const int c = cb + lane, y = y0 + row;
  if (c >= C || y >= H) return;
  float wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = w[(kFlip ? 8 - t : t) * C + c];
  const float b0 = kFlip ? 0.f : bias[c];
  T* ob = out + (((long long)blockIdx.z * H + y) * W) * C + c;
  for (int j = 0; j < kTile && x0 + j < W; ++j) {
    float acc = b0;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      acc = fmaf(wt[t], tile[row + t / 3][j + t % 3][lane], acc);
    ob[(long long)(x0 + j) * C] = from_f<T>(acc);
  }
}

template <typename T, bool kFlip>
cudaError_t launch(const void* x, const float* w, const float* bias,
                   void* out, long long sb, long long sh, long long sw,
                   int B, int H, int W, int C, cudaStream_t s) {
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile),
                  (C + kCh - 1) / kCh, B);
  dwconv3_kernel<T, kFlip><<<grid, 256, 0, s>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), sb, sh, sw,
      H, W, C);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int C) {
  return B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0;
}

}  // namespace
}  // namespace ceigm

// x (B, H, W, C) at element strides (sb, sh, sw, 1); out (B, H, W, C)
// contiguous, in x's dtype.
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
