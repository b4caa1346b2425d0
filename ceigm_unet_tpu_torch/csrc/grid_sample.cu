// DySample's grouped bilinear grid-sample (align_corners=False, border
// clamp), one grid per group of C/g consecutive channels.
//
// Replaces: ceigm_unet_tpu/ops/grid_sample.py _gs_banded_groups_impl (via
// _gs_banded_groups; entry dysample_grid_sample).
//
// The TPU kernel builds hat-weight tiles and contracts them against an
// input band on the MXU, and clamps coordinates that leave its band. This
// kernel computes the exact op (grid_sample_bilinear) at any offset: four
// taps per output element, unnormalised and clamped as in
// grid_sample_bilinear, interpolated in fp32, written in x's dtype.
//
// What bounds it on the H100: memory. Each output element reads 4 input
// values (mostly L1/L2 hits, neighbouring outputs share taps) and 2 grid
// coordinates; at b128, 28->56, C=128 the op writes ~100 MB in bf16.
// Design: one thread per output element (b, oy, ox, c) with c fastest, so
// a warp reads consecutive channels of the same input pixels and all
// threads of a group read the same coordinate pair (a broadcast).
#include "common.cuh"

namespace ceigm {
namespace {

template <typename T>
__global__ void dysample_gs_kernel(const T* __restrict__ x,
                                   const float* __restrict__ grid,
                                   T* __restrict__ out, int B, int H, int W,
                                   int C, int Ho, int Wo, int g) {
  const long long total = (long long)B * Ho * Wo * C;
  const int cg = C / g;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = i % C;
    const long long pix = i / C;               // (b, oy, ox) flat
    const long long b = pix / ((long long)Ho * Wo);
    const float* gp = grid + (pix * g + c / cg) * 2;
    float gx = (gp[0] + 1.f) * (float)W / 2.f - 0.5f;
    float gy = (gp[1] + 1.f) * (float)H / 2.f - 0.5f;
    gx = fminf(fmaxf(gx, 0.f), (float)(W - 1));
    gy = fminf(fmaxf(gy, 0.f), (float)(H - 1));
    const float x0 = floorf(gx), y0 = floorf(gy);
    const float wx = gx - x0, wy = gy - y0;
    const int x0i = min(max((int)x0, 0), W - 1), x1i = min(x0i + 1, W - 1);
    const int y0i = min(max((int)y0, 0), H - 1), y1i = min(y0i + 1, H - 1);
    const T* xb = x + b * H * W * (long long)C + c;
    const float v00 = to_f(xb[((long long)y0i * W + x0i) * C]);
    const float v01 = to_f(xb[((long long)y0i * W + x1i) * C]);
    const float v10 = to_f(xb[((long long)y1i * W + x0i) * C]);
    const float v11 = to_f(xb[((long long)y1i * W + x1i) * C]);
    const float top = v00 * (1.f - wx) + v01 * wx;
    const float bot = v10 * (1.f - wx) + v11 * wx;
    out[i] = from_f<T>(top * (1.f - wy) + bot * wy);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* grid, void* out, int B, int H,
                   int W, int C, int Ho, int Wo, int g, cudaStream_t s) {
  const long long total = (long long)B * Ho * Wo * C;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  dysample_gs_kernel<T><<<(int)blocks, 256, 0, s>>>(
      static_cast<const T*>(x), grid, static_cast<T*>(out), B, H, W, C, Ho,
      Wo, g);
  return cudaGetLastError();
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
