// Fused eval-mode LGAG attention gate: x * psi with
//   psi = sigmoid(a2 * (sum_c2 relu(a1*conv(g) + b1) * psi_w + psi_b) + c2)
// where conv is the six grouped 2-in/1-out convs (k 1/3/5, both branches
// reading g) folded on the host into one 5x5x2xC2 tap stack, and a1/b1,
// a2/c2 the folded batch norms (ops/tapconv.py lgag_gate_eval).
//
// Replaces: ceigm_unet_tpu/ops/tapconv.py _lgag_call / _lgag_kernel (entry
// lgag_gate_eval).
//
// What bounds it on the H100: per pixel it does 50*C2 FMAs and reads the
// 5x5 neighbourhood of g (C channels each, mostly cache hits) plus x, and
// writes C values: ~3 bytes of HBM traffic per FLOP at C=64, so memory and
// cache bandwidth bound it. Design: one warp per pixel; lane l takes the
// output channels c2 = l, l+32, ... and reads g's channel pair (2*c2,
// 2*c2+1) at each tap, so a warp's tap reads are one contiguous row of the
// pixel's C channels. The psi reduction over c2 is a warp shuffle, and the
// same warp then writes x*psi for all C channels of the pixel. Taps and
// arithmetic are fp32.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lgag_kernel(const T* __restrict__ g, const T* __restrict__ x,
            const float* __restrict__ taps, const float* __restrict__ a1,
            const float* __restrict__ b1, const float* __restrict__ psi_w,
            const float* __restrict__ sc, T* __restrict__ out, int B, int H,
            int W, int C) {
  const int lane = threadIdx.x & 31;
  const long long pix = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long L = (long long)H * W;
  if (pix >= B * L) return;
  const long long b = pix / L;
  const int p = pix % L, y = p / W, xq = p % W;
  const int C2 = C / 2;
  float part = 0.f;
  for (int c2 = lane; c2 < C2; c2 += 32) {
    float acc = 0.f;
    for (int ky = 0; ky < 5; ++ky) {
      const int yy = y + ky - 2;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 5; ++kx) {
        const int xx = xq + kx - 2;
        if (xx < 0 || xx >= W) continue;
        const T* gp = g + ((b * H + yy) * W + xx) * C + 2 * c2;
        const float* tp = taps + ((ky * 5 + kx) * 2) * C2 + c2;
        acc += to_f(gp[0]) * tp[0] + to_f(gp[1]) * tp[C2];
      }
    }
    part += fmaxf(acc * a1[c2] + b1[c2], 0.f) * psi_w[c2];
  }
  part = warp_sum(part);
  // sc = [psi_b, a2, c2]: psi conv bias and the folded psi batch norm
  const float psi = 1.f / (1.f + expf(-(sc[1] * (part + sc[0]) + sc[2])));
  const T* xp = x + pix * C;
  T* op = out + pix * C;
  for (int c = lane; c < C; c += 32) op[c] = from_f<T>(to_f(xp[c]) * psi);
}

template <typename T>
cudaError_t launch(const void* g, const void* x, const float* taps,
                   const float* a1, const float* b1, const float* psi_w,
                   const float* sc, void* out, int B, int H, int W, int C,
                   cudaStream_t s) {
  const long long pixels = (long long)B * H * W;
  const int blocks = (int)((pixels + kWarps - 1) / kWarps);
  lgag_kernel<T><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), taps, a1, b1, psi_w,
      sc, static_cast<T*>(out), B, H, W, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int lgag_gate(const void* g, const void* x, const float* taps,
                         const float* a1, const float* b1,
                         const float* psi_w, const float* sc, void* out,
                         int B, int H, int W, int C, int dtype,
                         cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || C % 2 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return (int)launch<float>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W, C,
                              s);
  return (int)launch<bf16>(g, x, taps, a1, b1, psi_w, sc, out, B, H, W, C, s);
}
