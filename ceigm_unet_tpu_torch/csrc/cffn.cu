// CustomFfn: fc1 GEMM + b1 -> depthwise 3x3 + b -> GELU -> q + composite
// 7x7(q) + b -> fc2 GEMM + b2, as three kernels with an fp32 hidden.
//
// Replaces: ceigm_unet_tpu/ops/ffn_pallas.py _cffn_call / _cffn_kernel
// (with _dw_shift; entry custom_ffn_fused).
//
// The TPU kernel computes fc1 and fc2 inside its body; here they are the
// hand-written GEMM cffn_gemm (cffn_gemm.cu), and this file holds the two
// stencils between them. The hidden between the kernels is fp32, as in
// _cffn_kernel.
//
// What bounds the stencils on the H100: bytes (the fp32 hidden, 411 MB each
// way at 56x56, b128). Each block stages an 8x8-pixel, 32-channel halo tile
// in shared memory and reads every tap from there. Keeping the hidden out
// of HBM is later work.
//
// cffn_inception7 treats channels below n_id as the composite kernel's
// pure-identity channels (out = 2q + b), the channels the inception split
// passes through; the 49 taps run only on the last HID - n_id channels.
#include "common.cuh"

namespace ceigm {
namespace {

// Abramowitz-Stegun 7.1.26 erf GELU (ops/activations.py), fp32.
__device__ __forceinline__ float gelu_as(float x) {
  const float t0 = x * 0.7071067811865476f;
  const float s = t0 > 0.f ? 1.f : (t0 < 0.f ? -1.f : 0.f);
  const float t = fabsf(t0);
  const float u = 1.f / (1.f + 0.3275911f * t);
  const float p = u * (0.254829592f + u * (-0.284496736f + u * (1.421413741f +
                  u * (-1.453152027f + u * 1.061405429f))));
  const float erf = s * (1.f - p * expf(-t * t));
  return x * (0.5f + 0.5f * erf);
}

// Depthwise (2R+1)^2 stencil over NHWC fp32 (B, H, W, HID), 'same' zero
// padding. A block takes an 8x8 pixel tile of 32 channels: it stages the
// (8+2R)^2 halo in shared memory (coalesced 128-byte channel rows), then
// each warp computes one tile row for its 32 channels with the taps in
// registers. Channel blocks start at c_first; with kGelu the output is
// gelu(acc + bias), else in + acc + bias (the inception residual). Grid y
// beyond n_tap_blocks covers the identity channels [0, c_first), whose
// composite kernel is the centre tap alone: out = 2 in + bias.
constexpr int kTile = 8;

template <int R, bool kGelu>
__global__ void __launch_bounds__(256)
stencil_kernel(const float* __restrict__ in, const float* __restrict__ taps,
               const float* __restrict__ bias, float* __restrict__ out,
               int H, int W, int HID, int c_first, int n_tap_blocks) {
  constexpr int S = kTile + 2 * R, K = 2 * R + 1;
  __shared__ float tile[S][S][32];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const long long base = (long long)blockIdx.z * H * W * HID;
  const int y = y0 + row;
  if (blockIdx.y >= n_tap_blocks) {
    const int c = (blockIdx.y - n_tap_blocks) * 32 + lane;
    if (c >= c_first || y >= H) return;
    for (int x = x0; x < min(x0 + kTile, W); ++x) {
      const long long i = base + ((long long)y * W + x) * HID + c;
      out[i] = 2.f * in[i] + bias[c];
    }
    return;
  }
  const int cb = c_first + blockIdx.y * 32;
  for (int e = threadIdx.x; e < S * S * 32; e += 256) {
    const int cc = e & 31, pix = e >> 5;
    const int sy = pix / S, sx = pix % S;
    const int yy = y0 + sy - R, xx = x0 + sx - R;
    tile[sy][sx][cc] = (yy >= 0 && yy < H && xx >= 0 && xx < W &&
                        cb + cc < HID)
        ? in[base + ((long long)yy * W + xx) * HID + cb + cc] : 0.f;
  }
  __syncthreads();
  const int c = cb + lane;
  if (c >= HID || y >= H) return;
  float w[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) w[t] = taps[t * HID + c];
  const float bc = bias[c];
  for (int j = 0; j < kTile && x0 + j < W; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
        acc += tile[row + ky][j + kx][lane] * w[ky * K + kx];
    const long long i = base + ((long long)y * W + x0 + j) * HID + c;
    out[i] = kGelu ? gelu_as(acc + bc) : tile[row + R][j + R][lane] + acc + bc;
  }
}

template <int R, bool kGelu>
cudaError_t stencil(const float* in, const float* taps, const float* bias,
                    float* out, int B, int H, int W, int HID, int c_first,
                    cudaStream_t s) {
  const int tap_blocks = (HID - c_first + 31) / 32;
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile),
                  tap_blocks + (c_first + 31) / 32, B);
  stencil_kernel<R, kGelu><<<grid, 256, 0, s>>>(in, taps, bias, out, H, W,
                                                HID, c_first, tap_blocks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int cffn_dw3_gelu(const float* h, const float* dwk,
                             const float* dwb, float* q, int B, int H, int W,
                             int HID, cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || H <= 0 || W <= 0 || HID <= 0) return (int)cudaErrorInvalidValue;
  return (int)stencil<1, true>(h, dwk, dwb, q, B, H, W, HID, 0, s);
}

extern "C" int cffn_inception7(const float* q, const float* inck,
                               const float* incb, float* out, int B, int H,
                               int W, int HID, int n_id, cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || H <= 0 || W <= 0 || HID <= 0 || n_id < 0 || n_id > HID)
    return (int)cudaErrorInvalidValue;
  return (int)stencil<3, false>(q, inck, incb, out, B, H, W, HID, n_id, s);
}
