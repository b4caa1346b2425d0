// CustomFfn: fc1 GEMM + b1 -> depthwise 3x3 + b -> GELU -> q + composite
// 7x7(q) + b -> fc2 GEMM + b2, as three kernels with an fp32 hidden.
//
// Replaces: ceigm_unet_tpu/ops/ffn_pallas.py _cffn_call / _cffn_kernel
// (with _dw_shift; entry custom_ffn_fused).
//
// The TPU kernel computes fc1 and fc2 inside its body, so here they are a
// hand-written tiled GEMM (cffn_gemm) and not a library call. The hidden
// between the kernels is fp32, as in _cffn_kernel: fc1 reads x and w1 in
// the compute dtype and writes fp32; fc2 rounds the fp32 hidden to the
// compute dtype on load (q.astype(w2.dtype) in the TPU kernel) and writes
// the compute dtype.
//
// What bounds it on the H100: fc1/fc2 are ~250 GFLOP per b128 forward over
// the 7 decoder blocks, so the GEMMs bound the op; the two stencils move
// the fp32 hidden (411 MB each way at 56x56, b128) and are bandwidth bound.
// Design for this first version: with bf16 weights (the bf16 regime) a
// 64x64x32 shared-memory tiled GEMM on the tensor cores through WMMA
// (mma.sync 16x16x16 bf16, fp32 accumulate, 4 warps of 32x32); with fp32
// weights a 64x64x16 tiled GEMM on the fp32 FMA pipes (4x4 outputs per
// thread). The stencils stage an 8x8-pixel, 32-channel halo tile in shared
// memory and read every tap from there. wgmma/TMA pipelines and keeping the
// hidden out of HBM are later work.
//
// cffn_inception7 treats channels below n_id as the composite kernel's
// pure-identity channels (out = 2q + b), the channels the inception split
// passes through; the 49 taps run only on the last HID - n_id channels.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace ceigm {
namespace {

constexpr int BM = 64, BN = 64, BK = 16;

// C[M, N] = round_TW(A[M, K]) @ Wt[K, N] + bias[N], fp32 accumulation
// on the FMA pipes (fp32 weights).
template <typename TA, typename TW, typename TO>
__global__ void __launch_bounds__(256)
gemm_bias_kernel(const TA* __restrict__ A, const TW* __restrict__ Wt,
                 const float* __restrict__ bias, TO* __restrict__ C, int M,
                 int N, int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * 256;          // 0..1023
      const int am = e / BK, ak = e % BK;   // A tile 64 x 16
      const int gm = m0 + am, gk = k0 + ak;
      float v = 0.f;
      if (gm < M && gk < K)
        v = to_f(from_f<TW>(to_f(A[(long long)gm * K + gk])));
      As[ak][am] = v;
      const int wk = e / BN, wn = e % BN;   // W tile 16 x 64
      const int gk2 = k0 + wk, gn = n0 + wn;
      Ws[wk][wn] = (gk2 < K && gn < N) ? to_f(Wt[(long long)gk2 * N + gn])
                                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[(long long)gm * N + gn] = from_f<TO>(acc[i][j] + bias[gn]);
    }
  }
}

// Tensor-core version for bf16 weights: C = round_bf16(A) @ Wt + bias.
constexpr int TM = 64, TN = 64, TK = 32;

template <typename TA, typename TO>
__global__ void __launch_bounds__(128)
gemm_bias_wmma_kernel(const TA* __restrict__ A, const bf16* __restrict__ Wt,
                      const float* __restrict__ bias, TO* __restrict__ C,
                      int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[TM][TK + 8];
  __shared__ __align__(32) bf16 Ws[TK][TN + 8];
  __shared__ __align__(32) float Cs[TM][TN + 4];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int r = 0; r < TM * TK / 128; ++r) {
      const int e = tid + r * 128;
      const int am = e / TK, ak = e % TK;
      const int gm = m0 + am, gk = k0 + ak;
      As[am][ak] = __float2bfloat16(
          gm < M && gk < K ? to_f(A[(long long)gm * K + gk]) : 0.f);
      const int wk = e / TN, wn2 = e % TN;
      const int gk2 = k0 + wk, gn = n0 + wn2;
      Ws[wk][wn2] = gk2 < K && gn < N ? Wt[(long long)gk2 * N + gn]
                                      : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm + 16 * i][kk], TK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[kk][wn + 16 * j], TN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              TN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TM * TN; e += 128) {
    const int r = e / TN, c = e % TN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      C[(long long)gm * N + gn] = from_f<TO>(Cs[r][c] + bias[gn]);
  }
}

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

template <typename TA, typename TW, typename TO>
cudaError_t gemm(const void* A, const void* Wt, const float* bias, void* C,
                 int M, int N, int K, cudaStream_t s) {
  if constexpr (std::is_same<TW, bf16>::value) {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    gemm_bias_wmma_kernel<TA, TO><<<grid, 128, 0, s>>>(
        static_cast<const TA*>(A), static_cast<const bf16*>(Wt), bias,
        static_cast<TO*>(C), M, N, K);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bias_kernel<TA, TW, TO><<<grid, 256, 0, s>>>(
        static_cast<const TA*>(A), static_cast<const TW*>(Wt), bias,
        static_cast<TO*>(C), M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int cffn_gemm(const void* A, const void* Wt, const float* bias,
                         void* C, int M, int N, int K, int dtype_a,
                         int dtype_w, int dtype_o, cudaStream_t s) {
  using namespace ceigm;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  // fp32 throughout; bf16 fc1 (bf16 in, fp32 hidden out); bf16 fc2 (fp32
  // hidden in, bf16 out)
  if (dtype_a == kF32 && dtype_w == kF32 && dtype_o == kF32)
    return (int)gemm<float, float, float>(A, Wt, bias, C, M, N, K, s);
  if (dtype_a == kBF16 && dtype_w == kBF16 && dtype_o == kF32)
    return (int)gemm<bf16, bf16, float>(A, Wt, bias, C, M, N, K, s);
  if (dtype_a == kF32 && dtype_w == kBF16 && dtype_o == kBF16)
    return (int)gemm<float, bf16, bf16>(A, Wt, bias, C, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

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
