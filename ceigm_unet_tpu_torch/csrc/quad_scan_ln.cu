// Quad-group selective scan (d_state = 1) + per-pixel group LayerNorm.
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _sscan_quad_ln_kernel (bodies
// _fused_quad_ln_merged_kernel / _fused_quad_ln_kernel / _quad_ln_body,
// entry sscan_quad_ln_cat) and its batch-last twin
// ceigm_unet_tpu/ops/quad_scan_bl.py _bl_family (entry
// sscan_quad_ln_cat_bl). Same math, one layout. As quad_scan_ln_q8 it also
// replaces the quant=True instance of _sscan_quad_ln_kernel (entry
// sscan_quad_ln_cat_q8): u and dt arrive as int8 and are dequantized in the
// prologue by per-(k, channel) scales, before the softplus, so the math past
// that multiply is the same; the output is bf16 whatever Bs/Cs's dtype.
//
// Per channel group k, scanned over the H*W pixels in direction k (1 row-
// major, 2 column-major, 3/4 those reversed):
//   d = softplus(dt + bias);  h = exp(d*A)*h_prev + d*u*B;  y = C*h + D*u
// then LayerNorm over the group's D channels of each pixel (eps 1e-5,
// var = E[y^2] - E[y]^2 as in the TPU kernel), written lane-concatenated
// to out (B, L, K*D) in u's dtype. h and all arithmetic are fp32.
//
// What bounds it on the H100: the recurrence is serial in L (3136 steps at
// 56x56) and there are only B*K chains of D channels, so it is latency
// bound, not bandwidth bound (at b128 stage 1 the whole op moves ~100 MB,
// ~30 us of HBM time). Design: one block of 128 threads per (b, k), walking
// the group's pixel order in chunks of 32 pixels. Per chunk, all threads
// load the chunk (coalesced: consecutive threads take consecutive channels
// of a pixel) and compute everything that does not depend on h -- the
// softplus, the decay exp(d*A), the drive d*u*B and D*u -- into shared
// memory; then one thread per channel runs only the 32 dependent FMAs
// h = a*h + b and y = C*h + D*u; then 4 threads per pixel reduce the
// LayerNorm statistics with shuffles, and all threads write the normalised
// chunk. The serial part per step is one FMA and two shared-memory loads.
// Shared-memory rows have stride D|1, so column reads are conflict-free.
//
// u/dt/Bs/Cs are addressed by strides, so the model passes the (B, L, K, D)
// GEMM outputs as strided views without a transpose copy.
#include <type_traits>

#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kChunk = 32;
constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr int kPerPixel = kThreads / kChunk;   // LN reduction lanes / pixel

struct ScanArgs {
  const void* u; const void* dt; const void* Bs; const void* Cs;
  const float* A; const float* bias; const float* Dv;
  const float* ln_s; const float* ln_b;
  const float* scale_u; const float* scale_dt;   // int8 (K, D), or null
  void* out;
  long long su[4], sdt[4], sbs[3], scs[3];
  int K, H, W, D;
  int dirs[4];
};

__device__ __forceinline__ int pixel_of(int t, int dir, int H, int W) {
  const int L = H * W;
  if (dir == 3 || dir == 4) t = L - 1 - t;
  if (dir == 2 || dir == 4) return (t % H) * W + t / H;
  return t;
}

// TU: u and dt (float, bf16, or int8 with scale_u/scale_dt); TS: Bs and
// Cs; TO: out.
template <typename TU, typename TS, typename TO>
__global__ void __launch_bounds__(kThreads) quad_scan_ln_kernel(ScanArgs a) {
  constexpr bool kQuant = std::is_same<TU, int8_t>::value;
  extern __shared__ float smem[];
  const int D = a.D, K = a.K, H = a.H, W = a.W, L = H * W;
  const int Dp = D | 1;                   // odd row stride
  float* sa = smem;                       // [kChunk][Dp] decay exp(d*A)
  float* sb = sa + kChunk * Dp;           // [kChunk][Dp] drive d*u*B
  float* sy = sb + kChunk * Dp;           // [kChunk][Dp] D*u, then y
  float* sC = sy + kChunk * Dp;           // [kChunk] per-pixel C
  float* sM = sC + kChunk;                // [kChunk] LN mean
  float* sR = sM + kChunk;                // [kChunk] LN 1/std
  float* prm = sR + kChunk;  // [5|7][D] A, bias, Dv, ln_s, ln_b, scales
  int* sP = reinterpret_cast<int*>(prm + (kQuant ? 7 : 5) * D);  // [kChunk]

  const int b = blockIdx.x / K, k = blockIdx.x % K;
  const int dir = a.dirs[k];
  const int tid = threadIdx.x;
  for (int c = tid; c < D; c += kThreads) {
    prm[c] = a.A[k * D + c];
    prm[D + c] = a.bias[k * D + c];
    prm[2 * D + c] = a.Dv[k * D + c];
    prm[3 * D + c] = a.ln_s[k * D + c];
    prm[4 * D + c] = a.ln_b[k * D + c];
    if (kQuant) {
      prm[5 * D + c] = a.scale_u[k * D + c];
      prm[6 * D + c] = a.scale_dt[k * D + c];
    }
  }

  const TU* u = static_cast<const TU*>(a.u) + b * a.su[0] + k * a.su[1];
  const TU* dt = static_cast<const TU*>(a.dt) + b * a.sdt[0] + k * a.sdt[1];
  const TS* Bs = static_cast<const TS*>(a.Bs) + b * a.sbs[0] + k * a.sbs[1];
  const TS* Cs = static_cast<const TS*>(a.Cs) + b * a.scs[0] + k * a.scs[1];
  TO* out = static_cast<TO*>(a.out) + (long long)b * L * K * D + k * D;
  float h = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int n = min(kChunk, L - t0);
    // 1. everything that does not depend on h, all threads
    for (int e = tid; e < n * D; e += kThreads) {
      const int i = e / D, c = e - i * D;
      const int p = pixel_of(t0 + i, dir, H, W);
      float uu = to_f(u[p * a.su[2] + c * a.su[3]]);
      float dtv = to_f(dt[p * a.sdt[2] + c * a.sdt[3]]);
      if (kQuant) {                       // dequantize, as _quad_ln_body
        uu *= prm[5 * D + c];
        dtv *= prm[6 * D + c];
      }
      const float x = dtv + prm[D + c];
      const float delta = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      sa[i * Dp + c] = expf(delta * prm[c]);
      sb[i * Dp + c] = delta * uu * to_f(Bs[p * a.sbs[2]]);
      sy[i * Dp + c] = prm[2 * D + c] * uu;
      if (c == 0) {
        sC[i] = to_f(Cs[p * a.scs[2]]);
        sP[i] = p;
      }
    }
    __syncthreads();
    // 2. the recurrence, one thread per channel
    if (tid < D) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        h = sa[i * Dp + tid] * h + sb[i * Dp + tid];
        sy[i * Dp + tid] += sC[i] * h;
      }
    }
    __syncthreads();
    // 3. LayerNorm statistics, kPerPixel lanes per pixel
    {
      const int i = tid / kPerPixel, part = tid % kPerPixel;
      float s = 0.f, ss = 0.f;
      if (i < n) {
        for (int c = part; c < D; c += kPerPixel) {
          const float v = sy[i * Dp + c];
          s += v;
          ss += v * v;
        }
      }
#pragma unroll
      for (int o = kPerPixel / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (i < n && part == 0) {
        const float m = s / (float)D;
        sM[i] = m;
        sR[i] = rsqrtf(ss / (float)D - m * m + 1e-5f);
      }
    }
    __syncthreads();
    // 4. write the normalised chunk, coalesced along channels
    for (int e = tid; e < n * D; e += kThreads) {
      const int i = e / D, c = e - i * D;
      out[(long long)sP[i] * K * D + c] = from_f<TO>(
          (sy[i * Dp + c] - sM[i]) * sR[i] * prm[3 * D + c] + prm[4 * D + c]);
    }
    __syncthreads();
  }
}

template <typename TU, typename TS, typename TO>
cudaError_t launch(const ScanArgs& a, int B, cudaStream_t stream) {
  const int n_prm = std::is_same<TU, int8_t>::value ? 7 : 5;
  const size_t smem = (size_t)(3 * kChunk * (a.D | 1) + 4 * kChunk +
                               n_prm * a.D) * 4;
  if (smem > 48 * 1024) {   // D > 112: opt in to more dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        quad_scan_ln_kernel<TU, TS, TO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  quad_scan_ln_kernel<TU, TS, TO><<<B * a.K, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int quad_scan_ln(
    const void* u, const void* dt, const void* Bs, const void* Cs,
    const float* A, const float* bias, const float* Dv, const float* ln_s,
    const float* ln_b, void* out,
    long long su0, long long su1, long long su2, long long su3,
    long long sd0, long long sd1, long long sd2, long long sd3,
    long long sb0, long long sb1, long long sb2,
    long long sc0, long long sc1, long long sc2,
    int B, int K, int H, int W, int D, int dir0, int dir1, int dir2,
    int dir3, int dtype, cudaStream_t stream) {
  using namespace ceigm;
  if (K < 1 || K > 4 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{u, dt, Bs, Cs, A, bias, Dv, ln_s, ln_b, nullptr, nullptr, out,
             {su0, su1, su2, su3}, {sd0, sd1, sd2, sd3}, {sb0, sb1, sb2},
             {sc0, sc1, sc2}, K, H, W, D, {dir0, dir1, dir2, dir3}};
  return (int)(dtype == kF32 ? launch<float, float, float>(a, B, stream)
                             : launch<bf16, bf16, bf16>(a, B, stream));
}

// The int8 form: u and dt int8 at the given strides, dequantized by
// scale_u/scale_dt (K, D); Bs and Cs in `dtype`; out (B, L, K*D) bf16.
extern "C" int quad_scan_ln_q8(
    const void* u, const void* dt, const void* Bs, const void* Cs,
    const float* A, const float* bias, const float* Dv, const float* ln_s,
    const float* ln_b, const float* scale_u, const float* scale_dt, void* out,
    long long su0, long long su1, long long su2, long long su3,
    long long sd0, long long sd1, long long sd2, long long sd3,
    long long sb0, long long sb1, long long sb2,
    long long sc0, long long sc1, long long sc2,
    int B, int K, int H, int W, int D, int dir0, int dir1, int dir2,
    int dir3, int dtype, cudaStream_t stream) {
  using namespace ceigm;
  if (K < 1 || K > 4 || D < 1 || D > kMaxD || scale_u == nullptr ||
      scale_dt == nullptr)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{u, dt, Bs, Cs, A, bias, Dv, ln_s, ln_b, scale_u, scale_dt, out,
             {su0, su1, su2, su3}, {sd0, sd1, sd2, sd3}, {sb0, sb1, sb2},
             {sc0, sc1, sc2}, K, H, W, D, {dir0, dir1, dir2, dir3}};
  return (int)(dtype == kF32 ? launch<int8_t, float, bf16>(a, B, stream)
                             : launch<int8_t, bf16, bf16>(a, B, stream));
}
