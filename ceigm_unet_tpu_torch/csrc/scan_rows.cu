// First-order recurrences over contiguous rows: the generic selective
// scan's two TPU kernels.
//
// scan_rows (K11) replaces ceigm_unet_tpu/ops/scan_pallas.py
// _scan_block_kernel (entry _scan_rows / scan_pallas):
//   a, b, out: (M, L) fp32, contiguous;  h_t = a_t * h_{t-1} + b_t.
// selective_scan_n1 (K12) replaces scan_pallas.py _fused_kernel (entry
// selective_scan_fused_n1), the fused d_state = 1 selective scan over the
// (batch*dim, L) rows, with B and C read per (batch, group) instead of the
// TPU's per-row repeated copies:
//   d = softplus(delta + bias_d);  h = exp(d*A_d)*h_prev + d*u*B_bg;
//   y = C_bg*h + D_d*u
// u, delta: (batch*dim, L) fp32 or bf16; Bf, Cf: (batch*G, L) fp32; A,
// bias, Dv: (dim,) fp32; y in fp32 or bf16. All arithmetic is fp32.
//
// What bounds them on the H100: bytes. At the reference speed test's shape
// (B 128, D 96, L 4096) K12 moves ~404 MB (0.12 ms at 3.35 TB/s) and K11
// ~604 MB; the rows are many (12,288) and each step is one FMA. Rows are
// contiguous in L, the opposite of K10's layout, so one warp owns one row
// and walks it in chunks of 256 elements: the warp loads the chunk
// coalesced (lane j takes elements j, j+32, ...) into shared memory, each
// lane then composes its 8 consecutive elements into one affine map
// (h -> A*h + B), a 5-step shuffle scan combines the 32 maps, each lane
// re-applies its elements from the prefix it receives, and the warp writes
// the chunk out coalesced. The last lane's h is the carry into the next
// chunk: the CUDA reading of the TPU kernel's (ROW_TILE, 1) scratch carried
// across its sequential grid. No step waits on more than 8 + 5 dependent
// FMAs per chunk, and no block synchronises: warps are independent.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kWarps = 4;             // rows per block
constexpr int kE = 8;                 // consecutive elements per lane
constexpr int kSeg = 32 * kE;         // elements per chunk
constexpr int kPad = kSeg + kSeg / 32;
constexpr unsigned kFull = 0xffffffffu;

// one padding slot every 32: lane j's run of kE consecutive elements then
// falls in distinct banks
__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// Composes lane-local maps over the warp and returns the h entering this
// lane's first element, given the carry entering the chunk.
__device__ __forceinline__ float warp_prefix(float A, float B, float carry,
                                             int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float Ao = __shfl_up_sync(kFull, A, o);
    const float Bo = __shfl_up_sync(kFull, B, o);
    if (lane >= o) {
      B = fmaf(A, Bo, B);
      A *= Ao;
    }
  }
  const float Ap = __shfl_up_sync(kFull, A, 1);
  const float Bp = __shfl_up_sync(kFull, B, 1);
  return lane == 0 ? carry : fmaf(Ap, carry, Bp);
}

// Scans the chunk staged in sa/sb (decay, drive) in place: sb holds h.
// Returns the carry into the next chunk.
__device__ __forceinline__ float scan_chunk(float* sa, float* sb,
                                            float carry, int lane) {
  float la[kE], lb[kE];
  float A = 1.f, B = 0.f;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    la[i] = sa[sidx(lane * kE + i)];
    lb[i] = sb[sidx(lane * kE + i)];
    B = fmaf(la[i], B, lb[i]);
    A *= la[i];
  }
  float h = warp_prefix(A, B, carry, lane);
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    h = fmaf(la[i], h, lb[i]);
    sb[sidx(lane * kE + i)] = h;
  }
  return __shfl_sync(kFull, h, 31);
}

__global__ void __launch_bounds__(32 * kWarps)
scan_rows_kernel(const float* a, const float* b, float* out, int M, int L) {
  __shared__ float s_a[kWarps][kPad];
  __shared__ float s_b[kWarps][kPad];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= M) return;              // the whole warp: no block barrier
  const float* ar = a + row * L;
  const float* br = b + row * L;
  float* orow = out + row * L;
  float* sa = s_a[warp];
  float* sb = s_b[warp];
  float carry = 0.f;
  for (int t0 = 0; t0 < L; t0 += kSeg) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int t = t0 + i * 32 + lane;
      const bool in = t < L;         // past the end: the identity map
      sa[sidx(i * 32 + lane)] = in ? ar[t] : 1.f;
      sb[sidx(i * 32 + lane)] = in ? br[t] : 0.f;
    }
    __syncwarp();
    carry = scan_chunk(sa, sb, carry, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int t = t0 + i * 32 + lane;
      if (t < L) orow[t] = sb[sidx(i * 32 + lane)];
    }
    __syncwarp();
  }
}

struct N1Args {
  const void* u; const void* delta; const float* Bf; const float* Cf;
  const float* A; const float* bias; const float* Dv; void* out;
  int M, dim, G, L;
};

template <typename T, typename O>
__global__ void __launch_bounds__(32 * kWarps) selective_scan_n1_kernel(
    N1Args p) {
  __shared__ float s_a[kWarps][kPad];
  __shared__ float s_b[kWarps][kPad];
  __shared__ float s_u[kWarps][kPad];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= p.M) return;
  const int L = p.L;
  const int d = (int)(row % p.dim);
  const long long bg = (row / p.dim) * p.G + d / (p.dim / p.G);
  const T* ur = static_cast<const T*>(p.u) + row * L;
  const T* dr = static_cast<const T*>(p.delta) + row * L;
  const float* Br = p.Bf + bg * L;
  const float* Cr = p.Cf + bg * L;
  O* orow = static_cast<O*>(p.out) + row * L;
  const float A_d = p.A[d], bias_d = p.bias[d], D_d = p.Dv[d];
  float* sa = s_a[warp];
  float* sb = s_b[warp];
  float* su = s_u[warp];
  float carry = 0.f;
  for (int t0 = 0; t0 < L; t0 += kSeg) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int t = t0 + i * 32 + lane;
      float av = 1.f, bv = 0.f, uu = 0.f;
      if (t < L) {
        uu = to_f(ur[t]);
        const float x = to_f(dr[t]) + bias_d;
        const float dl = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        av = expf(dl * A_d);
        bv = dl * uu * Br[t];
      }
      sa[sidx(i * 32 + lane)] = av;
      sb[sidx(i * 32 + lane)] = bv;
      su[sidx(i * 32 + lane)] = uu;
    }
    __syncwarp();
    carry = scan_chunk(sa, sb, carry, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int t = t0 + i * 32 + lane;
      const int s = sidx(i * 32 + lane);
      if (t < L) orow[t] = from_f<O>(fmaf(Cr[t], sb[s], D_d * su[s]));
    }
    __syncwarp();
  }
}

template <typename T, typename O>
cudaError_t launch_n1(const N1Args& p, cudaStream_t stream) {
  const int blocks = (p.M + kWarps - 1) / kWarps;
  selective_scan_n1_kernel<T, O><<<blocks, 32 * kWarps, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int scan_rows(const float* a, const float* b, float* out, int M,
                         int L, cudaStream_t stream) {
  using namespace ceigm;
  if (M < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (M + kWarps - 1) / kWarps;
  scan_rows_kernel<<<blocks, 32 * kWarps, 0, stream>>>(a, b, out, M, L);
  return (int)cudaGetLastError();
}

extern "C" int selective_scan_n1(
    const void* u, const void* delta, const float* Bf, const float* Cf,
    const float* A, const float* bias, const float* Dv, void* out, int M,
    int dim, int G, int L, int in_dtype, int out_dtype,
    cudaStream_t stream) {
  using namespace ceigm;
  if (M < 1 || L < 1 || dim < 1 || G < 1 || dim % G != 0 || M % dim != 0)
    return (int)cudaErrorInvalidValue;
  const N1Args p{u, delta, Bf, Cf, A, bias, Dv, out, M, dim, G, L};
  cudaError_t e;
  if (in_dtype == kF32)
    e = out_dtype == kF32 ? launch_n1<float, float>(p, stream)
                          : launch_n1<float, bf16>(p, stream);
  else
    e = out_dtype == kF32 ? launch_n1<bf16, float>(p, stream)
                          : launch_n1<bf16, bf16>(p, stream);
  return (int)e;
}
