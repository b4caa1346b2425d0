// First-order recurrences over contiguous rows: the generic selective
// scan's two TPU kernels.
//
// scan_rows (K11) replaces ceigm_unet_tpu/ops/scan_pallas.py
// _scan_block_kernel (entry _scan_rows / scan_pallas):
//   a, b, out: (M, L) fp32, contiguous;  h_t = a_t * h_{t-1} + b_t.
// What bounds it on the H100: bytes (12 per element; the rows are many,
// 12,288 at the reference speed test's shape, and each step is one FMA).
// Rows are contiguous in L, the opposite of K10's layout, so one warp owns
// one row and walks it in chunks of 256 elements: the warp loads the chunk
// coalesced (lane j takes elements j, j+32, ...) into shared memory, each
// lane then composes its 8 consecutive elements into one affine map
// (h -> A*h + B), a 5-step shuffle scan combines the 32 maps, each lane
// re-applies its elements from the prefix it receives, and the warp writes
// the chunk out coalesced. The last lane's h is the carry into the next
// chunk: the CUDA reading of the TPU kernel's (ROW_TILE, 1) scratch carried
// across its sequential grid.
//
// selective_scan_n1 (K12) replaces scan_pallas.py _fused_kernel (entry
// selective_scan_fused_n1), the fused d_state = 1 selective scan over the
// (batch*dim, L) rows, with B and C read per (batch, group) instead of the
// TPU's per-row repeated copies:
//   d = softplus(delta + bias_d);  h = exp(d*A_d)*h_prev + d*u*B_bg;
//   y = C_bg*h + D_d*u
// u, delta: (batch, dim, L), each fp32 or bf16, addressed by (batch, dim)
// strides with unit stride in L; B, C: (batch, G, L) in one dtype, fp32 or
// bf16, by (batch, group) strides; A by its stride over dim; bias, Dv:
// (dim,) fp32 or null (0). y: (batch*dim, L) contiguous, fp32 or bf16. All
// arithmetic is fp32.
//
// What bounds K12 on the H100: bytes. At the speed test's shape (B 128,
// D 96, L 4096, bf16 u, delta, B and C, fp32 y) it moves 404.8 MB: 0.121 ms
// at 3.35 TB/s; the softplus and the decay are 3 MUFU operations per
// element, ~0.04 ms. Design: lane j of a warp owns 8 consecutive elements
// of a 256-element chunk and keeps them in registers: one 16-byte load per
// bf16 operand (two per fp32 one), so a warp reads 512 contiguous bytes of
// each bf16 operand, and one or two 16-byte stores of y (u and delta read
// and y written evict-first; B and C, read again by the other rows of
// their group, cached). A block of up to 4 warps takes one row and walks L
// in rounds of one chunk per warp. Each lane runs its 8 steps from h = 0,
// keeping y_loc = C*h_loc + D*u and C*P (P the decay product so far), and
// composes them into one affine map; the next round's loads (u, delta, B
// and C) are then issued into the registers the steps have freed, so they
// are in flight through the shuffle scan, the barrier and the stores; a
// 5-step shuffle scan gives each lane the map of the chunk's steps before
// its own, and the last lane's map is the chunk's, published in shared
// memory. After one barrier per round each warp folds the round's
// carry-in over the chunks before its own and stores y = y_loc +
// C*P*h_in. With bf16 delta the softplus and both exponentials use ex2/lg2
// (d2 = softplus(x)*log2(e), exp(d*A) = 2^(d2*A)), whose ~2^-22 error is
// far below delta's 2^-8; fp32 delta keeps log1pf/expf (K10's fp32 fast
// forms failed a phase-18 gradient). A launch takes the 16-byte path when
// L % 8 == 0 and every row base is 16-byte aligned (pointers and strides),
// else the same design with element loads and stores.
//
// Versions (speed-test shape, fp32 / bf16 y, device ms, bound 0.1208 /
// 0.0908; tools/port_stencil_variants.py --n1-only, all in one call, on an
// H100 80GB HBM3 at 700 W): the parent's warp per row staging 256-element
// chunks in shared memory with element loads, B and C cast to fp32 by its
// wrapper (not timed), log1pf/expf: 0.4080 / 0.3745. This design with 2
// rows of 4 warps a block (B and C shared in L1): 0.1488 / 0.1202; 4 rows
// of 4 warps: 0.1813 / 0.1522; one row of 8 warps: 0.1559 / 0.1363; 8 rows
// of one warp (a warp per row, loads ahead): 0.1459 / 0.1140; one row of 4
// warps (kept): 0.1453 / 0.1178; that with 64 registers (__launch_bounds__
// (256, 4), 40 bytes of spill): 0.1521 / 0.1177; without the evict-first
// loads and stores: 0.1656 / 0.1419. The warp per row matches the kept
// form at 12,288 rows, but a small batch (B 8: 768 rows) would leave it ~6
// warps per SM where the kept form has 4 times as many.
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

constexpr int kN1Warps = 4;           // chunks per round, warps per block

// 8 consecutive elements of one operand, as loaded: bf16 packed in one
// 16-byte vector, fp32 in two
template <typename T> struct Pack8;

template <> struct Pack8<bf16> {
  uint4 v;
  __device__ __forceinline__ float operator[](int i) const {
    const unsigned w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};

template <> struct Pack8<float> {
  float4 lo, hi;
  __device__ __forceinline__ float operator[](int i) const {
    const float4& q = i < 4 ? lo : hi;
    const int j = i & 3;
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  }
};

// Elements t .. t+7 of a row (0 past L). kVec: one or two 16-byte loads
// (the launch checked alignment, and L % 8 == 0 puts a lane's 8 elements
// all before L or all past it); kStream: read once, evict first (u, delta;
// B and C are read again by the other rows of their group).
template <bool kVec, bool kStream>
__device__ __forceinline__ void load8(Pack8<bf16>& x, const bf16* p, int t,
                                      int L) {
  if (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(p + t);
    x.v = t < L ? (kStream ? __ldcs(q) : __ldg(q)) : make_uint4(0, 0, 0, 0);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = t + i < L ? s[t + i] : 0u;
    x.v = make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16,
                     w[4] | w[5] << 16, w[6] | w[7] << 16);
  }
}

template <bool kVec, bool kStream>
__device__ __forceinline__ void load8(Pack8<float>& x, const float* p, int t,
                                      int L) {
  if (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p + t);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    x.lo = t < L ? (kStream ? __ldcs(q) : __ldg(q)) : z;
    x.hi = t < L ? (kStream ? __ldcs(q + 1) : __ldg(q + 1)) : z;
  } else {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = t + i < L ? p[t + i] : 0.f;
    x.lo = make_float4(f[0], f[1], f[2], f[3]);
    x.hi = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// y into elements t .. t+7 of a row, those before L; evict first
template <bool kVec>
__device__ __forceinline__ void store8(float* p, int t, int L,
                                       const float (&y)[8]) {
  if (kVec) {
    if (t < L) {
      float4* q = reinterpret_cast<float4*>(p + t);
      __stcs(q, make_float4(y[0], y[1], y[2], y[3]));
      __stcs(q + 1, make_float4(y[4], y[5], y[6], y[7]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (t + i < L) p[t + i] = y[i];
  }
}

template <bool kVec>
__device__ __forceinline__ void store8(bf16* p, int t, int L,
                                       const float (&y)[8]) {
  if (kVec) {
    if (t < L)
      __stcs(reinterpret_cast<uint4*>(p + t),
             make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                        pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7])));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (t + i < L) p[t + i] = __float2bfloat16(y[i]);
  }
}

struct N1Args {
  const void* u; const void* dt; const void* B; const void* C;
  const float* A; const float* bias; const float* Dv; void* out;
  long long su0, su1, sd0, sd1, sb0, sb1, sc0, sc1, sA;
  int dim, G, L;
};

// one lane's operands for 8 steps of a chunk
template <typename TU, typename TD, typename TBC>
struct N1Chunk {
  Pack8<TU> u;
  Pack8<TD> dt;
  Pack8<TBC> b, c;
};

template <bool kVec, typename TU, typename TD, typename TBC>
__device__ __forceinline__ void load_steps(N1Chunk<TU, TD, TBC>& ch,
                                           const TU* u, const TD* dt,
                                           const TBC* Bp, const TBC* Cp,
                                           int t, int L) {
  load8<kVec, true>(ch.u, u, t, L);
  load8<kVec, true>(ch.dt, dt, t, L);
  load8<kVec, false>(ch.b, Bp, t, L);
  load8<kVec, false>(ch.c, Cp, t, L);
}

// The lane's 8 steps from h = 0: yl = C*h_loc + D*u and cp = C*P per step,
// P the decay product so far; returns the lane's map (P, h_loc). kTail:
// steps past L decay by 1 and add nothing.
template <bool kTail, typename TU, typename TD, typename TBC>
__device__ __forceinline__ float2 run_steps(
    const N1Chunk<TU, TD, TBC>& ch, float A_d, float bias_d, float D_d,
    int t, int L, float (&yl)[kE], float (&cp)[kE]) {
  float h = 0.f, P = 1.f;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const float x = ch.dt[i] + bias_d;
    const float uu = ch.u[i];
    float a, drive;
    if constexpr (sizeof(TD) == 2) {
      // bf16 delta: d2 = softplus(x)*log2(e), d = d2*ln(2)
      const float d2 = fmaf(fmaxf(x, 0.f), kLog2e,
                            lg2(1.f + ex2(-fabsf(x) * kLog2e)));
      a = ex2(d2 * A_d);
      drive = d2 * kLn2 * uu * ch.b[i];
    } else {
      const float d = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      a = expf(d * A_d);
      drive = d * uu * ch.b[i];
    }
    if (kTail && t + i >= L) a = 1.f, drive = 0.f;
    h = fmaf(a, h, drive);
    P *= a;
    yl[i] = fmaf(ch.c[i], h, D_d * uu);
    cp[i] = ch.c[i] * P;
  }
  return make_float2(P, h);
}

template <bool kVec, typename TU, typename TD, typename TBC, typename O>
__global__ void __launch_bounds__(32 * kN1Warps)
selective_scan_n1_kernel(N1Args p) {
  __shared__ float2 agg[2][kN1Warps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const int L = p.L;
  const long long bi = row / p.dim;
  const int d = (int)(row - bi * p.dim);
  const int g = d / (p.dim / p.G);
  const TU* u = static_cast<const TU*>(p.u) + bi * p.su0 + d * p.su1;
  const TD* dt = static_cast<const TD*>(p.dt) + bi * p.sd0 + d * p.sd1;
  const TBC* Bp = static_cast<const TBC*>(p.B) + bi * p.sb0 + g * p.sb1;
  const TBC* Cp = static_cast<const TBC*>(p.C) + bi * p.sc0 + g * p.sc1;
  O* out = static_cast<O*>(p.out) + row * L;
  const float A_d = p.A[d * p.sA];
  const float bias_d = p.bias ? p.bias[d] : 0.f;
  const float D_d = p.Dv ? p.Dv[d] : 0.f;

  const int span = nw * kSeg;                   // elements per round
  const int rounds = (L + span - 1) / span;
  const int full = L / span;                    // rounds with none past L
  const int t0 = wid * kSeg + lane * kE;        // the lane's first, round 0
  N1Chunk<TU, TD, TBC> ch;
  load_steps<kVec>(ch, u, dt, Bp, Cp, t0, L);
  float carry = 0.f;
  for (int r = 0; r < rounds; ++r) {
    const int t = r * span + t0;
    // 1. the lane's steps from h = 0
    float yl[kE], cp[kE];
    const float2 m = r < full
        ? run_steps<false>(ch, A_d, bias_d, D_d, t, L, yl, cp)
        : run_steps<true>(ch, A_d, bias_d, D_d, t, L, yl, cp);
    // 2. the next round's loads, in flight through the scan, the barrier
    // and the stores
    if (r + 1 < rounds) load_steps<kVec>(ch, u, dt, Bp, Cp, t + span, L);
    // 3. the maps of the chunk's lanes, composed: lane j's inclusive map;
    // the last lane's is the chunk's, published for the fold
    float Ai = m.x, Bi = m.y;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float Ao = __shfl_up_sync(kFull, Ai, o);
      const float Bo = __shfl_up_sync(kFull, Bi, o);
      if (lane >= o) {
        Bi = fmaf(Ai, Bo, Bi);
        Ai *= Ao;
      }
    }
    if (lane == 31) agg[r & 1][wid] = make_float2(Ai, Bi);
    float Ae = __shfl_up_sync(kFull, Ai, 1);
    float Be = __shfl_up_sync(kFull, Bi, 1);
    if (lane == 0) Ae = 1.f, Be = 0.f;
    // 4. fold the round's carry-in over the chunks before this one (cin),
    // and on to the round's end (the next round's carry-in). agg
    // alternates by round: a warp writes round r + 2's entry only after
    // every warp passed round r + 1's barrier.
    __syncthreads();
    float cin = carry;
    for (int i = 0; i < nw; ++i) {
      if (i == wid) cin = carry;
      const float2 e = agg[r & 1][i];
      carry = fmaf(e.x, carry, e.y);
    }
    // 5. y for the lane's steps
    const float hin = fmaf(Ae, cin, Be);
    float y[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) y[i] = fmaf(cp[i], hin, yl[i]);
    store8<kVec>(out, t, L, y);
  }
}

template <typename T> struct Tag { typedef T type; };

// f(Tag<float>()) or f(Tag<bf16>()) by dtype code
template <typename F>
cudaError_t by_dtype(int code, F f) {
  return code == kF32 ? f(Tag<float>()) : f(Tag<bf16>());
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
    const void* u, const void* delta, const void* B, const void* C,
    const float* A, const float* bias, const float* Dv, void* out,
    long long su0, long long su1, long long sd0, long long sd1,
    long long sb0, long long sb1, long long sc0, long long sc1,
    long long sA, int batch, int dim, int G, int L, int u_dtype,
    int delta_dtype, int bc_dtype, int out_dtype, cudaStream_t stream) {
  using namespace ceigm;
  const long long M = (long long)batch * dim;
  const auto code_ok = [](int c) { return c == kF32 || c == kBF16; };
  if (batch < 1 || dim < 1 || G < 1 || dim % G != 0 || M > 0x7fffffffLL
      || L < 1 || L > 0x7fffffff - 2 * kN1Warps * kSeg || !code_ok(u_dtype)
      || !code_ok(delta_dtype) || !code_ok(bc_dtype) || !code_ok(out_dtype))
    return (int)cudaErrorInvalidValue;
  // a block per row, a warp per chunk of a round: rounds of 4 chunks, or
  // of as many as cover a shorter row
  const int chunks = (L + kSeg - 1) / kSeg;
  const int nw = chunks < kN1Warps ? chunks : kN1Warps;
  // the 16-byte path: every row base of every operand 16-byte aligned
  const auto al = [](const void* q, int size,
                     std::initializer_list<long long> strides) {
    bool ok = reinterpret_cast<uintptr_t>(q) % 16 == 0;
    for (long long s : strides) ok = ok && (s * size) % 16 == 0;
    return ok;
  };
  const int su = u_dtype == kF32 ? 4 : 2, sd = delta_dtype == kF32 ? 4 : 2;
  const int sbc = bc_dtype == kF32 ? 4 : 2, so = out_dtype == kF32 ? 4 : 2;
  const bool vec = L % 8 == 0 && al(u, su, {su0, su1})
                   && al(delta, sd, {sd0, sd1}) && al(B, sbc, {sb0, sb1})
                   && al(C, sbc, {sc0, sc1}) && al(out, so, {L});
  const N1Args p{u, delta, B, C, A, bias, Dv, out, su0, su1, sd0, sd1,
                 sb0, sb1, sc0, sc1, sA, dim, G, L};
  const dim3 grid((unsigned)M), block(32 * nw);
  return (int)by_dtype(u_dtype, [&](auto tu) {
    return by_dtype(delta_dtype, [&](auto td) {
      return by_dtype(bc_dtype, [&](auto tb) {
        return by_dtype(out_dtype, [&](auto to) {
          using TU = typename decltype(tu)::type;
          using TD = typename decltype(td)::type;
          using TB = typename decltype(tb)::type;
          using TO = typename decltype(to)::type;
          if (vec)
            selective_scan_n1_kernel<true, TU, TD, TB, TO>
                <<<grid, block, 0, stream>>>(p);
          else
            selective_scan_n1_kernel<false, TU, TD, TB, TO>
                <<<grid, block, 0, stream>>>(p);
          return cudaGetLastError();
        });
      });
    });
  });
}
