// Directional d_state = 1 selective scan, no LayerNorm: the legacy VMamba
// SS2D's scan (K10).
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _sscan_dir_kernel (body
// _fused_kernel, entry sscan_dir), which the JAX package calls once per
// direction; here all K directions run in one launch.
//
// For direction k (1 row-major, 2 column-major, 3/4 those reversed), over
// the H*W pixels in that order, per channel c:
//   d = softplus(dt + bias);  h = exp(d*A)*h_prev + d*u*B;  y = C*h + D*u
// u, dt: (B, K, L, D) addressed by strides (u may be a stride-0 view over
// K: the four directions read the same activation); Bs, Cs: (B, K, L)
// per-pixel scalars by strides; A, bias, Dv: (K, D) fp32. y: (B, K, L, D)
// fp32, contiguous, in row-major pixel order. u/dt/Bs/Cs are fp32 or bf16;
// all arithmetic is fp32.
//
// What bounds it on the H100: bytes. At b128 the 56x56 D96 call moves ~1 GB
// (dt and the fp32 y dominate): 0.301 ms at 3.35 TB/s. A chain (b, k, c) is
// serial in L, and there are only B*K*D = 49,152 of them at 56x56; and per
// element the step costs ~40 instructions even with the fast forms, so
// instruction issue is close behind the bytes. Design: each chain is split
// into chunks of kSteps = 16 pixels, and a block of nw <= 4 warps takes one
// (b, k, 32-channel tile) and walks L in rounds of nw chunks, warp w on
// chunk w of the round, lane c on channel c. A warp loads its chunk's u and
// dt for its lane's channel, all 32 loads at once (a warp load is the
// tile's 32 contiguous channels of one pixel, whatever the direction), and
// the chunk's B and C one pixel per lane, shuffled to all lanes at each
// step. It runs the chunk from h = 0, keeping per pixel the local output
// C*h_loc + D*u and C*P, P the chunk's decay product so far, and publishes
// the chunk's (P, h_loc) in shared memory. After one barrier each warp
// folds the round's carry-in over the chunks before its own (h = P*h +
// h_loc) and stores y = y_loc + C*P*h_in; every warp folds on to the
// round's end, the next round's carry-in. The next round's loads are
// issued before the barrier, so they are in flight while the warps wait
// and store. Rounds with no pixel past L run without per-step checks;
// pixels are walked by increments (a column walk's start through an fp32
// reciprocal, not a divide). With bf16 inputs (the served and trained
// path) the softplus and both exponentials use the ex2/lg2 approximations,
// exp(d*A) as 2^(d*log2(e)*A) from the softplus's own log2 form: their
// ~2^-22 error is far below the inputs' 2^-8. fp32 inputs take the accurate
// log1pf and expf: with ex2/lg2 for them too the output met phase 10's fp32
// tolerance, but in the legacy b2 fp32 train step card vs CPU
// (chip_smoke.py phase 18) one gradient moved to 1.57 of its tolerance,
// three times its CPU reorder noise in that run, and the phase failed; with
// the accurate forms it passes.
// Lanes past D load a clamped channel and store nothing; pixels past L
// decay by 1, add nothing and store nothing.
//
// Versions (b128 bf16 legacy tiny_0230s forward, device time per forward,
// bound 2.628 ms; kernel_ab with the parent in the same call, on an H100
// 80GB HBM3 at 700 W): a warp per (b, k, 32-channel tile) walking all of L
// with 16 pixels' loads in flight per lane, accurate softplus and exp, a
// divide and a modulo per pixel of a column walk: 10.60 ms (each shape at
// ~4x its bound, those with 6-12 thousand warps too); chunks in blocks of
// 8 warps, every step checked against L: 5.438; checks only in the last
// round, no divides, ln(2) folded into B: 4.979; blocks of 4 warps (four
// blocks per SM instead of two, so a block's barrier wait overlaps the
// others' work): 4.635 (8-pixel chunks, three blocks of 8 warps: 4.960).
// Earlier, at 56x56 D96 alone: 64-pixel chunks staged in shared memory
// (128 threads load, one warp runs the chain, three barriers per chunk)
// 2.132 ms, against 1.248 for the warp per tile.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kTile = 32;      // channels per warp, one per lane
constexpr int kMaxWarps = 4;   // chunks per round (warps per block)
constexpr int kSteps = 16;     // pixels per chunk, loaded at once per lane

struct DirArgs {
  const void* u; const void* dt; const void* Bs; const void* Cs;
  const float* A; const float* bias; const float* Dv; float* out;
  long long su[4], sdt[4], sbs[3], scs[3];
  int K, H, W, D, tiles;
  int dirs[4];
};

template <typename T>
struct Chunk {
  T u[kSteps], dt[kSteps];
  float b, c;                  // lane j < kSteps: step j's B (times ln(2)
                               // for bf16 inputs) and C
};

// The loads of chunk steps t0 .. t0+kSteps-1: u and dt of this lane's
// channel, B and C of step `lane` (kTail: steps past L load the last pixel
// again).
template <bool kTail, typename T>
__device__ __forceinline__ void load_chunk(
    Chunk<T>& ch, const T* u, const T* dt, const T* Bs, const T* Cs,
    int su, int sdt, int sbs, int scs, int t0, int lane, const Walk& walk) {
  const int L = walk.L;
  int p = walk.at(kTail ? min(t0, L - 1) : t0);
  const int tl = t0 + (lane & (kSteps - 1));
  const int pl = walk.at(kTail ? min(tl, L - 1) : tl);
  ch.b = to_f(Bs[pl * sbs]) * (sizeof(T) == 4 ? 1.f : kLn2);
  ch.c = to_f(Cs[pl * scs]);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    ch.u[j] = u[p * su];
    ch.dt[j] = dt[p * sdt];
    if (j + 1 < kSteps && (!kTail || t0 + j + 1 < L)) p = walk.next(p);
  }
}

// The chunk from h = 0: y_loc = C*h_loc + D*u and cp = C*P per step, P the
// chunk's decay product so far; returns (P, h_loc) at the chunk's end.
// For bf16 inputs d2 = softplus(x)*log2(e) by ex2/lg2, so d = d2*ln(2) and
// exp(d*A) = 2^(d2*A); fp32 inputs take the accurate log1pf and expf.
// kTail: steps past L decay by 1 and add nothing.
template <bool kTail, typename T>
__device__ __forceinline__ float2 run_chunk(const Chunk<T>& ch, float A_c,
                                           float bias_c, float D_c, int t0,
                                           int L, float (&yl)[kSteps],
                                           float (&cp)[kSteps]) {
  float h = 0.f, P = 1.f;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const float x = to_f(ch.dt[j]) + bias_c;
    const float uu = to_f(ch.u[j]);
    const float bj = __shfl_sync(0xffffffffu, ch.b, j);
    const float cj = __shfl_sync(0xffffffffu, ch.c, j);
    float aj, drive;
    if constexpr (sizeof(T) == 4) {
      // fp32 inputs: the accurate forms, as the plain version computes
      const float d = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      aj = expf(d * A_c);
      drive = d * uu * bj;
    } else {
      const float d2 = fmaf(fmaxf(x, 0.f), kLog2e,
                            lg2(1.f + ex2(-fabsf(x) * kLog2e)));
      aj = ex2(d2 * A_c);
      drive = d2 * uu * bj;
    }
    if (kTail && t0 + j >= L) aj = 1.f, drive = 0.f;
    h = fmaf(aj, h, drive);
    P *= aj;
    yl[j] = fmaf(cj, h, D_c * uu);
    cp[j] = cj * P;
  }
  return make_float2(P, h);
}

// y = y_loc + C*P*h_in for the chunk's steps (kTail: those before L)
template <bool kTail>
__device__ __forceinline__ void store_chunk(float* out, int D, int t0,
                                            float cin,
                                            const float (&yl)[kSteps],
                                            const float (&cp)[kSteps],
                                            const Walk& walk) {
  int p = walk.at(kTail ? min(t0, walk.L - 1) : t0);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (!kTail || t0 + j < walk.L) {
      out[(long long)p * D] = fmaf(cp[j], cin, yl[j]);
      if (j + 1 < kSteps) p = walk.next(p);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps, 16 / kMaxWarps)
sscan_dir_kernel(DirArgs a) {
  __shared__ float2 agg[2][kMaxWarps][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int tile = blockIdx.x % a.tiles;
  const int bk = blockIdx.x / a.tiles;
  const int b = bk / a.K, k = bk % a.K;
  const int L = a.H * a.W, D = a.D;
  const Walk walk(a.dirs[k], a.H, a.W);
  const int c = tile * kTile + lane;
  const bool live = c < D;
  const int cl = live ? c : D - 1;              // in-bounds loads only

  const float A_c = a.A[k * D + cl];
  const float bias_c = a.bias[k * D + cl];
  const float D_c = a.Dv[k * D + cl];
  const T* u = static_cast<const T*>(a.u) + b * a.su[0] + k * a.su[1]
               + (long long)cl * a.su[3];
  const T* dt = static_cast<const T*>(a.dt) + b * a.sdt[0] + k * a.sdt[1]
                + (long long)cl * a.sdt[3];
  const T* Bs = static_cast<const T*>(a.Bs) + b * a.sbs[0] + k * a.sbs[1];
  const T* Cs = static_cast<const T*>(a.Cs) + b * a.scs[0] + k * a.scs[1];
  float* out = a.out + (long long)bk * L * D + c;
  // pixel strides (the host checks that L of them fit in an int)
  const int su = (int)a.su[2], sdt = (int)a.sdt[2];
  const int sbs = (int)a.sbs[2], scs = (int)a.scs[2];

  const int span = nw * kSteps;                 // steps per round
  const int rounds = (L + span - 1) / span;
  const int full = L / span;                    // rounds with no step past L
  float carry = 0.f;
  Chunk<T> ch;
  if (full > 0)
    load_chunk<false>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, wid * kSteps,
                      lane, walk);
  else
    load_chunk<true>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, wid * kSteps,
                     lane, walk);
  for (int r = 0; r < rounds; ++r) {
    const int t0 = r * span + wid * kSteps;
    const bool tail = r >= full;                // block-uniform
    // 1. the chunk from h = 0
    float yl[kSteps], cp[kSteps];
    const float2 g = tail
        ? run_chunk<true>(ch, A_c, bias_c, D_c, t0, L, yl, cp)
        : run_chunk<false>(ch, A_c, bias_c, D_c, t0, L, yl, cp);
    // 2. the next round's loads, in flight across the barrier
    if (r + 1 < full)
      load_chunk<false>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, t0 + span,
                        lane, walk);
    else if (r + 1 < rounds)
      load_chunk<true>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, t0 + span,
                       lane, walk);
    // 3. publish the chunk's (P, h_loc); fold the round's carry-in over
    // the chunks before this one (cin), and on to the round's end (the
    // next round's carry-in). agg alternates by round: a warp writes round
    // r + 2's entry only after every warp passed round r + 1's barrier.
    agg[r & 1][wid][lane] = g;
    __syncthreads();
    float cin = carry;
    for (int i = 0; i < nw; ++i) {
      if (i == wid) cin = carry;
      const float2 e = agg[r & 1][i][lane];
      carry = fmaf(e.x, carry, e.y);
    }
    // 4. y for this chunk's steps
    if (live) {
      if (tail) store_chunk<true>(out, D, t0, cin, yl, cp, walk);
      else store_chunk<false>(out, D, t0, cin, yl, cp, walk);
    }
  }
}

}  // namespace
}  // namespace ceigm

extern "C" int sscan_dir(
    const void* u, const void* dt, const void* Bs, const void* Cs,
    const float* A, const float* bias, const float* Dv, float* out,
    long long su0, long long su1, long long su2, long long su3,
    long long sd0, long long sd1, long long sd2, long long sd3,
    long long sb0, long long sb1, long long sb2,
    long long sc0, long long sc1, long long sc2,
    int B, int K, int H, int W, int D, int dir0, int dir1, int dir2,
    int dir3, int dtype, cudaStream_t stream) {
  using namespace ceigm;
  if (B < 1 || K < 1 || K > 4 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)H * W;
  // pixel offsets are ints in the kernel, pixel indices exact in fp32
  if (L >= (1LL << 24)) return (int)cudaErrorInvalidValue;
  const long long smax = su2 > sd2 ? su2 : sd2;
  const long long sbc = sb2 > sc2 ? sb2 : sc2;
  if (su2 < 0 || sd2 < 0 || sb2 < 0 || sc2 < 0
      || L * ((smax > sbc ? smax : sbc) + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tiles = (D + kTile - 1) / kTile;
  const long long blocks = (long long)B * K * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // rounds of at most kMaxWarps chunks; as few warps as cover L in that
  // many rounds (L 3136: 49 rounds of 4 chunks; L 45: 1 of 3)
  const long long span = (long long)kMaxWarps * kSteps;
  const long long rounds = (L + span - 1) / span;
  const int nw = (int)((L + rounds * kSteps - 1) / (rounds * kSteps));
  DirArgs a{u, dt, Bs, Cs, A, bias, Dv, out,
            {su0, su1, su2, su3}, {sd0, sd1, sd2, sd3}, {sb0, sb1, sb2},
            {sc0, sc1, sc2}, K, H, W, D, tiles, {dir0, dir1, dir2, dir3}};
  if (dtype == kF32)
    sscan_dir_kernel<float><<<(unsigned)blocks, 32 * nw, 0, stream>>>(a);
  else
    sscan_dir_kernel<bf16><<<(unsigned)blocks, 32 * nw, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
