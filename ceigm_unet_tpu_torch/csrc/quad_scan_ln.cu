// Quad-group selective scan (d_state = 1) + per-pixel group LayerNorm.
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _sscan_quad_ln_kernel (bodies
// _fused_quad_ln_merged_kernel / _fused_quad_ln_kernel / _quad_ln_body,
// entry sscan_quad_ln_cat) and its batch-last twin
// ceigm_unet_tpu/ops/quad_scan_bl.py _bl_family (entry
// sscan_quad_ln_cat_bl). Same math, one layout. As quad_scan_ln_q8 it also
// replaces the quant=True instance of _sscan_quad_ln_kernel (entry
// sscan_quad_ln_cat_q8): u and dt arrive as int8 and are dequantized by
// per-(k, channel) scales before the softplus, so the math past that
// multiply is the same; the output is bf16 whatever Bs/Cs's dtype.
//
// Per channel group k, scanned over the H*W pixels in direction k (1 row-
// major, 2 column-major, 3/4 those reversed):
//   d = softplus(dt + bias);  h = exp(d*A)*h_prev + d*u*B;  y = C*h + D*u
// then LayerNorm over the group's D channels of each pixel (eps 1e-5,
// var = E[y^2] - E[y]^2 as in the TPU kernel), written lane-concatenated
// to out (B, L, K*D). h and all arithmetic are fp32.
//
// What bounds it on the H100: bytes in principle (a b128 gm_tiny forward moves
// ~1.96 GB through its 26 calls: 0.585 ms at 3.35 TB/s; int8 u/dt 0.394 ms),
// in practice instruction issue and the access pattern. A chain (b, k, c) is
// serial in L and there are only B*K = 512 (b, k) chains, so the parallelism
// that fills the card has to come from L. Design (K10's, csrc/sscan_dir.cu,
// with the LayerNorm added): each chain is split into chunks of S pixels; a
// block of nw <= 4 warps takes one (b, k) and walks L in rounds of nw*32/G
// chunks. A team of G lanes runs one chunk with all D channels of its pixels:
// lane l on NC vectors of V consecutive channels (V = 2 where D is even and
// the strides and pointers allow 2-channel accesses: D16 on 8 lanes, four
// chunks per warp; D32 on 16; D112 on 28 of 32 lanes, 4 channels each; V = 1
// otherwise, D87 on 32 lanes with 3 channels each). S is 8 at V = 2 up to D64
// and 4 above; at V = 1, 16, 8 and 4 at 1, 2 and 3-4 vectors per lane. A lane
// loads its chunk's u and dt for its channels, all at once, and lane j the B
// and C of step j, shuffled to the team at each step. It runs the chunk from
// h = 0, keeping per pixel the local output C*h_loc + D*u and C*P, P the chunk's
// decay product so far, and publishes the chunk's (P, h_loc) in shared memory.
// After one barrier each team folds the round's carry-in over the chunks
// before its own (h = P*h + h_loc), finishes y = y_loc + C*P*h_in, and only
// then takes the LayerNorm statistics: a reduce-scatter over the team's lanes
// (each halving sends half of the chunk's per-pixel sums across), so a pixel's
// sum and sum of squares cost ~2 shuffles instead of 2*log2(G); the mean and
// 1/std are shuffled back per pixel. The next round's loads are issued before
// the barrier, so they are in flight while the warps wait, fold and store.
// Rounds with no pixel past L run without per-step checks; pixels are walked
// by increments (common.cuh Walk). With bf16 Bs/Cs (the served and trained
// path, and the int8 route's) the softplus and both exponentials use the
// ex2/lg2 approximations with ln(2) folded into B; fp32 takes the accurate
// log1pf and expf (as K10: the fp32 train-step gradient checks read this
// kernel's output). int8 u/dt are converted by the 2^23 magic-number add
// (common.cuh to_f), and dt's scale folds into the bias add as one FMA.
// Lanes past D load a clamped channel, count 0 in the statistics and store
// nothing; pixels past L decay by 1, add nothing and store nothing.
//
// Measured (b128 bf16 gm_tiny forward, device time, kernel_ab on an H100
// 80GB HBM3 at 700 W; PERF.md has the tables): K1 6.69 -> 1.49 ms (2.5x
// its bound), K14 6.17 -> 1.37 (3.5x). What is left: at 56x56 D16 each
// 128-byte pixel row of u, dt and out holds the four groups' 32-byte
// slices, and the four direction walks visit it at four different times,
// so every access is a lone 32-byte sector (the same kernel with every
// group walking rows, or with inputs that hit in cache, runs 1.6-1.8x
// faster); the rest is issue and latency (with inputs that hit in cache
// the shapes run at 1.7-2.7x the byte bound). Tried and dropped: S 8 or 16
// at 4, 6 or 8 warps per block (no change), 16-lane teams with 2 channels
// each at D16 (no change), evict-first loads and evict-last stores (no
// change), a 4-channel vector per lane with a warp-shuffle prefix over
// teams, unsigned offsets and separate row and column walk code (+12%,
// spills), loads two rounds ahead (+27%, spills).
//
// u/dt/Bs/Cs are addressed by strides, so the model passes the (B, L, K, D)
// GEMM outputs and the x_dbl slices as strided views without a copy.
#include <type_traits>

#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kMaxD = 128;
constexpr int kW = 4;                 // warps per block, at most
constexpr unsigned kFull = 0xffffffffu;

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

// V consecutive elements, loaded or stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// A lane's constants for its NC*V channels, slot n = i*V + v being channel
// (i*G + lt)*V + v (dead vectors, past D, hold the last vector's)
template <int NC, int V>
struct Lane {
  float A[NC * V], bias[NC * V], Dv[NC * V], ln_s[NC * V], ln_b[NC * V],
      su[NC * V], sdt[NC * V];
  int cu[NC], cdt[NC], c[NC];       // offsets of u, dt, out per vector
  bool live[NC];
};

template <typename TU, int NC, int S, int V>
struct Chunk {
  Vec<TU, V> u[NC][S], dt[NC][S];
  float b, c;                  // lane j < S: step j's B (times ln(2) on
                               // the fast path) and C
};

// The loads of chunk steps t0 .. t0+S-1: u and dt of this lane's channels,
// B and C of step (lt mod S) (kTail: steps past L load the last pixel
// again).
template <bool kTail, int NC, int S, int V, typename TU, typename TS>
__device__ __forceinline__ void load_chunk(
    Chunk<TU, NC, S, V>& ch, const TU* u, const TU* dt, const TS* Bs,
    const TS* Cs, int su, int sdt, int sbs, int scs, const Lane<NC, V>& ln,
    int t0, int lt, const Walk& walk) {
  const int L = walk.L;
  int p = walk.at(kTail ? min(t0, L - 1) : t0);
  const int tl = t0 + (lt & (S - 1));
  const int pl = walk.at(kTail ? min(tl, L - 1) : tl);
  constexpr bool kFast = std::is_same<TS, bf16>::value;
  ch.b = to_f(Bs[pl * sbs]) * (kFast ? kLn2 : 1.f);
  ch.c = to_f(Cs[pl * scs]);
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      ch.u[i][j] = *reinterpret_cast<const Vec<TU, V>*>(u + p * su
                                                         + ln.cu[i]);
      ch.dt[i][j] = *reinterpret_cast<const Vec<TU, V>*>(dt + p * sdt
                                                          + ln.cdt[i]);
    }
    if (j + 1 < S && (!kTail || t0 + j + 1 < L)) p = walk.next(p);
  }
}

// The chunk from h = 0: y_loc = C*h_loc + D*u and cp = C*P per step and
// channel, P the chunk's decay product so far; g = (P, h_loc) at the
// chunk's end. On the fast path d2 = softplus(x)*log2(e) by ex2/lg2, so
// d = d2*ln(2) (folded into B) and exp(d*A) = 2^(d2*A).
// kTail: steps past L decay by 1 and add nothing.
template <bool kTail, bool kFast, bool kQuant, int G, int NC, int S, int V,
          typename TU>
__device__ __forceinline__ void run_chunk(const Chunk<TU, NC, S, V>& ch,
                                          const Lane<NC, V>& ln, int t0,
                                          int L, float (&yl)[NC * V][S],
                                          float (&cp)[NC * V][S],
                                          float2 (&g)[NC * V]) {
  float h[NC * V], P[NC * V];
#pragma unroll
  for (int n = 0; n < NC * V; ++n) h[n] = 0.f, P[n] = 1.f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float bj = __shfl_sync(kFull, ch.b, j, G);
    const float cj = __shfl_sync(kFull, ch.c, j, G);
#pragma unroll
    for (int n = 0; n < NC * V; ++n) {
      float uu = to_f(ch.u[n / V][j].v[n % V]);
      const float dtv = to_f(ch.dt[n / V][j].v[n % V]);
      float x;
      if constexpr (kQuant) {     // dequantize, as _quad_ln_body
        uu *= ln.su[n];
        x = fmaf(dtv, ln.sdt[n], ln.bias[n]);
      } else {
        x = dtv + ln.bias[n];
      }
      float aj, drive;
      if constexpr (kFast) {
        const float d2 = fmaf(fmaxf(x, 0.f), kLog2e,
                              lg2(1.f + ex2(-fabsf(x) * kLog2e)));
        aj = ex2(d2 * ln.A[n]);
        drive = d2 * uu * bj;
      } else {
        // fp32: the accurate forms, as the plain version computes
        const float d = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        aj = expf(d * ln.A[n]);
        drive = d * uu * bj;
      }
      if (kTail && t0 + j >= L) aj = 1.f, drive = 0.f;
      h[n] = fmaf(aj, h[n], drive);
      P[n] *= aj;
      yl[n][j] = fmaf(cj, h[n], ln.Dv[n] * uu);
      cp[n][j] = cj * P[n];
    }
  }
#pragma unroll
  for (int n = 0; n < NC * V; ++n) g[n] = make_float2(P[n], h[n]);
}

// One halving of the reduce-scatter: N values per lane -> N/2, the lanes
// with bit O set keeping the upper half and receiving it from the lane
// across, the others the lower half.
template <int N, int O, int S>
__device__ __forceinline__ void halve(float (&s)[S], float (&q)[S], int lt) {
  if constexpr (N > 1) {
    const bool up = lt & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float s_keep = up ? s[i + N / 2] : s[i];
      const float s_send = up ? s[i] : s[i + N / 2];
      const float q_keep = up ? q[i + N / 2] : q[i];
      const float q_send = up ? q[i] : q[i + N / 2];
      s[i] = s_keep + __shfl_xor_sync(kFull, s_send, O);
      q[i] = q_keep + __shfl_xor_sync(kFull, q_send, O);
    }
    halve<N / 2, O / 2, S>(s, q, lt);
  }
}

// s[j], q[j] summed over the G lanes of the team for each of the S steps;
// lane lt returns the sums of step lt / (G / S) (S <= G).
template <int G, int S>
__device__ __forceinline__ float2 team_sums(float (&s)[S], float (&q)[S],
                                            int lt) {
  halve<S, G / 2, S>(s, q, lt);
  float2 t = make_float2(s[0], q[0]);
#pragma unroll
  for (int o = G / S / 2; o > 0; o /= 2) {
    t.x += __shfl_xor_sync(kFull, t.x, o);
    t.y += __shfl_xor_sync(kFull, t.y, o);
  }
  return t;
}

// y = y_loc + C*P*h_in, the LayerNorm over the team's channels of each
// pixel, and the stores of the chunk's steps (kTail: those before L)
template <bool kTail, int G, int NC, int S, int V, typename TO>
__device__ __forceinline__ void finish_chunk(
    TO* out, int KD, float invD, const Lane<NC, V>& ln,
    const float (&cin)[NC * V], float (&yl)[NC * V][S],
    const float (&cp)[NC * V][S], int t0, int lt, const Walk& walk) {
  float s[S], q[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    s[j] = 0.f, q[j] = 0.f;
#pragma unroll
    for (int n = 0; n < NC * V; ++n) {
      yl[n][j] = fmaf(cp[n][j], cin[n], yl[n][j]);
      const float v = ln.live[n / V] ? yl[n][j] : 0.f;
      s[j] += v;
      q[j] = fmaf(v, v, q[j]);
    }
  }
  const float2 t = team_sums<G, S>(s, q, lt);
  const float m = t.x * invD;
  const float rs = rsqrtf(t.y * invD - m * m + 1e-5f);
  const int L = walk.L;
  int p = walk.at(kTail ? min(t0, L - 1) : t0);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float mj = __shfl_sync(kFull, m, j * (G / S), G);
    const float rj = __shfl_sync(kFull, rs, j * (G / S), G);
    if (!kTail || t0 + j < L) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (ln.live[i]) {
          Vec<TO, V> o;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int n = i * V + v;
            o.v[v] = from_f<TO>(fmaf((yl[n][j] - mj) * rj, ln.ln_s[n],
                                     ln.ln_b[n]));
          }
          *reinterpret_cast<Vec<TO, V>*>(out + p * KD + ln.c[i]) = o;
        }
      }
      if (j + 1 < S) p = walk.next(p);
    }
  }
}

// TU: u and dt (float, bf16, or int8 with scale_u/scale_dt); TS: Bs and
// Cs; TO: out. G lanes per chunk, each on NC vectors of V consecutive
// channels; S pixels per chunk.
template <typename TU, typename TS, typename TO, int G, int NC, int S, int V>
__global__ void __launch_bounds__(32 * kW, 16 / kW)
quad_scan_ln_kernel(ScanArgs a) {
  constexpr bool kQuant = std::is_same<TU, int8_t>::value;
  constexpr bool kFast = std::is_same<TS, bf16>::value;
  constexpr int T = 32 / G;                       // chunks per warp
  constexpr int NV = NC * V;                      // channels per lane
  __shared__ float2 agg[2][kW * T][NV][G];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int lt = lane & (G - 1);
  const int nq = (blockDim.x >> 5) * T;           // chunks per round
  const int qi = wid * T + lane / G;              // this team's chunk
  const int b = blockIdx.x / a.K, k = blockIdx.x % a.K;
  const int D = a.D, L = a.H * a.W, KD = a.K * D;
  const Walk walk(a.dirs[k], a.H, a.W);

  Lane<NC, V> ln;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = (lt + i * G) * V;
    const int cl = min(c, D - V);                 // in-bounds loads only
    ln.c[i] = c;
    ln.live[i] = c < D;
    ln.cu[i] = cl * (int)a.su[3];
    ln.cdt[i] = cl * (int)a.sdt[3];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int n = i * V + v, e = k * D + cl + v;
      ln.A[n] = a.A[e];
      ln.bias[n] = a.bias[e];
      ln.Dv[n] = a.Dv[e];
      ln.ln_s[n] = a.ln_s[e];
      ln.ln_b[n] = a.ln_b[e];
      ln.su[n] = kQuant ? a.scale_u[e] : 1.f;
      ln.sdt[n] = kQuant ? a.scale_dt[e] : 1.f;
    }
  }
  const TU* u = static_cast<const TU*>(a.u) + b * a.su[0] + k * a.su[1];
  const TU* dt = static_cast<const TU*>(a.dt) + b * a.sdt[0] + k * a.sdt[1];
  const TS* Bs = static_cast<const TS*>(a.Bs) + b * a.sbs[0] + k * a.sbs[1];
  const TS* Cs = static_cast<const TS*>(a.Cs) + b * a.scs[0] + k * a.scs[1];
  TO* out = static_cast<TO*>(a.out) + (long long)b * L * KD + k * D;
  // pixel strides (the host checks that L of them fit in an int)
  const int su = (int)a.su[2], sdt = (int)a.sdt[2];
  const int sbs = (int)a.sbs[2], scs = (int)a.scs[2];
  const float invD = 1.f / D;

  const int span = nq * S;                        // steps per round
  const int rounds = (L + span - 1) / span;
  const int full = L / span;                      // rounds with no step past L
  float carry[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) carry[n] = 0.f;
  Chunk<TU, NC, S, V> ch;
  if (full > 0)
    load_chunk<false>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, ln, qi * S, lt,
                      walk);
  else
    load_chunk<true>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, ln, qi * S, lt,
                     walk);
  for (int r = 0; r < rounds; ++r) {
    const int t0 = r * span + qi * S;
    const bool tail = r >= full;                  // block-uniform
    // 1. the chunk from h = 0
    float yl[NV][S], cp[NV][S];
    float2 g[NV];
    if (tail)
      run_chunk<true, kFast, kQuant, G>(ch, ln, t0, L, yl, cp, g);
    else
      run_chunk<false, kFast, kQuant, G>(ch, ln, t0, L, yl, cp, g);
    // 2. the next round's loads, in flight across the barrier
    if (r + 1 < full)
      load_chunk<false>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, ln, t0 + span,
                        lt, walk);
    else if (r + 1 < rounds)
      load_chunk<true>(ch, u, dt, Bs, Cs, su, sdt, sbs, scs, ln, t0 + span,
                       lt, walk);
    // 3. publish the chunk's (P, h_loc); fold the round's carry-in over
    // the chunks before this one (cin), and on to the round's end (the
    // next round's carry-in). agg alternates by round: a team writes round
    // r + 2's entry only after every warp passed round r + 1's barrier.
#pragma unroll
    for (int n = 0; n < NV; ++n) agg[r & 1][qi][n][lt] = g[n];
    __syncthreads();
    float cin[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) cin[n] = carry[n];
    for (int e = 0; e < nq; ++e) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        if (e == qi) cin[n] = carry[n];
        const float2 v = agg[r & 1][e][n][lt];
        carry[n] = fmaf(v.x, carry[n], v.y);
      }
    }
    // 4. y, its LayerNorm, the stores
    if (tail)
      finish_chunk<true, G>(out, KD, invD, ln, cin, yl, cp, t0, lt, walk);
    else
      finish_chunk<false, G>(out, KD, invD, ln, cin, yl, cp, t0, lt, walk);
  }
}

template <typename TU, typename TS, typename TO, int G, int NC, int S, int V>
cudaError_t launch_cfg(const ScanArgs& a, int B, cudaStream_t stream) {
  constexpr int T = 32 / G;
  // rounds of at most kW*T chunks; as few warps as cover L in that many
  // rounds (L 3136 at D16: 25 rounds of 16 chunks; L 49 at D112: 4 rounds
  // of 4)
  const long long L = (long long)a.H * a.W;
  const long long span = (long long)kW * T * S;
  const long long rounds = (L + span - 1) / span;
  const int nw = (int)((L + rounds * T * S - 1) / (rounds * T * S));
  quad_scan_ln_kernel<TU, TS, TO, G, NC, S, V>
      <<<B * a.K, 32 * nw, 0, stream>>>(a);
  return cudaGetLastError();
}

// Whether u and dt can be read, and out written, two channels at a time:
// D even, channels contiguous, every other stride even, bases aligned
template <typename TU>
bool pairs(const ScanArgs& a) {
  const auto even = [](const long long* s) {
    return s[3] == 1 && s[0] % 2 == 0 && s[1] % 2 == 0 && s[2] % 2 == 0;
  };
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (2 * sizeof(TU)) == 0;
  };
  return a.D % 2 == 0 && even(a.su) && even(a.sdt) && aligned(a.u)
         && aligned(a.dt);
}

// chunk shape by D: G lanes per chunk, NC vectors of V channels per lane,
// S pixels. Channel pairs (V = 2) on the fast path where the layout
// allows; single channels otherwise.
template <typename TU, typename TS, typename TO>
cudaError_t launch(const ScanArgs& a, int B, cudaStream_t stream) {
  if (std::is_same<TS, bf16>::value && pairs<TU>(a)) {
    if (a.D <= 16) return launch_cfg<TU, TS, TO, 8, 1, 8, 2>(a, B, stream);
    if (a.D <= 32) return launch_cfg<TU, TS, TO, 16, 1, 8, 2>(a, B, stream);
    if (a.D <= 64) return launch_cfg<TU, TS, TO, 32, 1, 8, 2>(a, B, stream);
    return launch_cfg<TU, TS, TO, 32, 2, 4, 2>(a, B, stream);
  }
  if (a.D <= 16) return launch_cfg<TU, TS, TO, 16, 1, 16, 1>(a, B, stream);
  if (a.D <= 32) return launch_cfg<TU, TS, TO, 32, 1, 16, 1>(a, B, stream);
  if (a.D <= 64) return launch_cfg<TU, TS, TO, 32, 2, 8, 1>(a, B, stream);
  if (a.D <= 96) return launch_cfg<TU, TS, TO, 32, 3, 4, 1>(a, B, stream);
  return launch_cfg<TU, TS, TO, 32, 4, 4, 1>(a, B, stream);
}

// The host's checks: shapes the kernel takes, and offsets that fit its ints
bool valid(int B, int K, int H, int W, int D, long long su2, long long su3,
           long long sd2, long long sd3, long long sb2, long long sc2) {
  if (B < 1 || K < 1 || K > 4 || D < 1 || D > kMaxD || H < 1 || W < 1)
    return false;
  const long long L = (long long)H * W;
  // pixel indices exact in fp32; pixel offsets, channel offsets and the
  // output's L*K*D per (b, k) in ints
  if (L >= (1LL << 24) || (long long)B * K > 0x7fffffffLL) return false;
  if (su2 < 0 || su3 < 0 || sd2 < 0 || sd3 < 0 || sb2 < 0 || sc2 < 0)
    return false;
  const long long smax = su2 > sd2 ? su2 : sd2;
  const long long sbc = sb2 > sc2 ? sb2 : sc2;
  const long long cmax = su3 > sd3 ? su3 : sd3;
  return L * ((smax > sbc ? smax : sbc) + 1) + cmax * D <= 0x7fffffffLL
         && L * K * D <= 0x7fffffffLL;
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
  if (!valid(B, K, H, W, D, su2, su3, sd2, sd3, sb2, sc2))
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
  if (!valid(B, K, H, W, D, su2, su3, sd2, sd3, sb2, sc2)
      || scale_u == nullptr || scale_dt == nullptr)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{u, dt, Bs, Cs, A, bias, Dv, ln_s, ln_b, scale_u, scale_dt, out,
             {su0, su1, su2, su3}, {sd0, sd1, sd2, sd3}, {sb0, sb1, sb2},
             {sc0, sc1, sc2}, K, H, W, D, {dir0, dir1, dir2, dir3}};
  return (int)(dtype == kF32 ? launch<int8_t, float, bf16>(a, B, stream)
                             : launch<int8_t, bf16, bf16>(a, B, stream));
}
