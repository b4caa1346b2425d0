// First-order linear recurrence along a direction's pixel order: the quad
// scan's backward and the legacy directional scan's backward (K8).
//
// Replaces: ceigm_unet_tpu/ops/quad_scan.py _scan2d_kernel (used by scan2d,
// _scan2d_bwd, _quad_ln_bwd_impl and _sscan_bwd) and its batch-last twin
// ceigm_unet_tpu/ops/quad_scan_bl.py _scan_flat_bl (_scan2d_bl,
// _scan2d_bl_adj). Same function, any layout with unit stride in D.
//
// a, b: (B, K, L, D) fp32 addressed by strides (any stride over B, K and L,
// unit stride over D: the backward hands over the model's (B, L, K, D) or
// (K, B, L, D) storage as it is); out: (B, K, L, D) fp32, contiguous. L =
// H*W pixels in row-major order. Group k is walked in direction dirs[k] (1
// row-major, 2 column-major, 3/4 those reversed), as the forward kernels K1
// and K10 walk it.
//   scan mode:    h_t = a_t * h_{t-1} + b_t,     h_{-1} = 0;  out = h
//   adjoint mode: g_t = b_t + a_{t+1} * g_{t+1}, g_L = 0;     out = g
// The adjoint is the same recurrence walked in the reversed order, with a
// taken one step behind (the a of the pixel visited just before; 0 at the
// walk's first step); it is a mode of this kernel, not a shifted copy of a.
//
// What bounds it on the H100: bytes, 12 per element (a and b read, out
// written): ~0.86 ms per gm_tiny b48 train step and ~3.6 ms per legacy
// tiny_0230s one at 3.35 TB/s. Each chain (b, k, channel) is serial in L
// (3136 steps at 56x56) and the (b, k) pairs are few (192 at b48), so the
// design has to find its parallelism inside the chain, and with one or two
// blocks per SM its bandwidth from the bytes each block keeps in flight.
// It is K10's chunk and carry (sscan_dir.cu), without K10's exp and B/C
// work: a block of nw <= kMaxWarps warps takes one (b, k, channel tile) and
// walks L in rounds. A warp's lanes form teams of G lanes (G a power of
// two; the tile's channels in V-wide items, one item per lane: 16-byte
// accesses where D, the strides and the pointers allow, 8 or 4 bytes
// otherwise); each team takes a run of S = kRun / V steps of the round, so
// every warp access covers whole 32-byte sectors of a pixel's channels, in
// any layout. Each lane copies its runs' a and b into its own slots of a
// kStages-round ring in shared memory with cp.async, kStages - 1 rounds
// ahead (no registers held, no barrier: a lane reads only its own slots,
// after cp.async.wait_group), then per round
//   1. composes the run's affine map h -> P*h + h_loc from h = 0 (P the
//      product of its a),
//   2. scans those maps over the warp's teams by shuffles, so each team has
//      the map of the runs before it in its warp and the warp its total,
//   3. publishes the warp's total in shared memory; after one barrier each
//      lane folds the round's carry-in over the warps before its own, and
//      every lane on to the round's end (the next round's carry-in),
//   4. runs the recurrence again from its carry-in over the a and b it
//      holds in registers, storing each h: each output is the serial
//      recurrence from an exact carry, only the carry summed in another
//      order.
// The walk goes by increments (Walk::next, Walk::prev; no divides). Many
// warps per round keep the rounds few: 13 at gm_tiny's 56x56 D16, 2 at 7x7.
//
// Versions (b48 fp32, K8's device time per unfrozen train step on the
// model's layout through the wrapper, gm_tiny / tiny_0230s, python -m
// ceigm_unet_tpu_torch.kernel_ab on an H100 80GB HBM3 at 700 W, each
// against its predecessor in one call; PERF.md): chunks of up to 256
// pixels staged in shared memory, one thread per channel running the
// chain, contiguous operands only (the wrapper copied a and b): 5.354 /
// 16.689 (3.359 / 9.781 of it the kernel); this design with two register
// buffers of a and b (the next round's loads issued before this round's
// work) in place of the ring: 1.778 / 5.193 at up to 149 registers (one
// block per SM at D 87), 1.516 / 5.001 capped at 128 (two blocks per SM;
// runs of 8 steps at 4-byte items: no change); the ring: 1.414 / 4.976.
#include "common.cuh"

namespace ceigm {
namespace {

constexpr int kMaxWarps = 8;   // warps per block
constexpr int kRun = 16;       // floats of a (and of b) per lane per round

struct Scan2dArgs {
  const float* a; const float* b; float* out;
  long long sa[3], sb[3];      // strides over B, K, L (elements)
  int K, H, W, D, tiles, tw, lg;   // lg: log2 of the team's lanes G
  int dirs;                    // group k's direction in bits 4k .. 4k+3
};

template <int V>
__device__ __forceinline__ void lds_v(float (&x)[V], const float* p) {
  const typename VecOf<V>::T t =
      *reinterpret_cast<const typename VecOf<V>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int v = 0; v < V; ++v) x[v] = f[v];
}

// a run's operands: S steps of V channels
template <int V>
struct Run {
  float a[kRun / V][V], b[kRun / V][V];
};

constexpr int kStages = 3;     // rounds in the shared-memory ring

// 4V bytes from global p to shared s, asynchronously
template <int V>
__device__ __forceinline__ void cp_async(float* s, const float* p) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(sa), "l"(p));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(sa), "l"(p), "n"(4 * V));
}

// Issue the copies of the run from step t0 into this thread's slots of a
// ring stage (stage[j][threadIdx] for a, then for b): a and b at each
// step's pixel; the adjoint takes a at the pixel one step behind. Steps
// past L copy the last pixel again (take_run masks them).
template <int V, bool kAdj, bool kTail>
__device__ __forceinline__ void issue_run(float* stage, const float* a,
                                          const float* b, int sa, int sb,
                                          int t0, const Walk& walk) {
  constexpr int S = kRun / V;
  const int L = walk.L, nt = blockDim.x;
  int p = walk.at(kTail ? min(t0, L - 1) : t0);
  int pb = kAdj && t0 > 0 && t0 < L ? walk.prev(p) : p;
  float* sl = stage + threadIdx.x * V;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    cp_async<V>(sl + j * nt * V, a + (kAdj ? pb : p) * sa);
    cp_async<V>(sl + (S + j) * nt * V, b + p * sb);
    pb = p;
    if (j + 1 < S && (!kTail || t0 + j + 1 < L)) p = walk.next(p);
  }
}

// This thread's slots of a ring stage into registers; the adjoint's a is 0
// at the walk's first step, steps past L take a = 1, b = 0.
template <int V, bool kAdj>
__device__ __forceinline__ void take_run(Run<V>& r, const float* stage,
                                         int t0, int L) {
  constexpr int S = kRun / V;
  const int nt = blockDim.x;
  const float* sl = stage + threadIdx.x * V;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lds_v<V>(r.a[j], sl + j * nt * V);
    lds_v<V>(r.b[j], sl + (S + j) * nt * V);
    if ((kAdj && t0 + j == 0) || t0 + j >= L) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        r.a[j][v] = t0 + j >= L ? 1.f : 0.f;
        if (t0 + j >= L) r.b[j][v] = 0.f;
      }
    }
  }
}

template <int V, bool kAdj>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
scan2d_kernel(Scan2dArgs p) {
  constexpr int S = kRun / V;
  // the ring: kStages rounds of this block's a and b runs
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  // each warp's round total per (item, channel), by round parity: a warp
  // writes round r + 2's entry only after every warp passed round r + 1's
  // barrier
  __shared__ float2 agg[2][kMaxWarps][32 * V];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int G = 1 << p.lg, team = lane >> p.lg, item = lane & (G - 1);
  const int tile = blockIdx.x % p.tiles;
  const int bk = blockIdx.x / p.tiles;
  const int bi = bk / p.K, k = bk - bi * p.K;
  const int tw = min(p.tw, p.D / V - tile * p.tw);   // this tile's items
  const bool live = item < tw;
  const int c = (tile * p.tw + (live ? item : tw - 1)) * V;
  int dir = (p.dirs >> 4 * k) & 15;
  if (kAdj) dir = dir <= 2 ? dir + 2 : dir - 2;        // the reversed walk
  const Walk walk(dir, p.H, p.W);
  const int L = walk.L, D = p.D;
  const float* a = p.a + bi * p.sa[0] + k * p.sa[1] + c;
  const float* b = p.b + bi * p.sb[0] + k * p.sb[1] + c;
  float* out = p.out + (long long)bk * L * D + c;
  // pixel strides (the host checks that L of them fit in an int)
  const int sa = (int)p.sa[2], sb = (int)p.sb[2];
  const int run = (32 >> p.lg) * S;                    // steps per warp
  const int span = nw * run;                           // steps per round
  const int rounds = (L + span - 1) / span;
  const int full = L / span;                           // no step past L
  const int first = wid * run + team * S;              // in each round
  const int stage_floats = 2 * S * blockDim.x * V;
  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.f;

  // one commit group per round, empty past the last, so that waiting for
  // all but the kStages - 1 newest groups always completes round r
  auto issue = [&](int round) {
    if (round < rounds) {
      const int t0 = round * span + first;
      float* st = ring + (round % kStages) * stage_floats;
      if (round < full)
        issue_run<V, kAdj, false>(st, a, b, sa, sb, t0, walk);
      else
        issue_run<V, kAdj, true>(st, a, b, sa, sb, t0, walk);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int r = 0; r < kStages - 1; ++r) issue(r);
  for (int round = 0; round < rounds; ++round) {
    issue(round + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1));
    const int t0 = round * span + first;
    Run<V> r;
    take_run<V, kAdj>(r, ring + (round % kStages) * stage_floats, t0, L);
    // 1. the run's map from h = 0
    float P[V], h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) P[v] = 1.f, h[v] = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        h[v] = fmaf(r.a[j][v], h[v], r.b[j][v]);
        P[v] *= r.a[j][v];
      }
    }
    // 2. inclusive scan of the maps over the warp's teams (lane - o is the
    // same item o / G teams before), then the runs before this team's, and
    // the warp's total (its last team's)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      for (int o = G; o < 32; o <<= 1) {
        const float Pp = __shfl_up_sync(0xffffffffu, P[v], o);
        const float hp = __shfl_up_sync(0xffffffffu, h[v], o);
        if (lane >= o) {
          h[v] = fmaf(P[v], hp, h[v]);
          P[v] *= Pp;
        }
      }
    }
    float Pe[V], he[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Pe[v] = __shfl_up_sync(0xffffffffu, P[v], G);
      he[v] = __shfl_up_sync(0xffffffffu, h[v], G);
      if (team == 0) Pe[v] = 1.f, he[v] = 0.f;
      const float Pt = __shfl_sync(0xffffffffu, P[v], 32 - G + item);
      const float ht = __shfl_sync(0xffffffffu, h[v], 32 - G + item);
      if (team == 0) agg[round & 1][wid][item * V + v] = make_float2(Pt, ht);
    }
    // 3. fold the round's carry-in over the warps before this one (cw),
    // and on to the round's end
    __syncthreads();
    float cw[V];
#pragma unroll
    for (int v = 0; v < V; ++v) cw[v] = carry[v];
    for (int i = 0; i < nw; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (i == wid) cw[v] = carry[v];
        const float2 e = agg[round & 1][i][item * V + v];
        carry[v] = fmaf(e.x, carry[v], e.y);
      }
    }
    // 4. the recurrence from this run's carry-in, stored step by step
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = fmaf(Pe[v], cw[v], he[v]);
    const bool tail = round >= full;
    int px = walk.at(tail ? min(t0, L - 1) : t0);
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(r.a[j][v], h[v], r.b[j][v]);
      if (live && (!tail || t0 + j < L)) store_v<V>(out + px * D, h);
      if (j + 1 < S) px = walk.next(px);
    }
  }
}

template <int V, bool kAdj>
cudaError_t launch_mode(const Scan2dArgs& p, int blocks, int threads,
                        cudaStream_t s) {
  const int smem = kStages * 2 * kRun * threads * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      scan2d_kernel<V, kAdj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  scan2d_kernel<V, kAdj><<<blocks, threads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(const Scan2dArgs& p, int blocks, int threads,
                   bool adjoint, cudaStream_t s) {
  return adjoint ? launch_mode<V, true>(p, blocks, threads, s)
                 : launch_mode<V, false>(p, blocks, threads, s);
}

}  // namespace
}  // namespace ceigm

extern "C" int scan2d(const float* a, const float* b, float* out,
                      long long sa0, long long sa1, long long sa2,
                      long long sb0, long long sb1, long long sb2, int B,
                      int K, int H, int W, int D, int dir0, int dir1,
                      int dir2, int dir3, int adjoint, cudaStream_t stream) {
  using namespace ceigm;
  if (B < 1 || K < 1 || K > 4 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)H * W;
  for (long long x : {sa0, sa1, sa2, sb0, sb1, sb2})
    if (x < 0) return (int)cudaErrorInvalidValue;
  // pixel offsets are ints in the kernel (a's and b's, and out's within a
  // (b, k) chain), pixel indices exact in fp32
  if (L >= (1LL << 24) || L * D > 0x7fffffffLL
      || (L - 1) * (sa2 > sb2 ? sa2 : sb2) + D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the widest access that D, the strides and the pointers allow
  const int V = vec_width({D, sa0, sa1, sa2, sb0, sb1, sb2}, {a, b, out});
  // channel tiles of at most 32 items, of equal width; a team of G lanes
  // (the power of two at or above the width) per tile row
  const int items = D / V;
  const int tiles = (items + 31) / 32;
  const int tw = (items + tiles - 1) / tiles;
  int lg = 0;
  while ((1 << lg) < tw) ++lg;
  const long long blocks = (long long)B * K * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // rounds of at most kMaxWarps warps; as few warps as cover L in that
  // many rounds
  const long long run = (32 >> lg) * (kRun / V);
  const long long rounds = (L + kMaxWarps * run - 1) / (kMaxWarps * run);
  const int nw = (int)((L + rounds * run - 1) / (rounds * run));
  Scan2dArgs p{a, b, out, {sa0, sa1, sa2}, {sb0, sb1, sb2}, K, H, W, D,
               tiles, tw, lg,
               (dir0 & 15) | (dir1 & 15) << 4 | (dir2 & 15) << 8
               | (dir3 & 15) << 12};
  if (V == 4) return (int)launch<4>(p, (int)blocks, 32 * nw, adjoint != 0,
                                    stream);
  if (V == 2) return (int)launch<2>(p, (int)blocks, 32 * nw, adjoint != 0,
                                    stream);
  return (int)launch<1>(p, (int)blocks, 32 * nw, adjoint != 0, stream);
}
