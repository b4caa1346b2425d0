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
// way at 56x56, b128: 8 bytes per element, 0.987 ms per b128 forward for
// each stencil at 3.35 TB/s).
//
// cffn_dw3_gelu stages an 8x8-pixel, 32-channel halo tile in shared memory
// and reads every tap from there.
//
// cffn_inception7 computes, on the channels [n_id, HID), q + the 49-tap
// composite 7x7 of q (zero padding) + b, for any taps; on [0, n_id), the
// channels that the inception split passes through, 2q + b. One launch,
// two kinds of block, interleaved in proportion so that the compute-heavy
// tap blocks run beside the streaming identity blocks:
// - Tap blocks. A block takes kRows = 7 output rows (7 divides 14, 28 and
//   56) by tw columns (whole-width strips at 14x14 and 28x28, two 28-wide
//   tiles at 56x56) of 32 channels, one per lane. Staging: one step fills
//   the 13 x (tw+6) x 32 halo tile in shared memory (zeros outside the
//   image; a compile-time row pitch, so every tap read is an immediate
//   offset), each warp access whole pixels' 128-byte channel rows, 16
//   bytes a lane where n_id, HID and the pointer allow (8 at HID 1392,
//   n_id 870), all of a thread's loads issued before any is stored,
//   positions advanced by increments (no divides). Compute: a thread (one
//   channel, one column) walks the strip's 13 input rows top to bottom;
//   each input row's 7 values are read from shared memory once and added
//   into the up to 7 output rows they reach, with the 49 taps in registers:
//   7 shared reads per output instead of 49. The halo costs 13/7 of the
//   tile's reads from L2 where the strip has rows above and below it.
// - Identity blocks: 2q + b over [0, n_id) of a range of pixels as an
//   elementwise pass, 16 loads in flight per thread, 16-byte items where
//   HID and the pointers allow (a pixel's last item stores only its
//   channels below n_id).
// The 49 taps, 7 accumulators and 7 inputs need ~100 registers: at three
// blocks per SM (80 registers) the compute step spilled and the kernel
// took 2.5x as long; at two (128) it does not.
//
// For the fusion of the two stencils (keeping GELU(dw3(h)) out of device
// memory), a later kernel changes only the tap blocks' staging step: it
// reads h for a tile one pixel wider on each side (15 x (tw+8)), computes
// gelu(dw3(h) + dwb) into the 13 x (tw+6) halo tile (zero outside the
// image, as now: the 7x7's padding is of q, not of h), and keeps the
// tile's centre for the residual; the compute step stays. The identity
// blocks then compute q = gelu(dw3(h) + dwb) of their channels too (a 3x3
// halo of h), since 2q + b needs q; and the dw3 taps and bias join the
// kernel's arguments.
//
// Versions (b128 per forward, device ms, python -m
// ceigm_unet_tpu_torch.kernel_ab --kernels cffn_stencil on an H100 80GB
// HBM3, 700 W, each against its predecessor in one call; PERF.md): an 8x8
// tile per block, 49 shared reads per output, the identity channels
// walked 8 pixels per thread with 4-byte accesses: 3.0045; this design
// with 8-row strips at three blocks per SM (spilling), the identity
// blocks after the tap blocks: 2.7933; 7-row strips, the blocks
// interleaved: 2.5730; a compile-time pitch, still at three blocks per SM:
// 4.0288; at two: 1.6679; 16 identity loads in flight: 1.6193; 16-byte
// identity items, one staging batch: 1.5477 (bound 0.9867).
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

// gelu(depthwise3x3(h) + bias) over NHWC fp32 (B, H, W, HID), 'same' zero
// padding. A block takes an 8x8 pixel tile of 32 channels: it stages the
// 10x10 halo in shared memory (coalesced 128-byte channel rows), then each
// warp computes one tile row for its 32 channels with the taps in
// registers.
constexpr int kTile = 8;

__global__ void __launch_bounds__(256)
dw3_gelu_kernel(const float* __restrict__ in, const float* __restrict__ taps,
                const float* __restrict__ bias, float* __restrict__ out,
                int H, int W, int HID) {
  constexpr int S = kTile + 2;
  __shared__ float tile[S][S][32];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const long long base = (long long)blockIdx.z * H * W * HID;
  const int y = y0 + row;
  const int cb = blockIdx.y * 32;
  for (int e = threadIdx.x; e < S * S * 32; e += 256) {
    const int cc = e & 31, pix = e >> 5;
    const int sy = pix / S, sx = pix % S;
    const int yy = y0 + sy - 1, xx = x0 + sx - 1;
    tile[sy][sx][cc] = (yy >= 0 && yy < H && xx >= 0 && xx < W &&
                        cb + cc < HID)
        ? in[base + ((long long)yy * W + xx) * HID + cb + cc] : 0.f;
  }
  __syncthreads();
  const int c = cb + lane;
  if (c >= HID || y >= H) return;
  float w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = taps[t * HID + c];
  const float bc = bias[c];
  for (int j = 0; j < kTile && x0 + j < W; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        acc += tile[row + ky][j + kx][lane] * w[ky * 3 + kx];
    out[base + ((long long)y * W + x0 + j) * HID + c] = gelu_as(acc + bc);
  }
}

// --- cffn_inception7 --------------------------------------------------------

constexpr int kRows = 7;       // output rows per tap block (7 | 14, 28, 56)
constexpr int kHalo = 3;       // the 7x7's reach
constexpr int kTR = kRows + 2 * kHalo;   // staged rows
// staging loads in flight per thread: one batch for the model's tiles
// (16 at 28 columns of 16-byte items, 19 at 14 of 8-byte ones)
__host__ __device__ constexpr int staging_batch(int V) {
  return V == 4 ? 16 : V == 2 ? 20 : 24;
}
constexpr int kIdLoads = 16;   // identity loads in flight per thread
constexpr int kMaxTw = 32;     // tile columns
constexpr int kPitch = kMaxTw + 2 * kHalo;   // staged columns, any tile
                                             // width: compile-time offsets
constexpr int kMaxWarps = 7;   // per block (two blocks per SM)

struct IncArgs {
  const float* q; const float* taps; const float* bias; float* out;
  int H, W, HID, n_id;
  int tw, tiles_x, tiles_y, groups;   // tap blocks
  long long tap_blocks, blocks;  // tap blocks, all blocks
  int id_pix, id_items;        // identity blocks: pixels, items per pixel
  int id_v;                    // identity item width (floats)
  int id_dq, id_dr;            // blockDim = id_dq pixels + id_dr items
  long long M;                 // B*H*W pixels
};

// A tap block: stage the halo tile of channels c0 .. c0+31 with V-wide
// items, then the sliding-window 7x7.
template <int V>
__device__ __forceinline__ void tap_block(const IncArgs& p, float* tile,
                                          int blk) {
  const int S_c = p.tw + 2 * kHalo;        // staged columns
  const int g = blk % p.groups;
  int rest = blk / p.groups;
  const int tx = rest % p.tiles_x;
  rest /= p.tiles_x;
  const int ty = rest % p.tiles_y;
  const int bi = rest / p.tiles_y;
  const int y0 = ty * kRows, x0 = tx * p.tw;
  const int c0 = p.n_id + g * 32;
  const int nch = min(32, p.HID - c0);
  const float* q = p.q + (long long)bi * p.H * p.W * p.HID + c0;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. staging: thread -> (pixel of the tile, V-wide item of its 32
  // channels); the pixel advances by `step` (dr rows, dc columns) per load
  {
    constexpr int ipp = 32 / V;            // items per pixel
    const int it = tid % ipp;
    const int step = nt / ipp;
    const int n_pix = kTR * S_c;
    int e = tid / ipp;
    int sr = e / S_c, sc = e - sr * S_c;
    const int dr = step / S_c, dc = step - dr * S_c;
    const bool ch_ok = it * V < nch;
    constexpr int kBatch = staging_batch(V);
    for (; e < n_pix; ) {
      float r[kBatch][V];
      int dst[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int yy = y0 + sr - kHalo, xx = x0 + sc - kHalo;
        const bool in = e < n_pix && ch_ok && yy >= 0 && yy < p.H &&
                        xx >= 0 && xx < p.W;
        if (in) {
          load_v<V>(r[j], q + ((long long)yy * p.W + xx) * p.HID + it * V);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) r[j][v] = 0.f;
        }
        dst[j] = e < n_pix ? (sr * kPitch + sc) * 32 + it * V : -1;
        e += step;
        sr += dr;
        sc += dc;
        if (sc >= S_c) sc -= S_c, ++sr;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (dst[j] >= 0) store_v<V>(tile + dst[j], r[j]);
    }
  }
  __syncthreads();

  // 2. the 7x7: thread -> (channel lane, columns wid, wid + nw, ...)
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int c = c0 + min(lane, nch - 1);
  float w[49];
#pragma unroll
  for (int t = 0; t < 49; ++t) w[t] = p.taps[t * p.HID + c];
  const float bc = p.bias[c];
  float* out = p.out + (long long)bi * p.H * p.W * p.HID + c;
  for (int col = wid; col < p.tw && x0 + col < p.W; col += nw) {
    float acc[kRows];
#pragma unroll
    for (int o = 0; o < kRows; ++o) acc[o] = 0.f;
    const float* t_col = tile + col * 32 + lane;
#pragma unroll
    for (int s = 0; s < kTR; ++s) {
      float x[7];
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) x[kx] = t_col[(s * kPitch + kx) * 32];
      // input row s reaches output rows s - 6 .. s (tap row s - o)
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        if (o <= s && s - o < 7) {
#pragma unroll
          for (int kx = 0; kx < 7; ++kx)
            acc[o] = fmaf(x[kx], w[(s - o) * 7 + kx], acc[o]);
        }
      }
    }
    if (lane < nch) {
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        const int y = y0 + o;
        if (y < p.H) {
          const float centre = t_col[((o + kHalo) * kPitch + kHalo) * 32];
          out[((long long)y * p.W + x0 + col) * p.HID] = centre + acc[o] + bc;
        }
      }
    }
  }
}

// An identity block: 2q + b over channels [0, n_id) of pixels
// blk * id_pix .. +id_pix, as (pixel, V-wide item) pairs advanced by
// blockDim pairs at a time. V needs to divide HID, not n_id: a pixel's last
// item may reach past n_id (into its tap channels), and stores only the
// channels below n_id.
template <int V>
__device__ __forceinline__ void identity_block(const IncArgs& p, int blk) {
  const long long px0 = (long long)blk * p.id_pix;
  const int n_pix = (int)min((long long)p.id_pix, p.M - px0);
  int pix = threadIdx.x / p.id_items;
  int it = threadIdx.x - pix * p.id_items;
  const float* q = p.q + px0 * p.HID;
  float* out = p.out + px0 * p.HID;
  while (pix < n_pix) {
    float r[kIdLoads][V];
    int off[kIdLoads], ch[kIdLoads];
#pragma unroll
    for (int j = 0; j < kIdLoads; ++j) {
      ch[j] = it * V;
      off[j] = pix < n_pix ? pix * p.HID + ch[j] : -1;
      if (off[j] >= 0) load_v<V>(r[j], q + off[j]);
      pix += p.id_dq;
      it += p.id_dr;
      if (it >= p.id_items) it -= p.id_items, ++pix;
    }
#pragma unroll
    for (int j = 0; j < kIdLoads; ++j) {
      if (off[j] >= 0) {
        float bv[V];
        load_v<V>(bv, p.bias + ch[j]);
#pragma unroll
        for (int v = 0; v < V; ++v) r[j][v] = fmaf(2.f, r[j][v], bv[v]);
        if (ch[j] + V <= p.n_id) {
          store_v<V>(out + off[j], r[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (ch[j] + v < p.n_id) out[off[j] + v] = r[j][v];
        }
      }
    }
  }
}

// Tap and identity blocks interleave in proportion (block j is a tap block
// when floor((j + 1) T / N) > floor(j T / N), T tap blocks of N), so the
// compute-heavy tap blocks run beside the streaming identity blocks.
template <int V>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
inception7_kernel(IncArgs p) {
  extern __shared__ float tile[];
  const long long j = blockIdx.x;
  const long long t0 = j * p.tap_blocks / p.blocks;
  const long long t1 = (j + 1) * p.tap_blocks / p.blocks;
  if (t1 > t0) tap_block<V>(p, tile, (int)t0);
  else if (p.id_v == 4) identity_block<4>(p, (int)(j - t0));
  else if (p.id_v == 2) identity_block<2>(p, (int)(j - t0));
  else identity_block<1>(p, (int)(j - t0));
}

template <int V>
cudaError_t launch_inception7(const IncArgs& p, int blocks, int threads,
                              size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      inception7_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  inception7_kernel<V><<<blocks, threads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int cffn_dw3_gelu(const float* h, const float* dwk,
                             const float* dwb, float* q, int B, int H, int W,
                             int HID, cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || H <= 0 || W <= 0 || HID <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile),
                  (HID + 31) / 32, B);
  dw3_gelu_kernel<<<grid, 256, 0, s>>>(h, dwk, dwb, q, H, W, HID);
  return (int)cudaGetLastError();
}

extern "C" int cffn_inception7(const float* q, const float* inck,
                               const float* incb, float* out, int B, int H,
                               int W, int HID, int n_id, cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || H <= 0 || W <= 0 || HID <= 0 || n_id < 0 || n_id > HID)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  // pixel offsets within a block's range, and pixel indices, are ints
  if ((long long)H * W * HID > 0x7fffffffLL || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  IncArgs p{};
  p.q = q; p.taps = inck; p.bias = incb; p.out = out;
  p.H = H; p.W = W; p.HID = HID; p.n_id = n_id; p.M = M;
  // tap blocks: columns in tiles of at most kMaxTw of equal width, rows in
  // kRows strips, channels in groups of 32
  p.tiles_x = (W + kMaxTw - 1) / kMaxTw;
  p.tw = (W + p.tiles_x - 1) / p.tiles_x;
  p.tiles_y = (H + kRows - 1) / kRows;
  p.groups = (HID - n_id + 31) / 32;
  const long long tap_blocks = (long long)B * p.tiles_y * p.tiles_x * p.groups;
  // as few warps as give each the same number of columns, at most
  // kMaxWarps
  const int per = (p.tw + kMaxWarps - 1) / kMaxWarps;
  const int nw = (p.tw + per - 1) / per;
  const int threads = 32 * nw;
  // tap blocks' staging and identity blocks' items: the widest access
  // their channel offsets and pointers allow
  const int V = vec_width({n_id, HID}, {q});
  p.id_v = vec_width({HID}, {q, incb, out});
  // identity blocks: ~kIdLoads items per thread
  p.id_items = (n_id + p.id_v - 1) / p.id_v;
  long long id_blocks = 0;
  if (p.id_items > 0) {
    p.id_pix = (threads * kIdLoads + p.id_items - 1) / p.id_items;
    p.id_dq = threads / p.id_items;
    p.id_dr = threads - p.id_dq * p.id_items;
    id_blocks = (M + p.id_pix - 1) / p.id_pix;
  }
  if (tap_blocks + id_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tap_blocks = tap_blocks;
  p.blocks = tap_blocks + id_blocks;
  const int blocks = (int)p.blocks;
  const size_t smem = (size_t)kTR * kPitch * 32 * sizeof(float);
  if (V == 4) return (int)launch_inception7<4>(p, blocks, threads, smem, s);
  if (V == 2) return (int)launch_inception7<2>(p, blocks, threads, smem, s);
  return (int)launch_inception7<1>(p, blocks, threads, smem, s);
}
