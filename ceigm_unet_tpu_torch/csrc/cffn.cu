// CustomFfn: fc1 GEMM + b1 -> depthwise 3x3 + b -> GELU -> q + composite
// 7x7(q) + b -> fc2 GEMM + b2, as two kinds of kernel with an fp32 hidden.
//
// Replaces: ceigm_unet_tpu/ops/ffn_pallas.py _cffn_call / _cffn_kernel
// (with _dw_shift; entry custom_ffn_fused).
//
// The TPU kernel computes fc1 and fc2 inside its body; here they are the
// hand-written GEMM cffn_gemm (cffn_gemm.cu), and this file holds the one
// kernel between them, cffn_dw3_inception7: from the fp32 hidden h that
// fc1 writes it computes q = gelu(dw3(h) + dwb) and then q + composite
// 7x7(q) + incb, so q never exists in device memory. The hidden between
// the kernels is fp32, as in _cffn_kernel.
//
// What bounds it on the H100: bytes (h read once and the result written
// once, 8 bytes per element of the hidden: 411 MB at 56x56, b128, 0.987 ms
// per b128 forward at 3.35 TB/s). Instruction issue comes close (the
// erf-GELU of every q, the halo's included, and up to 49 FMAs per tapped
// output), and what the kernel reaches is set by latency: the 7x7's 49
// taps in registers allow two blocks of 7 warps per SM (128 registers; at
// three blocks, 80, the 7x7 spilled and took 2.5x as long), too few warps
// to hide a round trip to memory behind another block's work.
//
// One launch, two kinds of block, interleaved in proportion so that the
// compute-heavy tap blocks run beside the streaming identity blocks. Both
// walk up to kStrips strips of kRows = 7 rows (7 divides 14, 28 and 56)
// top to bottom, stage h in shared memory by asynchronous copies (all of a
// thread's in flight at once, in 16-byte items where n_id, HID and the
// pointer allow: 8 at HID 1392, n_id 870; zeros outside the image: dw3's
// padding of h), and have the next strip's h rows in flight while they
// compute the current one:
// - Tap blocks, the channels [n_id, HID), 32 per block, one per lane, over
//   tw columns (whole width at 14x14 and 28x28, two 28-wide tiles at
//   56x56). A block first reads which reach R its group's taps need
//   (1 to 3: the composite's 3x3, 5x5 and 7x7 groups) and runs the 7x7 at
//   that reach. It keeps two rings of tile rows: the 7 + 2R q rows one
//   7x7 reads, and 9 h rows. q row r (0 outside the image: the 7x7's zero
//   padding is of q, where gelu(dwb) would be wrong) comes from h rows r-1
//   .. r+1 by a rolling 3x3 window down each column, into the slot of a q
//   row no window reads any more. Then the 7x7: a thread (one channel,
//   columns wid, wid+7, ...) walks the window's q rows, each row's 2R+1
//   values read from shared memory once and added into the up to 2R+1
//   output rows they reach, with the taps in registers; the residual q is
//   the window's centre.
// - Identity blocks, the channels [0, n_id) that the inception split
//   passes through: 2q + incb, 32 channels by up to 48 columns, through a
//   ring of 16 h rows; a thread walks a strip's 9 rows, adding each row's
//   3 values into the up to 3 output rows they reach. A block's last group
//   may reach past n_id into the tap channels: it stores only the channels
//   below n_id.
//
// Versions (b128 per forward, device ms, python
// tools/port_stencil_variants.py --lgag on copies of each one's csrc/, all
// in one call, on an H100 80GB HBM3, 700 W; the parent's cffn_dw3_gelu +
// cffn_inception7: 4.0844 in kernel_ab, bound 0.9868; PERF.md): one strip
// per tap block, the q tile computed in place with one barrier per q row:
// 3.2602; the reach per group and strips walked through one ring, spilling
// up to 396 bytes: 3.3695; seven q rows held in registers per barrier
// (1.2 KB spilled): 3.7871; separate q and h rings, no barrier within the
// q phase: 2.8377; the next strip's h rows in flight during the 7x7:
// 2.7405; identity blocks walking strips with a prefetch: 2.6705; dw3's
// sum in the plain version's order: 2.6279 (this one; with the exact
// GELU: 3.1821). Slower and dropped: the q phase's rows unrolled (4.7939,
// 3.0041), 8 warps per block (2.7793), 144 registers by __maxnreg__
// (3.9761), and, in another call, 2 strips per tap block (2.7222 against
// this one's 2.6244).
#include "common.cuh"

namespace ceigm {
namespace {

// Abramowitz-Stegun 7.1.26 erf GELU (ops/activations.py), fp32:
// erf(t) = 1 - p(u) exp(-t^2) with u = 1 / (1 + P t) for t = |x| / sqrt 2,
// so gelu(x) = x (1 - e) for x >= 0 and x e below, e = p(u) exp(-t^2) / 2
// (p's coefficients halved). The reciprocal and the exponential by the
// approximate instructions: a few ulps. chip_smoke.py's train step reads
// the same gradient margins with these as with the plain version's exact
// forms, which cost the kernel a fifth more time; what moved those margins
// past their limit was the order of dw3's sum, which therefore follows the
// plain version's (the taps row by row, the bias last).
__device__ __forceinline__ float gelu_as(float x) {
  const float t = fabsf(x) * 0.7071067811865476f;
  const float u = __fdividef(1.f, fmaf(0.3275911f, t, 1.f));
  const float p = u * (0.127414796f + u * (-0.142248368f + u * (
      0.7107068705f + u * (-0.7265760135f + u * 0.5307027145f))));
  // exp(-t^2) = 2^(-x^2 log2(e) / 2)
  const float e = p * ex2(x * x * -0.7213475204444817f);
  return x * (x >= 0.f ? 1.f - e : e);
}

constexpr int kRows = 7;       // output rows per strip (7 | 14, 28, 56)
constexpr int kWarps = 7;      // per block (two blocks per SM)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTw = 32;     // tap tile columns
constexpr int kPitch = kMaxTw + 8;   // a tap tile's row pitch in pixels, any
                                     // reach: compile-time offsets
// a tap block's rings at reach 3: the 13 q rows one 7x7 reads, and 9 h rows
// (7 q rows' inputs); 112.6 KB, two blocks per SM
constexpr int kSlots = (kRows + 6) + (kRows + 2);
// strips a tap block walks: 4 of 8 at 56x56 (the first strip's 6 halo q
// rows are computed once per 4), all of them at 14x14 and 28x28
constexpr int kStrips = 4;
constexpr size_t kSmem = (size_t)kSlots * kPitch * 32 * sizeof(float);
// identity tile columns: a ring of 16 rows of kMaxIw + 2 pixels fits the
// tap blocks' shared memory
constexpr int kMaxIw = 48;
static_assert(16 * (kMaxIw + 2) * 32 * sizeof(float) <= kSmem,
              "an identity block's ring fits a tap block's shared memory");

struct Args {
  const float* h; const float* dwk; const float* dwb;
  const float* inck; const float* incb; float* out;
  int H, W, HID, n_id;
  int tiles_y;                             // strips of kRows rows
  int tw, tiles_x, groups, ts, chunks_y;   // tap blocks: ts strips each
  int iw, itiles_x, igroups, ichunks;      // identity blocks: ts strips
  long long tap_blocks, blocks;            // tap blocks, all blocks
};

template <int B>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  // src-size 0 fills the item with zeros and reads nothing
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(B), "r"(valid ? B : 0));
}

// Stage rows x cols pixels of channels c0 .. c0+31 (nch of them) in V-wide
// items into a ring of S rows of `pitch` pixels of 32 floats: image pixel
// (yo + r, xo + c) of the image at src (channel c0) into row (slot0 + r)
// mod S, column c; 0 outside the image and past nch. Thread -> (pixel,
// item), advanced by increments; every item is an asynchronous copy, so all
// of them are in flight at once without holding registers (staged() waits
// for them).
template <int V>
__device__ __forceinline__ void stage(float* tile, int pitch, int slot0,
                                      int S, const float* src, int rows,
                                      int cols, int yo, int xo, int H, int W,
                                      int HID, int nch) {
  constexpr int ipp = 32 / V;              // items per pixel
  constexpr int step = kThreads / ipp;
  const int it = threadIdx.x % ipp;
  const int n_pix = rows * cols;
  const int dr = step / cols, dc = step - dr * cols;
  const bool ch_ok = it * V < nch;
  int e = threadIdx.x / ipp;
  int sr = e / cols, sc = e - sr * cols;
  for (; e < n_pix; e += step) {
    const int yy = yo + sr, xx = xo + sc;
    const bool in = ch_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const int slot = slot0 + sr - (slot0 + sr >= S ? S : 0);
    cp_async<4 * V>(tile + (slot * pitch + sc) * 32 + it * V,
                    in ? src + ((long long)yy * W + xx) * HID + it * V : src,
                    in);
    sr += dr;
    sc += dc;
    if (sc >= cols) sc -= cols, ++sr;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's staging copies, then for the block's.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// A tap block at reach R (its taps zero outside the centred (2R+1)^2
// window): strips ty0 .. ty1-1 of tile columns x0 .. x0+tw-1, channels
// c0 .. c0+31, walked top to bottom. Two rings of tile rows: QS = 7 + 2R q
// rows (q row r in slot r mod QS: one strip's 7x7 window) and HS = 9 h rows
// (h row r in slot r mod HS). The first strip's window is computed in
// rounds of at most 7 q rows (each staging the h rows past the two it
// keeps). Each later strip needs 7 new q rows, from 7 new h rows: those are
// staged into the slots of h rows already spent while the previous strip's
// 7x7 runs, so the copies' latency hides behind it; the new q rows then
// take the slots of the window rows no later window reads.
template <int V, int R>
__device__ __forceinline__ void tap_strips(const Args& p, float* tile,
                                           int g, int tx, int ty0, int ty1,
                                           int bi) {
  constexpr int QS = kRows + 2 * R;        // q ring: a 7x7 window
  constexpr int HS = kRows + 2;            // h ring
  constexpr int K = 2 * R + 1;             // taps per row
  constexpr int kQC = (kMaxTw + 2 * R + kWarps - 1) / kWarps;
  constexpr int P32 = kPitch * 32;
  float* qt = tile;
  float* ht = tile + QS * P32;
  const int x0 = tx * p.tw;
  const int c0 = p.n_id + g * 32, nch = min(32, p.HID - c0);
  const long long img = (long long)bi * p.H * p.W * p.HID;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = c0 + min(lane, nch - 1);
  const int n_q = p.tw + 2 * R;            // q columns from image x0 - R
  // ring slots of image rows r > -64
  auto qslot = [](int r) { return (r + 64 * QS) % QS; };
  auto hslot = [](int r) { return (r + 64 * HS) % HS; };
  // q rows qmax+1 .. qmax+m from the staged h rows qmax .. qmax+m+1: q row
  // r (image column x0-R+j) from h rows r-1 .. r+1, columns j .. j+2 (a
  // rolling window down each of a thread's columns); 0 outside the image
  auto q_rows = [&](int qmax, int m) {
    float wq[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wq[t] = p.dwk[t * p.HID + c];
    const float bq = p.dwb[c];
#pragma unroll
    for (int k = 0; k < kQC; ++k) {
      const int j = wid + k * kWarps;
      if (j >= n_q) continue;
      const int xx = x0 - R + j;
      const bool col_in = xx >= 0 && xx < p.W;
      const float* h_col = ht + j * 32 + lane;
      float* q_col = qt + j * 32 + lane;
      int hoff = hslot(qmax) * P32, qoff = qslot(qmax + 1) * P32;
      float win[2][3];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) win[r][dx] = h_col[hoff + dx * 32];
        hoff += P32;
        hoff -= hoff >= HS * P32 ? HS * P32 : 0;
      }
      for (int i = 0; i < m; ++i) {
        float nx[3];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) nx[dx] = h_col[hoff + dx * 32];
        hoff += P32;
        hoff -= hoff >= HS * P32 ? HS * P32 : 0;
        // the taps row by row, then the bias: the plain version's order
        float acc = 0.f;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc = fmaf(win[0][dx], wq[dx], acc);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc = fmaf(win[1][dx], wq[3 + dx], acc);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc = fmaf(nx[dx], wq[6 + dx], acc);
        const int yy = qmax + 1 + i;
        q_col[qoff] = col_in && yy >= 0 && yy < p.H ? gelu_as(acc + bq) : 0.f;
        qoff += P32;
        qoff -= qoff >= QS * P32 ? QS * P32 : 0;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          win[0][dx] = win[1][dx];
          win[1][dx] = nx[dx];
        }
      }
    }
  };
  // stage h rows h0 .. h0+n-1 (issued, not waited for)
  auto stage_h = [&](int h0, int n) {
    stage<V>(ht, kPitch, hslot(h0), HS, p.h + img + c0, n, n_q + 2, h0,
             x0 - R - 1, p.H, p.W, p.HID, nch);
  };

  // 1. the first strip's window, q rows y0-R .. y0+6+R, in rounds of at
  // most kRows q rows (9 h rows, then 2R more)
  int qmax = ty0 * kRows - R - 1;          // last q row computed
  int hmax = qmax - 1;                     // last h row staged
  while (qmax < ty0 * kRows + 6 + R) {
    const int m = min(kRows, ty0 * kRows + 6 + R - qmax);
    __syncthreads();   // the h slots about to be written are read no more
    stage_h(hmax + 1, qmax + m + 1 - hmax);
    staged();
    hmax = qmax + m + 1;
    q_rows(qmax, m);
    qmax += m;
  }
  for (int ty = ty0; ty < ty1; ++ty) {
    const int y0 = ty * kRows;
    const bool next = ty + 1 < ty1;
    __syncthreads();   // the window is complete, its h rows are spent
    // 2. the next strip's 7 new h rows, in flight during this 7x7 (their
    // slots held h rows this strip's q rows needed)
    if (next) stage_h(hmax + 1, kRows);

    // 3. the 7x7 at reach R: thread -> (channel lane, columns wid, wid + 7,
    // ...); q row s of the window (image row y0-R+s) is read once and added
    // into the up to K output rows it reaches; output row o is stored when
    // its last tap row has been added, with q's centre as the residual
    float w[K * K];
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        w[dy * K + dx] = p.inck[((dy + 3 - R) * 7 + dx + 3 - R) * p.HID + c];
    const float bc = p.incb[c];
    const long long row = (long long)p.W * p.HID;
    const int off0 = qslot(y0 - R) * P32;
    for (int col = wid; col < p.tw && x0 + col < p.W; col += kWarps) {
      float acc[kRows];
#pragma unroll
      for (int o = 0; o < kRows; ++o) acc[o] = 0.f;
      const float* t_col = qt + col * 32 + lane;
      float* o_col = p.out + img + c + (y0 * p.W + x0 + col) * (long long)p.HID;
      int off = off0;
#pragma unroll
      for (int s = 0; s < QS; ++s) {
        float x[K];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) x[kx] = t_col[off + kx * 32];
        // q row s reaches output rows s - 2R .. s (tap row s - o)
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          if (o <= s && s - o < K) {
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
              acc[o] = fmaf(x[kx], w[(s - o) * K + kx], acc[o]);
          }
        }
        if (s >= 2 * R) {
          // output row o = s - 2R is complete; its residual q is R rows up
          const int o = s - 2 * R;
          if (lane < nch && y0 + o < p.H) {
            const int oc = off - R * P32 + (off < R * P32 ? QS * P32 : 0);
            o_col[o * row] = t_col[oc + R * 32] + acc[o] + bc;
          }
        }
        off += P32;
        off -= off >= QS * P32 ? QS * P32 : 0;
      }
    }
    // 4. the next strip's 7 new q rows, into the slots of this window's
    // first 7 rows
    if (next) {
      staged();   // the copies landed; every thread is done with the 7x7
      hmax += kRows;
      q_rows(qmax, kRows);
      qmax += kRows;
    }
  }
}

// The reach a tap group's taps need (1 to 3: the composite's 3x3, 5x5 and
// 7x7 groups), the same for every thread of the block.
__device__ __forceinline__ int tap_reach(const Args& p, int c) {
  bool r3 = false, r2 = false;
#pragma unroll
  for (int t = 0; t < 49; ++t) {
    const int dy = t / 7 - 3, dx = t % 7 - 3;
    const int d = max(abs(dy), abs(dx));
    if (d >= 2) {
      const bool nz = p.inck[t * p.HID + c] != 0.f;
      if (d == 3) r3 = r3 || nz;
      else r2 = r2 || nz;
    }
  }
  if (__syncthreads_or(r3)) return 3;
  return __syncthreads_or(r2) ? 2 : 1;
}

template <int V>
__device__ __forceinline__ void tap_block(const Args& p, float* tile,
                                          int blk) {
  const int g = blk % p.groups;
  int rest = blk / p.groups;
  const int tx = rest % p.tiles_x;
  rest /= p.tiles_x;
  const int cy = rest % p.chunks_y;
  const int bi = rest / p.chunks_y;
  const int ty0 = cy * p.ts, ty1 = min(ty0 + p.ts, p.tiles_y);
  const int c0 = p.n_id + g * 32;
  const int c = c0 + min((int)(threadIdx.x & 31), min(32, p.HID - c0) - 1);
  const int R = tap_reach(p, c);
  if (R == 3) tap_strips<V, 3>(p, tile, g, tx, ty0, ty1, bi);
  else if (R == 2) tap_strips<V, 2>(p, tile, g, tx, ty0, ty1, bi);
  else tap_strips<V, 1>(p, tile, g, tx, ty0, ty1, bi);
}

// An identity block: 2q + incb over channels c0 .. c0+31 (those below
// n_id) of up to kStrips strips of kRows rows by iw columns, walked top to
// bottom through a ring of 16 h rows (h row r in slot r mod 16) of iw+2
// pixels: a strip reads its 9 rows while the next strip's 7 new rows are
// in flight into the slots of rows already spent. A thread (one channel,
// columns wid, wid+7, ...) walks a strip's 9 rows, adding each row's 3
// values into the up to 3 output rows they reach.
template <int V>
__device__ __forceinline__ void identity_block(const Args& p, float* tile,
                                               int blk) {
  constexpr int IS = 16;                   // ring slots
  const int g = blk % p.igroups;
  int rest = blk / p.igroups;
  const int tx = rest % p.itiles_x;
  rest /= p.itiles_x;
  const int cy = rest % p.ichunks;
  const int bi = rest / p.ichunks;
  const int ty0 = cy * p.ts, ty1 = min(ty0 + p.ts, p.tiles_y);
  const int x0 = tx * p.iw;
  const int c0 = g * 32;
  const int nch = min(32, p.HID - c0);
  const int pitch = p.iw + 2;
  const int rs = pitch * 32;               // a ring row's floats
  const long long img = (long long)bi * p.H * p.W * p.HID;
  auto stage_h = [&](int h0, int n) {
    stage<V>(tile, pitch, (h0 + IS) % IS, IS, p.h + img + c0, n, pitch, h0,
             x0 - 1, p.H, p.W, p.HID, nch);
  };
  stage_h(ty0 * kRows - 1, kRows + 2);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = c0 + min(lane, nch - 1);
  float w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = p.dwk[t * p.HID + c];
  const float bc = p.dwb[c], ib = p.incb[c];
  const bool store = c0 + lane < p.n_id;
  const long long row = (long long)p.W * p.HID;
  for (int ty = ty0; ty < ty1; ++ty) {
    const int y0 = ty * kRows;
    staged();   // this strip's rows landed; the last strip's reads are done
    if (ty + 1 < ty1) stage_h(y0 + kRows + 1, kRows);
    const int off0 = ((y0 - 1 + IS) % IS) * rs;
    for (int col = wid; col < p.iw && x0 + col < p.W; col += kWarps) {
      // the taps row by row, then the bias: the plain version's order
      float acc[kRows];
#pragma unroll
      for (int o = 0; o < kRows; ++o) acc[o] = 0.f;
      const float* t_col = tile + col * 32 + lane;
      int off = off0;
#pragma unroll
      for (int s = 0; s < kRows + 2; ++s) {
        float x[3];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) x[kx] = t_col[off + kx * 32];
        off += rs;
        off -= off >= IS * rs ? IS * rs : 0;
        // h row s reaches output rows s - 2 .. s (tap row s - o)
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          if (o <= s && s - o < 3) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[o] = fmaf(x[kx], w[(s - o) * 3 + kx], acc[o]);
          }
        }
      }
      if (store) {
        float* o_col = p.out + img + c +
                       (y0 * p.W + x0 + col) * (long long)p.HID;
#pragma unroll
        for (int o = 0; o < kRows; ++o)
          if (y0 + o < p.H)
            o_col[o * row] = fmaf(2.f, gelu_as(acc[o] + bc), ib);
      }
    }
  }
}

// Tap and identity blocks interleave in proportion (block j is a tap block
// when floor((j + 1) T / N) > floor(j T / N), T tap blocks of N), so the
// compute-heavy tap blocks run beside the streaming identity blocks.
template <int V, int VI>
__global__ void __launch_bounds__(kThreads, 2)
dw3_inception7_kernel(Args p) {
  extern __shared__ float tile[];
  const long long j = blockIdx.x;
  const long long t0 = j * p.tap_blocks / p.blocks;
  const long long t1 = (j + 1) * p.tap_blocks / p.blocks;
  if (t1 > t0) tap_block<V>(p, tile, (int)t0);
  else identity_block<VI>(p, tile, (int)(j - t0));
}

template <int V, int VI>
cudaError_t launch(const Args& p, int blocks, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      dw3_inception7_kernel<V, VI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  // all of the SM's shared memory, for two blocks of 112.6 KB
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dw3_inception7_kernel<V, VI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return err;
  dw3_inception7_kernel<V, VI><<<blocks, kThreads, kSmem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ceigm

extern "C" int cffn_dw3_inception7(const float* h, const float* dwk,
                                   const float* dwb, const float* inck,
                                   const float* incb, float* out, int B,
                                   int H, int W, int HID, int n_id,
                                   cudaStream_t s) {
  using namespace ceigm;
  if (B <= 0 || H <= 0 || W <= 0 || HID <= 0 || n_id < 0 || n_id > HID)
    return (int)cudaErrorInvalidValue;
  // pixel offsets within an image are ints
  if ((long long)H * W * HID > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args p{};
  p.h = h; p.dwk = dwk; p.dwb = dwb; p.inck = inck; p.incb = incb;
  p.out = out;
  p.H = H; p.W = W; p.HID = HID; p.n_id = n_id;
  p.tiles_y = (H + kRows - 1) / kRows;
  // tap blocks: columns in tiles of at most kMaxTw of equal width, channels
  // in groups of 32, each walking up to kStrips strips
  p.tiles_x = (W + kMaxTw - 1) / kMaxTw;
  p.tw = (W + p.tiles_x - 1) / p.tiles_x;
  p.groups = (HID - n_id + 31) / 32;
  p.ts = min(p.tiles_y, kStrips);
  p.chunks_y = (p.tiles_y + p.ts - 1) / p.ts;
  const long long tap_blocks = (long long)B * p.tiles_x * p.groups *
                               p.chunks_y;
  // identity blocks: tiles of at most kMaxIw columns, groups of 32
  // channels, ts strips
  p.itiles_x = (W + kMaxIw - 1) / kMaxIw;
  p.iw = (W + p.itiles_x - 1) / p.itiles_x;
  p.igroups = (n_id + 31) / 32;
  p.ichunks = p.chunks_y;
  const long long id_blocks = (long long)B * p.ichunks * p.itiles_x *
                              p.igroups;
  if (tap_blocks + id_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tap_blocks = tap_blocks;
  p.blocks = tap_blocks + id_blocks;
  // the widest item the channel offsets and the pointer allow: tap groups
  // start at n_id + 32 g, identity groups at 32 g
  const int V = vec_width({n_id, HID}, {h});
  const int VI = vec_width({HID}, {h});
  const int blocks = (int)p.blocks;
  if (V == 4) return (int)launch<4, 4>(p, blocks, s);
  if (V == 2) return VI == 4 ? (int)launch<2, 4>(p, blocks, s)
                             : (int)launch<2, 2>(p, blocks, s);
  if (VI == 4) return (int)launch<1, 4>(p, blocks, s);
  if (VI == 2) return (int)launch<1, 2>(p, blocks, s);
  return (int)launch<1, 1>(p, blocks, s);
}
