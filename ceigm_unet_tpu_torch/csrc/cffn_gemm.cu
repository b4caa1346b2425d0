// CustomFfn's fc1 and fc2: C[M, N] = round_TW(A[M, K]) @ W + bias[N], fp32
// accumulation, one rounding to the output type.
//
// Replaces: the two matrix products inside ceigm_unet_tpu/ops/ffn_pallas.py
// _cffn_kernel (h = x @ w1 + b1; o = q.astype(w2.dtype) @ w2 + b2); the two
// stencils between them are in cffn.cu. fc1 reads x in the compute dtype and
// writes the fp32 hidden; fc2 reads the fp32 hidden, rounds it to the
// compute dtype (round to nearest even, as q.astype / a.to(w.dtype)) and
// writes the compute dtype.
//
// What bounds it on the H100: bytes. Per b128 224x224 forward fc1 writes and
// fc2 reads back the fp32 hidden, 1.65 GB, 1.11 ms of HBM time against
// ~0.25 ms of bf16 tensor-core time.
//
// bf16 weights (the bf16 regime): a persistent, warp-specialised Hopper
// GEMM. One block per SM walks output tiles of 128 rows by 128 columns (64
// where N <= 64). Its producer warp keeps TMA loads (cp.async.bulk.tensor)
// of the A and W tiles in flight, 64 of K per stage, into a ring of
// shared-memory stages guarded by full and empty mbarriers; the ring runs
// ahead into the next tile while the consumers write the current one, so
// at K 64-512 (1-8 stages a tile) the loads overlap the epilogue. Two
// consumer warpgroups each multiply 64 rows of the tile with
// wgmma.mma_async (m64n128k16 or m64n64k16), fp32 accumulators in
// registers: a bf16 A (fc1) straight from the 128-byte-swizzled tile; an
// fp32 A (fc2) read from its tile into registers and rounded to bf16
// there, so the hidden crosses HBM once. W is K-major, the (N, K) storage
// of nn.Linear. The epilogue adds the bias in fp32. fc1's fp32 hidden is
// staged in swizzled shared memory and leaves by TMA stores (whole 128-byte
// lines, clipped at M and N); fc2's bf16 output (696-byte rows at N 348,
// not a TMA pitch) by masked 4-byte stores from registers. TMA zero-fills
// the loads past M, N and K; it needs 16-byte row pitches, so the wrapper
// pads K to a multiple of 8 (ops/ffn.py gemm_operands).
//
// fp32 weights (the CLIs' fp32 regime, TF32 off): fp32 products and sums
// on the FMA pipes, no tensor cores, which bound it by operations (67
// TFLOP/s) at every CustomFfn shape. Blocks of 256 threads (2 an SM: 128
// registers a thread) multiply tiles of 128 x 128 (256 x 64 where N <= 64)
// as register-blocked outer products: each thread holds 8 x 8 sums in
// 4-wide sub-blocks and per K step reads its fragments as 4 float4 loads
// from k-major shared memory (rows padded, no bank conflict), 16 FFMAs per
// load. Both operands are K-contiguous (A (M, K), W nn.Linear's (N, K)):
// while a 32-wide K stage is multiplied, each thread fetches the next one
// as float4s into registers in two 16-wide halves and writes each half
// transposed into the other stage of a two-stage ring 12 K steps after
// fetching it, so the loads land unwaited and a block meets one
// __syncthreads per 32 K steps (2048 FFMAs a thread). Each output is summed
// over K in K order by one thread, as cuBLAS's sgemm sums it: at every
// CustomFfn shape the results equal torch.addmm's bit for bit (on an H100),
// and two calls give the same bits. K is not split: a split sums in
// another order, which moved the b2 train step's gradients away from the
// CPU's by more than the CPU's own reorder noise (chip_smoke.py phase 8).
// So tile counts just past a multiple of the SMs cost a part-empty round
// (fc2 at 14x14, b32: 147 tiles on 132 SMs). The epilogue adds the bias in
// fp32 and stores float4s masked at M and N.
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace ceigm {
namespace {

// --- the fp32 route (fp32 weights) ------------------------------------------

constexpr int kF32TileK = 32;    // K per ring stage: one barrier each

// Tiles of BM rows by TN columns, 128 x 128 (256 x 64 where N <= 64), in
// blocks of 256 threads (2 an SM: 128 registers a thread), each warp
// holding 64 x 32 sums, each thread 8 x 8: rows in sub-blocks of 4, 32
// apart, columns in two of 4, 16 apart.
template <int BM, int TN>
struct F32Config {
  static constexpr int kThreads = 256;
  static constexpr int kWarpsN = TN / 32;
  static_assert((BM / 64) * kWarpsN == 8, "8 warps a block");
  // K per fetch: a stage's K in two halves of 16, each fetched into
  // registers and written to shared memory while the stage before is
  // multiplied
  static constexpr int kFetchK = 16;
  static constexpr int kRowStep = kThreads / (kFetchK / 4);  // rows a pass
  // stage rows (one K each) padded by 4 floats: a fetch's transposing
  // stores then meet at most 2 to a bank, and every fragment read is a
  // fixed offset from one base
  static constexpr int kPitchA = BM + 4, kPitchW = TN + 4;
  static constexpr int kSmem = 2 * kF32TileK * (kPitchA + kPitchW) * 4;
};

// 4 floats of one row of C from p on: one float4 store where the row holds
// them and the address is 16-byte aligned (vec), else one float at a time
__device__ __forceinline__ void store_row4(float* p, float4 v, int left,
                                           bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (left > 1) p[1] = v.y;
  if (left > 2) p[2] = v.z;
  if (left > 3) p[3] = v.w;
}

// C[M, N] = A[M, K] @ W[N, K]^T + bias[N], fp32 (K a multiple of 4, A and
// W 16-byte aligned); block (x, y) computes tile (M tile y, N tile x) over
// the whole of K, in K order, as cuBLAS's sgemm sums it.
//
// Stage layout: k-major, As[k][m] and Ws[k][n], rows padded (F32Config).
// A thread fetches rows tid / 4 + kRowStep r of a tile at K offset
// 4 (tid % 4): the 4 lanes of one row read its 64 contiguous bytes of the
// half and write them transposed, one float to each of 4 stage rows.
template <int BM, int TN>
__global__ void __launch_bounds__(F32Config<BM, TN>::kThreads, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ C, int M,
                int N, int K) {
  using Cfg = F32Config<BM, TN>;
  constexpr int BK = kF32TileK, FK = Cfg::kFetchK, RS = Cfg::kRowStep;
  constexpr int LA = BM / RS, LW = TN / RS;   // float4 fetches a thread
  constexpr int PA = Cfg::kPitchA, PW = Cfg::kPitchW;
  extern __shared__ float4 f32_smem[];
  float* const As = reinterpret_cast<float*>(f32_smem);  // [2][BK][PA]
  float* const Ws = As + 2 * BK * PA;                    // [2][BK][PW]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;

  // global -> registers; rows past M or N and chunks past K load zeros
  const int q = tid & 3, row0 = tid >> 2;
  const float* const a_src = A + (size_t)(m0 + row0) * K + 4 * q;
  const float* const w_src = W + (size_t)(n0 + row0) * K + 4 * q;
  const int a_rows = M - m0 - row0, w_rows = N - n0 - row0;
  float4 ra[LA], rw[LW];
  // half h of stage kt: K [kt * BK + h * FK, + FK)
  auto fetch = [&](int kt, int h) {
    const int k = kt * BK + h * FK;
    const bool k_in = k + 4 * q < K;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < LA; ++r)
      ra[r] = k_in && RS * r < a_rows
                  ? __ldg(reinterpret_cast<const float4*>(
                        a_src + (size_t)RS * r * K + k))
                  : zero;
#pragma unroll
    for (int r = 0; r < LW; ++r)
      rw[r] = k_in && RS * r < w_rows
                  ? __ldg(reinterpret_cast<const float4*>(
                        w_src + (size_t)RS * r * K + k))
                  : zero;
  };
  // registers -> half h of stage buf: element i of a fetch is row
  // k = h * FK + 4q + i
  auto stage = [&](int buf, int h) {
    float* const as = As + buf * BK * PA + (h * FK + 4 * q) * PA + row0;
    float* const ws = Ws + buf * BK * PW + (h * FK + 4 * q) * PW + row0;
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      as[RS * r] = ra[r].x;
      as[PA + RS * r] = ra[r].y;
      as[2 * PA + RS * r] = ra[r].z;
      as[3 * PA + RS * r] = ra[r].w;
    }
#pragma unroll
    for (int r = 0; r < LW; ++r) {
      ws[RS * r] = rw[r].x;
      ws[PW + RS * r] = rw[r].y;
      ws[2 * PW + RS * r] = rw[r].z;
      ws[3 * PW + RS * r] = rw[r].w;
    }
  };

  // this thread's sums: rows wm*64 + i*32 + tm*4 + (0..3), columns
  // wn*32 + j*16 + tn*4 + (0..3), i, j < 2
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Cfg::kWarpsN, wn = warp % Cfg::kWarpsN;
  const int tm = lane >> 2, tn = lane & 3;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0, 0);
  stage(0, 0);
  fetch(0, 1);
  stage(0, 1);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    const float* const as = As + buf * BK * PA + wm * 64 + 4 * tm;
    const float* const ws = Ws + buf * BK * PW + wn * 32 + 4 * tn;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // the next stage's halves: each fetched 8 or 12 K steps ahead of
      // its transposing stores, so the loads land unwaited
      if (more && k == 0) fetch(kt + 1, 0);
      if (more && k == 8) {
        stage(buf ^ 1, 0);
        fetch(kt + 1, 1);
      }
      if (more && k == 20) stage(buf ^ 1, 1);
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + k * PA + 32 * i);
        a[4 * i] = v.x;
        a[4 * i + 1] = v.y;
        a[4 * i + 2] = v.z;
        a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(ws + k * PW + 16 * j);
        b[4 * j] = v.x;
        b[4 * j + 1] = v.y;
        b[4 * j + 2] = v.z;
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = n0 + wn * 32 + 16 * j + 4 * tn;
    if (col >= N) continue;
    float bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = col + e < N ? bias[col + e] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + wm * 64 + 32 * (i >> 2) + 4 * tm + (i & 3);
      if (row < M)
        store_row4(C + (size_t)row * N + col,
                   make_float4(acc[i][4 * j] + bv[0],
                               acc[i][4 * j + 1] + bv[1],
                               acc[i][4 * j + 2] + bv[2],
                               acc[i][4 * j + 3] + bv[3]),
                   N - col, vec);
    }
  }
}

// --- the Hopper route (bf16 weights) ----------------------------------------

constexpr int kTileM = 128;          // two consumer warpgroups of 64 rows
constexpr int kTileK = 64;           // K per stage: 128-byte bf16 rows
constexpr int kRowBytes = 128;       // one swizzled row of a stage tile
constexpr int kThreads = 384;        // consumers: warpgroups 0-1; producer: 2
constexpr int kSmemBudget = 200 * 1024;
// a wait this long (~9 s) means a lost arrival: trap instead of hanging
constexpr long long kHangCycles = 1LL << 34;

template <typename TA, int TN, bool kTmaStore>
struct TcConfig {
  static constexpr bool kF32A = std::is_same<TA, float>::value;
  // an fp32 A stage is two 32-column boxes (128-byte rows) side by side
  static constexpr int kABytes = kTileM * kRowBytes * (kF32A ? 2 : 1);
  static constexpr int kBBytes = TN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // fp32 output staged for the TMA store: per warpgroup TN / 32 boxes of
  // 64 rows x 32 floats
  static constexpr int kCBytes = kTmaStore ? kTileM * TN * 4 : 0;
  static constexpr int kRing = kSmemBudget - kCBytes;
  static constexpr int kStages = kRing / kStageBytes < 8 ? kRing / kStageBytes
                                                         : 8;
  // 1024 bytes of slack to align the buffers for the 128-byte swizzle
  static constexpr int kSmem =
      kCBytes + kStages * kStageBytes + 1024 + 2 * 8 * kStages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > kHangCycles) __trap();
  }
}

// 2-D TMA load of box (c0 = column, c1 = row) into shared memory; completes
// its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D TMA store of the box at (c0, c1) from shared memory, in the bulk
// group of the issuing thread
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0),
      "r"(c1) : "memory");
}

// this warpgroup's 128 threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// wgmma descriptor of a K-major tile as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: 128-byte rows, 8-row groups 1024 bytes apart,
// the tile 1024-byte aligned. Adding 2 moves it 16 bf16 along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma window
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16 bf16 x bf16 -> f32: ss takes A and B by descriptor, rs A from
// registers (each warp's 16 rows as the m16n8k16 A fragment); scale_d 0
// overwrites the accumulators
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else {
    p[0] = a;
    if (second) p[1] = b;
  }
}
__device__ __forceinline__ void store2(bf16* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else {
    p[0] = __float2bfloat16(a);
    if (second) p[1] = __float2bfloat16(b);
  }
}

// C[M, N] = round_bf16(A[M, K]) @ W[N, K]^T + bias, A bf16 or fp32 (tmA),
// W bf16 K-major (tmB), C fp32 or bf16; K a multiple of 8. With kTmaStore
// (fp32 C, N a multiple of 4) C is written by TMA stores through tmC.
template <typename TA, typename TO, int TN, bool kTmaStore>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap tmA,
               const __grid_constant__ CUtensorMap tmB,
               const __grid_constant__ CUtensorMap tmC,
               const float* __restrict__ bias, TO* __restrict__ C, int M,
               int N, int K) {
  using Cfg = TcConfig<TA, TN, kTmaStore>;
  constexpr int S = Cfg::kStages, R = TN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t cstage = (raw + 1023) & ~1023u;
  const uint32_t ring = cstage + Cfg::kCBytes;
  const uint32_t full = ring + S * Cfg::kStageBytes;  // S mbarriers
  const uint32_t empty = full + 8 * S;                // S mbarriers
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + kTileM - 1) / kTileM) * tiles_n;
  const int k_tiles = (K + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kTileM, n0 = (tile % tiles_n) * TN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t fb = full + 8 * stage;
          const uint32_t a = ring + stage * Cfg::kStageBytes;
          mbar_expect_tx(fb, Cfg::kStageBytes);
          tma_load(a, &tmA, fb, kt * kTileK, m0);
          if (Cfg::kF32A)
            tma_load(a + kTileM * kRowBytes, &tmA, fb, kt * kTileK + 32, m0);
          tma_load(a + Cfg::kABytes, &tmB, fb, kt * kTileK, n0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    int stage = 0;
    uint32_t phase = 0;
    float acc[R];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kTileM, n0 = (tile % tiles_n) * TN;
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * Cfg::kStageBytes;
        const uint64_t db = sw128_desc(a + Cfg::kABytes);
        if constexpr (Cfg::kF32A) {
          // this thread's rows 16 * warp + g (+ 8) of the warpgroup's 64:
          // float pairs at columns 2t (+ 8) of each 16-column step, from
          // the 16-byte chunk (col / 4) ^ (row % 8) of the swizzled row
          uint32_t af[4][4];
          const uint32_t row = a + (wg * 64 + warp * 16 + g) * kRowBytes;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t half = row + (s / 2) * kTileM * kRowBytes;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = (s % 2) * 16 + 8 * h + 2 * t;
              const uint32_t off = ((((c / 4) ^ g) << 4) | ((c % 4) * 4));
              float2 lo, hi;
              asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                           : "=f"(lo.x), "=f"(lo.y) : "r"(half + off));
              asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                           : "=f"(hi.x), "=f"(hi.y)
                           : "r"(half + 8 * kRowBytes + off));
              af[s][2 * h] = pack_bf16(lo.x, lo.y);
              af[s][2 * h + 1] = pack_bf16(hi.x, hi.y);
            }
          }
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            Wgmma<TN>::rs(acc, af[s], db + 2 * s, kt > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          if (lane == 0) mbar_arrive(empty + 8 * stage);
        } else {
          const uint64_t da = sw128_desc(a + wg * 64 * kRowBytes);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            Wgmma<TN>::ss(acc, da + 2 * s, db + 2 * s, kt > 0 || s > 0);
          wgmma_commit();
          // the previous stage's products are done: hand its buffer back
          wgmma_wait<1>();
          fence_regs(acc);
          if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (!Cfg::kF32A) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      // acc[4j + i]: row 16 * warp + g (+ 8 for i >= 2), column 8j + 2t
      // (+ 1 for odd i) of this warpgroup's 64 x TN block
      if constexpr (kTmaStore) {
        // the staging boxes as TMA reads them with the 128-byte swizzle;
        // TMA clips the rows and columns past M and N
        const uint32_t box0 = cstage + wg * 64 * TN * 4;
        const bool issuer = threadIdx.x % 128 == 0;
        if (issuer)  // the previous tile's stores have read the staging
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        warpgroup_sync(wg);
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float b0 = col < N ? bias[col] : 0.f;
          const float b1 = col + 1 < N ? bias[col + 1] : 0.f;
          const int cc = 8 * (j % 4) + 2 * t;  // column inside its box
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            const uint32_t dst = box0 + (j / 4) * 64 * kRowBytes +
                                 r * kRowBytes + (((cc / 4) ^ g) << 4) +
                                 (cc % 4) * 4;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(dst),
                         "f"(acc[4 * j + 2 * h] + b0),
                         "f"(acc[4 * j + 2 * h + 1] + b1) : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        warpgroup_sync(wg);
        if (issuer) {
          const int rm = m0 + wg * 64;
          for (int b = 0; b < TN / 32 && rm < M && n0 + 32 * b < N; ++b)
            tma_store(&tmC, box0 + b * 64 * kRowBytes, n0 + 32 * b, rm);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      } else {
        const int r0 = m0 + wg * 64 + warp * 16 + g;
        const bool even_n = (N % 2) == 0;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col >= N) continue;
          const bool second = col + 1 < N;
          const float b0 = bias[col], b1 = second ? bias[col + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r < M)
              store2(C + (long long)r * N + col, acc[4 * j + 2 * h] + b0,
                     acc[4 * j + 2 * h + 1] + b1, even_n && second, second);
          }
        }
      }
    }
    if (kTmaStore && threadIdx.x % 128 == 0)  // stores done before exit
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library links against the runtime alone
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// row-major (rows, cols) tensor, boxes of box_cols x box_rows (box_cols *
// elem_bytes == 128), 128-byte swizzle; out-of-bounds elements load as 0
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, bool f32,
                       uint64_t rows, uint64_t cols, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const uint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kRowBytes / elem), box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TA, typename TO, int TN, bool kTmaStore>
cudaError_t gemm_tc(const void* A, const void* W, const float* bias, void* C,
                    int M, int N, int K, cudaStream_t s) {
  using Cfg = TcConfig<TA, TN, kTmaStore>;
  CUtensorMap ta, tb, tc = {};
  cudaError_t err = tensor_map(&ta, A, Cfg::kF32A, M, K, kTileM);
  if (err == cudaSuccess) err = tensor_map(&tb, W, false, N, K, TN);
  if (err == cudaSuccess && kTmaStore)
    err = tensor_map(&tc, C, true, M, N, 64);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = gemm_tc_kernel<TA, TO, TN, kTmaStore>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((M + kTileM - 1) / kTileM) * ((N + TN - 1) / TN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, Cfg::kSmem, s>>>(ta, tb, tc, bias,
                                            static_cast<TO*>(C), M, N, K);
  return cudaGetLastError();
}

template <typename TA, typename TO>
cudaError_t gemm_bf16w(const void* A, const void* W, const float* bias,
                       void* C, int M, int N, int K, cudaStream_t s) {
  // TMA: 16-byte row pitches and 16-byte aligned bases
  if (K % 8 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return cudaErrorInvalidValue;
  // fp32 C (fc1, the hidden) leaves through TMA stores where its rows are
  // whole 16-byte units; bf16 C (fc2, 696-byte rows at N 348) from registers
  if constexpr (std::is_same<TO, float>::value) {
    if (N % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0) {
      if (N <= 64) return gemm_tc<TA, TO, 64, true>(A, W, bias, C, M, N, K, s);
      return gemm_tc<TA, TO, 128, true>(A, W, bias, C, M, N, K, s);
    }
  }
  if (N <= 64) return gemm_tc<TA, TO, 64, false>(A, W, bias, C, M, N, K, s);
  return gemm_tc<TA, TO, 128, false>(A, W, bias, C, M, N, K, s);
}

template <int BM, int TN>
cudaError_t gemm_f32_tiles(const float* A, const float* W, const float* bias,
                           float* C, int M, int N, int K, cudaStream_t s) {
  using Cfg = F32Config<BM, TN>;
  const dim3 grid((N + TN - 1) / TN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kernel = gemm_f32_kernel<BM, TN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Cfg::kThreads, Cfg::kSmem, s>>>(A, W, bias, C, M, N, K);
  return cudaGetLastError();
}

cudaError_t gemm_f32w(const void* A, const void* W, const float* bias,
                      void* C, int M, int N, int K, cudaStream_t s) {
  // float4 loads: 16-byte row pitches and 16-byte aligned bases
  if (K % 4 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* w = static_cast<const float*>(W);
  float* c = static_cast<float*>(C);
  if (N <= 64) return gemm_f32_tiles<256, 64>(a, w, bias, c, M, N, K, s);
  return gemm_f32_tiles<128, 128>(a, w, bias, c, M, N, K, s);
}

}  // namespace
}  // namespace ceigm

// W is (N, K) row-major, nn.Linear's weight, in both routes, and A and W
// are 16-byte aligned. fp32 weights: everything fp32, K a multiple of 4.
// bf16 weights: K a multiple of 8; fc1 takes a bf16 A and writes fp32, fc2
// an fp32 A and writes bf16.
extern "C" int cffn_gemm(const void* A, const void* W, const float* bias,
                         void* C, int M, int N, int K, int dtype_a,
                         int dtype_w, int dtype_o, cudaStream_t s) {
  using namespace ceigm;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype_a == kF32 && dtype_w == kF32 && dtype_o == kF32)
    return (int)gemm_f32w(A, W, bias, C, M, N, K, s);
  if (dtype_a == kBF16 && dtype_w == kBF16 && dtype_o == kF32)
    return (int)gemm_bf16w<bf16, float>(A, W, bias, C, M, N, K, s);
  if (dtype_a == kF32 && dtype_w == kBF16 && dtype_o == kBF16)
    return (int)gemm_bf16w<float, bf16>(A, W, bias, C, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
