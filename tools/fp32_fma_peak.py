"""The fp32 FMA rate one H100 reaches in the inner loop of the port's fp32
GEMM (``csrc/cffn_gemm.cu`` ``gemm_f32_kernel``), without the GEMM around it.

    python tools/fp32_fma_peak.py

Two loops, each over 8 x 8 register outer products per thread (2 blocks of
256 threads per SM, 4 waves of blocks), 16 K steps an iteration: FFMAs
alone, and FFMAs with the GEMM's fragment reads from shared memory (4
float4 loads per step, the same lane layout). Each runs ~2.5 s; prints
TFLOP/s beside the data sheet's 67 TFLOP/s, with the SM clock and power
sampled by nvidia-smi meanwhile, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
template <bool LDS>
__global__ void __launch_bounds__(256, 2) fma_loop(float* out, int iters) {
  __shared__ float4 sm4[2 * 16 * 256 / 4];
  float* sm = reinterpret_cast<float*>(sm4);
  for (int i = threadIdx.x; i < 2 * 16 * 256; i += 256) sm[i] = i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, tm = lane >> 2, tn = lane & 3;
  float a[8], b[8], acc[8][8];
  for (int i = 0; i < 8; ++i) {
    a[i] = threadIdx.x * 1e-3f + i;
    b[i] = 0.5f * i;
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
    const float* as = sm + (it & 1) * 4096 + wm * 64 + 4 * tm;
    const float* ws = sm + (it & 1) * 4096 + 2048 + wn * 32 + 4 * tn;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (LDS) {
        for (int i = 0; i < 2; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(as + k * 128 + 32 * i);
          const float4 u =
              *reinterpret_cast<const float4*>(ws + k * 128 + 16 * i);
          a[4 * i] = v.x; a[4 * i + 1] = v.y;
          a[4 * i + 2] = v.z; a[4 * i + 3] = v.w;
          b[4 * i] = u.x; b[4 * i + 1] = u.y;
          b[4 * i + 2] = u.z; b[4 * i + 3] = u.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float t = 0.f;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 8; ++j) t += acc[i][j];
  out[blockIdx.x * 256 + threadIdx.x] = t;
}
extern "C" int fma_run(float* out, int blocks, int iters, int lds,
                       cudaStream_t s) {
  if (lds) fma_loop<true><<<blocks, 256, 0, s>>>(out, iters);
  else fma_loop<false><<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
ITERS = 2000
PEAK = 67e12                 # H100 SXM fp32 outside the tensor cores


def main() -> int:
    if not torch.cuda.is_available():
        print("fp32_fma_peak: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from ceigm_unet_tpu_torch.ops import _build
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "fma.cu", Path(tmp) / "fma.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib_path), str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
    lib.fma_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p]
    blocks = 4 * 2 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")

    def run(lds):
        err = lib.fma_run(ctypes.c_void_p(out.data_ptr()), blocks, ITERS, lds,
                          torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fma_loop failed to launch: cudaError_t {err}")

    for lds, what in ((0, "FFMA alone"),
                      (1, "FFMA + the GEMM's fragment reads")):
        run(lds)
        torch.cuda.synchronize()
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader", "-lms", "300"], stdout=subprocess.PIPE,
            text=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0, n = time.time(), 0
        start.record()
        while time.time() - t0 < 2.5:
            for _ in range(5):
                run(lds)
                n += 1
            torch.cuda.synchronize()
        end.record()
        end.synchronize()
        smi.terminate()
        samples = [s for s in smi.communicate()[0].splitlines() if s][1:6]
        flops = 2.0 * 64 * 16 * ITERS * blocks * 256 * n
        rate = flops / (start.elapsed_time(end) * 1e-3)
        print(f"{what}: {rate / 1e12:.2f} TFLOP/s fp32 ({rate / PEAK:.3f} of "
              f"67); SM clock, power: {samples} | {gpu}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
