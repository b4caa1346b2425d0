#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure raises and the script
exits non-zero without its last line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the hand-written kernels (``ceigm_unet_tpu_torch/csrc``);
3. kernels: each kernel against its plain PyTorch version at every shape
   the 224x224 forward gives it, at batch 2 in fp32 (TF32 off; rtol 1e-4,
   atol 1e-4 * max|plain|) and bf16 (rtol 3e-2, atol 5e-2 * max|plain|),
   and at batch 128 in bf16 (same bf16 tolerance; the batch of phase 6,
   large enough that every grid-stride loop repeats), where kernel and
   plain version are also timed with CUDA events;
4. model: MSVM-UNet gm_tiny (9 classes, seeded random weights) at 224x224,
   batch 2, fp32 on the card against the same model on the CPU (rtol 1e-3,
   atol 1e-3 * max|CPU logits|), and the kernel launches of one forward;
   then the bf16 forward on the card against the fp32 CPU logits (max abs
   error <= 0.05 * max|CPU logits|, tests/test_torch_model.py's bound);
5. serving (the main path): ``predict_volume`` in bf16, batch 32, on two
   seeded synthetic CT volumes of 40 x 512 x 512; launch counters are reset
   just before and read just after;
6. throughput: the batch-128 bf16 224x224 forward, slices/s; its logits
   are then held against the fp32 forward of the same batch on the card
   (max abs error <= 0.05 * max|fp32 logits|).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
IMG = 224
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 5e-2)}
MODEL_TOL = (1e-3, 1e-3)
BF16_MODEL_TOL = 0.05          # max abs error / max|fp32 logits|


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(*parts):
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, dtype) -> float:
    """Max abs error; fails past the dtype's tolerance."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail("non-finite kernel output")
    rtol, atol = TOL[dtype]
    scale = want.abs().max().item()
    err = (got - want).abs()
    bad = err > atol * max(scale, 1e-6) + rtol * want.abs()
    if bool(bad.any()):
        fail(f"kernel differs from its plain version: max abs err "
             f"{err.max().item():.3e} (max|plain| {scale:.3e}, {dtype})")
    return err.max().item()


# --- phase 3: kernels at the main-path shapes -------------------------------

def kernel_cases(dev):
    """name -> (route, source, replaces, [(shape tag, calls per forward,
    make(batch, dtype) -> (kernel fn, plain fn))])."""
    from ceigm_unet_tpu_torch.ops import ffn, grid_sample, quad_scan, tapconv
    gen = torch.Generator().manual_seed(SEED)

    def rnd(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def quad(H, W, D):
        def make(B, dt):
            K, L = 4, H * W
            args = [rnd((B, K, L, D), 1.0, dt), rnd((B, K, L, D), 0.5, dt),
                    rnd((B, K, L), 1.0, dt), rnd((B, K, L), 1.0, dt),
                    -torch.exp(rnd((K, D), 0.5)), rnd((K, D), 0.3),
                    rnd((K, D)), 1 + rnd((K, D), 0.1), rnd((K, D), 0.1),
                    H, W, (1, 2, 3, 4)]
            return (lambda: quad_scan.quad_scan_ln_cat(*args),
                    lambda: quad_scan.quad_scan_ln_cat_ref(*args))
        return make

    def gemm(L, K, N, hidden_in):
        def make(B, dt):
            a = rnd((B * L, K), 1.0, torch.float32 if hidden_in else dt)
            w, b = rnd((K, N), 0.05, dt), rnd((N,), 0.1)
            od = dt if hidden_in else torch.float32
            return (lambda: ffn.ffn_gemm(a, w, b, od),
                    lambda: ffn.ffn_gemm_ref(a, w, b, od))
        return make

    def dw3(H, W, HID):
        def make(B, dt):
            args = [rnd((B * H * W, HID)), rnd((3, 3, 1, HID), 0.2),
                    rnd((HID,), 0.1), H, W]
            return (lambda: ffn.dw3_gelu(*args),
                    lambda: ffn.dw3_gelu_ref(*args))
        return make

    def inc7(H, W, HID):
        def make(B, dt):
            g = HID // 8
            k, b = ffn.inception_composite(
                HID, g, rnd((3, 3, 1, g), 0.2), rnd((5, 5, 1, g), 0.1),
                rnd((7, 7, 1, g), 0.05), rnd((g,), .1), rnd((g,), .1),
                rnd((g,), .1), torch.float32)
            args = [rnd((B * H * W, HID)), k, b, H, W, HID - 3 * g]
            return (lambda: ffn.inception7(*args),
                    lambda: ffn.inception7_ref(*args))
        return make

    def gsample(H, W, C):
        def make(B, dt):
            x = rnd((B, H, W, C), 1.0, dt)
            ys = (torch.arange(2 * H) + 0.5) / H - 1
            xs = (torch.arange(2 * W) + 0.5) / W - 1
            base = torch.stack(torch.meshgrid(ys, xs, indexing="ij")[::-1],
                               dim=-1)
            grid = base[None, :, :, None, :].to(dev) + rnd(
                (B, 2 * H, 2 * W, 4, 2), 0.1 / H)
            return (lambda: grid_sample.dysample_grid_sample(x, grid),
                    lambda: grid_sample.dysample_grid_sample_ref(x, grid))
        return make

    def lgag(H, W, C):
        def make(B, dt):
            C2 = C // 2
            args = [rnd((B, H, W, C), 1.0, dt), rnd((B, H, W, C), 1.0, dt),
                    rnd((5, 5, 2, C2), 0.2), 1 + rnd((C2,), 0.1),
                    rnd((C2,), 0.1), rnd((C2,), 0.3), rnd((3,), 0.5)]
            return (lambda: tapconv.lgag_gate(*args),
                    lambda: tapconv.lgag_gate_ref(*args))
        return make

    ffn_blocks = [(14, 348, 1392, 3), (28, 128, 512, 2), (56, 64, 256, 2)]
    src = "ceigm_unet_tpu_torch/csrc/"
    return {
        "quad_scan_ln": ("cuda", src + "quad_scan_ln.cu",
                         "ceigm_unet_tpu/ops/quad_scan.py:542", [
                             ("56x56 D16", 5, quad(56, 56, 16)),
                             ("28x28 D32", 6, quad(28, 28, 32)),
                             ("14x14 D87", 12, quad(14, 14, 87)),
                             ("7x7 D112", 3, quad(7, 7, 112))]),
        "cffn_gemm": ("cuda", src + "cffn.cu",
                      "ceigm_unet_tpu/ops/ffn_pallas.py:114",
                      [(f"fc1 {s}x{s} {c}->{h}", n, gemm(s * s, c, h, False))
                       for s, c, h, n in ffn_blocks]
                      + [(f"fc2 {s}x{s} {h}->{c}", n, gemm(s * s, h, c, True))
                         for s, c, h, n in ffn_blocks]),
        "cffn_dw3_gelu": ("cuda", src + "cffn.cu",
                          "ceigm_unet_tpu/ops/ffn_pallas.py:114",
                          [(f"{s}x{s} HID{h}", n, dw3(s, s, h))
                           for s, c, h, n in ffn_blocks]),
        "cffn_inception7": ("cuda", src + "cffn.cu",
                            "ceigm_unet_tpu/ops/ffn_pallas.py:114",
                            [(f"{s}x{s} HID{h}", n, inc7(s, s, h))
                             for s, c, h, n in ffn_blocks]),
        "dysample_grid_sample": ("cuda", src + "grid_sample.cu",
                                 "ceigm_unet_tpu/ops/grid_sample.py:432", [
                                     ("7->14 C448", 1, gsample(7, 7, 448)),
                                     ("14->28 C348", 1, gsample(14, 14, 348)),
                                     ("28->56 C128", 1, gsample(28, 28, 128))]),
        "lgag_gate": ("cuda", src + "lgag.cu",
                      "ceigm_unet_tpu/ops/tapconv.py:117", [
                          ("14x14 C348", 1, lgag(14, 14, 348)),
                          ("28x28 C128", 1, lgag(28, 28, 128)),
                          ("56x56 C64", 1, lgag(56, 56, 64))]),
    }


def phase_kernels(dev, gpu):
    results = {}
    bf16 = torch.bfloat16
    for name, (route, source, replaces, cases) in kernel_cases(dev).items():
        errs = {(2, torch.float32): 0.0, (2, bf16): 0.0, (128, bf16): 0.0}
        ms = plain_ms = 0.0
        for tag, calls, make in cases:
            for batch, dt in errs:
                kern, plain = make(batch, dt)
                err = compare(kern(), plain(), dt)
                errs[batch, dt] = max(errs[batch, dt], err)
            # kern, plain: the batch-128 bf16 pair, already checked
            k_ms, p_ms = time_ms(kern, 10), time_ms(plain, 3)
            ms += calls * k_ms
            plain_ms += calls * p_ms
            log(f"kernel {name} [{tag}] x{calls}/forward: b128 bf16 "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, max abs err {err:.3e}"
                f" | {gpu}")
            del kern, plain
        log(f"kernel {name}: max abs err b2 fp32 "
            f"{errs[2, torch.float32]:.3e}, b2 bf16 {errs[2, bf16]:.3e}, "
            f"b128 bf16 {errs[128, bf16]:.3e}; per b128 bf16 forward "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
        results[name] = dict(
            name=name, route=route, source=source, replaces=replaces,
            max_abs_err=errs[2, torch.float32],
            max_abs_err_bf16=errs[2, bf16],
            max_abs_err_bf16_b128=errs[128, bf16], ms=ms, plain_ms=plain_ms)
    torch.cuda.empty_cache()
    return results


# --- phases 4-6 -------------------------------------------------------------

# launches of one 224x224 gm_tiny forward: 26 quad blocks (19 encoder, 7
# decoder); 7 CustomFfn (2 GEMMs + 2 stencils each); 3 DySample; 3 LGAG
PER_FORWARD = {"quad_scan_ln": 26, "cffn_gemm": 14, "cffn_dw3_gelu": 7,
               "cffn_inception7": 7, "dysample_grid_sample": 3,
               "lgag_gate": 3}


def check_counts(counts, forwards: int, what: str):
    want = {k: v * forwards for k, v in PER_FORWARD.items()}
    if dict(counts) != want:
        fail(f"{what}: kernel launches {dict(counts)}, expected {want}")


def phase_model(dev):
    from ceigm_unet_tpu_torch.models import build_model
    from ceigm_unet_tpu_torch.ops import _build
    model = build_model(num_classes=9, enc_name="gm_tiny", seed=SEED)
    x = torch.randn((2, IMG, IMG, 1),
                    generator=torch.Generator().manual_seed(SEED + 1))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model(x)
    cpu_s = time.perf_counter() - t0
    model.to(dev)
    _build.reset_launch_counts()
    with torch.no_grad():
        got = model(x.to(dev))
    torch.cuda.synchronize()
    check_counts(_build.launch_counts, 1, "one gm_tiny forward")
    got = got.cpu()
    if got.shape != (2, IMG, IMG, 9) or not bool(torch.isfinite(got).all()):
        fail(f"logits {tuple(got.shape)} not finite or wrong shape")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rtol, atol = MODEL_TOL
    if bool(((got - want).abs() > atol * scale + rtol * want.abs()).any()):
        fail(f"gm_tiny logits on the card differ from the CPU: max abs err "
             f"{err:.3e}, max|logit| {scale:.3e}")
    log(f"model gm_tiny 224x224 b2 fp32: card vs CPU max abs err {err:.3e} "
        f"(max|logit| {scale:.3e}, tol rtol {rtol} atol {atol}*max); "
        f"launches {dict(_build.launch_counts)}; CPU forward {cpu_s:.1f} s")
    model.dtype = torch.bfloat16
    with torch.no_grad():
        got = model(x.to(dev))
    if got.dtype != torch.bfloat16:
        fail(f"bf16 forward returned {got.dtype} logits")
    bf_err = check_bf16(got, want, "gm_tiny b2 bf16 logits on the card vs "
                        "fp32 on the CPU")
    log(f"model gm_tiny 224x224 b2 bf16: card vs fp32 CPU max abs err "
        f"{bf_err:.3e} (max|logit| {scale:.3e}, tol {BF16_MODEL_TOL}*max)")
    return model


def check_bf16(got, want, what: str) -> float:
    """Max abs error of bf16 logits against fp32 ones; fails past
    BF16_MODEL_TOL * max|want|."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: {tuple(got.shape)} not finite or wrong shape")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > BF16_MODEL_TOL * scale:
        fail(f"{what}: max abs err {err:.3e} > {BF16_MODEL_TOL} * "
             f"max|fp32| {scale:.3e}")
    return err


def phase_serving(model, dev, gpu):
    from ceigm_unet_tpu_torch.eval.volume import predict_volume
    from ceigm_unet_tpu_torch.ops import _build
    rng = np.random.default_rng(SEED)
    volumes = []
    for _ in range(2):
        # smooth CT-like intensities in [0, 1]: low-frequency noise
        coarse = rng.random((40, 16, 16)).astype(np.float32)
        vol = np.kron(coarse, np.ones((1, 32, 32), np.float32))
        volumes.append(np.clip(vol + 0.05 * rng.standard_normal(
            vol.shape).astype(np.float32), 0, 1))
    _build.reset_launch_counts()
    times = []
    for vol in volumes:
        t0 = time.perf_counter()
        pred = predict_volume(model, vol, (IMG, IMG), batch_size=32)
        times.append((time.perf_counter() - t0) * 1e3)
        if pred.shape != vol.shape or pred.min() < 0 or pred.max() >= 9:
            fail(f"label map {pred.shape} or labels outside [0, 9)")
    counts = dict(_build.launch_counts)
    check_counts(counts, 4, "serving two 40-slice volumes at batch 32")
    log(f"serving: 2 volumes (40, 512, 512) bf16 batch 32: "
        f"{times[0]:.1f} ms, {times[1]:.1f} ms per volume "
        f"(first includes warm-up) | {gpu}")
    return counts


def phase_throughput(model, dev, gpu):
    x = torch.randn((128, IMG, IMG, 1), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 2))
    ts = []
    with torch.no_grad():
        for i in range(13):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if i == 3:
                torch.cuda.reset_peak_memory_stats()
            start.record()
            logits = model(x)
            end.record()
            end.synchronize()
            if i >= 3:
                ts.append(start.elapsed_time(end))
        mem = torch.cuda.max_memory_allocated() / 2**30
        model.dtype = torch.float32
        want = model(x)
        model.dtype = torch.bfloat16
    err = check_bf16(logits, want, "b128 bf16 logits vs the fp32 forward")
    med = statistics.median(ts)
    spread = (max(ts) - min(ts)) / (2 * med)
    log(f"throughput b128 224x224 bf16: {128e3 / med:.2f} slices/s, median "
        f"{med:.3f} ms over {len(ts)} runs, spread +-{100 * spread:.2f}%, "
        f"max memory {mem:.2f} GiB; logits vs fp32 on the card max abs err "
        f"{err:.3e} (max|logit| {want.abs().max().item():.3e}, tol "
        f"{BF16_MODEL_TOL}*max) | {gpu}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ceigm_unet_tpu_torch.ops import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.build().name})")
    kernels = phase_kernels(dev, gpu)
    model = phase_model(dev)
    counts = phase_serving(model, dev, gpu)
    phase_throughput(model, dev, gpu)
    for name, n in counts.items():
        kernels[name]["launches"] = n
    if any("launches" not in k for k in kernels.values()):
        fail("a kernel was not launched on the main path")
    log(gpu)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
