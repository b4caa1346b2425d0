"""Time kernels as this checkout builds them against the same entry points
built from another checkout's ``csrc/``, on one card, in turns.

    python -m ceigm_unet_tpu_torch.kernel_ab --base OTHER/ceigm_unet_tpu_torch/csrc

Both libraries are built with the same flags (``ops/_build.py``). Each
case is checked against its plain version on both, then timed with CUDA
events in the order base, this, this, base; the line per case prints both
medians and the bound. The cases are K8 (``scan2d``, scan and adjoint
modes) at the b48 224x224 training shapes of gm_tiny and of the legacy
tiny_0230s, as device time, on contiguous operands and in the layouts the
backward hands it (each entry point called directly, one without strides
on contiguous copies as its wrapper made them, and through this
checkout's wrapper, also with the host in the loop; a base that refuses a
shape is left out of it), and K3's GEMM (``cffn_gemm``) at
the six fc1/fc2 shapes of a b128 bf16 224x224 gm_tiny forward, beside the
bf16-output ``torch.addmm`` and, for fc1, the fp32-output one (the same
function). This checkout's GEMM is timed through ``ffn_gemm``, its
wrapper's padding included, and alone on the padded operands; the base's
entry point is called directly: on x as it is, with bf16 weights as
(K, N) rows, when its ``csrc/`` predates ``cffn_gemm.cu``, and otherwise on
the padded operands of this checkout's launch. Then the same six shapes
with fp32 weights at the b32 and b48 fp32 forwards (the test-set and
training CLIs' route, TF32 off), as device time: the base's entry point
(with W as (K, N) rows, copied outside the timing, where its fp32 route
takes them), this checkout through ``ffn_gemm`` and its launch alone, and
``torch.addmm``, beside the bound at the fp32 FMA peak. Then the
grid-sample kernels (``csrc/grid_sample.cu``) at the b128 bf16 224x224
forward's shapes: K4 (``dysample_grid_sample``, 4 groups) at DySample's
three upsamplings, and K6/K7 (``grid_sample_bilinear``) at the per-group
images of the ``dysample_grouped=False`` route and one non-2x size, each
entry point called directly on both libraries, beside ``F.grid_sample``
on the same data. Then K13 (``csrc/dwconv3.cu``) in both modes at the four
quad-block shapes of a b128 bf16 gm_tiny forward (the forward on the
in-projection's channel slice, the flip mode on a contiguous cotangent),
each entry point called directly with the tap layout its library takes,
and through this checkout's wrapper, beside ``F.conv2d`` /
``F.conv_transpose2d`` (``groups=C``); and K10 (``csrc/sscan_dir.cu``) at
the four tiny_0230s SS2D shapes of a b128 bf16 legacy forward with a
stride-0 u; and K1 / K14 (``csrc/quad_scan_ln.cu`` ``quad_scan_ln`` and
``quad_scan_ln_q8``) at the four gm_tiny quad-block shapes of a b128 bf16
forward in the model's strided layout; and K3's stencils between its
GEMMs, dw3+GELU and the inception 7x7 (``cffn_dw3_inception7``, or a
base's ``cffn_dw3_gelu`` followed by its ``cffn_inception7``, timed as one
case) at the three b128 CustomFfn shapes beside ``F.conv2d`` of the 7x7
alone; and K5 (``lgag_gate``) at the three b128 bf16 shapes of the
decoder's eval gates; and the selective scan's row kernels
(``csrc/scan_rows.cu``): K12 (``selective_scan_n1``) at the reference
speed test's shape (B 128, D 96, N 1, L 4096, bf16 in) with fp32 and with
bf16 out, and K11 (``scan_rows``) at the row shapes of the public op's
forward calls and, on the flipped operands its backward hands it, of its
backward calls (each entry point called directly, and through this
checkout's wrapper, also with the host in the loop; a base whose
``selective_scan_n1`` takes fp32 B and C gets fp32 copies made outside the
timed region, as its wrapper made them). These are device times: the queue
is held behind a spin kernel while the timed calls are enqueued, so host
time per call does not enter. ``--kernels`` picks groups of cases (all by
default). Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from ceigm_unet_tpu_torch.ops import (_build, dwconv, ffn, grid_sample,
                                      quad_scan, tapconv)
from ceigm_unet_tpu_torch.ops import selective_scan as ss

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12           # outside the tensor cores
# (tag, calls per unfrozen b48 step: the SS2D or quad blocks at that shape,
# side, D); each block's backward runs K8 once in each mode
GM_TINY = [("gm_tiny 56x56 D16", 5, 56, 16), ("gm_tiny 28x28 D32", 6, 28, 32),
           ("gm_tiny 14x14 D87", 12, 14, 87), ("gm_tiny 7x7 D112", 3, 7, 112)]
LEGACY = [("tiny_0230s 56x56 D96", 4, 56, 96),
          ("tiny_0230s 28x28 D192", 4, 28, 192),
          ("tiny_0230s 14x14 D384", 10, 14, 384),
          ("tiny_0230s 7x7 D768", 2, 7, 768)]
# (tag, calls per b128 forward, H*W, K, N, fc2): fc1 and fc2 of the 7
# decoder CustomFfns (3 at 14x14, 2 at 28x28, 2 at 56x56)
FFN = [(f"fc{2 if fc2 else 1} {s}x{s} {k}->{n}", calls, s * s, k, n, fc2)
       for fc2 in (False, True)
       for s, c, h, calls in ((14, 348, 1392, 3), (28, 128, 512, 2),
                              (56, 64, 256, 2))
       for k, n in [(h, c) if fc2 else (c, h)]]

# (tag, calls per b128 forward, images, H, W, C, Ho, Wo, groups; 0 for the
# single-grid entry point)
GRID_SAMPLE = [
    ("K4 7->14 C448", 1, 128, 7, 7, 448, 14, 14, 4),
    ("K4 14->28 C348", 1, 128, 14, 14, 348, 28, 28, 4),
    ("K4 28->56 C128", 1, 128, 28, 28, 128, 56, 56, 4),
    ("K6/K7 7->14 C112 x4 groups", 1, 512, 7, 7, 112, 14, 14, 0),
    ("K6/K7 14->28 C87 x4 groups", 1, 512, 14, 14, 87, 28, 28, 0),
    ("K6/K7 28->56 C32 x4 groups", 1, 512, 28, 28, 32, 56, 56, 0),
    ("K7 14x14->20x24 C87 (not on the path)", 0, 128, 14, 14, 87, 20, 24,
     0)]
# (side, C, quad blocks at that shape per b128 forward): K13 runs once per
# block forward, its flip mode once per block backward
DWCONV = [(56, 64, 5), (28, 128, 6), (14, 348, 12), (7, 448, 3)]
# (side, D, SS2D blocks per legacy forward): K10 runs once per block
SSCAN_DIR = [(56, 96, 4), (28, 192, 4), (14, 384, 10), (7, 768, 2)]
# spin cycles ahead of a device timing (~20 ms at the H100's clock): the
# host enqueues the timed calls meanwhile
SPIN_CYCLES = 40_000_000


def _scan2d_takes_strides(lib, csrc: Path) -> bool:
    """Whether ``csrc``'s ``scan2d`` takes a's and b's strides (an older
    one takes contiguous operands only); declares the entry point's
    arguments on ``lib`` accordingly."""
    strided = "long long sa0" in (csrc / "scan2d.cu").read_text()
    _P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.scan2d.argtypes = ([_P] * 3 + ([_L] * 6 if strided else [])
                           + [_I] * 10 + [_P])
    return strided


def _scan2d(lib, strided, a, b, S, adjoint):
    """The C entry ``scan2d`` of ``lib``; an entry point without strides
    gets contiguous copies of a and b, as its wrapper made them."""
    if not strided:
        a, b = a.contiguous(), b.contiguous()
    B, K, _, D = a.shape
    out = torch.empty((B, K, S * S, D), dtype=torch.float32, device=a.device)
    p = _build.ptr
    strides = [*a.stride()[:3], *b.stride()[:3]] if strided else []
    err = lib.scan2d(p(a), p(b), p(out), *strides, B, K, S, S, D, 1, 2, 3,
                     4, int(adjoint), _stream())
    if err:
        raise RuntimeError(f"scan2d failed to launch: cudaError_t {err}")
    return out


def _time(fn, reps=10):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_time(fn, reps=20):
    """ms per call of the device's work alone: the calls are enqueued
    behind a spin kernel, so the host's time per call does not enter."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _gemm(lib, a, w, bias, out_dtype, rows_nk):
    """The C entry ``cffn_gemm`` of ``lib``; w is the bf16 weight in the
    layout that library takes."""
    M, K = a.shape
    N = w.shape[0] if rows_nk else w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    codes = _build.DTYPE_CODES
    err = lib.cffn_gemm(_build.ptr(a), _build.ptr(w), _build.ptr(bias),
                        _build.ptr(out), M, N, K, codes[a.dtype],
                        codes[w.dtype], codes[out_dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cffn_gemm failed to launch: cudaError_t {err}")
    return out


# storage order of a and b as the backward hands them to K8, by mode (scan,
# adjoint), each a permutation of (B, K, L, D) that is its own inverse:
# quad_scan_ln_cat_bwd keeps the model's (B, L, K, D) GEMM outputs;
# sscan_dir_bwd's decay follows dt's (K, B, L, D) per-direction GEMM, and
# its adjoint's drive C * dy the (B, L, K, D) x_dbl
MODEL_LAYOUT = {"gm_tiny": {False: ((0, 2, 1, 3), (0, 2, 1, 3)),
                            True: ((0, 2, 1, 3), (0, 2, 1, 3))},
                "tiny_0230s": {False: ((1, 0, 2, 3), (1, 0, 2, 3)),
                               True: ((1, 0, 2, 3), (0, 2, 1, 3))}}


def scan2d_cases(libs, strided, batch, gpu, gen):
    """K8 in both modes at the b48 training shapes of gm_tiny and
    tiny_0230s, on contiguous operands and in the model's layout
    (``MODEL_LAYOUT``): each entry point called directly (one without
    strides on contiguous copies, as its wrapper made them, the copies
    timed with it) and through this checkout's wrapper. Each is held
    against its plain version (rtol 1e-4, atol 1e-4 * max), then timed in
    turns as device time; the wrapper also with the host in the loop. A
    base that refuses a shape (a launch error) is left out of it."""
    dev = torch.device("cuda")
    dirs = (1, 2, 3, 4)
    for group, cases in (("gm_tiny", GM_TINY), ("tiny_0230s", LEGACY)):
        totals, refused = {}, set()
        for tag, calls, S, D in cases:
            shape = (batch, 4, S * S, D)
            a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)
                              * 2 + 2)
            b = torch.randn(shape, generator=gen, device=dev)
            bound = 12 * a.numel() / HBM_BPS * 1e3
            for adjoint in (False, True):
                plain = (quad_scan.scan2d_adjoint_ref if adjoint
                         else quad_scan.scan2d_ref)(a, b, S, S, dirs)
                am, bm = [t.permute(o).contiguous().permute(o) for t, o in
                          zip((a, b), MODEL_LAYOUT[group][adjoint])]
                wrapper = (quad_scan.scan2d_adjoint if adjoint
                           else quad_scan.scan2d)
                runs = {}
                for lay, (x, y) in (("", (a, b)), (", model layout",
                                                   (am, bm))):
                    for n, lib in libs.items():
                        runs[n + lay] = (lambda lib=lib, n=n, x=x, y=y:
                                         _scan2d(lib, strided[n], x, y, S,
                                                 adjoint))
                runs["this wrapper, model layout"] = \
                    lambda: wrapper(am, bm, S, S, dirs)
                for n in list(runs):
                    try:
                        got = runs[n]()
                    except RuntimeError:
                        if not n.startswith("base"):
                            raise
                        del runs[n]
                        refused.add(n)
                        continue
                    err = (got - plain).abs().max().item()
                    if err > 1e-4 * plain.abs().max().item():
                        raise SystemExit(f"{n} {tag}: max abs err {err:.3e}")
                del plain, got
                ms = {n: [] for n in runs}
                for n in list(runs) + list(runs)[::-1]:
                    ms[n].append(device_time(runs[n]))
                med = {n: statistics.median(v) for n, v in ms.items()}
                med["this wrapper, model layout, host in the loop"] = _time(
                    runs["this wrapper, model layout"])
                med["bound"] = bound
                for n, v in med.items():
                    totals[n] = totals.get(n, 0.0) + calls * v
                mode = "adjoint" if adjoint else "scan"
                print(f"scan2d [{tag} {mode}] x{calls}/step b{batch} fp32, "
                      "device ms: " + ", ".join(f"{n} {v:.4f}" for n, v in
                                                med.items())
                      + f", this wrapper / bound "
                      f"{med['this wrapper, model layout'] / bound:.2f}"
                      f" | {gpu}", flush=True)
                del am, bm
            del a, b
        # a base that refused a shape has no per-step sum
        print(f"scan2d per b{batch} unfrozen {group} step, device ms: "
              + ", ".join(f"{n} {v:.4f}" for n, v in totals.items()
                          if n not in refused), flush=True)
        torch.cuda.empty_cache()


def gemm_cases(base_lib, this_lib, base_rows_nk, gpu, gen):
    """K3's GEMM at the b128 bf16 forward's six shapes, each held against
    ffn_gemm_ref (fp32 out: rtol 1e-4, atol 1e-4 * max; bf16 out: rtol
    1e-2, atol 1e-2 * max) on both libraries."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    totals = {}
    for tag, calls, L, K, N, fc2 in FFN:
        M = 128 * L
        a = torch.randn((M, K), generator=gen, device=dev).to(
            torch.float32 if fc2 else bf16)
        # nn.Linear's (N, K) storage; ffn_gemm takes its (K, N) view
        w_nk = (torch.randn((N, K), generator=gen, device=dev) * 0.05).to(bf16)
        bias = torch.randn((N,), generator=gen, device=dev) * 0.1
        od = bf16 if fc2 else torch.float32
        # "this kernel": the launch alone, on the operands ffn_gemm pads;
        # a base with cffn_gemm.cu takes the same padded operands, an older
        # one x as it is and the weight as (K, N) rows
        a_k, w_k = ffn.gemm_operands(a, w_nk.t())
        a_base, w_base = (a_k, w_k) if base_rows_nk else (
            a, w_nk.t().contiguous())
        runs = {"base": lambda: _gemm(base_lib, a_base, w_base, bias, od,
                                      base_rows_nk),
                "this": lambda: ffn.ffn_gemm(a, w_nk.t(), bias, od),
                "this kernel": lambda: _gemm(this_lib, a_k, w_k, bias, od,
                                             True)}
        plain = ffn.ffn_gemm_ref(a, w_nk.t(), bias, od).float()
        tol = 1e-2 if fc2 else 1e-4
        for n, fn in runs.items():
            err = (fn().float() - plain).abs()
            if bool((err > tol * plain.abs().max() + tol * plain.abs()).any()):
                raise SystemExit(f"{n} cffn_gemm {tag}: max abs err "
                                 f"{err.max().item():.3e}")
        ms = {n: [] for n in runs}
        for n in ["base", "this", "this kernel", "this kernel", "this",
                  "base"]:
            ms[n].append(_time(runs[n]))
        med = {n: statistics.median(v) for n, v in ms.items()}
        a_w, b_w = a.to(bf16), bias.to(bf16)
        med["addmm"] = _time(lambda: torch.addmm(b_w, a_w, w_nk.t()))
        if not fc2:
            med["addmm fp32 out"] = _time(lambda: torch.addmm(
                bias, a, w_nk.t(), out_dtype=torch.float32))
        nbytes = (a.numel() * a.element_size() + 2 * K * N + 4 * N
                  + M * N * (2 if fc2 else 4))
        med["bound"] = max(nbytes / HBM_BPS, 2 * M * N * K / BF16_FLOPS) * 1e3
        for n, v in med.items():
            totals[n] = totals.get(n, 0.0) + calls * v
        print(f"cffn_gemm [{tag}] x{calls}/forward b128 bf16: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in med.items())
              + f" | {gpu}", flush=True)
        del a, w_nk, a_base, w_base, a_k, w_k, plain, runs
    print("cffn_gemm per b128 bf16 forward: "
          + ", ".join(f"{n} {v:.3f} ms" for n, v in totals.items()),
          flush=True)


def gemm_fp32_cases(base_lib, this_lib, base_kn, gpu, gen):
    """K3's fp32-weight GEMM at the six shapes of the b32 and b48 fp32
    forwards, each held against ffn_gemm_ref (rtol 1e-4, atol 1e-4 * max)
    on both libraries and against torch.addmm (and this kernel's output
    compared with torch.addmm's bit for bit), then timed as device time in
    turns. ``base_kn``: the base's fp32 route takes W as (K, N) rows (given
    a copy made outside the timing) rather than nn.Linear's (N, K)."""
    dev = torch.device("cuda")
    f32 = torch.float32
    for batch in (32, 48):
        totals = {}
        for tag, calls, L, K, N, _ in FFN:
            M = batch * L
            a = torch.randn((M, K), generator=gen, device=dev)
            w_nk = torch.randn((N, K), generator=gen, device=dev) * 0.05
            bias = torch.randn((N,), generator=gen, device=dev) * 0.1
            a_k, w_k = ffn.gemm_operands(a, w_nk.t())
            w_base = w_nk.t().contiguous() if base_kn else w_k
            runs = {"base": lambda: _gemm(base_lib, a_k, w_base, bias, f32,
                                          not base_kn),
                    "this": lambda: ffn.ffn_gemm(a, w_nk.t(), bias, f32),
                    "this kernel": lambda: _gemm(this_lib, a_k, w_k, bias,
                                                 f32, True),
                    "addmm": lambda: torch.addmm(bias, a, w_nk.t())}
            plain = ffn.ffn_gemm_ref(a, w_nk.t(), bias, f32)
            scale = plain.abs().max().item()
            errs, outs = {}, {}
            for n, fn in runs.items():
                outs[n] = fn()
                err = (outs[n] - plain).abs()
                if bool((err > 1e-4 * scale + 1e-4 * plain.abs()).any()):
                    raise SystemExit(f"{n} cffn_gemm fp32 {tag} b{batch}: "
                                     f"max abs err {err.max().item():.3e}")
                errs[n] = err.max().item()
            same = torch.equal(outs["this"], outs["addmm"])
            del plain, outs
            ms = {n: [] for n in runs}
            for n in list(runs) + list(runs)[::-1]:
                ms[n].append(device_time(runs[n]))
            med = {n: statistics.median(v) for n, v in ms.items()}
            nbytes = 4 * (M * K + N * K + N + M * N)
            med["bound"] = max(nbytes / HBM_BPS,
                               2 * M * N * K / FP32_FLOPS) * 1e3
            for n, v in med.items():
                totals[n] = totals.get(n, 0.0) + calls * v
            print(f"cffn_gemm fp32 [{tag}] x{calls}/forward b{batch} fp32, "
                  "device ms: " + ", ".join(f"{n} {v:.4f}" for n, v in
                                            med.items())
                  + f", this kernel / bound "
                  f"{med['this kernel'] / med['bound']:.2f}, max abs "
                  + ", ".join(f"err {n} {v:.3e}" for n, v in errs.items())
                  + f" (max|plain| {scale:.3e}), this == addmm bitwise: "
                  f"{same} | {gpu}", flush=True)
            del a, w_nk, a_k, w_k, w_base, runs
        print(f"cffn_gemm fp32 per b{batch} fp32 forward, device ms: "
              + ", ".join(f"{n} {v:.4f}" for n, v in totals.items()),
              flush=True)
        torch.cuda.empty_cache()


def _grid_sample(lib, x, grid, groups):
    """The C entry ``dysample_grid_sample`` (groups > 0) or
    ``grid_sample_bilinear`` (0) of ``lib``."""
    B, H, W, C = x.shape
    Ho, Wo = grid.shape[1:3]
    out = torch.empty((B, Ho, Wo, C), dtype=x.dtype, device=x.device)
    args = [_build.ptr(x), _build.ptr(grid), _build.ptr(out), B, H, W, C,
            Ho, Wo] + ([groups] if groups else [])
    fn = lib.dysample_grid_sample if groups else lib.grid_sample_bilinear
    err = fn(*args, _build.dtype_code(x),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grid sample failed to launch: cudaError_t {err}")
    return out


def grid_sample_cases(libs, gpu, gen):
    """K4 and K6/K7 at the b128 bf16 forward's shapes, each held against
    its plain version at the bf16 tolerance (rtol 3e-2, atol 5e-2 * max)
    on both libraries, then timed in turns beside F.grid_sample."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    totals = {}
    for tag, calls, n, H, W, C, Ho, Wo, groups in GRID_SAMPLE:
        x = torch.randn((n, H, W, C), generator=gen, device=dev).to(bf16)
        ys = (torch.arange(Ho, device=dev) + 0.5) * 2 / Ho - 1
        xs = (torch.arange(Wo, device=dev) + 0.5) * 2 / Wo - 1
        base = torch.stack(torch.meshgrid(ys, xs, indexing="ij")[::-1], -1)
        g = groups or 1
        grid = (base[None, :, :, None, :] + torch.randn(
            (n, Ho, Wo, g, 2), generator=gen, device=dev) * (0.1 / H))
        if groups:
            cg = C // groups
            plain = grid_sample.dysample_grid_sample_ref(x, grid)
            # the regrouped batch F.grid_sample takes, built outside the
            # timing
            xl = x.reshape(n, H, W, g, cg).permute(0, 3, 4, 1, 2).reshape(
                n * g, cg, H, W)
            gl = grid.permute(0, 3, 1, 2, 4).reshape(n * g, Ho, Wo, 2)
        else:
            grid = grid[:, :, :, 0].contiguous()
            plain = grid_sample.grid_sample_bilinear(x, grid)
            # the channels-last NCHW view of x, as phase 14 of chip_smoke
            xl, gl = x.permute(0, 3, 1, 2), grid
        gl = gl.to(bf16)
        plain = plain.float()
        scale = plain.abs().max().item()
        for name, lib in libs.items():
            err = (_grid_sample(lib, x, grid, groups).float() - plain).abs()
            if bool((err > 5e-2 * scale + 3e-2 * plain.abs()).any()):
                raise SystemExit(f"{name} grid sample {tag}: max abs err "
                                 f"{err.max().item():.3e}")
        ms = {name: [] for name in libs}
        for name in ["base", "this", "this", "base"]:
            ms[name].append(device_time(
                lambda: _grid_sample(libs[name], x, grid, groups)))
        med = {name: statistics.median(v) for name, v in ms.items()}
        med["F.grid_sample"] = device_time(lambda: F.grid_sample(
            xl, gl, mode="bilinear", padding_mode="border",
            align_corners=False))
        nbytes = 2 * n * (H * W + Ho * Wo) * C + 8 * n * Ho * Wo * g
        med["bound"] = nbytes / HBM_BPS * 1e3
        kernel = "K4" if groups else "K6/K7"
        for name, v in med.items():
            totals[kernel, name] = totals.get((kernel, name), 0.0) \
                + calls * v
        print(f"grid sample [{tag}] x{calls}/forward b128 bf16: "
              + ", ".join(f"{name} {v:.4f} ms" for name, v in med.items())
              + f" | {gpu}", flush=True)
        del x, grid, plain, xl, gl
    for kernel in ("K4", "K6/K7"):
        print(f"grid sample {kernel} per b128 bf16 forward: "
              + ", ".join(f"{name} {v:.4f} ms" for (k, name), v in
                          totals.items() if k == kernel), flush=True)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _dwconv(lib, x, w, bias, flip):
    """The C entry ``dwconv3x3`` (``dwconv3x3_flip`` when ``flip``) of
    ``lib``; w is the fp32 taps in the layout that library takes."""
    B, H, W, C = x.shape
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    p = _build.ptr
    head = [p(x), p(w)] + ([] if flip else [p(bias)]) + [p(out)]
    fn = lib.dwconv3x3_flip if flip else lib.dwconv3x3
    err = fn(*head, *x.stride()[:3], B, H, W, C, _build.dtype_code(x),
             _stream())
    if err:
        raise RuntimeError(f"dwconv3x3 failed to launch: cudaError_t {err}")
    return out


def dwconv_cases(libs, taps_9c, gpu, gen):
    """K13 in both modes at the b128 bf16 gm_tiny quad-block shapes, held
    against dwconv3x3_ref at the bf16 tolerance (rtol 3e-2, atol 5e-2 *
    max) on both libraries, then timed in turns beside the library call.
    ``taps_9c[name]``: that library takes the taps as (9, C) rows (its
    wrapper transposed torch's (C, 1, 3, 3) weight per call)."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    totals = {}
    for flip in (False, True):
        mode = "flip" if flip else "forward"
        for S, C, calls in DWCONV:
            B = 128
            w = torch.randn((C, 1, 3, 3), generator=gen, device=dev) * 0.3
            b = torch.randn((C,), generator=gen, device=dev) * 0.1
            if flip:
                x = torch.randn((B, S, S, C), generator=gen,
                                device=dev).to(bf16)
            else:
                x = torch.randn((B * S * S, 2 * C), generator=gen,
                                device=dev).to(bf16)[:, :C].view(B, S, S, C)
            w9c = w.reshape(C, 9).t().contiguous()
            taps = {n: w9c if taps_9c[n] else w for n in libs}
            runs = {n: (lambda n=n: _dwconv(libs[n], x, taps[n], b, flip))
                    for n in libs}
            runs["this op"] = ((lambda: dwconv.dwconv3x3_flip(x, w)) if flip
                               else (lambda: dwconv.dwconv3x3(x, w, b)))
            plain = dwconv.dwconv3x3_ref(x, w, b, flip).float()
            scale = plain.abs().max().item()
            for n, fn in runs.items():
                err = (fn().float() - plain).abs()
                if bool((err > 5e-2 * scale + 3e-2 * plain.abs()).any()):
                    raise SystemExit(f"{n} dwconv3x3 {mode} {S}x{S} C{C}: "
                                     f"max abs err {err.max().item():.3e}")
            ms = {n: [] for n in runs}
            for n in ["base", "this", "this op", "this op", "this", "base"]:
                ms[n].append(device_time(runs[n]))
            med = {n: statistics.median(v) for n, v in ms.items()}
            xl, wl, bl = x.permute(0, 3, 1, 2).contiguous(), w.to(bf16), \
                b.to(bf16)
            lib_name = "F.conv_transpose2d" if flip else "F.conv2d"
            med[lib_name] = device_time(
                (lambda: F.conv_transpose2d(xl, wl, padding=1, groups=C))
                if flip else (lambda: F.conv2d(xl, wl, bl, padding=1,
                                               groups=C)))
            # host in the loop: the wrapper against the library call
            med["this op, host in the loop"] = _time(runs["this op"])
            med[lib_name + ", host in the loop"] = _time(
                (lambda: F.conv_transpose2d(xl, wl, padding=1, groups=C))
                if flip else (lambda: F.conv2d(xl, wl, bl, padding=1,
                                               groups=C)))
            # x read once, the result written, the taps and bias
            med["bound"] = (2 * x.numel() * 2 + 40 * C) / HBM_BPS * 1e3
            for n, v in med.items():
                totals[mode, n] = totals.get((mode, n), 0.0) + calls * v
            print(f"dwconv3x3 {mode} [{S}x{S} C{C}] x{calls}/"
                  f"{'backward' if flip else 'forward'} b128 bf16: "
                  + ", ".join(f"{n} {v:.4f} ms" for n, v in med.items())
                  + f", this / bound {med['this'] / med['bound']:.2f}"
                  f" | {gpu}", flush=True)
            del x, xl, plain, runs
    for mode in ("forward", "flip"):
        print(f"dwconv3x3 {mode} per b128 bf16 "
              f"{'backward' if mode == 'flip' else 'forward'}: "
              + ", ".join(f"{n} {v:.4f} ms" for (m, n), v in totals.items()
                          if m == mode), flush=True)


def _sscan_dir(lib, u, dt, Bs, Cs, prm, S):
    B, K, L, D = u.shape
    out = torch.empty((B, K, L, D), dtype=torch.float32, device=u.device)
    p = _build.ptr
    err = lib.sscan_dir(p(u), p(dt), p(Bs), p(Cs), *[p(t) for t in prm],
                        p(out), *u.stride(), *dt.stride(), *Bs.stride(),
                        *Cs.stride(), B, K, S, S, D, 1, 2, 3, 4,
                        _build.dtype_code(u), _stream())
    if err:
        raise RuntimeError(f"sscan_dir failed to launch: cudaError_t {err}")
    return out


def sscan_dir_cases(libs, gpu, gen):
    """K10 at the tiny_0230s b128 bf16 SS2D shapes (u a stride-0 view over
    the four directions), held against sscan_dir_ref at the bf16
    tolerance on both libraries (phase 10's), then timed in turns."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    totals = {}
    for S, D, calls in SSCAN_DIR:
        B, K, L = 128, 4, S * S
        rnd = lambda shape, scale=1.0: torch.randn(
            shape, generator=gen, device=dev) * scale
        u = rnd((B, L, D)).to(bf16)[:, None].expand(B, K, L, D)
        dt = rnd((B, K, L, D), 0.5).to(bf16)
        Bs, Cs = rnd((B, K, L)).to(bf16), rnd((B, K, L)).to(bf16)
        prm = [-torch.exp(rnd((K, D), 0.5)), rnd((K, D), 0.3), rnd((K, D))]
        plain = quad_scan.sscan_dir_ref(u, dt, Bs, Cs, *prm, S, S,
                                        (1, 2, 3, 4))
        scale = plain.abs().max().item()
        errs = {}
        for n, lib in libs.items():
            err = (_sscan_dir(lib, u, dt, Bs, Cs, prm, S) - plain).abs()
            if bool((err > 5e-2 * scale + 3e-2 * plain.abs()).any()):
                raise SystemExit(f"{n} sscan_dir {S}x{S} D{D}: max abs err "
                                 f"{err.max().item():.3e}")
            errs[n] = err.max().item()
        del plain
        ms = {n: [] for n in libs}
        for n in ["base", "this", "this", "base"]:
            ms[n].append(device_time(
                lambda: _sscan_dir(libs[n], u, dt, Bs, Cs, prm, S)))
        med = {n: statistics.median(v) for n, v in ms.items()}
        n_el = B * K * L * D
        # read once: u (one activation), dt, Bs, Cs, the (K, D) constants;
        # y written in fp32 (chip_smoke.py phase 10's count)
        med["bound"] = (2 * (B * L * D + n_el + 2 * B * K * L) + 12 * K * D
                        + 4 * n_el) / HBM_BPS * 1e3
        for n, v in med.items():
            totals[n] = totals.get(n, 0.0) + calls * v
        print(f"sscan_dir [{S}x{S} D{D}] x{calls}/forward b128 bf16: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in med.items())
              + f", this / bound {med['this'] / med['bound']:.2f}, max abs "
              + ", ".join(f"err {n} {v:.3e}" for n, v in errs.items())
              + f" (max|plain| {scale:.3e}) | {gpu}", flush=True)
        del u, dt, Bs, Cs
    print("sscan_dir per b128 bf16 legacy forward: "
          + ", ".join(f"{n} {v:.4f} ms" for n, v in totals.items()),
          flush=True)


def _quad_scan_ln(lib, u, dt, Bs, Cs, prm, S, scales=(), dirs=(1, 2, 3, 4)):
    """The C entry ``quad_scan_ln`` of ``lib``, or ``quad_scan_ln_q8`` with
    the int8 dequantization ``scales`` (su, sdt)."""
    B, K, L, D = u.shape
    out = torch.empty((B, L, K * D), dtype=torch.bfloat16, device=u.device)
    p = _build.ptr
    fn = lib.quad_scan_ln_q8 if scales else lib.quad_scan_ln
    err = fn(p(u), p(dt), p(Bs), p(Cs), *[p(t) for t in (*prm, *scales)],
             p(out), *u.stride(), *dt.stride(), *Bs.stride(), *Cs.stride(),
             B, K, S, S, D, *dirs, _build.dtype_code(Bs), _stream())
    if err:
        raise RuntimeError(f"quad_scan_ln failed to launch: cudaError_t "
                           f"{err}")
    return out


def quad_scan_ln_cases(libs, gpu, gen):
    """K1 (``quad_scan_ln``) and K14 (``quad_scan_ln_q8``) at the four
    gm_tiny quad-block shapes of a b128 bf16 forward, in the model's
    layout: u and dt (B, L, K, D) GEMM outputs viewed as (B, K, L, D) (int8
    for K14), Bs and Cs the x_dbl (B, L, K, R + 2) slices viewed as (B, K,
    L). Each is held against its plain version at the bf16 tolerance on
    both libraries, then timed in turns as device time beside the bound
    (chip_smoke.py phase 3's and phase 14's byte counts). For K1, this
    checkout's kernel is also timed with every group walking rows (each
    128-byte pixel row of u, dt and out then serves its four groups at one
    time) and on inputs that hit in cache (u, dt, Bs and Cs read through
    stride-0 views of one pixel): what the model's layout and the loads
    cost."""
    from ceigm_unet_tpu_torch.models.ss2d import q8
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rnd = lambda shape, scale=1.0: torch.randn(
        shape, generator=gen, device=dev) * scale
    totals = {}
    for kernel in ("K1", "K14"):
        for tag, calls, S, D in GM_TINY:
            B, K, L, R = 128, 4, S * S, -(-D // 16)
            if kernel == "K1":
                u, dt = [rnd((B, L, K, D), s).to(bf16).permute(0, 2, 1, 3)
                         for s in (1.0, 0.5)]
                scales = ()
            else:
                (u, su), (dt, sdt) = [q8(rnd((B, L, K, D), s))
                                      for s in (1.0, 0.5)]
                u, dt = u.permute(0, 2, 1, 3), dt.permute(0, 2, 1, 3)
                scales = (su, sdt)
            x_dbl = rnd((B, L, K, R + 2)).to(bf16)
            Bs, Cs = (x_dbl[..., R].permute(0, 2, 1),
                      x_dbl[..., R + 1].permute(0, 2, 1))
            prm = [-torch.exp(rnd((K, D), 0.5)), rnd((K, D), 0.3),
                   rnd((K, D)), 1 + rnd((K, D), 0.1), rnd((K, D), 0.1)]
            args = [u, dt, *scales, Bs, Cs, *prm, S, S, (1, 2, 3, 4)]
            plain = (quad_scan.quad_scan_ln_cat_q8_ref(*args) if scales
                     else quad_scan.quad_scan_ln_cat_ref(*args)).float()
            scale = plain.abs().max().item()
            errs = {}
            for n, lib in libs.items():
                err = (_quad_scan_ln(lib, u, dt, Bs, Cs, prm, S, scales)
                       .float() - plain).abs()
                if bool((err > 5e-2 * scale + 3e-2 * plain.abs()).any()):
                    raise SystemExit(f"{n} {kernel} {tag}: max abs err "
                                     f"{err.max().item():.3e}")
                errs[n] = err.max().item()
            del plain
            ms = {n: [] for n in libs}
            for n in ["base", "this", "this", "base"]:
                ms[n].append(device_time(lambda: _quad_scan_ln(
                    libs[n], u, dt, Bs, Cs, prm, S, scales)))
            med = {n: statistics.median(v) for n, v in ms.items()}
            if not scales:
                med["this, rows only"] = device_time(lambda: _quad_scan_ln(
                    libs["this"], u, dt, Bs, Cs, prm, S, dirs=(1, 1, 1, 1)))
                one = [t[:1, :1, :1].expand(t.shape) for t in (u, dt, Bs, Cs)]
                med["this, cached inputs"] = device_time(
                    lambda: _quad_scan_ln(libs["this"], *one, prm, S))
            n_el = B * K * L * D
            # u, dt read and the bf16 output written; Bs, Cs; the (K, D)
            # constants
            med["bound"] = ((4 * n_el if scales else 6 * n_el)
                            + 4 * B * K * L + (28 if scales else 20) * K * D
                            ) / HBM_BPS * 1e3
            for n, v in med.items():
                totals[kernel, n] = totals.get((kernel, n), 0.0) + calls * v
            print(f"quad_scan_ln {kernel} [{tag}] x{calls}/forward b128 bf16:"
                  " " + ", ".join(f"{n} {v:.4f} ms" for n, v in med.items())
                  + f", this / bound {med['this'] / med['bound']:.2f}, max "
                  "abs " + ", ".join(f"err {n} {v:.3e}" for n, v in
                                     errs.items())
                  + f" (max|plain| {scale:.3e}) | {gpu}", flush=True)
            del u, dt, Bs, Cs, x_dbl
    for kernel in ("K1", "K14"):
        print(f"quad_scan_ln {kernel} per b128 bf16 forward: "
              + ", ".join(f"{n} {v:.4f} ms" for (k, n), v in totals.items()
                          if k == kernel), flush=True)


# (side, HID, identity channels, calls per b128 forward): the dw3+GELU and
# inception stencils of the 7 decoder CustomFfns (3 at 14x14, 2 at 28x28, 2
# at 56x56)
STENCIL = [(14, 1392, 870, 3), (28, 512, 320, 2), (56, 256, 160, 2)]


def _stencil(lib, h, dwk, dwb, taps, bias, S, n_id):
    """gelu(dw3(h) + dwb) followed by the inception stencil, through
    ``lib``'s fused ``cffn_dw3_inception7``, or, in a library that predates
    it, its ``cffn_dw3_gelu`` and then its ``cffn_inception7`` (the q
    between them allocated and written as that library's wrapper did)."""
    M, HID = h.shape
    out = torch.empty_like(h)
    p, B = _build.ptr, M // (S * S)
    if hasattr(lib, "cffn_dw3_inception7"):
        err = lib.cffn_dw3_inception7(p(h), p(dwk), p(dwb), p(taps), p(bias),
                                      p(out), B, S, S, HID, n_id, _stream())
    else:
        _P, _I = ctypes.c_void_p, ctypes.c_int
        lib.cffn_dw3_gelu.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.cffn_inception7.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        q = torch.empty_like(h)
        err = (lib.cffn_dw3_gelu(p(h), p(dwk), p(dwb), p(q), B, S, S, HID,
                                 _stream())
               or lib.cffn_inception7(p(q), p(taps), p(bias), p(out), B, S,
                                      S, HID, n_id, _stream()))
    if err:
        raise RuntimeError(f"CustomFfn stencil failed to launch: cudaError_t "
                           f"{err}")
    return out


def stencil_cases(libs, gpu, gen):
    """K3's stencils between the GEMMs, q = gelu(dw3(h) + dwb) and then q +
    composite7x7(q) + incb, at the three b128 CustomFfn shapes (fp32
    hidden, random dw3 taps, the composite of random 3x3/5x5/7x7 taps):
    each library's entry points called directly (``_stencil``: the fused
    kernel, or the two of a library that predates it, timed as one case)
    and this checkout's wrapper ``dw3_gelu_inception7``, held against
    dw3_gelu_inception7_ref at the fp32 tolerance (rtol 1e-4, atol 1e-4 *
    max; TF32 off), then timed in turns as device time beside F.conv2d of
    the 7x7 alone (groups=HID, on the channels-last NCHW view of q) and
    the bound: h read once and the output written once, plus the taps and
    biases (chip_smoke.py phase 3's count)."""
    dev = torch.device("cuda")
    rnd = lambda shape, scale=1.0: torch.randn(
        shape, generator=gen, device=dev) * scale
    totals = {}
    for S, HID, n_id, calls in STENCIL:
        g, B = HID // 8, 128
        k, bias = ffn.inception_composite(
            HID, g, rnd((3, 3, 1, g), 0.2), rnd((5, 5, 1, g), 0.1),
            rnd((7, 7, 1, g), 0.05), rnd((g,), 0.1), rnd((g,), 0.1),
            rnd((g,), 0.1), torch.float32)
        taps = k.reshape(49, HID).contiguous()
        dwk, dwb = rnd((3, 3, 1, HID), 0.2), rnd((HID,), 0.1)
        dw9 = dwk.reshape(9, HID).contiguous()
        h = rnd((B * S * S, HID))
        plain = ffn.dw3_gelu_inception7_ref(h, dwk, dwb, k, bias, S, S, n_id)
        runs = {n: (lambda lib=lib: _stencil(lib, h, dw9, dwb, taps, bias, S,
                                             n_id))
                for n, lib in libs.items()}
        order = ["base", "this", "this", "base"]
        if hasattr(libs["this"], "cffn_dw3_inception7"):
            runs["this op"] = lambda: ffn.dw3_gelu_inception7(
                h, dwk, dwb, k, bias, S, S, n_id)
            order = ["base", "this", "this op", "this op", "this", "base"]
        scale = plain.abs().max().item()
        for n, fn in runs.items():
            err = (fn() - plain).abs()
            if bool((err > 1e-4 * scale + 1e-4 * plain.abs()).any()):
                raise SystemExit(f"{n} CustomFfn stencil {S}x{S} HID{HID}: "
                                 f"max abs err {err.max().item():.3e}")
        del plain
        ms = {n: [] for n in runs}
        for n in order:
            ms[n].append(device_time(runs[n]))
        med = {n: statistics.median(v) for n, v in ms.items()}
        # the 7x7 alone: q + conv(q) is one depthwise conv whose centre tap
        # is + 1, on q computed outside the timing
        k_id = k.clone()
        k_id[3, 3] += 1.0
        w = k_id.permute(3, 2, 0, 1).contiguous()
        q_nchw = ffn.dw3_gelu_ref(h, dwk, dwb, S, S).view(
            B, S, S, HID).permute(0, 3, 1, 2)
        med["F.conv2d 7x7 alone"] = device_time(
            lambda: F.conv2d(q_nchw, w, bias, padding=3, groups=HID))
        med["bound"] = (8 * h.numel() + 240 * HID) / HBM_BPS * 1e3
        for n, v in med.items():
            totals[n] = totals.get(n, 0.0) + calls * v
        print(f"CustomFfn stencil [{S}x{S} HID{HID} n_id {n_id}] x{calls}/"
              "forward b128 fp32, device ms: "
              + ", ".join(f"{n} {v:.4f}" for n, v in med.items())
              + f", this / bound {med['this'] / med['bound']:.2f} | {gpu}",
              flush=True)
        del h, q_nchw, runs
    print("CustomFfn stencil per b128 forward, device ms: "
          + ", ".join(f"{n} {v:.4f}" for n, v in totals.items()), flush=True)


# (side, C, calls per b128 forward): the eval LGAG gates of the decoder
LGAG = [(14, 348, 1), (28, 128, 1), (56, 64, 1)]


def _lgag(lib, g, x, prm):
    B, H, W, C = g.shape
    out = torch.empty_like(x)
    p = _build.ptr
    err = lib.lgag_gate(p(g), p(x), *[p(t) for t in prm], p(out), B, H, W, C,
                        _build.dtype_code(x), _stream())
    if err:
        raise RuntimeError(f"lgag_gate failed to launch: cudaError_t {err}")
    return out


def lgag_cases(libs, gpu, gen):
    """K5 (``lgag_gate``) at the three b128 bf16 shapes of the decoder's
    gates, each library's entry point called directly, held against
    lgag_gate_ref at the bf16 tolerance (rtol 3e-2, atol 5e-2 * max), then
    timed in turns as device time beside the bound: g and x read once, the
    output written once, and the folded parameters (chip_smoke.py phase
    3's count)."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rnd = lambda shape, scale=1.0: torch.randn(
        shape, generator=gen, device=dev) * scale
    totals = {}
    for S, C, calls in LGAG:
        B, C2 = 128, C // 2
        g, x = rnd((B, S, S, C)).to(bf16), rnd((B, S, S, C)).to(bf16)
        prm = [rnd((5, 5, 2, C2), 0.2), 1 + rnd((C2,), 0.1), rnd((C2,), 0.1),
               rnd((C2,), 0.3), rnd((3,), 0.5)]
        plain = tapconv.lgag_gate_ref(g, x, *prm).float()
        scale = plain.abs().max().item()
        errs = {}
        for n, lib in libs.items():
            err = (_lgag(lib, g, x, prm).float() - plain).abs()
            if bool((err > 5e-2 * scale + 3e-2 * plain.abs()).any()):
                raise SystemExit(f"{n} lgag_gate {S}x{S} C{C}: max abs err "
                                 f"{err.max().item():.3e}")
            errs[n] = err.max().item()
        del plain
        ms = {n: [] for n in libs}
        for n in ["base", "this", "this", "base"]:
            ms[n].append(device_time(lambda: _lgag(libs[n], g, x, prm)))
        med = {n: statistics.median(v) for n, v in ms.items()}
        med["bound"] = (3 * 2 * g.numel() + 4 * 53 * C2) / HBM_BPS * 1e3
        for n, v in med.items():
            totals[n] = totals.get(n, 0.0) + calls * v
        print(f"lgag_gate [{S}x{S} C{C}] x{calls}/forward b128 bf16, device "
              "ms: " + ", ".join(f"{n} {v:.4f}" for n, v in med.items())
              + f", this / bound {med['this'] / med['bound']:.2f}, max abs "
              + ", ".join(f"err {n} {v:.3e}" for n, v in errs.items())
              + f" (max|plain| {scale:.3e}) | {gpu}", flush=True)
        del g, x
    print("lgag_gate per b128 bf16 forward, device ms: "
          + ", ".join(f"{n} {v:.4f}" for n, v in totals.items()), flush=True)


# the reference selective-scan speed test (tools/bench_scan.py:25): K12's
# (batch, dim, L), N 1, bf16 u, delta, B and C
N1_SHAPE = (128, 96, 4096)
# K11's row shapes (tag, M, L, calls per pass over chip_smoke.py phase 13's
# forward calls, backwards per pass over phase 20's): N 1 without softplus
# at the speed-test shape (its backward runs twice, with and without
# softplus), and d_state 16 over 56x56 at B 8. Each backward runs K11 twice:
# h again on the forward's a and b, and the adjoint on flipped operands.
SCAN_ROWS = [("B128 D96 N1 L4096", 128 * 96, 4096, 1, 2),
             ("B8 D96 N16 L3136", 8 * 96 * 16, 3136, 1, 1)]


def _n1_takes_dtypes(lib, csrc: Path) -> bool:
    """Whether ``csrc``'s ``selective_scan_n1`` reads B and C in their own
    dtype through strides (an older one takes fp32 (batch*G, L) B and C and
    contiguous (dim,) constants); declares its arguments on ``lib``."""
    new = "long long su0" in (csrc / "scan_rows.cu").read_text()
    _P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.selective_scan_n1.argtypes = (
        [_P] * 8 + ([_L] * 9 + [_I] * 8 if new else [_I] * 6) + [_P])
    return new


def _n1(lib, new, u, delta, A, B, C, D, bias, out_dtype, f32):
    """The C entry ``selective_scan_n1`` of ``lib`` on (batch, dim, L) u
    and delta, (batch, G, 1, L) B and C; an older entry point gets
    ``f32``, the fp32 copies its wrapper made (Bf, Cf, A's column)."""
    batch, dim, L = u.shape
    G = B.shape[1]
    out = torch.empty((batch, dim, L), dtype=out_dtype, device=u.device)
    p, code = _build.ptr, _build.dtype_code
    if new:
        err = lib.selective_scan_n1(
            p(u), p(delta), p(B), p(C), p(A), p(bias), p(D), p(out),
            *u.stride()[:2], *delta.stride()[:2], *B.stride()[:2],
            *C.stride()[:2], A.stride(0), batch, dim, G, L, code(u),
            code(delta), code(B), code(out), _stream())
    else:
        Bf, Cf, A0 = f32
        err = lib.selective_scan_n1(
            p(u), p(delta), p(Bf), p(Cf), p(A0), p(bias), p(D), p(out),
            batch * dim, dim, G, L, code(u), code(out), _stream())
    if err:
        raise RuntimeError(f"selective_scan_n1 failed to launch: "
                           f"cudaError_t {err}")
    return out


def _scan_rows(lib, a, b):
    out = torch.empty_like(a)
    p = _build.ptr
    err = lib.scan_rows(p(a), p(b), p(out), a.shape[0], a.shape[1],
                        _stream())
    if err:
        raise RuntimeError(f"scan_rows failed to launch: cudaError_t {err}")
    return out


def selective_scan_cases(libs, new, gpu, gen):
    """K12 at the speed-test shape with fp32 and bf16 out, and K11 at its
    row shapes: on the a and b the forward builds, and on the flipped
    adjoint operands the backward hands it (``selective_scan_bwd``). Each
    library's entry point is called directly and held against its plain
    version at the bf16 tolerance (K11, fp32 in and out: the fp32 one),
    then timed in turns as device time; this checkout's wrapper beside
    them, as device time and with the host in the loop. Bounds: K12 reads
    u, delta, B and C and the (dim,) constants once and writes y; K11 reads
    a and b and writes h, fp32 (12 bytes per element)."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    batch, dim, L = N1_SHAPE
    rnd = lambda shape, scale=1.0, dt=bf16: (torch.randn(
        shape, generator=gen, device=dev) * scale).to(dt)
    u, delta = rnd((batch, dim, L)), rnd((batch, dim, L), 0.1)
    A = -torch.exp(rnd((dim, 1), 0.5, torch.float32))
    B, C = rnd((batch, 1, 1, L)), rnd((batch, 1, 1, L))
    D, bias = rnd((dim,), 1.0, torch.float32), rnd((dim,), 0.3, torch.float32)
    f32 = (B[:, :, 0].float().contiguous(), C[:, :, 0].float().contiguous(),
           A[:, 0].contiguous())
    for od in (torch.float32, bf16):
        args = (u, delta, A, B, C, D, bias, od)
        runs = {n: (lambda n=n: _n1(libs[n], new[n], *args, f32))
                for n in libs}
        runs["this wrapper"] = lambda: ss.selective_scan_n1(*args)
        plain = ss.selective_scan_n1_ref(*args).float()
        scale = plain.abs().max().item()
        errs = {}
        for n, fn in runs.items():
            err = (fn().float() - plain).abs()
            if bool((err > 5e-2 * scale + 3e-2 * plain.abs()).any()):
                raise SystemExit(f"{n} selective_scan_n1 out {od}: max abs "
                                 f"err {err.max().item():.3e}")
            errs[n] = err.max().item()
        del plain
        ms = {n: [] for n in runs}
        for n in ["base", "this", "this wrapper", "this wrapper", "this",
                  "base"]:
            ms[n].append(device_time(runs[n]))
        med = {n: statistics.median(v) for n, v in ms.items()}
        med["this wrapper, host in the loop"] = _time(runs["this wrapper"])
        n_el = u.numel()
        med["bound"] = (4 * n_el + n_el * torch.finfo(od).bits // 8
                        + 4 * B.numel() + 12 * dim) / HBM_BPS * 1e3
        print(f"selective_scan_n1 [B{batch} D{dim} N1 L{L} bf16 -> "
              f"{str(od).split('.')[-1]}] device ms: "
              + ", ".join(f"{n} {v:.4f}" for n, v in med.items())
              + f", this / bound {med['this'] / med['bound']:.2f}, max abs "
              + ", ".join(f"err {n} {v:.3e}" for n, v in errs.items())
              + f" (max|plain| {scale:.3e}) | {gpu}", flush=True)
    del u, delta, f32
    totals = {}
    for tag, M, L, fwd, bwd in SCAN_ROWS:
        a = torch.sigmoid(torch.randn((M, L), generator=gen, device=dev) * 2
                          + 2)
        b = torch.randn((M, L), generator=gen, device=dev)
        # the backward's adjoint: a_{t+1} (1 past the end) and the drive,
        # both reversed along L
        adj = (torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], -1).flip(-1),
               b.flip(-1))
        for which, (x, y), calls in (("h on a, b", (a, b), (fwd, bwd)),
                                     ("backward adjoint", adj, (0, bwd))):
            runs = {n: (lambda n=n: _scan_rows(libs[n], x, y)) for n in libs}
            runs["this wrapper"] = lambda: ss.scan_rows(x, y)
            plain = ss.scan_rows_ref(x, y)
            scale = plain.abs().max().item()
            errs = {}
            for n, fn in runs.items():
                err = (fn() - plain).abs()
                if bool((err > 1e-4 * scale + 1e-4 * plain.abs()).any()):
                    raise SystemExit(f"{n} scan_rows {tag}: max abs err "
                                     f"{err.max().item():.3e}")
                errs[n] = err.max().item()
            del plain
            ms = {n: [] for n in runs}
            for n in ["base", "this", "this wrapper", "this wrapper", "this",
                      "base"]:
                ms[n].append(device_time(runs[n]))
            med = {n: statistics.median(v) for n, v in ms.items()}
            med["this wrapper, host in the loop"] = _time(runs["this wrapper"])
            med["bound"] = 12 * M * L / HBM_BPS * 1e3
            for n, v in med.items():
                for k, c in zip(("forward", "backward"), calls):
                    totals[k, n] = totals.get((k, n), 0.0) + c * v
            print(f"scan_rows [{tag}, M {M} L {L}, {which}] x{calls[0]}/"
                  f"forward x{calls[1]}/backward pass, device ms: "
                  + ", ".join(f"{n} {v:.4f}" for n, v in med.items())
                  + f", this / bound {med['this'] / med['bound']:.2f}, max "
                  "abs " + ", ".join(f"err {n} {v:.3e}" for n, v in
                                     errs.items())
                  + f" (max|plain| {scale:.3e}) | {gpu}", flush=True)
        del a, b, adj
    for k in ("forward", "backward"):
        print(f"scan_rows per pass over the op's {k} calls, device ms: "
              + ", ".join(f"{n} {v:.4f}" for (kk, n), v in totals.items()
                          if kk == k), flush=True)


KERNELS = ("scan2d", "cffn_gemm", "grid_sample", "dwconv", "sscan_dir",
           "quad_scan_ln", "cffn_stencil", "lgag", "selective_scan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="the other checkout's ceigm_unet_tpu_torch/csrc")
    ap.add_argument("--batch", type=int, default=48,
                    help="batch of the scan2d cases")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="groups of cases to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {gpu}", flush=True)
    base = args.base.resolve()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"base": _build.load(_build.build(base, Path(tmp)),
                                    strict=False),
                "this": _build.library()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "scan2d" in args.kernels:
        strided = {n: _scan2d_takes_strides(libs[n], csrc)
                   for n, csrc in (("base", base), ("this", _build.CSRC))}
        scan2d_cases(libs, strided, args.batch, gpu, gen)
    if "cffn_gemm" in args.kernels:
        base_gemm = base / "cffn_gemm.cu"
        gemm_cases(libs["base"], libs["this"], base_gemm.exists(), gpu, gen)
        gemm_fp32_cases(libs["base"], libs["this"],
                        not base_gemm.exists()
                        or "Wt (K, N)" in base_gemm.read_text(), gpu, gen)
    if "grid_sample" in args.kernels:
        grid_sample_cases(libs, gpu, gen)
    if "dwconv" in args.kernels:
        dwconv_cases(libs, {
            n: "w is (9, C)" in (csrc / "dwconv3.cu").read_text()
            for n, csrc in (("base", base), ("this", _build.CSRC))},
            gpu, gen)
    if "sscan_dir" in args.kernels:
        sscan_dir_cases(libs, gpu, gen)
    if "quad_scan_ln" in args.kernels:
        quad_scan_ln_cases(libs, gpu, gen)
    if "cffn_stencil" in args.kernels:
        stencil_cases(libs, gpu, gen)
    if "lgag" in args.kernels:
        lgag_cases(libs, gpu, gen)
    if "selective_scan" in args.kernels:
        selective_scan_cases(libs, {
            n: _n1_takes_dtypes(libs[n], csrc)
            for n, csrc in (("base", base), ("this", _build.CSRC))}, gpu, gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
