"""Time a kernel as this checkout builds it against the same entry point
built from another checkout's ``csrc/``, on one card, in turns.

    python -m ceigm_unet_tpu_torch.kernel_ab --base OTHER/ceigm_unet_tpu_torch/csrc

Both libraries are built with the same flags (``ops/_build.py``). Each
case is checked against its plain version on both, then timed with CUDA
events in the order base, this, this, base; the line per case prints both
medians and the bound. The cases are K8 (``scan2d``, scan and adjoint
modes) at the b48 224x224 training shapes of gm_tiny (D <= 128, which
both versions take) and of the legacy tiny_0230s (for this checkout
alone where the base refuses D > 128). Prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from ceigm_unet_tpu_torch.ops import _build, quad_scan

HBM_BPS = 3.35e12
# (tag, calls per unfrozen b48 step: the SS2D or quad blocks at that shape,
# side, D); each block's backward runs K8 once in each mode
GM_TINY = [("gm_tiny 56x56 D16", 5, 56, 16), ("gm_tiny 28x28 D32", 6, 28, 32),
           ("gm_tiny 14x14 D87", 12, 14, 87), ("gm_tiny 7x7 D112", 3, 7, 112)]
LEGACY = [("tiny_0230s 56x56 D96", 4, 56, 96),
          ("tiny_0230s 28x28 D192", 4, 28, 192),
          ("tiny_0230s 14x14 D384", 10, 14, 384),
          ("tiny_0230s 7x7 D768", 2, 7, 768)]


def _scan2d(lib, a, b, S, adjoint):
    out = torch.empty_like(a)
    B, K, _, D = a.shape
    err = lib.scan2d(_build.ptr(a), _build.ptr(b), _build.ptr(out), B, K, S,
                     S, D, 1, 2, 3, 4, int(adjoint),
                     torch.cuda.current_stream().cuda_stream)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="the other checkout's ceigm_unet_tpu_torch/csrc")
    ap.add_argument("--batch", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {gpu}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"base": _build.load(_build.build(args.base.resolve(),
                                                 Path(tmp))),
                "this": _build.library()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    for group, cases in (("gm_tiny", GM_TINY), ("tiny_0230s", LEGACY)):
        # the base kernel may refuse D > 128: then this checkout's alone
        names = (["base", "this"] if all(D <= 128 for *_, D in cases)
                 else ["this"])
        for tag, calls, S, D in cases:
            shape = (args.batch, 4, S * S, D)
            a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)
                              * 2 + 2)
            b = torch.randn(shape, generator=gen, device=dev)
            bound = 12 * a.numel() / HBM_BPS * 1e3
            for adjoint in (False, True):
                plain = (quad_scan.scan2d_adjoint_ref if adjoint
                         else quad_scan.scan2d_ref)(a, b, S, S, (1, 2, 3, 4))
                ms = {n: [] for n in names}
                for n in names:
                    got = _scan2d(libs[n], a, b, S, adjoint)
                    err = (got - plain).abs().max().item()
                    if err > 1e-4 * plain.abs().max().item():
                        raise SystemExit(f"{n} {tag}: max abs err {err:.3e}")
                for n in names + names[::-1]:
                    ms[n].append(_time(lambda: _scan2d(libs[n], a, b, S,
                                                       adjoint)))
                med = {n: statistics.median(v) for n, v in ms.items()}
                mode = "adjoint" if adjoint else "scan"
                for n, v in med.items():
                    totals[group, n] = totals.get((group, n), 0.0) \
                        + calls * v
                totals[group, "bound"] = totals.get((group, "bound"), 0.0) \
                    + calls * bound
                print(f"scan2d [{tag} {mode}] b{args.batch} fp32: "
                      + ", ".join(f"{n} {v:.4f} ms" for n, v in med.items())
                      + f", bound {bound:.4f} ms | {gpu}", flush=True)
            del a, b, plain
        print(f"scan2d per b{args.batch} unfrozen {group} step: "
              + ", ".join(f"{n} {totals[group, n]:.3f} ms" for n in
                          ("base", "this", "bound") if (group, n) in totals),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
