"""Where the time of the port's forward goes, on an NVIDIA card.

    python tools/profile_port.py [--out DIR] [--fp32] [--batch N]

Builds the seeded gm_tiny model (224x224, 9 classes, bf16; with --fp32 in
fp32 with TF32 off, as the test-set CLI serves it), warms up, then
traces 3 forwards (batch 128, or N) with torch.profiler. Prints the wall time per forward, the
summed device-kernel time per forward, the device idle share
(1 - kernel time / wall time), the kernels by device time, and the wall
time of the tensors the forward rebuilds from the weights alone on every
call (QuadGroupSS2D.fused_weights, the CustomFfn composite, the LGAG fold);
with --out, writes the table and a chrome trace there. Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def derived_weights(model) -> None:
    """Build every tensor the forward derives from the weights alone."""
    from ceigm_unet_tpu_torch.models.emcad import LGAG
    from ceigm_unet_tpu_torch.models.layers import CustomFfn
    from ceigm_unet_tpu_torch.models.ss2d import QuadGroupSS2D
    for m in model.modules():
        if isinstance(m, QuadGroupSS2D):
            m.fused_weights(model.dtype)
        elif isinstance(m, CustomFfn):
            m.custom.composite(torch.float32)
        elif isinstance(m, LGAG):
            m.folded()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for profile.txt and trace.json")
    ap.add_argument("--fp32", action="store_true",
                    help="compute in fp32 with TF32 off (default: bf16)")
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    batch, iters = args.batch, 3
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from ceigm_unet_tpu_torch.models import build_model
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.fp32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = build_model(dtype=dtype, device="cuda")
    x = torch.randn((batch, 224, 224, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    with torch.no_grad():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters
        bare = {}
        for name, fn in (("forward", lambda: model(x)),
                         ("derived", lambda: derived_weights(model))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            bare[name] = (time.perf_counter() - t0) / 5
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0))
    events.sort(key=dev_time, reverse=True)
    kernel_ms = sum(dev_time(e) for e in events) / 1e3 / iters
    lines = [f"profile: gm_tiny b{batch} 224x224 "
             f"{'fp32' if args.fp32 else 'bf16'} | {gpu}",
             f"wall {wall * 1e3:.3f} ms/forward, device kernels "
             f"{kernel_ms:.3f} ms/forward, idle share "
             f"{max(0.0, 1 - kernel_ms / (wall * 1e3)):.3f}",
             f"without the profiler: forward {bare['forward'] * 1e3:.3f} ms,"
             f" of which the weight-derived tensors rebuilt on every call "
             f"take {bare['derived'] * 1e3:.3f} ms alone (share "
             f"{bare['derived'] / bare['forward']:.3f})",
             f"{'ms/forward':>10} {'share':>6} {'calls':>6}  kernel"]
    for e in events[:40]:
        ms = dev_time(e) / 1e3 / iters
        lines.append(f"{ms:10.3f} {ms / kernel_ms:6.3f} "
                     f"{e.count // iters:6d}  {e.key[:110]}")
    print("\n".join(lines))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
