"""Parameter count and FLOPs of the MSVM-UNet (reference
gm-unet/calc_params.py + utils.print_flops_params) at a 1x1xSxS input.

    python -m ceigm_unet_tpu_torch.cli.calc_params [--num-classes 9]
        [--img-size 224] [--enc gm_tiny]

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``, which
counts the matrix products and convolutions of PyTorch's own operators. The
port's hand-written CUDA kernels are opaque to it (on the card the
CustomFfn GEMMs would drop out of the count), so this tool runs the model
on the plain path, on the CPU, and refuses any other device; it analyses
the model and serves nothing. The figure differs from the JAX package's,
which is XLA's cost analysis of the whole compiled graph (element-wise work
and the scans included).
"""
from __future__ import annotations

import argparse
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ceigm_unet_tpu_torch.models import build_model


def count_params_flops(num_classes: int = 9, img_size: int = 224,
                       enc_name: str = "gm_tiny", device: str = "cpu"
                       ) -> Tuple[int, int]:
    """(parameters, GEMM and convolution FLOPs of one batch-1 forward).
    Counts on the CPU only: on the card the hand kernels would hide their
    FLOPs from the counter."""
    if torch.device(device).type != "cpu":
        raise ValueError(f"count_params_flops counts on the CPU, not on "
                         f"{device}: FlopCounterMode cannot see the port's "
                         f"CUDA kernels")
    model = build_model(num_classes=num_classes, enc_name=enc_name,
                        device=device)
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros((1, img_size, img_size, 1), device=device)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return n_params, counter.get_total_flops()


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="FLOPs are those of PyTorch's GEMM and convolution operators "
               "as FlopCounterMode counts them; the port's CUDA kernels are "
               "invisible to it, so the model runs on the CPU.")
    p.add_argument("--num-classes", type=int, default=9)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--enc", default="gm_tiny")
    a = p.parse_args(argv)
    n, f = count_params_flops(a.num_classes, a.img_size, a.enc)
    print(f"Params: {n / 1e6:.3f} M ({n})")
    print(f"FLOPs:  {f / 1e9:.3f} G (FlopCounterMode: GEMM and conv "
          f"operators only, batch 1)")
    return n, f


if __name__ == "__main__":
    main()
