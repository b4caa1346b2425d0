"""PyTorch + CUDA port of ``ceigm_unet_tpu`` (MSVM-UNet inference and its
training step; the legacy VMamba MSVM-UNet's inference and the
``selective_scan`` op).

Same layout and public names as the JAX package (``ops/``, ``models/``,
``convert/``, ``eval/``, ``train/``, ``losses``). Every Pallas kernel on
those paths is a hand-written Hopper kernel under ``csrc/``, built at first
use by ``ops/_build.py``; each kernel op runs its plain PyTorch version for
CPU tensors. This package imports torch and never JAX.
"""
