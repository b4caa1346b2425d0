"""PyTorch + CUDA port of ``ceigm_unet_tpu`` (MSVM-UNet inference).

Same layout and public names as the JAX package (``ops/``, ``models/``,
``convert/``, ``eval/``). Every Pallas kernel on the inference path is a
hand-written Hopper kernel under ``csrc/``, built at first use by
``ops/_build.py``; each kernel op runs its plain PyTorch version for CPU
tensors. This package imports torch and never JAX.
"""
