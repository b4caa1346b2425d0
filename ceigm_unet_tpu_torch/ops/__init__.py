"""Ops of the port: each kernel op launches a hand-written Hopper kernel
(``csrc/``) for CUDA tensors and runs its plain PyTorch version, in the same
module, for CPU tensors."""
