"""Build and load the hand-written Hopper kernels under ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded through ``ctypes``. The
build happens at first use, into ``ceigm_unet_tpu_torch/_build/``, keyed by
a hash of the sources, so a checkout builds everything it needs from its own
files. A failed build raises; nothing falls back.

Every C entry point launches exactly one kernel on the stream it is given
and returns ``cudaGetLastError()``. :func:`launch` checks that code and adds
one to the entry point's launch count, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong
# C signatures (all return cudaError_t as int). The stream is the last
# argument of each.
SIGNATURES = {
    "quad_scan_ln": [_P] * 10 + [_L] * 14 + [_I] * 10 + [_P],
    "cffn_gemm": [_P] * 4 + [_I] * 6 + [_P],
    "cffn_dw3_gelu": [_P] * 4 + [_I] * 4 + [_P],
    "cffn_inception7": [_P] * 4 + [_I] * 5 + [_P],
    "dysample_grid_sample": [_P] * 3 + [_I] * 8 + [_P],
    "lgag_gate": [_P] * 8 + [_I] * 5 + [_P],
}

# launches per C entry point since the last reset_launch_counts()
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels under " + str(CSRC))
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the kernels if the library for the current sources is not
    built yet. Returns the library's path."""
    BUILD_DIR.mkdir(exist_ok=True)
    lib = BUILD_DIR / f"libceigm_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (rc=%d):\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream; raise on a
    launch error, count the launch otherwise."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError_t "
                           f"{err}")
    launch_counts[name] += 1


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_cuda(*tensors: torch.Tensor) -> None:
    """All tensors on the current CUDA device (the kernels launch on its
    current stream)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"kernel operand on {t.device}, the current "
                             f"device is {dev}")
