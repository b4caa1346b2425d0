"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded through ``ctypes``. The build happens at first
use, into ``ceigm_unet_tpu_torch/_build/``, keyed by a hash of the sources,
so a checkout builds everything it needs from its own files. A failed build
raises; nothing falls back.

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
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong
# C signatures (all return cudaError_t as int). The stream is the last
# argument of each.
SIGNATURES = {
    "quad_scan_ln": [_P] * 10 + [_L] * 14 + [_I] * 10 + [_P],
    "quad_scan_ln_q8": [_P] * 12 + [_L] * 14 + [_I] * 10 + [_P],
    "cffn_gemm": [_P] * 4 + [_I] * 6 + [_P],
    "cffn_dw3_inception7": [_P] * 6 + [_I] * 5 + [_P],
    "dysample_grid_sample": [_P] * 3 + [_I] * 8 + [_P],
    "grid_sample_bilinear": [_P] * 3 + [_I] * 7 + [_P],
    "dwconv3x3": [_P] * 4 + [_L] * 3 + [_I] * 5 + [_P],
    "dwconv3x3_flip": [_P] * 3 + [_L] * 3 + [_I] * 5 + [_P],
    "lgag_gate": [_P] * 8 + [_I] * 5 + [_P],
    "scan2d": [_P] * 3 + [_L] * 6 + [_I] * 10 + [_P],
    "sscan_dir": [_P] * 8 + [_L] * 14 + [_I] * 10 + [_P],
    "scan_rows": [_P] * 3 + [_I] * 2 + [_P],
    "selective_scan_n1": [_P] * 8 + [_L] * 9 + [_I] * 8 + [_P],
}

# launches per C entry point since the last reset_launch_counts()
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels under " + str(CSRC))
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels of ``csrc`` (this checkout's by default) if the
    library for those sources is not built yet. Returns the library's
    path."""
    build_dir.mkdir(exist_ok=True)
    lib = build_dir / f"libceigm_kernels_{source_hash(csrc)}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    obj_dir = build_dir / f"obj_{lib.stem}_{os.getpid()}"
    obj_dir.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(csrc.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(src), "-o",
               str(obj_dir / (src.stem + ".o"))]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    # wait for every compile before raising, so none outlives the build
    results = [(cmd, proc, proc.communicate()[1]) for cmd, proc in jobs]
    for cmd, proc, err in results:
        _check(cmd, proc.returncode, err)
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *[cmd[-1] for cmd, _, _ in results]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _check(cmd, proc.returncode, proc.stderr)
    os.replace(tmp, lib)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib


def _check(cmd, returncode: int, err: str) -> None:
    if returncode != 0:
        raise RuntimeError("nvcc failed (rc=%d):\n%s\n%s" % (
            returncode, " ".join(cmd), err[-8000:]))


def load(path: Path, strict: bool = True) -> ctypes.CDLL:
    """Load a built library and declare its entry points' signatures. With
    ``strict`` False, entry points the library lacks (another checkout's,
    built from an older ``csrc/``) are left out instead of raising."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if not strict and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    return load(build())


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream; raise on a
    launch error, count the launch otherwise."""
    # the raw handle: torch.cuda.current_stream() builds a Stream object
    # on every call, which costs more host time than the launch itself
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
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
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"kernel operand on {t.device}, the current "
                             f"device is cuda:{dev}")


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel whose output autograd could not trace back refuses inputs
    that require grad (its differentiable caller runs it in no-grad mode)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward of its own; "
                           f"call it under torch.no_grad() or through its "
                           f"differentiable op")
