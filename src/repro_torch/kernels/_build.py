"""Builds the port's CUDA kernels at first use and binds them with ctypes.

``library()`` compiles ``csrc/*.cu`` for ``sm_90a`` through
``torch.utils.cpp_extension.load`` into ``build/torch_ext/`` at the repo root
(listed in ``.gitignore``), once per process, and returns the loaded
library.  The sources expose a plain C interface and include no PyTorch
header, so nvcc takes seconds rather than minutes; ``load`` runs one nvcc
per source in parallel through ninja.  Nothing here runs at import, so
``import repro_torch`` works on a machine without nvcc or a card.  A build
error propagates: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import os
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rmsnorm.cu", "flash.cu", "flash_bwd.cu", "ssd.cu", "ssd_bwd.cu", "wkv6.cu",
           "wkv6_step.cu", "runtime.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
EXT_NAME = "repro_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

# dtype codes of csrc/common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LIB = None
BUILD_SECONDS = None     # wall time of this process's build, once built


def library() -> ctypes.CDLL:
    """The compiled kernels, built on the first call."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        t0 = time.perf_counter()
        _LIB = _bind(ctypes.CDLL(_compile()))
        BUILD_SECONDS = time.perf_counter() - t0
    return _LIB


def _compile() -> str:
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)   # load() does not make it
    # the -gencode flag fixes the one target; the variable keeps load() from
    # adding targets for the detected card as well
    prev = os.environ.get("TORCH_CUDA_ARCH_LIST")
    os.environ["TORCH_CUDA_ARCH_LIST"] = "9.0a"
    try:
        path = load(name=EXT_NAME, sources=[str(CSRC / s) for s in SOURCES],
                    extra_cuda_cflags=CUDA_FLAGS, build_directory=str(BUILD_DIR),
                    is_python_module=False, verbose=False)
    finally:
        if prev is None:
            del os.environ["TORCH_CUDA_ARCH_LIST"]
        else:
            os.environ["TORCH_CUDA_ARCH_LIST"] = prev
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.rt_rmsnorm.argtypes = [p, p, p, i, i, f, i, i, p]
    lib.rt_rmsnorm.restype = i
    lib.rt_rmsnorm_bwd.argtypes = [p] * 6 + [i, i, i, f, i, i, p]
    lib.rt_rmsnorm_bwd.restype = i
    lib.rt_rmsnorm_bwd_blocks.argtypes = [i]
    lib.rt_rmsnorm_bwd_blocks.restype = i
    lib.rt_flash_attention.argtypes = [p] * 6 + [i] * 8 + [f, i, p]
    lib.rt_flash_attention.restype = i
    lib.rt_flash_attention_bwd.argtypes = [p] * 11 + [i] * 8 + [f, i, p]
    lib.rt_flash_attention_bwd.restype = i
    lib.rt_ssd.argtypes = [p] * 10 + [i] * 6 + [ll] * 6 + [i, p]
    lib.rt_ssd.restype = i
    lib.rt_ssd_smem_bytes.argtypes = [i, i]
    lib.rt_ssd_smem_bytes.restype = i
    lib.rt_ssd_bwd.argtypes = [p] * 18 + [i] * 6 + [ll] * 6 + [i, p]
    lib.rt_ssd_bwd.restype = i
    lib.rt_ssd_bwd_smem_bytes.argtypes = [i, i]
    lib.rt_ssd_bwd_smem_bytes.restype = i
    lib.rt_wkv6.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.rt_wkv6.restype = i
    lib.rt_wkv6_smem_bytes.argtypes = [i, i]
    lib.rt_wkv6_smem_bytes.restype = i
    lib.rt_wkv6_step.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.rt_wkv6_step.restype = i
    lib.rt_error_string.argtypes = [i]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher refused its arguments or its launch failed."""
    if rc != 0:
        raise RuntimeError(f"{what}: {lib.rt_error_string(rc).decode()} (code {rc})")
