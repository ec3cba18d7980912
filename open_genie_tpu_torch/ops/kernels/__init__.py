"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled by `nvcc` for `sm_90a` into one shared library
with a plain C interface and loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). The build happens at first use, never at import,
into `build/torch_kernels/<hash>/` beside the package; the hash covers the
sources and the flags, so an unchanged tree reuses its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LIB_NAME = "libopen_genie_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes; every entry returns its cudaError_t as int.
_SIGNATURES = {
    # q, k, v, o, lse, bh, n, d, dtype, scale, causal, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, dout, lse, delta, dk, dv, bh, n, d, dtype, scale, causal, stream
    "flash_attention_bwd_dkv": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P,
    ),
    # q, k, v, dout, lse, delta, dq, bh, n, d, dtype, scale, causal, stream
    "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # x, w, b, codes, idx, n, c, d, dtype, stream
    "lfq_head": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


# What the last build found or did: library path, whether nvcc ran, its
# wall time and its output (ptxas register and shared-memory report).
BUILD = {"path": None, "built": False, "seconds": 0.0, "log": ""}

_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit"
        )
    return found


def _build() -> Path:
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_ROOT / digest.hexdigest()[:16] / _LIB_NAME
    BUILD.update(path=out, built=False)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)],
        capture_output=True, text=True,
    )
    BUILD.update(
        seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD['log']}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    BUILD["built"] = True
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
