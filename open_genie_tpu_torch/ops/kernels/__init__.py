"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled by `nvcc` for `sm_90a`, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). The build happens at first use, never at import, into
`build/torch_kernels/<hash>/` beside the package; the hash covers the
sources, the headers they include and the flags, so an unchanged tree
reuses its library.
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LIB_NAME = "libopen_genie_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argtypes; every entry returns its cudaError_t as int.
_SIGNATURES = {
    # f32 (CUDA cores) and bf16 (tensor cores), each pair below:
    # q, k, v, o, lse, bh, n, d, scale, causal, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "flash_attention_fwd_mma": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, dout, lse, delta, dk, dv, bh, n, d, scale, causal, stream
    "flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "flash_attention_bwd_dkv_mma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, dout, lse, delta, dq, bh, n, d, scale, causal, stream
    "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "flash_attention_bwd_dq_mma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, w, w strides (c, d), w dtype, b, b dtype, codes, idx, n, c, d, dtype, stream
    "lfq_head": (_P, _P, _L, _L, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P),
    # x, tables, q, n, d, beta, stream
    "lfq_entropy_fwd": (_P, _P, _P, _I, _I, _F, _P),
    # x, w, scratch, dx, n, d, beta, stream
    "lfq_entropy_bwd": (_P, _P, _P, _P, _I, _I, _F, _P),
    # logits, dtype, noise, noise kind, temp, b, hw, v, splits, scratch,
    # mask, code, code dtype, num_tokens, mask_out, code_out, pred, conf, stream
    "maskgit_sample": (_P, _I, _P, _I, _F, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                       _P, _P),
    # x, w_gate_up, w_down, order, offsets, weights, h, out, slots, experts, c, i, top_k,
    # block_m, stream
    "moe_experts": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, q stride (b), q stride (n), k, v, o, b, n, n_head, n_kv_head, t_max, end, d, scale,
    # stream
    "block_attention": (_P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}


# What the last build found or did: library path, whether nvcc ran, its
# wall time and its output (ptxas register and shared-memory report, kept
# beside the library for a later process that reuses it).
BUILD = {"path": None, "built": False, "seconds": 0.0, "log": ""}

_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


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
    for src in srcs + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_ROOT / digest.hexdigest()[:16] / _LIB_NAME
    log = out.with_name("nvcc.log")
    BUILD.update(path=out, built=False)
    if out.exists():
        BUILD["log"] = log.read_text() if log.exists() else ""
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode != 0]
        lib = Path(tmp) / _LIB_NAME
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = ["link"] if link.returncode != 0 else []
        BUILD.update(seconds=time.perf_counter() - t0, log="".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD['log']}")
        log.write_text(BUILD["log"])
        os.replace(lib, out)  # atomic: a reader never sees a half-written library
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
