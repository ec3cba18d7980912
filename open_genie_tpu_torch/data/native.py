"""The native `.gvid` loader (twin of `open_genie_tpu.data.native`): ctypes
bindings to `native/gvid_loader.cpp`, a dataset over one file and a batch
loader whose C++ threads prefetch ahead.

The `.gvid` container holds fixed-geometry uint8 RGB clips; the C++ side
mmaps it and gathers float32 clips with a thread pool, a codec-free hot path
(no OpenCV in the loop).

The shared library is built from `native/gvid_loader.cpp` at first use,
never at import, into `build/gvid/<hash>/libgvid.so` beside the package,
with the flags of `native/Makefile`. The hash covers the source, the flags
and what the compiler makes of `-march=native` on this host, so a library
built on one machine is never loaded on another CPU. A file lock lets one
process build while the others wait; the library is written under a
temporary name and renamed into place. A failed build raises with the
compiler's output: there is no reader in Python to fall back to.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "gvid_loader.cpp"
BUILD_ROOT = REPO / "build" / "gvid"
# The compiler and flags of native/Makefile (CXXFLAGS, then LDFLAGS).
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-pthread")
_LIB_NAME = "libgvid.so"

# What the last `library()` call found or did: the library's path, whether
# it compiled it, and the compile's wall time.
BUILD = {"path": None, "built": False, "seconds": 0.0}

_lib: Optional[ctypes.CDLL] = None
_FLOATS = ctypes.POINTER(ctypes.c_float)
_INT64S = ctypes.POINTER(ctypes.c_int64)


def _target_digest() -> bytes:
    """The compiler's version and the macros it predefines for
    `-march=native` here (its instruction-set extensions)."""
    out = subprocess.run([CXX, "--version"], capture_output=True, text=True, check=True).stdout
    macros = subprocess.run([CXX, *CXXFLAGS, "-dM", "-E", "-x", "c++", os.devnull],
                            capture_output=True, text=True, check=True).stdout
    return (out + "".join(sorted(macros.splitlines(keepends=True)))).encode()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    digest.update(_target_digest())
    return BUILD_ROOT / digest.hexdigest()[:16] / _LIB_NAME


def _build() -> Path:
    out = library_path()
    BUILD.update(path=out, built=False, seconds=0.0)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name("build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one process compiles; the others wait, then reuse
        if out.exists():
            return out
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=".libgvid-", suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run([CXX, *CXXFLAGS, *LDFLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed ({CXX} exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a reader never sees a half-written library
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        BUILD.update(built=True, seconds=time.perf_counter() - t0)
    return out


def library() -> ctypes.CDLL:
    """The loaded gvid library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.gvid_open.restype = ctypes.c_void_p
    lib.gvid_open.argtypes = [ctypes.c_char_p]
    lib.gvid_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
    lib.gvid_load_batch.argtypes = [ctypes.c_void_p, _INT64S, ctypes.c_int, ctypes.c_int,
                                    _FLOATS]
    lib.gvid_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
    lib.gvid_prefetch_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, _INT64S]
    lib.gvid_prefetch_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, _FLOATS]
    lib.gvid_prefetch_stop.argtypes = [ctypes.c_void_p]
    lib.gvid_close.argtypes = [ctypes.c_void_p]
    lib.gvid_write.restype = ctypes.c_int
    lib.gvid_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8)] + [
        ctypes.c_uint32] * 5
    _lib = lib
    return lib


def write_gvid(path: str, videos: np.ndarray) -> None:
    """Write `(N, T, H, W, C)` uint8 (or float [0,1]) videos as .gvid."""
    lib = library()
    if videos.dtype != np.uint8:
        videos = (np.clip(videos, 0, 1) * 255).astype(np.uint8)
    videos = np.ascontiguousarray(videos)
    n, t, h, w, c = videos.shape
    rc = lib.gvid_write(str(path).encode(),
                        videos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, t, h, w, c)
    if rc != 0:
        raise OSError(f"gvid_write({path}) failed: {rc}")


class GVidDataset:
    """Map-style dataset over a .gvid file (native synchronous reads):
    item `i` is clip `i`'s first `num_frames` frames (a random start when
    `randomize`), `(T, H, W, C)` float32 in [0, 1]."""

    def __init__(self, path: str, num_frames: Optional[int] = None, randomize: bool = False,
                 seed: int = 0) -> None:
        self.lib = library()
        self.handle = None
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        self.handle = self.lib.gvid_open(str(path).encode())
        if not self.handle:
            raise OSError(f"failed to open {path} as .gvid")
        info = (ctypes.c_uint32 * 5)()
        self.lib.gvid_info(self.handle, info)
        self.num_videos, self.frames, self.h, self.w, self.c = (int(v) for v in info)
        self.num_frames = num_frames or self.frames
        if self.num_frames > self.frames:
            raise ValueError(f"num_frames {self.num_frames} > the file's {self.frames} frames")
        self.randomize = randomize
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_videos

    def read(self, spec: np.ndarray, out: torch.Tensor) -> torch.Tensor:
        """Gather the clips `spec` `(n, 2)` of (clip index, start frame) into
        `out` `(n, num_frames, H, W, C)` float32 (contiguous, on the host)."""
        spec = np.ascontiguousarray(spec, np.int64)
        rc = self.lib.gvid_load_batch(self.handle, spec.ctypes.data_as(_INT64S), len(spec),
                                      self.num_frames, ctypes.cast(out.data_ptr(), _FLOATS))
        if rc != 0:
            raise IndexError(f"gvid_load_batch: spec {spec.tolist()} out of range ({rc})")
        return out

    def __getitem__(self, idx: int) -> np.ndarray:
        start = 0
        if self.randomize and self.frames > self.num_frames:
            start = int(self.rng.integers(0, self.frames - self.num_frames + 1))
        out = torch.empty((1, self.num_frames, self.h, self.w, self.c))
        return self.read(np.array([[idx, start]]), out)[0].numpy()

    def close(self) -> None:
        if self.handle:
            self.lib.gvid_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass


class NativeBatchLoader:
    """Pipelined native batch iterator: C++ threads gather the next
    `prefetch` batches while the consumer holds the current one.

    Yields `(B, T, H, W, C)` float32 tensors, in pinned host memory with
    `pin_memory` (each batch written there by the C++ side, so
    `device_prefetch` copies it asynchronously). The order is the JAX
    package's: epoch `e` (1 on the first pass) shuffles the clips with
    `np.random.default_rng(seed + e)`, then draws each batch's start frames
    from the same generator. `seek` positions it like `BatchLoader.seek`."""

    def __init__(self, dataset: GVidDataset, batch_size: int = 8, shuffle: bool = True,
                 num_threads: int = 2, prefetch: int = 2, seed: int = 0,
                 pin_memory: bool = False) -> None:
        self.ds = self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.seed = seed
        self.pin_memory = pin_memory
        self._epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size

    def seek(self, batches: int) -> None:
        """Position the loader as if `batches` batches had been served from
        its first epoch on: the next pass is the epoch they end in, from
        the batch after them (its specs drawn in full, so the rest of the
        epoch is what an uninterrupted run would serve)."""
        self._epoch, self._skip = divmod(batches, len(self))

    def epoch_specs(self, epoch: int) -> List[np.ndarray]:
        """Every batch of epoch `epoch` as a flat `[clip, start] * B` int64
        array, in the JAX package's draw order."""
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        max_start = self.ds.frames - self.ds.num_frames
        specs = []
        for bi in range(len(self)):
            spec = np.empty((self.batch_size, 2), np.int64)
            spec[:, 0] = order[bi * self.batch_size: (bi + 1) * self.batch_size]
            spec[:, 1] = rng.integers(0, max_start + 1, self.batch_size) if max_start > 0 else 0
            specs.append(np.ascontiguousarray(spec.reshape(-1)))
        return specs

    def __iter__(self) -> Iterator[torch.Tensor]:
        """The C++ prefetcher runs for the epoch and is stopped in a
        `finally`, also when the consumer stops early."""
        lib, handle = self.ds.lib, self.ds.handle
        self._epoch += 1
        skip, self._skip = self._skip, 0
        specs = self.epoch_specs(self._epoch)[skip:]
        shape = (self.batch_size, self.ds.num_frames, self.ds.h, self.ds.w, self.ds.c)
        lib.gvid_prefetch_start(handle, self.batch_size, self.ds.num_frames, self.num_threads)
        try:
            submitted = 0

            def submit():
                nonlocal submitted
                lib.gvid_prefetch_submit(handle, submitted, specs[submitted].ctypes.data_as(_INT64S))
                submitted += 1

            while submitted < min(len(specs), self.prefetch + 1):
                submit()
            for ticket in range(len(specs)):
                out = torch.empty(shape, pin_memory=self.pin_memory)
                lib.gvid_prefetch_get(handle, ticket, ctypes.cast(out.data_ptr(), _FLOATS))
                if submitted < len(specs):
                    submit()
                yield out
        finally:
            lib.gvid_prefetch_stop(handle)
