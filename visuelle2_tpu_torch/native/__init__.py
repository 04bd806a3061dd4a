"""The native (C++) prefetch engine, counterpart of ``visuelle2_tpu/native``.

``prefetch.cc`` (a plain C ABI) gathers whole uint8 image rows on a pool of
worker threads; ``PrefetchEngine`` binds it with ``ctypes``, and
``data/loader.py`` uses it to assemble the next batch's images while the card
runs the current one.

The library is built at first use, never at import: ``g++ -O3 -shared -fPIC
-pthread`` into ``build/visuelle2_tpu_torch/`` at the root of the checkout,
under a name that carries a hash of the source and flags, written to a
per-process temporary name and renamed into place (atomic on one file
system), so processes that build at the same moment never load half a file.
A failed build raises ``RuntimeError`` with the compiler's stderr; there is
no quiet fallback (``BatchLoader(native_prefetch=False)`` is the explicit way
out).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "prefetch.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "visuelle2_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libv2t_prefetch_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the library if needed, then load it (once per process)."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib_path.stem}.{os.getpid()}.tmp.so"
        cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native prefetch: cannot run {cmd[0]}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native prefetch: {' '.join(cmd)} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    lib.prefetch_engine_create.restype = ctypes.c_void_p
    lib.prefetch_engine_create.argtypes = [ctypes.c_int]
    lib.prefetch_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.prefetch_gather_submit.restype = ctypes.c_void_p
    lib.prefetch_gather_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.prefetch_gather_wait.argtypes = [ctypes.c_void_p]
    return lib


class PrefetchEngine:
    """Threaded gather over a uint8 row-major array.

    ``gather(src, indices, out)`` copies ``src[indices]`` into ``out`` on the
    worker pool; ``submit`` and ``wait`` are its asynchronous form.
    """

    def __init__(self, num_threads: int = 0):
        self._lib = load_library()
        if num_threads <= 0:
            num_threads = min(8, os.cpu_count() or 4)
        self._engine = self._lib.prefetch_engine_create(num_threads)

    def __del__(self):
        if getattr(self, "_engine", None):
            self._lib.prefetch_engine_destroy(self._engine)
            self._engine = None

    @staticmethod
    def _check(src: np.ndarray, indices: np.ndarray, out: np.ndarray) -> int:
        # Exceptions, not asserts: these guard the raw memcpy offsets.
        if src.dtype != np.uint8 or out.dtype != np.uint8:
            raise TypeError(f"src and out must be uint8, got {src.dtype} and {out.dtype}")
        if not (src.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]):
            raise ValueError("src and out must be C-contiguous")
        if indices.dtype != np.int64 or not indices.flags["C_CONTIGUOUS"]:
            raise TypeError("indices must be C-contiguous int64")
        row_bytes = int(np.prod(src.shape[1:]))
        if out.shape[0] != indices.shape[0]:
            raise ValueError(f"out has {out.shape[0]} rows, indices {indices.shape[0]}")
        if int(np.prod(out.shape[1:])) != row_bytes:
            raise ValueError(f"out rows {out.shape[1:]} != src rows {src.shape[1:]}")
        if indices.size and (indices.min() < 0 or indices.max() >= src.shape[0]):
            raise IndexError(f"indices out of range for {src.shape[0]} rows")
        return row_bytes

    def submit(self, src: np.ndarray, indices: np.ndarray, out: np.ndarray):
        """Start ``out[:] = src[indices]``; returns the handle ``wait`` takes.
        The handle keeps ``src``, ``indices`` and ``out`` alive."""
        row_bytes = self._check(src, indices, out)
        job = self._lib.prefetch_gather_submit(
            self._engine, src.ctypes.data_as(ctypes.c_void_p), row_bytes,
            indices.ctypes.data_as(ctypes.c_void_p), len(indices),
            out.ctypes.data_as(ctypes.c_void_p))
        return (job, src, indices, out)

    def wait(self, handle) -> np.ndarray:
        """Finish a submitted gather (the calling thread helps) and return
        its ``out``."""
        job, _src, _indices, out = handle
        self._lib.prefetch_gather_wait(job)
        return out

    def gather(self, src: np.ndarray, indices: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            out = np.empty((len(indices),) + src.shape[1:], np.uint8)
        return self.wait(self.submit(src, indices, out))


_engine_lock = threading.Lock()
_shared: Optional[PrefetchEngine] = None


def shared_engine() -> PrefetchEngine:
    """The process's one engine: loaders share its thread pool (only one
    gathers at a time, and the job queue is mutex-protected)."""
    global _shared
    with _engine_lock:
        if _shared is None:
            _shared = PrefetchEngine()
        return _shared
