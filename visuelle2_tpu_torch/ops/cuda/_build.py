"""Build and load the port's CUDA kernels.

Every ``visuelle2_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for
``sm_90a``, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at first use, never at import (the package
imports on machines without ``nvcc``), and goes into
``build/visuelle2_tpu_torch/`` at the root of the checkout.  The library's
name carries a hash of the sources and flags, so a changed source is rebuilt
and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "visuelle2_tpu_torch"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"nvcc not found (looked in {cuda_home}/bin and PATH): "
                       "the port's CUDA kernels are built on the GPU machine")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"libv2t_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the stderr of any that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed, then load them (once per process).

    One ``nvcc`` per source, all started together, then one link."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{lib.stem}.{os.getpid()}"
        nvcc = _nvcc()
        sources = sorted(SRC_DIR.glob("*.cu"))
        objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objects)])
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        _run_all([[nvcc, *LINK_FLAGS, *map(str, objects), "-o", str(tmp)]])
        for obj in objects:
            obj.unlink()
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(lib))


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        lib.v2t_error_string.argtypes = [ctypes.c_int]
        lib.v2t_error_string.restype = ctypes.c_char_p
        msg = lib.v2t_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
