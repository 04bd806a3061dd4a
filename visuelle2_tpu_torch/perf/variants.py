"""Kernel variants for the split tools: a kernel's source with lines
replaced, each built into its own shared library.

``perf/gemm_split.py`` and ``perf/gru_split.py`` time a kernel whole and
with one part removed; a variant is a tuple of (line, replacement) edits of
the kernel's source in ``csrc/``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from visuelle2_tpu_torch.ops.cuda import _build


def variant_sources(text: str, variants: dict, source: Path) -> dict:
    """Each variant's source from the kernel's source ``text``; raises if it
    no longer holds a line a variant replaces."""
    out = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} is not in {source.name}")
            src = src.replace(old, new)
        out[name] = src
    return out


def build_variants(kernels: dict) -> dict:
    """``kernels``: tag -> (source path, variants).  One shared library per
    kernel and variant, built side by side into the build directory (one
    nvcc each): tag -> name -> library."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, paths = _build._nvcc(), [], {}
    for tag, (source, variants) in kernels.items():
        for name, src in variant_sources(source.read_text(), variants, source).items():
            cu = _build.BUILD_DIR / f"split_{tag}_{name}.cu"
            cu.write_text(src)
            paths[tag, name] = _build.BUILD_DIR / f"split_{tag}_{name}.so"
            cmds.append([nvcc, *_build.COMPILE_FLAGS, "-shared", str(cu), "-o",
                         str(paths[tag, name])])
    _build._run_all(cmds)
    libs = {tag: {} for tag in kernels}
    for (tag, name), path in paths.items():
        libs[tag][name] = ctypes.CDLL(str(path))
    return libs
